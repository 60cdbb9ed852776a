"""Framework-free helpers: failure-point fault injection."""

from lantern_tpu_torch.utils.failpoints import (  # noqa: F401
    FailurePointError,
    failure_point,
    failure_point_disable_all,
    failure_point_enable,
)
