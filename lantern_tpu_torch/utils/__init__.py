"""Framework-free helpers: the leveled logger and failure-point fault
injection."""

from lantern_tpu_torch.utils.logger import Logger, LogLevel  # noqa: F401
from lantern_tpu_torch.utils.failpoints import (  # noqa: F401
    FailurePointError,
    failure_point,
    failure_point_disable_all,
    failure_point_enable,
)
