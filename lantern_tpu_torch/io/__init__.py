from lantern_tpu_torch.io.dotvecs import (  # noqa: F401
    parse_bvecs,
    parse_fvecs,
    parse_ivecs,
    write_fvecs,
)
