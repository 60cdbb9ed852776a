from lantern_tpu_torch.service.protocol import (  # noqa: F401
    ERR_MSG,
    END_MSG,
    INIT_MSG,
    PROTOCOL_VERSION,
    SERVER_TYPE_INDEXING,
    SERVER_TYPE_ROUTER,
    InitParams,
)
