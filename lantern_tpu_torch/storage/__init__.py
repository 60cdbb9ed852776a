"""Persistence: snapshots, the insert log and the log-following replica."""

from lantern_tpu_torch.storage.replica import IndexFollower  # noqa: F401
from lantern_tpu_torch.storage.snapshot import (  # noqa: F401
    HEADER_MAGIC,
    HEADER_VERSION,
    InsertLog,
    load_snapshot,
    read_log_header,
    read_snapshot_header,
    save_snapshot,
    scan_log_tail,
)
