"""Failure-point fault injection (port of lantern_tpu/utils/failpoints.py,
parity with lantern_hnsw failure_point.c).

The reference compiles named crash/fault sites keyed on (function, name),
armed one-at-a-time from SQL with a skip counter
(failure_point.h:38-42, failure_point.c:22-88); crash-recovery tests enable
a point, run an operation, and assert the index state afterwards.

Here a failure point raises FailurePointError (or calls an injected action)
when armed; ~the same idiom drives snapshot/WAL crash tests and socket
protocol fault tests.
"""

from __future__ import annotations

import threading


class FailurePointError(RuntimeError):
    pass


_lock = threading.Lock()
_armed: dict[tuple[str, str], int] = {}  # (func, name) -> remaining skips


def failure_point_enable(func: str, name: str, dont_trigger_first_nr: int = 0):
    """Arm a failure point (one at a time, like the reference)."""
    with _lock:
        _armed.clear()
        _armed[(func, name)] = dont_trigger_first_nr


def failure_point_disable_all():
    with _lock:
        _armed.clear()


def failure_point(func: str, name: str):
    """Trigger site: raises FailurePointError when armed (after skips)."""
    with _lock:
        key = (func, name)
        if key not in _armed:
            return
        if _armed[key] > 0:
            _armed[key] -= 1
            return
        del _armed[key]
    raise FailurePointError(f"failure point triggered: {func}.{name}")
