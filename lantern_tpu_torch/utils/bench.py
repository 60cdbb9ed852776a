"""Micro-benchmark timers (own copy of lantern_tpu/utils/bench.py) — parity
with the reference's LanternBench (C16).

The reference wraps hot calls in a macro that aggregates count/avg and logs
every 5 s (bench.h:12-23, bench.c:14-51), compiled in with -DBENCH=ON.
Here: a context manager / decorator registry, enabled by env var
LANTERN_TPU_BENCH=1 (or programmatically), dumping on demand or on interval.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time

_enabled = os.environ.get("LANTERN_TPU_BENCH", "") == "1"
_lock = threading.Lock()
_stats: dict[str, list] = {}  # name -> [count, total_s]
_last_dump = time.monotonic()
DUMP_INTERVAL_S = 5.0  # bench.c dumps every 5 s


def enable(on: bool = True):
    global _enabled
    _enabled = on


def reset():
    with _lock:
        _stats.clear()


def stats() -> dict[str, dict]:
    with _lock:
        return {
            name: {"count": c, "total_s": t, "avg_s": t / c if c else 0.0}
            for name, (c, t) in _stats.items()
        }


def _record(name: str, dt: float):
    global _last_dump
    with _lock:
        entry = _stats.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += dt
        now = time.monotonic()
        if now - _last_dump >= DUMP_INTERVAL_S:
            _last_dump = now
            for n, (c, t) in _stats.items():
                print(f"[bench] {n}: count={c} avg={t / c * 1e3:.3f}ms")


@contextlib.contextmanager
def bench(name: str):
    """with bench("hot_loop"): ...  (the LanternBench macro analog)."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _record(name, time.perf_counter() - t0)


def benched(name: str | None = None):
    """Decorator form."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _enabled:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                _record(label, time.perf_counter() - t0)

        return wrapper

    return deco
