"""Spans and micro-benchmark timers (own copy of lantern_tpu/utils/bench.py)
— parity with the reference's LanternBench (C16).

The reference wraps hot calls in a macro that aggregates count/avg and logs
every 5 s (bench.h:12-23, bench.c:14-51), compiled in with -DBENCH=ON.

Here every span of the program goes through ``span(name)``, which two
switches turn on:

- a ``torch.profiler`` session that is recording: the span enters
  ``record_function(name)``, so it lies in the profiler's trace on the
  clock of the kernels and runtime calls made inside it. The device time
  of those kernels is the profiler's to read;
- the LanternBench counters (``enable()``, or ``LANTERN_TPU_BENCH=1`` in
  the environment): the span adds its count and seconds to ``stats()``,
  dumped every 5 s. These are host seconds: on CUDA a span ends when its
  work is enqueued, not when the device has run it.

With neither on, ``span`` returns one shared ``nullcontext`` after a flag
read and a bool read (well under a microsecond a span). ``bench`` and
``benched`` are the reference's names for it. ``launch`` marks the
hand-written kernels' launches for the profiler alone.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

_enabled = os.environ.get("LANTERN_TPU_BENCH", "") == "1"
_lock = threading.Lock()
_stats: dict[str, list] = {}  # name -> [count, total_s]
_last_dump = time.monotonic()
DUMP_INTERVAL_S = 5.0  # bench.c dumps every 5 s
_OFF = contextlib.nullcontext()


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
                print(f"[bench] {n}: count={c} avg={t / c * 1e3:.3f}ms host")


def span(name: str):
    """``with span("search.flat"): ...``: a profiler record and/or a
    counter entry where either is on (see the module's docstring), else a
    shared no-op."""
    if not (_enabled or _profiler_enabled()):
        return _OFF
    return _on(name)


@contextlib.contextmanager
def _on(name: str):
    with record_function(name) if _profiler_enabled() else _OFF:
        if not _enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _record(name, time.perf_counter() - t0)


def launch(name: str):
    """``with launch("k4.launch"): <ctypes call>``, around a hand-written
    kernel's launch, which no torch op encloses. While a profiler records,
    an op record named ``name`` (``_RecordFunctionFast``, as Inductor puts
    around a Triton launch): the profiler links a kernel to the innermost op
    that launched it, and a span is a user annotation, not an op, so without
    this the kernel's device time would count in no span. Else a shared
    no-op."""
    return _RecordFunctionFast(name) if _profiler_enabled() else _OFF


bench = span  # with bench("hot_loop"): ...  (the LanternBench macro analog)


def benched(name: str | None = None):
    """Decorator form: the whole call is one span."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with span(label):
                return fn(*a, **kw)

        return wrapper

    return deco
