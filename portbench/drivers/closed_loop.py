"""A closed loop: one caller, each call sent when the last one's results are
on the host, batches of ``batch`` queries taken in turn from the seeded pool
(wrapping round), so every seed sends the same sizes in the same order.

Traffic keys: ``batch`` (queries a call), ``mode`` (``Index.search``'s
mode), ``warmup_calls`` (calls of set-up, at the window's one shape),
``trace_calls`` (calls in the traced sub-window); ``params`` and ``search``
as ``system.search`` reads them.
"""

from __future__ import annotations

import resource
import time
import traceback

import numpy as np

from portbench import system, trace


class Loop:
    def __init__(self, ix, cfg: dict, traffic: dict, pool: np.ndarray,
                 batch: int, log, extra: dict | None = None):
        self.ix, self.cfg, self.traffic, self.log = ix, cfg, traffic, log
        self.extra = extra or {}
        self.batch = batch
        self.size = len(pool)
        # the pool and its first batch again: every batch a contiguous slice
        self.pool = np.concatenate([pool, pool[:batch]])
        self.next = 0
        self.starts: list[int] = []  # each answered call's first pool row
        self.dists: list[np.ndarray] = []
        self.labels: list[np.ndarray] = []
        self.failed = 0

    def _call(self):
        start = self.next
        self.next = (start + self.batch) % self.size
        try:
            out = system.search(self.ix, self.cfg, self.traffic,
                                self.pool[start:start + self.batch],
                                **self.extra)
        except Exception:  # a call that never answers: counted, run goes on
            if not self.failed:
                self.log("call failed:\n" + traceback.format_exc())
            self.failed += self.batch
            return
        self.starts.append(start)
        self.dists.append(out[0])
        self.labels.append(out[1])

    def warm_up(self):
        for _ in range(self.traffic["warmup_calls"]):
            self._call()

    def traced(self, probes: dict, kernels: dict, device):
        """The profiled sub-window of ``trace_calls`` calls."""
        return trace.traced(self._call, self.traffic["trace_calls"], probes,
                            kernels, device)

    def window(self, seconds: float) -> dict:
        """Calls until ``seconds`` have passed; each call's start and end on
        the host's clock, and the calling thread's CPU seconds and
        involuntary context switches during it."""
        failed0, calls, host = self.failed, [], []
        t0 = time.perf_counter()
        while True:
            cpu, switches = _thread_use()
            t = time.perf_counter()
            self._call()
            end = time.perf_counter()
            cpu2, switches2 = _thread_use()
            calls.append((t, end))
            host.append((cpu2 - cpu, switches2 - switches))
            if end - t0 >= seconds:
                break
        return {"calls": calls, "host": host,
                "latencies": [e - s for s, e in calls],
                "seconds": end - t0, "attempted": len(calls) * self.batch,
                "failed": self.failed - failed0,
                "queries": len(calls) * self.batch - (self.failed - failed0)}

    def answers(self):
        """(pool row [A], dists [A, k], labels [A, k] int64) of every call
        that answered."""
        qidx = np.concatenate([(s + np.arange(self.batch)) % self.size
                               for s in self.starts])
        labels = np.concatenate(self.labels).view(np.int64)
        return qidx, np.concatenate(self.dists), labels


def _thread_use():
    """(CPU seconds, involuntary context switches) of the calling thread."""
    return time.thread_time(), resource.getrusage(
        resource.RUSAGE_THREAD).ru_nivcsw
