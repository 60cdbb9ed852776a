"""The traced run's record: one ``torch.profiler`` session over a fixed
sub-window of whole calls, the launches the readers observe, and the reading
of device time, idle time and the breakdown from it.

The session's first step is a warm-up call and is not read (sessions have
lost kernels, ``chip_smoke.py`` ``profiled()``, line 422); the second step
is the sub-window, one span ``portbench.window`` around its calls and one
``portbench.call`` around each. A record
that lost a launch (fewer kernels of a probed name than the probe counted
launches) is taken again, on the next calls, up to ``TRIES`` times, and is
never read.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
import importlib
from collections import defaultdict

import torch

TRIES = 3
WINDOW_SPAN = "portbench.window"
# around each call: idle time outside any op of the program reads as this
CALL_SPAN = "portbench.call"
TOP = 10
NAME_CHARS = 96  # a breakdown's names, cut: kernels' template arguments run long


@dataclasses.dataclass
class Interval:
    name: str
    start: float  # seconds, the profiler's clock
    end: float


@dataclasses.dataclass
class Record:
    """What one traced sub-window left: its calls, the device's intervals,
    the host's ops, and each probe's launches (a dict of shapes a call)."""

    calls: int
    window: Interval | None
    device: list[Interval]
    host: list[Interval]
    host_device_s: dict[str, float]  # an op's device time, kernels under it
    launches: dict[str, list[dict]]

    def device_in_window(self) -> list[Interval]:
        w = self.window
        return [e for e in self.device if e.end > w.start and e.start < w.end]


def _describe(x):
    if isinstance(x, torch.Tensor):
        return {"shape": tuple(x.shape), "itemsize": x.element_size(),
                "dtype": str(x.dtype).replace("torch.", "")}
    return x


class Probe:
    """Records the arguments' shapes of each call of ``module:attr`` (the
    binding a program module calls), then calls through. It replaces only
    that one binding and puts it back on ``remove``."""

    def __init__(self, target: str):
        mod_name, self.attr = target.split(":")
        self.module = importlib.import_module(mod_name)
        self.orig = getattr(self.module, self.attr)
        self.calls: list[dict] = []

        @functools.wraps(self.orig)
        def observed(*args, **kwargs):
            self.calls.append({"args": [_describe(a) for a in args],
                               "kwargs": {k: _describe(v)
                                          for k, v in kwargs.items()}})
            return self.orig(*args, **kwargs)

        setattr(self.module, self.attr, observed)

    def remove(self):
        setattr(self.module, self.attr, self.orig)


def _seconds(us: float) -> float:
    return us / 1e6


def _record(events, calls, probes) -> Record:
    device, host, host_dev = [], [], defaultdict(float)
    window = None
    for e in events:
        iv = Interval(e.name, _seconds(e.time_range.start),
                      _seconds(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the spans' images on the device's timeline are no work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in (WINDOW_SPAN, CALL_SPAN)
                    or e.name.startswith("ProfilerStep")):
                device.append(iv)
            continue
        if e.name == WINDOW_SPAN:
            window = iv
        elif not e.name.startswith("ProfilerStep"):
            host.append(iv)
            host_dev[e.name] += _seconds(e.device_time_total)
    return Record(calls, window, device, host, dict(host_dev),
                  {name: list(p.calls) for name, p in probes.items()})


def complete(rec: Record, kernels: dict[str, str]) -> bool:
    """The record holds its window and, for each probe, as many kernels of
    the probe's kernel name as the probe counted launches."""
    if rec.window is None:
        return False
    inside = rec.device_in_window()
    for probe, kernel in kernels.items():
        n = sum(1 for e in inside if kernel in e.name)
        if n != len(rec.launches.get(probe, ())):
            return False
    return True


def traced(call, calls: int, probe_targets: dict[str, str],
           kernels: dict[str, str], device) -> Record | None:
    """Profile ``calls`` calls of ``call()`` after one warm-up call, with
    the probes in place; up to ``TRIES`` sessions until one is complete.
    Returns the record, or None where every session lost a launch."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    else:  # the plain versions run on the host: no kernel to find
        kernels = {}
    for _ in range(TRIES):
        probes = {name: Probe(t) for name, t in probe_targets.items()}
        got = {}
        try:
            with torch.profiler.profile(
                    activities=activities,
                    schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                     active=1),
                    on_trace_ready=lambda p: got.setdefault(
                        "events", list(p.events())),
            ) as prof:
                call()
                _sync(device)
                prof.step()
                for p in probes.values():
                    p.calls.clear()
                with torch.profiler.record_function(WINDOW_SPAN):
                    for _ in range(calls):
                        with torch.profiler.record_function(CALL_SPAN):
                            call()
                    _sync(device)
                prof.step()
        finally:
            for p in probes.values():
                p.remove()
        rec = _record(got.get("events", []), calls, probes)
        if complete(rec, kernels):
            return rec
    return None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def merged(intervals: list[Interval], lo: float, hi: float):
    """The union of intervals clipped to [lo, hi], as sorted (start, end)."""
    spans = sorted((max(e.start, lo), min(e.end, hi)) for e in intervals
                   if e.end > lo and e.start < hi)
    out = []
    for s, t in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def busy_s(rec: Record) -> float:
    w = rec.window
    return sum(t - s for s, t in merged(rec.device, w.start, w.end))


def _short(name: str) -> str:
    """A name cut to ``NAME_CHARS`` characters."""
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS] + "..."


def device_ops(rec: Record) -> list[list]:
    """The ``TOP`` device operations by summed seconds in the window."""
    total = defaultdict(float)
    for e in rec.device_in_window():
        total[_short(e.name)] += e.end - e.start
    return [[name, s] for name, s in
            sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def idle_gaps(rec: Record) -> list[list]:
    """The device's idle time in the window, summed by what the host was
    doing: the innermost host op that spans each gap's midpoint."""
    w = rec.window
    busy = merged(rec.device, w.start, w.end)
    gaps, cursor = [], w.start
    for s, t in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, t)
    if cursor < w.end:
        gaps.append((cursor, w.end))
    ops = sorted((e for e in rec.host if e.end > w.start and e.start < w.end),
                 key=lambda e: e.start)
    total = defaultdict(float)
    active: list = []  # heap of (-start, index) of started host ops
    j = 0
    for s, t in sorted(gaps):
        mid = 0.5 * (s + t)
        while j < len(ops) and ops[j].start <= mid:
            heapq.heappush(active, (-ops[j].start, j))
            j += 1
        while active and ops[active[0][1]].end < mid:
            heapq.heappop(active)
        name = _short(ops[active[0][1]].name) if active else "(no host op)"
        total[name] += t - s
    return [[name, sec] for name, sec in
            sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def roofline_share(ctx, probe: str, kernel: str) -> float | None:
    """A kernel's share of its roofline over the traced sub-window, in %:
    the summed least times of the launches ``probe`` recorded (from
    ``roofline/<kernel>.py``) over the device time of the kernels of its
    name. None where nothing launched; never 0."""
    from portbench import spec

    rec = ctx.record
    if rec is None:
        return None
    roof = spec.load_module(ctx.root, "roofline", kernel)
    peaks = spec.load_module(ctx.root, "roofline", "peaks")
    costs = [c for c in map(roof.cost, rec.launches.get(probe, ())) if c]
    took = sum(e.end - e.start for e in rec.device_in_window()
               if roof.KERNEL in e.name)
    if not costs or took <= 0:
        return None
    bound = sum(peaks.bound_s(ops, kind, nbytes) for ops, kind, nbytes in costs)
    return 100.0 * bound / took
