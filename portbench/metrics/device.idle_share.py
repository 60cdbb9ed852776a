"""device.idle_share: the share of the traced sub-window in which no kernel
or copy runs (the union of the device's intervals in the profiler's
trace)."""

from portbench import trace


def read(ctx):
    rec = ctx.record
    if rec is None:
        return None
    w = rec.window.end - rec.window.start
    busy = trace.busy_s(rec)
    return 100.0 * (1.0 - busy / w) if busy > 0 and w > 0 else None
