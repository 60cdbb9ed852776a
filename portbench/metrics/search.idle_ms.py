"""search.idle_ms: the device's idle time inside the program's ``search``
spans (``Index.search``, nested ones counted once) in the traced
sub-window, a call: each span's interval less the union of the device's
intervals clipped to it. The idle that the program's own host code leaves
inside a call, apart from the harness's time between calls. None where the
program has no such span."""

from portbench import trace

SPAN = "search"


def read(ctx):
    rec = ctx.record
    if rec is None:
        return None
    w = rec.window
    calls = trace.merged([e for e in rec.host if e.name == SPAN],
                         w.start, w.end)
    if not calls:
        return None
    idle = 0.0
    for s, t in calls:
        idle += (t - s) - sum(b - a for a, b in trace.merged(rec.device, s, t))
    return idle * 1e3 / rec.calls
