"""dispatch.host_ms: host time of the program's ``search.dispatch`` spans
(``Index.search``'s ``mode="auto"`` choice: ``costmodel.memory_budget`` and
``choose_search_strategy``) in the traced sub-window, a call. None where the
program has no such span."""

SPAN = "search.dispatch"


def read(ctx):
    rec = ctx.record
    if rec is None:
        return None
    w = rec.window
    spans = [e for e in rec.host
             if e.name == SPAN and e.end > w.start and e.start < w.end]
    if not spans:
        return None
    return sum(e.end - e.start for e in spans) * 1e3 / rec.calls
