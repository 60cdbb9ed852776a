"""flat.select_ms: device time of the kernels launched under the program's
``flat.topk`` spans (the flat scan's row select of the score block, and the
running merge where the scan walks blocks) in the traced sub-window, a call.
None where the program has no such span."""

SPAN = "flat.topk"


def read(ctx):
    rec = ctx.record
    if rec is None:
        return None
    s = rec.host_device_s.get(SPAN, 0.0)
    return s * 1e3 / rec.calls if s > 0 else None
