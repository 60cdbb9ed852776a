"""flat.score_ms: device time of the kernels launched under the program's
``flat.score`` spans (the flat scan's score block: the SGEMM and score
passes for f32, K4 with its epilogue for hamming) in the traced sub-window,
a call. None where the program has no such span."""

SPAN = "flat.score"


def read(ctx):
    rec = ctx.record
    if rec is None:
        return None
    s = rec.host_device_s.get(SPAN, 0.0)
    return s * 1e3 / rec.calls if s > 0 else None
