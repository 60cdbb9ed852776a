"""flat.scale_ms: device time of the kernels launched under the program's
``flat.scale`` spans (the in-place passes that follow the GEMM in a cosine
or i8 score block: the column scale, then the mask) in the traced
sub-window, a call. None where the program has no such span."""

SPAN = "flat.scale"


def read(ctx):
    rec = ctx.record
    if rec is None:
        return None
    s = rec.host_device_s.get(SPAN, 0.0)
    return s * 1e3 / rec.calls if s > 0 else None
