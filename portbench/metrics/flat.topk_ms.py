"""flat.topk_ms: device time of the kernels under ``aten::topk`` in the
traced sub-window, a call."""


def read(ctx):
    rec = ctx.record
    if rec is None:
        return None
    s = rec.host_device_s.get("aten::topk", 0.0)
    return s * 1e3 / rec.calls if s > 0 else None
