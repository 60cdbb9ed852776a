"""flat.score_roofline: the flat scan's score blocks' share of their roofline
in the traced sub-window, in %: the summed least times of the blocks that a
probe on ``flat._scores`` recorded (``roofline/score_block.py`` from each
call's shapes, against ``roofline/peaks.py``) over the device time of the
kernels under the program's ``flat.score`` spans. It matches no kernel
name, so it reads the same work whatever kernels form the block. None where
nothing was recorded; never 0."""

from portbench import spec

PROBES = {"score": "lantern_tpu_torch.flat:_scores"}
SPAN = "flat.score"


def read(ctx):
    rec = ctx.record
    if rec is None:
        return None
    roof = spec.load_module(ctx.root, "roofline", "score_block")
    peaks = spec.load_module(ctx.root, "roofline", "peaks")
    costs = [c for c in map(roof.cost, rec.launches.get("score", ())) if c]
    took = rec.host_device_s.get(SPAN, 0.0)
    if not costs or took <= 0:
        return None
    bound = sum(peaks.bound_s(ops, kind, nbytes) for ops, kind, nbytes in costs)
    return 100.0 * bound / took
