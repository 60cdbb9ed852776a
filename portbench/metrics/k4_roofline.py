"""k4_roofline: K4's share of its roofline in the traced sub-window (the
flat scan's score launches): the least time its launches could take
(``roofline/k4.py`` from each launch's shapes, against
``roofline/peaks.py``) over their device time."""

from portbench import trace

PROBES = {"k4": "lantern_tpu_torch.ops.hamming:_launch"}
ROOFLINES = {"k4": "k4"}


def read(ctx):
    return trace.roofline_share(ctx, "k4", "k4")
