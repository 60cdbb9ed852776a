"""qps: every query answered in the window over the window's seconds (host
clock; the window ends when its last call's results are on the host)."""


def read(ctx):
    w = ctx.window
    return w["queries"] / w["seconds"] if w["seconds"] > 0 else None
