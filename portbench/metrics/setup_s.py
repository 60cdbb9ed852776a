"""setup_s: process start to the window's start (data, the index build,
warm-up; in a checkout's first run, the kernels' builds too)."""


def read(ctx):
    return ctx.setup_s
