"""build.seconds: host clock around set-up's ``Index.add(build=...)``,
ended by ``torch.cuda.synchronize()``."""


def read(ctx):
    return ctx.build_s
