"""setup_s: seconds from the process's start to the first timed frame:
imports, CUDA's start, the scene's writing and build, the kernels' load
and the warm frame (host clock)."""


def read(ctx):
    return ctx.get("setup_s")
