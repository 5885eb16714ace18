"""setup.warmup_s: the benchmark's span around the warm frame (the
kernels' load, the allocator's growth, lazy tables), in seconds."""


def read(ctx):
    return ctx.get("spans", {}).get("warmup")
