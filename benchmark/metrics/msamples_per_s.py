"""msamples_per_s: pixel samples of every frame completed in the timed
window, over the window's time to the end of its last frame (host clock,
each frame ending in a synchronisation), in millions a second."""


def read(ctx):
    if not ctx.get("window_s"):
        return None
    return ctx["frames"] * ctx["samples_per_frame"] / ctx["window_s"] / 1e6
