"""walk.roofline_pct: the least time the frame's walks need (roofline.py:
the bytes the live rays and one read of the triangles a launch need, over
the HBM peak) over the walk kernels' device time, in percent."""
from devtrace import kernel_of
from roofline import walk_bound_ms


def read(ctx):
    walks = [d for name, _, d in ctx.get("dev_events") or () if kernel_of(name)]
    cnt = ctx.get("counters")
    if not walks or not cnt:
        return None
    k = ctx["trace_frames"]
    live = cnt["camera_rays"] + cnt["shadow_rays"] + cnt["bounce_rays"]
    ms = sum(walks) / 1e6 / k
    return 100.0 * walk_bound_ms(live, len(walks) / k, ctx["n_tris"]) / ms
