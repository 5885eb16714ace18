"""walk.device_ms_per_frame: device time of the port's walk kernels
(csrc/bvh_traverse.cu and its siblings, by name) a frame, in ms
(torch.profiler)."""
from devtrace import kernel_of


def read(ctx):
    walks = [d for name, _, d in ctx.get("dev_events") or () if kernel_of(name)]
    if not walks:
        return None
    return sum(walks) / 1e6 / ctx["trace_frames"]
