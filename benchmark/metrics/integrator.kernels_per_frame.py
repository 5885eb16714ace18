"""integrator.kernels_per_frame: device operations of the traced frames
other than the port's walk kernels, a frame (torch.profiler)."""
from devtrace import kernel_of


def read(ctx):
    evs = ctx.get("dev_events")
    if not evs:
        return None
    return sum(1 for name, _, _ in evs if kernel_of(name) is None) / ctx["trace_frames"]
