"""integrator.device_ms_per_frame: device time of the traced frames'
operations other than the port's walk kernels, a frame, in ms
(torch.profiler)."""
from devtrace import kernel_of


def read(ctx):
    evs = ctx.get("dev_events")
    if not evs:
        return None
    return sum(d for name, _, d in evs if kernel_of(name) is None) / 1e6 / ctx["trace_frames"]
