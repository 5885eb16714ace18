"""integrator.ns_per_glossy_hit: the integrator's device time a traced
frame (its operations other than the port's walk kernels, as
integrator.device_ms_per_frame reads them) over the frame's glossy hits,
the live lanes whose lobes hold a glossy reflection lobe summed over the
bounces (the port's glossy_hits counter), in ns. None where the program
does not count glossy hits or counts none."""
from devtrace import kernel_of


def read(ctx):
    evs = ctx.get("dev_events")
    hits = (ctx.get("counters") or {}).get("glossy_hits")
    if not evs or not hits:
        return None
    return sum(d for name, _, d in evs if kernel_of(name) is None) / ctx["trace_frames"] / hits
