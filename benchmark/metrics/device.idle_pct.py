"""device.idle_pct: share of a frame's wall in which no device operation
runs, in percent: the device's busy time a frame (the union of the
profiler's device intervals over the traced frames) over the wall time a
frame of the frames rendered just before them without the profiler (host
clock, from a synchronised start to a synchronised end). The profiler's
host overhead slows a host-paced frame, so the traced frames' own wall
would overstate the idle share."""


def read(ctx):
    if not ctx.get("untraced_frame_s") or not ctx.get("dev_events"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["trace_frames"] / ctx["untraced_frame_s"])
