"""entry.wait_ms_per_frame: host time a traced frame spends in the
synchronising CUDA API calls made in the port's render.frame span
(cudaStreamSynchronize behind each blocking copy or host read of a device
value), in ms: how long the host waits for the device (spans.waits)."""
from spans import wait_ns_in


def read(ctx):
    spans, apis = ctx.get("program_spans"), ctx.get("api_calls")
    if not spans or not apis:
        return None
    return wait_ns_in(spans, apis, "render.frame") / 1e6 / ctx["trace_frames"]
