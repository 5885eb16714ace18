"""entry.host_issue_ms_per_frame: host time of the port's render.pass
spans a traced frame less the host's waits for the device inside them
(synchronising CUDA API calls, spans.waits), in ms: the time the host takes to issue a frame's passes
(pbrt_tpu_torch/utils/trace.py spans, time.time_ns())."""
from spans import span_ms, wait_ns_in


def read(ctx):
    spans, apis = ctx.get("program_spans"), ctx.get("api_calls")
    if not spans or not apis:
        return None
    issue = span_ms(spans, "render.pass") - wait_ns_in(spans, apis, "render.pass") / 1e6
    return issue / ctx["trace_frames"]
