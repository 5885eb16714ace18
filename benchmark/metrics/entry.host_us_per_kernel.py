"""entry.host_us_per_kernel: host time of the port's render.pass spans,
less the host's waits for the device inside them (spans.waits), over the
device operations launched inside them, in us: the host's cost of issuing
one operation (spans.py joins each operation to its launch)."""
from spans import owners, span_ms, wait_ns_in, within


def read(ctx):
    spans, recs, apis = ctx.get("program_spans"), ctx.get("launches"), ctx.get("api_calls")
    if not spans or not recs or not apis:
        return None
    n = sum(1 for o in owners(spans, recs) if within(spans, o, "render.pass"))
    issue = span_ms(spans, "render.pass") - wait_ns_in(spans, apis, "render.pass") / 1e6
    return 1e3 * issue / n if n else None
