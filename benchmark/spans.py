"""The port's host spans against the device trace: which stage of the
render loop launched each device operation, and how long the host spent
in each stage.

The port records spans (pbrt_tpu_torch/utils/trace.py) under
`trace.recording()`: tuples (name, t0_ns, t1_ns, parent, frame), parent
the index of the enclosing span or -1, stamped with time.time_ns(), the
clock torch.profiler stamps its events with. Each device operation of a
profile shares a correlation id with its launch on the host (the CUDA
runtime's cudaLaunchKernel, cudaMemcpyAsync, ...), so it is put down to
the innermost span open on the host when it was launched; one launched
outside every span is `outside`, one whose launch the profile lacks
`unjoined`. A stage's host self time is its spans' time less the time of
the spans nested in them (self_ns repeats utils/trace.py's, as the
measuring code imports nothing of the program); its host wait is the time
of the synchronising CUDA API calls made in it.

`launch_records(prof)` -> [(name, start_ns, duration_ns, launch_ns or
None)], one record a device operation, and `api_calls(prof)` -> [(name,
start_ns, duration_ns)], one a CUDA API call on the host; the other
functions take spans and such records, so the tests build them by hand.
"""
from __future__ import annotations

OUTSIDE = "outside"
UNJOINED = "unjoined"


def is_launch(name):
    """Whether a host event is a call of the CUDA runtime or driver API
    (cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel, ...), which is what
    launches device work; the profiler's own host ops are "aten::..."."""
    return name.startswith("cu")


def launch_records(prof):
    """A finished profile's device operations, each with the host time of
    its launch (None where the profile holds no launch of its
    correlation id)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    launch, dev = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            dev.append((e.name(), e.start_ns(), e.duration_ns(), e.correlation_id()))
        elif is_launch(e.name()):
            launch[e.correlation_id()] = e.start_ns()
    return [(name, s, d, launch.get(c)) for name, s, d, c in dev]


def api_calls(prof):
    """A finished profile's CUDA runtime and driver API calls on the host
    -> [(name, start_ns, duration_ns)]."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() != cuda and is_launch(e.name())]


def innermost(spans, times):
    """For each host time, the index of the innermost span open at it
    ([t0, t1)), or -1."""
    marks = [(s[1], 1, i) for i, s in enumerate(spans)] + \
            [(s[2], 0, i) for i, s in enumerate(spans)] + \
            [(t, 2, j) for j, t in enumerate(times)]
    marks.sort()
    out, open_ = [-1] * len(times), []
    for _, kind, i in marks:
        if kind == 1:
            open_.append(i)
        elif kind == 0:
            open_.remove(i)
        else:
            out[i] = open_[-1] if open_ else -1
    return out


def owners(spans, recs):
    """Each record's span index (-1: outside every span, None: not
    joined to a launch)."""
    joined = [i for i, r in enumerate(recs) if r[3] is not None]
    found = innermost(spans, [recs[i][3] for i in joined])
    out = [None] * len(recs)
    for i, o in zip(joined, found):
        out[i] = o
    return out


def owner_name(spans, o):
    return UNJOINED if o is None else OUTSIDE if o < 0 else spans[o][0]


def within(spans, o, name):
    """Whether span o is, or is nested in, a span called `name`."""
    while o is not None and o >= 0:
        if spans[o][0] == name:
            return True
        o = spans[o][3]
    return False


def self_ns(spans):
    """Each span's host time less the time of the spans directly in it."""
    out = [s[2] - s[1] for s in spans]
    for s in spans:
        if s[3] >= 0:
            out[s[3]] -= s[2] - s[1]
    return out


def waits(apis):
    """Each API call's host time spent waiting for the device, in ns: the
    whole call for a synchronising one (cudaStreamSynchronize, behind
    every copy between host and device that is not asynchronous and
    every host read of a device value; cudaDeviceSynchronize,
    cudaEventSynchronize), else 0."""
    return [d if "Synchronize" in name else 0 for name, _, d in apis]


def wait_ns_in(spans, apis, name):
    """Summed wait (waits) of the API calls made inside spans called
    `name` (or nested in them)."""
    own = innermost(spans, [a[1] for a in apis])
    return sum(w for w, o in zip(waits(apis), own) if within(spans, o, name))


def span_ms(spans, name):
    """Summed host time of the spans called `name`, in ms."""
    return sum(s[2] - s[1] for s in spans if s[0] == name) / 1e6


def stages(spans, recs, frames, apis=()):
    """{span name: {"host_self_ms", "host_wait_ms", "kernels", "device_ms"}}
    a frame: the device operations put down to the innermost span at their
    launch (with `outside` and `unjoined` rows where there are such), and
    the host's waits in the API calls made while it was the innermost."""
    by = {}
    row = lambda name: by.setdefault(name, {"host_self_ms": 0.0, "host_wait_ms": 0.0,
                                            "kernels": 0, "device_ms": 0.0})
    for s, ns in zip(spans, self_ns(spans)):
        row(s[0])["host_self_ms"] += ns / 1e6 / frames
    own = innermost(spans, [a[1] for a in apis])
    for w, o in zip(waits(apis), own):
        row(owner_name(spans, o))["host_wait_ms"] += w / 1e6 / frames
    for r, o in zip(recs, owners(spans, recs)):
        st = row(owner_name(spans, o))
        st["kernels"] += 1 / frames
        st["device_ms"] += r[2] / 1e6 / frames
    return dict(sorted(by.items(), key=lambda kv: -kv[1]["device_ms"]))


def idle_gaps_by_span(spans, recs, n=10):
    """The device's idle gaps, each put down to the innermost span open on
    the host when the operation that ended it was launched, summed by
    span name -> the n largest as [[name, seconds]]."""
    own = owners(spans, recs)
    order = sorted(range(len(recs)), key=lambda i: recs[i][1])
    by, end = {}, None
    for i in order:
        s, e = recs[i][1], recs[i][1] + recs[i][2]
        if end is not None and s > end:
            k = owner_name(spans, own[i])
            by[k] = by.get(k, 0) + (s - end)
        end = e if end is None else max(end, e)
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def join_summary(spans, recs, frame="render.frame", lead_us=50.0):
    """How far the join holds: the device operations, those joined to a
    launch, those launched inside a `frame` span, the largest lead of an
    operation's start over its launch's host time (us; negative where
    every operation starts after its launch) and the operations that lead
    by over `lead_us`."""
    own = owners(spans, recs)
    leads = [(r[3] - r[1]) / 1e3 for r in recs if r[3] is not None]
    return {"kernels": len(recs), "joined": len(leads),
            "in_frame": sum(1 for o in own if within(spans, o, frame)),
            "max_lead_us": max(leads) if leads else None,
            "over_lead_us": sum(1 for x in leads if x > lead_us)}


def device_ms_in(ctx, names):
    """Device ms a frame of the operations whose innermost span at launch
    is called one of `names`, or None without spans or launch records."""
    spans, recs = ctx.get("program_spans"), ctx.get("launches")
    if not spans or not recs:
        return None
    ms = sum(r[2] for r, o in zip(recs, owners(spans, recs)) if owner_name(spans, o) in names)
    return ms / 1e6 / ctx["trace_frames"]
