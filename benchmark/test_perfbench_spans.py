"""CPU tests of spans.py and the span metrics' readers on synthetic spans
and device events: the join by correlation id, the innermost span at a
launch, self time, the waits in synchronising CUDA API calls, idle gaps
named by span, and readers that find nothing
or leave the existing metrics as they were. Run with `python -m pytest
benchmark/ -q` from the repository's root."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

import harness
import spans as S

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ["entry.host_issue_ms_per_frame", "entry.wait_ms_per_frame", "entry.host_us_per_kernel",
       "integrator.sampler_device_ms_per_frame", "integrator.bsdf_device_ms_per_frame"]

# one frame (times in us, as ns * 1000): a pass holding a sampler draw and
# li.bsdf, which holds a sampler draw of its own; then the wait
US = 1000
SPANS = [("render.frame", 0, 100 * US, -1, 1), ("render.pass", 10 * US, 90 * US, 0, 1),
         ("sampler", 20 * US, 30 * US, 1, 1), ("li.bsdf", 40 * US, 60 * US, 1, 1),
         ("sampler", 45 * US, 50 * US, 3, 1), ("render.wait", 92 * US, 98 * US, 0, 1)]
# (name, device start, duration, launch): launched in the first sampler,
# the nested sampler, li.bsdf, the frame alone, outside every span, and
# one whose launch the profile lacks
RECS = [("hash", 26 * US, 5 * US, 25 * US), ("hash2", 48 * US, 2 * US, 47 * US),
        ("Mul", 70 * US, 10 * US, 55 * US), ("copy", 6 * US, 1 * US, 5 * US),
        ("late", 200 * US, 3 * US, 150 * US), ("lost", 300 * US, 4 * US, None)]
# (name, host start, duration) of CUDA API calls: the launches above, an
# upload in li.bsdf that waits 9 us for the stream, the readback in
# render.wait that waits 4 us, and a slow launch, which is no wait
APIS = [("cudaLaunchKernel", 25 * US, 2 * US), ("cudaLaunchKernel", 47 * US, 2 * US),
        ("cudaMemcpyAsync", 52 * US, 1 * US), ("cudaStreamSynchronize", 53 * US, 9 * US),
        ("cudaLaunchKernel", 55 * US, 12 * US), ("cudaMemcpyAsync", 5 * US, 1 * US),
        ("cudaStreamSynchronize", 93 * US, 4 * US), ("cudaLaunchKernel", 150 * US, 2 * US)]


class _Ev:
    def __init__(self, name, dev, corr, start, dur):
        self._v = (name, dev, corr, start, dur)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]


class _Prof:
    def __init__(self, evs):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: evs)})})()


def test_launch_records_join_by_correlation_id():
    """A device event takes the host start of the CUDA API call with its
    correlation id; host ops of the profiler (aten::) and device events
    without a launch are not joined."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    prof = _Prof([_Ev("cudaLaunchKernel", cpu, 7, 1000, 5), _Ev("aten::mul", cpu, 8, 1500, 9),
                  _Ev("Mul", cuda, 7, 1200, 30), _Ev("cudaMemcpyAsync", cpu, 9, 2000, 5),
                  _Ev("Memcpy HtoD", cuda, 9, 2100, 40), _Ev("orphan", cuda, 8, 3000, 10)])
    assert S.launch_records(prof) == [("Mul", 1200, 30, 1000), ("Memcpy HtoD", 2100, 40, 2000),
                                      ("orphan", 3000, 10, None)]
    assert S.api_calls(prof) == [("cudaLaunchKernel", 1000, 5), ("cudaMemcpyAsync", 2000, 5)]


def test_innermost_span_at_launch():
    """Each operation goes to the innermost span open at its launch
    ([t0, t1)); one launched outside every span is `outside`, one not
    joined `unjoined`."""
    own = S.owners(SPANS, RECS)
    assert own == [2, 4, 3, 0, -1, None]
    assert [S.owner_name(SPANS, o) for o in own] == [
        "sampler", "sampler", "li.bsdf", "render.frame", S.OUTSIDE, S.UNJOINED]
    assert S.innermost(SPANS, [10 * US, 90 * US, 92 * US, 98 * US]) == [1, 0, 5, 0]
    assert [S.within(SPANS, o, "render.pass") for o in own] == [True, True, True, False,
                                                                False, False]


def test_self_time_and_stages():
    """Self time is a span's time less its children's; the stage table
    sums it, the synchronising API calls made in each name and the
    operations put down to each name, a frame."""
    assert S.self_ns(SPANS) == [14 * US, 50 * US, 10 * US, 15 * US, 5 * US, 6 * US]
    assert S.waits(APIS) == [0, 0, 0, 9 * US, 0, 0, 4 * US, 0]
    assert S.wait_ns_in(SPANS, APIS, "render.pass") == 9 * US
    assert S.wait_ns_in(SPANS, APIS, "render.frame") == 13 * US
    table = S.stages(SPANS, RECS, frames=2, apis=APIS)
    assert table["render.pass"] == {"host_self_ms": 0.025, "host_wait_ms": 0.0, "kernels": 0,
                                    "device_ms": 0.0}
    assert table["sampler"]["host_self_ms"] == pytest.approx(0.0075)
    assert table["sampler"]["kernels"] == 1
    assert table["sampler"]["device_ms"] == pytest.approx(0.0035)
    assert table["li.bsdf"] == pytest.approx({"host_self_ms": 0.0075, "host_wait_ms": 0.0045,
                                             "kernels": 0.5, "device_ms": 0.005})
    assert table["render.wait"]["host_wait_ms"] == pytest.approx(0.002)
    assert S.stages(SPANS, RECS, frames=2)["li.bsdf"]["host_wait_ms"] == 0.0
    assert table[S.OUTSIDE]["kernels"] == 0.5 and table[S.UNJOINED]["device_ms"] == 0.002
    assert list(table)[0] == "li.bsdf"      # by device time
    assert S.span_ms(SPANS, "render.pass") == 0.08


def test_idle_gaps_named_by_span_and_join_summary():
    """Each device idle gap goes to the span that launched the operation
    ending it; the summary counts joins, operations in a frame span and
    the largest lead of a start over its launch."""
    gaps = dict(S.idle_gaps_by_span(SPANS, RECS))
    # device busy 6-7, 26-31, 48-50, 70-80, 200-203, 300-304 (us)
    assert gaps == pytest.approx({"sampler": 36e-6, "li.bsdf": 20e-6, S.OUTSIDE: 120e-6,
                                  S.UNJOINED: 97e-6})
    assert S.join_summary(SPANS, RECS) == {"kernels": 6, "joined": 5, "in_frame": 4,
                                           "max_lead_us": -1.0, "over_lead_us": 0}
    late = RECS[:2] + [("early", 50 * US, 1 * US, 60 * US)]
    assert S.join_summary(SPANS, late, lead_us=5)["over_lead_us"] == 1


def _ctx(**more):
    evs = [(n, s, d) for n, s, d, _ in RECS] + [
        ("void walk_kernel<true, true, false>(...)", 400 * US, 50 * US)]
    ctx = {"dev_events": evs, "trace_frames": 1, "busy_s": 1e-4, "untraced_frame_s": 1e-3,
           "counters": {"camera_rays": 100, "shadow_rays": 50, "bounce_rays": 80},
           "n_tris": 1000, "spans": {"scene_build": 1.5, "warmup": 2.5}}
    ctx.update(more)
    return ctx


@pytest.mark.parametrize("name", NEW)
def test_span_readers_find_nothing_without_spans(name):
    read = harness.reader(name)
    assert read({}) is None and read(_ctx()) is None
    if name.startswith("integrator."):
        assert read(_ctx(program_spans=SPANS)) is None, "needs the launch records too"
    else:
        assert read(_ctx(program_spans=SPANS, launches=RECS)) is None, "needs the API calls too"


def test_span_readers_read_the_spans():
    """The pass's 80 us less its 9 us of waiting issue 3 operations; the
    frame waits 13 us in all."""
    ctx = _ctx(program_spans=SPANS, launches=RECS, api_calls=APIS)
    got = {n: harness.reader(n)(ctx) for n in NEW}
    assert got == pytest.approx({"entry.host_issue_ms_per_frame": 0.071,
                                 "entry.wait_ms_per_frame": 0.013,
                                 "entry.host_us_per_kernel": 71 / 3,
                                 "integrator.sampler_device_ms_per_frame": 0.007,
                                 "integrator.bsdf_device_ms_per_frame": 0.01})


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_existing_readers_ignore_the_new_keys(name):
    read = harness.reader(name)
    assert read(_ctx(program_spans=SPANS, launches=RECS, api_calls=APIS)) == read(_ctx())
