"""The port's host spans (utils/trace.py): off by default and then free,
nested as the render loop and li_path's stages nest, one frame id a
render, on the profiler's clock, and without effect on the image."""
import time

import pytest
import torch

from pbrt_tpu_torch.__main__ import main
from pbrt_tpu_torch.render import render
from pbrt_tpu_torch.scene import load_scene_string
from pbrt_tpu_torch.utils import trace
from pbrt_tpu_torch.utils.options import Options
from pbrt_tpu_torch.utils.stats import STATS

# a lit sphere, 16x16 at 4 spp, depth 2: two passes at 512 lanes
SCENE = """
LookAt 0 0 5  0 0 0  0 1 0
Camera "perspective" "float fov" 45
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "random" "integer pixelsamples" 4
Integrator "path" "integer maxdepth" 2
WorldBegin
LightSource "infinite" "rgb L" [0.4 0.5 0.6]
AttributeBegin
Material "matte" "rgb Kd" [0.7 0.2 0.1]
Shape "sphere" "float radius" 1
AttributeEnd
WorldEnd
"""
OPTS = Options(wavefront_size=2 * 16 * 16)
MAX_DEPTH = 2
LI_ONCE = ("li.camera", "li.intersect")
LI_BOUNCE = ("li.lobes", "li.nee", "li.bsdf", "li.pair")


def _scene(integrator='"path" "integer maxdepth" 2'):
    return load_scene_string(SCENE.replace('"path" "integer maxdepth" 2', integrator),
                             device="cpu")


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def test_off_records_nothing():
    """With recording off, span() is the one shared no-op and a render
    leaves no span."""
    trace.take()
    assert trace.span("render.pass") is trace.span("li.bsdf") is trace.OFF
    render(_scene(), OPTS)
    assert trace.take() == []


def test_spans_nest_as_the_render_loop():
    """One render.frame a call, holding render.setup, one render.pass a
    pass, render.develop and render.wait; each pass holds li_path's
    stages (li.pair once a bounce that runs) and film.deposit; samplers
    nest under stages; one frame id a call, a new one the next call; the
    image is the same with recording off."""
    cs = _scene()
    want = render(cs, OPTS)[0]
    trace.take()
    with trace.recording():
        got, _, passes = render(cs, OPTS)
        render(cs, OPTS)
    spans = trace.take()
    assert torch.equal(got, want)
    assert passes == 2
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in roots] == ["render.frame"] * 2
    first = [s for s in spans if s.frame == spans[roots[0]].frame]
    assert len(first) == roots[1] and {s.frame for s in spans[roots[1]:]} == {
        spans[roots[1]].frame} != {spans[roots[0]].frame}
    top = [s.name for s in _children(spans, roots[0])]
    assert top == ["render.setup", "render.pass", "render.pass", "render.develop", "render.wait"]
    for i in (i for i in range(roots[1]) if spans[i].name == "render.pass"):
        names = [s.name for s in _children(spans, i)]
        assert names[:2] == list(LI_ONCE) and names[-1] == "film.deposit"
        for stage in LI_BOUNCE:
            assert names.count(stage) == MAX_DEPTH, stage
        assert names.count("li.emit") == MAX_DEPTH + 1
        assert "li.rr" not in names          # roulette starts after bounce 3
    samplers = [s for s in spans if s.name == "sampler"]
    assert samplers and all(spans[s.parent].name.startswith("li.") for s in samplers)
    assert {spans[s.parent].name for s in samplers} >= {"li.camera", "li.nee", "li.bsdf"}
    for s in spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    assert trace.span("render.pass") is trace.OFF


@pytest.mark.parametrize("integrator", [
    '"bdpt" "integer maxdepth" 2',
    '"sppm" "integer maxdepth" 2 "integer iterations" 2 "float radius" 0.5',
    '"mlt" "string target" "path" "integer maxdepth" 2 "integer bootstrapsamples" 64 '
    '"integer chains" 16 "integer mutationsperpixel" 2'])
def test_drivers_share_one_frame(integrator):
    """render() opens render.frame around every driver, so the spans of a
    BDPT, SPPM or MLT render (samplers, and li_path's stages under MLT's
    path target) nest in it and share its frame id."""
    cs = _scene(integrator)
    trace.take()
    with trace.recording():
        render(cs, OPTS)
    spans = trace.take()
    assert spans[0].name == "render.frame" and spans[0].parent == -1
    assert len(spans) > 10 and all(s.parent >= 0 for s in spans[1:])
    assert {s.frame for s in spans} == {spans[0].frame}
    names = {s.name for s in spans}
    assert "sampler" in names or "li.pair" in names


def test_self_time_and_timing_report():
    """A span's self time is its time less its children's; the report
    puts each name's self ms a frame into a Timing distribution."""
    S = trace.Span
    spans = [S("render.frame", 0, 10_000_000, -1, 1), S("render.pass", 1_000_000, 9_000_000, 0, 1),
             S("sampler", 2_000_000, 3_000_000, 1, 1), S("sampler", 4_000_000, 6_000_000, 1, 1),
             S("render.frame", 20_000_000, 24_000_000, -1, 2)]
    assert trace.self_ns(spans) == [2_000_000, 5_000_000, 1_000_000, 2_000_000, 4_000_000]
    STATS.clear()
    trace.report_timing(STATS, spans)
    assert STATS.distributions["Timing/render.frame self ms"] == [6.0, 2.0, 2.0, 4.0]
    assert STATS.distributions["Timing/sampler self ms"] == [3.0, 1.0, 3.0, 3.0]
    STATS.clear()


def test_spans_share_the_profilers_clock():
    """Inside a torch.profiler CPU profile, every op of the render lies in
    its render.frame span, and no op crosses a render.pass span's edge:
    spans and the profile read one clock, time.time_ns()'s."""
    from torch.profiler import ProfilerActivity, profile
    cs = _scene()
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording():
            render(cs, OPTS)
    spans = trace.take()
    evs = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()]
    frame = spans[0]
    assert frame.name == "render.frame" and len(evs) > 100
    assert all(frame.t0_ns <= s and e <= frame.t1_ns for s, e in evs)
    for p in (s for s in spans if s.name == "render.pass"):
        inside = [(s, e) for s, e in evs if p.t0_ns <= s < p.t1_ns]
        assert inside and all(e <= p.t1_ns for _, e in inside)
        assert not any(s < p.t0_ns < e for s, e in evs)
    assert abs(frame.t0_ns - time.time_ns()) < 60e9


def test_cli_stats_reports_timing(tmp_path, capsys):
    """--stats records the render's spans and reports each name's self
    ms a frame under Timing; recording is off again after it."""
    scene = tmp_path / "s.pbrt"
    scene.write_text(SCENE)
    STATS.clear()
    assert main(["--device", "cpu", "--quiet", "--stats", "--wavefront", "512",
                 "--outfile", str(tmp_path / "s.png"), str(scene)]) == 0
    out = capsys.readouterr().out
    assert "  Timing\n" in out
    for name in ("render.pass", "render.wait", "li.bsdf", "li.pair", "sampler"):
        assert f"    {name} self ms" in out, name
    assert trace.span("sampler") is trace.OFF and trace.take() == []
