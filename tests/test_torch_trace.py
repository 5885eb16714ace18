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


# a metal sphere and a matte one over a plastic floor, 16x16 at 4 spp, depth 2:
# glossy lobes on most hits, not on all
GLOSSY_SCENE = """
LookAt 0 2 5  0 0 0  0 1 0
Camera "perspective" "float fov" 45
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "random" "integer pixelsamples" 4
Integrator "path" "integer maxdepth" 2
WorldBegin
LightSource "infinite" "rgb L" [0.4 0.5 0.6]
AttributeBegin
Material "metal" "float roughness" 0.05
Shape "sphere" "float radius" 1
AttributeEnd
AttributeBegin
Translate 1.8 0 0
Material "matte" "rgb Kd" [0.7 0.2 0.1]
Shape "sphere" "float radius" 0.6
AttributeEnd
AttributeBegin
Material "plastic" "rgb Kd" [0.3 0.3 0.3] "rgb Ks" [0.4 0.4 0.4] "float roughness" 0.2
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-5 -1 -5  5 -1 -5  5 -1 5  -5 -1 5]
AttributeEnd
WorldEnd
"""


def _spans_of(cs):
    trace.take()
    with trace.recording():
        img, cnt, _ = render(cs, OPTS)
    return img, cnt, trace.take()


def test_glossy_span_only_where_the_scene_is_glossy():
    """bsdf.glossy opens inside NEE (bsdf_f, bsdf_pdf) and BSDF sampling on
    a glossy scene, a bounce each, and never on a matte one."""
    _, _, spans = _spans_of(load_scene_string(GLOSSY_SCENE, device="cpu"))
    glossy = [s for s in spans if s.name == "bsdf.glossy"]
    parents = [spans[s.parent].name for s in glossy]
    # two passes, two bounces: bsdf_f and bsdf_pdf in li.nee; the sampling
    # half and bsdf_f and bsdf_pdf of the drawn direction in li.bsdf
    assert parents.count("li.nee") == 2 * 2 * 2 and parents.count("li.bsdf") == 2 * 2 * 3
    _, _, spans = _spans_of(_scene())
    assert spans and not any(s.name == "bsdf.glossy" for s in spans)


def test_glossy_hits_count_the_glossy_lanes(monkeypatch):
    """glossy_hits is the sum over bounces of the live lanes on a metal or
    plastic surface, counted here from the material kinds at NEE; a matte
    scene has no such counter."""
    from pbrt_tpu_torch.integrators import path as P
    from pbrt_tpu_torch.materials import M_METAL, M_PLASTIC
    cs = load_scene_string(GLOSSY_SCENE, device="cpu")
    seen = []
    prepare = P.prepare_one_light

    def counting(cs_, si, lobes, active, *args):
        kind = cs_.data.mats.kind[torch.clamp(si.material, min=0).to(torch.int64)]
        seen.append(int((active & ((kind == M_METAL) | (kind == M_PLASTIC))).sum()))
        return prepare(cs_, si, lobes, active, *args)
    monkeypatch.setattr(P, "prepare_one_light", counting)
    _, cnt, passes = render(cs, OPTS)
    assert len(seen) == passes * MAX_DEPTH
    assert cnt["glossy_hits"] == sum(seen)
    assert 0 < cnt["glossy_hits"] < cnt["valid_hits"]
    monkeypatch.undo()
    assert set(render(_scene(), OPTS)[1]) == set(P.COUNTERS)


def test_glossy_frame_is_the_same_with_spans_on():
    cs = load_scene_string(GLOSSY_SCENE, device="cpu")
    img_off, cnt_off, _ = render(cs, OPTS)
    img_on, cnt_on, spans = _spans_of(cs)
    assert any(s.name == "bsdf.glossy" for s in spans)
    assert torch.equal(img_on, img_off) and cnt_on == cnt_off


def test_matte_shapes_count_no_glossy_hits():
    """Where every shape is matte, glossy_hits is not counted and issues no
    op, though a plastic declared and given to no shape (as config 2's
    floor line) turns the glossy family on: the counters are COUNTERS
    alone, the render issues fewer ops than with the counter forced on
    (which counts 0), and the same ops in the same order with spans
    recorded or not."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from pbrt_tpu_torch.integrators.path import COUNTERS

    def ops_of(cs, on=False):
        trace.take()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            if on:
                with trace.recording():
                    cnt = render(cs, OPTS)[1]
            else:
                cnt = render(cs, OPTS)[1]
        trace.take()
        return cnt, [e.name() for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("aten::")]

    cs = load_scene_string(SCENE.replace('Material "matte"', 'Material "plastic"\nMaterial "matte"'),
                           device="cpu")
    assert cs.flags.bsdf_fams[1] and cs.flags.shaded_kinds == (0,)
    cnt, off = ops_of(cs)
    assert set(cnt) == set(COUNTERS)
    assert len(off) > 100 and ops_of(cs, on=True)[1] == off
    forced = dataclasses.replace(cs, flags=dataclasses.replace(cs.flags,
                                                               shaded_kinds=cs.flags.mat_kinds))
    cnt, more = ops_of(forced)
    assert cnt["glossy_hits"] == 0 and len(more) > len(off)


def test_cli_stats_reports_glossy(tmp_path, capsys):
    """--stats prints the glossy hits beside the other counters and the
    bsdf.glossy span's self ms under Timing."""
    scene = tmp_path / "g.pbrt"
    scene.write_text(GLOSSY_SCENE)
    STATS.clear()
    assert main(["--device", "cpu", "--quiet", "--stats", "--wavefront", "512",
                 "--outfile", str(tmp_path / "g.png"), str(scene)]) == 0
    out = capsys.readouterr().out
    assert "    Glossy hits" in out and "    bsdf.glossy self ms" in out
