"""The run-time options against pbrt_tpu: checkpoint and resume, the
statistics report, the preview image and the CLI's flags for them.

Nothing here compiles a JAX integrator: the checkpoint files and the
StatsAccumulator are held against the reference's own host code.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_refs import cases as C

from pbrt_tpu_torch import render as R
from pbrt_tpu_torch.film import FilmState
from pbrt_tpu_torch.io.image_io import read_png
from pbrt_tpu_torch.render import render, render_sampler_integrator
from pbrt_tpu_torch.scene import load_scene_string
from pbrt_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from pbrt_tpu_torch.utils.options import Options
from pbrt_tpu_torch.utils.stats import STATS, StatsAccumulator

# tests/test_checkpoint.py's scene seen from outside its sphere: 16x16 at 4
# spp, one pass a sample index at a wavefront of 256 lanes
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
LANES = 16 * 16


def test_resume_equals_a_straight_render(tmp_path):
    """A render that saves a checkpoint every 2 of its 4 passes leaves one
    at sample 2 (none after the last pass); a render resumed from it takes
    the 2 passes left and equals the straight-through render bit for bit."""
    ck = str(tmp_path / "ck.npz")
    cs = load_scene_string(SCENE, device="cpu")
    want, cnt, passes = render_sampler_integrator(cs, Options(wavefront_size=LANES))
    assert passes == 4 and float(want.sum()) > 0
    render_sampler_integrator(cs, Options(wavefront_size=LANES, checkpoint_path=ck,
                                          checkpoint_every=2))
    film, s, _ = load_checkpoint(ck)
    assert s == 2 and film.splat is None and float(film.weight_sum.sum()) > 0
    got, cnt2, passes2 = render_sampler_integrator(
        cs, Options(wavefront_size=LANES, checkpoint_path=ck, resume=True))
    assert passes2 == 2 and cnt2["camera_rays"] == 2 * LANES
    assert torch.equal(got, want)
    # a missing or corrupt checkpoint starts the render afresh
    (tmp_path / "bad.npz").write_bytes(b"not a checkpoint")
    assert load_checkpoint(str(tmp_path / "bad.npz")) is None
    assert load_checkpoint(str(tmp_path / "none.npz")) is None
    got, _, passes3 = render_sampler_integrator(
        cs, Options(wavefront_size=LANES, checkpoint_path=str(tmp_path / "bad.npz"),
                    resume=True))
    assert passes3 == 4 and torch.equal(got, want)


def test_checkpoint_loads_across_packages(tmp_path):
    """A checkpoint the port writes loads in pbrt_tpu with the same film,
    cursor and meta, and one pbrt_tpu writes loads in the port; a film
    without splats saves zeros."""
    from pbrt_tpu.film import FilmState as JFilm
    from pbrt_tpu.utils.checkpoint import load_checkpoint as j_load, save_checkpoint as j_save
    rng = np.random.default_rng(4)
    rgb = rng.uniform(0, 2, (5, 7, 3)).astype(np.float32)
    w = rng.uniform(0, 1, (5, 7)).astype(np.float32)
    save_checkpoint(str(tmp_path / "port.npz"), FilmState(torch.as_tensor(rgb), torch.as_tensor(w)),
                    9, {"spp": np.int64(16)})
    jfilm, js, jmeta = j_load(str(tmp_path / "port.npz"))
    assert js == 9 and int(jmeta["spp"]) == 16
    np.testing.assert_array_equal(np.asarray(jfilm.rgb_sum), rgb)
    np.testing.assert_array_equal(np.asarray(jfilm.weight_sum), w)
    assert not np.asarray(jfilm.splat).any()
    splat = rng.uniform(0, 1, (5, 7, 3)).astype(np.float32)
    j_save(str(tmp_path / "ref.npz"), JFilm(jnp.asarray(rgb), jnp.asarray(w), jnp.asarray(splat)),
           3)
    film, s, meta = load_checkpoint(str(tmp_path / "ref.npz"))
    assert s == 3 and meta == {}
    for mine, ref in ((film.rgb_sum, rgb), (film.weight_sum, w), (film.splat, splat)):
        np.testing.assert_array_equal(mine.numpy(), ref)


def _fill(acc, seed):
    rng = np.random.default_rng(seed)
    acc.report_counter("Intersections/Camera rays traced", 1024)
    acc.report_counter("Intersections/Camera rays traced", 2048)
    acc.report_counter("Integrator/Sample batches", 3)
    acc.report_counter("Memory/Film pixels", 1234567)
    acc.report_distribution("Performance/Mpaths per second", rng.uniform(0, 9, 5))
    acc.report_distribution("Performance/Mpaths per second", 2.5)
    acc.report_ratio("Film/Nonzero pixels", 200, 256)
    acc.report_ratio("Integrator/Acceptance rate", 0, 0)


def test_stats_report_is_the_references():
    """The same counters, distributions and ratios give the reference's
    report letter for letter; a sampler integrator's render reports the
    reference's names, its device counters summed over the passes."""
    from pbrt_tpu.utils.stats import StatsAccumulator as JStats
    mine, ref = StatsAccumulator(), JStats()
    _fill(mine, 5)
    _fill(ref, 5)
    assert mine.format() == ref.format()
    assert mine.format().startswith("Statistics:\n  Film\n    Nonzero pixels")
    STATS.clear()
    img, cnt, passes = render_sampler_integrator(load_scene_string(SCENE, device="cpu"),
                                                 Options(wavefront_size=LANES))
    assert set(STATS.counters) == {
        "Intersections/Camera rays traced", "Intersections/Shadow rays traced",
        "Intersections/Bounce rays traced", "Intersections/Valid hits",
        "Integrator/Paths terminated by RR", "Integrator/Camera rays traced",
        "Integrator/Sample batches", "Integrator/Wavefront size", "Memory/Film pixels"}
    assert STATS.counters["Intersections/Valid hits"] == cnt["valid_hits"] > 0
    assert STATS.counters["Integrator/Camera rays traced"] == 4 * LANES
    assert STATS.counters["Integrator/Sample batches"] == passes == 4
    assert set(STATS.distributions) == {"Performance/Mpaths per second"}
    lit = float((img.sum(-1) > 0).sum())
    assert STATS.ratios["Film/Nonzero pixels"] == [lit, float(LANES)] and lit > 0
    STATS.clear()


@pytest.mark.parametrize("kind,names", [
    ("bdpt", {"Performance/BDPT render seconds"}),
    ("mlt", {"Performance/MLT render seconds"}),
])
def test_driver_stats_are_the_references(kind, names):
    """BDPT and MLT report the reference's names: BDPT its device counters
    and its seconds, MLT its acceptance rate, mutations, bootstrap samples
    and seconds."""
    line = {"bdpt": 'Integrator "bdpt" "integer maxdepth" 1',
            "mlt": 'Integrator "mlt" "integer maxdepth" 1 "integer bootstrapsamples" 256 '
                   '"integer chains" 64 "integer mutationsperpixel" 2'}[kind]
    STATS.clear()
    _, cnt, _ = render(load_scene_string(C.integrator_form_scene(line), device="cpu"))
    assert set(STATS.distributions) == names
    if kind == "bdpt":
        assert STATS.counters["Intersections/Camera rays traced"] == cnt["camera_rays"] == 128
    else:
        assert STATS.counters["Integrator/MLT mutations"] == cnt["mutations"] > 0
        assert STATS.counters["Integrator/MLT bootstrap samples"] == 256
        assert STATS.ratios["Integrator/Acceptance rate"] == [cnt["mutations_accepted"],
                                                             cnt["mutations"]]
    STATS.clear()


def test_preview_written_every_n_passes(tmp_path, monkeypatch):
    """preview_every 1 over 4 passes writes the image so far after each
    pass but the last, to preview_path; the last preview is the image
    after 3 of the 4 sample indices."""
    writes = []
    real = R.write_image
    monkeypatch.setattr(R, "write_image", lambda p, img: (writes.append(p), real(p, img)))
    cs = load_scene_string(SCENE, device="cpu")
    path = str(tmp_path / "preview.png")
    render_sampler_integrator(cs, Options(wavefront_size=LANES, preview_every=1,
                                          preview_path=path))
    assert writes == [path] * 3
    img = read_png(path)
    assert img.shape == (16, 16, 3) and img.max() > 0


def test_cli_runtime_flags(tmp_path, monkeypatch, capsys):
    """--stats prints the report after the scene; --checkpoint with
    --checkpoint-every 1 leaves a checkpoint at sample 3 of 4; --resume
    renders the pass left to the same image; --preview 1 writes the image
    so far after each pass but the last (to the output file: the CLI has
    no preview path)."""
    from pbrt_tpu_torch.__main__ import main
    scene = tmp_path / "s.pbrt"
    scene.write_text(SCENE)
    out, ck = str(tmp_path / "out.png"), str(tmp_path / "ck.npz")
    base = ["--device", "cpu", "--quiet", "--wavefront", str(LANES), "--outfile", out]
    writes = []
    real = R.write_image
    monkeypatch.setattr(R, "write_image", lambda p, img: (writes.append(p), real(p, img)))
    STATS.clear()
    assert main(base + ["--stats", "--preview", "1", "--checkpoint", ck, "--checkpoint-every",
                        "1", str(scene)]) == 0
    report = capsys.readouterr().out
    assert report.startswith("Statistics:\n") and "    Camera rays traced" in report
    assert "Intersections" in report and not STATS.counters
    assert writes == [out] * 4        # 3 previews, then the image
    assert load_checkpoint(ck)[1] == 3
    first = read_png(out)
    assert main(base + ["--resume", "--checkpoint", ck, str(scene)]) == 0
    assert np.array_equal(read_png(out), first)
    STATS.clear()
