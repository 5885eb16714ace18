"""The slice as a whole: the port's front end, li_path and the render driver
against pbrt_tpu, and the port running with JAX absent."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import REPO, jax_bench_scene, jax_scene_arrays, lanes

from pbrt_tpu.integrators.path import li_path as j_li_path
from pbrt_tpu_torch.integrators.path import li_path
from pbrt_tpu_torch.io.image_io import read_png, write_png
from pbrt_tpu_torch.render import Options, render_sampler_integrator
from pbrt_tpu_torch.scene import load_scene_string
from pbrt_tpu_torch.scene.bench import SCENE, build_bench_scene, bench_description
from pbrt_tpu_torch.scene.bridge import from_jax_arrays, tables_from_jax_arrays
from pbrt_tpu_torch.scene.build import build_tables

SMOKE = """
Camera "perspective" "float fov" 45
Film "image" "integer xresolution" [8] "integer yresolution" [8] "string filename" "{OUT}"
Sampler "random" "integer pixelsamples" 1
Integrator "path" "integer maxdepth" 1
WorldBegin
LightSource "infinite" "rgb L" [0.5 0.5 0.5]
WorldEnd
"""


@pytest.fixture(scope="module")
def scenes():
    jcpu, jcs = jax_bench_scene(large=False)
    arrays, specs = jax_scene_arrays(jcs)
    return jcpu, arrays, specs


def test_bench_scene_text_is_the_reference_scene():
    sys.path.insert(0, REPO)
    import __graft_entry__
    assert SCENE == __graft_entry__._SCENE
    assert 'Material "matte" "rgb Kd" [0.5 0.5 0.5]' == __graft_entry__._FLOOR_PLAIN


def test_front_end_tables_equal_bridge(scenes):
    _, arrays, specs = scenes
    want = tables_from_jax_arrays(arrays)
    got = build_tables(bench_description(large=False))
    assert set(got) == set(want)
    for k in want:
        if k == "bvh":
            for f in ("metas", "nodes", "tris", "order", "seed", "seed_slots"):
                assert torch.equal(getattr(got[k], f), getattr(want[k], f)), f
            assert got[k].max_depth == want[k].max_depth
            assert np.array_equal(got[k].wlo, want[k].wlo)
        else:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    ours = build_bench_scene(large=False)
    theirs = from_jax_arrays(arrays, specs)
    assert np.array_equal(ours.camera.raster_to_camera, theirs.camera.raster_to_camera)
    assert np.array_equal(ours.camera.cam_to_world, theirs.camera.cam_to_world)
    assert ours.film == theirs.film and ours.sampler == theirs.sampler
    assert ours.flags == theirs.flags


def test_li_path_matches_reference(scenes):
    """1024 lanes, depth 4: >= 99% of lanes within rtol 1e-3 / atol 1e-4,
    the mean within 1%, and the same live-ray counts."""
    jcpu, arrays, specs = scenes
    cs = from_jax_arrays(arrays, specs)
    px, py, s = lanes(1024, 64, 4, seed=4)
    L, p_film, w, cnt = li_path(cs, *(torch.as_tensor(a) for a in (px, py, s)), max_depth=4)
    jL, jp, jw, jcnt = j_li_path(jcpu, jnp.asarray(px), jnp.asarray(py), jnp.asarray(s),
                                 max_depth=4, with_stats=True)
    L, jL = L.numpy(), np.asarray(jL)
    ok = np.all(np.abs(L - jL) <= 1e-4 + 1e-3 * np.abs(jL), axis=1)
    assert ok.mean() >= 0.99
    assert abs(L.mean() - jL.mean()) <= 0.01 * abs(jL.mean())
    assert L.mean() > 0.05
    np.testing.assert_array_equal(p_film.numpy(), np.asarray(jp))
    for k in ("camera_rays", "shadow_rays", "bounce_rays", "valid_hits"):
        assert abs(int(cnt[k]) - float(jcnt[k])) <= 0.01 * float(jcnt[k]), k


def test_render_driver_is_deterministic_and_finite():
    opts = Options(crop_window=(0.375, 0.5, 0.375, 0.5), wavefront_size=128)
    cs = build_bench_scene(large=False, options=opts)
    img1, cnt, passes = render_sampler_integrator(cs, opts)
    img2, _, _ = render_sampler_integrator(cs, opts)
    assert img1.shape == (8, 8, 3) and passes == 2
    assert torch.isfinite(img1).all() and float(img1.sum()) > 0
    assert torch.equal(img1, img2)
    assert cnt["camera_rays"] == 8 * 8 * 4


def test_smoke_scene_renders_without_jax(tmp_path):
    """A process with jax blocked imports the port and renders the
    constant-environment scene: every pixel is sRGB 188."""
    scene = tmp_path / "smoke.pbrt"
    out = tmp_path / "smoke.png"
    scene.write_text(SMOKE.replace("{OUT}", str(out)))
    code = ("import sys; sys.modules['jax'] = None; sys.modules['pbrt_tpu'] = None\n"
            "from pbrt_tpu_torch.__main__ import main\n"
            f"sys.exit(main(['--device', 'cpu', '--quiet', {str(scene)!r}]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    img = read_png(str(out))
    assert img.shape == (8, 8, 3) and np.all(img == 188)


def test_png_round_trip(tmp_path):
    rgb = np.random.default_rng(0).uniform(0, 1, (5, 7, 3)).astype(np.float32)
    write_png(str(tmp_path / "a.png"), rgb)
    got = read_png(str(tmp_path / "a.png"))
    from pbrt_tpu_torch.io.image_io import to_srgb8
    assert np.array_equal(got, to_srgb8(rgb))


@pytest.mark.parametrize("directive,what", [
    ('Shape "sphere"', "shape 'sphere'"),
    ('Material "glass"\nShape "trianglemesh" "integer indices" [0 1 2] "point P" [0 0 0 1 0 0 0 1 0]',
     "material 'glass'"),
    ('LightSource "point"', "light 'point'"),
    ('Texture "t" "color" "checkerboard"', "Texture 't'"),
    ('ObjectBegin "o"', "ObjectBegin 'o'"),
    ('MakeNamedMedium "m" "string type" "homogeneous"', "MakeNamedMedium 'm'"),
])
def test_unported_directives_raise(directive, what):
    text = SMOKE.replace("{OUT}", "x.png").replace("WorldEnd", directive + "\nWorldEnd")
    with pytest.raises(NotImplementedError, match=what):
        load_scene_string(text)


@pytest.mark.parametrize("line,what", [
    ('Sampler "halton"', "sampler 'halton'"),
    ('Integrator "bdpt"', "integrator 'bdpt'"),
    ('Camera "orthographic"', "camera 'orthographic'"),
    ('Accelerator "kdtree"', "accelerator 'kdtree'"),
])
def test_unported_options_raise(line, what):
    text = SMOKE.replace("{OUT}", "x.png").replace("WorldBegin", line + "\nWorldBegin")
    with pytest.raises(NotImplementedError, match=what):
        load_scene_string(text)
