"""The samplers and depth of field on whole scenes, against pbrt_tpu: lens
rays, BASELINE configs 2 (stratified, a PLY mesh) and 4 (glass and a
mirror through a lens, Sobol'), and the default sampler of a scene with
no Sampler line."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import (REPO, front_end_tables, hold_li, jax_scene_file)

from pbrt_tpu.cameras import CameraSamples, generate_rays as j_generate_rays
from pbrt_tpu.integrators.path import li_path as j_li_path
from pbrt_tpu.scene import load_scene_string as j_load_scene_string
from pbrt_tpu_torch.cameras import generate_rays
from pbrt_tpu_torch.integrators.path import li_path
from pbrt_tpu_torch.io.image_io import read_png
from pbrt_tpu_torch.scene import load_scene, load_scene_string
from pbrt_tpu_torch.scene.bench import write_config2_scene, write_config4_scene
from pbrt_tpu_torch.scene.bridge import from_jax_arrays, tables_from_jax_arrays

LENS = """LookAt 1 2 5  0 0 0  0 1 0
Camera "{KIND}" "float lensradius" 0.3 "float focaldistance" 4.5 {EXTRA}
Film "image" "integer xresolution" [20] "integer yresolution" [16]
Sampler "random" "integer pixelsamples" 1
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
WorldEnd"""
CAMERAS = {"perspective": '"float fov" 50', "orthographic": '"float screenwindow" [-1.3 1.3 -1 1]'}


def _lens_rays(kind):
    text = LENS.replace("{KIND}", kind).replace("{EXTRA}", CAMERAS[kind])
    cs, jcs = load_scene_string(text, device="cpu"), j_load_scene_string(text)
    rng = np.random.default_rng(7)
    p_film = rng.uniform(0, 16, (1024, 2)).astype(np.float32)
    u_lens = rng.uniform(0, 1, (1024, 2)).astype(np.float32)
    got, w = generate_rays(cs.camera, torch.as_tensor(p_film), True, torch.as_tensor(u_lens))
    rays, jw = j_generate_rays(jcs.camera, CameraSamples(jnp.asarray(p_film), jnp.asarray(u_lens),
                                                         jnp.zeros(1024)))
    return cs, got, w, rays, jw, p_film


@pytest.mark.parametrize("kind", list(CAMERAS))
def test_lens_rays_match_reference(kind):
    """Depth of field: origins on the lens, directions through the plane of
    focus, and both differentials, within 4 ulps of their largest
    component."""
    cs, got, w, rays, jw, _ = _lens_rays(kind)
    assert cs.camera.lens_radius == 0.3 and cs.camera.focal_distance == 4.5
    for k in ("o", "d", "rx_o", "rx_d", "ry_o", "ry_d"):
        want = np.asarray(getattr(rays, k))
        np.testing.assert_allclose(getattr(got, k).numpy(), want, rtol=0,
                                   atol=4 * np.spacing(np.abs(want).max()), err_msg=k)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def test_orthographic_lens_differentials_stay_lens_free():
    """The reference (and so the port) leaves the orthographic camera's
    differentials off the lens: their origins are the unlensed raster
    points one pixel over and their direction is the lensed main ray's,
    where pbrt-v3 moves them onto the lens too."""
    cs, got, _, _, _, p_film = _lens_rays("orthographic")
    plain, _ = generate_rays(cs.camera.__class__(**{**cs.camera.__dict__, "lens_radius": 0.0}),
                             torch.as_tensor(p_film), True)
    assert torch.equal(got.rx_o, plain.rx_o) and torch.equal(got.ry_o, plain.ry_o)
    assert torch.equal(got.rx_d, got.d) and torch.equal(got.ry_d, got.d)
    assert not torch.allclose(got.o, plain.o) and not torch.allclose(got.d, plain.d)


@pytest.fixture(scope="module", params=["config2", "config4"])
def config(request, tmp_path_factory):
    """The small variant of BASELINE config 2 (stratified 4x4, the small
    knot from a PLY file) or 4 (a glass knot and a mirror through a lens,
    Sobol'), 64x64, in the reference with kernel tables -> (its CPU-path
    scene, arrays, specs, the scene file)."""
    d = str(tmp_path_factory.mktemp(request.param))
    path = (write_config2_scene(d, large=False) if request.param == "config2"
            else write_config4_scene(d, large=False, spp=16))
    return (*jax_scene_file(path), path)


def test_config_front_end_tables_equal_bridge(config):
    """The port's front end gives the reference's tables, sampler and
    camera (lens included), and the bridged scene's flags."""
    _, arrays, specs, path = config
    want = tables_from_jax_arrays(arrays)
    got = front_end_tables(path)
    assert set(got) == set(want)
    for k in want:
        if k != "bvh":
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    ours, theirs = load_scene(path, device="cpu"), from_jax_arrays(arrays, specs, device="cpu")
    assert ours.flags == theirs.flags and ours.sampler == theirs.sampler
    assert ours.camera.lens_radius == theirs.camera.lens_radius
    assert ours.camera.focal_distance == theirs.camera.focal_distance
    assert ours.sampler.kind in ("stratified", "sobol") and ours.sampler.rounded_spp() == 16


def test_config_li_path_matches_reference(config):
    """li_path of configs 2 and 4, 1,024 lanes at depth 3."""
    jcpu, _, _, path = config
    assert hold_li(j_li_path, li_path, jcpu, load_scene(path, device="cpu"), 1024, 64, 16, 3,
                   seed=8) > 0.02


def test_scene_without_sampler_line_renders_with_halton(tmp_path):
    """pbrt's default sampler is halton at 16 spp: a scene with no Sampler
    line renders through the CLI on the CPU (the constant environment,
    sRGB 188 everywhere)."""
    out = tmp_path / "halton.png"
    scene = tmp_path / "halton.pbrt"
    scene.write_text(f"""Camera "perspective" "float fov" 45
Film "image" "integer xresolution" [8] "integer yresolution" [8] "string filename" "{out}"
Integrator "path" "integer maxdepth" 1
WorldBegin
LightSource "infinite" "rgb L" [0.5 0.5 0.5]
WorldEnd
""")
    assert load_scene(str(scene), device="cpu").sampler.kind == "halton"
    res = subprocess.run([sys.executable, "-m", "pbrt_tpu_torch", "--device", "cpu", "--quiet",
                          str(scene)], env=dict(os.environ, PYTHONPATH=REPO), cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "error" not in res.stderr, res.stderr
    img = read_png(str(out))
    assert img.shape == (8, 8, 3) and np.all(img == 188)
