"""Environment-map, projection and goniometric lights, light selection and
the orthographic camera of the port against pbrt_tpu on the CPU, on
inputs made from a numpy seed: Distribution2D tables and sampled indices
bit-equal, its continuous values within 1e-6; the environment tables of
BASELINE config 3's scene bit-equal; sample_li / pdf_li / le_escaped on a
scene with an environment map, a goniometric and a projection light;
select_light for the power, uniform and spatial strategies (the spatial
grid against build_spatial_distrib); orthographic rays and differentials
within a few ulps."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pbrt_tpu import lights as JL
from pbrt_tpu.cameras import CameraSamples, generate_rays as j_generate_rays
from pbrt_tpu.core.sampling import Distribution2D as JD2, _row_searchsorted
from pbrt_tpu.integrators.common import select_light as j_select_light
from pbrt_tpu.lights.distrib import build_spatial_distrib as j_build_spatial
from pbrt_tpu.scene import load_scene as j_load_scene, load_scene_string as j_load_scene_string
from pbrt_tpu_torch import lights as LT
from pbrt_tpu_torch.cameras import generate_rays
from pbrt_tpu_torch.core.sampling import Distribution2D
from pbrt_tpu_torch.integrators.common import select_light
from pbrt_tpu_torch.scene import load_scene, load_scene_string
from pbrt_tpu_torch.scene.bench import write_env_material_scene, write_light_map, write_sky_exr
from pbrt_tpu_torch.scene.build import build_tables
from pbrt_tpu_torch.scene.api import Api
from pbrt_tpu_torch.scene.parser import parse_file


def _f2d(seed=0, h=24, w=40):
    """A positive 2D function with two zero rows and a zero column."""
    f = np.random.default_rng(seed).gamma(0.6, 1.0, (h, w)).astype(np.float32)
    f[3] = 0.0
    f[17] = 0.0
    f[:, 5] = 0.0
    return f


def test_distribution2d_tables_and_indices_bit_equal():
    """Tables bit-equal; the row and column of every sample (with u at
    exact CDF entries, where searchsorted's side decides) bit-equal;
    continuous (x, y) and pdf within 1e-6, pdf 0 in the zero rows."""
    f = _f2d()
    ref = JD2.build(f)
    got = Distribution2D.tables(f)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    d = Distribution2D.from_tables(*got, "cpu")
    rng = np.random.default_rng(1)
    u = rng.uniform(0, 1, (4096, 2)).astype(np.float32)
    u[:64, 1] = np.asarray(ref.marg_cdf)[rng.integers(0, f.shape[0], 64)]
    u[64:128, 0] = np.asarray(ref.cond_cdf)[3, rng.integers(0, f.shape[1], 64)]
    iy, ix, _ = d.indices(torch.as_tensor(u))
    h, w = f.shape
    jy = jnp.clip(jnp.searchsorted(ref.marg_cdf, u[:, 1], side="right") - 1, 0, h - 1)
    jx = jnp.clip(_row_searchsorted(ref.cond_cdf[jy], jnp.asarray(u[:, 0])) - 1, 0, w - 1)
    np.testing.assert_array_equal(iy.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(ix.numpy(), np.asarray(jx))
    xy, pdf = d.sample_continuous(torch.as_tensor(u))
    jxy, jpdf = ref.sample_continuous(jnp.asarray(u))
    np.testing.assert_allclose(xy.numpy(), np.asarray(jxy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-6, atol=1e-6)
    assert np.all(pdf.numpy()[np.isin(iy.numpy(), (3, 17))] == 0)
    np.testing.assert_allclose(d.pdf(xy).numpy(), np.asarray(ref.pdf(jxy)), rtol=1e-6)


@pytest.fixture(scope="module")
def env_scene(tmp_path_factory):
    """BASELINE config 3's small scene in both packages."""
    path = write_env_material_scene(str(tmp_path_factory.mktemp("env")), large=False, spp=4)
    return j_load_scene(path), load_scene(path, device="cpu"), path


def test_env_tables_equal_reference(env_scene):
    """The environment image, its luminance * sin(theta) tables, the light
    frames and the power distribution (with env_mean) bit-equal."""
    jcs, cs, path = env_scene
    api = Api()
    api.cwd = os.path.dirname(path)
    parse_file(path, api)
    t = build_tables(api.scene, api.cwd)
    jl = jcs.data.lights
    for k, j in (("env_image", "env_image"), ("env_func", "env_cond_func"),
                 ("env_cond_cdf", "env_cond_cdf"), ("env_cond_int", "env_cond_int"),
                 ("env_marg_cdf", "env_marg_cdf"), ("env_marg_int", "env_marg_int"),
                 ("light_l2w", "l2w"), ("light_w2l", "w2l"), ("light_params", "params")):
        np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(getattr(jl, j)), err_msg=k)
    np.testing.assert_array_equal(t["light_func"], np.asarray(jcs.data.light_distr.func))
    assert cs.data.lights.mapped == (0,)
    assert tuple(cs.data.lights.env.image.shape) == (256, 512, 3)


LIGHTS_SCENE = """
LookAt 0 2 6  0 0 0  0 1 0
Camera "perspective" "float fov" 45
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "02sequence" "integer pixelsamples" 2
Integrator "path" "integer maxdepth" 2 {STRATEGY}
WorldBegin
AttributeBegin
  Rotate -90 1 0 0
  Rotate 30 0 0 1
  LightSource "infinite" "string mapname" "sky.exr" "rgb scale" [0.5 0.5 0.5]
AttributeEnd
AttributeBegin
  Translate 0.5 3 1
  Rotate -70 1 0 0
  LightSource "goniometric" "string mapname" "gonio.exr" "rgb I" [8 8 8]
AttributeEnd
AttributeBegin
  Translate -1 2 2
  Rotate 150 1 0 0
  LightSource "projection" "string mapname" "proj.exr" "float fov" 50 "rgb I" [9 9 9]
AttributeEnd
LightSource "spot" "point from" [2 3 0] "point to" [0 0 0] "rgb I" [5 5 5]
AttributeBegin
  Material "plastic"
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-4 -1 -4  4 -1 -4  4 -1 4  -4 -1 4]
  Shape "sphere" "float radius" 0.7
AttributeEnd
WorldEnd
"""


@pytest.fixture(scope="module")
def lights_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("lights")
    write_sky_exr(str(d / "sky.exr"), size=(64, 32))
    write_light_map(str(d / "gonio.exr"), (32, 16), seed=1)
    write_light_map(str(d / "proj.exr"), (20, 12), seed=2)
    out = {}
    for name, strategy in (("power", ""), ("uniform", '"string lightsamplestrategy" "uniform"'),
                           ("spatial", '"string lightsamplestrategy" "spatial" '
                                       '"integer spatialvoxels" 4')):
        text = LIGHTS_SCENE.replace("{STRATEGY}", strategy)
        out[name] = (j_load_scene_string(text, cwd=str(d)),
                     load_scene_string(text, device="cpu", cwd=str(d)))
    return out


def test_light_table_holds_the_maps(lights_scene):
    jcs, cs = lights_scene["power"]
    lt = cs.data.lights
    assert lt.kind.tolist() == [LT.L_INFINITE, LT.L_GONIO, LT.L_PROJECTION, LT.L_SPOT]
    assert lt.mapped == (0,) and tuple(lt.limg.shape) == (2, 64, 64, 3)
    np.testing.assert_array_equal(lt.limg.numpy(), np.asarray(jcs.data.lights.limg))
    np.testing.assert_array_equal(lt.params.numpy(), np.asarray(jcs.data.lights.params))
    for k, L, p in zip(lt.kind.tolist(), lt.L.numpy(), lt.params.numpy()):
        assert LT.light_power(k, L, p, 1.5, 0.3) == JL.light_power(k, L, p, 1.5, 0.3)


def test_sample_li_pdf_li_le_escaped_match_reference(lights_scene):
    """4,096 lanes over every light: wi and p_light within rtol 2e-5, li
    and pdf within rtol 1e-4 on >= 99.9% of lanes (a direction on a map
    texel's edge may take the next texel), is_delta equal; pdf_li of the
    sampled directions and le_escaped of random ones likewise."""
    jcs, cs = lights_scene["power"]
    n = 4096
    rng = np.random.default_rng(5)
    ref_p = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    idx = rng.integers(0, cs.flags.n_lights, n)
    jd = jcs.data
    ls = LT.sample_li(cs.data.lights, torch.as_tensor(idx), torch.as_tensor(ref_p),
                      torch.as_tensor(u2), cs.data.world_radius)
    ref = JL.sample_li(jd.lights, jd, jnp.asarray(idx, jnp.int32), jnp.asarray(ref_p),
                       jnp.asarray(u2), jd.world_center, jd.world_radius)

    def share_close(g, w, rtol):
        g, w = np.asarray(g), np.asarray(w)
        ok = np.isclose(g, w, rtol=rtol, atol=1e-6)
        return ok.reshape(n, -1).all(1).mean()

    for f, rtol in (("wi", 2e-5), ("p_light", 2e-5), ("li", 1e-4), ("pdf", 1e-4)):
        assert share_close(getattr(ls, f), getattr(ref, f), rtol) >= 0.999, f
    np.testing.assert_array_equal(ls.is_delta.numpy(), np.asarray(ref.is_delta))
    kinds = cs.data.lights.kind.numpy()[idx]
    for k in (LT.L_GONIO, LT.L_PROJECTION, LT.L_INFINITE):
        li = ls.li.numpy()[kinds == k].sum(1)
        assert (li > 0).mean() > 0.2, k
    assert (ls.li.numpy()[kinds == LT.L_PROJECTION].sum(1) == 0).any()   # outside the frustum
    wi = ls.wi.numpy()
    one = np.ones(n, np.float32)
    got = LT.pdf_li(cs.data.lights, torch.as_tensor(idx), torch.as_tensor(one),
                    torch.as_tensor(one), torch.as_tensor(wi)).numpy()
    want = JL.pdf_li(jd.lights, jd, jnp.asarray(idx, jnp.int32), jnp.asarray(ref_p),
                     jnp.asarray(wi), jnp.asarray(one), jnp.asarray(one), jd.world_radius)
    assert share_close(got, want, 1e-4) >= 0.999
    inf = kinds == LT.L_INFINITE
    np.testing.assert_allclose(got[inf], ls.pdf.numpy()[inf], rtol=1e-3)   # its own samples
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    assert share_close(LT.le_escaped(cs.data.lights, cs.flags.infinite_light_ids,
                                     torch.as_tensor(rd)),
                       JL.le_escaped(jd.lights, jnp.asarray(rd)), 1e-5) >= 0.999


@pytest.mark.parametrize("strategy", ["power", "uniform", "spatial"])
def test_select_light_matches_reference(lights_scene, strategy):
    """2,048 lanes at random points: light index bit-equal, pmf and u_remap
    within 1e-6; the spatial grid (4 voxels a side) against
    build_spatial_distrib within rtol 1e-5 (its per-voxel sums of 128
    samples add up in another order), and its picks equal except where u
    lies within 1e-5 of a CDF step. A weight far below its voxel's largest
    is held to 1e-5 of that largest one instead."""
    jcs, cs = lights_scene[strategy]
    n = 2048
    rng = np.random.default_rng(7)
    p = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    u = rng.uniform(0, 1, n).astype(np.float32)
    if strategy == "spatial":
        jsd = j_build_spatial(jcs.data, jcs.flags, max_voxels=4)
        sd = cs.data.light_spatial
        got, want = sd.func.numpy(), np.asarray(jsd.func)
        assert np.all(np.abs(got - want) <= 1e-5 * np.maximum(np.abs(want),
                                                              want.max(1, keepdims=True)))
        np.testing.assert_allclose(sd.cdf.numpy(), np.asarray(jsd.cdf), rtol=1e-5, atol=1e-7)
        assert sd.nvox == tuple(int(v) for v in np.asarray(jsd.nvox))
        jcs = dataclasses.replace(jcs, data=jcs.data._replace(light_spatial=jsd))
    idx, pmf, ur = select_light(cs, torch.as_tensor(p), torch.as_tensor(u))
    jidx, jpmf, jur = j_select_light(jcs, jnp.asarray(p), jnp.asarray(u))
    same = idx.numpy() == np.asarray(jidx)
    if strategy == "spatial":
        row = cs.data.light_spatial.cdf.numpy()[_voxels(cs, p)]
        near = (np.abs(row - u[:, None]) < 1e-5).any(1)
        assert np.all(same | near) and same.mean() > 0.99
    else:
        assert same.all()
    np.testing.assert_allclose(pmf.numpy()[same], np.asarray(jpmf)[same], rtol=1e-5)
    np.testing.assert_allclose(ur.numpy()[same], np.asarray(jur)[same], rtol=1e-4, atol=1e-5)


def _voxels(cs, p):
    from pbrt_tpu_torch.lights.distrib import _voxel_index
    return _voxel_index(cs.data.light_spatial, torch.as_tensor(p)).numpy()


def test_orthographic_rays_match_reference():
    """Origins, directions and both differentials within 4 ulps of their
    largest component."""
    text = """LookAt 1 2 5  0 0 0  0 1 0
Camera "orthographic" "float screenwindow" [-1.3 1.3 -1 1]
Film "image" "integer xresolution" [20] "integer yresolution" [16]
Sampler "random" "integer pixelsamples" 1
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
WorldEnd"""
    cs, jcs = load_scene_string(text, device="cpu"), j_load_scene_string(text)
    n = 1024
    p_film = np.random.default_rng(3).uniform(0, 16, (n, 2)).astype(np.float32)
    got, w = generate_rays(cs.camera, torch.as_tensor(p_film), differentials=True)
    rays, jw = j_generate_rays(jcs.camera, CameraSamples(jnp.asarray(p_film), jnp.zeros((n, 2)),
                                                         jnp.zeros(n)))
    for k in ("o", "d", "rx_o", "rx_d", "ry_o", "ry_d"):
        want = np.asarray(getattr(rays, k))
        np.testing.assert_allclose(getattr(got, k).numpy(), want, rtol=0,
                                   atol=4 * np.spacing(np.abs(want).max()), err_msg=k)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
