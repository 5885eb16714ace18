"""Bidirectional path tracing, emission sampling, the film's splats and
the camera's raster transform against pbrt_tpu.

_bdpt_sample and render_bdpt are held against the reference's outputs
committed in tests/torch_refs (make_refs.py ran pbrt_tpu jitted on the
CPU on the same scene text, lanes and seed), so no test here compiles a
JAX integrator; sample_le, the film and the camera are compared live
(eager and cheap).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import hold_ref
from torch_refs import cases as C

from pbrt_tpu import lights as JL
from pbrt_tpu.film import FilmState as JFilmState, add_splats as j_add_splats, develop as j_develop
from pbrt_tpu.scene import load_scene_string as j_load_scene_string
from pbrt_tpu_torch import lights as LT
from pbrt_tpu_torch.film import FilmState, add_splats, develop
from pbrt_tpu_torch.integrators.bdpt import _bdpt_sample, debug_strategies, render_bdpt
from pbrt_tpu_torch.scene import load_scene_string
from pbrt_tpu_torch.scene.bench import write_light_map, write_sky_exr

D = C.DEPTH + 1


def _lanes(ref):
    return [torch.as_tensor(ref[k]) for k in ("px", "py", "s")]


def _hold_splats(sp, sv, ref):
    """splat_v under hold_li's criterion; splat_p within 1e-4 pixels on
    >= 99.9% of rows."""
    sv, jsv = sv.numpy(), ref["splat_v"]
    assert sv.shape == jsv.shape
    ok = np.all(np.abs(sv - jsv) <= 1e-4 + 1e-3 * np.abs(jsv), axis=1)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(sv.mean() - jsv.mean()) <= 0.01 * abs(jsv.mean())
    close = np.abs(sp.numpy() - ref["splat_p"]).max(1) <= 1e-4
    assert close.mean() >= 0.999, close.mean()


@pytest.mark.parametrize("scene", C.BDPT_SCENES)
def test_bdpt_sample_matches_reference(scene):
    """1,024 lanes at depth 3: L and the splat values within hold_li's
    criterion (>= 99% of lanes within rtol 1e-3 / atol 1e-4, the means
    within 1%), p_film bit-equal, splat positions within 1e-4 pixels; the
    live-ray counts within 1% of the reference's (on the knot a camera
    ray meets a shared edge of two coplanar triangles at one t, where the
    reference's brute-force intersection takes the other triangle, and
    that lane's path ends a vertex earlier)."""
    ref = C.load(f"bdpt_{scene}")
    text = C.case_scene(scene, "bdpt")
    assert text == ref["scene"]
    cs = load_scene_string(text, device="cpu")
    L, p_film, sp, sv, cnt = _bdpt_sample(cs, *_lanes(ref), D, with_stats=True)
    mean = hold_ref(L, p_film, None, ref)
    assert mean > 0.01
    for k in ("camera_rays", "shadow_rays", "bounce_rays", "valid_hits"):
        assert abs(int(cnt[k]) - int(ref[f"cnt_{k}"])) <= 0.01 * int(ref[f"cnt_{k}"]), k
    _hold_splats(sp, sv, ref)
    if scene != "murk":
        assert float(sv.abs().sum()) > 0


@pytest.mark.parametrize("hook", C.BDPT_HOOKS)
def test_bdpt_hooks_match_reference(hook):
    """The hooks MLT drives, on the knot scene: st_filter keeps one (s, t)
    strategy; st_select one strategy a lane, its t = 1 lanes in L with
    their raster positions for p_film; sampler_fn with p_film_override
    traces the given film positions from a table of samples."""
    ref = C.load(f"bdpt_{hook}")
    text = C.case_scene("knot", "bdpt")
    assert text == ref["scene"]
    cs = load_scene_string(text, device="cpu")
    lanes = _lanes(ref)
    if hook == "st_filter":
        L, p_film, sp, sv = _bdpt_sample(cs, *lanes, D, st_filter=C.ST_FILTER)
        hold_ref(L, p_film, None, ref)
        _hold_splats(sp, sv, ref)
        assert float(sv.abs().sum()) == 0.0   # (2, 2) splats nothing
        return
    table, p_over, s_sel, t_sel = C.hook_inputs(int(ref["seed"]), cs.film.full_resolution[0])
    for k, v in (("table", table), ("p_over", p_over), ("s_sel", s_sel), ("t_sel", t_sel)):
        np.testing.assert_array_equal(v, ref[k])
    if hook == "st_select":
        L, p_film, sp, sv = _bdpt_sample(cs, *lanes, D, st_select=(torch.as_tensor(s_sel),
                                                                   torch.as_tensor(t_sel)))
        assert sp is None and sv is None
        close = np.abs(p_film.numpy() - ref["p_film"]).max(1) <= 1e-4
        assert close.mean() >= 0.999
        hold_ref(L, ref["p_film"], None, ref)
        assert (L.numpy()[t_sel == 1].sum(1) > 0).any()
        return
    tab = torch.as_tensor(table)
    L, p_film, sp, sv = _bdpt_sample(cs, *lanes, D,
                                     sampler_fn=lambda dim: tab[:, dim].contiguous(),
                                     p_film_override=torch.as_tensor(p_over))
    np.testing.assert_array_equal(p_film.numpy(), p_over)
    hold_ref(L, p_film, None, ref)
    _hold_splats(sp, sv, ref)


def test_render_bdpt_matches_reference():
    """render_bdpt on the env-lit scene at 16x16 and 4 spp against the
    reference's image: >= 99% of pixels within rtol 1e-3 / atol 1e-4, the
    means within 1%."""
    name, scene, res, spp = C.RENDER_CASE
    ref = C.load(name)
    text = C.case_scene(scene, "bdpt", res=res, spp=spp)
    assert text == ref["scene"]
    img, cnt, passes = render_bdpt(load_scene_string(text, device="cpu"))
    img, want = img.numpy(), ref["image"]
    assert img.shape == want.shape == (res, res, 3) and passes == spp
    ok = np.all(np.abs(img - want) <= 1e-4 + 1e-3 * np.abs(want), axis=2)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(img.mean() - want.mean()) <= 0.01 * want.mean()
    assert cnt["camera_rays"] == res * res * spp
    # the debug films at depth 3: s = 0 and s = 1 at t = 2..5, 6 with s, t >= 2, 3 with t = 1
    assert len(debug_strategies(C.DEPTH)) == 17


SEVEN_LIGHTS = """LookAt 0 2 6  0 0 0  0 1 0
Camera "perspective" "float fov" 45
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "02sequence" "integer pixelsamples" 2
Integrator "bdpt" "integer maxdepth" 2
WorldBegin
AttributeBegin
  Rotate -90 1 0 0
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
LightSource "point" "point from" [0 3 1] "rgb I" [4 4 4]
LightSource "distant" "point from" [1 4 2] "point to" [0 0 0] "rgb L" [1 0.9 0.8]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [5 5 5] "bool twosided" "true"
  Translate 0 3 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-1 0 -1 1 0 -1 1 0 1 -1 0 1]
AttributeEnd
LightSource "spot" "point from" [2 3 0] "point to" [0 0 0] "rgb I" [5 5 5]
AttributeBegin
  Material "plastic"
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-4 -1 -4  4 -1 -4  4 -1 4  -4 -1 4]
AttributeEnd
WorldEnd
"""


@pytest.fixture(scope="module")
def seven_lights(tmp_path_factory):
    d = tmp_path_factory.mktemp("lights")
    write_sky_exr(str(d / "sky.exr"), size=(64, 32))
    write_light_map(str(d / "gonio.exr"), (32, 16), seed=1)
    write_light_map(str(d / "proj.exr"), (20, 12), seed=2)
    return (j_load_scene_string(SEVEN_LIGHTS, cwd=str(d)),
            load_scene_string(SEVEN_LIGHTS, device="cpu", cwd=str(d)))


def test_sample_le_matches_reference(seven_lights):
    """4,096 emitted rays over the seven light kinds (the maps modulating
    the projection and goniometric ones): origins, directions and normals
    within 1e-4 (relative and absolute), radiance and densities within
    rtol 1e-4 (the spot's falloff: 1e-3), each on >= 99.9% of lanes."""
    jcs, cs = seven_lights
    lt = cs.data.lights
    assert sorted(lt.kind.tolist()) == list(range(7))
    n = 4096
    rng = np.random.default_rng(5)
    u1 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    idx = rng.integers(0, cs.flags.n_lights, n)
    le = LT.sample_le(lt, torch.as_tensor(idx), torch.as_tensor(u1), torch.as_tensor(u2),
                      cs.data.world_center, cs.data.world_radius)
    jd = jcs.data
    ref = JL.sample_le(jd.lights, jd, jnp.asarray(idx, jnp.int32), jnp.asarray(u1),
                       jnp.asarray(u2), jd.world_center, jd.world_radius)
    spot = lt.kind.numpy()[idx] == LT.L_SPOT
    for f, rtol, atol in (("o", 1e-4, 1e-4), ("d", 1e-4, 1e-4), ("n_light", 1e-4, 1e-4),
                          ("le", 1e-4, 1e-6), ("pdf_pos", 1e-4, 0.0), ("pdf_dir", 1e-4, 0.0)):
        g, w = getattr(le, f).numpy(), np.asarray(getattr(ref, f))
        tol = atol + np.where(spot, 1e-3 if f == "le" else rtol, rtol).reshape(
            (n,) + (1,) * (g.ndim - 1)) * np.abs(w)
        ok = (np.abs(g - w) <= tol).reshape(n, -1).all(1)
        assert ok.mean() >= 0.999, (f, ok.mean())
    lit = le.le.numpy().sum(1) > 0
    for k in range(7):   # the projection emits only inside its frustum
        assert lit[lt.kind.numpy()[idx] == k].mean() > (0.01 if k == LT.L_PROJECTION else 0.2), k


def test_camera_raster_transform_matches_reference(seven_lights):
    """camera_to_raster and screen_area, perspective and orthographic, are
    the reference's."""
    jcs, cs = seven_lights
    ortho = SEVEN_LIGHTS.replace('Camera "perspective" "float fov" 45',
                                 'Camera "orthographic" "float screenwindow" [-3 3 -2 2]')
    ortho = ortho.split("WorldBegin")[0] + "WorldBegin\nWorldEnd\n"
    for j, t in ((jcs.camera, cs.camera), (j_load_scene_string(ortho).camera,
                                           load_scene_string(ortho, device="cpu").camera)):
        np.testing.assert_array_equal(t.camera_to_raster, np.asarray(j.camera_to_raster))
        assert t.screen_area == j.screen_area
        np.testing.assert_array_equal(t.world_to_camera, np.linalg.inv(
            np.asarray(j.cam_to_world.start.m, np.float64)).astype(np.float32))


def test_film_splats_match_reference(seven_lights):
    """add_splats (the nearest pixel; non-finite values and positions off
    the film dropped) and develop's splat_scale against the reference on
    a cropped film; a film made without splats has none and develops as
    before: the filtered sum over the weights, scaled and clamped."""
    jcs, cs = seven_lights
    import dataclasses
    crop = (0.25, 1.0, 0.0, 0.75)
    jspec = dataclasses.replace(jcs.film, crop_window=crop)
    spec = dataclasses.replace(cs.film, crop_window=crop)
    rng = np.random.default_rng(7)
    n = 2048
    p = rng.uniform(-2, 18, (n, 2)).astype(np.float32)
    v = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    v[::97, 1] = np.nan
    v[::89, 0] = np.inf
    v[::13] = 0.0
    H, W = spec.cropped_resolution[1], spec.cropped_resolution[0]
    rgb = rng.uniform(0, 3, (H, W, 3)).astype(np.float32)
    wsum = rng.uniform(0, 2, (H, W)).astype(np.float32)
    wsum[::3, ::2] = 0.0
    st = FilmState(torch.as_tensor(rgb), torch.as_tensor(wsum), torch.zeros((H, W, 3)))
    st = add_splats(spec, add_splats(spec, st, torch.as_tensor(p), torch.as_tensor(v)),
                    torch.as_tensor(p[::-1].copy()), torch.as_tensor(v[:n // 2].repeat(2, 0)))
    jst = JFilmState(jnp.asarray(rgb), jnp.asarray(wsum), jnp.zeros((H, W, 3)))
    jst = j_add_splats(jspec, j_add_splats(jspec, jst, jnp.asarray(p), jnp.asarray(v)),
                       jnp.asarray(p[::-1].copy()), jnp.asarray(v[:n // 2].repeat(2, 0)))
    np.testing.assert_allclose(st.splat.numpy(), np.asarray(jst.splat), rtol=1e-6, atol=1e-6)
    assert (st.splat.numpy() > 0).mean() > 0.5
    np.testing.assert_allclose(develop(spec, st, splat_scale=0.25).numpy(),
                               np.asarray(j_develop(jspec, jst, splat_scale=0.25)),
                               rtol=1e-6, atol=1e-6)
    plain = FilmState.zeros(spec, "cpu")
    assert plain.splat is None
    plain = FilmState(torch.as_tensor(rgb), torch.as_tensor(wsum))
    w = torch.as_tensor(wsum)[..., None]
    before = torch.clamp(torch.where(w > 0.0, torch.as_tensor(rgb) / torch.clamp(w, min=1e-20),
                                     0.0) * spec.scale, min=0.0)
    assert torch.equal(develop(spec, plain), before)
