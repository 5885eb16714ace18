"""Shared helpers of the tests that hold pbrt_tpu_torch against pbrt_tpu.

Importing this module caps torch at one thread: the suite runs in several
worker processes on a few cores. Inputs are made with numpy from a seed
and handed to both packages; the JAX side stays on the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def pallas_tables():
    """Make pbrt_tpu's scene build emit the kernel tables (pbvh, slot_attr)
    on the CPU, as it does on a TPU."""
    old = os.environ.get("PBRT_TPU_PALLAS")
    os.environ["PBRT_TPU_PALLAS"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["PBRT_TPU_PALLAS"]
        else:
            os.environ["PBRT_TPU_PALLAS"] = old


def jax_bench_scene(large=False):
    """The reference's benchmark scene with kernel tables -> (cs for the
    reference's CPU path, the same scene with the kernel tables)."""
    import sys
    sys.path.insert(0, REPO)
    from __graft_entry__ import _build_scene
    with pallas_tables():
        cs = _build_scene(large=large)
    cpu = dataclasses.replace(cs, flags=dataclasses.replace(cs.flags, use_pallas=False))
    return cpu, cs


def jax_scene_arrays(cs):
    """pbrt_tpu CompiledScene -> (arrays, specs) for bridge.from_jax_arrays."""
    d = cs.data
    a = lambda x: None if x is None else np.asarray(x)
    arrays = {"n_tris": cs.flags.n_tris, "n_world_tris": cs.flags.n_world_tris,
              "n_lights": cs.flags.n_lights, "n_quadrics": cs.flags.n_quadrics,
              "tri_attr": a(d.tri_attr), "slot_attr": a(d.slot_attr),
              "world_center": a(d.world_center), "world_radius": a(d.world_radius)}
    for k in ("metas", "nodes", "tris", "order", "seed", "seed_slots", "wlo", "whi"):
        arrays[f"pbvh.{k}"] = None if d.pbvh is None else a(getattr(d.pbvh, k))
    for k in ("metas", "nodes", "tris", "order", "imat", "iroot", "ianim", "i2w", "w2p",
              "wlo", "whi"):
        arrays[f"ibvh.{k}"] = None if d.ibvh is None else a(getattr(d.ibvh, k))
    for k in ("quad_type", "quad_o2w", "quad_w2o", "quad_params", "quad_prim", "prim_material",
              "prim_light", "prim_rev"):
        arrays[k] = a(getattr(d, k))
    for k in ("kind", "const", "misc", "tex", "child"):
        arrays[f"mats.{k}"] = a(getattr(d.mats, k))
    arrays["bsdf_fams"] = cs.flags.bsdf_fams
    arrays["n_fourier"] = int(cs.flags.has_fourier and d.fourier.mu.shape[0])
    for k in ("mu", "a", "eta", "n_mu", "a0y", "cdf"):
        arrays[f"fourier.{k}"] = a(getattr(d.fourier, k))
    for k in ("kind", "params", "child", "w2t", "image_id", "atlas", "atlas_size",
              "atlas_levels"):
        arrays[f"tex.{k}"] = a(getattr(d.tex, k))
    arrays["n_textures"] = d.tex.kind.shape[0] if cs.flags.tex_kinds else 0
    for k in ("kind", "L", "params", "tri_cdf", "ltri_p0", "ltri_p1", "ltri_p2", "l2w", "w2l",
              "limg", "env_image", "env_cond_func", "env_cond_cdf", "env_cond_int",
              "env_marg_cdf", "env_marg_int"):
        arrays[f"lights.{k}"] = a(getattr(d.lights, k))
    for k in ("func", "cdf", "func_int"):
        arrays[f"light_distr.{k}"] = a(getattr(d.light_distr, k))
    arrays["lights.medium"] = a(d.lights.medium)
    arrays["n_media"], arrays["any_grid_media"] = cs.flags.n_media, cs.flags.any_grid_media
    arrays["prim_medium"], arrays["camera_medium"] = a(d.prim_medium), a(d.camera_medium)
    for k in ("kind", "sigma_a", "sigma_s", "params", "w2m", "density"):
        arrays[f"media.{k}"] = a(getattr(d.media, k))
    cam, film, s = cs.camera, cs.film, cs.sampler
    f = film.filter
    specs = {
        "camera": dict(kind=cam.kind, raster_to_camera=np.asarray(cam.raster_to_camera),
                       cam_to_world=np.asarray(cam.cam_to_world.start.m),
                       shutter_open=cam.shutter_open, shutter_close=cam.shutter_close,
                       resolution=tuple(cam.resolution), lens_radius=cam.lens_radius,
                       focal_distance=cam.focal_distance,
                       camera_to_raster=np.asarray(cam.camera_to_raster),
                       screen_area=cam.screen_area),
        "film": dict(full_resolution=tuple(film.full_resolution),
                     crop_window=tuple(film.crop_window), filename=film.filename,
                     scale=film.scale, max_sample_luminance=film.max_sample_luminance),
        "filter": dict(kind=f.kind, xwidth=f.xwidth, ywidth=f.ywidth, alpha=f.alpha,
                       b=f.b, c=f.c, tau=f.tau),
        "sampler": dict(kind=s.kind, spp=s.spp, seed=s.seed, resolution=tuple(s.resolution),
                        xsamples=s.xsamples, ysamples=s.ysamples, jitter=s.jitter,
                        dimensions=s.dimensions, owen=s.owen),
        "integrator_kind": cs.integrator_kind,
        "integrator_params": dict(cs.integrator_params),
    }
    return arrays, specs


def lanes(n, res, spp, seed=0):
    """n (px, py, sample) lanes drawn from a numpy seed -> int32 arrays."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, res, n).astype(np.int32), rng.integers(0, res, n).astype(np.int32),
            rng.integers(0, spp, n).astype(np.int32))


def rays_at_knot(n, seed=0):
    """Rays from a shell around the knot toward random points inside it,
    with zeroed direction components on every 7th / 11th ray."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32) - o
    d[::7, 0] = 0.0
    d[::11, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def rays_at_grid(n, seed=0):
    """Rays from a shell of radius 12 around the instanced bench scene's
    grid toward points inside it, with times in [-0.25, 1.25)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 12.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    o[:, 1] = np.abs(o[:, 1])
    d = rng.uniform([-6.0, -1.0, -6.0], [6.0, 1.2, 6.0], (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    time = rng.uniform(-0.25, 1.25, n)
    return o.astype(np.float32), d.astype(np.float32), time.astype(np.float32)


def needs_cuda():
    """Skip the calling test unless a CUDA device is present (decided at
    run time, never at import)."""
    import pytest
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def hold_li(j_li, li, jcs, cs, n, res, spp, depth, seed):
    """An integrator of both packages on n lanes (px, py < res, samples <
    spp) at `depth`: >= 99% of lanes within rtol 1e-3 / atol 1e-4, the
    means within 1%, p_film bit-equal and the same live-ray counts -> the
    port's mean."""
    import jax.numpy as jnp
    px, py, s = lanes(n, res, spp, seed=seed)
    L, p_film, _, cnt = li(cs, *(torch.as_tensor(a) for a in (px, py, s)), max_depth=depth)
    jL, jp, _, jcnt = j_li(jcs, jnp.asarray(px), jnp.asarray(py), jnp.asarray(s),
                           max_depth=depth, with_stats=True)
    L, jL = L.numpy(), np.asarray(jL)
    ok = np.all(np.abs(L - jL) <= 1e-4 + 1e-3 * np.abs(jL), axis=1)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(L.mean() - jL.mean()) <= 0.01 * abs(jL.mean())
    np.testing.assert_array_equal(p_film.numpy(), np.asarray(jp))
    for k in ("camera_rays", "shadow_rays", "bounce_rays", "valid_hits"):
        assert int(cnt[k]) == int(jcnt[k]), k
    return L.mean()


def hold_ref(L, p_film, cnt, ref):
    """hold_li's criterion against committed reference outputs (a dict of
    tests/torch_refs/cases.load): >= 99% of lanes within rtol 1e-3 / atol
    1e-4, the means within 1%, p_film bit-equal and the same live-ray
    counts (where the reference stored them) -> the port's mean."""
    L, jL = np.asarray(L), ref["L"]
    ok = np.all(np.abs(L - jL) <= 1e-4 + 1e-3 * np.abs(jL), axis=1)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(L.mean() - jL.mean()) <= 0.01 * abs(jL.mean())
    np.testing.assert_array_equal(np.asarray(p_film), ref["p_film"])
    for k in ("camera_rays", "shadow_rays", "bounce_rays", "valid_hits"):
        if cnt is not None and f"cnt_{k}" in ref:
            assert int(cnt[k]) == int(ref[f"cnt_{k}"]), k
    return L.mean()


def hold_image(img, want):
    """A whole render against the reference's image: >= 99% of pixels
    within rtol 1e-3 / atol 1e-4, the means within 1%."""
    img = np.asarray(img)
    assert img.shape == want.shape
    ok = np.all(np.abs(img - want) <= 1e-4 + 1e-3 * np.abs(want), axis=-1)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(img.mean() - want.mean()) <= 0.01 * abs(want.mean())


SPECTRAL_FLAG = ' "bool spectral" "true"'


def renders_as_without_spectral(text, **options):
    """A scene under "bool spectral" "true" whose integrator has no
    spectral branch (whitted, volpath, bdpt, MLT's bdpt target): the
    flag is set, and the image is bit-equal to the same scene's without
    the flag."""
    from pbrt_tpu_torch.render import Options, render
    from pbrt_tpu_torch.scene import load_scene_string
    assert SPECTRAL_FLAG in text
    cs = load_scene_string(text, device="cpu")
    assert cs.flags.spectral
    got, _, _ = render(cs, Options(**options))
    want, _, _ = render(load_scene_string(text.replace(SPECTRAL_FLAG, ""), device="cpu"),
                        Options(**options))
    assert float(want.sum()) > 0
    assert torch.equal(got, want)


def jax_scene_file(path):
    """The reference's scene file with kernel tables -> (its CPU-path scene,
    arrays, specs)."""
    from pbrt_tpu.scene import load_scene
    with pallas_tables():
        jcs = load_scene(path)
    arrays, specs = jax_scene_arrays(jcs)
    return (dataclasses.replace(jcs, flags=dataclasses.replace(jcs.flags, use_pallas=False)),
            arrays, specs)


def front_end_tables(path):
    """The port's host tables of a scene file."""
    from pbrt_tpu_torch.scene.api import Api
    from pbrt_tpu_torch.scene.build import build_tables
    from pbrt_tpu_torch.scene.parser import parse_file
    api = Api()
    api.cwd = os.path.dirname(path)
    parse_file(path, api)
    return build_tables(api.scene, api.cwd)
