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
    for k in ("kind", "const", "misc", "tex"):
        arrays[f"mats.{k}"] = a(getattr(d.mats, k))
    for k in ("kind", "params", "child", "w2t", "image_id", "atlas", "atlas_size",
              "atlas_levels"):
        arrays[f"tex.{k}"] = a(getattr(d.tex, k))
    arrays["n_textures"] = d.tex.kind.shape[0] if cs.flags.tex_kinds else 0
    for k in ("kind", "L", "params", "tri_cdf", "ltri_p0", "ltri_p1", "ltri_p2"):
        arrays[f"lights.{k}"] = a(getattr(d.lights, k))
    for k in ("func", "cdf", "func_int"):
        arrays[f"light_distr.{k}"] = a(getattr(d.light_distr, k))
    cam, film, s = cs.camera, cs.film, cs.sampler
    f = film.filter
    specs = {
        "camera": dict(raster_to_camera=np.asarray(cam.raster_to_camera),
                       cam_to_world=np.asarray(cam.cam_to_world.start.m),
                       shutter_open=cam.shutter_open, shutter_close=cam.shutter_close,
                       resolution=tuple(cam.resolution)),
        "film": dict(full_resolution=tuple(film.full_resolution),
                     crop_window=tuple(film.crop_window), filename=film.filename,
                     scale=film.scale, max_sample_luminance=film.max_sample_luminance),
        "filter": dict(kind=f.kind, xwidth=f.xwidth, ywidth=f.ywidth, alpha=f.alpha,
                       b=f.b, c=f.c, tau=f.tau),
        "sampler": dict(kind=s.kind, spp=s.spp, seed=s.seed, resolution=tuple(s.resolution)),
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
