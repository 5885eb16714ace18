"""Carry the reference's compiled scene across to the port.

`from_jax_arrays` takes the tables of a pbrt_tpu CompiledScene, already
converted to numpy by the caller and named as in the reference (see
ARRAY_KEYS), plus its specs as plain dicts, and builds the port's
CompiledScene on a chosen device. Tests use it so that both packages
compute on identical tables; the port's own front end must produce tables
equal to `tables_from_jax_arrays` of the same scene.
"""
from __future__ import annotations

import numpy as np

from pbrt_tpu_torch.accel.traverse import KernelBVH, LEAF_TRIS, tree_depth
from pbrt_tpu_torch.cameras import CameraSpec
from pbrt_tpu_torch.film import FilmSpec
from pbrt_tpu_torch.filters import FilterSpec
from pbrt_tpu_torch.samplers import SamplerSpec, PORTED_KINDS
from pbrt_tpu_torch.scene.build import scene_from_tables

ARRAY_KEYS = (
    "n_tris", "n_lights", "tri_attr", "slot_attr",
    "pbvh.metas", "pbvh.nodes", "pbvh.tris", "pbvh.order", "pbvh.seed",
    "pbvh.seed_slots", "pbvh.wlo", "pbvh.whi",
    "mats.kind", "mats.const", "mats.misc",
    "lights.kind", "lights.L", "lights.params", "lights.tri_cdf",
    "lights.ltri_p0", "lights.ltri_p1", "lights.ltri_p2",
    "light_distr.func", "light_distr.cdf", "light_distr.func_int",
    "world_center", "world_radius")


def kernel_bvh_from_pallas(metas, nodes, tris, order, seed, seed_slots, wlo, whi):
    """The reference's PallasBVH arrays (TPU row layout) -> KernelBVH (CPU)."""
    import torch
    metas = np.asarray(metas, np.int32)
    M = metas.shape[0]
    cnts = (metas >> 2) & 15
    right = np.where(cnts > 0, 0, (metas >> 6) & 0x3FFFFFF)
    t = lambda a: torch.as_tensor(np.array(a))
    return KernelBVH(t(metas), t(np.asarray(nodes, np.float32).reshape(-1, 16)[:M]),
                     t(np.asarray(tris, np.float32).reshape(-1, 16)),
                     t(np.asarray(order, np.int32)),
                     t(np.asarray(seed, np.float32).reshape(LEAF_TRIS, 16)),
                     t(np.asarray(seed_slots, np.int32)),
                     np.asarray(wlo, np.float32), np.asarray(whi, np.float32),
                     tree_depth(right, cnts))


def tables_from_jax_arrays(a: dict) -> dict:
    """Reference arrays -> the port's host table dict (build.build_tables)."""
    missing = [k for k in ARRAY_KEYS if k not in a]
    if missing:
        raise KeyError(f"missing reference arrays: {missing}")
    n_tris = int(a["n_tris"])
    t = {"n_tris": n_tris, "n_lights": int(a["n_lights"]),
         "tri_attr": np.asarray(a["tri_attr"], np.float32)[:n_tris],
         "mat_kind": np.asarray(a["mats.kind"], np.int32),
         "mat_const": np.asarray(a["mats.const"], np.float32),
         "mat_misc": np.asarray(a["mats.misc"], np.float32),
         "light_kind": np.asarray(a["lights.kind"], np.int32),
         "light_L": np.asarray(a["lights.L"], np.float32),
         "light_params": np.asarray(a["lights.params"], np.float32),
         "tri_cdf": np.asarray(a["lights.tri_cdf"], np.float32),
         "ltri": np.stack([np.asarray(a[f"lights.ltri_p{i}"], np.float32)
                           for i in range(3)], 1),
         "light_func": np.asarray(a["light_distr.func"], np.float32),
         "light_cdf": np.asarray(a["light_distr.cdf"], np.float32),
         "light_func_int": np.float32(a["light_distr.func_int"]),
         "world_center": np.asarray(a["world_center"], np.float32),
         "world_radius": np.float32(a["world_radius"])}
    if n_tris:
        if a["slot_attr"] is None or a["pbvh.metas"] is None:
            raise ValueError("the reference scene carries no kernel tables: "
                             "build it with PBRT_TPU_PALLAS=1")
        t["slot_attr"] = np.asarray(a["slot_attr"], np.float32)
        t["bvh"] = kernel_bvh_from_pallas(*(a[f"pbvh.{k}"] for k in (
            "metas", "nodes", "tris", "order", "seed", "seed_slots", "wlo", "whi")))
    return t


def from_jax_arrays(arrays: dict, specs: dict, device="cpu"):
    """Reference arrays and specs -> the port's CompiledScene on `device`.

    specs: {"camera": {raster_to_camera, cam_to_world, shutter_open,
    shutter_close, resolution}, "film": {full_resolution, crop_window,
    filename, scale, max_sample_luminance}, "filter": FilterSpec fields,
    "sampler": {kind, spp, seed, resolution}, "integrator_kind",
    "integrator_params"}."""
    s = specs["sampler"]
    if s["kind"] not in PORTED_KINDS:
        raise NotImplementedError(f"sampler {s['kind']!r} is not ported")
    camera = CameraSpec("perspective", **specs["camera"])
    film = FilmSpec(filter=FilterSpec(**specs["filter"]), **specs["film"])
    sampler = SamplerSpec(s["kind"], int(s["spp"]), int(s["seed"]), tuple(s["resolution"]))
    return scene_from_tables(tables_from_jax_arrays(arrays), camera, film, sampler,
                             specs["integrator_kind"], specs["integrator_params"], device)
