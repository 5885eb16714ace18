"""Carry the reference's compiled scene across to the port.

`from_jax_arrays` takes the tables of a pbrt_tpu CompiledScene, already
converted to numpy by the caller and named as in the reference (see
ARRAY_KEYS; a scene with quadrics adds n_quadrics, quad_type, quad_o2w,
quad_w2o, quad_params, quad_prim and the primitive records prim_material,
prim_light and prim_rev; n_textures, mats.tex and the texture table as
TEX_KEYS; the fourier tables as fourier.<key> with n_fourier, the table
count; the flags' bsdf_fams; the media: n_media, any_grid_media,
prim_medium, camera_medium, lights.medium and the medium table as
media.<key>), plus its specs as plain dicts, and builds the port's
CompiledScene on a chosen device. Tests use it so that both packages
compute on identical tables; the port's own front end must produce tables
equal to `tables_from_jax_arrays` of the same scene.
"""
from __future__ import annotations

import numpy as np

from pbrt_tpu_torch.accel.instance import IMAT_STRIDE, InstanceBVH, walk_stack_need
from pbrt_tpu_torch.accel.traverse import KernelBVH, LEAF_TRIS, tree_depth
from pbrt_tpu_torch.cameras import CameraSpec
from pbrt_tpu_torch.film import FilmSpec
from pbrt_tpu_torch.filters import FilterSpec
from pbrt_tpu_torch.media import MEDIUM_KEYS
from pbrt_tpu_torch.samplers import SamplerSpec
from pbrt_tpu_torch.scene.build import ENV_KEYS, scene_from_tables

# the fourier tables' arrays (fourier.<key>)
FOURIER_KEYS = ("mu", "a", "eta", "n_mu", "a0y", "cdf")
# the texture table's arrays (tex.<key>)
TEX_KEYS = ("kind", "params", "child", "w2t", "image_id", "atlas", "atlas_size",
            "atlas_levels")
ARRAY_KEYS = (
    "n_tris", "n_world_tris", "n_lights", "tri_attr", "slot_attr",
    "pbvh.metas", "pbvh.nodes", "pbvh.tris", "pbvh.order", "pbvh.seed",
    "pbvh.seed_slots", "pbvh.wlo", "pbvh.whi",
    "mats.kind", "mats.const", "mats.misc",
    "lights.kind", "lights.L", "lights.params", "lights.tri_cdf",
    "lights.ltri_p0", "lights.ltri_p1", "lights.ltri_p2",
    "light_distr.func", "light_distr.cdf", "light_distr.func_int",
    "world_center", "world_radius", "n_textures", "mats.tex",
    *(f"tex.{k}" for k in TEX_KEYS),
    "mats.child", "lights.l2w", "lights.w2l", "lights.limg", "lights.env_image",
    "lights.env_cond_func", "lights.env_cond_cdf", "lights.env_cond_int",
    "lights.env_marg_cdf", "lights.env_marg_int", "bsdf_fams", "n_fourier",
    *(f"fourier.{k}" for k in FOURIER_KEYS),
    "n_media", "any_grid_media", "prim_medium", "camera_medium", "lights.medium",
    *(f"media.{k}" for k in MEDIUM_KEYS))
# the instance world's arrays: present (not None) only in scenes with instances
IBVH_KEYS = ("metas", "nodes", "tris", "order", "imat", "iroot", "ianim", "i2w", "w2p",
             "wlo", "whi")


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


def instance_bvh_from_pallas(metas, nodes, tris, order, imat, iroot, ianim, i2w, w2p,
                             wlo, whi):
    """The reference's InstanceBVH arrays (TPU row layout) -> InstanceBVH (CPU)."""
    import torch
    metas = np.asarray(metas, np.int32)
    t = lambda a, dt: torch.as_tensor(np.array(a, dt))
    return InstanceBVH(t(metas, np.int32),
                       t(np.asarray(nodes, np.float32).reshape(-1, 16)[:metas.shape[0]], np.float32),
                       t(np.asarray(tris, np.float32).reshape(-1, 16), np.float32),
                       t(order, np.int32),
                       t(np.asarray(imat, np.float32).reshape(-1, IMAT_STRIDE), np.float32),
                       t(iroot, np.int32), t(ianim, np.int32), t(i2w, np.float32),
                       t(w2p, np.float32), np.asarray(wlo, np.float32),
                       np.asarray(whi, np.float32), walk_stack_need(metas, iroot))


def tables_from_jax_arrays(a: dict) -> dict:
    """Reference arrays -> the port's host table dict (build.build_tables)."""
    missing = [k for k in ARRAY_KEYS if k not in a]
    if missing:
        raise KeyError(f"missing reference arrays: {missing}")
    n_tris = int(a["n_tris"])
    t = {"n_tris": n_tris, "n_world_tris": int(a["n_world_tris"]),
         "n_lights": int(a["n_lights"]),
         "tri_attr": np.asarray(a["tri_attr"], np.float32),
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
    # the reference pads an empty quadric table with one row; its count says
    nq = int(a.get("n_quadrics", 0))
    qprim = np.asarray(a["quad_prim"], np.int32)[:nq] if nq else np.zeros(0, np.int32)
    t["n_quadrics"] = nq
    t["quad_kind"] = np.asarray(a["quad_type"], np.int32)[:nq] if nq else qprim
    for k, shape in (("o2w", (4, 4)), ("w2o", (4, 4)), ("params", (8,))):
        t[f"quad_{k}"] = (np.asarray(a[f"quad_{k}"], np.float32)[:nq] if nq
                          else np.zeros((0, *shape), np.float32))
    t["quad_prim"] = qprim
    for k, col, dt in (("quad_mat", "prim_material", np.int32),
                       ("quad_light", "prim_light", np.int32), ("quad_rev", "prim_rev", bool)):
        t[k] = np.asarray(a[col], dt)[qprim] if nq else np.zeros(0, dt)
    t["n_textures"] = int(a["n_textures"])
    for k in TEX_KEYS:
        t[f"tex_{k}"] = np.asarray(a[f"tex.{k}"], np.float32 if k in ("params", "w2t", "atlas")
                                   else np.int32)
    t["mat_tex"] = np.asarray(a["mats.tex"], np.int32)
    t["mat_child"] = np.asarray(a["mats.child"], np.int32)
    m = t["mat_kind"].shape[0]
    for k, key, shape in (("sss", "mat_sss", (m, 7)), ("sss_prof", "mat_sss_prof", (m, 3, 64)),
                          ("sss_cdf", "mat_sss_cdf", (m, 3, 64)),
                          ("sss_rhoeff", "mat_sss_rhoeff", (m, 3))):
        v = a.get(f"mats.{k}")
        t[key] = np.zeros(shape, np.float32) if v is None else np.asarray(v, np.float32)
    t["bsdf_fams"] = tuple(bool(b) for b in a["bsdf_fams"])
    t["n_fourier"] = int(a["n_fourier"])
    for k in FOURIER_KEYS:
        t[f"fourier_{k}"] = np.asarray(a[f"fourier.{k}"], np.int32 if k == "n_mu"
                                       else np.float32)
    for k in ("l2w", "w2l"):
        t[f"light_{k}"] = np.asarray(a[f"lights.{k}"], np.float32)
    t["light_maps"] = np.asarray(a["lights.limg"], np.float32)
    t["light_medium"] = np.asarray(a["lights.medium"], np.int32)
    t["n_media"] = int(a["n_media"])
    t["any_grid_media"] = bool(a["any_grid_media"])
    t["prim_medium"] = np.asarray(a["prim_medium"], np.int32).reshape(-1, 2)
    t["camera_medium"] = int(a["camera_medium"])
    for k in MEDIUM_KEYS:
        t[f"med_{k}"] = np.asarray(a[f"media.{k}"], np.int32 if k == "kind" else np.float32)
    t["env_image"] = np.asarray(a["lights.env_image"], np.float32)
    for k, j in zip(ENV_KEYS, ("cond_func", "cond_cdf", "cond_int", "marg_cdf", "marg_int")):
        t[k] = np.asarray(a[f"lights.env_{j}"], np.float32)
    if n_tris:
        if a["slot_attr"] is None or a["pbvh.metas"] is None:
            raise ValueError("the reference scene carries no kernel tables: "
                             "build it with PBRT_TPU_PALLAS=1")
        t["slot_attr"] = np.asarray(a["slot_attr"], np.float32)
        t["bvh"] = kernel_bvh_from_pallas(*(a[f"pbvh.{k}"] for k in (
            "metas", "nodes", "tris", "order", "seed", "seed_slots", "wlo", "whi")))
    if a.get("ibvh.metas") is not None:
        t["ibvh"] = instance_bvh_from_pallas(*(a[f"ibvh.{k}"] for k in IBVH_KEYS))
    return t


def from_jax_arrays(arrays: dict, specs: dict, device="cuda"):
    """Reference arrays and specs -> the port's CompiledScene on `device`.

    specs: {"camera": {raster_to_camera, cam_to_world, shutter_open,
    shutter_close, resolution}, "film": {full_resolution, crop_window,
    filename, scale, max_sample_luminance}, "filter": FilterSpec fields,
    "sampler": SamplerSpec fields, "integrator_kind", "integrator_params"};
    the camera's lens_radius and focal_distance may be left out (no
    lens), and so may camera_to_raster and screen_area, which only BDPT
    reads."""
    s = dict(specs["sampler"], resolution=tuple(specs["sampler"]["resolution"]))
    camera = CameraSpec(**{"kind": "perspective", **specs["camera"]})
    film = FilmSpec(filter=FilterSpec(**specs["filter"]), **specs["film"])
    sampler = SamplerSpec(**s)
    return scene_from_tables(tables_from_jax_arrays(arrays), camera, film, sampler,
                             specs["integrator_kind"], specs["integrator_params"], device)
