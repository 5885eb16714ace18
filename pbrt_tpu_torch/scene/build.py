"""Scene flattening: SceneDescription -> CompiledScene on a device (port of
the slice's part of pbrt_tpu/scene/build.py): the global triangle table,
the BVH and its kernel tables, slot-keyed hit attributes, material and
light tables, the light power distribution, and the camera, film and
sampler specs."""
from __future__ import annotations

import os

import numpy as np
import torch

from pbrt_tpu_torch.accel.bvh import build_bvh
from pbrt_tpu_torch.accel.traverse import pack_kernel_bvh
from pbrt_tpu_torch.cameras import make_camera
from pbrt_tpu_torch.core.sampling import Distribution1D
from pbrt_tpu_torch.film import make_film
from pbrt_tpu_torch.filters import make_filter
from pbrt_tpu_torch.lights import compile_lights, light_power, L_AREA, L_INFINITE
from pbrt_tpu_torch.materials import compile_materials
from pbrt_tpu_torch.samplers import make_sampler
from pbrt_tpu_torch.scene.api import Api, SceneDescription
from pbrt_tpu_torch.scene.parser import parse_file, parse_string
from pbrt_tpu_torch.scene.types import (AT_K, CompiledScene, LightTable, MaterialTable,
                                        SceneData, SceneFlags)

_PORTED_INTEGRATOR_PARAMS = {"maxdepth", "rrthreshold"}


def build_tables(desc: SceneDescription) -> dict:
    """Host numpy tables of a scene description (keys as in bridge.py)."""
    tri_p, tri_n, tri_uv, tri_prim, tri_has_n = [], [], [], [], []
    prim_material, prim_light, prim_rev = [], [], []
    shape_tri_range = {}
    n_tri = 0
    for si, rec in enumerate(desc.shapes):
        pid = len(prim_material)
        prim_material.append(rec.material)
        prim_light.append(rec.area_light)
        m = rec.mesh
        prim_rev.append(rec.reverse_orientation ^ m.transform_swaps_handedness)
        idx = m.indices
        T = idx.shape[0]
        tri_p.append(m.p[idx])
        if m.n is not None:
            tri_n.append(m.n[idx])
            tri_has_n.append(np.ones(T, bool))
        else:
            tri_n.append(np.zeros((T, 3, 3), np.float32))
            tri_has_n.append(np.zeros(T, bool))
        tri_uv.append(m.uv[idx] if m.uv is not None else
                      np.tile(np.array([[0, 0], [1, 0], [1, 1]], np.float32), (T, 1, 1)))
        tri_prim.append(np.full(T, pid, np.int32))
        shape_tri_range[si] = (n_tri, T)
        n_tri += T

    out = {"n_tris": n_tri}
    if n_tri:
        tp = np.concatenate(tri_p).astype(np.float32)
        tn = np.concatenate(tri_n).astype(np.float32)
        thn = np.concatenate(tri_has_n)
        tuv = np.concatenate(tri_uv).astype(np.float32)
        tprim = np.concatenate(tri_prim)
        lo = tp.min(axis=1)
        hi = tp.max(axis=1)
        eps = 1e-5 * np.maximum(np.abs(lo) + np.abs(hi), 1.0)
        bvh = build_bvh(lo - eps, hi + eps, split_method=desc.accelerator_params
                        .find_one_string("splitmethod", "sah"))
        out["bvh"] = pack_kernel_bvh(bvh, tp[:, 0], tp[:, 1], tp[:, 2])
        attr = np.zeros((n_tri, AT_K), np.float32)
        attr[:, 0:3], attr[:, 3:6], attr[:, 6:9] = tp[:, 0], tp[:, 1], tp[:, 2]
        attr[:, 9:18] = tn.reshape(n_tri, 9)
        attr[:, 18:24] = tuv.reshape(n_tri, 6)
        attr[:, 24] = thn
        attr[:, 25] = tprim
        attr[:, 26] = np.asarray(prim_material, np.int32)[tprim]
        attr[:, 27] = np.asarray(prim_light, np.int32)[tprim]
        attr[:, 28] = np.asarray(prim_rev, bool)[tprim]
        attr[:, 29] = np.arange(n_tri)
        attr[:, 30:32] = -1.0
        order = out["bvh"].order.numpy()
        slot_attr = attr[np.maximum(order, 0)].copy()
        slot_attr[order < 0] = 0.0
        slot_attr[order < 0, 29] = -1.0
        slot_attr[order < 0, 27] = -1.0
        slot_attr[order < 0, 30:32] = -1.0
        out["tri_attr"], out["slot_attr"] = attr, slot_attr
        allpts = np.concatenate([lo, hi])
        wlo, whi = allpts.min(0), allpts.max(0)
        wc = 0.5 * (wlo + whi)
        wr = float(np.linalg.norm(whi - wlo) * 0.5 + 1e-6)
    else:
        tp = np.zeros((0, 3, 3), np.float32)
        out["tri_attr"] = np.zeros((0, AT_K), np.float32)
        wc, wr = np.zeros(3, np.float32), 1.0
    out["world_center"] = wc.astype(np.float32)
    out["world_radius"] = np.float32(wr)

    out["mat_kind"], out["mat_const"], out["mat_misc"] = compile_materials(desc.materials)

    rows, out["tri_cdf"], ltri = compile_lights(desc.lights, shape_tri_range, tp)
    Lc = max(len(rows), 1)
    out["light_kind"] = np.zeros(Lc, np.int32)
    out["light_L"] = np.zeros((Lc, 3), np.float32)
    out["light_params"] = np.zeros((Lc, 12), np.float32)
    out["light_params"][:, 8] = -1
    for i, (k, L, p) in enumerate(rows):
        out["light_kind"][i], out["light_L"][i], out["light_params"][i] = k, L, p
    out["ltri"] = ltri
    out["n_lights"] = len(rows)
    powers = [light_power(k, L, p, wr) for k, L, p in rows]
    if not powers or sum(powers) <= 0:
        powers = [1.0] * Lc
    out["light_func"], out["light_cdf"], out["light_func_int"] = \
        Distribution1D.tables(np.asarray(powers, np.float32))
    return out


def scene_from_tables(t: dict, camera, film, sampler, integrator_kind,
                      integrator_params, device) -> CompiledScene:
    """Host tables + specs -> CompiledScene with its tensors on `device`."""
    dev = torch.device(device)
    if integrator_kind != "path":
        raise NotImplementedError(f"integrator {integrator_kind!r} is not ported")
    for k in integrator_params:
        if k not in _PORTED_INTEGRATOR_PARAMS:
            raise NotImplementedError(f"integrator parameter {k!r} is not ported")
    ten = lambda a: torch.as_tensor(np.array(a), device=dev)
    ltri = t["ltri"]
    kinds = t["light_kind"][:t["n_lights"]]
    data = SceneData(
        tri_attr=ten(t["tri_attr"]),
        slot_attr=ten(t["slot_attr"]) if t["n_tris"] else None,
        bvh=t["bvh"].to(dev) if t["n_tris"] else None,
        mats=MaterialTable(ten(t["mat_kind"]), ten(t["mat_const"]), ten(t["mat_misc"])),
        lights=LightTable(ten(t["light_kind"]), ten(t["light_L"]), ten(t["light_params"]),
                          ten(t["tri_cdf"]), ten(ltri[:, 0]), ten(ltri[:, 1]),
                          ten(ltri[:, 2])),
        light_distr=Distribution1D.from_tables(t["light_func"], t["light_cdf"],
                                               t["light_func_int"], dev),
        world_center=np.asarray(t["world_center"], np.float32),
        world_radius=float(t["world_radius"]))
    flags = SceneFlags(
        n_tris=int(t["n_tris"]), n_lights=int(t["n_lights"]),
        has_infinite=bool(np.any(kinds == L_INFINITE)),
        has_area_lights=bool(np.any(kinds == L_AREA)),
        infinite_light_ids=tuple(int(i) for i in np.nonzero(kinds == L_INFINITE)[0]))
    return CompiledScene(data, flags, camera, film, sampler, integrator_kind,
                         dict(integrator_params))


def build_scene(desc: SceneDescription, options=None, device="cpu", seed=0) -> CompiledScene:
    """SceneDescription -> CompiledScene on `device`."""
    filt = make_filter(desc.filter_kind, desc.filter_params.as_plain_dict())
    film = make_film(desc.film_params.as_plain_dict(), filt, options)
    camera = make_camera(desc.camera_kind, desc.camera_params.as_plain_dict(),
                         desc.camera_to_world, film.full_resolution)
    sampler = make_sampler(desc.sampler_kind, desc.sampler_params.as_plain_dict(),
                           film.full_resolution, seed)
    return scene_from_tables(build_tables(desc), camera, film, sampler,
                             desc.integrator_kind,
                             desc.integrator_params.as_plain_dict(), device)


def load_scene(path: str, options=None, device="cpu", seed=0) -> CompiledScene:
    """Parse and build a .pbrt file."""
    api = Api()
    api.cwd = os.path.dirname(os.path.abspath(path))
    parse_file(path, api)
    return build_scene(api.scene, options, device, seed)


def load_scene_string(text: str, options=None, device="cpu", cwd=".", seed=0) -> CompiledScene:
    api = Api()
    api.cwd = cwd
    parse_string(text, api, cwd)
    return build_scene(api.scene, options, device, seed)
