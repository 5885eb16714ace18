"""Scene flattening: SceneDescription -> CompiledScene on a device (port of
the slice's part of pbrt_tpu/scene/build.py): the global triangle table,
the world BVH and its kernel tables, slot-keyed hit attributes (with each
triangle's alpha-mask texture ids), the world kd-tree under
`Accelerator "kdtree"` over MIN_BVH_TRIS or more world triangles (fewer
take the BVH, as the reference takes its brute-force test), the instance
world, the quadric table,
the medium table with each primitive's, each light's and the camera's
medium, the texture table with its image atlas, material tables with their fourier
tables, light tables with the environment map's importance tables and the
projection / goniometric map tiles, the light power distribution (and the
spatial strategy's voxel grid), and the camera, film and sampler specs."""
from __future__ import annotations

import logging
import os

import numpy as np
import torch

from pbrt_tpu_torch.accel.bvh import build_bvh
from pbrt_tpu_torch.accel.instance import pack_instance_world
from pbrt_tpu_torch.accel.kdtree import KdTree, build_kdtree
from pbrt_tpu_torch.accel.traverse import pack_kernel_bvh
from pbrt_tpu_torch.cameras import make_camera
from pbrt_tpu_torch.core.sampling import Distribution1D, Distribution2D
from pbrt_tpu_torch.film import make_film
from pbrt_tpu_torch.filters import make_filter
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.lights import (compile_lights, env_tables, light_power, L_AREA,
                                   L_INFINITE)
from pbrt_tpu_torch.lights.distrib import build_spatial_distrib
from pbrt_tpu_torch.materials import compile_materials, compile_subsurface, material_families
from pbrt_tpu_torch.materials.fourier import fourier_tables, table_on
from pbrt_tpu_torch.media import compile_media, medium_table
from pbrt_tpu_torch.samplers import make_sampler
from pbrt_tpu_torch.scene.api import Api, SceneDescription
from pbrt_tpu_torch.scene.parser import parse_file, parse_string
from pbrt_tpu_torch.scene.types import (AT_ALPHA, AT_K, AT_SALPHA, CompiledScene, EnvMap,
                                        LightTable, MaterialTable, QuadricTable, SceneData,
                                        SceneFlags)
from pbrt_tpu_torch.shapes.quadrics import quadric_object_bounds
from pbrt_tpu_torch.textures import KIND_IDS as TEX_KIND_IDS, T_CHECKER3D, TextureTable
from pbrt_tpu_torch.textures.image import build_atlas, load_image

MIN_BVH_TRIS = 64   # world triangles from which the reference builds an accelerator
ENV_KEYS = ("env_func", "env_cond_cdf", "env_cond_int", "env_marg_cdf", "env_marg_int")
_MAPPINGS = {"uv": 0, "spherical": 1, "cylindrical": 2, "planar": 3}


def compile_textures(decls, cwd="."):
    """Host: list of TextureDecl -> texture table arrays (keys tex_kind,
    tex_params, tex_child, tex_w2t, tex_image_id, tex_atlas,
    tex_atlas_size, tex_atlas_levels; textures/__init__.py layout). A
    scene without textures gets one unused constant row, as in the
    reference. Each image file is read once; one that cannot be read is
    logged and becomes a 2x2 grey 0.5, as the reference substitutes."""
    X = max(len(decls), 1)
    kind = np.zeros(X, np.int32)
    params = np.zeros((X, 16), np.float32)
    child = np.full((X, 2), -1, np.int32)
    w2t = np.tile(np.eye(4, dtype=np.float32), (X, 1, 1))
    image_id = np.full(X, -1, np.int32)
    images, image_cache = [], {}
    for i, d in enumerate(decls):
        kind[i] = TEX_KIND_IDS.get(d.kind, 0)
        ps = d.params
        params[i, 0:3] = ps.find_one_rgb("value", ps.find_one_rgb("tex1", [1, 1, 1]))
        params[i, 3:6] = ps.find_one_rgb("tex2", [0, 0, 0])
        if d.kind == "bilerp":
            params[i, 0:3] = ps.find_one_rgb("v00", [0, 0, 0])
            params[i, 3:6] = ps.find_one_rgb("v01", [1, 1, 1])
            params[i, 13:16] = ps.find_one_rgb("v10", [0, 0, 0])
            params[i, 11] = ps.find_one_rgb("v11", [1, 1, 1])[0]
        mapping = ps.find_one_string("mapping", "uv")
        params[i, 6] = _MAPPINGS.get(mapping, 0)
        params[i, 7] = ps.find_one_float("uscale", 1.0)
        params[i, 8] = ps.find_one_float("vscale", 1.0)
        params[i, 9] = ps.find_one_float("udelta", 0.0)
        params[i, 10] = ps.find_one_float("vdelta", 0.0)
        if d.world_to_texture is not None:
            w2t[i] = d.world_to_texture
        if mapping == "planar":
            w2t[i, 0, :3] = ps.find_one_rgb("v1", [1, 0, 0])
            w2t[i, 1, :3] = ps.find_one_rgb("v2", [0, 1, 0])
        for pname, cid in d.children.items():
            if pname in ("tex1", "value"):
                child[i, 0] = cid
            elif pname in ("tex2", "amount"):
                child[i, 1] = cid     # a mix's amount texture takes slot 1
        if d.kind == "mix":
            params[i, 11] = ps.find_one_float("amount", 0.5)
        if d.kind == "dots":
            for pname, cid in d.children.items():
                if pname == "inside":
                    child[i, 0] = cid
                elif pname == "outside":
                    child[i, 1] = cid
            params[i, 0:3] = ps.find_one_rgb("inside", [1, 1, 1])
            params[i, 3:6] = ps.find_one_rgb("outside", [0, 0, 0])
        if d.kind in ("fbm", "wrinkled", "marble", "windy"):
            params[i, 11] = ps.find_one_float("variation", 0.2)
            params[i, 12] = ps.find_one_float("roughness", ps.find_one_float("omega", 0.5))
            params[i, 13] = ps.find_one_float("scale", 1.0)
        if d.kind == "checkerboard" and ps.find_one_int("dimension", 2) == 3:
            kind[i] = T_CHECKER3D
        if d.kind == "imagemap":
            fname = ps.find_one_string("filename", "")
            path = fname if os.path.isabs(fname) else os.path.join(cwd, fname)
            if path not in image_cache:
                gamma = ps.find_one_bool("gamma", path.lower().endswith((".png", ".tga", ".jpg")))
                try:
                    img = load_image(path, gamma=gamma)
                except (OSError, ValueError) as e:
                    logging.getLogger(__name__).warning(
                        "image texture %s unreadable (%s): grey 0.5 in its place", path, e)
                    img = np.full((2, 2, 3), 0.5, np.float32)
                image_cache[path] = len(images)
                images.append(img)
            image_id[i] = image_cache[path]
            params[i, 0:3] = ps.find_one_float("scale", 1.0)
    atlas, sizes, nlevels = build_atlas(images)
    return {"n_textures": len(decls), "tex_kind": kind, "tex_params": params,
            "tex_child": child, "tex_w2t": w2t, "tex_image_id": image_id, "tex_atlas": atlas,
            "tex_atlas_size": sizes, "tex_atlas_levels": nlevels}


def build_tables(desc: SceneDescription, cwd=".") -> dict:
    """Host numpy tables of a scene description (keys as in bridge.py).

    tri_attr holds the world triangles, then each prototype's triangles
    once, in prototype space. The world BVH covers the world rows only; the
    instance world's prototype subtrees index the prototype rows. Every
    shape, mesh or quadric, is one primitive record, in shape order."""
    media, med_ids, any_grid = compile_media(desc.media)
    tri_p, tri_n, tri_uv, tri_prim, tri_has_n = [], [], [], [], []
    prim_material, prim_light, prim_rev, prim_alpha, prim_medium = [], [], [], [], []
    quads = []             # (kind, o2w, w2o, params, prim)
    shape_quads = {}       # shape index -> (quadric row, kind, params, o2w, reversed)
    n_tri = 0

    def add_prim(rec, light, rev):
        prim_material.append(rec.material)
        prim_light.append(light)
        prim_rev.append(rev)
        prim_alpha.append((rec.mesh.alpha_tex, rec.mesh.shadow_alpha_tex)
                          if rec.mesh is not None else (-1, -1))
        prim_medium.append((med_ids.get(rec.medium_inside, -1),
                            med_ids.get(rec.medium_outside, -1)))
        return len(prim_material) - 1

    def add_mesh(rec, light):
        """Append one mesh's rows -> its (first row, count)."""
        nonlocal n_tri
        m = rec.mesh
        pid = add_prim(rec, light, rec.reverse_orientation ^ m.transform_swaps_handedness)
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
        n_tri += T
        return n_tri - T, T

    shape_tri_range = {}
    for si, rec in enumerate(desc.shapes):
        if rec.mesh is not None:
            shape_tri_range[si] = add_mesh(rec, rec.area_light)
            continue
        rev = rec.reverse_orientation ^ Transform(rec.o2w).swaps_handedness()
        pid = add_prim(rec, rec.area_light, rev)
        shape_quads[si] = (len(quads), rec.quad_type, rec.quad_params, rec.o2w, rev)
        quads.append((rec.quad_type, rec.o2w, rec.w2o, rec.quad_params, pid))
    n_world = n_tri
    proto_rows = [[add_mesh(rec, -1) for rec in precs] for precs in desc.prototypes]

    out = {"n_tris": n_world, "n_world_tris": n_world, "n_quadrics": len(quads),
           "n_media": len(desc.media), "any_grid_media": any_grid,
           "prim_medium": np.asarray(prim_medium or [(-1, -1)], np.int32).reshape(-1, 2),
           "camera_medium": med_ids.get(desc.camera_medium_name, -1), **media}
    qprim = np.array([q[4] for q in quads], np.int32)
    out["quad_kind"] = np.array([q[0] for q in quads], np.int32)
    out["quad_o2w"] = np.array([q[1] for q in quads], np.float32).reshape(-1, 4, 4)
    out["quad_w2o"] = np.array([q[2] for q in quads], np.float32).reshape(-1, 4, 4)
    out["quad_params"] = np.array([q[3] for q in quads], np.float32).reshape(-1, 8)
    out["quad_prim"] = qprim
    out["quad_mat"] = np.asarray(prim_material, np.int32)[qprim]
    out["quad_light"] = np.asarray(prim_light, np.int32)[qprim]
    out["quad_rev"] = np.asarray(prim_rev, bool)[qprim]
    tp = (np.concatenate(tri_p).astype(np.float32) if n_tri
          else np.zeros((0, 3, 3), np.float32))
    attr = np.zeros((n_tri, AT_K), np.float32)
    if n_tri:
        tn = np.concatenate(tri_n).astype(np.float32)
        tprim = np.concatenate(tri_prim)
        attr[:, 0:3], attr[:, 3:6], attr[:, 6:9] = tp[:, 0], tp[:, 1], tp[:, 2]
        attr[:, 9:18] = tn.reshape(n_tri, 9)
        attr[:, 18:24] = np.concatenate(tri_uv).astype(np.float32).reshape(n_tri, 6)
        attr[:, 24] = np.concatenate(tri_has_n)
        attr[:, 25] = tprim
        attr[:, 26] = np.asarray(prim_material, np.int32)[tprim]
        attr[:, 27] = np.asarray(prim_light, np.int32)[tprim]
        attr[:, 28] = np.asarray(prim_rev, bool)[tprim]
        attr[:, 29] = np.arange(n_tri)
        attr[:, 30:32] = np.asarray(prim_alpha, np.int32).reshape(-1, 2)[tprim]
    out["tri_attr"] = attr
    pts = []
    if n_world:
        wtp = tp[:n_world]
        lo = wtp.min(axis=1)
        hi = wtp.max(axis=1)
        eps = 1e-5 * np.maximum(np.abs(lo) + np.abs(hi), 1.0)
        bvh = build_bvh(lo - eps, hi + eps, split_method=desc.accelerator_params
                        .find_one_string("splitmethod", "sah"))
        out["bvh"] = pack_kernel_bvh(bvh, wtp[:, 0], wtp[:, 1], wtp[:, 2])
        order = out["bvh"].order.numpy()
        slot_attr = attr[np.maximum(order, 0)].copy()
        slot_attr[order < 0] = 0.0
        slot_attr[order < 0, 29] = -1.0
        slot_attr[order < 0, 27] = -1.0
        slot_attr[order < 0, 30:32] = -1.0
        out["slot_attr"] = slot_attr
        if desc.accelerator_kind == "kdtree" and n_world >= MIN_BVH_TRIS:
            out["kd"] = build_kdtree(lo - eps, hi + eps)
        pts += [lo, hi]
    if desc.instances:
        proto_tris, proto_gids = [], []
        for rows in proto_rows:
            first = rows[0][0]
            last = rows[-1][0] + rows[-1][1]
            p0, p1, p2 = tp[first:last, 0], tp[first:last, 1], tp[first:last, 2]
            proto_tris.append((np.minimum(np.minimum(p0, p1), p2),
                               np.maximum(np.maximum(p0, p1), p2), p0, p1, p2))
            proto_gids.append(np.arange(first, last, dtype=np.int32))
        out["ibvh"] = pack_instance_world(proto_tris, proto_gids, desc.instances)
        pts += [out["ibvh"].wlo[None], out["ibvh"].whi[None]]
    for kind, o2w, _, qp, _ in quads:
        # each quadric's object bounds, their corners moved to world
        qlo, qhi = quadric_object_bounds(kind, qp)
        corners = np.array([[x, y, z] for x in (qlo[0], qhi[0])
                            for y in (qlo[1], qhi[1]) for z in (qlo[2], qhi[2])])
        wpts = corners @ o2w[:3, :3].T + o2w[:3, 3]
        pts += [wpts.min(0)[None], wpts.max(0)[None]]
    allpts = np.concatenate(pts) if pts else np.zeros((0, 3), np.float32)
    allpts = allpts[np.abs(allpts).max(-1) < 1e29]
    if allpts.size:
        wlo, whi = allpts.min(0), allpts.max(0)
        wc = 0.5 * (wlo + whi)
        wr = float(np.linalg.norm(whi - wlo) * 0.5 + 1e-6)
    else:
        wc, wr = np.zeros(3, np.float32), 1.0
    out["world_center"] = wc.astype(np.float32)
    out["world_radius"] = np.float32(wr)

    out.update(compile_textures(desc.textures, cwd))
    (out["mat_kind"], out["mat_const"], out["mat_misc"], out["mat_tex"], out["mat_child"],
     ftabs) = compile_materials(desc.materials, cwd)
    (out["mat_sss"], out["mat_sss_prof"], out["mat_sss_cdf"],
     out["mat_sss_rhoeff"]) = compile_subsurface(desc.materials, out["mat_misc"])
    out["bsdf_fams"] = material_families(desc.materials)
    out["n_fourier"] = len(ftabs)
    out.update({f"fourier_{k}": v for k, v in fourier_tables(ftabs).items()})

    lt = compile_lights(desc.lights, shape_tri_range, tp, shape_quads, cwd)
    rows = lt["rows"]
    out["tri_cdf"] = lt["tri_cdf"]
    Lc = max(len(rows), 1)
    out["light_kind"] = np.zeros(Lc, np.int32)
    out["light_L"] = np.zeros((Lc, 3), np.float32)
    out["light_params"] = np.zeros((Lc, 12), np.float32)
    out["light_params"][:, 8] = -1
    out["light_l2w"] = np.tile(np.eye(4, dtype=np.float32), (Lc, 1, 1))
    out["light_w2l"] = np.tile(np.eye(4, dtype=np.float32), (Lc, 1, 1))
    for i, (k, L, p, l2w, w2l) in enumerate(rows):
        out["light_kind"][i], out["light_L"][i], out["light_params"][i] = k, L, p
        out["light_l2w"][i], out["light_w2l"][i] = l2w, w2l
    out["light_medium"] = np.full(Lc, -1, np.int32)
    out["light_medium"][:len(rows)] = [med_ids.get(name, -1) for name in lt["media"]]
    out["ltri"] = lt["ltri"]
    out["n_lights"] = len(rows)
    out["light_maps"] = (lt["maps"] if lt["maps"] is not None
                         else np.zeros((1, 1, 1, 3), np.float32))
    out["env_image"] = lt["env"] if lt["env"] is not None else np.zeros((1, 1, 3), np.float32)
    env, env_mean = env_tables(lt["env"])
    out.update(env)
    powers = [light_power(k, L, p, wr, env_mean) for k, L, p, _, _ in rows]
    if not powers or sum(powers) <= 0:
        powers = [1.0] * Lc
    out["light_func"], out["light_cdf"], out["light_func_int"] = \
        Distribution1D.tables(np.asarray(powers, np.float32))
    return out


def _param_bool(v):
    """A ParamSet bool as the reference reads it: [True], ["true"] or a
    bool."""
    if isinstance(v, (list, tuple)):
        v = v[0] if v else False
    if isinstance(v, str):
        return v.strip().lower() == "true"
    return bool(v)


def reachable_kinds(kind, child, ids):
    """Texture kind ids of textures ids and every texture they nest."""
    seen, todo = set(), [int(i) for i in ids]
    while todo:
        j = todo.pop()
        seen.add(int(kind[j]))
        todo += [int(c) for c in child[j] if c >= 0]
    return tuple(sorted(seen))


def scene_from_tables(t: dict, camera, film, sampler, integrator_kind,
                      integrator_params, device) -> CompiledScene:
    """Host tables + specs -> CompiledScene with its tensors on `device`."""
    dev = torch.device(device)
    # other integrator parameters are ignored, as in the reference; the
    # scene is spectral where "spectral" is true and neither a fourier
    # table nor a BSSRDF is present (with either it renders in RGB)
    has_sss = bool((t["mat_sss"][:, 0] > 0).any())
    spectral = (_param_bool(integrator_params.get("spectral", False)) and not t["n_fourier"]
                and not has_sss)
    # the reference takes any other strategy name for "power"
    strategy = str(integrator_params.get("lightsamplestrategy", ["power"])[0])
    ten = lambda a: torch.as_tensor(np.array(a), device=dev)
    ltri = t["ltri"]
    n_lights = int(t["n_lights"])
    kinds = t["light_kind"][:n_lights]
    lparams = t["light_params"]
    mapped = tuple(int(i) for i in np.nonzero((kinds == L_INFINITE)
                                             & (lparams[:n_lights, 8] >= 0))[0])
    env = None
    if mapped:
        env = EnvMap(ten(t["env_image"]), Distribution2D.from_tables(
            t["env_func"], t["env_cond_cdf"], t["env_cond_int"], t["env_cond_int"],
            t["env_marg_cdf"], t["env_marg_int"], dev))
    alpha_ids = np.unique(t["tri_attr"][:, AT_ALPHA:AT_SALPHA + 1].astype(np.int32))
    alpha_ids = alpha_ids[alpha_ids >= 0]
    quads = None
    if t["n_quadrics"]:
        quads = QuadricTable(*(ten(t[k]) for k in (
            "quad_kind", "quad_o2w", "quad_w2o", "quad_params", "quad_prim", "quad_mat",
            "quad_light", "quad_rev")))
    data = SceneData(
        tri_attr=ten(t["tri_attr"]),
        slot_attr=ten(t["slot_attr"]) if t["n_tris"] else None,
        bvh=t["bvh"].to(dev) if t["n_tris"] else None,
        mats=MaterialTable(ten(t["mat_kind"]), ten(t["mat_const"]), ten(t["mat_misc"]),
                           ten(t["mat_tex"]), ten(t["mat_child"]),
                           *((ten(t["mat_sss"]), ten(t["mat_sss_prof"]), ten(t["mat_sss_cdf"]),
                              ten(t["mat_sss_rhoeff"])) if has_sss else ())),
        tex=TextureTable(*(ten(t[f"tex_{k}"]) for k in (
            "kind", "params", "child", "w2t", "image_id", "atlas", "atlas_size",
            "atlas_levels"))),
        lights=LightTable(ten(t["light_kind"]), ten(t["light_L"]), ten(lparams),
                          ten(t["tri_cdf"]), ten(ltri[:, 0]), ten(ltri[:, 1]),
                          ten(ltri[:, 2]), ten(t["light_l2w"]), ten(t["light_w2l"]), env,
                          ten(t["light_maps"]) if t["light_maps"].shape[1] > 1 else None,
                          mapped, np.asarray(t["light_w2l"], np.float32),
                          ten(t["light_medium"])),
        light_distr=Distribution1D.from_tables(t["light_func"], t["light_cdf"],
                                               t["light_func_int"], dev),
        world_center=np.asarray(t["world_center"], np.float32),
        world_radius=float(t["world_radius"]),
        ibvh=t["ibvh"].to(dev) if "ibvh" in t else None, quads=quads,
        fourier=table_on({k: t[f"fourier_{k}"] for k in ("mu", "a", "eta", "n_mu", "a0y", "cdf")},
                         dev) if t["n_fourier"] else None,
        prim_medium=ten(t["prim_medium"]), camera_medium=int(t["camera_medium"]),
        media=medium_table(t, dev) if t["n_media"] else None)
    if "kd" in t:
        wa = data.tri_attr[:int(t["n_world_tris"])]
        data.kd = KdTree.from_tables(t["kd"], wa[:, 0:3], wa[:, 3:6], wa[:, 6:9])
    flags = SceneFlags(
        n_tris=int(t["n_tris"]), n_lights=n_lights,
        has_infinite=bool(np.any(kinds == L_INFINITE)),
        has_area_lights=bool(np.any(kinds == L_AREA)),
        infinite_light_ids=tuple(int(i) for i in np.nonzero(kinds == L_INFINITE)[0]),
        n_instances=int(t["ibvh"].iroot.shape[0]) if "ibvh" in t else 0,
        n_world_tris=int(t["n_world_tris"]),
        any_animated_inst="ibvh" in t and bool(t["ibvh"].ianim.any()),
        n_quadrics=int(t["n_quadrics"]),
        tex_kinds=tuple(int(k) for k in np.unique(t["tex_kind"][:t["n_textures"]])),
        has_tex_slot=tuple(bool(b) for b in (t["mat_tex"] >= 0).any(0)),
        has_alpha=bool(alpha_ids.size),
        alpha_kinds=reachable_kinds(t["tex_kind"], t["tex_child"], alpha_ids),
        bsdf_fams=tuple(bool(b) for b in t["bsdf_fams"]),
        mat_kinds=tuple(int(k) for k in np.unique(t["mat_kind"])),
        has_fourier=bool(t["n_fourier"]), light_strategy=strategy,
        n_media=int(t["n_media"]), any_grid_media=bool(t["any_grid_media"]),
        accel="kdtree" if "kd" in t else "bvh", has_subsurface=has_sss, spectral=spectral)
    if strategy == "spatial" and n_lights > 0:
        sv = integrator_params.get("spatialvoxels")
        data.light_spatial = build_spatial_distrib(
            data.lights, data.world_center, data.world_radius, n_lights,
            int(sv[0]) if sv else None, dev)
    return CompiledScene(data, flags, camera, film, sampler, integrator_kind,
                         dict(integrator_params))


def build_scene(desc: SceneDescription, options=None, device="cuda", seed=0,
                cwd=".", tables=None) -> CompiledScene:
    """SceneDescription -> CompiledScene on `device`; image textures are
    read relative to cwd. tables: the description's build_tables, where
    they were built already (another crop or device of the same scene)."""
    filt = make_filter(desc.filter_kind, desc.filter_params.as_plain_dict())
    film = make_film(desc.film_params.as_plain_dict(), filt, options)
    camera = make_camera(desc.camera_kind, desc.camera_params.as_plain_dict(),
                         desc.camera_to_world, film.full_resolution)
    sampler = make_sampler(desc.sampler_kind, desc.sampler_params.as_plain_dict(),
                           film.full_resolution, seed)
    return scene_from_tables(build_tables(desc, cwd) if tables is None else tables, camera,
                             film, sampler,
                             desc.integrator_kind,
                             desc.integrator_params.as_plain_dict(), device)


def load_scene(path: str, options=None, device="cuda", seed=0) -> CompiledScene:
    """Parse and build a .pbrt file."""
    api = Api()
    api.cwd = os.path.dirname(os.path.abspath(path))
    parse_file(path, api)
    cs = build_scene(api.scene, options, device, seed, api.cwd)
    cs.source = (load_scene, (os.path.abspath(path), options), {"seed": seed})
    return cs


def load_scene_string(text: str, options=None, device="cuda", cwd=".", seed=0) -> CompiledScene:
    api = Api()
    api.cwd = cwd
    parse_string(text, api, cwd)
    cs = build_scene(api.scene, options, device, seed, cwd)
    cs.source = (load_scene_string, (text, options), {"cwd": cwd, "seed": seed})
    return cs
