"""Light table, sampling and emission (port of pbrt_tpu/lights/__init__.py):
point, spot, projection, goniometric and distant lights, the diffuse area
light on meshes and quadrics, and the infinite light, constant or with an
environment map.

params layout [L, 12]:
  POINT:    [0:3] world position
  SPOT:     [0:3] position, [3:6] world direction, [6] cos of the cone
            angle, [7] cos of the start of the falloff
  PROJECTION, GONIO: [0:3] position, [3:6] world z axis, [6] cos fov,
            [7] tan(fov / 2), [8] map id (-1: none), [9] map h / w
  DISTANT:  [3:6] world direction toward the light
  AREA:     [0] 1 on a mesh, 0 on a quadric, [1] quadric row, [2] first
            emitter triangle, [3] their count, [4] total area,
            [5] two-sided, [6] cdf offset
  INFINITE: [8] image id (-1 = constant)
A quadric emitter is sampled by area through a tessellation built with the
scene (shapes/quadrics.py tessellate_quadric); its hits are the analytic
ones. An environment map is looked up in the light's frame (w2l) as an
equirect image and importance-sampled by a luminance * sin(theta)
Distribution2D; projection and goniometric maps are resampled to 64x64
tiles by nearest index, as in the reference. sample_le samples an emitted
ray of every kind (BDPT's light subpaths); projection and goniometric maps
modulate it as they modulate sample_li's radiance. Code for a light kind,
an environment map or a light map runs only in scenes that hold one.
"""
from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.math import cross, dot, normalize, vec3, INV_4PI, PI
from pbrt_tpu_torch.core.sampling import (concentric_sample_disk, cosine_hemisphere_pdf,
                                          cosine_sample_hemisphere, uniform_cone_pdf,
                                          uniform_sample_cone, uniform_sample_sphere,
                                          uniform_sample_triangle)
from pbrt_tpu_torch.core.spectrum import RGB_TO_Y
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.shapes.quadrics import tessellate_quadric

L_POINT, L_SPOT, L_PROJECTION, L_GONIO, L_DISTANT, L_AREA, L_INFINITE = range(7)
KIND_IDS = {"point": L_POINT, "spot": L_SPOT, "projection": L_PROJECTION,
            "goniometric": L_GONIO, "distant": L_DISTANT, "area": L_AREA,
            "infinite": L_INFINITE, "exinfinite": L_INFINITE}
DELTA_KINDS = (L_POINT, L_SPOT, L_PROJECTION, L_GONIO, L_DISTANT)
POINT_FAMILY = (L_POINT, L_SPOT, L_PROJECTION, L_GONIO)
MAP_RES = 64   # projection / goniometric map tiles


@dataclasses.dataclass
class LiSample:
    wi: torch.Tensor        # [N,3]
    li: torch.Tensor        # [N,3]
    pdf: torch.Tensor       # [N] solid-angle pdf (1 for delta lights)
    p_light: torch.Tensor   # [N,3] shadow-ray target
    is_delta: torch.Tensor  # [N] bool
    n_light: torch.Tensor = None   # [N,3] emitter normal at p_light (-wi off area
                                   # lights); only where asked for


def _emitter_triangles(lr, shape_tri_range, tp, shape_quads):
    """An area light's emitter -> (triangles [T,3,3], params[0], params[1]),
    or None for an emitter inside an object (its baked copies carry it)."""
    if lr.shape_index in shape_tri_range:
        start, count = shape_tri_range[lr.shape_index]
        return tp[start:start + count], 1.0, 0.0
    if lr.shape_index in shape_quads:
        qi, qtype, qp, o2w, rev = shape_quads[lr.shape_index]
        return tessellate_quadric(qtype, qp, o2w, flip_normal=rev), 0.0, qi
    return None


def _read_light_map(path):
    """A projection / goniometric map -> (64x64x3 tile by nearest index,
    h / w), or None where it cannot be read (logged)."""
    from pbrt_tpu_torch.io.image_io import read_image
    try:
        img = np.asarray(read_image(path), np.float32)
    except (OSError, ValueError) as e:
        logging.getLogger(__name__).warning("light map %s unreadable (%s): no map", path, e)
        return None
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, -1)
    ys = np.linspace(0, img.shape[0] - 1, MAP_RES).astype(int)
    xs = np.linspace(0, img.shape[1] - 1, MAP_RES).astype(int)
    return img[ys][:, xs, :3], img.shape[0] / max(img.shape[1], 1)


def compile_lights(lights, shape_tri_range, tp, shape_quads, cwd="."):
    """Host: LightRecords -> dict(rows [(kind, L, params, l2w, w2l)],
    media (each row's outside medium name), tri_cdf, ltri [C,3,3], maps
    [K,64,64,3] or None, env [H,W,3] or None).
    tp [T,3,3] holds the scene triangles; shape_quads maps a quadric
    shape's index to (its row, kind, params, o2w, reversed). An environment
    map that cannot be read is logged and its light is constant, as the
    reference treats it."""
    from pbrt_tpu_torch.io.image_io import read_image
    rows, media, cdfs, ltris, maps = [], [], [], [], []
    env = None
    for lr in lights:
        ps = lr.params
        params = np.zeros(12, np.float32)
        params[8] = -1
        scale = ps.find_one_rgb("scale", [1, 1, 1])
        kid = KIND_IDS.get(lr.kind)
        if kid is None:   # an unknown kind is skipped, as in the reference
            continue
        t = Transform(lr.l2w)
        if kid == L_POINT:
            L = ps.find_one_rgb("I", [1, 1, 1]) * scale
            params[0:3] = np.asarray(t.point(ps.find_one_rgb("from", [0, 0, 0])))
        elif kid == L_SPOT:
            L = ps.find_one_rgb("I", [1, 1, 1]) * scale
            params[0:3] = np.asarray(t.point(ps.find_one_rgb("from", [0, 0, 0])))
            d = np.asarray(t.point(ps.find_one_rgb("to", [0, 0, 1]))) - params[0:3]
            params[3:6] = d / max(np.linalg.norm(d), 1e-9)
            cone = ps.find_one_float("coneangle", 30.0)
            delta = ps.find_one_float("conedeltaangle", 5.0)
            params[6] = np.cos(np.radians(cone))
            params[7] = np.cos(np.radians(cone - delta))
        elif kid in (L_PROJECTION, L_GONIO):
            L = ps.find_one_rgb("I", [1, 1, 1]) * scale
            params[0:3] = np.asarray(t.point([0, 0, 0]))
            params[3:6] = np.asarray(t.vector([0, 0, 1.0]))
            fov = ps.find_one_float("fov", 45.0)
            params[6] = np.cos(np.radians(fov))
            params[7] = np.tan(np.radians(fov) * 0.5)
            mapname = ps.find_one_string("mapname", "")
            got = _read_light_map(os.path.join(cwd, mapname)) if mapname else None
            if got is not None:
                params[8] = len(maps)
                params[9] = got[1]
                maps.append(got[0])
        elif kid == L_DISTANT:
            L = ps.find_one_rgb("L", [1, 1, 1]) * scale
            w = (np.asarray(t.point(ps.find_one_rgb("from", [0, 0, 0])))
                 - np.asarray(t.point(ps.find_one_rgb("to", [0, 0, 1]))))
            params[3:6] = w / max(np.linalg.norm(w), 1e-9)
        elif kid == L_AREA:
            emitter = _emitter_triangles(lr, shape_tri_range, tp, shape_quads)
            if emitter is None:
                continue
            light_tris, params[0], params[1] = emitter
            L = ps.find_one_rgb("L", [1, 1, 1]) * scale
            params[5] = 1.0 if ps.find_one_bool("twosided", False) else 0.0
            P0, P1, P2 = light_tris[:, 0], light_tris[:, 1], light_tris[:, 2]
            areas = 0.5 * np.linalg.norm(np.cross(P1 - P0, P2 - P0), axis=-1)
            total = float(areas.sum())
            params[2] = sum(len(c) for c in cdfs)
            params[3] = len(areas)
            params[4] = max(total, 1e-12)
            params[6] = params[2]
            cdfs.append((np.cumsum(areas) / max(total, 1e-12)).astype(np.float32))
            ltris.append(light_tris.astype(np.float32))
        else:
            L = ps.find_one_rgb("L", [1, 1, 1]) * scale
            mapname = ps.find_one_string("mapname", "")
            if mapname:
                path = mapname if os.path.isabs(mapname) else os.path.join(cwd, mapname)
                try:
                    env = np.asarray(read_image(path), np.float32)
                    params[8] = 0
                except (OSError, ValueError) as e:
                    logging.getLogger(__name__).warning(
                        "environment map %s unreadable (%s): constant light", path, e)
        rows.append((kid, np.asarray(L, np.float32), params, lr.l2w, lr.w2l))
        media.append(lr.medium)
    return {"rows": rows, "media": media,
            "tri_cdf": np.concatenate(cdfs) if cdfs else np.zeros(1, np.float32),
            "ltri": np.concatenate(ltris) if ltris else np.zeros((1, 3, 3), np.float32),
            "maps": np.stack(maps).astype(np.float32) if maps else None, "env": env}


def env_tables(env):
    """Host: an equirect environment image [H,W,3] (or None) -> the
    reference's luminance * sin(theta) tables (func [H,W], cond_cdf
    [H,W+1], cond_int [H], marg_cdf [H+1], marg_int) and the mean
    luminance for the power distribution. A row of zero integral keeps a
    zero CDF ending in 1, as the reference builds it."""
    img = np.zeros((1, 1, 3), np.float32) if env is None else env
    H, W = img.shape[:2]
    lum = img @ np.array([0.212671, 0.715160, 0.072169], np.float32)
    sin_w = np.sin((np.arange(H) + 0.5) / H * np.pi).astype(np.float32)
    f2d = (lum * sin_w[:, None]).astype(np.float32)
    cond_cdf = np.concatenate([np.zeros((H, 1), np.float32),
                               np.cumsum(f2d, -1, dtype=np.float64).astype(np.float32) / W], -1)
    cond_int = cond_cdf[:, -1].copy()
    cond_cdf = cond_cdf / np.where(cond_int > 0, cond_int, 1.0)[:, None]
    cond_cdf[:, -1] = 1.0
    marg_cdf = np.concatenate([[0.0], np.cumsum(cond_int, dtype=np.float64).astype(np.float32)
                               / H]).astype(np.float32)
    marg_int = float(marg_cdf[-1])
    if marg_int > 0:
        marg_cdf = marg_cdf / marg_int
    marg_cdf[-1] = 1.0
    env_mean = float(lum.mean()) if H > 1 else 1.0
    return {"env_func": f2d, "env_cond_cdf": cond_cdf.astype(np.float32),
            "env_cond_int": cond_int, "env_marg_cdf": marg_cdf.astype(np.float32),
            "env_marg_int": np.float32(marg_int)}, env_mean


def light_power(kind, L_rgb, params, world_radius, env_mean=1.0):
    """Approximate power for the selection distribution."""
    y = float(np.dot(L_rgb, RGB_TO_Y))
    if kind in (L_POINT, L_PROJECTION, L_GONIO):
        return 4.0 * np.pi * y
    if kind == L_SPOT:
        return 2.0 * np.pi * (1.0 - 0.5 * (params[6] + params[7])) * y
    if kind == L_AREA:
        return params[4] * np.pi * y * (2.0 if params[5] > 0.5 else 1.0)
    if kind == L_INFINITE:
        return np.pi * world_radius * world_radius * y * env_mean
    return np.pi * world_radius * world_radius * y   # distant


def _spot_falloff(cos_w, cos_total, cos_falloff):
    d = torch.clamp((cos_w - cos_total) / torch.clamp(cos_falloff - cos_total, min=1e-6),
                    0.0, 1.0)
    return torch.where(cos_w < cos_total, 0.0,
                       torch.where(cos_w > cos_falloff, 1.0, (d * d) * (d * d)))


def _texel(x, n):
    """Float texel coordinate -> index in [0, n): truncated as the
    reference's int cast, clamped first so that no out-of-range or NaN
    value reaches the conversion (NaN takes texel 0)."""
    return torch.clamp(torch.nan_to_num(x, nan=0.0), 0.0, n - 1.0).to(torch.int64)


def _lane_xform(m, v):
    """Per-lane [N,4,4] matrices' upper 3x3 applied to vectors [N,3]."""
    return vec3(*(m[:, i, 0] * v[:, 0] + m[:, i, 1] * v[:, 1] + m[:, i, 2] * v[:, 2]
                  for i in range(3)))


def _is(kind, ids, kinds):
    """kind is one of ids; only the ids the table holds are compared."""
    out = None
    for k in ids:
        if k in kinds:
            out = (kind == k) if out is None else out | (kind == k)
    return out


def _map_modulation(lights, kind, pr, li_idx, dir_world):
    """Projection / goniometric map factor of a point-family light's
    emission along world direction dir_world (light to receiver): the
    projection's frustum texel (0 outside it), the goniometric (phi,
    theta) texel, 1 for every other lane."""
    imgid = pr[:, 8].to(torch.int64)
    dl = normalize(_lane_xform(lights.w2l[li_idx], dir_world))
    dxl, dyl, dzl = dl[:, 0], dl[:, 1], dl[:, 2]
    tanh = torch.clamp(pr[:, 7], min=1e-6)
    aspect = torch.where(pr[:, 9] > 0, pr[:, 9], 1.0)
    zs = torch.where(torch.abs(dzl) > 1e-6, dzl, 1e-6)
    s = dxl / (zs * tanh) * 0.5 + 0.5
    t = dyl / (zs * tanh * aspect) * 0.5 + 0.5
    inside = (dzl > 0) & (s >= 0) & (s <= 1) & (t >= 0) & (t <= 1)
    theta = torch.acos(torch.clamp(dzl, -1.0, 1.0))
    phi = torch.atan2(dyl, dxl)
    phi = torch.where(phi < 0, phi + 2.0 * np.pi, phi)
    is_proj = kind == L_PROJECTION
    K, Hh, Ww = lights.limg.shape[:3]
    ix = _texel(torch.where(is_proj, s, phi / (2.0 * np.pi)) * Ww, Ww)
    iy = _texel(torch.where(is_proj, t, theta / np.pi) * Hh, Hh)
    mval = lights.limg.reshape(K * Hh * Ww, 3)[(torch.clamp(imgid, 0, K - 1) * Hh + iy) * Ww + ix]
    has = imgid >= 0
    return torch.where((is_proj & has)[:, None], torch.where(inside[:, None], mval, 0.0),
                       torch.where(((kind == L_GONIO) & has)[:, None], mval, 1.0))


def sample_li(lights, light_idx, ref_p, u2, world_radius, with_normal=False) -> LiSample:
    """Sample an incident direction from per-lane light light_idx [N];
    only the kinds the table holds are evaluated. with_normal: also the
    emitter's normal at the sampled point (BDPT's MIS reads it)."""
    kinds = lights.kinds
    li_idx = torch.clamp(light_idx, min=0)
    kind = lights.kind[li_idx]
    Lv = lights.L[li_idx]
    pr = lights.params[li_idx]
    n = ref_p.shape[0]
    mapped = _is(kind, (L_PROJECTION, L_GONIO), kinds)
    # candidates in the order point family, distant, area, infinite; the
    # last one present is the default of the selection below
    picks = []
    if any(k in kinds for k in POINT_FAMILY):
        pos = pr[:, 0:3]
        to_l = pos - ref_p
        d2 = torch.clamp(vm.length_squared(to_l), min=1e-12)
        wi = to_l * vm.rsqrt(d2)[:, None]
        li = Lv / d2[:, None]
        if L_SPOT in kinds:
            fall = _spot_falloff(dot(-wi, pr[:, 3:6]), pr[:, 6], pr[:, 7])
            li = torch.where((kind == L_SPOT)[:, None], li * fall[:, None], li)
        if lights.limg is not None:
            li = li * _map_modulation(lights, kind, pr, li_idx, -wi)
        fam = (kind == L_POINT) | (kind == L_SPOT)
        picks.append((fam if mapped is None else fam | mapped,
                      LiSample(wi, li, torch.ones(n, device=ref_p.device), pos, None)))
    if L_DISTANT in kinds:
        w = pr[:, 3:6]
        picks.append((kind == L_DISTANT, LiSample(w, Lv, torch.ones(n, device=ref_p.device),
                                                  ref_p + w * (2.0 * world_radius), None)))
    if L_AREA in kinds:
        picks.append((kind == L_AREA, _sample_area(lights, li_idx, ref_p, u2)))
    if L_INFINITE in kinds:
        s = _sample_infinite(lights, li_idx, pr, u2, Lv)
        s.p_light = ref_p + s.wi * (2.0 * world_radius)
        picks.append((kind == L_INFINITE, s))
    _, out = picks[-1]
    for sel, s in reversed(picks[:-1]):
        s3 = sel[:, None]
        out = LiSample(torch.where(s3, s.wi, out.wi), torch.where(s3, s.li, out.li),
                       torch.where(sel, s.pdf, out.pdf),
                       torch.where(s3, s.p_light, out.p_light), None)
    is_delta = (kind == L_POINT) | (kind == L_SPOT) | (kind == L_DISTANT)
    if mapped is not None:
        is_delta = is_delta | mapped
    n_light = None
    if with_normal:
        n_light = -out.wi
        for sel, s in picks:
            if s.n_light is not None:
                n_light = torch.where(sel[:, None], s.n_light, n_light)
    return LiSample(out.wi, out.li, torch.where(light_idx < 0, 0.0, out.pdf), out.p_light,
                    is_delta, n_light)


def _sample_infinite(lights, li_idx, pr, u2, Lv) -> LiSample:
    """Infinite light: a uniform sphere direction where constant, the
    environment map's Distribution2D where it has one (no p_light)."""
    n = u2.shape[0]
    wi_c = uniform_sample_sphere(u2)
    s = LiSample(wi_c, Lv, torch.full((n,), INV_4PI, device=u2.device), None, None)
    if lights.env is not None:
        wi_m, li_m, pdf_m = _sample_env(lights, li_idx, u2, Lv)
        has_map = (pr[:, 8] >= 0)
        s = LiSample(torch.where(has_map[:, None], wi_m, wi_c),
                     torch.where(has_map[:, None], li_m, Lv),
                     torch.where(has_map, pdf_m, s.pdf), None, None)
    return s


def _sample_env(lights, li_idx, u2, Lv):
    """Environment-map importance sample -> (world wi, li, solid-angle
    pdf); zeros from a 1x1 map, as in the reference."""
    env = lights.env
    H, W = env.image.shape[:2]
    if H <= 1:
        z = torch.zeros_like(Lv)
        return z, z, z[:, 0]
    uv, map_pdf = env.distr.sample_continuous(u2)
    theta = uv[:, 1] * PI
    phi = uv[:, 0] * 2.0 * PI
    sin_t = torch.sin(theta)
    w_l = vec3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), torch.cos(theta))
    wi = _lane_xform(lights.l2w[li_idx], w_l)
    pdf = torch.where(sin_t > 1e-7, map_pdf / (2.0 * PI * PI * torch.clamp(sin_t, min=1e-7)),
                      0.0)
    ix, iy = _texel(uv[:, 0] * W, W), _texel(uv[:, 1] * H, H)
    return wi, env.image.reshape(H * W, 3)[iy * W + ix] * Lv, pdf


def _area_pick(lights, li_idx, pr, u2):
    """A uniform point on area light li_idx's emitter: a triangle by the
    area CDF (fixed-step bisection), then a point on it -> (p [N,3],
    unit geometric normal [N,3], total area [N])."""
    n = u2.shape[0]
    tri_start = pr[:, 2].to(torch.int64)
    tri_count = torch.clamp(pr[:, 3].to(torch.int64), min=1)
    cdf_off = pr[:, 6].to(torch.int64)
    total_area = torch.clamp(pr[:, 4], min=1e-12)
    C = lights.tri_cdf.shape[0]
    u0 = u2[:, 0]
    lo = torch.zeros(n, dtype=torch.int64, device=u2.device)
    hi = tri_count
    for _ in range(max(1, int(np.ceil(np.log2(max(C, 2)))) + 1)):
        mid = (lo + hi) // 2
        go_right = lights.tri_cdf[torch.clamp(cdf_off + mid, 0, C - 1)] <= u0
        lo = torch.where(go_right, torch.minimum(mid + 1, tri_count), lo)
        hi = torch.where(go_right, hi, mid)
    k = torch.minimum(lo, tri_count - 1)
    tri = torch.clamp(tri_start + k, 0, lights.ltri_p0.shape[0] - 1)
    c_lo = torch.where(k > 0, lights.tri_cdf[torch.clamp(cdf_off + k - 1, 0, C - 1)], 0.0)
    c_hi = lights.tri_cdf[torch.clamp(cdf_off + k, 0, C - 1)]
    u0r = torch.clamp((u0 - c_lo) / torch.clamp(c_hi - c_lo, min=1e-9), 0.0,
                      vm.ONE_MINUS_EPSILON)
    b = uniform_sample_triangle(torch.stack([u0r, u2[:, 1]], -1))
    p0, p1, p2 = lights.ltri_p0[tri], lights.ltri_p1[tri], lights.ltri_p2[tri]
    p = b[:, 0:1] * p0 + b[:, 1:2] * p1 + (1.0 - b[:, 0:1] - b[:, 1:2]) * p2
    ng = cross(p1 - p0, p2 - p0)
    return p, ng / torch.clamp(vm.length(ng), min=1e-12)[:, None], total_area


def _sample_area(lights, li_idx, ref_p, u2) -> LiSample:
    """Diffuse area light: a uniform point on the emitter, seen from ref_p."""
    pr = lights.params[li_idx]
    two_sided = pr[:, 5] > 0.5
    p, ng, total_area = _area_pick(lights, li_idx, pr, u2)
    to_ref = ref_p - p
    d2 = torch.clamp(vm.length_squared(to_ref), min=1e-12)
    wi = -to_ref * vm.rsqrt(d2)[:, None]
    cos_l = dot(ng, -wi)
    emits = torch.where(two_sided, torch.abs(cos_l) > 1e-7, cos_l > 1e-7)
    pdf = d2 / torch.clamp(torch.abs(cos_l), min=1e-9) / total_area
    li = torch.where(emits[:, None], lights.L[li_idx], 0.0)
    return LiSample(wi, li, torch.where(emits, pdf, 0.0), p, None, ng)


def pdf_li(lights, light_idx, hit_t, hit_cos, wi=None):
    """Solid-angle pdf that sample_li gives direction wi [N,3] toward light
    light_idx; for area lights the caller passes the hit's t and |cos| (wi
    is read only where the scene has an environment map). Delta lights
    have none (0)."""
    li_idx = torch.clamp(light_idx, min=0)
    kind = lights.kind[li_idx]
    total_area = torch.clamp(lights.params[li_idx, 4], min=1e-12)
    pdf_area = hit_t * hit_t / torch.clamp(hit_cos, min=1e-9) / total_area
    pdf_inf = INV_4PI
    if lights.env is not None:
        pdf_inf = torch.where(lights.params[li_idx, 8] >= 0, _env_pdf(lights, li_idx, wi),
                              INV_4PI)
    return torch.where(kind == L_AREA, pdf_area, torch.where(kind == L_INFINITE, pdf_inf, 0.0))


def _env_pdf(lights, li_idx, wi):
    """The environment map's solid-angle pdf of world directions wi."""
    env = lights.env
    H, W = env.image.shape[:2]
    w_l = _lane_xform(lights.w2l[li_idx], wi)
    if H <= 1:
        return torch.zeros_like(wi[:, 0])
    theta, phi = vm.spherical_theta(w_l), vm.spherical_phi(w_l)
    sin_t = torch.sin(theta)
    iu, iv = _texel(phi / (2 * PI) * W, W), _texel(theta / PI * H, H)
    f = env.distr.cond_func.reshape(-1)[iv * W + iu]
    return torch.where(sin_t > 1e-7, f / torch.clamp(env.distr.marg_int_t, min=1e-12)
                       / (2.0 * PI * PI * torch.clamp(sin_t, min=1e-7)), 0.0)


def le_escaped(lights, infinite_ids, rd):
    """Sum of the infinite lights' radiance along escaped directions rd;
    a mapped light's texel is looked up in its own frame."""
    total = torch.zeros_like(rd)
    for li in infinite_ids:
        if li not in lights.mapped:
            total = total + lights.L[li]
            continue
        H, W = lights.env.image.shape[:2]
        if H <= 1:
            continue
        w_l = vm.xform_vector(lights.w2l_host[li], rd)
        theta, phi = vm.spherical_theta(w_l), vm.spherical_phi(w_l)
        iu, iv = _texel(phi / (2 * PI) * W, W), _texel(theta / PI * H, H)
        total = total + lights.env.image.reshape(H * W, 3)[iv * W + iu] * lights.L[li]
    return total


def le_area(lights, light_idx, ng, wo):
    """Emitted radiance of an intersected area light."""
    li_idx = torch.clamp(light_idx, min=0)
    two_sided = lights.params[li_idx, 5] > 0.5
    ok = (light_idx >= 0) & (two_sided | (dot(ng, wo) > 0.0))
    return torch.where(ok[:, None], lights.L[li_idx], 0.0)


@dataclasses.dataclass
class LeSample:
    o: torch.Tensor         # [N,3] ray origin, off the emitter along n_light
    d: torch.Tensor         # [N,3] ray direction
    n_light: torch.Tensor   # [N,3] the emitter's normal (the direction off area lights)
    le: torch.Tensor        # [N,3] emitted radiance
    pdf_pos: torch.Tensor   # [N] area density of the origin (1 for point lights)
    pdf_dir: torch.Tensor   # [N] solid-angle density of the direction


def _area_point(lights, li_idx, u2):
    """A uniform point on area light li_idx's emitter -> (p [N,3], unit
    geometric normal [N,3], area density [N])."""
    p, ng, total_area = _area_pick(lights, li_idx, lights.params[li_idx], u2)
    return p, ng, 1.0 / total_area


def sample_le(lights, light_idx, u1, u2, world_center, world_radius) -> LeSample:
    """Sample an emitted ray from per-lane light light_idx [N]; u1, u2
    [N,2]: the position and direction pairs. Point lights emit over the
    sphere (spot lights over their cone), mapped ones through their map;
    a distant light from a disk of the world's radius; an area light from
    a uniform point of its emitter over the cosine hemisphere (a
    two-sided one picks its side by u2's first coordinate); an infinite
    light along its sample_li direction, reversed, from a disk of the
    world's radius. Only the kinds the table holds are evaluated."""
    kinds = lights.kinds
    n = u1.shape[0]
    dev = u1.device
    li_idx = torch.clamp(light_idx, min=0)
    kind = lights.kind[li_idx]
    Lv = lights.L[li_idx]
    pr = lights.params[li_idx]
    center = torch.as_tensor(np.asarray(world_center, np.float32), device=dev)
    r32 = np.float32(world_radius)
    pdf_pos_disk = float(np.float32(1.0) / (np.float32(PI) * r32 * r32))
    cd = concentric_sample_disk(u1) if (L_DISTANT in kinds or L_INFINITE in kinds) else None
    # candidates (mask, o, d, le, pdf_pos, pdf_dir) in the order point
    # family, distant, area, infinite; the last one present is the default
    # of the selection below
    picks = []
    area_nl = None
    if any(k in kinds for k in POINT_FAMILY):
        d_point = uniform_sample_sphere(u1)
        pdf_dir = torch.full((n,), INV_4PI, device=dev)
        le = Lv
        if L_SPOT in kinds:
            is_spot = kind == L_SPOT
            sdir = pr[:, 3:6]
            cos_total = pr[:, 6]
            cone = uniform_sample_cone(u1, cos_total)
            axis = torch.where(is_spot[:, None], sdir,
                               torch.tensor([0.0, 0.0, 1.0], device=dev))
            v1, v2 = vm.coordinate_system(normalize(axis))
            d_spot = cone[:, 0:1] * v1 + cone[:, 1:2] * v2 + cone[:, 2:3] * normalize(sdir)
            d_point = torch.where(is_spot[:, None], d_spot, d_point)
            pdf_dir = torch.where(is_spot, uniform_cone_pdf(cos_total), pdf_dir)
            fall = _spot_falloff(dot(d_point, sdir), pr[:, 6], pr[:, 7])
            le = torch.where(is_spot[:, None], Lv * fall[:, None], Lv)
        if lights.limg is not None:
            le = le * _map_modulation(lights, kind, pr, li_idx, d_point)
        picks.append((_is(kind, POINT_FAMILY, kinds), pr[:, 0:3], d_point, le, 1.0, pdf_dir))
    if L_DISTANT in kinds:
        w_l = pr[:, 3:6]
        v1, v2 = vm.coordinate_system(normalize(-w_l + 1e-12))
        p_disk = center + world_radius * (cd[:, 0:1] * v1 + cd[:, 1:2] * v2)
        picks.append((kind == L_DISTANT, p_disk + w_l * world_radius, -w_l, Lv,
                      pdf_pos_disk, 1.0))
    if L_AREA in kinds:
        area_p, area_ng, area_pdf_pos = _area_point(lights, li_idx, u1)
        hl = cosine_sample_hemisphere(u2)
        av1, av2 = vm.coordinate_system(area_ng)
        d_area = hl[:, 0:1] * av1 + hl[:, 1:2] * av2 + hl[:, 2:3] * area_ng
        flip = (pr[:, 5] > 0.5) & (u2[:, 0] < 0.5)
        d_area = torch.where(flip[:, None], -d_area, d_area)
        area_nl = torch.where(flip[:, None], -area_ng, area_ng)
        picks.append((kind == L_AREA, area_p, d_area, Lv, area_pdf_pos,
                      cosine_hemisphere_pdf(torch.abs(hl[:, 2]))))
    if L_INFINITE in kinds:
        s = _sample_infinite(lights, li_idx, pr, u2, Lv)
        d_inf = -s.wi
        iv1, iv2 = vm.coordinate_system(normalize(d_inf))
        p_inf = center + world_radius * (-d_inf + cd[:, 0:1] * iv1 + cd[:, 1:2] * iv2)
        picks.append((kind == L_INFINITE, p_inf, d_inf, s.li, pdf_pos_disk, s.pdf))
    full = lambda v: v if torch.is_tensor(v) else torch.full((n,), v, device=dev)
    _, o, d, le, pdf_pos, pdf_dir = picks[-1]
    pdf_pos, pdf_dir = full(pdf_pos), full(pdf_dir)
    for sel, o_k, d_k, le_k, pos_k, dir_k in reversed(picks[:-1]):
        s3 = sel[:, None]
        o, d, le = torch.where(s3, o_k, o), torch.where(s3, d_k, d), torch.where(s3, le_k, le)
        pdf_pos = torch.where(sel, pos_k, pdf_pos)
        pdf_dir = torch.where(sel, dir_k, pdf_dir)
    n_light = normalize(d)
    if area_nl is not None:
        n_light = torch.where((kind == L_AREA)[:, None], area_nl, n_light)
    return LeSample(o + n_light * 1e-4, d, n_light, le, pdf_pos,
                    torch.clamp(pdf_dir, min=1e-12))
