"""Light table, sampling and emission (port of pbrt_tpu/lights/__init__.py
for the point, spot and distant lights, the diffuse area light on meshes
and quadrics, and the constant infinite light).

params layout [L, 12]:
  POINT:    [0:3] world position
  SPOT:     [0:3] position, [3:6] world direction, [6] cos of the cone
            angle, [7] cos of the start of the falloff
  DISTANT:  [3:6] world direction toward the light
  AREA:     [0] 1 on a mesh, 0 on a quadric, [1] quadric row, [2] first
            emitter triangle, [3] their count, [4] total area,
            [5] two-sided, [6] cdf offset
  INFINITE: [8] image id (-1 = constant)
A quadric emitter is sampled by area through a tessellation built with the
scene (shapes/quadrics.py tessellate_quadric); its hits are the analytic
ones. Projection and goniometric lights, environment maps and the other
light-selection strategies raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.math import cross, dot, INV_4PI
from pbrt_tpu_torch.core.sampling import uniform_sample_sphere, uniform_sample_triangle
from pbrt_tpu_torch.core.spectrum import RGB_TO_Y
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.shapes.quadrics import tessellate_quadric

L_POINT, L_SPOT, L_PROJECTION, L_GONIO, L_DISTANT, L_AREA, L_INFINITE = range(7)
KIND_IDS = {"point": L_POINT, "spot": L_SPOT, "distant": L_DISTANT, "area": L_AREA,
            "infinite": L_INFINITE, "exinfinite": L_INFINITE}
DELTA_KINDS = (L_POINT, L_SPOT, L_PROJECTION, L_GONIO, L_DISTANT)


@dataclasses.dataclass
class LiSample:
    wi: torch.Tensor        # [N,3]
    li: torch.Tensor        # [N,3]
    pdf: torch.Tensor       # [N] solid-angle pdf (1 for delta lights)
    p_light: torch.Tensor   # [N,3] shadow-ray target
    is_delta: torch.Tensor  # [N] bool


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


def compile_lights(lights, shape_tri_range, tp, shape_quads):
    """Host: LightRecords -> (rows, tri_cdf, ltri [C,3,3]); rows are
    (kind, L, params). tp [T,3,3] holds the scene triangles; shape_quads
    maps a quadric shape's index to (its row, kind, params, o2w, reversed)."""
    rows, cdfs, ltris = [], [], []
    for lr in lights:
        ps = lr.params
        params = np.zeros(12, np.float32)
        params[8] = -1
        scale = ps.find_one_rgb("scale", [1, 1, 1])
        kid = KIND_IDS.get(lr.kind)
        if kid is None:
            raise NotImplementedError(f"light {lr.kind!r} is not ported")
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
            if ps.find_one_string("mapname", ""):
                raise NotImplementedError("infinite light 'mapname' (environment map) is not ported")
        rows.append((kid, np.asarray(L, np.float32), params))
    tri_cdf = np.concatenate(cdfs) if cdfs else np.zeros(1, np.float32)
    ltri = np.concatenate(ltris) if ltris else np.zeros((1, 3, 3), np.float32)
    return rows, tri_cdf, ltri


def light_power(kind, L_rgb, params, world_radius):
    """Approximate power for the selection distribution."""
    y = float(np.dot(L_rgb, RGB_TO_Y))
    if kind == L_POINT:
        return 4.0 * np.pi * y
    if kind == L_SPOT:
        return 2.0 * np.pi * (1.0 - 0.5 * (params[6] + params[7])) * y
    if kind == L_AREA:
        return params[4] * np.pi * y * (2.0 if params[5] > 0.5 else 1.0)
    return np.pi * world_radius * world_radius * y   # distant, infinite


def _spot_falloff(cos_w, cos_total, cos_falloff):
    d = torch.clamp((cos_w - cos_total) / torch.clamp(cos_falloff - cos_total, min=1e-6),
                    0.0, 1.0)
    return torch.where(cos_w < cos_total, 0.0,
                       torch.where(cos_w > cos_falloff, 1.0, (d * d) * (d * d)))


def sample_li(lights, light_idx, ref_p, u2, world_radius) -> LiSample:
    """Sample an incident direction from per-lane light light_idx [N];
    only the kinds the table holds are evaluated."""
    kinds = lights.kinds
    li_idx = torch.clamp(light_idx, min=0)
    kind = lights.kind[li_idx]
    Lv = lights.L[li_idx]
    pr = lights.params[li_idx]
    n = ref_p.shape[0]
    # candidates in the order point family, distant, area, infinite; the
    # last one present is the default of the selection below
    picks = []
    if L_POINT in kinds or L_SPOT in kinds:
        pos = pr[:, 0:3]
        to_l = pos - ref_p
        d2 = torch.clamp(vm.length_squared(to_l), min=1e-12)
        wi = to_l * torch.rsqrt(d2)[:, None]
        li = Lv / d2[:, None]
        if L_SPOT in kinds:
            fall = _spot_falloff(dot(-wi, pr[:, 3:6]), pr[:, 6], pr[:, 7])
            li = torch.where((kind == L_SPOT)[:, None], li * fall[:, None], li)
        picks.append(((kind == L_POINT) | (kind == L_SPOT),
                      LiSample(wi, li, torch.ones(n, device=ref_p.device), pos, None)))
    if L_DISTANT in kinds:
        w = pr[:, 3:6]
        picks.append((kind == L_DISTANT, LiSample(w, Lv, torch.ones(n, device=ref_p.device),
                                                  ref_p + w * (2.0 * world_radius), None)))
    if L_AREA in kinds:
        picks.append((kind == L_AREA, _sample_area(lights, li_idx, ref_p, u2)))
    if L_INFINITE in kinds:
        # constant infinite light: uniform sphere
        wi_c = uniform_sample_sphere(u2)
        picks.append((kind == L_INFINITE,
                      LiSample(wi_c, Lv, torch.full((n,), INV_4PI, device=ref_p.device),
                               ref_p + wi_c * (2.0 * world_radius), None)))
    _, out = picks[-1]
    for sel, s in reversed(picks[:-1]):
        s3 = sel[:, None]
        out = LiSample(torch.where(s3, s.wi, out.wi), torch.where(s3, s.li, out.li),
                       torch.where(sel, s.pdf, out.pdf),
                       torch.where(s3, s.p_light, out.p_light), None)
    is_delta = (kind == L_POINT) | (kind == L_SPOT) | (kind == L_DISTANT)
    return LiSample(out.wi, out.li, torch.where(light_idx < 0, 0.0, out.pdf), out.p_light,
                    is_delta)


def _sample_area(lights, li_idx, ref_p, u2) -> LiSample:
    """Diffuse area light: pick a triangle by the area CDF (fixed-step
    bisection), then a uniform point on it."""
    n = ref_p.shape[0]
    pr = lights.params[li_idx]
    tri_start = pr[:, 2].to(torch.int64)
    tri_count = torch.clamp(pr[:, 3].to(torch.int64), min=1)
    cdf_off = pr[:, 6].to(torch.int64)
    total_area = torch.clamp(pr[:, 4], min=1e-12)
    two_sided = pr[:, 5] > 0.5
    C = lights.tri_cdf.shape[0]
    u0 = u2[:, 0]
    lo = torch.zeros(n, dtype=torch.int64, device=ref_p.device)
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
    ng = ng / torch.clamp(vm.length(ng), min=1e-12)[:, None]
    to_ref = ref_p - p
    d2 = torch.clamp(vm.length_squared(to_ref), min=1e-12)
    wi = -to_ref * torch.rsqrt(d2)[:, None]
    cos_l = dot(ng, -wi)
    emits = torch.where(two_sided, torch.abs(cos_l) > 1e-7, cos_l > 1e-7)
    pdf = d2 / torch.clamp(torch.abs(cos_l), min=1e-9) / total_area
    li = torch.where(emits[:, None], lights.L[li_idx], 0.0)
    return LiSample(wi, li, torch.where(emits, pdf, 0.0), p, None)


def pdf_li(lights, light_idx, hit_t, hit_cos):
    """Solid-angle pdf that sample_li gives direction wi toward light
    light_idx; for area lights the caller passes the hit's t and |cos|.
    Delta lights have none (0)."""
    li_idx = torch.clamp(light_idx, min=0)
    kind = lights.kind[li_idx]
    total_area = torch.clamp(lights.params[li_idx, 4], min=1e-12)
    pdf_area = hit_t * hit_t / torch.clamp(hit_cos, min=1e-9) / total_area
    return torch.where(kind == L_AREA, pdf_area,
                       torch.where(kind == L_INFINITE, INV_4PI, 0.0))


def le_escaped(lights, infinite_ids, rd):
    """Sum of the infinite lights' radiance along escaped directions rd."""
    total = torch.zeros_like(rd)
    for li in infinite_ids:
        total = total + lights.L[li]
    return total


def le_area(lights, light_idx, ng, wo):
    """Emitted radiance of an intersected area light."""
    li_idx = torch.clamp(light_idx, min=0)
    two_sided = lights.params[li_idx, 5] > 0.5
    ok = (light_idx >= 0) & (two_sided | (dot(ng, wo) > 0.0))
    return torch.where(ok[:, None], lights.L[li_idx], 0.0)
