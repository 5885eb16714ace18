"""Light table, sampling and emission (port of pbrt_tpu/lights/__init__.py
for the diffuse area light on triangles and the constant infinite light).

params layout [L, 12]:
  AREA:     [0] is_mesh, [2] tri_start, [3] tri_count, [4] total_area,
            [5] two_sided, [6] cdf offset
  INFINITE: [8] image id (-1 = constant)
Point, spot, projection, goniometric and distant lights, environment maps
and the spatial light distribution raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.math import cross, dot, PI, INV_4PI
from pbrt_tpu_torch.core.sampling import uniform_sample_sphere, uniform_sample_triangle
from pbrt_tpu_torch.core.spectrum import RGB_TO_Y

L_AREA, L_INFINITE = 5, 6   # the reference's kind ids


@dataclasses.dataclass
class LiSample:
    wi: torch.Tensor       # [N,3]
    li: torch.Tensor       # [N,3]
    pdf: torch.Tensor      # [N] solid-angle pdf
    p_light: torch.Tensor  # [N,3] shadow-ray target


def compile_lights(lights, shape_tri_range, tp):
    """Host: LightRecords -> (rows, tri_cdf, ltri [C,3,3]); rows are
    (kind, L, params). tp [T,3,3] holds the scene triangles."""
    rows, cdfs, ltris = [], [], []
    for lr in lights:
        ps = lr.params
        params = np.zeros(12, np.float32)
        params[8] = -1
        scale = ps.find_one_rgb("scale", [1, 1, 1])
        if lr.kind == "area":
            if lr.shape_index not in shape_tri_range:
                continue   # an emitter inside an object: its baked copies carry it
            kid = L_AREA
            L = ps.find_one_rgb("L", [1, 1, 1]) * scale
            params[5] = 1.0 if ps.find_one_bool("twosided", False) else 0.0
            start, count = shape_tri_range[lr.shape_index]
            light_tris = tp[start:start + count]
            params[0] = 1.0
            P0, P1, P2 = light_tris[:, 0], light_tris[:, 1], light_tris[:, 2]
            areas = 0.5 * np.linalg.norm(np.cross(P1 - P0, P2 - P0), axis=-1)
            total = float(areas.sum())
            params[2] = sum(len(c) for c in cdfs)
            params[3] = len(areas)
            params[4] = max(total, 1e-12)
            params[6] = params[2]
            cdfs.append((np.cumsum(areas) / max(total, 1e-12)).astype(np.float32))
            ltris.append(light_tris.astype(np.float32))
        elif lr.kind in ("infinite", "exinfinite"):
            kid = L_INFINITE
            L = ps.find_one_rgb("L", [1, 1, 1]) * scale
            if ps.find_one_string("mapname", ""):
                raise NotImplementedError("infinite light 'mapname' (environment map) is not ported")
        else:
            raise NotImplementedError(f"light {lr.kind!r} is not ported")
        rows.append((kid, np.asarray(L, np.float32), params))
    tri_cdf = np.concatenate(cdfs) if cdfs else np.zeros(1, np.float32)
    ltri = np.concatenate(ltris) if ltris else np.zeros((1, 3, 3), np.float32)
    return rows, tri_cdf, ltri


def light_power(kind, L_rgb, params, world_radius):
    """Approximate power for the selection distribution."""
    y = float(np.dot(L_rgb, RGB_TO_Y))
    if kind == L_AREA:
        return params[4] * np.pi * y * (2.0 if params[5] > 0.5 else 1.0)
    return np.pi * world_radius * world_radius * y


def sample_li(lights, light_idx, ref_p, u2, world_radius) -> LiSample:
    """Sample an incident direction from per-lane light light_idx [N]."""
    li_idx = torch.clamp(light_idx, min=0)
    kind = lights.kind[li_idx]
    area = _sample_area(lights, li_idx, ref_p, u2)
    # constant infinite light: uniform sphere
    wi_c = uniform_sample_sphere(u2)
    inf = LiSample(wi_c, lights.L[li_idx],
                   torch.full(light_idx.shape, INV_4PI, device=ref_p.device),
                   ref_p + wi_c * (2.0 * world_radius))
    is_area = kind == L_AREA
    a3 = is_area[:, None]
    pdf = torch.where(is_area, area.pdf, inf.pdf)
    return LiSample(torch.where(a3, area.wi, inf.wi), torch.where(a3, area.li, inf.li),
                    torch.where(light_idx < 0, 0.0, pdf),
                    torch.where(a3, area.p_light, inf.p_light))


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
    return LiSample(wi, li, torch.where(emits, pdf, 0.0), p)


def pdf_li(lights, light_idx, hit_t, hit_cos):
    """Solid-angle pdf that sample_li gives direction wi toward light
    light_idx; for area lights the caller passes the hit's t and |cos|."""
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
