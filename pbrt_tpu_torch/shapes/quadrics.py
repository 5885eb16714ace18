"""Quadric shapes: sphere, cylinder, disk, cone, paraboloid, hyperboloid
(port of pbrt_tpu/shapes/quadrics.py).

All quadrics of a scene live in one table (type, object<->world matrices,
parameter vector). Each intersect is branch-free: clipping (zmin/zmax/
phimax) and the two roots are masks, the smaller valid root wins. The
parameters `qp` are a tensor whose last axis holds the 8 values below; its
leading axes broadcast against the rays' (a [8] row for one quadric, [N, 8]
per lane, or [Q, 8] against rays of shape [N, Q, 3]).

Parameter layout (quad_params[:, 8]):
  sphere:      radius, zmin, zmax, phimax, theta_min, theta_max, -, -
  cylinder:    radius, zmin, zmax, phimax, -, -, -, -
  disk:        height, radius, inner_radius, phimax, -, -, -, -
  cone:        radius, height, phimax, -, -, -, -, -
  paraboloid:  radius, zmin, zmax, phimax, -, -, -, -
  hyperboloid: p1(3), phimax, p2(3), a (the implicit x^2+y^2 coefficient)
"""
from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.math import PI, cross, dot, normalize, quadratic, vec3

SPHERE, CYLINDER, DISK, CONE, PARABOLOID, HYPERBOLOID = range(6)
KIND_NAMES = {"sphere": SPHERE, "cylinder": CYLINDER, "disk": DISK,
              "cone": CONE, "paraboloid": PARABOLOID, "hyperboloid": HYPERBOLOID}


def build_quadric(kind: str, params: dict):
    """ParamSet values -> (type id, param vector [8] float32, area)."""
    p = np.zeros(8, np.float32)
    if kind == "sphere":
        r = float(params.get("radius", [1.0])[0])
        zmin = float(params.get("zmin", [-r])[0])
        zmax = float(params.get("zmax", [r])[0])
        phimax = np.radians(float(params.get("phimax", [360.0])[0]))
        tmin = np.arccos(np.clip(min(zmin, zmax) / r, -1, 1))
        tmax = np.arccos(np.clip(max(zmin, zmax) / r, -1, 1))
        p[:6] = [r, min(zmin, zmax), max(zmin, zmax), phimax, tmin, tmax]
        area = phimax * r * (max(zmin, zmax) - min(zmin, zmax))
        return SPHERE, p, float(area)
    if kind == "cylinder":
        r = float(params.get("radius", [1.0])[0])
        zmin = float(params.get("zmin", [-1.0])[0])
        zmax = float(params.get("zmax", [1.0])[0])
        phimax = np.radians(float(params.get("phimax", [360.0])[0]))
        p[:4] = [r, min(zmin, zmax), max(zmin, zmax), phimax]
        return CYLINDER, p, float((zmax - zmin) * r * phimax)
    if kind == "disk":
        h = float(params.get("height", [0.0])[0])
        r = float(params.get("radius", [1.0])[0])
        ir = float(params.get("innerradius", [0.0])[0])
        phimax = np.radians(float(params.get("phimax", [360.0])[0]))
        p[:4] = [h, r, ir, phimax]
        return DISK, p, float(phimax * 0.5 * (r * r - ir * ir))
    if kind == "cone":
        r = float(params.get("radius", [1.0])[0])
        h = float(params.get("height", [1.0])[0])
        phimax = np.radians(float(params.get("phimax", [360.0])[0]))
        p[:3] = [r, h, phimax]
        return CONE, p, float(r * np.sqrt(h * h + r * r) * phimax / 2.0)
    if kind == "paraboloid":
        r = float(params.get("radius", [1.0])[0])
        zmin = float(params.get("zmin", [0.0])[0])
        zmax = float(params.get("zmax", [1.0])[0])
        phimax = np.radians(float(params.get("phimax", [360.0])[0]))
        p[:4] = [r, min(zmin, zmax), max(zmin, zmax), phimax]
        radius2 = r * r
        k = 4.0 * zmax / radius2
        area = (radius2 * radius2 * phimax / (12.0 * zmax * zmax)) * \
            ((k * zmax + 1) ** 1.5 - (k * zmin + 1) ** 1.5)
        return PARABOLOID, p, float(area)
    if kind == "hyperboloid":
        pa = _point_param(params, "p1", [0, 0, 0])
        pb = _point_param(params, "p2", [1, 1, 1])
        phimax = np.radians(float(params.get("phimax", [360.0])[0]))
        if pb[2] == 0.0:
            pa, pb = pb, pa
        # the implicit form x^2 + y^2 - c z^2 = 1 scaled by a: step the first
        # point outward until the two points' equations are independent
        pp = pa.copy()
        a = 0.0
        for _ in range(64):
            pp = pa + 2.0 * (pp - pa)
            xy1 = pp[0] ** 2 + pp[1] ** 2
            xy2 = pb[0] ** 2 + pb[1] ** 2
            denom = xy1 * pb[2] ** 2 - xy2 * pp[2] ** 2
            if abs(denom) < 1e-12:
                continue
            a = (pp[2] ** 2 - pb[2] ** 2) / denom
            if np.isfinite(a) and a != 0.0:
                break
        p[:3] = pa
        p[3] = phimax
        p[4:7] = pb
        p[7] = np.float32(a)
        zmin, zmax = min(pa[2], pb[2]), max(pa[2], pb[2])
        rmax = max(np.hypot(*pa[:2]), np.hypot(*pb[:2]))
        area = phimax * rmax * (zmax - zmin)   # approximate, as the reference's
        return HYPERBOLOID, p, float(area)
    raise ValueError(f"unknown quadric {kind!r}")


def _point_param(params, name, default):
    """A point parameter's first 3 values as float32 [3]."""
    v = params.get(name, [default])
    first = v[0]
    if isinstance(first, (list, np.ndarray)):
        return np.asarray(first, np.float32).reshape(3)
    return np.asarray(v[:3], np.float32).reshape(3)


def _clip_phi(px, py, phimax):
    phi = torch.atan2(py, px)
    phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)
    return phi, phi <= phimax + 1e-6


def _pick_root(has, t0, t1, t_max, ok0, ok1):
    """The smaller root that is past 1e-4, below t_max and inside the clip
    -> (use t0 [..], hit [..], t [..])."""
    use0 = has & (t0 > 1e-4) & (t0 < t_max) & ok0
    use1 = has & (t1 > 1e-4) & (t1 < t_max) & ok1 & ~use0
    return use0, use0 | use1, torch.where(use0, t0, t1)


def _sel3(use0, a, b):
    return torch.where(use0[..., None], a, b)


def intersect_quadric(qtype: int, qp, o, d, t_max, full: bool = True):
    """Object-space intersect of quadrics of one kind with rays.

    o, d [..., 3] object-space rays; t_max broadcasts against o[..., 0].
    -> (hit, t) when not full, else (hit, t, p, n, uv, dpdu, dpdv, p_err),
    all in object space."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    q = lambda i: qp[..., i]

    if qtype == SPHERE:
        radius, zmin, zmax, phimax, theta_min, theta_max = (q(i) for i in range(6))
        has, t0, t1 = quadratic(dot(d, d), 2.0 * dot(o, d), dot(o, o) - radius * radius)
        whole = (zmin <= -radius + 1e-7) & (zmax >= radius - 1e-7) & (phimax >= 2 * PI - 1e-6)

        def eval_at(t):
            p = o + d * t[..., None]
            # refine onto the sphere
            p = p * (radius / torch.clamp(vm.length(p), min=1e-20))[..., None]
            phi, phi_ok = _clip_phi(p[..., 0], p[..., 1], phimax)
            z_ok = (p[..., 2] >= zmin - 1e-6) & (p[..., 2] <= zmax + 1e-6)
            return p, phi, whole | (z_ok & phi_ok)

        p0, phi0, ok0 = eval_at(t0)
        p1, phi1, ok1 = eval_at(t1)
        use0, hit, t = _pick_root(has, t0, t1, t_max, ok0, ok1)
        if not full:
            return hit, t
        p, phi = _sel3(use0, p0, p1), torch.where(use0, phi0, phi1)
        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        theta = torch.acos(torch.clamp(pz / radius, -1.0, 1.0))
        dth = torch.clamp(theta_max - theta_min, min=1e-6)
        uv = torch.stack([phi / phimax, (theta - theta_min) / dth], -1)
        inv_zr = 1.0 / torch.sqrt(torch.clamp(px * px + py * py, min=1e-20))
        zero = torch.zeros_like(px)
        dpdu = vec3(-phimax * py, phimax * px, zero)
        dpdv = dth[..., None] * vec3(pz * (px * inv_zr), pz * (py * inv_zr),
                                     -radius * torch.sin(theta))
        return hit, t, p, normalize(p), uv, dpdu, dpdv, vm.gamma_bound(5) * torch.abs(p)

    if qtype == CYLINDER:
        radius, zmin, zmax, phimax = (q(i) for i in range(4))
        has, t0, t1 = quadratic(dx * dx + dy * dy, 2.0 * (dx * ox + dy * oy),
                                ox * ox + oy * oy - radius * radius)

        def eval_at(t):
            p = o + d * t[..., None]
            s = radius / torch.sqrt(torch.clamp(p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1],
                                                min=1e-20))
            p = torch.stack([p[..., 0] * s, p[..., 1] * s, p[..., 2]], -1)
            phi, phi_ok = _clip_phi(p[..., 0], p[..., 1], phimax)
            return p, phi, (p[..., 2] >= zmin) & (p[..., 2] <= zmax) & phi_ok

        p0, phi0, ok0 = eval_at(t0)
        p1, phi1, ok1 = eval_at(t1)
        use0, hit, t = _pick_root(has, t0, t1, t_max, ok0, ok1)
        if not full:
            return hit, t
        p, phi = _sel3(use0, p0, p1), torch.where(use0, phi0, phi1)
        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        zero = torch.zeros_like(px)
        uv = torch.stack([phi / phimax, (pz - zmin) / torch.clamp(zmax - zmin, min=1e-9)], -1)
        dpdu = vec3(-phimax * py, phimax * px, zero)
        dpdv = vec3(zero, zero, (zmax - zmin) + zero)
        radial = vec3(px, py, zero)
        return (hit, t, p, normalize(radial), uv, dpdu, dpdv,
                vm.gamma_bound(3) * torch.abs(radial))

    if qtype == DISK:
        height, radius, inner_radius, phimax = (q(i) for i in range(4))
        t = (height - oz) / torch.where(torch.abs(dz) < 1e-9, vm.INF, dz)
        p = o + d * t[..., None]
        px, py = p[..., 0], p[..., 1]
        dist2 = px * px + py * py
        phi, phi_ok = _clip_phi(px, py, phimax)
        hit = ((torch.abs(dz) > 1e-9) & (t > 1e-4) & (t < t_max) & (dist2 <= radius * radius)
               & (dist2 >= inner_radius * inner_radius) & phi_ok)
        if not full:
            return hit, t
        r_hit = torch.sqrt(torch.clamp(dist2, min=1e-20))
        one_minus_v = (r_hit - inner_radius) / torch.clamp(radius - inner_radius, min=1e-9)
        uv = torch.stack([phi / phimax, 1.0 - one_minus_v], -1)
        zero = torch.zeros_like(px)
        dpdu = vec3(-phimax * py, phimax * px, zero)
        dpdv = vec3(px, py, zero) * ((inner_radius - radius)
                                     / torch.clamp(r_hit, min=1e-9))[..., None]
        n = vec3(zero, zero, zero + 1.0)
        p = torch.stack([px, py, height + zero], -1)
        return hit, t, p, n, uv, dpdu, dpdv, torch.zeros_like(p)

    if qtype == CONE:
        radius, cheight, phimax = (q(i) for i in range(3))
        k = (radius / cheight) * (radius / cheight)
        has, t0, t1 = quadratic(dx * dx + dy * dy - k * dz * dz,
                                2.0 * (dx * ox + dy * oy - k * dz * (oz - cheight)),
                                ox * ox + oy * oy - k * (oz - cheight) * (oz - cheight))

        def eval_at(t):
            p = o + d * t[..., None]
            phi, phi_ok = _clip_phi(p[..., 0], p[..., 1], phimax)
            return p, phi, (p[..., 2] >= 0.0) & (p[..., 2] <= cheight) & phi_ok

        p0, phi0, ok0 = eval_at(t0)
        p1, phi1, ok1 = eval_at(t1)
        use0, hit, t = _pick_root(has, t0, t1, t_max, ok0, ok1)
        if not full:
            return hit, t
        p, phi = _sel3(use0, p0, p1), torch.where(use0, phi0, phi1)
        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        v = pz / cheight
        uv = torch.stack([phi / phimax, v], -1)
        zero = torch.zeros_like(px)
        dpdu = vec3(-phimax * py, phimax * px, zero)
        omv = torch.clamp(1.0 - v, min=1e-6)
        dpdv = vec3(-px / omv, -py / omv, cheight + zero)
        return (hit, t, p, normalize(cross(dpdu, dpdv)), uv, dpdu, dpdv,
                vm.gamma_bound(7) * torch.abs(p))

    if qtype == PARABOLOID:
        radius, zmin, zmax, phimax = (q(i) for i in range(4))
        k = zmax / (radius * radius)
        has, t0, t1 = quadratic(k * (dx * dx + dy * dy), 2.0 * k * (dx * ox + dy * oy) - dz,
                                k * (ox * ox + oy * oy) - oz)

        def eval_at(t):
            p = o + d * t[..., None]
            phi, phi_ok = _clip_phi(p[..., 0], p[..., 1], phimax)
            return p, phi, (p[..., 2] >= zmin) & (p[..., 2] <= zmax) & phi_ok

        p0, phi0, ok0 = eval_at(t0)
        p1, phi1, ok1 = eval_at(t1)
        use0, hit, t = _pick_root(has, t0, t1, t_max, ok0, ok1)
        if not full:
            return hit, t
        p, phi = _sel3(use0, p0, p1), torch.where(use0, phi0, phi1)
        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        uv = torch.stack([phi / phimax, (pz - zmin) / torch.clamp(zmax - zmin, min=1e-9)], -1)
        zero = torch.zeros_like(px)
        dpdu = vec3(-phimax * py, phimax * px, zero)
        pz2 = 2.0 * torch.clamp(pz, min=1e-6)
        dpdv = (zmax - zmin)[..., None] * vec3(px / pz2, py / pz2, zero + 1.0)
        return (hit, t, p, normalize(cross(dpdu, dpdv)), uv, dpdu, dpdv,
                vm.gamma_bound(7) * torch.abs(p))

    if qtype == HYPERBOLOID:
        p1x, p1y, p1z, phimax, p2x, p2y, p2z, ah = (q(i) for i in range(8))
        p1v, p2v = vec3(p1x, p1y, p1z), vec3(p2x, p2y, p2z)
        z2 = torch.where(torch.abs(p2z) < 1e-9, 1.0, p2z)
        ch = (ah * (p2x * p2x + p2y * p2y) - 1.0) / (z2 * z2)
        zmin, zmax = torch.minimum(p1z, p2z), torch.maximum(p1z, p2z)
        has, t0, t1 = quadratic(ah * dx * dx + ah * dy * dy - ch * dz * dz,
                                2.0 * (ah * dx * ox + ah * dy * oy - ch * dz * oz),
                                ah * ox * ox + ah * oy * oy - ch * oz * oz - 1.0)

        def eval_at(t):
            p = o + d * t[..., None]
            v = (p[..., 2] - p1z) / torch.clamp(p2z - p1z, min=1e-9)
            pr = (1.0 - v)[..., None] * p1v + v[..., None] * p2v
            phi = torch.atan2(pr[..., 0] * p[..., 1] - p[..., 0] * pr[..., 1],
                              p[..., 0] * pr[..., 0] + p[..., 1] * pr[..., 1])
            phi = torch.where(phi < 0.0, phi + 2 * PI, phi)
            return p, phi, v, (p[..., 2] >= zmin) & (p[..., 2] <= zmax) & (phi <= phimax)

        p0, phi0, v0, ok0 = eval_at(t0)
        p1, phi1, v1, ok1 = eval_at(t1)
        use0, hit, t = _pick_root(has, t0, t1, t_max, ok0, ok1)
        if not full:
            return hit, t
        p, phi = _sel3(use0, p0, p1), torch.where(use0, phi0, phi1)
        px, py = p[..., 0], p[..., 1]
        uv = torch.stack([phi / phimax, torch.where(use0, v0, v1)], -1)
        cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
        zero = torch.zeros_like(px)
        dpdu = vec3(-phimax * py, phimax * px, zero)
        dxdv, dydv = p2x - p1x, p2y - p1y
        dpdv = vec3(dxdv * cos_phi - dydv * sin_phi, dxdv * sin_phi + dydv * cos_phi,
                    (p2z - p1z) + zero)
        return (hit, t, p, normalize(cross(dpdu, dpdv)), uv, dpdu, dpdv,
                vm.gamma_bound(7) * torch.abs(p))

    raise ValueError(qtype)


def quadric_object_bounds(qtype: int, qp) -> tuple:
    """Host-side conservative object bounds -> (lo [3], hi [3])."""
    qp = np.asarray(qp)
    if qtype in (SPHERE, CYLINDER, PARABOLOID):
        r = qp[0]
        return np.array([-r, -r, qp[1]]), np.array([r, r, qp[2]])
    if qtype == DISK:
        h, r = qp[0], qp[1]
        return np.array([-r, -r, h - 1e-4]), np.array([r, r, h + 1e-4])
    if qtype == CONE:
        r, h = qp[0], qp[1]
        return np.array([-r, -r, 0.0]), np.array([r, r, h])
    if qtype == HYPERBOLOID:
        p1, p2 = qp[0:3], qp[4:7]
        rmax = max(np.hypot(p1[0], p1[1]), np.hypot(p2[0], p2[1]))
        zmin, zmax = min(p1[2], p2[2]), max(p1[2], p2[2])
        return np.array([-rmax, -rmax, zmin]), np.array([rmax, rmax, zmax])
    raise ValueError(qtype)


def tessellate_quadric(qtype: int, qp, o2w: np.ndarray, nu: int = 64, nv: int = 32,
                       flip_normal: bool = False) -> np.ndarray:
    """Host-side parametric tessellation of a quadric to world-space
    triangles [T, 3, 3], for sampling a quadric area light by area through
    the triangle CDF every emitter shares.

    Vertices are pushed outward along the surface normal by the largest
    facet sag, so the tessellation circumscribes the surface and a shadow
    ray toward a sample does not first hit the quadric itself. The (u, v)
    grids follow intersect_quadric's parameterization, so partial sweeps
    tessellate exactly the emitting part. Each triangle is wound so that its
    normal points out of the surface, or in when flip_normal."""
    qp = np.asarray(qp, np.float64)

    if qtype == SPHERE:
        r, zmin, zmax, phimax = qp[0], qp[1], qp[2], qp[3]
        tmin = np.arccos(np.clip(zmax / r, -1, 1))
        tmax = np.arccos(np.clip(zmin / r, -1, 1))

        def eval_p(U, V):
            phi = U * phimax
            theta = tmin + V * (tmax - tmin)
            st = np.sin(theta)
            return np.stack([r * st * np.cos(phi), r * st * np.sin(phi), r * np.cos(theta)], -1)
    elif qtype == CYLINDER:
        r, zmin, zmax, phimax = qp[0], qp[1], qp[2], qp[3]

        def eval_p(U, V):
            phi = U * phimax
            return np.stack([r * np.cos(phi), r * np.sin(phi), zmin + V * (zmax - zmin)], -1)
    elif qtype == DISK:
        h, r, ir, phimax = qp[0], qp[1], qp[2], qp[3]

        def eval_p(U, V):
            phi = U * phimax
            rad = np.sqrt(ir * ir + V * (r * r - ir * ir))
            return np.stack([rad * np.cos(phi), rad * np.sin(phi), np.full_like(phi, h)], -1)
    elif qtype == CONE:
        r, h, phimax = qp[0], qp[1], qp[2]

        def eval_p(U, V):
            phi = U * phimax
            return np.stack([r * (1 - V) * np.cos(phi), r * (1 - V) * np.sin(phi), V * h], -1)
    elif qtype == PARABOLOID:
        r, zmin, zmax, phimax = qp[0], qp[1], qp[2], qp[3]

        def eval_p(U, V):
            phi = U * phimax
            z = zmin + V * (zmax - zmin)
            rad = r * np.sqrt(np.maximum(z / max(zmax, 1e-12), 0.0))
            return np.stack([rad * np.cos(phi), rad * np.sin(phi), z], -1)
    elif qtype == HYPERBOLOID:
        p1, p2, phimax = qp[0:3], qp[4:7], qp[3]

        def eval_p(U, V):
            phi = U * phimax
            x = (1 - V) * p1[0] + V * p2[0]
            y = (1 - V) * p1[1] + V * p2[1]
            z = (1 - V) * p1[2] + V * p2[2]
            return np.stack([x * np.cos(phi) - y * np.sin(phi),
                             x * np.sin(phi) + y * np.cos(phi), z], -1)
    else:
        raise ValueError(qtype)

    uu = np.linspace(0.0, 1.0, nu + 1)
    vv = np.linspace(0.0, 1.0, nv + 1)
    U, V = np.meshgrid(uu, vv, indexing="ij")      # [nu+1, nv+1]
    P = eval_p(U, V)

    # facet sag: the largest distance from the surface at a facet's centre
    # to the average of its corners
    Um, Vm = np.meshgrid(0.5 * (uu[:-1] + uu[1:]), 0.5 * (vv[:-1] + vv[1:]), indexing="ij")
    corner_avg = 0.25 * (P[:-1, :-1] + P[1:, :-1] + P[1:, 1:] + P[:-1, 1:])
    sag = float(np.linalg.norm(eval_p(Um, Vm) - corner_avg, axis=-1).max())

    # outward reference direction in object space: radial from the origin
    # for the sphere, +z for the disk, radial from the axis otherwise
    if qtype == DISK:
        ref_dir = np.zeros_like(P)
        ref_dir[..., 2] = 1.0
    else:
        ref_dir = P.copy()
        if qtype != SPHERE:
            ref_dir[..., 2] = 0.0

    if sag > 0.0:
        # outward vertex normals from numeric partials, oriented by ref_dir
        hstep = 1e-4
        du = eval_p(np.clip(U + hstep, 0, 1), V) - eval_p(np.clip(U - hstep, 0, 1), V)
        dv = eval_p(U, np.clip(V + hstep, 0, 1)) - eval_p(U, np.clip(V - hstep, 0, 1))
        nrm = np.cross(du, dv)
        nlen = np.linalg.norm(nrm, axis=-1, keepdims=True)
        rlen = np.linalg.norm(ref_dir, axis=-1, keepdims=True)
        # degenerate partials (the sphere's poles) take the reference direction
        nrm = np.where(nlen > 1e-9, nrm / np.maximum(nlen, 1e-30),
                       ref_dir / np.maximum(rlen, 1e-30))
        sgn = np.sign(np.sum(nrm * ref_dir, -1, keepdims=True))
        sgn = np.where(np.abs(sgn) < 0.5, 1.0, sgn)
        P = P + nrm * sgn * (1.001 * sag)

    m = np.asarray(o2w, np.float64)
    Pw = P @ m[:3, :3].T + m[:3, 3]
    ref_w = ref_dir @ m[:3, :3].T
    a, ra = Pw[:-1, :-1], ref_w[:-1, :-1]
    b = Pw[1:, :-1]
    c, rc = Pw[1:, 1:], ref_w[1:, 1:]
    d = Pw[:-1, 1:]
    tris = np.concatenate([np.stack([a, b, c], -2).reshape(-1, 3, 3),
                           np.stack([a, c, d], -2).reshape(-1, 3, 3)], 0)
    refs = np.concatenate([ra.reshape(-1, 3), rc.reshape(-1, 3)], 0)
    # wind each triangle so cross(p1 - p0, p2 - p0) is the emitting side
    fn = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    want_neg = (np.sum(fn * refs, -1) < 0.0) ^ bool(flip_normal)
    tris[want_neg] = tris[want_neg][:, ::-1]
    tris = tris.astype(np.float32)
    # drop degenerate slivers (poles, inner radius 0)
    area2 = np.linalg.norm(np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]), axis=-1)
    return tris[area2 > 1e-12]
