"""Participating media: homogeneous and grid-density media and the
Henyey-Greenstein phase function (port of pbrt_tpu/media/__init__.py).

One medium table per scene; grids live in one flat density array with a
per-medium (offset, nx, ny, nz). Homogeneous sampling is the closed-form
channel-MIS estimator. Grid sampling is delta tracking and grid
transmittance ratio tracking, as in the reference: a host loop over
TRACKING_UNROLL-step blocks that goes on while any lane still walks and
the TRACKING_MAX_BLOCKS roof is not reached (the reference's
lax.while_loop). Each test of that condition reads one flag back from
the device; HOST_READS counts them.

A lane walks only while its walk can still change its result: the lanes
of a grid medium until they pass their segment's end or leave the grid's
box for good (beyond it the density is 0, so no collision is real and the
ratio stays 1). The reference walks every lane, those of homogeneous
media and vacuum too, whose tracked values it then discards, and a lane
whose segment never ends (a ray that hits nothing) walks to the roof. The
estimate of every lane is the reference's.

Medium params layout (params[:, 8]):
  [0] g   [1] grid offset   [2:5] nx, ny, nz   [5] max_density (grid)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.math import INV_4PI, PI, normalize
from pbrt_tpu_torch.core.transform import Transform, scale as tscale, translate
from pbrt_tpu_torch.samplers.hashing import hash_combine, u32_to_float

M_HOMOGENEOUS, M_GRID = 0, 1
TRACKING_UNROLL = 8
TRACKING_MAX_BLOCKS = 2048
HOST_READS = {"blocks": 0}   # device-to-host reads of the tracking loops' condition
MEDIUM_KEYS = ("kind", "sigma_a", "sigma_s", "params", "w2m", "density")


@dataclasses.dataclass
class MediumTable:
    kind: torch.Tensor      # [Md] int32
    sigma_a: torch.Tensor   # [Md,3]
    sigma_s: torch.Tensor   # [Md,3]
    params: torch.Tensor    # [Md,8]
    w2m: torch.Tensor       # [Md,4,4] world to the grid's unit cube
    density: torch.Tensor   # [total] flat grid densities

    @property
    def n_media(self):
        return self.kind.shape[0]


def compile_media(media_decls: dict):
    """Host: {name: (kind, ParamSet, l2w)} -> ({med_<key>: numpy table},
    name -> id, any grid medium). Media are numbered by sorted name; a
    scene without media gets one unused homogeneous row."""
    names = sorted(media_decls.keys())
    Md = max(len(names), 1)
    kind = np.zeros(Md, np.int32)
    sigma_a = np.tile(np.asarray([[1.0, 1.0, 1.0]], np.float32), (Md, 1))
    sigma_s = np.tile(np.asarray([[1.0, 1.0, 1.0]], np.float32), (Md, 1))
    params = np.zeros((Md, 8), np.float32)
    w2m = np.tile(np.eye(4, dtype=np.float32), (Md, 1, 1))
    density_parts, total, name_to_id = [], 0, {}
    for i, name in enumerate(names):
        mkind, ps, l2w = media_decls[name]
        name_to_id[name] = i
        s = ps.find_one_float("scale", 1.0)
        sigma_a[i] = ps.find_one_rgb("sigma_a", [1.0, 1.0, 1.0]) * s
        sigma_s[i] = ps.find_one_rgb("sigma_s", [1.0, 1.0, 1.0]) * s
        params[i, 0] = ps.find_one_float("g", 0.0)
        if mkind in ("heterogeneous", "grid") or "density" in ps:
            kind[i] = M_GRID
            d = ps.find_floats("density")
            nx, ny, nz = (ps.find_one_int(k, 1) for k in ("nx", "ny", "nz"))
            if d is None:
                d = np.ones(nx * ny * nz, np.float32)
            params[i, 1] = total
            params[i, 2:5] = [nx, ny, nz]
            params[i, 5] = float(d.max())
            density_parts.append(d.astype(np.float32))
            total += d.size
            p0 = ps.find_one_rgb("p0", [0, 0, 0])
            p1 = ps.find_one_rgb("p1", [1, 1, 1])
            m2w = Transform(l2w) * translate(p0) * tscale(np.maximum(p1 - p0, 1e-9))
            w2m[i] = m2w.m_inv
    density = np.concatenate(density_parts) if density_parts else np.zeros(1, np.float32)
    return ({"med_kind": kind, "med_sigma_a": sigma_a, "med_sigma_s": sigma_s,
             "med_params": params, "med_w2m": w2m, "med_density": density},
            name_to_id, bool((kind == M_GRID).any()))


def medium_table(t: dict, device) -> MediumTable:
    return MediumTable(*(torch.as_tensor(np.array(t[f"med_{k}"]), device=device)
                         for k in MEDIUM_KEYS))


# ---------------------------------------------------------------------------
# Henyey-Greenstein phase function
# ---------------------------------------------------------------------------

def hg_p(cos_theta, g):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-9)), min=1e-9)


def hg_sample(wo, g, u2):
    """Sample wi ~ HG around -wo -> (wi, pdf = p)."""
    small = torch.abs(g) < 1e-3
    g_safe = torch.where(small, 1e-3 * torch.sign(g + 1e-9), g)
    sq = (1.0 - g_safe * g_safe) / (1.0 + g_safe - 2.0 * g_safe * u2[..., 0])
    cos_theta = -(1.0 + g_safe * g_safe - sq * sq) / (2.0 * g_safe)
    cos_theta = torch.where(small, 1.0 - 2.0 * u2[..., 0], cos_theta)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * PI * u2[..., 1]
    wn = normalize(wo)
    v1, v2 = vm.coordinate_system(wn)
    wi = ((sin_theta * torch.cos(phi))[..., None] * v1
          + (sin_theta * torch.sin(phi))[..., None] * v2 + cos_theta[..., None] * wn)
    return wi, hg_p(cos_theta, g)


# ---------------------------------------------------------------------------
# grid density and tracking
# ---------------------------------------------------------------------------

def _mean3(v):
    return (v[:, 0] + v[:, 1] + v[:, 2]) / 3.0


class _Grid:
    """The per-lane constants of the grid lookup of media m [N]."""

    def __init__(self, med: MediumTable, m):
        self.density = med.density
        w2m = med.w2m[m]
        self.lin, self.off3 = w2m[:, :3, :3], w2m[:, :3, 3]
        pr = med.params[m]
        self.n = [pr[:, k].to(torch.int32) for k in (2, 3, 4)]
        self.nf = [v.to(torch.float32) for v in self.n]
        self.off = pr[:, 1].to(torch.int32)

    def density_at(self, p_world):
        """Trilinear density at world points [N,3]: 0 outside the box."""
        pm = torch.einsum("nij,nj->ni", self.lin, p_world) + self.off3
        nx, ny, nz = self.n
        g = [pm[:, a] * self.nf[a] - 0.5 for a in range(3)]
        lo = [torch.floor(v).to(torch.int32) for v in g]
        fx, fy, fz = (v - c for v, c in zip(g, lo))
        valid = [((c >= 0) & (c < n), (c + 1 >= 0) & (c + 1 < n))
                 for c, n in zip(lo, self.n)]
        base = self.off + (lo[2] * ny + lo[1]) * nx + lo[0]
        top = self.density.shape[0] - 1

        def dv(i, j, k):
            idx = torch.clamp(base + (k * ny + j) * nx + i if (i or j or k) else base, 0, top)
            return torch.where(valid[0][i] & valid[1][j] & valid[2][k],
                               self.density[idx.to(torch.int64)], 0.0)

        d00 = vm.lerp(fx, dv(0, 0, 0), dv(1, 0, 0))
        d10 = vm.lerp(fx, dv(0, 1, 0), dv(1, 1, 0))
        d01 = vm.lerp(fx, dv(0, 0, 1), dv(1, 0, 1))
        d11 = vm.lerp(fx, dv(0, 1, 1), dv(1, 1, 1))
        inside = torch.all((pm >= 0.0) & (pm <= 1.0), -1)
        val = vm.lerp(fz, vm.lerp(fy, d00, d10), vm.lerp(fy, d01, d11))
        return torch.where(inside, val, 0.0)

    def exit_t(self, o, d):
        """The ray parameter past which the rays (o, d) stay outside the
        grid's box, with a margin over rounding (-inf where the ray misses
        the box ahead of it)."""
        om = torch.einsum("nij,nj->ni", self.lin, o) + self.off3
        dm = torch.einsum("nij,nj->ni", self.lin, d)
        t0, t1 = (0.0 - om) / dm, (1.0 - om) / dm
        t_near = torch.amax(torch.minimum(t0, t1), -1)
        t_far = torch.amin(torch.maximum(t0, t1), -1)
        t_far = t_far * (1.0 + 1e-4) + 1e-4
        return torch.where(t_near > t_far, -vm.INF, t_far)


def _walk(cond, block):
    """The reference's while loop over tracking blocks: run block(step0)
    while cond() (one device read each) and the roof allows."""
    step0 = 0
    while step0 < TRACKING_UNROLL * TRACKING_MAX_BLOCKS:
        HOST_READS["blocks"] += 1
        if not bool(cond()):
            break
        block(step0)
        step0 += TRACKING_UNROLL


@dataclasses.dataclass
class MediumSample:
    sampled_medium: torch.Tensor   # [N] bool: scattered inside the medium
    t: torch.Tensor                # [N] scatter distance
    p: torch.Tensor                # [N,3]
    weight: torch.Tensor           # [N,3] beta multiplier


def sample_medium(med: MediumTable, mid, o, d, t_surf, key_a, key_b, u, any_grid=True):
    """Sample a medium interaction along [0, t_surf) for lanes with mid >= 0
    (u [N,2]: channel select, distance; key_a/key_b: the u32 keys of the
    delta-tracking hash stream)."""
    n = o.shape[0]
    has = mid >= 0
    m = torch.clamp(mid, min=0).to(torch.int64)
    ss = med.sigma_s[m]
    st = med.sigma_a[m] + ss

    # homogeneous: closed-form spectral MIS
    ch = torch.clamp((u[:, 0] * 3).to(torch.int32), 0, 2).to(torch.int64)
    st_ch = torch.gather(st, 1, ch[:, None])[:, 0]
    dist = -torch.log(torch.clamp(1.0 - u[:, 1], min=1e-38)) / torch.clamp(st_ch, min=1e-12)
    t_h = torch.minimum(dist, t_surf)
    inside_h = (dist < t_surf) & (st_ch > 0.0)
    tr_h = torch.exp(-st * torch.clamp(t_h, max=1e6)[:, None])
    dens_h = torch.where(inside_h[:, None], st * tr_h, tr_h)
    pdf_h = torch.clamp(_mean3(dens_h), min=1e-12)
    w_h = torch.where(inside_h[:, None], tr_h * ss / pdf_h[:, None], tr_h / pdf_h[:, None])
    if not any_grid:
        return MediumSample(inside_h & has, t_h, o + d * t_h[:, None],
                            torch.where(has[:, None], w_h, 1.0))

    # grid: delta tracking
    is_grid = med.kind[m] == M_GRID
    grid = _Grid(med, m)
    max_d = torch.clamp(med.params[m][:, 5], min=1e-9)
    inv_sbar = 1.0 / torch.clamp(max_d * _mean3(st), min=1e-12)
    t_exit = grid.exit_t(o, d)
    kab = hash_combine(key_a, key_b)
    state = {"t": torch.zeros(n, device=o.device),
           "done": ~(has & is_grid) | (t_exit <= 0.0),
           "scat": torch.zeros(n, dtype=torch.bool, device=o.device)}

    def block(step0):
        t_cur, done, scat = state["t"], state["done"], state["scat"]
        for k in range(TRACKING_UNROLL):
            step = step0 + k
            u1 = u32_to_float(hash_combine(kab, 2 * step))
            u2 = u32_to_float(hash_combine(kab, 2 * step + 1))
            t_cur = torch.where(done, t_cur, t_cur - torch.log(
                torch.clamp(1.0 - u1, min=1e-38)) * inv_sbar)
            past = t_cur >= t_surf
            real = u2 < grid.density_at(o + d * t_cur[:, None]) / max_d
            newly = ~done & ~past & real
            scat = scat | newly
            done = done | past | newly | (t_cur >= t_exit)
        state.update(t=t_cur, done=done, scat=scat)

    _walk(lambda: (~state["done"]).any(), block)
    scat = state["scat"]
    # a lane that did not scatter ran to its segment's end, where the
    # reference's min(t, t_surf) puts it
    t_g = torch.where(scat, state["t"], t_surf)
    w_g = torch.where(scat[:, None], ss / torch.clamp(st, min=1e-9), 1.0)
    t = torch.where(is_grid, t_g, t_h)
    w = torch.where(is_grid[:, None], w_g, w_h)
    return MediumSample(torch.where(is_grid, scat, inside_h) & has, t, o + d * t[:, None],
                        torch.where(has[:, None], w, 1.0))


def transmittance(med: MediumTable, mid, o, d, t_far, key_a, key_b, any_grid=True):
    """Tr [N,3] along the segments [0, t_far) for per-lane media mid (-1:
    vacuum); grids by ratio tracking."""
    n = o.shape[0]
    has = mid >= 0
    m = torch.clamp(mid, min=0).to(torch.int64)
    st = med.sigma_a[m] + med.sigma_s[m]
    tr_h = torch.exp(-st * torch.clamp(t_far, max=1e6)[:, None])
    if not any_grid:
        return torch.where(has[:, None], tr_h, 1.0)
    is_grid = med.kind[m] == M_GRID
    grid = _Grid(med, m)
    max_d = torch.clamp(med.params[m][:, 5], min=1e-9)
    inv_sbar = 1.0 / torch.clamp(max_d * _mean3(st), min=1e-12)
    t_exit = grid.exit_t(o, d)
    kab = hash_combine(key_a, key_b)
    state = {"t": torch.zeros(n, device=o.device), "tr": torch.ones(n, device=o.device),
           "done": ~(has & is_grid) | (t_exit <= 0.0)}

    def block(step0):
        t_cur, tr_g, done = state["t"], state["tr"], state["done"]
        for k in range(TRACKING_UNROLL):
            u1 = u32_to_float(hash_combine(kab, 0x5000 + 2 * (step0 + k)))
            t_cur = torch.where(done, t_cur, t_cur - torch.log(
                torch.clamp(1.0 - u1, min=1e-38)) * inv_sbar)
            done2 = done | (t_cur >= t_far)
            ratio = 1.0 - grid.density_at(o + d * t_cur[:, None]) / max_d
            tr_g = torch.where(done2, tr_g, tr_g * torch.clamp(ratio, min=0.0))
            done = done2 | (tr_g <= 0.0) | (t_cur >= t_exit)
        state.update(t=t_cur, tr=tr_g, done=done)

    _walk(lambda: (~state["done"]).any(), block)
    tr = torch.where(is_grid[:, None], state["tr"][:, None].expand(n, 3), tr_h)
    return torch.where(has[:, None], tr, 1.0)
