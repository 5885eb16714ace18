"""Stochastic progressive photon mapping over the whole wavefront (port of
pbrt_tpu/integrators/sppm.py).

Each iteration runs four passes:
  1. camera pass: one path a pixel to its first diffuse or glossy hit (a
     material with Kd, Ks or a FresnelBlend colour), through specular
     bounces, with NEE at every bounce; the hit is the pixel's visible
     point, its lobes and shading frame kept;
  2. grid: the visible points' cells (side twice the largest radius,
     1024-aliased ids, 0x7FFFFFFF for none) stably sorted;
  3. photon pass: photons from sample_le (lights by power), hashed by
     photon, iteration and salt; each hit after the first looks into the
     27 cells around it, at most MAX_PER_CELL = 16 sorted points a cell,
     and deposits beta * f at each point within its radius on the same
     side; a cell's entry past the 16th is counted as an overflow;
     Russian roulette on the photon's weight;
  4. pixel update with gamma 2/3.
The image is ld_sum / iterations + tau / (photons * pi r^2), written by
pixel without the film's filter.

The deposits are deterministic on every device: a deposit call's entries
are taken in the reference's (cell, slot, photon) order and summed per
visible point with the film's ordered sum, never with float atomics. The
entries are compacted before the gather BSDF, so f is evaluated only
where a photon reaches a point.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch import lights as LT
from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.math import dot, normalize
from pbrt_tpu_torch.film import SPLAT_CHUNK, _ordered_sum
from pbrt_tpu_torch.integrators.common import bounce_base, camera_rays, sample_one_light
from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.materials import M_MIX, compute_lobes
from pbrt_tpu_torch.samplers import sample_2d, sample_dim
from pbrt_tpu_torch.samplers.hashing import hash3, u32_to_float
from pbrt_tpu_torch.scene.intersect import intersect

MAX_PER_CELL = 16   # visible points a photon examines in a cell; more are counted as overflow
GAMMA = 2.0 / 3.0
NO_CELL = 0x7FFFFFFF
PHOTON_SALT = 0x9E37


@dataclasses.dataclass
class VisiblePoints:
    """A pixel's first diffuse or glossy hit: [P] valid, [P,3] p, wo and
    throughput beta, its lobes and shading frame (ns, ss, ts)."""
    valid: torch.Tensor
    p: torch.Tensor
    wo: torch.Tensor
    beta: torch.Tensor
    lobes: B.Lobes
    ns: torch.Tensor
    ss: torch.Tensor
    ts: torch.Tensor


@dataclasses.dataclass
class Grid:
    """The visible points' cells: lo [3] and cell_size [] (device
    tensors), cell [P] int32, order [P] (stable argsort) and
    sorted_cell [P]."""
    lo: torch.Tensor
    cell_size: torch.Tensor
    cell: torch.Tensor
    order: torch.Tensor
    sorted_cell: torch.Tensor

    def cell_of(self, p):
        return torch.clamp(((p - self.lo) / self.cell_size).to(torch.int32), 0, 1 << 20)


def cell_id(c):
    """Integer cell coordinates [..., 3] -> ids, each axis aliased to 10 bits."""
    return (c[..., 0] & 1023) * 1048576 + (c[..., 1] & 1023) * 1024 + (c[..., 2] & 1023)


def _where_rows(m, a, b):
    return torch.where(m.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def _merge_lobes(m, new: B.Lobes, old: B.Lobes) -> B.Lobes:
    return B.Lobes(**{f.name: None if getattr(new, f.name) is None else
                      _where_rows(m, getattr(new, f.name), getattr(old, f.name))
                      for f in dataclasses.fields(B.Lobes)})


def _lobes_rows(lb: B.Lobes, idx) -> B.Lobes:
    return B.Lobes(**{f.name: None if getattr(lb, f.name) is None else getattr(lb, f.name)[idx]
                      for f in dataclasses.fields(B.Lobes)})


def _lobes(cs, si, u_mix):
    """The hits' lobes; u_mix() draws the mix pick, only where the scene
    has a mix material."""
    data, flags = cs.data, cs.flags
    return compute_lobes(data.mats, data.tex, si.material, si.uv, si.p, None, flags.has_tex_slot,
                         flags.tex_kinds, u_mix() if M_MIX in flags.mat_kinds else None,
                         flags.bsdf_fams, flags.mat_kinds)


def camera_pass(cs, max_depth, px, py, it):
    """Pixels' paths at sample index `it` to their visible points ->
    (VisiblePoints, ld [P,3]: emission reached through specular bounces
    and NEE at every bounce, times the throughput)."""
    spec, data, flags = cs.sampler, cs.data, cs.flags
    n = px.shape[0]
    dev = px.device
    ftab = data.fourier if flags.has_fourier else None
    sidx = torch.full((n,), it, dtype=torch.int32, device=dev)
    rays, _, _ = camera_rays(cs, px, py, sidx)
    o, d = rays.o, rays.d
    beta = torch.ones((n, 3), device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    specular_bounce = torch.ones(n, dtype=torch.bool, device=dev)
    ld = torch.zeros((n, 3), device=dev)
    vp = None
    for bounce in range(max_depth):
        base = bounce_base(bounce)
        dn = normalize(d)
        si = intersect(data, flags, o, dn, torch.full((n,), vm.INF, device=dev))
        if flags.has_infinite:
            esc = active & ~si.valid & specular_bounce
            ld = ld + torch.where(esc[:, None], beta * LT.le_escaped(
                data.lights, flags.infinite_light_ids, dn), 0.0)
        if flags.has_area_lights:
            hit_l = active & si.valid & (si.area_light >= 0) & specular_bounce
            le = LT.le_area(data.lights, si.area_light, si.ng, si.wo)
            ld = ld + torch.where(hit_l[:, None], beta * le, 0.0)
        active = active & si.valid
        lobes = _lobes(cs, si, lambda: sample_dim(spec, px, py, sidx, base + 0))
        ldb = sample_one_light(cs, si, lobes, active, sample_dim(spec, px, py, sidx, base + 1),
                               sample_2d(spec, px, py, sidx, base + 2))
        ld = ld + torch.where(active[:, None], beta * ldb, 0.0)

        # a diffuse or glossy hit is the visible point; specular continues
        is_diffuse = ~B.black(lobes.kd)
        for c in (lobes.ks, lobes.rd_blend):
            if c is not None:
                is_diffuse = is_diffuse | ~B.black(c)
        if vp is None:
            zero = B.Lobes(**{f.name: None if getattr(lobes, f.name) is None
                              else torch.zeros_like(getattr(lobes, f.name))
                              for f in dataclasses.fields(B.Lobes)})
            z3 = torch.zeros((n, 3), device=dev)
            # the frame starts as the first hit's, as the reference's record does
            vp = VisiblePoints(torch.zeros_like(active), z3, z3, z3, zero, si.ns, si.ss, si.ts)
        newly = active & is_diffuse & ~vp.valid
        vp = VisiblePoints(vp.valid | newly, _where_rows(newly, si.p, vp.p),
                           _where_rows(newly, si.wo, vp.wo), _where_rows(newly, beta, vp.beta),
                           _merge_lobes(newly, lobes, vp.lobes), _where_rows(newly, si.ns, vp.ns),
                           _where_rows(newly, si.ss, vp.ss), _where_rows(newly, si.ts, vp.ts))
        active = active & ~newly
        if bounce == max_depth - 1:
            break

        bs = B.bsdf_sample(lobes, si.world_to_local(si.wo), sample_dim(spec, px, py, sidx, base + 4),
                           sample_2d(spec, px, py, sidx, base + 5), ftab, flags.bsdf_fams)
        wi_world = si.local_to_world(bs.wi)
        ok = active & bs.is_specular & (bs.pdf > 0.0) & ~B.black(bs.f)
        beta = torch.where(ok[:, None], beta * bs.f * (vm.absdot(wi_world, si.ns)
                                                       / torch.clamp(bs.pdf, min=1e-12))[:, None],
                           beta)
        active = ok
        specular_bounce = bs.is_specular
        o = si.spawn_origin(wi_world)
        d = wi_world
    return vp, ld


def build_grid(cs, vp: VisiblePoints, radius) -> Grid:
    """Sort the visible points by cell (a stable sort, as jnp.argsort)."""
    dev = radius.device
    cell_size = torch.max(torch.where(vp.valid, radius, 0.0)) * 2.0 + 1e-6
    lo = torch.as_tensor(np.asarray(cs.data.world_center, np.float32)
                         - np.float32(cs.data.world_radius), device=dev)
    grid = Grid(lo, cell_size, None, None, None)
    cell = torch.where(vp.valid, cell_id(grid.cell_of(vp.p)), NO_CELL)
    order = torch.argsort(cell, stable=True)
    return dataclasses.replace(grid, cell=cell, order=order, sorted_cell=cell[order])


def _deposit(vp: VisiblePoints, grid: Grid, radius, ph_p, ph_beta, ph_active, ph_dir, fams):
    """Photon hits -> this call's deposits into the visible points:
    (phi [P,3], m_count [P], overflow [] int64). Each hit examines the
    first MAX_PER_CELL sorted points of each of its 27 neighbour cells;
    the gather BSDF is each point's full f(wo, -photon direction) in its
    shading frame, without fourier tables, as in the reference."""
    n_pix = vp.p.shape[0]
    n_ph = ph_p.shape[0]
    dev = ph_p.device
    pc = grid.cell_of(ph_p)
    wi_w = -ph_dir
    ks = torch.arange(MAX_PER_CELL, device=dev)
    masks, slots = [], []
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for ci in range(27):
        off = torch.tensor([ci % 3 - 1, (ci // 3) % 3 - 1, ci // 9 - 1], dtype=torch.int32,
                           device=dev)
        cid = cell_id(pc + off)
        start = torch.searchsorted(grid.sorted_cell, cid, right=False)
        slot = torch.clamp(start[None, :] + ks[:, None], 0, n_pix - 1)   # [slot, photon]
        v = grid.order[slot]
        dist2 = vm.length_squared(vp.p[v] - ph_p)
        r = radius[v]
        same_side = dot(vp.ns[v], wi_w) * dot(vp.ns[v], vp.wo[v]) > 0.0
        masks.append(ph_active & (grid.sorted_cell[slot] == cid) & vp.valid[v]
                     & (dist2 <= r * r) & same_side)
        slots.append(slot)
        # an entry past the last examined slot still in the cell spills
        past = torch.clamp(start + MAX_PER_CELL, 0, n_pix - 1)
        overflow += (ph_active & (grid.sorted_cell[past] == cid)
                     & vp.valid[grid.order[past]]).sum()
    # the entries in (cell, slot, photon) order
    ok = torch.stack(masks)
    entry = ok.view(-1).nonzero()[:, 0]
    photon = entry % n_ph
    v = grid.order[torch.stack(slots).view(-1)[entry]]
    ns, ss, ts, wo, wi = vp.ns[v], vp.ss[v], vp.ts[v], vp.wo[v], wi_w[photon]
    wo_l = torch.stack([dot(wo, ss), dot(wo, ts), dot(wo, ns)], -1)
    wi_l = torch.stack([dot(wi, ss), dot(wi, ts), dot(wi, ns)], -1)
    f = B.bsdf_f(_lobes_rows(vp.lobes, v), wo_l, wi_l, None, fams)
    vals = torch.cat([f * ph_beta[photon], torch.ones((v.shape[0], 1), device=dev)], 1)
    sums = _ordered_sum(v, vals, n_pix, chunk=SPLAT_CHUNK)
    return sums[:, :3], sums[:, 3], overflow


def photon_pass(cs, max_depth, n_ph, it, vp: VisiblePoints, grid: Grid, radius):
    """n_ph photons of iteration `it` -> (phi [P,3], m_count [P],
    overflow [] int64) summed over their bounces."""
    data, flags = cs.data, cs.flags
    dev = radius.device
    n_pix = radius.shape[0]
    ftab = data.fourier if flags.has_fourier else None
    hkey = hash3(torch.arange(n_ph, dtype=torch.int64, device=dev), it, PHOTON_SALT)

    def hdim(salt):
        return u32_to_float(hash3(hkey, salt, it))

    def hdim2(salt):
        return torch.stack([hdim(salt), hdim(salt + 1)], -1)

    light_idx, pmf, _ = data.light_distr.sample_discrete(hdim(1))
    le = LT.sample_le(data.lights, light_idx, hdim2(2), hdim2(4), data.world_center,
                      data.world_radius)
    pdf_total = torch.clamp(le.pdf_pos * le.pdf_dir * pmf, min=1e-12)
    ph_beta = le.le * (vm.absdot(le.n_light, normalize(le.d)) / pdf_total)[:, None]
    ph_o, ph_d = le.o, le.d
    ph_active = ~B.black(ph_beta) & (pmf > 0.0)
    phi = torch.zeros((n_pix, 3), device=dev)
    m_count = torch.zeros(n_pix, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for bounce in range(max_depth):
        dn = normalize(ph_d)
        si = intersect(data, flags, ph_o, dn, torch.full((n_ph,), vm.INF, device=dev))
        ph_active = ph_active & si.valid
        lobes = _lobes(cs, si, lambda: hdim(100 + bounce * 16))
        if bounce > 0:
            d_phi, d_m, d_ovf = _deposit(vp, grid, radius, si.p, ph_beta, ph_active, dn,
                                         flags.bsdf_fams)
            phi, m_count, overflow = phi + d_phi, m_count + d_m, overflow + d_ovf
        if bounce == max_depth - 1:
            break
        bs = B.bsdf_sample(lobes, si.world_to_local(si.wo), hdim(101 + bounce * 16),
                           hdim2(102 + bounce * 16), ftab, flags.bsdf_fams)
        wi_world = si.local_to_world(bs.wi)
        ok = ph_active & (bs.pdf > 0.0) & ~B.black(bs.f)
        new_beta = ph_beta * bs.f * (vm.absdot(wi_world, si.ns)
                                     / torch.clamp(bs.pdf, min=1e-12))[:, None]
        # Russian roulette on the photon's weight
        q = torch.clamp(1.0 - vm.max_component(new_beta)
                        / torch.clamp(vm.max_component(ph_beta), min=1e-12), 0.0, 0.95)
        survive = hdim(103 + bounce * 16) >= q
        ph_beta = torch.where((ok & survive)[:, None],
                              new_beta / torch.clamp(1.0 - q, min=1e-6)[:, None], ph_beta)
        ph_active = ok & survive
        ph_o = si.spawn_origin(wi_world)
        ph_d = wi_world
    return phi, m_count, overflow


def _sppm_iteration(cs, max_depth, n_photons_iter, px, py, it, radius, ld_sum, tau, n_photons):
    """One iteration -> (radius, ld_sum, tau, N, overflow [] int64)."""
    vp, ld = camera_pass(cs, max_depth, px, py, it)
    grid = build_grid(cs, vp, radius)
    phi, m_count, overflow = photon_pass(cs, max_depth, n_photons_iter, it, vp, grid, radius)
    has_m = m_count > 0
    n_new = n_photons + GAMMA * m_count
    r_new = torch.where(has_m, radius * torch.sqrt(
        n_new / torch.clamp(n_photons + m_count, min=1e-9)), radius)
    tau_new = torch.where(has_m[:, None], (tau + vp.beta * phi) * (
        r_new * r_new / torch.clamp(radius * radius, min=1e-12))[:, None], tau)
    return r_new, ld_sum + ld, tau_new, torch.where(has_m, n_new, n_photons), overflow


@torch.no_grad()
def render_sppm(cs, options=None):
    """-> (image [H,W,3] linear RGB tensor on the scene's device, counters
    {"grid_overflows": deposits past MAX_PER_CELL}, number of
    iterations). Warns on stdout where the overflow count is nonzero."""
    from pbrt_tpu_torch.render import Options, sample_pixels
    options = options or Options()
    p = cs.integrator_params
    dev = cs.device
    n_iterations = int(p.get("numiterations", p.get("iterations", [64]))[0])
    if options.quick:
        n_iterations = max(4, n_iterations // 8)
    max_depth = int(p.get("maxdepth", [5])[0])
    photons_per_iter = int(p.get("photonsperiteration", [-1])[0])
    init_radius = float(p.get("radius", [1.0])[0])
    if options.sppm_radius > 0:
        init_radius = options.sppm_radius
    px_np, py_np = sample_pixels(cs.film)
    n_pix = px_np.shape[0]
    if photons_per_iter <= 0:
        photons_per_iter = n_pix
    px = torch.as_tensor(px_np, device=dev)
    py = torch.as_tensor(py_np, device=dev)
    radius = torch.full((n_pix,), init_radius, device=dev)
    ld_sum = torch.zeros((n_pix, 3), device=dev)
    tau = torch.zeros((n_pix, 3), device=dev)
    n_photons = torch.zeros(n_pix, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for it in range(n_iterations):
        radius, ld_sum, tau, n_photons, ovf = _sppm_iteration(
            cs, max_depth, photons_per_iter, px, py, it, radius, ld_sum, tau, n_photons)
        overflow += ovf
    overflow = int(overflow)
    if overflow > 0:
        print(f"warning: SPPM grid overflow — {overflow} deposits skipped past "
              f"MAX_PER_CELL={MAX_PER_CELL}; raise it or lower the initial radius")

    # ld averaged over the iterations, the photon term tau / (N_total pi r^2)
    n_total = n_iterations * photons_per_iter
    r = torch.clamp(radius, min=1e-9)
    L = ld_sum / torch.full((), float(n_iterations), device=dev) \
        + tau / (float(n_total * np.pi) * (r * r))[:, None]
    x0, _, y0, _ = cs.film.pixel_bounds
    W, H = cs.film.cropped_resolution
    flat = (torch.clamp(py - y0, 0, H - 1) * W + torch.clamp(px - x0, 0, W - 1)).to(torch.int64)
    # a pixel takes its last lane's estimate, as the reference's scatter writes
    last = torch.full((H * W,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, flat, torch.arange(n_pix, device=dev), "amax")
    img = torch.where((last >= 0)[:, None], L[torch.clamp(last, min=0)], 0.0).view(H, W, 3)
    return torch.clamp(img * cs.film.scale, min=0.0), {"grid_overflows": overflow}, n_iterations
