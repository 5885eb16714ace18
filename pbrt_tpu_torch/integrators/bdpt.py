"""Bidirectional path tracing over the whole wavefront (port of
pbrt_tpu/integrators/bdpt.py).

Each lane walks a camera subpath and a light subpath into vertex arrays
[N, D] (VertexSoA), by the path integrator's bounce pipeline; every (s, t)
connection strategy is then evaluated for all lanes at once, masked by
each lane's subpath lengths, and weighted by the pdf-ratio MIS sums over
the stored forward and reverse area densities (the reference's remap0
convention). Strategies with t >= 2 deposit into the lane's pixel
sample; t = 1 (a light vertex seen by the camera) becomes a film splat.

As in the reference: t = 1 is evaluated for the perspective camera only;
the light subpath picks its light by the power distribution whatever the
scene's light strategy; an escaped camera ray is an infinite-light
endpoint (densities at infinity stay in solid angle, and the positional
density of an infinite light is 1 / (pi r^2)); a medium-scattered vertex
stores zero frames and takes the Henyey-Greenstein phase function as its
f and pdf. Scenes with media draw their medium decisions from the hash4
stream keyed by pixel, sample and 0xBD10 + 2k / 0xBD11 + 2k, and their
connections walk intersect_tr, crossing null interfaces with
transmittance; scenes without media trace each connection with one
any-hit launch. Every vertex index is static, so the [N, D] arrays are
sliced, never gathered.

The hooks that MLT drives are kept with the reference's meaning:
sampler_fn (a dimension -> [N] override of the sampler), p_film_override
(the film positions to trace), st_select (one (s, t) strategy a lane,
unweighted by the strategy count) and st_filter (one strategy for all
lanes, the debug films of render_bdpt_debug).
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch

from pbrt_tpu_torch import lights as LT
from pbrt_tpu_torch import media as MD
from pbrt_tpu_torch.cameras import generate_rays
from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.math import dot, normalize
from pbrt_tpu_torch.film import FilmState, add_samples, add_splats, develop
from pbrt_tpu_torch.filters import build_table
from pbrt_tpu_torch.integrators.common import camera_dims, camera_rays, infinite_pdf_for_dir
from pbrt_tpu_torch.integrators.path import COUNTERS
from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.materials import compute_lobes
from pbrt_tpu_torch.samplers import sample_2d, sample_dim
from pbrt_tpu_torch.samplers.hashing import hash3, hash4, u32
from pbrt_tpu_torch.scene.intersect import intersect, intersect_p

# sampler dimensions: the camera's 0-4, then 8 a camera vertex from CAM_BASE,
# then the light subpath's from CAM_BASE + 8 D (see _bdpt_sample)
CAM_BASE = 5
STRATEGIES = ("s0", "s1", "gen", "t1")


@dataclasses.dataclass
class VertexSoA:
    """[N, D] vertex arrays; vtype: 0 none, 3 a stored (surface or medium)
    vertex."""
    vtype: torch.Tensor     # [N,D] int32
    p: torch.Tensor         # [N,D,3]
    ng: torch.Tensor        # [N,D,3] (zero at a medium vertex)
    ns: torch.Tensor
    ss: torch.Tensor        # the shading frame, for evaluating the BSDF
    ts: torch.Tensor
    uv: torch.Tensor        # [N,D,2]
    beta: torch.Tensor      # [N,D,3]
    pdf_fwd: torch.Tensor   # [N,D] area density from the previous vertex
    pdf_rev: torch.Tensor   # [N,D] solid-angle density back toward it
    delta: torch.Tensor     # [N,D] bool: reached by a specular bounce
    material: torch.Tensor  # [N,D] int32
    light: torch.Tensor     # [N,D] int32 area light at the vertex (-1)
    mat_umix: torch.Tensor  # [N,D] the mix material's draw
    is_med: torch.Tensor    # [N,D] bool: scattered in a medium
    medium: torch.Tensor    # [N,D] int32: the medium around the vertex (-1)


@dataclasses.dataclass
class Escape:
    """The camera walk's escape: a ray that leaves the scene ends the walk
    at an infinite-light endpoint."""
    valid: torch.Tensor    # [N] bool
    beta: torch.Tensor     # [N,3] the throughput carried out
    dir: torch.Tensor      # [N,3]
    pdf_sa: torch.Tensor   # [N] the solid-angle density of the escaping direction
    k: torch.Tensor        # [N] the vertex count at the escape
    spec: torch.Tensor     # [N] bool: the escaping bounce was specular


def _samplers(cs, px, py, sidx, sampler_fn):
    """(dim -> [N], dim -> [N,2]) from the sampler or from sampler_fn."""
    if sampler_fn is None:
        return (lambda dim: sample_dim(cs.sampler, px, py, sidx, dim),
                lambda dim: sample_2d(cs.sampler, px, py, sidx, dim))
    return sampler_fn, lambda dim: torch.stack([sampler_fn(dim), sampler_fn(dim + 1)], -1)


def _lobes_at(cs, v: VertexSoA, k):
    """The lobes at vertex k, recomputed from its material and mix draw."""
    flags = cs.flags
    return compute_lobes(cs.data.mats, cs.data.tex, v.material[:, k], v.uv[:, k], v.p[:, k],
                         None, flags.has_tex_slot, flags.tex_kinds, v.mat_umix[:, k],
                         flags.bsdf_fams, flags.mat_kinds)


def _f_at(cs, v: VertexSoA, k, wo_w, wi_w, lobes):
    """(f [N,3], pdf forward, pdf reverse) at vertex k between world
    directions wo_w and wi_w; a medium vertex takes the HG phase function
    for all three (HG is symmetric)."""
    data, flags = cs.data, cs.flags
    ftab = data.fourier if flags.has_fourier else None
    local = lambda w: torch.stack([dot(w, v.ss[:, k]), dot(w, v.ts[:, k]),
                                   dot(w, v.ns[:, k])], -1)
    wo_l, wi_l = local(wo_w), local(wi_w)
    f = B.bsdf_f(lobes, wo_l, wi_l, ftab, flags.bsdf_fams)
    pf = B.bsdf_pdf(lobes, wo_l, wi_l, ftab, flags.bsdf_fams)
    pr = B.bsdf_pdf(lobes, wi_l, wo_l, ftab, flags.bsdf_fams)
    if flags.n_media > 0:
        is_m = v.is_med[:, k]
        g = data.media.params[torch.clamp(v.medium[:, k], min=0).to(torch.int64)][:, 0]
        ph = MD.hg_p(dot(wo_w, wi_w), g)
        f = torch.where(is_m[:, None], ph[:, None], f)
        pf = torch.where(is_m, ph, pf)
        pr = torch.where(is_m, ph, pr)
    return f, pf, pr


def _cos_or_one(nvec, w):
    """|cos| against a normal; 1 for the zero normal of a medium vertex."""
    return torch.where(vm.length_squared(nvec) > 0.0, vm.absdot(nvec, w), 1.0)


def _convert_density(pdf_sa, from_p, to_p, to_ng):
    """Solid-angle density at from_p -> area density at to_p (cosine-free
    at a medium vertex)."""
    w = to_p - from_p
    d2 = torch.clamp(vm.length_squared(w), min=1e-12)
    wn = w * vm.rsqrt(d2)[..., None]
    return pdf_sa * _cos_or_one(to_ng, wn) / d2


def _walk(cs, o, d, beta0, pdf_dir0, depth, dim1, dim2, pix, dim_base, light_mode,
          time=None, med0=None):
    """A random walk of up to depth vertices from rays (o, d) -> (VertexSoA
    [N, depth], Escape). light_mode: importance transport (the shading
    normal correction); med0: the walk's first medium (default the
    camera's); pix: (px, py, sample) as u32 words, the media's hash keys."""
    data, flags = cs.data, cs.flags
    n = o.shape[0]
    dev = o.device
    media = flags.n_media > 0
    ftab = data.fourier if flags.has_fourier else None
    fams = flags.bsdf_fams
    if med0 is None:
        cur_med = torch.full((n,), data.camera_medium, dtype=torch.int32, device=dev)
    else:
        cur_med = med0.to(torch.int32)
    beta = beta0
    active = ~B.black(beta0)
    pdf_fwd_sa = pdf_dir0
    prev_p = o
    prev_delta = torch.zeros(n, dtype=torch.bool, device=dev)
    esc = Escape(torch.zeros(n, dtype=torch.bool, device=dev), torch.zeros((n, 3), device=dev),
                 torch.zeros((n, 3), device=dev), torch.zeros(n, device=dev),
                 torch.zeros(n, dtype=torch.int32, device=dev),
                 torch.zeros(n, dtype=torch.bool, device=dev))
    cols = {f.name: [] for f in dataclasses.fields(VertexSoA)}
    zf = torch.zeros((n, 3), device=dev)

    for k in range(depth):
        base = dim_base + 8 * k
        dn = normalize(d)
        si = intersect(data, flags, o, dn, torch.full((n,), vm.INF, device=dev), time=time)
        if media:
            ka = hash4(*pix, 0xBD10 + 2 * k)
            kb = hash4(*pix, 0xBD11 + 2 * k)
            t_seg = torch.where(si.valid, si.t, vm.INF)
            ms = MD.sample_medium(data.media, cur_med, o, dn, t_seg, ka, kb, dim2(base + 1),
                                  flags.any_grid_media)
            in_med = active & ms.sampled_medium
            beta = torch.where(active[:, None], beta * ms.weight, beta)
        else:
            in_med = torch.zeros(n, dtype=torch.bool, device=dev)
        hit = active & si.valid & ~in_med
        esc_new = active & ~si.valid & ~in_med & ~esc.valid
        esc = Escape(esc.valid | esc_new, torch.where(esc_new[:, None], beta, esc.beta),
                     torch.where(esc_new[:, None], dn, esc.dir),
                     torch.where(esc_new, pdf_fwd_sa, esc.pdf_sa),
                     torch.where(esc_new, k, esc.k), torch.where(esc_new, prev_delta, esc.spec))
        u_mix = dim1(base + 0)
        stored = hit | in_med
        if media:
            m3 = in_med[:, None]
            vp = torch.where(m3, ms.p, si.p)
            vng, vns, vss, vts = (torch.where(m3, zf, x) for x in (si.ng, si.ns, si.ss, si.ts))
        else:
            vp, vng, vns, vss, vts = si.p, si.ng, si.ns, si.ss, si.ts
        pdf_fwd_area = _convert_density(pdf_fwd_sa, prev_p, vp, vng)
        for name, val in (
                ("vtype", torch.where(stored, 3, 0).to(torch.int32)), ("p", vp), ("ng", vng),
                ("ns", vns), ("ss", vss), ("ts", vts), ("uv", si.uv),
                ("beta", torch.where(stored[:, None], beta, 0.0)),
                ("pdf_fwd", torch.where(stored, pdf_fwd_area, 0.0)),
                ("delta", prev_delta & stored),
                ("material", torch.where(hit, si.material, -1).to(torch.int32)),
                ("light", torch.where(hit, si.area_light, -1).to(torch.int32)),
                ("mat_umix", u_mix), ("is_med", in_med),
                ("medium", torch.where(stored, cur_med, -1).to(torch.int32))):
            cols[name].append(val)
        active = stored
        if k == depth - 1:
            cols["pdf_rev"].append(torch.zeros(n, device=dev))
            break

        lobes = compute_lobes(data.mats, data.tex, si.material, si.uv, si.p, None,
                              flags.has_tex_slot, flags.tex_kinds, u_mix, fams, flags.mat_kinds)
        u_lobe = dim1(base + 4)
        u_dir = dim2(base + 5)
        wo_local = si.world_to_local(si.wo)
        bs = B.bsdf_sample(lobes, wo_local, u_lobe, u_dir, ftab, fams)
        wi_world = si.local_to_world(bs.wi)
        cos_w = vm.absdot(wi_world, si.ns)
        ok_surf = (bs.pdf > 0.0) & ~B.black(bs.f)
        if light_mode:
            # the shading-normal correction of importance transport
            num = vm.absdot(si.wo, si.ns) * vm.absdot(wi_world, si.ng)
            den = torch.clamp(vm.absdot(si.wo, si.ng) * vm.absdot(wi_world, si.ns), min=1e-9)
            cos_w = cos_w * (num / den)
        bmul_surf = bs.f * (cos_w / torch.clamp(bs.pdf, min=1e-12))[:, None]
        pdf_rev_surf = B.bsdf_pdf(lobes, si.world_to_local(wi_world), wo_local, ftab, fams)
        spec_fwd = torch.where(bs.is_specular, 0.0, bs.pdf)
        if media:
            # a medium vertex scatters by HG: f / pdf = 1, reverse = forward
            g_cur = data.media.params[torch.clamp(cur_med, min=0).to(torch.int64)][:, 0]
            wi_med, p_med = MD.hg_sample(-dn, g_cur, u_dir)
            wi_world = torch.where(in_med[:, None], wi_med, wi_world)
            ok = active & torch.where(in_med, p_med > 0.0, ok_surf)
            beta = torch.where((ok & ~in_med)[:, None], beta * bmul_surf, beta)
            pdf_rev_sa = torch.where(in_med, p_med, pdf_rev_surf)
            prev_delta = torch.where(in_med, False, bs.is_specular)
            pdf_fwd_sa = torch.where(in_med, p_med, spec_fwd)
            # crossing a transmissive boundary swaps the medium
            if bs.is_transmission is not None:
                pm = data.prim_medium[torch.clamp(si.prim, min=0).to(torch.int64)]
                crossed = hit & bs.is_transmission & ok
                cur_med = torch.where(crossed, torch.where(dot(wi_world, si.ng) < 0.0,
                                                           pm[:, 0], pm[:, 1]), cur_med)
            o = torch.where(in_med[:, None], vp, si.spawn_origin(wi_world))
            prev_p = vp
        else:
            ok = active & ok_surf
            beta = torch.where(ok[:, None], beta * bmul_surf, beta)
            pdf_rev_sa = pdf_rev_surf
            prev_delta = bs.is_specular
            pdf_fwd_sa = spec_fwd
            o = si.spawn_origin(wi_world)
            prev_p = si.p
        cols["pdf_rev"].append(torch.where(ok, pdf_rev_sa, 0.0))
        active = ok
        d = wi_world
    if depth == 0:
        shapes = {"p": (3,), "ng": (3,), "ns": (3,), "ss": (3,), "ts": (3,), "uv": (2,),
                  "beta": (3,)}
        dts = {"vtype": torch.int32, "material": torch.int32, "light": torch.int32,
               "medium": torch.int32, "delta": torch.bool, "is_med": torch.bool}
        return VertexSoA(**{k: torch.zeros((n, 0, *shapes.get(k, ())),
                                           dtype=dts.get(k, torch.float32), device=dev)
                            for k in cols}), esc
    return VertexSoA(**{k: torch.stack(v, 1) for k, v in cols.items()}), esc


def _length(v: VertexSoA):
    return (v.vtype > 0).sum(1)


def _wo_of(v: VertexSoA, origin, k):
    """Direction from vertex k toward the previous vertex of its walk
    (origin before the first)."""
    prev = origin if k == 0 else v.p[:, k - 1]
    return normalize(prev - v.p[:, k])


def _occluded(cs, p_from, ng_from, p_to, w, medium, time, pix_s, keys):
    """-> (occluded [N] bool, transmittance [N,3] or None where the scene
    has no media) of a connection segment: intersect_tr across null
    interfaces in scenes with media, one any-hit launch elsewhere."""
    o = vm.offset_ray_origin(p_from, torch.full_like(p_from, 1e-4), ng_from, w)
    to = p_to - o
    dist = vm.length(to)
    sd = to / torch.clamp(dist, min=1e-12)[:, None]
    if cs.flags.n_media > 0:
        from pbrt_tpu_torch.integrators.volpath import intersect_tr
        tr, occ = intersect_tr(cs.data, cs.flags, medium, o, sd, dist, keys, pix_s)
        return occ, tr
    return intersect_p(cs.data, cs.flags, o, sd, dist * (1 - 1e-3), time=time), None


def _cam_dir(cs, dev):
    """The perspective camera's viewing direction (its +z) in world space."""
    m = np.asarray(cs.camera.cam_to_world, np.float32)
    return normalize(torch.as_tensor(np.ascontiguousarray(m[:3, 2]), device=dev))


def _camera_importance(cs, cam_o, p):
    """The perspective camera's importance toward points p [N,3], their
    raster positions [N,2] and whether they land on the film."""
    spec = cs.camera
    dev = p.device
    w2c = torch.as_tensor(spec.world_to_camera, device=dev)
    pc = p @ w2c[:3, :3].T + w2c[:3, 3]
    behind = pc[:, 2] <= 1e-6
    # the full homogeneous camera -> raster (the perspective divide in its w row)
    c2r = torch.as_tensor(spec.camera_to_raster, device=dev)
    num = pc @ c2r[:3, :3].T + c2r[:3, 3]
    wdiv = pc @ c2r[3, :3] + c2r[3, 3]
    rast = num / torch.where(torch.abs(wdiv[:, None]) < 1e-9, 1e-9, wdiv[:, None])
    resx, resy = spec.resolution
    on = ~behind & (rast[:, 0] >= 0) & (rast[:, 0] < resx) & (rast[:, 1] >= 0) \
        & (rast[:, 1] < resy)
    cos_t = torch.clamp(dot(normalize(p - cam_o), _cam_dir(cs, dev)), min=1e-6)
    c2 = cos_t * cos_t
    imp = 1.0 / (spec.screen_area * (c2 * c2))
    return torch.where(on, imp, 0.0), rast[:, :2], on


def camera_pdf_we_dir(cs, cam_o, p):
    """Solid-angle density of the perspective camera sampling a ray toward
    points p [N,3]."""
    cos_t = torch.clamp(dot(normalize(p - cam_o), _cam_dir(cs, p.device)), min=1e-6)
    # cos^3 as the reference's integer power multiplies: x (x x)
    return 1.0 / (cs.camera.screen_area * (cos_t * (cos_t * cos_t)))


# ---------------------------------------------------------------------------
# MIS weights: 1 / (1 + the camera side's and the light side's sums of
# products of ri = p_reverse / p_forward in area measure), each junction's
# reverse densities recomputed for the connection's directions.
# ---------------------------------------------------------------------------

def _remap0(x):
    return torch.where(x > 0.0, x, 1.0)


def _chain(v: VertexSoA, top, r, total, prev_sa, below_first):
    """Extend a ratio chain from vertex top + 1 down to vertex 0: each step
    converts the previous solid-angle density to an area one at the next
    vertex. below_first: the delta test below vertex 0 (True or a mask)."""
    for j in range(top, -1, -1):
        p_back = _convert_density(prev_sa, v.p[:, j + 1], v.p[:, j], v.ng[:, j])
        r = r * _remap0(p_back) / _remap0(v.pdf_fwd[:, j])
        below = ~v.delta[:, j - 1] if j > 0 else below_first
        total = total + torch.where(~v.delta[:, j] & below, r, 0.0)
        prev_sa = v.pdf_rev[:, j]
    return r, total, prev_sa


def _cam_side_sum(cam_v, kt, p_gen_kt_area, pdf_rev_at_kt_sa):
    """The ratios of the strategies that move the junction down the
    camera subpath."""
    r = _remap0(p_gen_kt_area) / _remap0(cam_v.pdf_fwd[:, kt])
    ok = ~cam_v.delta[:, kt]
    if kt > 0:
        ok = ok & ~cam_v.delta[:, kt - 1]
    total = torch.where(ok, r, 0.0)
    return _chain(cam_v, kt - 1, r, total, pdf_rev_at_kt_sa, True)[1]


def _emitter_info(cs, light_idx):
    """-> (positional density x selection pmf, hittable: a camera path can
    hit it, connectible: a light sample can reach it (not distant))."""
    lights = cs.data.lights
    li = torch.clamp(light_idx, min=0).to(torch.int64)
    kind = lights.kind[li]
    pmf = cs.data.light_distr.discrete_pdf(li)
    area = torch.clamp(lights.params[li, 4], min=1e-9)
    pdf_pos = torch.where(kind == LT.L_AREA, pmf / area, pmf)
    return pdf_pos, (kind == LT.L_AREA) | (kind == LT.L_INFINITE), kind != LT.L_DISTANT


def _emission_dir_pdf_sa(cs, light_idx, n_light_v, w):
    """Solid-angle density of the emitter sampling emission direction w:
    the cosine hemisphere on an area light, the cone on spot and
    projection lights, the map's density of -w on an infinite light, 0 on
    a distant light and the uniform sphere otherwise."""
    lights = cs.data.lights
    li = torch.clamp(light_idx, min=0).to(torch.int64)
    kind = lights.kind[li]
    cos_l = vm.absdot(n_light_v, w)
    pdf_area_l = cos_l * (1.0 / np.pi)
    pdf_point = torch.full_like(cos_l, 1.0 / (4.0 * np.pi))
    pdf_cone = 1.0 / (2.0 * np.pi * torch.clamp(1.0 - lights.params[li, 6], min=1e-6))
    one = torch.ones_like(cos_l)
    pdf_inf = LT.pdf_li(lights, li, one, one, -w)
    return torch.where(kind == LT.L_AREA, pdf_area_l,
                       torch.where((kind == LT.L_SPOT) | (kind == LT.L_PROJECTION), pdf_cone,
                                   torch.where(kind == LT.L_INFINITE, pdf_inf,
                                               torch.where(kind == LT.L_DISTANT, 0.0,
                                                           pdf_point))))


def _light_side_sum(cs, light_v, ks, light_idx, le, p_gen_ks_area, pdf_rev_at_ks_sa):
    """The ratios of the strategies that move the junction down the light
    subpath, ending at the emitter (the camera path hitting it)."""
    pdf_pos, hittable, connectible = _emitter_info(cs, light_idx)
    r = _remap0(p_gen_ks_area) / _remap0(light_v.pdf_fwd[:, ks])
    below = ~light_v.delta[:, ks - 1] if ks > 0 else connectible
    total = torch.where(~light_v.delta[:, ks] & below, r, 0.0)
    r, total, prev_sa = _chain(light_v, ks - 1, r, total, pdf_rev_at_ks_sa, connectible)
    p_back_em = _convert_density(prev_sa, light_v.p[:, 0], le.o, le.n_light)
    r = r * _remap0(p_back_em) / _remap0(pdf_pos)
    return total + torch.where(hittable, r, 0.0)


def _mis_weight_s0(cs, cam_v, k):
    """s = 0: the camera path hits an emitter at vertex k."""
    n = cam_v.vtype.shape[0]
    if k == 0:
        return torch.ones(n, device=cam_v.p.device)
    light = cam_v.light[:, k]
    pdf_pos = _emitter_info(cs, light)[0]
    r = _remap0(pdf_pos) / _remap0(cam_v.pdf_fwd[:, k])
    total = torch.where(~cam_v.delta[:, k - 1], r, 0.0)
    wo = normalize(cam_v.p[:, k - 1] - cam_v.p[:, k])
    em_sa = _emission_dir_pdf_sa(cs, light, cam_v.ng[:, k], wo)
    total = _chain(cam_v, k - 1, r, total, em_sa, True)[1]
    return 1.0 / (1.0 + total)


def _infinite_pos_pdf_area(cs):
    """Area density of an infinite light generating a surface point,
    1 / (pi r^2), in float32 as the reference computes it."""
    r = np.float32(cs.data.world_radius)
    return float(np.float32(1.0) / (np.float32(np.pi) * r * r))


def _mis_weight_s0_inf(cs, cam_v, k, esc: Escape):
    """s = 0 for a camera path that escaped to the infinite lights after
    k vertices."""
    n = cam_v.vtype.shape[0]
    if k == 0:
        return torch.ones(n, device=cam_v.p.device)
    nee_sa = infinite_pdf_for_dir(cs, esc.dir, cam_v.p[:, k - 1])
    r = _remap0(nee_sa) / _remap0(esc.pdf_sa)
    total = torch.where(~cam_v.delta[:, k - 1] & ~esc.spec, r, 0.0)
    # the light regenerates the last vertex with its positional density
    r = r * _remap0(torch.full((n,), _infinite_pos_pdf_area(cs), device=r.device)) \
        / _remap0(cam_v.pdf_fwd[:, k - 1])
    below = ~cam_v.delta[:, k - 2] if k - 1 > 0 else True
    total = total + torch.where(~cam_v.delta[:, k - 1] & below, r, 0.0)
    total = _chain(cam_v, k - 2, r, total, cam_v.pdf_rev[:, k - 1], True)[1]
    return 1.0 / (1.0 + total)


def _mis_weight_s1(cs, cam_v, kt, ls, light_idx, pdf_c_fwd, pdf_c_rev):
    """s = 1: a light sample connected at camera vertex kt."""
    pdf_pos, hittable, _ = _emitter_info(cs, light_idx)
    li = torch.clamp(light_idx, min=0).to(torch.int64)
    pmf = cs.data.light_distr.discrete_pdf(li)
    sum_light = torch.where(hittable, _remap0(pdf_c_fwd) / _remap0(ls.pdf * pmf), 0.0)
    em_sa = _emission_dir_pdf_sa(cs, light_idx, ls.n_light, -ls.wi)
    p_gen_kt = _convert_density(em_sa, ls.p_light, cam_v.p[:, kt], cam_v.ng[:, kt])
    p_gen_kt = torch.where(cs.data.lights.kind[li] == LT.L_INFINITE,
                           _infinite_pos_pdf_area(cs), p_gen_kt)
    sum_cam = _cam_side_sum(cam_v, kt, p_gen_kt, pdf_c_rev)
    return 1.0 / (1.0 + sum_cam + sum_light)


def _mis_weight_t1(cs, light_v, ks, light_idx, le, pdf_we_dir_sa, pl_rev_sa, cam_o):
    """t = 1: light vertex ks seen by the camera."""
    p_gen_ks = _convert_density(pdf_we_dir_sa, cam_o, light_v.p[:, ks], light_v.ng[:, ks])
    return 1.0 / (1.0 + _light_side_sum(cs, light_v, ks, light_idx, le, p_gen_ks, pl_rev_sa))


def _mis_weight_general(cs, cam_v, light_v, kt, ks, light_idx, le, pc_f, pc_r, pl_f, pl_r):
    """s >= 2, t >= 2: camera vertex kt connected to light vertex ks."""
    p_gen_kt = _convert_density(pl_f, light_v.p[:, ks], cam_v.p[:, kt], cam_v.ng[:, kt])
    sum_cam = _cam_side_sum(cam_v, kt, p_gen_kt, pc_r)
    p_gen_ks = _convert_density(pc_f, cam_v.p[:, kt], light_v.p[:, ks], light_v.ng[:, ks])
    sum_light = _light_side_sum(cs, light_v, ks, light_idx, le, p_gen_ks, pl_r)
    return 1.0 / (1.0 + sum_cam + sum_light)


def _bdpt_sample(cs, px, py, sidx, D, strategies=STRATEGIES, st_filter=None, sampler_fn=None,
                 p_film_override=None, st_select=None, with_stats=False):
    """One BDPT sample for each lane, with subpaths of up to D vertices ->
    (L [N,3], p_film [N,2], splat_p [M,2], splat_v [M,3]) and, with_stats,
    the counters; the splats are one row a lane for each t = 1 strategy.

    st_filter: one static (s, t) pair whose contribution alone is kept.
    sampler_fn / p_film_override: a dimension -> [N] function that stands
    in for the sampler, and the film positions to trace (MLT's primary
    sample space). st_select: ([N], [N]) the (s, t) each lane keeps, not
    weighted by the strategy count; t = 1 lanes then add into L and their
    raster positions replace p_film, and no splats are returned (None)."""
    data, flags = cs.data, cs.flags
    n = px.shape[0]
    dev = px.device
    keep = lambda s, t: st_filter is None or (s, t) == st_filter

    def st_mask(s, t):
        if st_select is None:
            return True
        return (st_select[0] == s) & (st_select[1] == t)

    dim1, dim2 = _samplers(cs, px, py, sidx, sampler_fn)
    # ---- camera subpath ----
    if p_film_override is None:
        rays, _, p_film = camera_rays(cs, px, py, sidx)
    else:
        p_film = p_film_override
        rays, _ = generate_rays(cs.camera, p_film, False, *camera_dims(cs.camera, dim1, dim2))
    cam_o = rays.o
    # animated instances are traced at the camera sample's time
    time = dim1(4) if flags.n_instances > 0 else None
    cam_d = normalize(rays.d)
    pix = (u32(px), u32(py), u32(sidx))
    cam_v, cam_esc = _walk(cs, cam_o, cam_d, torch.ones((n, 3), device=dev),
                           camera_pdf_we_dir(cs, cam_o, cam_o + cam_d), D, dim1, dim2, pix,
                           CAM_BASE, False, time)

    # ---- light subpath: the light picked by power, whatever the strategy ----
    lbase = CAM_BASE + 8 * D
    light_idx, pmf, _ = data.light_distr.sample_discrete(dim1(lbase + 0))
    le = LT.sample_le(data.lights, light_idx, dim2(lbase + 1), dim2(lbase + 3),
                      data.world_center, data.world_radius)
    pdf0 = torch.clamp(le.pdf_pos * pmf, min=1e-12)
    beta_l0 = le.le * (vm.absdot(le.n_light, normalize(le.d))
                       / torch.clamp(pdf0 * le.pdf_dir, min=1e-12))[:, None]
    light_med = None
    if data.lights.medium is not None:
        light_med = data.lights.medium[torch.clamp(light_idx, min=0).to(torch.int64)]
    light_v, _ = _walk(cs, le.o, normalize(le.d), beta_l0, le.pdf_dir, D - 1, dim1, dim2, pix,
                       lbase + 5, True, time, light_med)

    n_cam = _length(cam_v)
    n_light = _length(light_v)
    pix_s = hash3(*pix) if flags.n_media > 0 else None
    cnt = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in COUNTERS}
    cnt["camera_rays"] += n
    cnt["bounce_rays"] += (n_cam + n_light).sum()
    cnt["valid_hits"] += n_cam.sum()

    L = torch.zeros((n, 3), device=dev)
    splat_parts = []
    sel_raster = p_film
    lobes = {}

    def lobes_of(side, v, k):
        if (side, k) not in lobes:
            lobes[side, k] = _lobes_at(cs, v, k)
        return lobes[side, k]

    # Camera vertex kt = t - 2 (t counts the camera itself), light vertex
    # ks = s - 2 (s = 1 is the sampled light point itself).

    # ---- s = 0, an escaped camera path meets the infinite lights ----
    if flags.has_infinite and "s0" in strategies:
        le_esc = LT.le_escaped(data.lights, flags.infinite_light_ids, cam_esc.dir)
        for k in range(D):
            if not keep(0, k + 2):
                continue
            ok = cam_esc.valid & (cam_esc.k == k) & st_mask(0, k + 2)
            w = _mis_weight_s0_inf(cs, cam_v, k, cam_esc)
            L = L + torch.where(ok[:, None], cam_esc.beta * le_esc * w[:, None], 0.0)

    # ---- s = 0, the camera path hits an area light ----
    if flags.has_area_lights and "s0" in strategies:
        for k in range(D):
            if not keep(0, k + 2):
                continue
            ok = (cam_v.vtype[:, k] > 0) & (cam_v.light[:, k] >= 0) & (n_cam >= k + 1) \
                & st_mask(0, k + 2)
            wo = _wo_of(cam_v, cam_o, k)
            le_v = LT.le_area(data.lights, cam_v.light[:, k], cam_v.ng[:, k], wo)
            w = _mis_weight_s0(cs, cam_v, k)
            L = L + torch.where(ok[:, None], cam_v.beta[:, k] * le_v * w[:, None], 0.0)

    # ---- s = 1 (a light sample) and s >= 2 (a light vertex) at each t >= 2 ----
    for t in range(2, D + 2):
        kt = t - 2
        cam_ok = (cam_v.vtype[:, kt] > 0) & ~cam_v.delta[:, kt] & (n_cam >= kt + 1)
        cnt["shadow_rays"] += cam_ok.sum()
        wo_c = _wo_of(cam_v, cam_o, kt)
        if "s1" in strategies and keep(1, t):
            sbase = CAM_BASE + 8 * D + 5 + 8 * (D - 1) + 4 * t
            u_l = dim2(sbase)
            li1, pmf1, _ = data.light_distr.sample_discrete(dim1(sbase + 2))
            ls = LT.sample_li(data.lights, li1, cam_v.p[:, kt], u_l, data.world_radius,
                              with_normal=True)
            f_c, pdf_c_fwd, pdf_c_rev = _f_at(cs, cam_v, kt, wo_c, ls.wi,
                                              lobes_of("c", cam_v, kt))
            g_cos = _cos_or_one(cam_v.ns[:, kt], ls.wi)
            occ, tr1 = _occluded(cs, cam_v.p[:, kt], cam_v.ng[:, kt], ls.p_light, ls.wi,
                                 cam_v.medium[:, kt], time, pix_s, 0x7000 + 16 * t)
            contrib1 = cam_v.beta[:, kt] * f_c * ls.li
            if tr1 is not None:
                contrib1 = contrib1 * tr1
            contrib1 = contrib1 * (g_cos / torch.clamp(ls.pdf * pmf1, min=1e-12))[:, None]
            ok1 = cam_ok & (ls.pdf > 0.0) & ~B.black(contrib1) & ~occ & st_mask(1, t)
            w1 = _mis_weight_s1(cs, cam_v, kt, ls, li1, pdf_c_fwd, pdf_c_rev)
            L = L + torch.where(ok1[:, None], contrib1 * w1[:, None], 0.0)

        for s in (range(2, D + 1) if "gen" in strategies else ()):
            ks = s - 2
            if ks >= D - 1 or s + t > D + 2 or not keep(s, t):
                continue
            l_ok = (light_v.vtype[:, ks] > 0) & ~light_v.delta[:, ks] & (n_light >= ks + 1)
            d_c2l = light_v.p[:, ks] - cam_v.p[:, kt]
            dist2 = torch.clamp(vm.length_squared(d_c2l), min=1e-12)
            wi = d_c2l * vm.rsqrt(dist2)[:, None]
            f_cam, pc_f, pc_r = _f_at(cs, cam_v, kt, wo_c, wi, lobes_of("c", cam_v, kt))
            f_li, pl_f, pl_r = _f_at(cs, light_v, ks, _wo_of(light_v, le.o, ks), -wi,
                                     lobes_of("l", light_v, ks))
            G = _cos_or_one(cam_v.ns[:, kt], wi) * _cos_or_one(light_v.ns[:, ks], wi) / dist2
            occ2, tr2 = _occluded(cs, cam_v.p[:, kt], cam_v.ng[:, kt], light_v.p[:, ks], wi,
                                  cam_v.medium[:, kt], time, pix_s, 0x7800 + 64 * t + 8 * s)
            contrib = cam_v.beta[:, kt] * f_cam * f_li * light_v.beta[:, ks]
            if tr2 is not None:
                contrib = contrib * tr2
            contrib = contrib * G[:, None]
            ok2 = cam_ok & l_ok & ~B.black(contrib) & ~occ2 & st_mask(s, t)
            w2 = _mis_weight_general(cs, cam_v, light_v, kt, ks, light_idx, le, pc_f, pc_r,
                                     pl_f, pl_r)
            L = L + torch.where(ok2[:, None], contrib * w2[:, None], 0.0)

    # ---- t = 1: a light vertex seen by the camera (splats) ----
    if cs.camera.kind == "perspective" and "t1" in strategies:
        cam_dirv = _cam_dir(cs, dev)
        for s in range(2, D + 1):
            ks = s - 2
            if ks >= D - 1 or not keep(s, 1):
                continue
            ok = (light_v.vtype[:, ks] > 0) & ~light_v.delta[:, ks] & (n_light >= ks + 1)
            p_v = light_v.p[:, ks]
            imp, p_raster, on_film = _camera_importance(cs, cam_o, p_v)
            wi = normalize(cam_o - p_v)
            f_l, _, pl_r1 = _f_at(cs, light_v, ks, _wo_of(light_v, le.o, ks), wi,
                                  lobes_of("l", light_v, ks))
            dist2 = torch.clamp(vm.length_squared(cam_o - p_v), min=1e-12)
            # the camera's sample_wi pdf is dist^2 / cos: beta_cam = We cos / dist^2
            cos_cam = torch.clamp(dot(-wi, cam_dirv), min=1e-6)
            beta_cam = imp * cos_cam / dist2
            G_l = _cos_or_one(light_v.ns[:, ks], wi)
            occ3, tr3 = _occluded(cs, p_v, light_v.ng[:, ks], cam_o, wi, light_v.medium[:, ks],
                                  time, pix_s, 0xA000 + 8 * s)
            contrib = light_v.beta[:, ks] * f_l
            if tr3 is not None:
                contrib = contrib * tr3
            contrib = contrib * (beta_cam * G_l)[:, None]
            okc = ok & on_film & ~B.black(contrib) & ~occ3 & st_mask(s, 1)
            wmis = _mis_weight_t1(cs, light_v, ks, light_idx, le,
                                  camera_pdf_we_dir(cs, cam_o, p_v), pl_r1, cam_o)
            if st_select is not None:
                L = L + torch.where(okc[:, None], contrib * wmis[:, None], 0.0)
                sel_raster = torch.where(okc[:, None], p_raster, sel_raster)
            else:
                splat_parts.append((torch.where(okc[:, None], p_raster, 0.0),
                                    torch.where(okc[:, None], contrib * wmis[:, None], 0.0)))

    if st_select is not None:
        return L, sel_raster, None, None
    if splat_parts:
        splat_p = torch.cat([sp for sp, _ in splat_parts])
        splat_v = torch.cat([sv for _, sv in splat_parts])
    else:
        splat_p = torch.zeros((n, 2), device=dev)
        splat_v = torch.zeros((n, 3), device=dev)
    if with_stats:
        return L, p_film, splat_p, splat_v, cnt
    return L, p_film, splat_p, splat_v


@torch.no_grad()
def render_bdpt_film(cs, options=None, st_filter=None):
    """Render the film pass by pass, one sample index a pass -> (film
    state with its splats, counters summed, number of passes);
    st_filter: one (s, t) strategy alone."""
    from pbrt_tpu_torch.render import sample_pixels
    from pbrt_tpu_torch.utils.options import Options
    options = options or Options()
    dev = cs.device
    D = int(cs.integrator_params.get("maxdepth", [5])[0]) + 1
    px_np, py_np = sample_pixels(cs.film)
    px = torch.as_tensor(px_np, device=dev)
    py = torch.as_tensor(py_np, device=dev)
    spp = cs.sampler.rounded_spp()
    if options.quick:
        spp = max(1, spp // 4)
    table = torch.as_tensor(build_table(cs.film.filter), device=dev)
    ones = torch.ones(px.shape[0], device=dev)
    film = FilmState.zeros(cs.film, dev, splats=True)
    totals = {c: torch.zeros((), dtype=torch.int64, device=dev) for c in COUNTERS}
    for s in range(spp):
        sidx = torch.full(px.shape, s, dtype=torch.int32, device=dev)
        L, p_film, splat_p, splat_v, cnt = _bdpt_sample(cs, px, py, sidx, D, st_filter=st_filter,
                                                        with_stats=True)
        film = add_samples(cs.film, film, p_film, L, ones, table)
        film = add_splats(cs.film, film, splat_p, splat_v)
        for c in COUNTERS:
            totals[c] += cnt[c]
    return film, totals, spp


@torch.no_grad()
def render_bdpt(cs, options=None):
    """-> (image [H,W,3] linear RGB tensor on the scene's device, counters
    {name: int} summed over all passes, number of passes); the splats are
    scaled by 1 / spp. Reports the counters and the render's seconds into
    STATS."""
    import time
    from pbrt_tpu_torch.utils.stats import STATS, merge_device_counters
    t0 = time.time()
    film, totals, spp = render_bdpt_film(cs, options)
    img = develop(cs.film, film, splat_scale=1.0 / spp)
    totals = {c: int(v) for c, v in totals.items()}
    merge_device_counters(STATS, totals)
    STATS.report_distribution("Performance/BDPT render seconds", time.time() - t0)
    return img, totals, spp


def debug_strategies(max_depth):
    """The (s, t) pairs of render_bdpt_debug's films."""
    D = max_depth + 1
    return ([(0, t) for t in range(2, D + 2)] + [(1, t) for t in range(2, D + 2)]
            + [(s, t) for s in range(2, D + 1) for t in range(2, D + 2) if s + t <= D + 2]
            + [(s, 1) for s in range(2, D + 1)])


@torch.no_grad()
def render_bdpt_debug(cs, out_dir, options=None) -> list:
    """Write one PNG per (s, t) strategy, bdpt_d{maxdepth}_s{S}_t{T}.png,
    each that strategy's contribution alone -> the paths written."""
    import os
    from pbrt_tpu_torch.io.image_io import write_png
    max_depth = int(cs.integrator_params.get("maxdepth", [5])[0])
    os.makedirs(out_dir, exist_ok=True)
    out = []
    for st in debug_strategies(max_depth):
        film, _, spp = render_bdpt_film(cs, options, st_filter=st)
        img = develop(cs.film, film, splat_scale=1.0 / spp)
        out.append(os.path.join(out_dir, f"bdpt_d{max_depth}_s{st[0]:02d}_t{st[1]:02d}.png"))
        write_png(out[-1], img.cpu().numpy())
    return out
