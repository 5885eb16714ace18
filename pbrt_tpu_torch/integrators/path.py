"""Wavefront unidirectional path tracer with NEE, MIS and Russian roulette
(port of pbrt_tpu/integrators/path.py).

Mix materials draw their pick at dimension base + 0 (only where the table
holds a mix); transmission through glass, translucent and fourier lobes
tracks eta^2 for Russian roulette (only where a transmitting family is
present); the spatial light strategy reads the previous vertex.

Every bounce runs intersect -> material -> NEE -> BSDF sample over the
whole [N] wavefront with masked lanes. The camera rays take one traversal
launch; each later bounce takes one merged launch for the next rays and
the shadow rays (scenes with instances add one instance-walk launch to
each; alpha masks add their re-trace launches). Sample dimensions are
static per bounce, so the estimate is a pure function of (pixel, sample
index): the differentiable replay of diff/ backpropagates through it.
In scenes with an image texture, the camera rays carry ray differentials
through specular bounces and every hit gets its uv screen derivatives
for the image filter; elsewhere nothing reads them and none is computed.
In a spectral scene the radiance and throughput are [N, 60] sampled
spectra: emission, the light samples and the lobes' colours are lifted
where they enter, and the radiance goes back to RGB at the return.

Scenes with subsurface materials run the reference's BSSRDF branches
(materials/bssrdf.py). A sampled transmission into a subsurface boundary
launches a diffusion probe instead of the refracted ray: an axis (the
shading normal with probability 1/2, each tangent 1/4) and a channel from
dimensions base + 8 and + 11, a radius from the channel's tabulated CDF
(+ 9) and an azimuth (+ 10); the probe is a chord along the axis through a
sphere of the CDF's 0.999 radius. The next bounce peels up to
SSS_CHAIN_K - 1 further hits of the chord (one intersect call, so one walk
launch, each), picks one of the hits on the entry's material uniformly by
reservoir (dimensions + 12 - + 14), and weights it by Sp / pdf_sp (the
three-axis, three-channel MIS); the exit point shades with the Sw
adapter, a Lambertian of the boundary's Fresnel moment.

The stages are utils/trace.py spans: li.camera and li.intersect once, then
a bounce's li.emit, li.lobes, li.nee, li.bsdf, li.rr and li.pair; the
subsurface branches fall inside the enclosing span.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from pbrt_tpu_torch import lights as LT
from pbrt_tpu_torch.cameras import generate_rays
from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.interaction import compute_differentials, specular_diff_rays
from pbrt_tpu_torch.core.math import normalize
from pbrt_tpu_torch.core.sampling import power_heuristic
from pbrt_tpu_torch.core.spectrum import rgb_to_spectrum, spectrum_to_rgb
from pbrt_tpu_torch.integrators.common import (bounce_base, camera_dims, camera_rays,
                                               channels, infinite_pdf_for_dir,
                                               light_pdf_for_dir, prepare_one_light)
from pbrt_tpu_torch.core.math import dot
from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.materials import M_MIX, bssrdf as SSS, compute_lobes, lift_lobes
from pbrt_tpu_torch.samplers import sample_2d, sample_dim
from pbrt_tpu_torch.scene.intersect import dead_lane_rays, intersect, intersect_pair
from pbrt_tpu_torch.textures import T_IMAGEMAP
from pbrt_tpu_torch.utils.trace import span

COUNTERS = ("camera_rays", "shadow_rays", "bounce_rays", "valid_hits",
            "paths_terminated_rr")
SSS_CHAIN_K = 4      # probe chord hits considered
SSS_AXIS_PROB = (0.25, 0.25, 0.5)   # probe axis: the tangents ss, ts, then ns


def _pick_si(mask, a, b):
    """Lanes of SurfaceInteraction a where mask [N], else b's."""
    out = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        out[f.name] = None if x is None else torch.where(
            mask.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
    return type(a)(**out)


def _probe_chain(cs, si, o, d, t_max, pending, entry_mat, sample_dim_, base, ray_time):
    """Peel up to SSS_CHAIN_K - 1 further hits along each pending probe's
    chord (o, d, t_max) past si, and pick one of its hits on the entry's
    material uniformly -> (si with the pick on pending lanes, the number
    of such hits [N])."""
    data, flags = cs.data, cs.flags
    n = o.shape[0]
    count = (pending & si.valid & (si.material == entry_mat)).to(torch.int64)
    chosen = si
    eps0 = 1e-4 * (1.0 + torch.abs(si.t))
    o_cur = o + (si.t + eps0)[:, None] * d
    rem = torch.clamp(t_max - si.t - eps0, min=0.0)
    far = dead_lane_rays(data, flags, n, o.device)
    for kk in range(1, SSS_CHAIN_K):
        live = pending & (rem > 0.0)
        o_k, d_k = o_cur, d
        if far is not None:
            o_k = torch.where(live[:, None], o_cur, far[0])
            d_k = torch.where(live[:, None], d, far[1])
        si_k = intersect(data, flags, o_k, d_k, torch.where(live, rem, 0.0), time=ray_time)
        ok_k = live & si_k.valid & (si_k.material == entry_mat)
        count = count + ok_k.to(torch.int64)
        take = ok_k & (sample_dim_(base + 11 + kk) * count.to(torch.float32) < 1.0)
        chosen = _pick_si(take, si_k, chosen)
        step = torch.where(ok_k, si_k.t + 1e-4 * (1.0 + torch.abs(si_k.t)), rem)
        o_cur = o_cur + step[:, None] * d
        rem = torch.clamp(rem - step, min=0.0)
    return _pick_si(pending, chosen, si), count


def _exit_weight(data, si, entry_p, entry_mat, frame):
    """Sp(|p_exit - p_entry|) / pdf_sp of each lane's exit point, pdf_sp
    the three probe axes' and three channels' mixture -> [N,3]."""
    emat = torch.clamp(entry_mat, min=0).to(torch.int64)
    prof, reff = data.mats.sss_prof[emat], data.mats.sss_rhoeff[emat]
    st = data.mats.sss[emat][:, 1:4]
    d_vec = si.p - entry_p
    sp = SSS.table_sr(prof, st, vm.length(d_vec))
    d_loc = [dot(d_vec, f) for f in frame]
    n_loc = [dot(si.ns, f) for f in frame]
    r_proj = [torch.sqrt(d_loc[1] ** 2 + d_loc[2] ** 2), torch.sqrt(d_loc[2] ** 2 + d_loc[0] ** 2),
              torch.sqrt(d_loc[0] ** 2 + d_loc[1] ** 2)]
    pdf_sp = torch.zeros_like(d_vec[:, 0])
    for ax in range(3):
        pdfs = SSS.table_pdf_sr(prof, reff, st, r_proj[ax])
        pdf_sp = pdf_sp + (pdfs[:, 0] + pdfs[:, 1] + pdfs[:, 2]) / 3.0 \
            * torch.abs(n_loc[ax]) * SSS_AXIS_PROB[ax]
    return sp / torch.clamp(pdf_sp, min=1e-12)[:, None]


def _adapter_lobes(lobes, here, kd):
    """The exit points' Sw adapter: on lanes `here`, every lobe zero but
    the Lambertian kd [N] (eta 1, no fourier table)."""
    for f in dataclasses.fields(lobes):
        x = getattr(lobes, f.name)
        if x is None:
            continue
        if f.name == "kd":
            v = kd[:, None].expand_as(x)
        elif f.name == "eta":
            v = torch.ones_like(x)
        elif f.name == "fourier_id":
            v = torch.full_like(x, -1)
        else:
            v = torch.zeros_like(x)
        setattr(lobes, f.name, torch.where(here.reshape((-1,) + (1,) * (x.dim() - 1)), v, x))
    return lobes


def _probe_launch(cs, si, lobes, bs, wo_local, ok, here, sample_dim_, base, radii):
    """The lanes that transmit into a subsurface boundary from outside ->
    (entering [N], probe origin [N,3], probe direction [N,3], chord length
    [N], the exit adapter's kd [N])."""
    data = cs.data
    entering = (ok & lobes.sss_flag & ((bs.wi[:, 2] * wo_local[:, 2]) < 0.0)
                & (dot(si.wo, si.ns) > 0.0) & ~here)
    u_ax, u_r = sample_dim_(base + 8), sample_dim_(base + 9)
    u_phi, u_ch = sample_dim_(base + 10), sample_dim_(base + 11)
    pick_ss = (u_ax < 0.25)[:, None]
    pick_ts = ((u_ax >= 0.25) & (u_ax < 0.5))[:, None]
    vz = torch.where(pick_ss, si.ss, torch.where(pick_ts, si.ts, si.ns))
    vx = torch.where(pick_ss, si.ts, torch.where(pick_ts, si.ns, si.ss))
    vy = torch.where(pick_ss, si.ns, torch.where(pick_ts, si.ss, si.ts))
    mid = torch.clamp(si.material, min=0).to(torch.int64)
    ch = torch.clamp((u_ch * 3.0).to(torch.int64), 0, 2)
    st_ch = torch.gather(data.mats.sss[mid][:, 1:4], 1, ch[:, None])[:, 0]
    reff_ch = torch.gather(data.mats.sss_rhoeff[mid], 1, ch[:, None])[:, 0]
    cdf_ch = data.mats.sss_cdf[mid, ch]
    r = SSS.table_sample_sr(cdf_ch, reff_ch, st_ch, radii, u_r)
    rmax = SSS.table_sample_sr(cdf_ch, reff_ch, st_ch, radii, torch.full_like(u_r, 0.999))
    r = torch.minimum(r, 0.999 * rmax)
    h = torch.sqrt(torch.clamp(rmax * rmax - r * r, min=1e-12))
    phi = 2.0 * math.pi * u_phi
    probe_o = si.p + ((r * torch.cos(phi))[:, None] * vx + (r * torch.sin(phi))[:, None] * vy) \
        + h[:, None] * vz
    c_norm = 1.0 - 2.0 * SSS.fresnel_moment1(1.0 / lobes.eta)
    kd_ad = torch.clamp((1.0 - 2.0 * SSS.fresnel_moment1(lobes.eta))
                        / torch.clamp(c_norm, min=1e-3), 0.0, 1.0)
    return entering, probe_o, -vz, 2.0 * h, kd_ad


def li_path(cs, px, py, sample_idx, max_depth: int = 5, rr_threshold: float = 1.0,
            sampler_fn=None, p_film_override=None):
    """Radiance estimate for one sample of each lane. Records an autograd
    tape where gradients are enabled and the scene's tables require them.

    sampler_fn: a dimension -> [N] function that stands in for the
    sampler; p_film_override: [N,2] film positions to trace, with the lens
    drawn from dimensions 2 - 3 and the time from dimension 4, and no ray
    differentials (MLT's primary sample space drives both).

    -> (L [N,3] RGB, p_film [N,2], ray_weight [N], counters): counters are
    int64 device tensors (see COUNTERS) of live rays and hits."""
    spec, data, flags = cs.sampler, cs.data, cs.flags
    n = px.shape[0]
    dev = px.device
    if sampler_fn is None:
        sample_dim_ = lambda dim: sample_dim(spec, px, py, sample_idx, dim)
        sample_2d_ = lambda dim: sample_2d(spec, px, py, sample_idx, dim)
    else:
        sample_dim_ = sampler_fn
        sample_2d_ = lambda dim: torch.stack([sampler_fn(dim), sampler_fn(dim + 1)], -1)
    track_diff = T_IMAGEMAP in flags.tex_kinds
    with span("li.camera"):
        if p_film_override is None:
            rays, ray_w, p_film = camera_rays(
                cs, px, py, sample_idx, spp_for_diff=spec.rounded_spp() if track_diff else None)
        else:
            p_film = p_film_override
            rays, ray_w = generate_rays(cs.camera, p_film, False,
                                        *camera_dims(cs.camera, sample_dim_, sample_2d_))
    o, d = rays.o, rays.d
    spectral = flags.spectral
    L = torch.zeros((n, channels(flags)), device=dev)
    beta = torch.ones((n, channels(flags)), device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    specular_bounce = torch.ones(n, dtype=torch.bool, device=dev)
    prev_bsdf_pdf = torch.zeros(n, device=dev)
    t_max = torch.full((n,), vm.INF, device=dev)
    prev_p = o if flags.light_strategy == "spatial" else None
    eta_scale = None
    ftab = data.fourier if flags.has_fourier else None
    fams = flags.bsdf_fams
    cnt = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in COUNTERS}
    cnt["camera_rays"] += n

    sss = flags.has_subsurface
    if sss:
        radii = torch.as_tensor(SSS.radii_knots(), device=dev)
        pending = torch.zeros(n, dtype=torch.bool, device=dev)
        here = pending
        entry_p, entry_mat = o, torch.full((n,), -1, dtype=torch.int32, device=dev)
        frame = [torch.zeros((n, 3), device=dev)] * 3    # the entry's ss, ts, ns
        kd_adapter = torch.zeros(n, device=dev)

    # ray time places animated instances (the camera's time dimension)
    ray_time = sample_dim_(4) if flags.n_instances > 0 else None
    with span("li.intersect"):
        si = intersect(data, flags, o, normalize(d), t_max, time=ray_time)
    diff_rays = rays
    for bounce in range(max_depth + 1):
        base = bounce_base(bounce)
        if sss:
            if SSS_CHAIN_K > 1 and bounce > 0:
                si, count = _probe_chain(cs, si, o, d, t_max, pending, entry_mat, sample_dim_,
                                         base, ray_time)
                # a uniform pick among count hits: pdf_sp gains 1 / count
                beta = torch.where((pending & (count > 0))[:, None],
                                   beta * count.to(torch.float32)[:, None], beta)
            here = pending & si.valid & (si.material == entry_mat)
            beta = torch.where(here[:, None],
                               beta * _exit_weight(data, si, entry_p, entry_mat, frame), beta)
            active = active & (~pending | here)
        if track_diff:
            si = compute_differentials(si, diff_rays)
        with span("li.emit"):
            wd = None
            if flags.has_infinite:
                esc = active & ~si.valid
                if sss:
                    esc = esc & ~pending
                wd = normalize(d)
                le_inf = LT.le_escaped(data.lights, flags.infinite_light_ids, wd)
                if spectral:
                    le_inf = rgb_to_spectrum(le_inf)
                if bounce == 0:
                    w = torch.ones(n, device=dev)
                else:
                    w = torch.where(specular_bounce, 1.0, power_heuristic(
                        1.0, prev_bsdf_pdf, 1.0, infinite_pdf_for_dir(cs, wd, prev_p)))
                L = L + torch.where(esc[:, None], beta * le_inf * w[:, None], 0.0)
            if flags.has_area_lights:
                hit_l = active & si.valid & (si.area_light >= 0)
                if sss:
                    hit_l = hit_l & ~pending
                le = LT.le_area(data.lights, si.area_light, si.ng, si.wo)
                if spectral:
                    le = rgb_to_spectrum(le)
                if bounce == 0:
                    w = torch.ones(n, device=dev)
                else:
                    w = torch.where(specular_bounce, 1.0, power_heuristic(
                        1.0, prev_bsdf_pdf, 1.0,
                        light_pdf_for_dir(cs, prev_p, wd, si, si.area_light)))
                L = L + torch.where(hit_l[:, None], beta * le * w[:, None], 0.0)

        active = active & si.valid
        cnt["valid_hits"] += active.sum()
        if bounce == max_depth:
            break

        with span("li.lobes"):
            u_mix = sample_dim_(base + 0) if M_MIX in flags.mat_kinds else None
            lobes = compute_lobes(data.mats, data.tex, si.material, si.uv, si.p, si.duv,
                                  flags.has_tex_slot, flags.tex_kinds, u_mix, fams, flags.mat_kinds)
            if spectral:
                lobes = lift_lobes(lobes)
            if sss:
                lobes = _adapter_lobes(lobes, here, kd_adapter)

        # NEE: light sample now, occlusion in the merged launch below
        with span("li.nee"):
            u_sel = sample_dim_(base + 1)
            u_light = sample_2d_(base + 2)
            cnt["shadow_rays"] += active.sum()
            ld, o_sh, d_sh, dist_sh, nee_live = prepare_one_light(
                cs, si, lobes, active, u_sel, u_light)
            beta_nee = beta

        # BSDF sampling
        with span("li.bsdf"):
            u_lobe = sample_dim_(base + 4)
            u_dir = sample_2d_(base + 5)
            wo_local = si.world_to_local(si.wo)
            bs = B.bsdf_sample(lobes, wo_local, u_lobe, u_dir, ftab, fams)
            wi_world = si.local_to_world(bs.wi)
            cos_w = vm.absdot(wi_world, si.ns)
            ok = active & (bs.pdf > 0.0) & ~B.black(bs.f)
            cnt["bounce_rays"] += ok.sum()
            beta = torch.where(ok[:, None], beta * bs.f
                               * (cos_w / torch.clamp(bs.pdf, min=1e-12))[:, None], beta)
            active = ok
            specular_bounce = bs.is_specular
            if track_diff:
                trans = bs.is_transmission if bs.is_transmission is not None \
                    else torch.zeros_like(ok)
                diff_rays = specular_diff_rays(si, diff_rays, wi_world, bs.is_specular & ok,
                                               trans, lobes.eta)
            prev_bsdf_pdf = bs.pdf
            if bs.eta_scale is not None:
                eta_scale = bs.eta_scale if eta_scale is None else eta_scale * bs.eta_scale
            if prev_p is not None:
                prev_p = si.p
            o = si.spawn_origin(wi_world)
            d = wi_world
            if sss:
                entering, probe_o, probe_d, chord, kd_ad = _probe_launch(
                    cs, si, lobes, bs, wo_local, ok, here, sample_dim_, base, radii)
                e3 = entering[:, None]
                o = torch.where(e3, probe_o, o)
                d = torch.where(e3, probe_d, d)
                t_max = torch.where(entering, chord, vm.INF)
                pending = entering
                entry_p = torch.where(e3, si.p, entry_p)
                entry_mat = torch.where(entering, si.material, entry_mat)
                frame = [torch.where(e3, v, f) for v, f in zip((si.ss, si.ts, si.ns), frame)]
                kd_adapter = torch.where(entering, kd_ad, kd_adapter)

        # Russian roulette
        if bounce > 3:
            with span("li.rr"):
                rr_beta = vm.max_component(beta if eta_scale is None else beta * eta_scale[:, None])
                u_rr = sample_dim_(base + 7)
                q = torch.clamp(1.0 - rr_beta, min=0.05)
                do_rr = rr_beta < rr_threshold
                survive = ~do_rr | (u_rr >= q)
                beta = torch.where((do_rr & survive)[:, None],
                                   beta / torch.clamp(1.0 - q, min=1e-6)[:, None], beta)
                cnt["paths_terminated_rr"] += (active & ~survive).sum()
                active = active & survive

        with span("li.pair"):
            si, occluded = intersect_pair(data, flags, o, normalize(d), t_max, active,
                                          o_sh, d_sh, dist_sh, nee_live, time=ray_time)
            L = L + torch.where((nee_live & ~occluded)[:, None], beta_nee * ld, 0.0)
    if spectral:
        L = spectrum_to_rgb(L)
    return L, p_film, ray_w, cnt
