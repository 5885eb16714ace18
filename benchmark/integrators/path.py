"""Integrator "path": the estimator that the port documents for its path
integrator, step for step, so that at the same sample draws it gives the
same radiance up to rounding.

A unidirectional path tracer with next-event estimation from one light a
vertex (picked by power), multiple importance sampling by the power
heuristic, Russian roulette after bounce 3 with eta^2 tracking through
specular transmission, and static sample dimensions: 0-1 film, 2-3 lens,
then 16 a bounce from 5 (+1 light pick, +2/+3 light point, +4 lobe,
+5/+6 direction, +7 roulette). Materials, lights and the camera are the
reference's parts (materials/, lights/, area_lights/, cameras/), each
asked through its own functions.
"""
from __future__ import annotations

import math

import torch

import refsampler
from refmath import dot, normalize, only_params, power_heuristic

CAMERA_DIMS, BOUNCE_DIMS = 5, 16


def make(params, ref):
    only_params("path integrator", params, ("maxdepth",))
    return Path(int(params["maxdepth"][1][0]) if "maxdepth" in params else 5, ref)


class Path:
    def __init__(self, max_depth, ref):
        self.max_depth, self.ref = max_depth, ref

    def _light_sample(self, p, u_sel, u2):
        """NEE: one light picked by power, sampled at points p -> (pmf, wi,
        Li, pdf, target point)."""
        ref = self.ref
        n = p.shape[0]
        li = torch.clamp(torch.searchsorted(ref.l_cdf, u_sel.float().contiguous(), right=True) - 1,
                         0, len(ref.lights) - 1)
        pmf = ref.l_pmf[li]
        wi = torch.zeros((n, 3), dtype=ref.dtype, device=ref.device)
        Li, target = torch.zeros_like(wi), torch.zeros_like(wi)
        pdf = torch.zeros(n, dtype=ref.dtype, device=ref.device)
        for i, light in enumerate(ref.lights):
            sel = li == i
            w_i, L_i, pdf_i, t_i = light.sample(ref, p, u2)
            s3 = sel[:, None]
            wi, Li = torch.where(s3, w_i, wi), torch.where(s3, L_i, Li)
            pdf, target = torch.where(sel, pdf_i, pdf), torch.where(s3, t_i, target)
        return pmf, wi, Li, pdf, target

    def radiance(self, px, py, s, pf):
        """One radiance sample per lane of pixels px, py at sample indices
        s, film positions pf -> L [N,3] in the reference's float type."""
        ref = self.ref
        dt, dev = ref.dtype, ref.device
        st = refsampler.Stream(ref.sampler, px, py, s)
        U1 = lambda k: torch.as_tensor(st.d1(k), device=dev).to(dt)
        U2 = lambda k: torch.as_tensor(st.d2(k), device=dev).to(dt)
        n = len(px)
        o, d = ref.camera.rays(pf, st)
        L = torch.zeros((n, 3), dtype=dt, device=dev)
        beta = torch.ones((n, 3), dtype=dt, device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        spec = torch.ones(n, dtype=torch.bool, device=dev)
        prev_pdf = torch.zeros(n, dtype=dt, device=dev)
        eta_scale = torch.ones(n, dtype=dt, device=dev)
        inf = torch.full((n,), math.inf, dtype=dt, device=dev)
        escapes = [(i, l) for i, l in enumerate(ref.lights) if hasattr(l, "escape")]
        areas = [(i, l) for i, l in enumerate(ref.lights) if hasattr(l, "hit")]
        kinds = ref.material_kinds
        d = normalize(d)
        h = ref.hit(o, d, inf)
        for bounce in range(self.max_depth + 1):
            base = CAMERA_DIMS + BOUNCE_DIMS * bounce
            if escapes:
                esc = active & ~h["valid"]
                got = [l.escape(ref, d, ref.l_pmf[i]) for i, l in escapes]
                le, pdf_esc = sum(g[0] for g in got), sum(g[1] for g in got)
                w = (torch.ones(n, dtype=dt, device=dev) if bounce == 0 else
                     torch.where(spec, 1.0, power_heuristic(prev_pdf, pdf_esc.expand(n))))
                L = L + torch.where(esc[:, None], beta * le * w[:, None], 0.0)
            hit_l = active & h["valid"] & (h["light"] >= 0)
            if hit_l.any():
                emit = torch.zeros_like(hit_l)
                Le = torch.zeros((n, 3), dtype=dt, device=dev)
                pl = torch.zeros(n, dtype=dt, device=dev)
                for i, light in areas:
                    sel = hit_l & (h["light"] == i)
                    e_i, Le_i, pa_i = light.hit(ref, h)
                    emit = emit | (sel & e_i)
                    Le = torch.where(sel[:, None], Le_i, Le)
                    pl = torch.where(sel, pa_i * ref.l_pmf[i], pl)
                w = (torch.ones(n, dtype=dt, device=dev) if bounce == 0 else
                     torch.where(spec, 1.0, power_heuristic(prev_pdf, pl)))
                L = L + torch.where(emit[:, None], beta * Le * w[:, None], 0.0)
            active = active & h["valid"]
            if bounce == self.max_depth:
                break
            mid = h["mat"]
            mats = {k: {key: t[mid] for key, t in tables.items()}
                    for k, (mod, tables) in kinds.items()}
            wo = ref.local(h, h["wo"])
            # next-event estimation: the light sample now, its shadow ray below
            pmf, wi_l, Li, pdf_l, target = self._light_sample(h["p"], U1(base + 1), U2(base + 2))
            wil = ref.local(h, wi_l)
            f_l = torch.zeros((n, 3), dtype=dt, device=dev)
            pdf_b = torch.zeros(n, dtype=dt, device=dev)
            for k, (mod, _) in kinds.items():
                if not mod.SPECULAR:
                    sel = h["kind"] == k
                    f_k, p_k = mod.f_pdf(mats[k], wo, wil)
                    f_l = torch.where(sel[:, None], f_k, f_l)
                    pdf_b = torch.where(sel, p_k, pdf_b)
            f_l = f_l * torch.abs(dot(wi_l, h["ns"]))[:, None]
            nee = active & (pdf_l > 0) & (f_l > 0).any(-1) & (Li > 0).any(-1) & (pmf > 0)
            o_sh = ref.spawn(h, wi_l)
            to_l = target - o_sh
            dist = torch.sqrt(dot(to_l, to_l))
            d_sh = to_l / torch.clamp(dist, min=1e-12)[:, None]
            w_l = power_heuristic(pdf_l * pmf, pdf_b)
            w_nee = w_l / torch.clamp(pdf_l * pmf, min=1e-12)
            ld = torch.where(nee[:, None], f_l * Li * w_nee[:, None], 0.0)
            beta_nee = beta
            # BSDF sampling, each material by its own rule
            u_lobe, u_dir = U1(base + 4), U2(base + 5)
            wi = torch.zeros((n, 3), dtype=dt, device=dev)
            f = torch.zeros_like(wi)
            pdf = torch.zeros(n, dtype=dt, device=dev)
            is_spec = torch.zeros(n, dtype=torch.bool, device=dev)
            eta2 = torch.ones(n, dtype=dt, device=dev)
            for k, (mod, _) in kinds.items():
                sel = h["kind"] == k
                wi_k, f_k, p_k, e_k = mod.sample(mats[k], wo, u_lobe, u_dir)
                wi, f = torch.where(sel[:, None], wi_k, wi), torch.where(sel[:, None], f_k, f)
                pdf = torch.where(sel, p_k, pdf)
                is_spec = is_spec | (sel & mod.SPECULAR)
                if e_k is not None:
                    eta2 = torch.where(sel, e_k, eta2)
            eta_scale = eta_scale * eta2
            wi_w = wi[:, 0:1] * h["ss"] + wi[:, 1:2] * h["ts"] + wi[:, 2:3] * h["ns"]
            ok = active & (pdf > 0) & (f > 0).any(-1)
            beta = torch.where(ok[:, None], beta * f * (torch.abs(dot(wi_w, h["ns"]))
                                                        / torch.clamp(pdf, min=1e-12))[:, None],
                               beta)
            active = ok
            spec = is_spec
            prev_pdf = pdf
            o = ref.spawn(h, wi_w)
            d = wi_w
            if bounce > 3:
                rr = (beta * eta_scale[:, None]).amax(-1)
                q = torch.clamp(1.0 - rr, min=0.05)
                do_rr = rr < 1.0
                live = ~do_rr | (U1(base + 7) >= q)
                beta = torch.where((do_rr & live)[:, None],
                                   beta / torch.clamp(1.0 - q, min=1e-6)[:, None], beta)
                active = active & live
            d = normalize(d)
            h = ref.hit(o, d, torch.where(active, inf, 0.0))
            _, occ = ref.accel.closest(o_sh, d_sh, torch.where(nee, dist * (1.0 - 1e-3), 0.0))
            L = L + torch.where((nee & (occ < 0))[:, None], beta_nee * ld, 0.0)
        return L
