"""Material "glass": a smooth dielectric of index eta (default 1.5) with
reflection Kr and transmission Kt (default 1), one of the two chosen by
its Fresnel weight; rough glass is not read."""
from __future__ import annotations

import torch

from refmath import ONE_MINUS_EPS, only_params, rgb, scalar

SPECULAR = True


def parse(params):
    only_params("glass", params, ("Kr", "Kt", "eta", "index", "roughness", "uroughness",
                                  "vroughness", "remaproughness"))
    for k in ("roughness", "uroughness", "vroughness"):
        if k in params and params[k][1][0] != 0.0:
            raise ValueError("scene: only smooth glass is read")
    eta = scalar(params, "eta", scalar(params, "index", 1.5))
    return {"Kr": rgb(params, "Kr", 1.0), "Kt": rgb(params, "Kt", 1.0), "eta": eta}


def fresnel(cos_i, eta):
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    enter = cos_i > 0
    ei, et = torch.where(enter, 1.0, eta), torch.where(enter, eta, 1.0)
    ci = torch.abs(cos_i)
    st = ei / et * torch.sqrt(torch.clamp(1 - ci * ci, min=0.0))
    ct = torch.sqrt(torch.clamp(1 - st * st, min=0.0))
    rpa = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-9)
    rpe = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-9)
    return torch.where(st >= 1, 1.0, 0.5 * (rpa * rpa + rpe * rpe))


def sample(m, wo, u_lobe, u_dir):
    """Reflection or refraction by u_lobe against the Fresnel weight ->
    (wi, f, pdf, the factor on eta^2 tracking for Russian roulette)."""
    eta = m["eta"]
    cos_o = wo[:, 2]
    u_re = torch.clamp(u_lobe, 0.0, ONE_MINUS_EPS)
    Fr = fresnel(cos_o, eta)
    refl = u_re < Fr
    eta_t = torch.where(cos_o > 0, 1.0 / eta, eta)
    sgn = torch.where(cos_o > 0, 1.0, -1.0).to(wo.dtype)
    ci = torch.abs(cos_o)
    s2t = eta_t * eta_t * torch.clamp(1.0 - ci * ci, min=0.0)
    ct = torch.sqrt(torch.clamp(1.0 - s2t, min=1e-12))
    wt = torch.stack([-eta_t * wo[:, 0], -eta_t * wo[:, 1],
                      -eta_t * wo[:, 2] + (eta_t * ci - ct) * sgn], -1)
    wr = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1)
    wi = torch.where(refl[:, None], wr, wt)
    aci = torch.clamp(torch.abs(wi[:, 2]), min=1e-9)[:, None]
    f = torch.where(refl[:, None], m["Kr"] * Fr[:, None] / aci,
                    m["Kt"] * ((1.0 - Fr) * eta_t * eta_t)[:, None] / aci)
    pdf = torch.where(refl, Fr, 1.0 - Fr)
    pdf = torch.where(refl | (s2t < 1.0), pdf, 0.0)
    eta2 = torch.where(~refl, torch.where(cos_o > 0, eta * eta, 1.0 / (eta * eta)), 1.0)
    return wi, f, pdf, eta2
