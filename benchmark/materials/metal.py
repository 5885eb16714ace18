"""Material "metal": pbrt-v3's rough conductor, Torrance-Sparrow reflection
of a Trowbridge-Reitz distribution with the conductor Fresnel term of rgb
eta and k (refmicrofacet.py). Parameters and defaults are pbrt-v3's:
roughness 0.01, uroughness and vroughness falling back to it,
remaproughness true, and copper for eta and k (pbrt-v3's sampled copper
curves, here in the rgb that the port integrates them to; a scene that
states eta and k in rgb needs no spectral table). Spectra and a bumpmap
are not read. The only lobe is the glossy one, so every draw samples it
and u_lobe is not read."""
from __future__ import annotations

import numpy as np
import torch

import refmicrofacet as mf
from refmath import only_params

SPECULAR = False
COPPER_ETA = (0.2004, 0.9240, 1.1022)
COPPER_K = (3.9129, 2.4528, 2.1421)


def parse(params):
    only_params("metal", params, ("eta", "k", "roughness", "uroughness", "vroughness",
                                  "remaproughness"))
    for key in ("eta", "k"):
        if key in params and params[key][0] != "rgb":
            raise ValueError(f"scene: metal: only an rgb {key} is read")
    au, av = mf.alphas(params, 0.01)
    eta, k = (np.asarray(params[key][1] if key in params else default, np.float64)
              for key, default in (("eta", COPPER_ETA), ("k", COPPER_K)))
    return {"eta": eta, "k": k, "au": au, "av": av}


def f_pdf(m, wo, wi):
    """f [N,3] and pdf [N] of local directions wo, wi."""
    f = mf.glossy_f(wo, wi, m["au"], m["av"],
                    lambda c: mf.fresnel_conductor(c, m["eta"], m["k"]))
    return f, mf.glossy_pdf(wo, wi, m["au"], m["av"])


def sample(m, wo, u_lobe, u_dir):
    """A reflection about a sampled half vector -> (wi, f, pdf, eta factor)."""
    wi, ok = mf.sample_wi(wo, u_dir, m["au"], m["av"])
    f, pdf = f_pdf(m, wo, wi)
    return wi, f, torch.where(ok, pdf, 0.0), None
