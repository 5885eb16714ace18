"""Material tables -> lobes (port of pbrt_tpu/materials/__init__.py for
every material kind but the subsurface ones).

A material is a row of a table: its kind, a constant or a texture id per
slot, and misc values. Slot layout of `const` and `tex` (the reference's):
0 Kd (metal: eta rgb), 1 Ks (metal: k rgb), 2 Kr, 3 Kt, 4 roughness,
5 uroughness, 6 vroughness, 7 opacity, 8 sigma (matte) / amount (mix),
9 bumpmap (held, never evaluated, as in the reference). `misc`: [eta,
remaproughness, translucent reflect rgb (fourier: table id), translucent
transmit rgb]. `child`: a mix's two materials.

`compute_lobes` resolves mix rows (two levels, one uniform u_mix draw:
the one-sample estimator of the reference's lobe-scaled mix) and writes
each kind's lobe parameters under its mask. Only the kinds the table holds
(`kinds`, static) and the lobe families they populate (`fams`) issue
tensor ops; a slot no material textures issues no texture op.
`subsurface` and `kdsubsurface` raise NotImplementedError.
"""
from __future__ import annotations

import logging
import os
import struct

import numpy as np
import torch

from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.textures import eval_texture

(M_MATTE, M_PLASTIC, M_GLASS, M_MIRROR, M_METAL, M_SUBSTRATE, M_TRANSLUCENT,
 M_UBER, M_FOURIER, M_MIX, M_SUBSURFACE, M_KDSUBSURFACE, M_NONE) = range(13)
KIND_IDS = {"matte": M_MATTE, "plastic": M_PLASTIC, "glass": M_GLASS,
            "mirror": M_MIRROR, "metal": M_METAL, "substrate": M_SUBSTRATE,
            "translucent": M_TRANSLUCENT, "uber": M_UBER, "fourier": M_FOURIER,
            "mix": M_MIX, "subsurface": M_SUBSURFACE,
            "kdsubsurface": M_KDSUBSURFACE, "none": M_NONE, "": M_NONE}
ALL_KINDS = tuple(k for k in range(13) if k not in (M_SUBSURFACE, M_KDSUBSURFACE))
N_SLOTS = 10
SLOT_NAMES = ["Kd", "Ks", "Kr", "Kt", "roughness", "uroughness",
              "vroughness", "opacity", "sigma", "bumpmap"]
# copper eta / k (the sampled Cu curves of metal.rs integrated to sRGB)
COPPER_ETA = np.array([0.2004, 0.9240, 1.1022], np.float32)
COPPER_K = np.array([3.9129, 2.4528, 2.1421], np.float32)
_DEFAULTS = {
    M_MATTE: {"Kd": 0.5, "sigma": 0.0},
    # plastic's opacity slot is 1: compute_lobes scales Kd and Ks by it
    M_PLASTIC: {"Kd": 0.25, "Ks": 0.25, "roughness": 0.1, "opacity": 1.0},
    M_GLASS: {"Kr": 1.0, "Kt": 1.0, "roughness": 0.0},
    M_MIRROR: {"Kr": 0.9},
    M_METAL: {"roughness": 0.01},
    M_SUBSTRATE: {"Kd": 0.5, "Ks": 0.5, "roughness": 0.1},
    M_TRANSLUCENT: {"Kd": 0.25, "Ks": 0.25, "roughness": 0.1},
    M_UBER: {"Kd": 0.25, "Ks": 0.25, "Kr": 0.0, "Kt": 0.0, "roughness": 0.1,
             "opacity": 1.0},
}


def compile_materials(decls, cwd="."):
    """Host: list of MaterialDecl -> (kind [M], const [M,10,3], misc [M,8],
    tex [M,10] texture id per slot (-1: its constant), child [M,2] mix
    children, fourier tables read for fourier.fourier_tables). A kind the
    reference does not know renders as matte, as there; a fourier table
    that cannot be read is logged and its material becomes matte Kd 0.5."""
    from pbrt_tpu_torch.materials.fourier import read_bsdf_file
    M = len(decls)
    kind = np.zeros(M, np.int32)
    tex = np.full((M, N_SLOTS), -1, np.int32)
    const = np.zeros((M, N_SLOTS, 3), np.float32)
    misc = np.zeros((M, 8), np.float32)
    child = np.full((M, 2), -1, np.int32)
    tables = []
    for i, d in enumerate(decls):
        k = KIND_IDS.get(d.kind, M_MATTE)
        if k in (M_SUBSURFACE, M_KDSUBSURFACE):
            raise NotImplementedError(f"material {d.kind!r} is not ported")
        kind[i] = k
        ps = d.params
        defaults = _DEFAULTS.get(k, {})
        for s, name in enumerate(SLOT_NAMES):
            dv = defaults.get(name)
            if name in d.tex_refs:
                tex[i, s] = d.tex_refs[name]
            elif name in ps:
                const[i, s] = ps.find_one_rgb(name, [0, 0, 0])
            elif dv is not None:
                const[i, s] = dv
        misc[i, 0] = ps.find_one_float("eta", ps.find_one_float("index", 1.5))
        misc[i, 1] = 1.0 if ps.find_one_bool("remaproughness", True) else 0.0
        if k == M_METAL:
            const[i, 0] = ps.find_one_rgb("eta", COPPER_ETA)
            const[i, 1] = ps.find_one_rgb("k", COPPER_K)
        elif k == M_MIX:
            child[i] = d.children
            const[i, 8] = ps.find_one_rgb("amount", [0.5, 0.5, 0.5])
        elif k == M_TRANSLUCENT:
            misc[i, 2:5] = ps.find_one_rgb("reflect", [0.5] * 3)
            misc[i, 5:8] = ps.find_one_rgb("transmit", [0.5] * 3)
        elif k == M_FOURIER:
            fname = ps.find_one_string("bsdffile", "")
            path = fname if os.path.isabs(fname) else os.path.join(cwd, fname)
            try:
                t = read_bsdf_file(path)
            except (OSError, ValueError, struct.error) as e:
                logging.getLogger(__name__).warning(
                    "fourier table %s unreadable (%s): matte in its place", path, e)
                kind[i] = M_MATTE
                const[i, 0] = 0.5
            else:
                misc[i, 2] = float(len(tables))
                misc[i, 0] = t["eta"]
                tables.append(t)
    return kind, const, misc, tex, child, tables


def material_families(decls):
    """Static lobe-family presence of a scene's materials -> (dift,
    glossy, glossy_t, oren, spec); conservative: a textured or nonzero
    parameter keeps its family on. Mix children are materials of their
    own; a fourier table is gated by the table itself."""
    dift = glossy = glossy_t = oren = spec = False
    for d in decls:
        k = d.kind
        vals = d.params.as_plain_dict()

        def has(name):
            v = vals.get(name)
            if v is None:
                return False
            return isinstance(v[0], str) or any(abs(float(x)) > 1e-9 for x in v)

        if k == "matte":
            oren |= has("sigma")
        elif k in ("plastic", "metal", "substrate"):
            glossy = True
        elif k == "glass":
            spec = True
            if has("roughness") or has("uroughness") or has("vroughness"):
                glossy = glossy_t = True
        elif k == "mirror":
            spec = True
        elif k == "translucent":
            dift = glossy = glossy_t = True
        elif k == "uber":
            glossy = spec = True
            oren |= has("sigma")
        elif k in ("subsurface", "kdsubsurface"):
            spec = True
            if has("roughness") or has("uroughness"):
                glossy = glossy_t = True
        elif k not in ("fourier", "mix"):
            dift = glossy = glossy_t = oren = spec = True
    return (dift, glossy, glossy_t, oren, spec)


def _remap(rough, do_remap):
    a = torch.where(do_remap, B.roughness_to_alpha(rough), rough)
    return torch.clamp(a, min=1e-3)


def _select(terms, like):
    """Nested where over (mask [N], value [N,3]) terms; 0 where none
    holds (each lane holds at most one)."""
    out = torch.zeros_like(like) if not terms else 0.0
    for mask, v in reversed(terms):
        out = torch.where(mask[:, None], v, out)
    return out


def compute_lobes(mats, tex, mat_id, uv, p, duv=None, has_tex_slot=(), tex_kinds=(),
                  u_mix=None, fams=None, kinds=None) -> B.Lobes:
    """Wavefront material stage: material ids [N] of hits with uv [N,2],
    points p [N,3] and uv screen derivatives duv (or None) -> Lobes.
    has_tex_slot (SceneFlags): the slots some material textures; tex_kinds:
    the texture kinds present; u_mix [N]: the mix draw (needed where the
    table holds a mix); fams: the lobe families to build (default all);
    kinds: the material kinds the table holds (default all)."""
    fams = fams or B.ALL_FAMS
    dift, glossy, glossy_t, oren, spec = fams
    kinds = ALL_KINDS if kinds is None else kinds
    mat_id = torch.clamp(mat_id, min=0).to(torch.int64)
    if M_MIX in kinds:
        for _ in range(2):
            is_mix = mats.kind[mat_id] == M_MIX
            pick1 = u_mix < mats.const[mat_id, 8, 0]
            childv = mats.child[mat_id]
            chosen = torch.where(pick1, childv[:, 0], childv[:, 1]).to(torch.int64)
            mat_id = torch.where(is_mix & (chosen >= 0), chosen, mat_id)
    kind = mats.kind[mat_id]
    misc = mats.misc[mat_id]
    constv = mats.const[mat_id]
    texv = mats.tex[mat_id] if any(has_tex_slot) else None

    def slot(s):
        if s >= len(has_tex_slot) or not has_tex_slot[s]:
            return constv[:, s]
        cid = texv[:, s]
        tv = eval_texture(tex, cid, uv, p, duv=duv, kinds=tex_kinds)
        return torch.where((cid >= 0)[:, None], tv, constv[:, s])

    has = {k: (kind == k) for k in kinds if k not in (M_MIX, M_NONE)}
    present = set(has)
    Kd, Ks = slot(0), slot(1)
    opacity = slot(7) if present & {M_PLASTIC, M_UBER} else None
    Kr = slot(2) if present & {M_GLASS, M_MIRROR, M_UBER} else None
    Kt = slot(3) if present & {M_GLASS, M_UBER} else None
    if glossy or glossy_t or M_GLASS in has:
        rough = slot(4)[:, 0]
        urough_raw, vrough_raw = slot(5)[:, 0], slot(6)[:, 0]
        urough = torch.where(urough_raw > 0.0, urough_raw, rough)
        vrough = torch.where(vrough_raw > 0.0, vrough_raw, rough)
    if M_GLASS in has:
        glass_smooth = has[M_GLASS] & (urough <= 1e-6) & (vrough <= 1e-6)
        glass_rough = has[M_GLASS] & ~glass_smooth
    transl = has.get(M_TRANSLUCENT)

    kd_terms = []
    if M_MATTE in has:
        kd_terms.append((has[M_MATTE], Kd))
    if M_PLASTIC in has:
        kd_terms.append((has[M_PLASTIC], Kd * opacity))
    if M_UBER in has:
        kd_terms.append((has[M_UBER], Kd * opacity))
    if transl is not None:
        kd_terms.append((transl, Kd * misc[:, 2:5]))
    lb = B.Lobes(kd=_select(kd_terms, Kd))
    if glossy or glossy_t:
        do_remap = misc[:, 1] > 0.5
        au, av = _remap(urough, do_remap), _remap(vrough, do_remap)
    if glossy:
        ks_terms = []
        if M_PLASTIC in has:
            ks_terms.append((has[M_PLASTIC], Ks * opacity))
        if M_UBER in has:
            ks_terms.append((has[M_UBER], Ks * opacity))
        if M_METAL in has:
            ks_terms.append((has[M_METAL], torch.ones_like(Ks)))
        if M_SUBSTRATE in has:
            ks_terms.append((has[M_SUBSTRATE], Ks))
        if M_GLASS in has:
            ks_terms.append((glass_rough, Kr))
        if transl is not None:
            ks_terms.append((transl, Ks * misc[:, 2:5]))
        lb.ks, lb.rough_u, lb.rough_v = _select(ks_terms, Ks), au, av
        if M_METAL in has or M_SUBSTRATE in has:
            gk = torch.full_like(kind, B.GF_DIELECTRIC)
            if M_SUBSTRATE in has:
                gk = torch.where(has[M_SUBSTRATE], B.GF_BLEND, gk)
                lb.rd_blend = torch.where(has[M_SUBSTRATE][:, None], Kd, 0.0)
            if M_METAL in has:
                gk = torch.where(has[M_METAL], B.GF_CONDUCTOR, gk)
            lb.glossy_kind = gk
    if M_METAL in has:
        # conductor eta / k: the raw constants (the reference never textures them)
        lb.eta3 = torch.where(has[M_METAL][:, None], constv[:, 0], 1.0)
        lb.k3 = torch.where(has[M_METAL][:, None], constv[:, 1], 0.0)
    if oren:
        sigma = slot(8)[:, 0]
        lb.sigma = torch.where(has[M_MATTE], torch.deg2rad(sigma), 0.0) \
            if M_MATTE in has else torch.zeros_like(sigma)
    if dift:
        lb.kt_diff = torch.where(transl[:, None], Kd * misc[:, 5:8], 0.0) \
            if transl is not None else torch.zeros_like(Kd)
    if glossy_t:
        kt_terms = []
        if M_GLASS in has:
            kt_terms.append((glass_rough, Kt))
        if transl is not None:
            kt_terms.append((transl, Ks * misc[:, 5:8]))
        lb.kt_gloss, lb.rough_tu, lb.rough_tv = _select(kt_terms, Ks), au, av
    if spec:
        r_terms, t_terms = [], []
        if M_GLASS in has:
            r_terms.append((glass_smooth, Kr))
            t_terms.append((glass_smooth, Kt))
        if M_MIRROR in has:
            r_terms.append((has[M_MIRROR], Kr))
        if M_UBER in has:
            r_terms.append((has[M_UBER], Kr * opacity))
            # the (1 - opacity) passthrough keeps dielectric Fresnel, as in the reference
            t_terms.append((has[M_UBER], Kt * opacity + (1.0 - opacity)))
        lb.spec_r, lb.spec_t = _select(r_terms, Kd), _select(t_terms, Kd)
        if M_MIRROR in has:
            lb.spec_fresnel = torch.where(has[M_MIRROR], B.SF_NOOP, B.SF_DIELECTRIC)
    if M_FOURIER in has:
        lb.fourier_id = torch.where(has[M_FOURIER], misc[:, 2].to(torch.int64), -1)
    eta = misc[:, 0]
    lb.eta = torch.where(eta > 0, eta, 1.5)
    return lb
