"""Material tables -> lobes (port of pbrt_tpu/materials/__init__.py for the
`matte` and `plastic` kinds, with constant or textured parameters).

Slot layout of `const` and `tex` (the reference's): 0 Kd, 1 Ks, 2 Kr,
3 Kt, 4 roughness, 5 uroughness, 6 vroughness, 7 opacity, 8 sigma,
9 bumpmap (held, never evaluated, as in the reference). `misc`: [eta,
remaproughness, ...]. A slot that names a texture takes the texture's
value; a slot no material textures issues no texture op. Other material
kinds and matte's Oren-Nayar `sigma` raise NotImplementedError.
"""
from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.materials import bsdf as B
from pbrt_tpu_torch.textures import eval_texture

M_MATTE, M_PLASTIC = 0, 1
KIND_IDS = {"matte": M_MATTE, "plastic": M_PLASTIC}
N_SLOTS = 10
SLOT_NAMES = ["Kd", "Ks", "Kr", "Kt", "roughness", "uroughness",
              "vroughness", "opacity", "sigma", "bumpmap"]
_DEFAULTS = {
    M_MATTE: {"Kd": 0.5, "sigma": 0.0},
    M_PLASTIC: {"Kd": 0.25, "Ks": 0.25, "roughness": 0.1, "opacity": 1.0},
}


def compile_materials(decls):
    """Host: list of MaterialDecl -> (kind [M], const [M,10,3], misc [M,8],
    tex [M,10] texture id per slot, -1 where the slot is constant)."""
    M = len(decls)
    kind = np.zeros(M, np.int32)
    tex = np.full((M, N_SLOTS), -1, np.int32)
    const = np.zeros((M, N_SLOTS, 3), np.float32)
    misc = np.zeros((M, 8), np.float32)
    for i, d in enumerate(decls):
        if d.kind not in KIND_IDS:
            raise NotImplementedError(f"material {d.kind!r} is not ported")
        k = KIND_IDS[d.kind]
        kind[i] = k
        ps = d.params
        for s, name in enumerate(SLOT_NAMES):
            dv = _DEFAULTS[k].get(name)
            if name in d.tex_refs:
                tex[i, s] = d.tex_refs[name]
            elif name in ps:
                const[i, s] = ps.find_one_rgb(name, [0, 0, 0])
            elif dv is not None:
                const[i, s] = dv
        if k == M_MATTE and (np.any(const[i, 8] != 0.0) or tex[i, 8] >= 0):
            raise NotImplementedError("matte 'sigma' (Oren-Nayar) is not ported")
        misc[i, 0] = ps.find_one_float("eta", ps.find_one_float("index", 1.5))
        misc[i, 1] = 1.0 if ps.find_one_bool("remaproughness", True) else 0.0
    return kind, const, misc, tex


def _remap(rough, do_remap):
    a = torch.where(do_remap, B.roughness_to_alpha(rough), rough)
    return torch.clamp(a, min=1e-3)


def compute_lobes(mats, tex, mat_id, uv, p, duv=None, has_tex_slot=(),
                  tex_kinds=()) -> B.Lobes:
    """Wavefront material stage: material ids [N] of hits with uv [N,2],
    points p [N,3] and uv screen derivatives duv (or None) -> Lobes.
    has_tex_slot (SceneFlags): the slots some material textures; tex_kinds:
    the texture kinds present."""
    mat_id = torch.clamp(mat_id, min=0).to(torch.int64)
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

    Kd, Ks, opacity = slot(0), slot(1), slot(7)
    rough = slot(4)[:, 0]
    urough_raw, vrough_raw = slot(5)[:, 0], slot(6)[:, 0]
    urough = torch.where(urough_raw > 0.0, urough_raw, rough)
    vrough = torch.where(vrough_raw > 0.0, vrough_raw, rough)
    do_remap = misc[:, 1] > 0.5
    is_matte = (kind == M_MATTE)[:, None]
    is_plastic = (kind == M_PLASTIC)[:, None]
    kd = torch.where(is_matte, Kd, torch.where(is_plastic, Kd * opacity, 0.0))
    ks = torch.where(is_plastic, Ks * opacity, 0.0)
    eta = misc[:, 0]
    return B.Lobes(kd=kd, ks=ks, rough_u=_remap(urough, do_remap),
                   rough_v=_remap(vrough, do_remap),
                   eta=torch.where(eta > 0, eta, 1.5))
