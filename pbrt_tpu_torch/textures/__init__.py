"""Texture table and its wavefront evaluation (port of
pbrt_tpu/textures/__init__.py): constant, scale, mix, bilerp, uv,
checkerboard 2D and 3D, dots, fbm, wrinkled, windy, marble and imagemap,
the 2D (uv, spherical, cylindrical, planar) and 3D mappings, and the
hash-gradient Perlin noise.

Table layout (one row a texture):
  kind    [X] int32
  params  [X, 16] float32: [0:3] constant rgb / tex1 colour, [3:6] tex2
          colour, [6] 2D mapping, [7:11] uscale vscale udelta vdelta,
          [11] aux (mix amount, noise variation, bilerp v11), [12] omega,
          [13] noise scale, [13:16] bilerp v10
  child   [X, 2] int32: inner textures of tex1 / tex2 (-1: the colour)
  w2t     [X, 4, 4] world to texture (3D mappings; planar packs v1, v2)
  image_id [X] int32 (imagemap; -1 none), and the mip atlas of
  textures/image.py.

Evaluation recurses over children to a static depth. `kinds`, the kind
ids the scene holds (SceneFlags.tex_kinds), gates it: an absent kind
issues no tensor op. Each level of the recursion is gated to the kinds of
the textures that sit that many child links below some texture (derived
with the table), so a table without nested textures evaluates no child:
the values are the reference's, which evaluates every kind at every
level. The Perlin hashes run on the port's int64-masked u32 words
(samplers/hashing.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.math import dot, normalize
from pbrt_tpu_torch.samplers.hashing import hash3, u32, u32_to_float

(T_CONSTANT, T_SCALE, T_MIX, T_BILERP, T_UV, T_CHECKER2D, T_CHECKER3D,
 T_DOTS, T_FBM, T_WRINKLED, T_WINDY, T_MARBLE, T_IMAGEMAP, T_PTEX) = range(14)

KIND_IDS = {"constant": T_CONSTANT, "scale": T_SCALE, "mix": T_MIX,
            "bilerp": T_BILERP, "uv": T_UV, "checkerboard": T_CHECKER2D,
            "dots": T_DOTS, "fbm": T_FBM, "wrinkled": T_WRINKLED,
            "windy": T_WINDY, "marble": T_MARBLE, "imagemap": T_IMAGEMAP}

MAX_TEX_DEPTH = 4
OCTAVES = 6
_ST_KINDS = (T_SCALE, T_MIX, T_BILERP, T_UV, T_CHECKER2D, T_DOTS, T_IMAGEMAP)
_P3_KINDS = (T_CHECKER3D, T_FBM, T_WRINKLED, T_WINDY, T_MARBLE)
_CHILD_KINDS = (T_SCALE, T_MIX, T_CHECKER2D, T_CHECKER3D, T_DOTS)


@dataclasses.dataclass
class TextureTable:
    kind: torch.Tensor          # [X] int32
    params: torch.Tensor        # [X, 16]
    child: torch.Tensor         # [X, 2] int32
    w2t: torch.Tensor           # [X, 4, 4]
    image_id: torch.Tensor      # [X] int32
    atlas: torch.Tensor         # [n_images, S, S + S//2, 3]
    atlas_size: torch.Tensor    # [n_images, 2] int32
    atlas_levels: torch.Tensor  # [n_images] int32
    mappings: tuple = dataclasses.field(init=False)     # 2D mapping ids present
    child_kinds: tuple = dataclasses.field(init=False)  # per child level, its kind ids

    def __post_init__(self):
        self.mappings = tuple(int(m) for m in np.unique(
            self.params[:, 6].detach().cpu().numpy().astype(np.int32)))
        kind, child = self.kind.cpu().numpy(), self.child.cpu().numpy()
        levels, ids = [], np.arange(kind.shape[0])
        for _ in range(MAX_TEX_DEPTH):
            ids = np.unique(child[ids].reshape(-1))
            ids = ids[ids >= 0]
            levels.append(tuple(int(k) for k in np.unique(kind[ids])))
        self.child_kinds = tuple(levels)


# ---------------------------------------------------------------------------
# Perlin noise
# ---------------------------------------------------------------------------

def _grad(ix, iy, iz, fx, fy, fz):
    h = hash3(u32(ix), u32(iy), u32(iz)) & 15
    u = torch.where(h < 8, fx, fy)
    v = torch.where(h < 4, fy, torch.where((h == 12) | (h == 14), fx, fz))
    return torch.where((h & 1) == 0, u, -u) + torch.where((h & 2) == 0, v, -v)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def noise3(p):
    """Perlin gradient noise in [-1, 1] of points p [..., 3]."""
    pi = torch.floor(p)
    pf = p - pi
    ix, iy, iz = (pi[..., i].to(torch.int32).to(torch.int64) for i in range(3))
    fx, fy, fz = pf[..., 0], pf[..., 1], pf[..., 2]
    u, v, w = _fade(fx), _fade(fy), _fade(fz)

    def g(dx, dy, dz):
        return _grad(ix + dx, iy + dy, iz + dz, fx - dx, fy - dy, fz - dz)

    x00 = vm.lerp(u, g(0, 0, 0), g(1, 0, 0))
    x10 = vm.lerp(u, g(0, 1, 0), g(1, 1, 0))
    x01 = vm.lerp(u, g(0, 0, 1), g(1, 0, 1))
    x11 = vm.lerp(u, g(0, 1, 1), g(1, 1, 1))
    return vm.lerp(w, vm.lerp(v, x00, x10), vm.lerp(v, x01, x11))


def fbm(p, omega: float, max_octaves: int):
    total = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    lam, o = 1.0, 1.0
    for _ in range(max_octaves):
        total = total + o * noise3(p * lam)
        lam *= 1.99
        o *= omega
    return total


def turbulence(p, omega: float, max_octaves: int):
    total = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    lam, o = 1.0, 1.0
    for _ in range(max_octaves):
        total = total + o * torch.abs(noise3(p * lam))
        lam *= 1.99
        o *= omega
    return total


# ---------------------------------------------------------------------------
# mappings
# ---------------------------------------------------------------------------

def _map_p3(w2t, p):
    return torch.einsum("nij,nj->ni", w2t[:, :3, :3], p) + w2t[:, :3, 3]


def _map_st(params, w2t, uv, p, mappings):
    """2D mapping of the hits -> (s, t) per lane; mappings: the mapping
    ids (0 uv, 1 spherical, 2 cylindrical, 3 planar) the table holds."""
    mk = params[:, 6].to(torch.int32)
    us, vs, ud, vd = params[:, 7], params[:, 8], params[:, 9], params[:, 10]
    st = torch.stack([uv[:, 0] * us + ud, uv[:, 1] * vs + vd], -1)
    if 1 in mappings or 2 in mappings:
        pt = _map_p3(w2t, p)
        vec = normalize(pt)
        phi = vm.spherical_phi(vec)
        if 2 in mappings:
            st = torch.where((mk == 2)[:, None],
                             torch.stack([phi * (1.0 / (2 * vm.PI)), pt[:, 2]], -1), st)
        if 1 in mappings:
            st = torch.where((mk == 1)[:, None],
                             torch.stack([vm.spherical_theta(vec) * (1.0 / vm.PI),
                                          phi * (1.0 / (2 * vm.PI))], -1), st)
    if 3 in mappings:
        st = torch.where((mk == 3)[:, None], torch.stack(
            [dot(p, w2t[:, 0, :3]) + ud, dot(p, w2t[:, 1, :3]) + vd], -1), st)
    return st


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

_MARBLE_COLORS = np.array([
    [0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.58, 0.58, 0.6],
    [0.5, 0.5, 0.5], [0.6, 0.59, 0.58], [0.58, 0.58, 0.6],
    [0.58, 0.58, 0.6], [0.2, 0.2, 0.33], [0.58, 0.58, 0.6]], np.float32)


def _marble_spline(t):
    c = torch.as_tensor(_MARBLE_COLORS, device=t.device)
    x = torch.clamp(t, 0.0, 0.9999) * (c.shape[0] - 3)
    xi = torch.floor(x)
    # a NaN t (a point at infinity) makes NaN colours, not a bad index
    i = torch.clamp(torch.nan_to_num(xi), 0, c.shape[0] - 4).to(torch.int64)
    f = (x - xi)[..., None]
    s0 = vm.lerp(f, c[i], c[i + 1])
    s1 = vm.lerp(f, c[i + 1], c[i + 2])
    s2 = vm.lerp(f, c[i + 2], c[i + 3])
    return 1.5 * vm.lerp(f, vm.lerp(f, s0, s1), vm.lerp(f, s1, s2))


def eval_texture(tex: TextureTable, tex_id, uv, p, depth: int = MAX_TEX_DEPTH,
                 duv=None, kinds=None, level: int = 0):
    """[N, 3] value of per-lane texture ids (-1: zeros) at hits with uv
    [N, 2] and world points p [N, 3]; duv, the uv screen derivatives
    (dudx, dvdx, dudy, dvdy), selects the EWA image lookup over level-0
    bilinear. kinds: the kind ids present (None: all); level: the child
    level of these ids (0 at the top)."""
    kset = frozenset(range(14) if kinds is None else kinds)

    def has(*ks):
        return any(k in kset for k in ks)

    tid = torch.clamp(tex_id, min=0).to(torch.int64)
    params = tex.params[tid]
    const_rgb = params[:, 0:3]
    if depth <= 0 or not (kset - {T_CONSTANT}):
        return torch.where((tex_id < 0)[:, None], 0.0, const_rgb)
    kind = tex.kind[tid]
    w2t = tex.w2t[tid]

    if has(*_CHILD_KINDS):
        child = tex.child[tid]
        below = kset & frozenset(tex.child_kinds[level]) if level < len(tex.child_kinds) else ()
        c1 = torch.where((child[:, 0] >= 0)[:, None],
                         eval_texture(tex, child[:, 0], uv, p, depth - 1, duv, below, level + 1),
                         params[:, 0:3])
        c2 = torch.where((child[:, 1] >= 0)[:, None],
                         eval_texture(tex, child[:, 1], uv, p, depth - 1, duv, below, level + 1),
                         params[:, 3:6])
    st = _map_st(params, w2t, uv, p, tex.mappings) if has(*_ST_KINDS) else None
    p3 = _map_p3(w2t, p) if has(*_P3_KINDS) else None

    def put(k, value, out):
        return torch.where((kind == k)[:, None], value, out)

    out = const_rgb
    if has(T_SCALE):
        out = put(T_SCALE, c1 * c2, out)
    if has(T_MIX):
        amt = params[:, 11:12]
        out = put(T_MIX, (1.0 - amt) * c1 + amt * c2, out)
    if has(T_BILERP):
        v00, v01, v10 = params[:, 0:3], params[:, 3:6], params[:, 13:16]
        v11 = params[:, 11:12].expand(-1, 3)
        su, tv = st[:, 0:1], st[:, 1:2]
        out = put(T_BILERP, (1 - su) * (1 - tv) * v00 + (1 - su) * tv * v01
                  + su * (1 - tv) * v10 + su * tv * v11, out)
    if has(T_UV):
        out = put(T_UV, torch.stack([st[:, 0] - torch.floor(st[:, 0]),
                                     st[:, 1] - torch.floor(st[:, 1]),
                                     torch.zeros_like(st[:, 0])], -1), out)
    if has(T_CHECKER2D):
        check2 = torch.remainder(torch.floor(st[:, 0]) + torch.floor(st[:, 1]), 2.0)
        out = put(T_CHECKER2D, torch.where((check2 == 0)[:, None], c1, c2), out)
    if has(T_CHECKER3D):
        check3 = torch.remainder(torch.floor(p3[:, 0]) + torch.floor(p3[:, 1])
                                 + torch.floor(p3[:, 2]), 2.0)
        out = put(T_CHECKER3D, torch.where((check3 == 0)[:, None], c1, c2), out)
    if has(T_DOTS):
        # one random dot per integer cell
        scell = torch.floor(st[:, 0] + 0.5).to(torch.int32)
        tcell = torch.floor(st[:, 1] + 0.5).to(torch.int32)
        su, tu = u32(scell), u32(tcell)
        h1, h2, h3 = (u32_to_float(hash3(su, tu, k)) for k in (1, 2, 3))
        radius = 0.35
        ds = st[:, 0] - (scell + (-0.5 + radius) + (1.0 - 2 * radius) * h2)
        dt = st[:, 1] - (tcell + (-0.5 + radius) + (1.0 - 2 * radius) * h3)
        inside = (h1 < 0.5) & (ds * ds + dt * dt < radius * radius)
        out = put(T_DOTS, torch.where(inside[:, None], c1, c2), out)
    if has(T_FBM):
        out = put(T_FBM, fbm(p3, 0.5, OCTAVES)[:, None].expand(-1, 3), out)
    if has(T_WRINKLED):
        out = put(T_WRINKLED, turbulence(p3, 0.5, OCTAVES)[:, None].expand(-1, 3), out)
    if has(T_WINDY):
        wind = torch.abs(fbm(0.1 * p3, 0.5, 3)) * fbm(p3, 0.5, 6)
        out = put(T_WINDY, wind[:, None].expand(-1, 3), out)
    if has(T_MARBLE):
        variation = torch.where(params[:, 11] == 0.0, 0.2, params[:, 11])
        scale_m = torch.where(params[:, 13] == 0.0, 1.0, params[:, 13])
        tmarb = torch.clamp(0.5 + 0.5 * torch.sin(
            scale_m * p3[:, 1] + variation * turbulence(p3 * scale_m[:, None], 0.5, OCTAVES)),
            0.0, 1.0)
        out = put(T_MARBLE, _marble_spline(tmarb), out)
    if tex.atlas.shape[0] > 0 and has(T_IMAGEMAP):
        from pbrt_tpu_torch.textures.image import sample_atlas, sample_atlas_aniso
        if duv is None:
            img = sample_atlas(tex, tid, st)
        else:
            us, vs = params[:, 7], params[:, 8]
            dst0 = torch.stack([duv[0] * us, duv[1] * vs], -1)
            dst1 = torch.stack([duv[2] * us, duv[3] * vs], -1)
            img = sample_atlas_aniso(tex, tid, st, dst0, dst1)
        out = put(T_IMAGEMAP, img, out)
    return torch.where((tex_id < 0)[:, None], 0.0, out)
