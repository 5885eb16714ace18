"""Triangle meshes (port of pbrt_tpu/shapes/triangle.py): host mesh build,
the procedural benchmark knot, and per-hit shading geometry on tensors."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pbrt_tpu_torch.core import math as vm
from pbrt_tpu_torch.core.math import cross, normalize


@dataclasses.dataclass
class TriangleMeshData:
    """Host mesh with world-space vertices."""
    indices: np.ndarray              # [T,3] int32
    p: np.ndarray                    # [V,3] f32
    n: Optional[np.ndarray] = None   # [V,3]
    uv: Optional[np.ndarray] = None  # [V,2]
    transform_swaps_handedness: bool = False
    alpha_tex: int = -1              # alpha-mask texture id (-1: none)
    shadow_alpha_tex: int = -1       # the same for shadow rays


def mesh_from_params(ps, object_to_world) -> TriangleMeshData:
    """From a 'trianglemesh' ParamSet (its alpha masks are resolved by
    scene/api.py). Tangents ("vector S") are read and not used, as in the
    reference."""
    params = ps.as_plain_dict()
    indices = np.asarray(params["indices"], np.int32).reshape(-1, 3)
    p = object_to_world.point(np.asarray(params["P"], np.float32).reshape(-1, 3))
    n = params.get("N")
    if n is not None:
        n = object_to_world.normal(np.asarray(n, np.float32).reshape(-1, 3))
    uv = params.get("uv", params.get("st"))
    if uv is not None:
        uv = np.asarray(uv, np.float32).reshape(-1, 2)
    return TriangleMeshData(indices, np.asarray(p, np.float32),
                            None if n is None else np.asarray(n, np.float32), uv,
                            object_to_world.swaps_handedness())


def triangle_shading(b0, b1, b2, tp0, tp1, tp2, tuv):
    """Surface frame of hits: (p, ng, uv, dpdu, dpdv, p_err)."""
    p = b0[:, None] * tp0 + b1[:, None] * tp1 + b2[:, None] * tp2
    uv0, uv1, uv2 = tuv[:, 0], tuv[:, 1], tuv[:, 2]
    uv = b0[:, None] * uv0 + b1[:, None] * uv1 + b2[:, None] * uv2
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    dp02 = tp0 - tp2
    dp12 = tp1 - tp2
    det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
    degenerate = torch.abs(det) < 1e-12
    inv_det = 1.0 / torch.where(degenerate, 1.0, det)
    dpdu = (duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12) * inv_det[:, None]
    dpdv = (-duv12[:, 0:1] * dp02 + duv02[:, 0:1] * dp12) * inv_det[:, None]
    ng = normalize(cross(dp02, dp12))
    t1, t2 = vm.coordinate_system(ng)
    dpdu = torch.where(degenerate[:, None], t1, dpdu)
    dpdv = torch.where(degenerate[:, None], t2, dpdv)
    err = vm.gamma_bound(7) * (torch.abs(b0[:, None] * tp0) + torch.abs(b1[:, None] * tp1)
                               + torch.abs(b2[:, None] * tp2))
    return p, ng, uv, dpdu, dpdv, err


def make_knot_mesh(n_u=256, n_v=48, scale=1.0) -> TriangleMeshData:
    """Trefoil-knot tube, ~n_u*n_v*2 triangles: the benchmark mesh."""
    u = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    cx = np.stack([np.sin(u) + 2 * np.sin(2 * u),
                   np.cos(u) - 2 * np.cos(2 * u),
                   -np.sin(3 * u)], -1)
    t = np.gradient(cx, axis=0)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    b = np.cross(t, np.array([0.0, 0.0, 1.0]))
    b /= np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-9)
    n = np.cross(b, t)
    v = np.linspace(0, 2 * np.pi, n_v, endpoint=False)
    r = 0.4
    verts = (cx[:, None, :] + r * (np.cos(v)[None, :, None] * n[:, None, :]
                                   + np.sin(v)[None, :, None] * b[:, None, :]))
    verts = (verts * scale).reshape(-1, 3).astype(np.float32)
    i = np.arange(n_u)[:, None]
    j = np.arange(n_v)[None, :]
    a = i * n_v + j
    bq = i * n_v + (j + 1) % n_v
    c = ((i + 1) % n_u) * n_v + j
    d = ((i + 1) % n_u) * n_v + (j + 1) % n_v
    idx = np.stack([np.stack([a, bq, c], -1), np.stack([bq, d, c], -1)], 2)
    return TriangleMeshData(idx.reshape(-1, 3).astype(np.int32), verts)
