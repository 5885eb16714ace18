"""Loop subdivision surfaces -> triangle mesh, on the host (the port's copy
of pbrt_tpu/shapes/loopsubdiv.py).

Per level, one new vertex per edge and Loop's vertex masks for the old
vertices, with the boundary rules; float64 inside. The result is a plain
triangle mesh with area-weighted vertex normals.
"""
from __future__ import annotations

import numpy as np


def loop_subdivide(verts: np.ndarray, faces: np.ndarray, levels: int):
    """-> (vertices [V',3] f32, faces [F',3] i32, normals [V',3] f32)."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    for _ in range(max(0, int(levels))):
        v, f = _subdivide_once(v, f)
    n = _vertex_normals(v, f)
    return v.astype(np.float32), f.astype(np.int32), n.astype(np.float32)


def _edge_key(a, b):
    return np.minimum(a, b).astype(np.int64) * (1 << 32) + np.maximum(a, b)


def _subdivide_once(v, f):
    nv = v.shape[0]
    all_edges = np.concatenate([_edge_key(f[:, 0], f[:, 1]), _edge_key(f[:, 1], f[:, 2]),
                                _edge_key(f[:, 2], f[:, 0])])
    uniq, inv, counts = np.unique(all_edges, return_inverse=True, return_counts=True)
    n_edges = uniq.shape[0]
    boundary_edge = counts == 1
    ea = (uniq >> 32).astype(np.int64)
    eb = (uniq & 0xFFFFFFFF).astype(np.int64)

    # the vertex opposite each edge in each of its faces, summed per edge
    thirds = np.concatenate([f[:, 2], f[:, 0], f[:, 1]])
    opp_accum = np.zeros((n_edges, 3))
    np.add.at(opp_accum, inv, v[thirds])

    # new edge vertices: interior 3/8 (a + b) + 1/8 (c + d); boundary (a + b) / 2
    mid = 0.5 * (v[ea] + v[eb])
    interior = (3.0 / 8.0) * (v[ea] + v[eb]) + (1.0 / 8.0) * opp_accum
    edge_verts = np.where(boundary_edge[:, None], mid, interior)

    # old vertices: Loop's beta over all edge neighbours; on the boundary
    # 3/4 self + 1/8 each boundary-edge neighbour
    valence = np.zeros(nv, np.int64)
    neigh_sum = np.zeros((nv, 3))
    np.add.at(valence, ea, 1)
    np.add.at(valence, eb, 1)
    np.add.at(neigh_sum, ea, v[eb])
    np.add.at(neigh_sum, eb, v[ea])
    b_valence = np.zeros(nv, np.int64)
    b_sum = np.zeros((nv, 3))
    bea, beb = ea[boundary_edge], eb[boundary_edge]
    np.add.at(b_valence, bea, 1)
    np.add.at(b_valence, beb, 1)
    np.add.at(b_sum, bea, v[beb])
    np.add.at(b_sum, beb, v[bea])
    is_boundary_v = b_valence > 0

    val = np.maximum(valence, 1)
    beta = np.where(val == 3, 3.0 / 16.0, 3.0 / (8.0 * val))
    interior_new = v * (1.0 - val * beta)[:, None] + beta[:, None] * neigh_sum
    boundary_new = 0.75 * v + 0.125 * b_sum
    v_new_old = np.where(is_boundary_v[:, None], boundary_new, interior_new)

    new_v = np.concatenate([v_new_old, edge_verts])
    # each face -> 4
    F = len(f)
    i01, i12, i20 = nv + inv[:F], nv + inv[F:2 * F], nv + inv[2 * F:]
    new_f = np.concatenate([np.stack([f[:, 0], i01, i20], -1), np.stack([f[:, 1], i12, i01], -1),
                            np.stack([f[:, 2], i20, i12], -1), np.stack([i01, i12, i20], -1)])
    return new_v, new_f


def _vertex_normals(v, f):
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = np.zeros_like(v)
    np.add.at(n, f[:, 0], fn)
    np.add.at(n, f[:, 1], fn)
    np.add.at(n, f[:, 2], fn)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(ln, 1e-12)
