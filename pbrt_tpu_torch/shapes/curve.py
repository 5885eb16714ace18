"""Bezier curves, flat, ribbon and cylinder (port of pbrt_tpu/shapes/curve.py).

Curves are tessellated into triangles when the scene is built, so they
take the same BVH walks as every other mesh: each cubic segment becomes one
triangle mesh of n_seg steps along the curve (and n_rad around a cylinder).
"""
from __future__ import annotations

import numpy as np

from pbrt_tpu_torch.shapes.triangle import TriangleMeshData


def _bezier_eval(cp, u):
    """cp [4,3]; u [n] -> (points [n,3], tangents [n,3])."""
    u = u[:, None]
    a = (1 - u) ** 3 * cp[0] + 3 * (1 - u) ** 2 * u * cp[1] \
        + 3 * (1 - u) * u ** 2 * cp[2] + u ** 3 * cp[3]
    d = 3 * (1 - u) ** 2 * (cp[1] - cp[0]) + 6 * (1 - u) * u * (cp[2] - cp[1]) \
        + 3 * u ** 2 * (cp[3] - cp[2])
    return a, d


def _side(t, ref):
    """Unit vectors across the tangents t [n,3], perpendicular to ref (or,
    where t is parallel to ref, to +x)."""
    side = np.cross(t, ref)
    bad = np.linalg.norm(side, axis=-1) < 1e-6
    side[bad] = np.cross(t[bad], np.array([1.0, 0.0, 0.0]))
    return side


def tessellate_curve(cp, width0, width1, curve_type="cylinder", normals=None,
                     n_seg=32, n_rad=8):
    """One cubic Bezier segment -> (verts, faces, vertex normals or None)."""
    u = np.linspace(0.0, 1.0, n_seg + 1)
    p, t = _bezier_eval(np.asarray(cp, np.float64), u)
    t /= np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    w = (1 - u) * width0 + u * width1
    n = len(u)

    if curve_type in ("flat", "ribbon"):
        # sweep a segment of width w across the tangent
        if normals is not None and curve_type == "ribbon":
            n0, n1 = np.asarray(normals, np.float64)
            th = np.arccos(np.clip(np.dot(n0, n1), -1, 1))
            if th < 1e-6:
                nrm = np.tile(n0, (n, 1))
            else:   # slerp of the two normals along the curve
                nrm = (np.sin((1 - u)[:, None] * th) * n0
                       + np.sin(u[:, None] * th) * n1) / np.sin(th)
            side = np.cross(t, nrm)
        else:
            side = _side(t, np.array([0.0, 0.0, 1.0]))
        side /= np.maximum(np.linalg.norm(side, axis=-1, keepdims=True), 1e-12)
        verts = np.concatenate([p - 0.5 * w[:, None] * side, p + 0.5 * w[:, None] * side])
        i = np.arange(n - 1)
        faces = np.stack([np.stack([i, i + 1, n + i], -1),
                          np.stack([i + 1, n + i + 1, n + i], -1)], 1).reshape(-1, 3)
        return verts.astype(np.float32), faces.astype(np.int32), None

    # cylinder: a circle of n_rad vertices swept along the curve
    b = _side(t, np.array([0.0, 0.0, 1.0]))
    b /= np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    nvec = np.cross(b, t)
    ang = np.linspace(0, 2 * np.pi, n_rad, endpoint=False)
    ring = (np.cos(ang)[None, :, None] * nvec[:, None, :]
            + np.sin(ang)[None, :, None] * b[:, None, :])
    verts = (p[:, None, :] + 0.5 * w[:, None, None] * ring).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n_rad), indexing="ij")
    a0 = i * n_rad + j
    a1 = i * n_rad + (j + 1) % n_rad
    b0 = (i + 1) * n_rad + j
    b1 = (i + 1) * n_rad + (j + 1) % n_rad
    faces = np.stack([np.stack([a0, a1, b0], -1), np.stack([a1, b1, b0], -1)], 2).reshape(-1, 3)
    return (verts.astype(np.float32), faces.astype(np.int32),
            ring.reshape(-1, 3).astype(np.float32))


def curve_records(ps, o2w):
    """A 'curve' ParamSet -> one mesh ShapeRecord per cubic segment, the
    width interpolated between width0 and width1 over the segments."""
    from pbrt_tpu_torch.scene.api import ShapeRecord
    cp = ps.find_point3s("P")
    ctype = ps.find_one_string("type", "flat")
    w0 = ps.find_one_float("width0", ps.find_one_float("width", 1.0))
    w1 = ps.find_one_float("width1", ps.find_one_float("width", 1.0))
    normals = ps.find_point3s("N")
    degree = 3
    n_segments = (cp.shape[0] - 1) // degree
    recs = []
    for s in range(max(1, n_segments)):
        seg = cp[s * degree: s * degree + 4]
        if seg.shape[0] < 4:
            break
        us, ue = s / max(n_segments, 1), (s + 1) / max(n_segments, 1)
        v, f, n = tessellate_curve(seg, (1 - us) * w0 + us * w1, (1 - ue) * w0 + ue * w1,
                                   ctype, normals)
        recs.append(ShapeRecord("trianglemesh", mesh=TriangleMeshData(
            f, np.asarray(o2w.point(v), np.float32),
            None if n is None else np.asarray(o2w.normal(n), np.float32))))
    return recs
