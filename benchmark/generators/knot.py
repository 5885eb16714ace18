"""The knot generator: the trefoil tube of the repository's bench scenes
(a NumPy copy of `make_knot_mesh`), written as a binary little-endian PLY
file with area-weighted vertex normals and uv = (i / n_u, j / n_v), as
`write_knot_ply` writes it. The benchmark keeps its own copy so that a
later change to the program cannot change what is measured.

Parameters: n_u segments along the tube, n_v around it (2 n_u n_v
triangles), scale.
"""
from __future__ import annotations

import numpy as np


def knot_mesh(n_u, n_v, scale):
    """-> (vertices [n_u * n_v, 3] float32, faces [2 n_u n_v, 3] int32)."""
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
    verts = (cx[:, None, :] + 0.4 * (np.cos(v)[None, :, None] * n[:, None, :]
                                     + np.sin(v)[None, :, None] * b[:, None, :]))
    verts = (verts * scale).reshape(-1, 3).astype(np.float32)
    i = np.arange(n_u)[:, None]
    j = np.arange(n_v)[None, :]
    a = i * n_v + j
    bq = i * n_v + (j + 1) % n_v
    c = ((i + 1) % n_u) * n_v + j
    d = ((i + 1) % n_u) * n_v + (j + 1) % n_v
    idx = np.stack([np.stack([a, bq, c], -1), np.stack([bq, d, c], -1)], 2)
    return verts, idx.reshape(-1, 3).astype(np.int32)


def vertex_normals(verts, faces):
    """Area-weighted vertex normals, computed in float64."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = np.zeros_like(v)
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    return (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)).astype(np.float32)


def write_ply(path, verts, faces, normals=None, uv=None):
    """A triangle mesh as a binary little-endian PLY file: x y z [nx ny nz]
    [u v] float vertex properties, uchar/int face lists."""
    cols, names = [verts], ["x", "y", "z"]
    if normals is not None:
        cols, names = cols + [normals], names + ["nx", "ny", "nz"]
    if uv is not None:
        cols, names = cols + [uv], names + ["u", "v"]
    vtab = np.concatenate(cols, 1).astype("<f4")
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            + "".join(f"property float {n}\n" for n in names)
            + f"element face {len(faces)}\nproperty list uchar int vertex_indices\nend_header\n")
    rec = np.zeros(len(faces), np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    rec["n"], rec["i"] = 3, faces
    with open(path, "wb") as f:
        f.write(head.encode("ascii"))
        f.write(vtab.tobytes())
        f.write(rec.tobytes())


def write(path, n_u, n_v, scale=0.45):
    """The knot as a PLY file: x y z nx ny nz u v."""
    verts, faces = knot_mesh(n_u, n_v, scale)
    i, j = np.meshgrid(np.arange(n_u) / n_u, np.arange(n_v) / n_v, indexing="ij")
    uv = np.stack([i.reshape(-1), j.reshape(-1)], -1).astype(np.float32)
    write_ply(path, verts, faces, vertex_normals(verts, faces), uv)


def scaled(params, factor):
    """The parameters with the segment counts scaled (the CPU tests' small
    meshes)."""
    out = dict(params)
    out["n_u"] = max(8, int(params["n_u"] * factor))
    out["n_v"] = max(4, int(params["n_v"] * factor))
    return out
