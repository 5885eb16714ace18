"""Shape "plymesh": a binary little-endian PLY file of float vertex
properties (x y z, optional nx ny nz and u v) and uchar/int triangle
lists, named by "string filename" relative to the scene file."""
from __future__ import annotations

import os

import numpy as np


def read_ply(path):
    """-> (P [V,3], N [V,3] or None, UV [V,2] or None, faces [F,3])."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    if "format binary_little_endian 1.0" not in header:
        raise ValueError(f"{path}: only binary little-endian PLY is read")
    props, n_vert, n_face = [], 0, 0
    for line in header:
        w = line.split()
        if w[:2] == ["element", "vertex"]:
            n_vert = int(w[2])
        elif w[:2] == ["element", "face"]:
            n_face = int(w[2])
        elif w[:2] == ["property", "float"]:
            props.append(w[2])
        elif w[:3] == ["property", "list", "uchar"] and w[3] != "int":
            raise ValueError(f"{path}: face indices must be int")
    vtab = np.frombuffer(data, "<f4", n_vert * len(props), end).reshape(n_vert, len(props))
    rec = np.frombuffer(data, np.dtype([("n", "u1"), ("i", "<i4", (3,))]), n_face,
                        end + 4 * n_vert * len(props))
    if (rec["n"] != 3).any():
        raise ValueError(f"{path}: only triangle faces are read")
    col = {p: k for k, p in enumerate(props)}
    pick = lambda names: (vtab[:, [col[n] for n in names]].astype(np.float64)
                          if all(n in col for n in names) else None)
    return pick("xyz"), pick(["nx", "ny", "nz"]), pick("uv"), rec["i"].astype(np.int64)


def triangles(params, scene_dir):
    return read_ply(os.path.join(scene_dir, params["filename"][1][0]))
