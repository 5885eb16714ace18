"""PLY mesh reader and writer (the port's copy of pbrt_tpu/shapes/ply.py).

Reads ascii and binary little/big endian files: vertex properties x/y/z,
nx/ny/nz and u/v (or s/t, texture_u/texture_v), and face lists, with
polygons fanned to triangles. A binary face element whose only property
is a vertex-index list of 3 on every face is read in one numpy pass; any
other layout takes the per-face loop. Both give the same arrays.
"""
from __future__ import annotations

import numpy as np

_TYPES = {
    "char": ("i1", 1), "int8": ("i1", 1),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "short": ("i2", 2), "int16": ("i2", 2),
    "ushort": ("u2", 2), "uint16": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
}
_INDEX_LISTS = ("vertex_indices", "vertex_index")


def read_ply(path: str):
    """-> (verts [V,3], normals [V,3] | None, uv [V,2] | None, faces [F,3])."""
    with open(path, "rb") as fh:
        data = fh.read()
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError("not a PLY file (no end_header)")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end + len(b"end_header\n"):]
    fmt = "ascii"
    elements = []  # (name, count, [(ptype, name) or ('list', ctype, itype, name)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[1], parts[2]))

    verts = normals = uv = None
    faces = []
    if fmt == "ascii":
        toks = body.decode("ascii", "replace").split()
        ti = 0
        for name, count, props in elements:
            if name == "vertex":
                cols = [p[1] for p in props]
                arr = np.array(toks[ti:ti + count * len(cols)], np.float64).reshape(count, len(cols))
                ti += count * len(cols)
                verts, normals, uv = _extract_vertex(arr, cols)
            elif name == "face":
                for _ in range(count):
                    n = int(toks[ti])
                    ti += 1
                    idx = [int(toks[ti + k]) for k in range(n)]
                    ti += n
                    for k in range(1, n - 1):
                        faces.append([idx[0], idx[k], idx[k + 1]])
            else:
                for _ in range(count):
                    for p in props:
                        ti += 1 + int(toks[ti]) if p[0] == "list" else 1
    else:
        endian = "<" if "little" in fmt else ">"
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[0] != "list" for p in props):
                dtype = np.dtype([(p[1], endian + _TYPES[p[0]][0]) for p in props])
                arr = np.frombuffer(body, dtype, count, off)
                off += dtype.itemsize * count
                cols = [p[1] for p in props]
                mat = np.stack([arr[c].astype(np.float64) for c in cols], -1)
                verts, normals, uv = _extract_vertex(mat, cols)
            elif name == "face":
                tris, off = _triangle_faces(body, off, count, props, endian)
                if tris is not None:
                    faces.append(tris)
                    continue
                for _ in range(count):
                    for p in props:
                        if p[0] == "list":
                            ct, it = _TYPES[p[1]], _TYPES[p[2]]
                            n = int(np.frombuffer(body, endian + ct[0], 1, off)[0])
                            off += ct[1]
                            idx = np.frombuffer(body, endian + it[0], n, off).astype(np.int64)
                            off += it[1] * n
                            if p[3] in _INDEX_LISTS:
                                for k in range(1, n - 1):
                                    faces.append([idx[0], idx[k], idx[k + 1]])
                        else:
                            off += _TYPES[p[0]][1]
            else:
                for _ in range(count):
                    for p in props:
                        if p[0] == "list":
                            ct, it = _TYPES[p[1]], _TYPES[p[2]]
                            n = int(np.frombuffer(body, endian + ct[0], 1, off)[0])
                            off += ct[1] + it[1] * n
                        else:
                            off += _TYPES[p[0]][1]
    faces = np.concatenate(faces) if faces and isinstance(faces[0], np.ndarray) else faces
    return (np.asarray(verts, np.float32),
            None if normals is None else np.asarray(normals, np.float32),
            None if uv is None else np.asarray(uv, np.float32),
            np.asarray(faces, np.int32).reshape(-1, 3))


def _triangle_faces(body, off, count, props, endian):
    """A binary face element of one index list with 3 entries on every face
    -> (faces [F,3] int64, offset past it); otherwise (None, off)."""
    if len(props) != 1 or props[0][0] != "list" or props[0][3] not in _INDEX_LISTS:
        return None, off
    ct, it = _TYPES[props[0][1]], _TYPES[props[0][2]]
    dtype = np.dtype([("n", endian + ct[0]), ("i", endian + it[0], (3,))])
    if off + dtype.itemsize * count > len(body):
        return None, off
    arr = np.frombuffer(body, dtype, count, off)
    if not np.all(arr["n"] == 3):
        return None, off
    return arr["i"].astype(np.int64), off + dtype.itemsize * count


def _extract_vertex(arr, cols):
    ci = {c: i for i, c in enumerate(cols)}
    verts = np.stack([arr[:, ci["x"]], arr[:, ci["y"]], arr[:, ci["z"]]], -1)
    normals = uv = None
    if all(k in ci for k in ("nx", "ny", "nz")):
        normals = np.stack([arr[:, ci["nx"]], arr[:, ci["ny"]], arr[:, ci["nz"]]], -1)
    for ukey, vkey in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if ukey in ci and vkey in ci:
            uv = np.stack([arr[:, ci[ukey]], arr[:, ci[vkey]]], -1)
            break
    return verts, normals, uv


def write_ply(path, verts, faces, normals=None, uv=None, fmt="ascii"):
    """Write float vertices (with optional normals and uv) and polygon
    faces [F,k] as a PLY file; fmt is "ascii", "binary_little_endian" or
    "binary_big_endian". Face lists are uchar counts and int indices."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    cols = [verts]
    names = ["x", "y", "z"]
    if normals is not None:
        cols.append(np.asarray(normals, np.float32))
        names += ["nx", "ny", "nz"]
    if uv is not None:
        cols.append(np.asarray(uv, np.float32))
        names += ["u", "v"]
    vtab = np.concatenate(cols, 1)
    head = [f"ply\nformat {fmt} 1.0\nelement vertex {len(verts)}\n"]
    head += [f"property float {n}\n" for n in names]
    head.append(f"element face {len(faces)}\n"
                "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write("".join(head).encode("ascii"))
        if fmt == "ascii":
            for row in vtab:
                f.write((" ".join(repr(float(x)) for x in row) + "\n").encode("ascii"))
            for fc in faces:
                f.write((f"{len(fc)} " + " ".join(str(int(i)) for i in fc) + "\n").encode("ascii"))
            return
        e = "<" if fmt == "binary_little_endian" else ">"
        f.write(vtab.astype(e + "f4").tobytes())
        k = faces.shape[1]
        rec = np.zeros(len(faces), np.dtype([("n", "u1"), ("i", e + "i4", (k,))]))
        rec["n"], rec["i"] = k, faces
        f.write(rec.tobytes())
