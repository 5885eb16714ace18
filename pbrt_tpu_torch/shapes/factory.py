"""Shape name -> ShapeRecords (port of pbrt_tpu/shapes/factory.py::make_shapes):
triangle meshes inline, from PLY files or from Loop subdivision; the six
quadrics; Bezier curves, tessellated into meshes."""
from __future__ import annotations

import logging
import os

import numpy as np

from pbrt_tpu_torch.shapes import quadrics as Q

QUADRIC_KINDS = frozenset(Q.KIND_NAMES)


def make_shapes(kind: str, ps, o2w, cwd: str = "."):
    """The records of one Shape directive under object-to-world o2w; a PLY
    file that is missing is logged and gives none. Alpha masks on a
    loopsubdiv surface raise NotImplementedError."""
    from pbrt_tpu_torch.scene.api import ShapeRecord
    from pbrt_tpu_torch.shapes.triangle import TriangleMeshData, mesh_from_params
    if kind in QUADRIC_KINDS:
        qt, qp, area = Q.build_quadric(kind, ps.as_plain_dict())
        return [ShapeRecord(kind, quad_type=qt, quad_params=qp, quad_area=area,
                            o2w=o2w.m.copy(), w2o=o2w.m_inv.copy())]
    if kind == "curve":
        from pbrt_tpu_torch.shapes.curve import curve_records
        return curve_records(ps, o2w)
    if kind == "trianglemesh":
        return [ShapeRecord("trianglemesh", mesh=mesh_from_params(ps, o2w))]
    if kind not in ("plymesh", "loopsubdiv"):
        raise ValueError(f"unknown shape kind {kind!r}")
    for name in ("alpha", "shadowalpha"):
        if kind == "loopsubdiv" and name in ps:
            raise NotImplementedError(f"{kind} parameter {name!r} is not ported")
    if kind == "plymesh":
        from pbrt_tpu_torch.shapes.ply import read_ply
        fname = ps.find_one_string("filename", "")
        path = fname if os.path.isabs(fname) else os.path.join(cwd, fname)
        if not os.path.exists(path):
            logging.getLogger(__name__).warning("PLY not found: %s", path)
            return []
        v, n, uv, f = read_ply(path)
    else:
        from pbrt_tpu_torch.shapes.loopsubdiv import loop_subdivide
        levels = ps.find_one_int("levels", ps.find_one_int("nlevels", 3))
        v, f, n = loop_subdivide(ps.find_point3s("P"), ps.find_ints("indices").reshape(-1, 3),
                                 levels)
        uv = None
    mesh = TriangleMeshData(f.astype(np.int32), np.asarray(o2w.point(v), np.float32),
                            None if n is None else np.asarray(o2w.normal(n), np.float32),
                            uv, o2w.swaps_handedness())
    return [ShapeRecord("trianglemesh", mesh=mesh)]
