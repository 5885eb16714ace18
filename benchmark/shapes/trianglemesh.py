"""Shape "trianglemesh": the mesh given inline ("point P", "integer
indices", optional "normal N" and "point2 uv" / "float uv")."""
from __future__ import annotations

import numpy as np


def triangles(params, scene_dir):
    """-> (P [V,3], N [V,3] or None, UV [V,2] or None, faces [F,3]), in
    object space."""
    p = np.asarray(params["P"][1], np.float64).reshape(-1, 3)
    idx = np.asarray(params["indices"][1], np.int64).reshape(-1, 3)
    n = np.asarray(params["N"][1], np.float64).reshape(-1, 3) if "N" in params else None
    uv = np.asarray(params["uv"][1], np.float64).reshape(-1, 2) if "uv" in params else None
    return p, n, uv, idx
