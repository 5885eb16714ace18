"""Perspective camera: film samples -> world-space rays (port of the
perspective path of pbrt_tpu/cameras/__init__.py). Orthographic,
environment and realistic cameras, depth of field and a moving camera raise
NotImplementedError."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from pbrt_tpu_torch.core.math import normalize, xform_point, xform_vector
from pbrt_tpu_torch.core.transform import perspective, scale, translate


@dataclasses.dataclass(frozen=True, eq=False)
class CameraSpec:
    kind: str
    raster_to_camera: np.ndarray   # [4,4]
    cam_to_world: np.ndarray       # [4,4]
    shutter_open: float = 0.0
    shutter_close: float = 1.0
    resolution: Tuple[int, int] = (640, 480)


def _screen_window(aspect, given=None):
    if given is not None:
        return tuple(given)
    if aspect > 1.0:
        return (-aspect, aspect, -1.0, 1.0)
    return (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect)


def make_camera(kind: str, params: dict, cam_to_world, resolution) -> CameraSpec:
    """From a .pbrt Camera ParamSet dict; cam_to_world is the (start, end)
    Transform pair."""
    if kind != "perspective":
        raise NotImplementedError(f"camera {kind!r} is not ported")
    if float(params.get("lensradius", [0.0])[0]) > 0.0:
        raise NotImplementedError("camera parameter 'lensradius' (depth of field) is not ported")
    start, end = cam_to_world
    if not np.allclose(start.m, end.m):
        raise NotImplementedError("a moving camera (animated CameraToWorld) is not ported")
    aspect = float(params.get("frameaspectratio", [resolution[0] / resolution[1]])[0])
    x0, x1, y0, y1 = _screen_window(aspect, params.get("screenwindow"))
    fov = float(params.get("fov", [90.0])[0])
    if params.get("halffov") is not None:
        fov = 2.0 * float(params["halffov"][0])
    s2r = (scale([resolution[0], resolution[1], 1.0])
           * scale([1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0])
           * translate([-x0, -y1, 0.0]))
    r2c = perspective(fov, 1e-2, 1000.0).inverse() * s2r.inverse()
    return CameraSpec(kind, r2c.m, start.m,
                      float(params.get("shutteropen", [0.0])[0]),
                      float(params.get("shutterclose", [1.0])[0]), tuple(resolution))


def generate_rays(spec: CameraSpec, p_film):
    """[N,2] raster positions -> world rays (o [N,3], d [N,3]), weight [N]."""
    n = p_film.shape[0]
    p3 = torch.cat([p_film, torch.zeros((n, 1), dtype=p_film.dtype, device=p_film.device)], -1)
    m = spec.raster_to_camera
    w = (float(m[3, 0]) * p3[:, 0] + float(m[3, 1]) * p3[:, 1]
         + float(m[3, 2]) * p3[:, 2] + float(m[3, 3]))
    d = normalize(xform_point(m, p3) / w[:, None])
    o = torch.zeros_like(d)
    c2w = spec.cam_to_world
    return xform_point(c2w, o), xform_vector(c2w, d), torch.ones_like(w)
