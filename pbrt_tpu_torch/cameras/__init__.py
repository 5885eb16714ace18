"""Perspective and orthographic cameras: film samples -> world-space rays
(port of those paths of pbrt_tpu/cameras/__init__.py, ray differentials
and depth of field included). Environment and realistic cameras and a
moving camera raise NotImplementedError.

Depth of field (`lensradius` > 0) moves each ray's origin to a point of
the lens disk and aims it at the ray's point on the plane of focus
(`focaldistance`), as the reference's _lens_offset does. The orthographic
camera keeps its differentials lens-free, as the reference does: their
origins are the unlensed raster points and their direction the lensed
ray's (pbrt-v3 offsets them too)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pbrt_tpu_torch.core.math import normalize, xform_point, xform_vector
from pbrt_tpu_torch.core.ray import Rays
from pbrt_tpu_torch.core.sampling import concentric_sample_disk
from pbrt_tpu_torch.core.transform import apply_point, orthographic, perspective, scale, translate


@dataclasses.dataclass(frozen=True, eq=False)
class CameraSpec:
    """world_to_camera, the float64 inverse of cam_to_world rounded to
    float32, is derived at construction where it is not given (BDPT
    projects points to the film with it)."""
    kind: str
    raster_to_camera: np.ndarray   # [4,4]
    cam_to_world: np.ndarray       # [4,4]
    shutter_open: float = 0.0
    shutter_close: float = 1.0
    resolution: Tuple[int, int] = (640, 480)
    lens_radius: float = 0.0
    focal_distance: float = 1e6
    camera_to_raster: Optional[np.ndarray] = None   # [4,4], the float64 inverse of raster_to_camera
    screen_area: float = 1.0       # area of the film's window on the z = 1 plane (perspective)
    world_to_camera: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.world_to_camera is None:
            w2c = np.linalg.inv(np.asarray(self.cam_to_world, np.float64)).astype(np.float32)
            object.__setattr__(self, "world_to_camera", w2c)


def _screen_window(aspect, given=None):
    if given is not None:
        return tuple(given)
    if aspect > 1.0:
        return (-aspect, aspect, -1.0, 1.0)
    return (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect)


def make_camera(kind: str, params: dict, cam_to_world, resolution) -> CameraSpec:
    """From a .pbrt Camera ParamSet dict; cam_to_world is the (start, end)
    Transform pair."""
    if kind not in ("perspective", "orthographic"):
        raise NotImplementedError(f"camera {kind!r} is not ported")
    start, end = cam_to_world
    if not np.allclose(start.m, end.m):
        raise NotImplementedError("a moving camera (animated CameraToWorld) is not ported")
    aspect = float(params.get("frameaspectratio", [resolution[0] / resolution[1]])[0])
    x0, x1, y0, y1 = _screen_window(aspect, params.get("screenwindow"))
    if kind == "perspective":
        fov = float(params.get("fov", [90.0])[0])
        if params.get("halffov") is not None:
            fov = 2.0 * float(params["halffov"][0])
        c2s = perspective(fov, 1e-2, 1000.0)
    else:
        c2s = orthographic(0.0, 1.0)
    s2r = (scale([resolution[0], resolution[1], 1.0])
           * scale([1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0])
           * translate([-x0, -y1, 0.0]))
    r2c = c2s.inverse() * s2r.inverse()
    pmin = apply_point(r2c.m, np.zeros(3))
    pmax = apply_point(r2c.m, np.array([resolution[0], resolution[1], 0.0]))
    if kind == "perspective":
        pmin = pmin / pmin[2]
        pmax = pmax / pmax[2]
    return CameraSpec(kind, r2c.m, start.m,
                      float(params.get("shutteropen", [0.0])[0]),
                      float(params.get("shutterclose", [1.0])[0]), tuple(resolution),
                      float(params.get("lensradius", [0.0])[0]),
                      float(params.get("focaldistance", [1e6])[0]),
                      np.linalg.inv(r2c.m.astype(np.float64)).astype(np.float32),
                      float(abs((pmax[0] - pmin[0]) * (pmax[1] - pmin[1]))))


def _raster_point(m, p3):
    """Camera-space points of raster points p3 [N,3]."""
    w = (float(m[3, 0]) * p3[:, 0] + float(m[3, 1]) * p3[:, 1]
         + float(m[3, 2]) * p3[:, 2] + float(m[3, 3]))
    return xform_point(m, p3) / w[:, None]


def _lens_offset(spec, p_lens, o, d):
    """Camera-space rays (o, d) moved to lens points p_lens [N,2] (already
    scaled by the lens radius) and aimed at their point on the plane of
    focus -> (origin, direction)."""
    ft = torch.full_like(d[:, 2], spec.focal_distance) / d[:, 2]
    p_focus = o + d * ft[:, None]
    o2 = torch.cat([p_lens, torch.zeros_like(p_lens[:, :1])], -1)
    return o2, normalize(p_focus - o2)


def generate_rays(spec: CameraSpec, p_film, differentials: bool = False, u_lens=None):
    """[N,2] raster positions -> (world Rays [N], weight [N]); with
    differentials, the rays through the raster points one pixel over in x
    and in y ride along (the reference's generate_ray_differential). A
    perspective ray leaves the eye through the raster point; an
    orthographic one leaves the raster point along +z. u_lens [N,2], the
    lens sample, is read where the lens radius is over 0."""
    n = p_film.shape[0]
    p3 = torch.cat([p_film, torch.zeros((n, 1), dtype=p_film.dtype, device=p_film.device)], -1)
    m, c2w = spec.raster_to_camera, spec.cam_to_world
    step = torch.eye(3, dtype=p3.dtype, device=p3.device) if differentials else None
    lens = spec.lens_radius > 0.0
    p_lens = spec.lens_radius * concentric_sample_disk(u_lens) if lens else None
    if spec.kind == "orthographic":
        o = _raster_point(m, p3)
        d = torch.zeros_like(p3)
        d[:, 2] = 1.0
        if lens:
            o, d = _lens_offset(spec, p_lens, o, d)
        rays = Rays(xform_point(c2w, o), xform_vector(c2w, d))
        if differentials:
            rays.rx_o = xform_point(c2w, _raster_point(m, p3 + step[0]))
            rays.ry_o = xform_point(c2w, _raster_point(m, p3 + step[1]))
            rays.rx_d = rays.ry_d = rays.d
        return rays, torch.ones(n, dtype=p_film.dtype, device=p_film.device)
    d = normalize(_raster_point(m, p3))
    o_cam = torch.zeros_like(d)
    if lens:
        o_cam, d = _lens_offset(spec, p_lens, o_cam, d)
    o = xform_point(c2w, o_cam)
    rays = Rays(o, xform_vector(c2w, d))
    if differentials:
        for axis in (0, 1):
            dd = normalize(_raster_point(m, p3 + step[axis]))
            od = o
            if lens:
                # the reference aims from the main ray's lens point
                od, dd = _lens_offset(spec, p_lens, o_cam, dd)
                od = xform_point(c2w, od)
            setattr(rays, "rx_o" if axis == 0 else "ry_o", od)
            setattr(rays, "rx_d" if axis == 0 else "ry_d", xform_vector(c2w, dd))
    return rays, torch.ones(n, dtype=p_film.dtype, device=p_film.device)
