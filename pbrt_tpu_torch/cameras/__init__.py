"""Cameras: film samples -> world-space rays (port of
pbrt_tpu/cameras/__init__.py): perspective and orthographic with ray
differentials and depth of field, the environment camera and the
realistic camera (cameras/realistic.py), each fixed or moving over the
shutter.

Depth of field (`lensradius` > 0) moves each ray's origin to a point of
the lens disk and aims it at the ray's point on the plane of focus
(`focaldistance`), as the reference's _lens_offset does. The orthographic
camera keeps its differentials lens-free, as the reference does: their
origins are the unlensed raster points and their direction the lensed
ray's (pbrt-v3 offsets them too). The environment and realistic cameras
give no differentials.

A camera whose CameraToWorld differs at the shutter's end moves: every ray,
its differentials included, is taken to world by the matrix interpolated
at the lane's shutter-mapped time (`motion`, an AnimatedTransform over
times 0 and 1, as the reference builds it). `cam_to_world` and
`world_to_camera` stay the start transform's, which BDPT reads."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pbrt_tpu_torch.core.math import normalize, xform_point, xform_vector
from pbrt_tpu_torch.core.ray import Rays
from pbrt_tpu_torch.core.sampling import concentric_sample_disk
from pbrt_tpu_torch.core.transform import (AnimatedTransform, apply_point, orthographic,
                                           perspective, scale, translate)


@dataclasses.dataclass(frozen=True, eq=False)
class CameraSpec:
    """world_to_camera, the float64 inverse of cam_to_world rounded to
    float32, is derived at construction where it is not given (BDPT
    projects points to the film with it)."""
    kind: str
    raster_to_camera: Optional[np.ndarray]   # [4,4]; None for environment and realistic
    cam_to_world: np.ndarray       # [4,4] at the shutter's start
    shutter_open: float = 0.0
    shutter_close: float = 1.0
    resolution: Tuple[int, int] = (640, 480)
    lens_radius: float = 0.0
    focal_distance: float = 1e6
    camera_to_raster: Optional[np.ndarray] = None   # [4,4], the float64 inverse of raster_to_camera
    screen_area: float = 1.0       # area of the film's window on the z = 1 plane (perspective)
    world_to_camera: Optional[np.ndarray] = None
    motion: Optional[AnimatedTransform] = None   # a moving camera's keyframes
    # the realistic camera: [n,4] lens rows (curvature radius, thickness,
    # eta, aperture radius; metres) front to rear, focused; [32,4] exit
    # pupil bounds per film radius bin
    lens_elements: Optional[np.ndarray] = None
    exit_pupil: Optional[np.ndarray] = None
    simple_weighting: bool = True

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
    start, end = cam_to_world
    motion = AnimatedTransform(start, 0.0, end, 1.0)
    common = dict(kind=kind, cam_to_world=start.m,
                  shutter_open=float(params.get("shutteropen", [0.0])[0]),
                  shutter_close=float(params.get("shutterclose", [1.0])[0]),
                  resolution=tuple(resolution), motion=motion if motion.animated else None)
    aspect = float(params.get("frameaspectratio", [resolution[0] / resolution[1]])[0])
    sw = _screen_window(aspect, params.get("screenwindow"))
    if kind == "environment":
        return CameraSpec(raster_to_camera=None, **common)
    if kind == "realistic":
        from pbrt_tpu_torch.cameras import realistic
        lens, pupil = realistic.focus_lens_system(
            realistic.load_lens_system(params), float(params.get("focusdistance", [10.0])[0]))
        return CameraSpec(raster_to_camera=None, lens_elements=lens, exit_pupil=pupil,
                          focal_distance=float(params.get("focusdistance", [10.0])[0]),
                          simple_weighting=bool(params.get("simpleweighting", [True])[0]),
                          **common)
    if kind not in ("perspective", "orthographic"):
        raise ValueError(f"unknown camera kind {kind!r}")
    x0, x1, y0, y1 = sw
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
    return CameraSpec(raster_to_camera=r2c.m,
                      lens_radius=float(params.get("lensradius", [0.0])[0]),
                      focal_distance=float(params.get("focaldistance", [1e6])[0]),
                      camera_to_raster=np.linalg.inv(r2c.m.astype(np.float64)).astype(np.float32),
                      screen_area=float(abs((pmax[0] - pmin[0]) * (pmax[1] - pmin[1]))),
                      **common)


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


def _to_world(spec, time, ray_fields):
    """Camera-space ray fields (points and vectors, None kept) -> world:
    by the start matrix, or per lane by the matrix interpolated at time. A
    field that is the main ray's own tensor (a differential's unlensed
    origin) takes the main ray's result."""
    if spec.motion is None:
        c2w = spec.cam_to_world
        xf = lambda v, point: xform_point(c2w, v) if point else xform_vector(c2w, v)
    else:
        m = spec.motion.interpolate(time)

        def xf(v, point):
            rows = [m[:, i, 0] * v[:, 0] + m[:, i, 1] * v[:, 1] + m[:, i, 2] * v[:, 2]
                    for i in range(3)]
            if point:
                rows = [r + m[:, i, 3] for i, r in enumerate(rows)]
            return torch.stack(rows, -1)
    out = {}
    for k, v in ray_fields.items():
        same = [j for j, u in ray_fields.items() if u is v and j in out]
        out[k] = out[same[0]] if same else (None if v is None else xf(v, k.endswith("o")))
    return out


def _environment_rays(spec, p_film):
    """The environment camera's camera-space directions: theta down the
    film's rows, phi across its columns."""
    pi = 3.14159265358979323846
    theta = pi * p_film[:, 1] / spec.resolution[1]
    phi = 2.0 * pi * p_film[:, 0] / spec.resolution[0]
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), torch.cos(theta), st * torch.sin(phi)], -1)


def generate_rays(spec: CameraSpec, p_film, differentials: bool = False, u_lens=None,
                  u_time=None):
    """[N,2] raster positions -> (world Rays [N], weight [N]); with
    differentials, the rays through the raster points one pixel over in x
    and in y ride along (the reference's generate_ray_differential) where
    the camera has them. A perspective ray leaves the eye through the
    raster point; an orthographic one leaves the raster point along +z.
    u_lens [N,2], the lens sample, is read where the lens radius is over 0
    and by the realistic camera; u_time [N], the time sample, where the
    camera moves."""
    n = p_film.shape[0]
    ones = torch.ones(n, dtype=p_film.dtype, device=p_film.device)
    time = None
    if spec.motion is not None:
        time = spec.shutter_open + u_time * (spec.shutter_close - spec.shutter_open)
    if spec.kind == "environment":
        f = _to_world(spec, time, {"o": torch.zeros((n, 3), device=p_film.device),
                                   "d": _environment_rays(spec, p_film)})
        return Rays(f["o"], f["d"]), ones
    if spec.kind == "realistic":
        from pbrt_tpu_torch.cameras.realistic import realistic_rays
        o, d, w = realistic_rays(spec, p_film, u_lens)
        f = _to_world(spec, time, {"o": o, "d": d})
        return Rays(f["o"], f["d"]), w
    p3 = torch.cat([p_film, torch.zeros((n, 1), dtype=p_film.dtype, device=p_film.device)], -1)
    m = spec.raster_to_camera
    step = torch.eye(3, dtype=p3.dtype, device=p3.device) if differentials else None
    lens = spec.lens_radius > 0.0
    p_lens = spec.lens_radius * concentric_sample_disk(u_lens) if lens else None
    f = {}
    if spec.kind == "orthographic":
        o = _raster_point(m, p3)
        d = torch.zeros_like(p3)
        d[:, 2] = 1.0
        if lens:
            o, d = _lens_offset(spec, p_lens, o, d)
        f = {"o": o, "d": d}
        if differentials:
            f["rx_o"] = _raster_point(m, p3 + step[0])
            f["ry_o"] = _raster_point(m, p3 + step[1])
        f = _to_world(spec, time, f)
        rays = Rays(f["o"], f["d"])
        if differentials:
            rays.rx_o, rays.ry_o = f["rx_o"], f["ry_o"]
            rays.rx_d = rays.ry_d = rays.d
        return rays, ones
    d = normalize(_raster_point(m, p3))
    o_cam = torch.zeros_like(d)
    if lens:
        o_cam, d = _lens_offset(spec, p_lens, o_cam, d)
    f = {"o": o_cam, "d": d}
    if differentials:
        for axis, name in ((0, "rx"), (1, "ry")):
            dd = normalize(_raster_point(m, p3 + step[axis]))
            od = o_cam
            if lens:
                # the reference aims from the main ray's lens point
                od, dd = _lens_offset(spec, p_lens, o_cam, dd)
            f[name + "_o"], f[name + "_d"] = od, dd
    f = _to_world(spec, time, f)
    return Rays(f["o"], f["d"], f.get("rx_o"), f.get("rx_d"), f.get("ry_o"), f.get("ry_d")), ones
