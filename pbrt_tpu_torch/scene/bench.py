"""The benchmark scene of the reference (`__graft_entry__._build_scene`),
built with the port's own front end: 02sequence at 4 spp, a perspective
camera, a box filter, a constant infinite light plus one diffuse area
light, a matte floor and a procedural trefoil knot, path depth 4.

small: a 4,608-triangle knot at 64x64; large: 73,728 triangles at 256x256.

The instanced bench scene keeps that sampler, depth, lighting and those
materials, and makes the large knot a prototype behind 64 instances on an
8x8 grid (4,718,592 instanced triangles, the knot stored once) at 256x256;
its animated variant moves every instance over the shutter.
"""
from __future__ import annotations

import numpy as np

from pbrt_tpu_torch.scene.api import Api, ShapeRecord
from pbrt_tpu_torch.scene.build import build_scene
from pbrt_tpu_torch.scene.parser import parse_string
from pbrt_tpu_torch.shapes.triangle import make_knot_mesh

SCENE = """
LookAt 3 3 3  0 0 0  0 1 0
Camera "perspective" "float fov" 40
Film "image" "integer xresolution" [{RES}] "integer yresolution" [{RES}]
Sampler "02sequence" "integer pixelsamples" 4
Integrator "path" "integer maxdepth" 4
WorldBegin
LightSource "infinite" "rgb L" [0.3 0.35 0.4]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8]
  Translate 0 4 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.6 0.4 0.3]
AttributeEnd
AttributeBegin
  Material "plastic" "rgb Kd" [0.3 0.3 0.7] "rgb Ks" [0.3 0.3 0.3]
  {FLOOR_MAT}
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-10 -1 -10  10 -1 -10  10 -1 10  -10 -1 10]
AttributeEnd
WorldEnd
"""
FLOOR_PLAIN = 'Material "matte" "rgb Kd" [0.5 0.5 0.5]'
KNOT = {False: (96, 24), True: (384, 96)}   # (n_u, n_v) per size
KNOT_MATERIAL = 1    # the reference appends the knot with material id 1


def scene_text(large: bool) -> str:
    return SCENE.replace("{RES}", "256" if large else "64").replace("{FLOOR_MAT}", FLOOR_PLAIN)


def bench_description(large: bool = False):
    """SceneDescription of the benchmark scene (knot appended last)."""
    api = Api()
    parse_string(scene_text(large), api)
    n_u, n_v = KNOT[large]
    api.scene.shapes.append(ShapeRecord("trianglemesh",
                                        mesh=make_knot_mesh(n_u, n_v, scale=0.45),
                                        material=KNOT_MATERIAL))
    return api.scene


def build_bench_scene(large: bool = False, device="cuda", options=None):
    return build_scene(bench_description(large), options, device)


INSTANCED_SCENE = """
LookAt 8 6 8  0 0 0  0 1 0
Camera "perspective" "float fov" 45
Film "image" "integer xresolution" [256] "integer yresolution" [256]
Sampler "02sequence" "integer pixelsamples" 4
Integrator "path" "integer maxdepth" 4
WorldBegin
LightSource "infinite" "rgb L" [0.3 0.35 0.4]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8]
  Translate 0 6 0
  Scale 3 3 3
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.6 0.4 0.3]
AttributeEnd
AttributeBegin
  Material "plastic" "rgb Kd" [0.3 0.3 0.7] "rgb Ks" [0.3 0.3 0.3]
  Material "matte" "rgb Kd" [0.5 0.5 0.5]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-20 -1 -20  20 -1 -20  20 -1 20  -20 -1 20]
AttributeEnd
ObjectBegin "knot"
"""
GRID, SPACING = 8, 1.6


def instanced_description(animated: bool = False):
    """SceneDescription of the instanced bench scene: the large knot as the
    prototype "knot" (appended into the object as bench_description appends
    it), then GRID x GRID instances at SPACING, centred on the origin, each
    rotated about y by an angle in [0, 360) and scaled by a factor in
    [0.6, 1.0], both drawn from numpy.random.default_rng(0). animated: each
    pose at StartTime, and at EndTime the same pose rotated a further 45
    degrees about y and moved 0.3 along x."""
    api = Api()
    parse_string(INSTANCED_SCENE, api)
    n_u, n_v = KNOT[True]
    api.objects[api.current_object].append(
        ShapeRecord("trianglemesh", mesh=make_knot_mesh(n_u, n_v, scale=0.45),
                    material=KNOT_MATERIAL))
    rng = np.random.default_rng(0)
    angles = rng.uniform(0.0, 360.0, GRID * GRID)
    scales = rng.uniform(0.6, 1.0, GRID * GRID)
    text = ["ObjectEnd"]
    for k in range(GRID * GRID):
        x = (k % GRID - (GRID - 1) / 2) * SPACING
        z = (k // GRID - (GRID - 1) / 2) * SPACING
        a, s = angles[k], scales[k]
        pose = f"Translate {x} 0 {z}\n  Rotate {a} 0 1 0\n  Scale {s} {s} {s}\n"
        if animated:
            end = f"Translate {x + 0.3} 0 {z}\n  Rotate {a + 45.0} 0 1 0\n  Scale {s} {s} {s}\n"
            pose = (f"ActiveTransform StartTime\n  {pose}  ActiveTransform EndTime\n  {end}"
                    "  ActiveTransform All\n")
        text.append(f"AttributeBegin\n  {pose}  ObjectInstance \"knot\"\nAttributeEnd")
    parse_string("\n".join(text + ["WorldEnd"]), api)
    return api.scene


def build_instanced_bench_scene(animated: bool = False, device="cuda", options=None):
    return build_scene(instanced_description(animated), options, device)
