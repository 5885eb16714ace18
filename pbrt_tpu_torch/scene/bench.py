"""The benchmark scene of the reference (`__graft_entry__._build_scene`),
built with the port's own front end: 02sequence at 4 spp, a perspective
camera, a box filter, a constant infinite light plus one diffuse area
light, a matte floor and a procedural trefoil knot, path depth 4.

small: a 4,608-triangle knot at 64x64; large: 73,728 triangles at 256x256.
"""
from __future__ import annotations

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


def build_bench_scene(large: bool = False, device="cpu", options=None):
    return build_scene(bench_description(large), options, device)
