"""The benchmark scene of the reference (`__graft_entry__._build_scene`),
built with the port's own front end: 02sequence at 4 spp, a perspective
camera, a box filter, a constant infinite light plus one diffuse area
light, a matte floor and a procedural trefoil knot, path depth 4.

small: a 4,608-triangle knot at 64x64; large: 73,728 triangles at 256x256.

The instanced bench scene keeps that sampler, depth, lighting and those
materials, and makes the large knot a prototype behind 64 instances on an
8x8 grid (4,718,592 instanced triangles, the knot stored once) at 256x256;
its animated variant moves every instance over the shutter.

The PLY bench scene keeps the large scene's text, resolution, sampler and
depth, and reads its knot, 448x112 (100,352 triangles, with normals and
uv), from a binary little-endian PLY file written at run time; its
loopsubdiv variant subdivides a 56x14 knot (1,568 triangles) three times
to the same count. Their world trees have more than 32,768 nodes and
their reference kernel tables at most 12 MiB, where the reference walks
them with its B5 kernel.
"""
from __future__ import annotations

import os

import numpy as np

from pbrt_tpu_torch.accel.traverse import tpu_table_bytes
from pbrt_tpu_torch.scene.api import Api, ShapeRecord
from pbrt_tpu_torch.scene.build import build_scene, load_scene
from pbrt_tpu_torch.scene.parser import parse_string
from pbrt_tpu_torch.shapes.loopsubdiv import loop_subdivide
from pbrt_tpu_torch.shapes.ply import write_ply
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


PLY_KNOT = (448, 112)     # 100,352 triangles
LOOP_KNOT = (56, 14)      # 1,568 triangles; 3 levels of Loop subdivision give 100,352
KNOT_LINE = '  Material "matte" "rgb Kd" [0.6 0.4 0.3]\n'   # the knot's material
PLY_WINDOW = (1 << 15, 12 << 20)   # nodes above, reference table bytes at most


def write_knot_ply(path, n_u=PLY_KNOT[0], n_v=PLY_KNOT[1]):
    """Write the bench knot (scale 0.45) as a binary little-endian PLY file
    with area-weighted vertex normals and uv = (i / n_u, j / n_v)."""
    m = make_knot_mesh(n_u, n_v, scale=0.45)
    _, _, normals = loop_subdivide(m.p, m.indices, 0)
    i, j = np.meshgrid(np.arange(n_u) / n_u, np.arange(n_v) / n_v, indexing="ij")
    uv = np.stack([i.reshape(-1), j.reshape(-1)], -1)
    write_ply(path, m.p, m.indices, normals, uv, fmt="binary_little_endian")


def ply_scene_text(shape: str) -> str:
    """The large bench scene with `shape` as its knot, under the knot's
    material."""
    return scene_text(True).replace(KNOT_LINE, KNOT_LINE + "  " + shape + "\n")


def build_ply_bench_scene(dirname, device="cuda", loopsubdiv=False, options=None):
    """Write the PLY bench scene (or its loopsubdiv variant) and its knot
    into dirname and load it. Raises if its world tree is outside the
    reference's B5 window (PLY_WINDOW)."""
    if loopsubdiv:
        m = make_knot_mesh(*LOOP_KNOT, scale=0.45)
        shape = ('Shape "loopsubdiv" "integer levels" [3] "integer indices" [{}] '
                 '"point P" [{}]').format(" ".join(map(str, m.indices.reshape(-1))),
                                          " ".join(repr(float(x)) for x in m.p.reshape(-1)))
        name = "knot_loopsubdiv.pbrt"
    else:
        write_knot_ply(os.path.join(dirname, "knot.ply"))
        shape, name = 'Shape "plymesh" "string filename" "knot.ply"', "knot_ply.pbrt"
    path = os.path.join(dirname, name)
    with open(path, "w") as f:
        f.write(ply_scene_text(shape))
    cs = load_scene(path, options, device)
    nodes, table = cs.data.bvh.metas.shape[0], tpu_table_bytes(cs.data.bvh)
    if not (nodes > PLY_WINDOW[0] and table <= PLY_WINDOW[1]):
        raise ValueError(f"{name}: {nodes} nodes and {table} table bytes are outside the "
                         f"reference's B5 window")
    return cs
