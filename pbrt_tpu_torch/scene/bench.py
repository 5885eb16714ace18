"""The benchmark scene of the reference (`__graft_entry__._build_scene`),
built with the port's own front end: 02sequence at 4 spp, a perspective
camera, a box filter, a constant infinite light plus one diffuse area
light, a matte floor and a procedural trefoil knot, path depth 4.

small: a 4,608-triangle knot at 64x64; large: 73,728 triangles at 256x256.

The instanced bench scene keeps that sampler, depth, lighting and those
materials, and makes the large knot a prototype behind 64 instances on an
8x8 grid (4,718,592 instanced triangles, the knot stored once) at 256x256;
its animated variant moves every instance over the shutter.

The sphere scene is the first configuration of BASELINE.json: one sphere of
radius 1, matte, lit by one point light, 256x256, 02sequence at 16 spp,
the path integrator at pbrt's default depth 5; it holds no triangle.

The quadric showcase is the large bench scene plus one shape of each
quadric kind (some cut by zmin/zmax/phimax or innerradius), a cylinder
object instanced twice (instances of quadrics are baked), a small emitting
sphere, a point, a spot and a distant light, and Bezier curves: cylinder
"grass" on the floor, one flat and one ribbon curve.

The differentiable scene stands in for BASELINE.json's fifth
configuration (the reference's tests/test_diff.py scene; the configuration's
bunny is not in the repo): a matte sphere and a checkerboard-textured
floor under a point light and a constant environment, 02sequence, depth 3.

The textured bench scene is the bench scene with a texture on every
surface: the floor an image map (uv repeated 6x6 over it) read from a PNG
file, the knot marble, a checkerboard wall behind the knot, and in front of
it a quad whose alpha mask is a 6x6 checkerboard, so half of it is cut
away and the rays through it are re-traced.

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


KNOT_MARBLE = ('Texture "knot" "color" "marble" "float scale" 4 "float variation" 0.6\n'
               '  Material "matte" "texture Kd" "knot"')
FLOOR_IMAGE = ('Texture "floor" "color" "imagemap" "string filename" "{IMG}" '
               '"float uscale" 6 "float vscale" 6\n  Material "matte" "texture Kd" "floor"')
FLOOR_P = '"point P" [-10 -1 -10  10 -1 -10  10 -1 10  -10 -1 10]'
QUAD_UV = '"float uv" [0 0 1 0 1 1 0 1]'
TEXTURED_EXTRA = f"""AttributeBegin
  Texture "wall" "color" "checkerboard" "float uscale" 8 "float vscale" 4
    "rgb tex1" [0.8 0.8 0.7] "rgb tex2" [0.2 0.3 0.5]
  Material "matte" "texture Kd" "wall"
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-6 -1 -3  6 -1 -3  6 4 -3  -6 4 -3] {QUAD_UV}
AttributeEnd
AttributeBegin
  Texture "mask" "float" "checkerboard" "float uscale" 6 "float vscale" 6
    "float tex1" 1 "float tex2" 0
  Material "matte" "rgb Kd" [0.7 0.2 0.2]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1.5 -1 1.8  1.5 -1 1.8  1.5 1.5 1.8  -1.5 1.5 1.8] {QUAD_UV}
    "texture alpha" "mask"
AttributeEnd
WorldEnd"""


DIFF_SCENE = """
LookAt 0 4 4  0 0 0  0 1 0
Camera "perspective" "float fov" 35
Film "image" "integer xresolution" [{RES}] "integer yresolution" [{RES}]
Sampler "02sequence" "integer pixelsamples" 8
Integrator "path" "integer maxdepth" 3
WorldBegin
LightSource "point" "point from" [2 5 1] "rgb I" [40 40 40]
LightSource "infinite" "rgb L" [0.2 0.2 0.25]
AttributeBegin
  Material "matte" "rgb Kd" [0.6 0.3 0.2]
  Shape "sphere" "float radius" 1
AttributeEnd
AttributeBegin
  Texture "check" "color" "checkerboard" "rgb tex1" [0.8 0.8 0.8] "rgb tex2" [0.2 0.2 0.2]
  Material "matte" "texture Kd" "check"
  Translate 0 -1 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-8 0 -8  8 0 -8  8 0 8  -8 0 8]
AttributeEnd
WorldEnd
"""


def build_diff_scene(res: int = 256, device="cuda"):
    api = Api()
    parse_string(DIFF_SCENE.replace("{RES}", str(res)), api)
    return build_scene(api.scene, None, device)


def textured_scene_text(large: bool, image: str) -> str:
    """The textured bench scene's text (its knot is appended by
    textured_description); image: the floor's image file."""
    return (scene_text(large).replace(FLOOR_PLAIN, FLOOR_IMAGE.replace("{IMG}", image))
            .replace('Material "matte" "rgb Kd" [0.6 0.4 0.3]', KNOT_MARBLE)
            .replace(FLOOR_P, f"{FLOOR_P} {QUAD_UV}").replace("WorldEnd", TEXTURED_EXTRA))


def write_floor_image(path, size=(192, 160), seed=0):
    """The floor's image: soft colour blobs over tiles, seeded, as an 8-bit
    PNG of size (width, height); not a power of two, so the atlas build
    resamples it."""
    from pbrt_tpu_torch.io.image_io import write_png
    w, h = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    img = 0.25 + 0.2 * ((np.floor(xx * 8) + np.floor(yy * 8)) % 2)[..., None] * np.ones(3)
    for c in rng.uniform(0, 1, (12, 5)):
        blob = np.exp(-((xx - c[0]) ** 2 + (yy - c[1]) ** 2) / (0.01 + 0.02 * c[2]))
        img = img + 0.5 * blob[..., None] * np.array([c[2], c[3], c[4]])
    write_png(path, np.clip(img, 0, 1).astype(np.float32))


def textured_description(large: bool, image: str):
    api = Api()
    parse_string(textured_scene_text(large, image), api)
    n_u, n_v = KNOT[large]
    api.scene.shapes.append(ShapeRecord("trianglemesh",
                                        mesh=make_knot_mesh(n_u, n_v, scale=0.45),
                                        material=KNOT_MATERIAL))
    return api.scene


def build_textured_bench_scene(image: str, large: bool = True, device="cuda", options=None):
    return build_scene(textured_description(large, image), options, device)


SPHERE_SCENE = """
LookAt 0 0 5  0 0 0  0 1 0
Camera "perspective" "float fov" 30
Film "image" "integer xresolution" [256] "integer yresolution" [256]
Sampler "02sequence" "integer pixelsamples" 16
Integrator "path"
WorldBegin
LightSource "point" "point from" [2 3 4] "rgb I" [25 25 25]
AttributeBegin
  Material "matte" "rgb Kd" [0.5 0.5 0.5]
  Shape "sphere" "float radius" 1
AttributeEnd
WorldEnd
"""


def build_sphere_scene(device="cuda", options=None):
    api = Api()
    parse_string(SPHERE_SCENE, api)
    return build_scene(api.scene, options, device)


QUADRICS = """
LightSource "point" "point from" [2 3 -1] "rgb I" [6 6 6]
LightSource "spot" "point from" [-2 4 2] "point to" [0 0 0] "float coneangle" 25
  "float conedeltaangle" 8 "rgb I" [20 20 20]
LightSource "distant" "point from" [-1 2 1] "point to" [0 0 0] "rgb L" [0.6 0.6 0.5]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 4 4]
  Translate 0.8 1.6 0.8
  Shape "sphere" "float radius" 0.15
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.7 0.3 0.3]
  Translate -1.2 -0.5 1.2
  Shape "sphere" "float radius" 0.4 "float zmin" -0.3 "float zmax" 0.35 "float phimax" 290
AttributeEnd
AttributeBegin
  Material "plastic" "rgb Kd" [0.2 0.5 0.2] "rgb Ks" [0.3 0.3 0.3]
  Translate 0 -0.99 0
  Rotate -90 1 0 0
  Shape "disk" "float radius" 2.2 "float innerradius" 1.6
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.3 0.3 0.7]
  Translate -1.3 -1 -0.8
  Rotate -90 1 0 0
  Shape "cone" "float radius" 0.35 "float height" 0.8 "float phimax" 300
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.7 0.7 0.2]
  Translate 1.4 -1 0.6
  Rotate -90 1 0 0
  Shape "paraboloid" "float radius" 0.35 "float zmin" 0.1 "float zmax" 0.7
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.3 0.7 0.7]
  Translate 0.2 -1 1.6
  Rotate -90 1 0 0
  Shape "hyperboloid" "point p1" [0.3 0 0] "point p2" [0 0.3 0.6]
AttributeEnd
ObjectBegin "post"
  Material "plastic" "rgb Kd" [0.5 0.4 0.3] "rgb Ks" [0.2 0.2 0.2]
  Rotate -90 1 0 0
  Shape "cylinder" "float radius" 0.12 "float zmin" 0 "float zmax" 0.9 "float phimax" 270
ObjectEnd
AttributeBegin
  Translate 1.2 -1 -1.2
  ObjectInstance "post"
AttributeEnd
AttributeBegin
  Translate -0.4 -1 -1.6
  Rotate 60 0 1 0
  ObjectInstance "post"
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.8 0.8 0.8]
  Shape "curve" "string type" "flat" "point P" [-1.5 -0.2 -1.5  -0.5 0.6 -1.5  0.5 0.6 -1.5  1.5 -0.2 -1.5]
    "float width" 0.06
  Shape "curve" "string type" "ribbon" "point P" [-1.5 1.2 0  -0.5 1.6 0.5  0.5 1.6 0.5  1.5 1.2 0]
    "normal N" [0 0 1  0 1 1] "float width0" 0.08 "float width1" 0.03
{GRASS}AttributeEnd
"""


def grass(n):
    """n cylinder curves standing on the floor at y = -1, on a ring of
    radius 1.9, each leaning outward."""
    out = []
    for k in range(n):
        a = 2.0 * np.pi * k / n
        c, s = np.cos(a), np.sin(a)
        pts = [(1.9 * c, -1.0, 1.9 * s), (1.9 * c, -0.7, 1.9 * s),
               (2.0 * c, -0.5, 2.0 * s), (2.15 * c, -0.35, 2.15 * s)]
        out.append('  Shape "curve" "string type" "cylinder" "point P" [{}]\n'
                   '    "float width0" 0.04 "float width1" 0.01\n'.format(
                       "  ".join(" ".join(f"{x:.4f}" for x in p) for p in pts)))
    return "".join(out)


def quadric_scene_text(res=256, spp=4, n_grass=16) -> str:
    """The bench scene (no knot) at res x res and spp with QUADRICS and
    n_grass cylinder curves added before its end."""
    return SCENE.replace("{RES}", str(res)).replace("{FLOOR_MAT}", FLOOR_PLAIN).replace(
        "pixelsamples\" 4", f"pixelsamples\" {spp}").replace(
        "WorldEnd", QUADRICS.replace("{GRASS}", grass(n_grass)) + "WorldEnd")


def quadric_showcase_description():
    """SceneDescription of the quadric showcase: the large bench scene (its
    knot appended last, as bench_description appends it) with QUADRICS and
    16 cylinder curves."""
    api = Api()
    parse_string(quadric_scene_text(), api)
    n_u, n_v = KNOT[True]
    api.scene.shapes.append(ShapeRecord("trianglemesh",
                                        mesh=make_knot_mesh(n_u, n_v, scale=0.45),
                                        material=KNOT_MATERIAL))
    return api.scene


def build_quadric_showcase(device="cuda", options=None):
    return build_scene(quadric_showcase_description(), options, device)


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
