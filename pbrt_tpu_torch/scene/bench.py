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

The environment-material scene is BASELINE.json's third configuration:
textured materials and microfacet metal / plastic under an infinite
environment light with MIS. The large bench knot (73,728 triangles, read
from a PLY file) is copper metal at roughness 0.15; the floor is a mix of
a checkerboard matte and a plastic whose Kd is the "uv" texture; a smooth
glass sphere and a mirror quad stand beside the knot; no area light: the
light is a seeded 512x256 equirect EXR, a sky gradient with a sun patch
about 200x brighter. 256x256, 02sequence at 16 spp, depth 5. Its small
variant has the small knot at 64x64. write_env_material_scene writes the
scene file, its knot and its map into a directory.

The all-kinds scene is a 64x64 orthographic view of one sphere of each
ported material kind (matte with sigma, plastic, metal, smooth and rough
glass, mirror, substrate, translucent, uber, mix, fourier, none) on a
matte backdrop, lit by a goniometric and a projection light with maps and
a dim constant environment, chosen per shading point by the "spatial"
strategy; write_all_kinds_scene writes it with its fourier table and maps.

BASELINE.json's second configuration ("path integrator, PLY triangle mesh
with BVH accelerator, area light, stratified sampler"; its bunny is not in
the repo) is the PLY bench scene with the stratified sampler, 4x4
jittered (16 spp), at depth 5, under the bench's area and constant
lights; its small variant reads the small knot at 64x64.

BASELINE.json's fourth configuration ("glass/mirror specular transport +
depth-of-field perspective camera, Sobol (0-2) sampler, 256 spp") is the
large knot, read from a PLY file, as glass (eta 1.5) before a mirror
quad, over the matte floor and under the bench's lights, seen through a
lens of radius 0.1 focused on the knot (5.196 units away, so the floor
blurs), with the reference-matched global Sobol' sampler at 256 spp,
depth 5; its small variant has the small knot at 64x64.

The volpath scene is the large bench scene (its knot from a PLY file)
under the volumetric path integrator at depth 5: the camera sits in a
thin homogeneous fog, and the knot in a box of material "none" (a medium
interface) that holds a 32^3 grid medium of seeded smooth density with
g = 0.3; 4 spp. Its "homogeneous" variant has the fog alone (no box).

The bench variants (bench_variant_description) keep the bench scene and
change one thing each: a camera that moves over the shutter
(CAMERA_MOTION: translated and turned by ActiveTransform EndTime), the
world under `Accelerator "kdtree"`, or the knot's material (SUBSURFACE_KNOT:
the measured marble, its coefficients scaled by 20 so that its mean free
path, about 0.02 units, is small beside the knot's 0.3-unit tube;
KDSUBSURFACE_KNOT: a Kd and mean free path of the same scale). Config 3
takes another camera through write_env_material_scene's `camera`
(ENV_CAMERA, REALISTIC_CAMERA: the built-in double-Gauss lens at an 8 mm
aperture focused at the knot, 5.196 units away). The kd-tree calibration
scene (kdtree_calibration_scene) is the 36-triangle knot scene of the
reference's calibration under the kd-tree, its floor a 6x6 grid of quads,
so that the world holds 110 triangles, over the 64 from which the
reference builds an accelerator.

The PLY bench scene keeps the large scene's text, resolution, sampler and
depth, and reads its knot, 448x112 (100,352 triangles, with normals and
uv), from a binary little-endian PLY file written at run time; its
loopsubdiv variant subdivides a 56x14 knot (1,568 triangles) three times
to the same count. Their world trees have more than 32,768 nodes and
their reference kernel tables at most 12 MiB, where the reference walks
them with its B5 kernel.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from pbrt_tpu_torch.accel.kdtree import LEAF, KdTables
from pbrt_tpu_torch.accel.traverse import tpu_table_bytes
from pbrt_tpu_torch.cameras import realistic as R
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
    cs = build_scene(bench_description(large), options, device)
    cs.source = (build_bench_scene, (large,), {"options": options})
    return cs


CAMERA_MOTION = "Translate 0.25 0.1 0\nRotate 4 0 1 0"
SUBSURFACE_KNOT = 'Material "subsurface" "string name" "Marble" "float scale" 20'
KDSUBSURFACE_KNOT = 'Material "kdsubsurface" "rgb Kd" [0.8 0.55 0.4] "float mfp" 0.02'
ENV_CAMERA = 'Camera "environment"'
REALISTIC_CAMERA = ('Camera "realistic" "float aperturediameter" 8 '
                    '"float focusdistance" 5.196')
_LOOKAT = "LookAt 3 3 3  0 0 0  0 1 0\n"


def scene_variant(text, camera=None, motion=None, accelerator=None, knot_material=None,
                  knot_line='Material "matte" "rgb Kd" [0.6 0.4 0.3]', integrator=None):
    """A scene text of the bench family with one thing changed: the Camera
    line, the camera's end transform (motion: transform lines applied at
    the shutter's end after the LookAt), the Accelerator, or the knot's
    material (in place of knot_line); integrator, where given, replaces
    the bench's Integrator line. Each line it changes must be in the text
    once."""
    def once(text, target, new):
        if text.count(target) != 1:
            raise ValueError(f"scene_variant: {target!r} is in the text "
                             f"{text.count(target)} times, not once")
        return text.replace(target, new)

    if integrator:
        text = once(text, 'Integrator "path" "integer maxdepth" 4', integrator)
    if camera:
        text = once(text, 'Camera "perspective" "float fov" 40', camera)
    if motion:
        text = once(text, _LOOKAT, _LOOKAT + "ActiveTransform EndTime\n" + motion
                    + "\nActiveTransform All\n")
    if accelerator:
        text = once(text, "WorldBegin", f'Accelerator "{accelerator}"\nWorldBegin')
    if knot_material:
        text = once(text, knot_line, knot_material)
    return text


def open_lens(load_lens_system=R.load_lens_system, trace_np=R._trace_np,
              normalize_np=R._normalize_np):
    """REALISTIC_CAMERA's lens opened: the built-in lens at its table's own
    rear gap (72.228 mm; the reference's focus collapses the gap, so its
    lens passes no ray) and exit-pupil bounds found as focus_lens_system
    finds them, with load_lens_system, the float32 trace and normalize of
    cameras/realistic.py (or another package's, to compare the two) ->
    (lens [n,4], bounds [32,4] f32)."""
    lens = load_lens_system({"aperturediameter": [8.0]})
    rear_ap, rear_z = float(lens[-1, 3]), -float(lens[-1, 1])
    bounds = np.zeros((32, 4), np.float32)
    rng = np.random.default_rng(0)
    for b in range(32):
        fx = rng.uniform(b / 32 * 0.0175, (b + 1) / 32 * 0.0175, 512)
        lx = rng.uniform(-1.5 * rear_ap, 1.5 * rear_ap, (512, 2))
        o = np.stack([fx, np.zeros(512), np.zeros(512)], -1)
        d = np.stack([lx[:, 0] - fx, lx[:, 1], np.full(512, rear_z)], -1)
        sel = lx[trace_np(lens, o, normalize_np(d))[0]]
        pad = 0.1 * rear_ap
        bounds[b] = [sel[:, 0].min() - pad, sel[:, 0].max() + pad,
                     sel[:, 1].min() - pad, sel[:, 1].max() + pad]
    return lens, bounds


def open_realistic_camera(cs):
    """A compiled scene under REALISTIC_CAMERA -> the same scene through
    open_lens's lens, whose rays reach the scene."""
    lens, bounds = open_lens()
    return dataclasses.replace(cs, camera=dataclasses.replace(
        cs.camera, lens_elements=lens, exit_pupil=bounds))


def bench_variant_description(large: bool = True, **variant):
    """SceneDescription of a bench variant (see scene_variant)."""
    api = Api()
    parse_string(scene_variant(scene_text(large), **variant), api)
    n_u, n_v = KNOT[large]
    api.scene.shapes.append(ShapeRecord("trianglemesh",
                                        mesh=make_knot_mesh(n_u, n_v, scale=0.45),
                                        material=KNOT_MATERIAL))
    return api.scene


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
    cs = build_scene(api.scene, None, device)
    cs.source = (build_diff_scene, (res,), {})
    return cs


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


ENV_SCENE = """
LookAt 3 3 3  0 0 0  0 1 0
Camera "perspective" "float fov" 40
Film "image" "integer xresolution" [{RES}] "integer yresolution" [{RES}]
Sampler "02sequence" "integer pixelsamples" {SPP}
Integrator "path" "integer maxdepth" 5
WorldBegin
AttributeBegin
  Rotate -90 1 0 0
  LightSource "infinite" "string mapname" "sky.exr"
AttributeEnd
AttributeBegin
  Texture "check" "spectrum" "checkerboard" "float uscale" 12 "float vscale" 12
    "rgb tex1" [0.8 0.8 0.8] "rgb tex2" [0.15 0.15 0.15]
  Texture "ramp" "spectrum" "uv"
  MakeNamedMaterial "floor_matte" "string type" "matte" "texture Kd" "check"
  MakeNamedMaterial "floor_plastic" "string type" "plastic" "texture Kd" "ramp"
    "rgb Ks" [0.3 0.3 0.3] "float roughness" 0.05
  Material "mix" "string namedmaterial1" "floor_matte" "string namedmaterial2" "floor_plastic"
    "rgb amount" [0.5 0.5 0.5]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-10 -1 -10  10 -1 -10  10 -1 10  -10 -1 10] "float uv" [0 0 1 0 1 1 0 1]
AttributeEnd
AttributeBegin
  Material "metal" "float roughness" 0.15
  Shape "plymesh" "string filename" "knot.ply"
AttributeEnd
AttributeBegin
  Material "glass"
  Translate 1.3 -0.45 1.7
  Shape "sphere" "float radius" 0.55
AttributeEnd
AttributeBegin
  Material "mirror"
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-2.8 -1 -2  0.4 -1 -2  0.4 1.6 -2  -2.8 1.6 -2]
AttributeEnd
WorldEnd
"""


def write_sky_exr(path, size=(512, 256), seed=0):
    """The environment map: an equirect (theta from the light frame's +z
    down the rows) sky gradient over a darker ground with seeded grain,
    and a sun patch about 200x brighter than the sky, as a float EXR."""
    from pbrt_tpu_torch.io.image_io import write_exr
    w, h = size
    rng = np.random.default_rng(seed)
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2 * np.pi
    up = np.clip(np.cos(theta), 0.0, 1.0)[:, None, None]
    sky = np.array([0.35, 0.5, 0.9]) * (0.4 + 0.6 * up) + np.array([0.6, 0.55, 0.5]) * (1 - up)
    ground = np.array([0.12, 0.1, 0.08]) * np.ones((h, 1, 1))
    img = np.where((theta < np.pi / 2)[:, None, None], sky, ground) * np.ones((1, w, 1))
    img = img * rng.uniform(0.9, 1.1, (h, w, 1))
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    sun = (np.cos(tt) * np.cos(0.6) + np.sin(tt) * np.sin(0.6) * np.cos(pp - 1.0)) > np.cos(0.05)
    img[sun] = 200.0 * np.array([1.0, 0.95, 0.85])
    write_exr(path, img.astype(np.float32))


def write_env_material_scene(dirname, large=True, res=None, spp=16, integrator=None,
                             camera=None):
    """Write BASELINE config 3 (scene.pbrt, knot.ply, sky.exr) into dirname
    -> the scene file's path; res defaults to 256 (large) or 64;
    integrator: another Integrator line than path at depth 5; camera:
    another Camera line."""
    write_sky_exr(os.path.join(dirname, "sky.exr"))
    write_knot_ply(os.path.join(dirname, "knot.ply"), *KNOT[large])
    path = os.path.join(dirname, "scene.pbrt")
    text = ENV_SCENE.replace("{RES}", str(res or (256 if large else 64))).replace(
        "{SPP}", str(spp))
    if integrator:
        text = text.replace('Integrator "path" "integer maxdepth" 5', integrator)
    text = scene_variant(text, camera=camera)
    with open(path, "w") as f:
        f.write(text)
    return path


def build_env_material_scene(dirname, large=True, device="cuda", options=None):
    """Write BASELINE config 3 into dirname and load it."""
    return load_scene(write_env_material_scene(dirname, large), options, device)


def write_fourier_bsdf(path, rho=0.6, n_mu=32, harmonics=(1.0, 0.4, 0.1), eta=1.5):
    """A single-channel SCATFUN table: a_k(mu_i, mu_o) = rho / pi * |mu_i| *
    harmonics[k], a diffuse lobe with an azimuthal ripple that stays
    positive."""
    import struct
    mu = np.linspace(-1, 1, n_mu).astype(np.float32)
    m = len(harmonics)
    oal = np.zeros((n_mu * n_mu, 2), np.int32)
    coeffs = []
    for i in range(n_mu):
        for j in range(n_mu):
            oal[i * n_mu + j] = (len(coeffs), m)
            coeffs += [rho / np.pi * abs(mu[i]) * h for h in harmonics]
    a = np.asarray(coeffs, np.float32)
    with open(path, "wb") as f:
        f.write(b"SCATFUN\x01")
        f.write(struct.pack("<9i", 1, n_mu, len(a), m, 1, 1, 0, 0, 0))
        f.write(struct.pack("<f", eta))
        f.write(struct.pack("<4i", 0, 0, 0, 0))
        f.write(mu.tobytes())
        f.write(np.zeros(n_mu * n_mu, np.float32).tobytes())
        f.write(oal.tobytes())
        f.write(a.tobytes())


def write_light_map(path, size=(32, 16), seed=1):
    """A seeded colour map for a projection or goniometric light (EXR)."""
    from pbrt_tpu_torch.io.image_io import write_exr
    w, h = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    img = 0.3 + 0.7 * ((np.floor(xx * 4) + np.floor(yy * 4)) % 2)[..., None] \
        * rng.uniform(0.3, 1.0, 3)
    write_exr(path, img.astype(np.float32))


ALL_KINDS = [
    'Material "matte" "rgb Kd" [0.7 0.6 0.5] "float sigma" 25',
    'Material "plastic" "rgb Kd" [0.2 0.3 0.6] "rgb Ks" [0.4 0.4 0.4]',
    'Material "metal" "float roughness" 0.2',
    'Material "glass"',
    'Material "glass" "float roughness" 0.3',
    'Material "mirror"',
    'Material "substrate" "rgb Kd" [0.5 0.3 0.2] "rgb Ks" [0.3 0.3 0.3]',
    'Material "translucent" "rgb Kd" [0.6 0.6 0.3]',
    'Material "uber" "rgb Kd" [0.3 0.5 0.3] "rgb Kr" [0.2 0.2 0.2] "rgb opacity" [0.8 0.8 0.8]',
    'MakeNamedMaterial "m1" "string type" "matte" "rgb Kd" [0.9 0.2 0.2]\n'
    '  MakeNamedMaterial "m2" "string type" "metal" "float roughness" 0.05\n'
    '  Material "mix" "string namedmaterial1" "m1" "string namedmaterial2" "m2"',
    'Material "fourier" "string bsdffile" "ripple.bsdf"',
    'Material ""',
]


def all_kinds_scene_text(res=64, spp=8, voxels=16, strategy="spatial") -> str:
    """The all-kinds scene's text (its maps and fourier table are files
    beside it: write_all_kinds_scene); strategy: the light strategy."""
    spheres = "".join(
        f'AttributeBegin\n  {m}\n  Translate {-3 + 2 * (i % 4)} {2 - 2 * (i // 4)} 0\n'
        f'  Shape "sphere" "float radius" 0.8\nAttributeEnd\n' for i, m in enumerate(ALL_KINDS))
    return f"""LookAt 0 0 8  0 0 0  0 1 0
Camera "orthographic" "float screenwindow" [-4 4 -4 4]
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
Sampler "02sequence" "integer pixelsamples" {spp}
Integrator "path" "integer maxdepth" 5 "string lightsamplestrategy" "{strategy}"
  "integer spatialvoxels" {voxels}
WorldBegin
LightSource "infinite" "rgb L" [0.1 0.1 0.12]
AttributeBegin
  Translate 0 1 6
  LightSource "goniometric" "string mapname" "gonio.exr" "rgb I" [30 30 30]
AttributeEnd
AttributeBegin
  Translate 2 -1 7
  Rotate 180 1 0 0
  LightSource "projection" "string mapname" "proj.exr" "float fov" 70 "rgb I" [40 40 40]
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.5 0.5 0.5]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-6 -6 -1.5  6 -6 -1.5  6 6 -1.5  -6 6 -1.5]
AttributeEnd
{spheres}WorldEnd
"""


def write_all_kinds_scene(dirname, res=64, spp=8, voxels=16, strategy="spatial"):
    """Write the all-kinds scene (all_kinds.pbrt, ripple.bsdf, gonio.exr,
    proj.exr) into dirname -> the scene file's path."""
    write_fourier_bsdf(os.path.join(dirname, "ripple.bsdf"))
    write_light_map(os.path.join(dirname, "gonio.exr"), (32, 16), seed=1)
    write_light_map(os.path.join(dirname, "proj.exr"), (24, 24), seed=2)
    path = os.path.join(dirname, "all_kinds.pbrt")
    with open(path, "w") as f:
        f.write(all_kinds_scene_text(res, spp, voxels, strategy))
    return path


STRATIFIED = ('Sampler "stratified" "integer xsamples" 4 "integer ysamples" 4 '
              '"bool jitter" "true"')


def _knot_scene_file(dirname, text, knot):
    """Write text as scene.pbrt with its knot.ply, a knot of (n_u, n_v)
    segments, into dirname -> the scene file's path."""
    write_knot_ply(os.path.join(dirname, "knot.ply"), *knot)
    path = os.path.join(dirname, "scene.pbrt")
    with open(path, "w") as f:
        f.write(text)
    return path


def write_config2_scene(dirname, large=True, res=None):
    """Write BASELINE config 2 (scene.pbrt, knot.ply) into dirname -> the
    scene file's path; res defaults to 256 (large) or 64."""
    text = ply_scene_text('Shape "plymesh" "string filename" "knot.ply"').replace(
        'Sampler "02sequence" "integer pixelsamples" 4', STRATIFIED).replace(
        '"integer maxdepth" 4', '"integer maxdepth" 5').replace(
        "[256]", f"[{res or (256 if large else 64)}]")
    return _knot_scene_file(dirname, text, PLY_KNOT if large else KNOT[False])


CONFIG4_SCENE = """
LookAt 3 3 3  0 0 0  0 1 0
Camera "perspective" "float fov" 40 "float lensradius" 0.1 "float focaldistance" 5.196
Film "image" "integer xresolution" [{RES}] "integer yresolution" [{RES}]
Sampler "sobol" "integer pixelsamples" {SPP}
Integrator "path" "integer maxdepth" 5
WorldBegin
LightSource "infinite" "rgb L" [0.3 0.35 0.4]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8]
  Translate 0 4 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.5 0.5 0.5]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-10 -1 -10  10 -1 -10  10 -1 10  -10 -1 10]
AttributeEnd
AttributeBegin
  Material "mirror"
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-2.6 -1 -2.2  1.6 -1 -2.2  1.6 2 -2.2  -2.6 2 -2.2]
AttributeEnd
AttributeBegin
  Material "glass" "float eta" 1.5
  Shape "plymesh" "string filename" "knot.ply"
AttributeEnd
WorldEnd
"""


def write_config4_scene(dirname, large=True, res=None, spp=256):
    """Write BASELINE config 4 (scene.pbrt, knot.ply) into dirname -> the
    scene file's path; res defaults to 256 (large) or 64."""
    text = CONFIG4_SCENE.replace("{RES}", str(res or (256 if large else 64))).replace(
        "{SPP}", str(spp))
    return _knot_scene_file(dirname, text, KNOT[large])


FOG = ('MakeNamedMedium "fog" "string type" "homogeneous" "rgb sigma_a" [0.004 0.004 0.005] '
       '"rgb sigma_s" [0.02 0.022 0.026]\nMediumInterface "" "fog"\n')
SMOKE_BOX = ((-1.6, -0.98, -0.8), (1.6, 1.3, 0.8))   # the grid's box around the knot


def smoke_density(n=32, seed=0):
    """[n^3] smooth density in [0, 1], x fastest: a sum of seeded Gaussian
    blobs over a faint floor."""
    rng = np.random.default_rng(seed)
    c = (np.arange(n) + 0.5) / n
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    d = np.full(x.shape, 0.05)
    for cx, cy, cz, r, a in rng.uniform([0.2, 0.2, 0.2, 0.12, 0.5], [0.8, 0.8, 0.8, 0.3, 1.0],
                                        (8, 5)):
        d += a * np.exp(-((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2) / (2 * r * r))
    return (d / d.max()).reshape(-1)


def box_mesh(lo, hi):
    """A closed box's 12 triangles, wound so that their normals point out ->
    the trianglemesh's parameter text."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    p = np.array([[hi[i] if (k >> i) & 1 else lo[i] for i in range(3)] for k in range(8)])
    quads = [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4), (2, 6, 7, 3), (0, 4, 6, 2), (1, 3, 7, 5)]
    centre, idx = 0.5 * (lo + hi), []
    for q in quads:
        for tri in ((q[0], q[1], q[2]), (q[0], q[2], q[3])):
            a, b, c = p[list(tri)]
            n = np.cross(a - c, b - c)   # the geometric normal of (p0, p1, p2)
            idx += tri if np.dot(n, (a + b + c) / 3 - centre) > 0 else tri[::-1]
    return ('"integer indices" [{}] "point P" [{}]'.format(
        " ".join(map(str, idx)), " ".join(repr(float(v)) for v in p.reshape(-1))))


def volpath_scene_text(large=True, res=None, spp=4, grid=True, n_grid=32, seed=0) -> str:
    """The volpath scene (without grid: the fog alone) with its knot read
    from knot.ply."""
    text = ply_scene_text('Shape "plymesh" "string filename" "knot.ply"').replace(
        'Integrator "path" "integer maxdepth" 4', 'Integrator "volpath" "integer maxdepth" 5')
    text = text.replace('Sampler "02sequence" "integer pixelsamples" 4',
                        f'Sampler "02sequence" "integer pixelsamples" {spp}')
    text = text.replace("[256]", f"[{res or (256 if large else 64)}]")
    text = text.replace("LookAt", FOG + "LookAt", 1)
    if grid:
        lo, hi = SMOKE_BOX
        dens = " ".join(f"{v:.4g}" for v in smoke_density(n_grid, seed))
        text = text.replace("WorldEnd", f"""AttributeBegin
  MakeNamedMedium "smoke" "string type" "heterogeneous" "integer nx" {n_grid}
    "integer ny" {n_grid} "integer nz" {n_grid} "point p0" [{lo[0]} {lo[1]} {lo[2]}]
    "point p1" [{hi[0]} {hi[1]} {hi[2]}] "rgb sigma_a" [0.5 0.5 0.5]
    "rgb sigma_s" [2 1.8 1.5] "float g" 0.3 "float density" [{dens}]
  MediumInterface "smoke" "fog"
  Material "none"
  Shape "trianglemesh" {box_mesh(lo, hi)}
AttributeEnd
WorldEnd""")
    return text


def write_volpath_scene(dirname, large=True, res=None, spp=4, grid=True, knot=None):
    """Write the volpath scene (scene.pbrt, knot.ply) into dirname -> the
    scene file's path; res defaults to 256 (large) or 64; knot: (n_u, n_v)
    of another knot."""
    return _knot_scene_file(dirname, volpath_scene_text(large, res, spp, grid),
                            knot or KNOT[large])


def write_bdpt_scene(dirname, large=True, res=None, spp=4, integrator=None, **variant):
    """Write the bench scene (its knot read from knot.ply) under
    Integrator "bdpt" at depth 4, or under the Integrator line
    `integrator`, into dirname -> the scene file's path; res defaults to
    256 (large) or 64; variant: scene_variant's changes."""
    text = ply_scene_text('Shape "plymesh" "string filename" "knot.ply"').replace(
        'Integrator "path" "integer maxdepth" 4',
        integrator or 'Integrator "bdpt" "integer maxdepth" 4').replace(
        'Sampler "02sequence" "integer pixelsamples" 4',
        f'Sampler "02sequence" "integer pixelsamples" {spp}').replace(
        "[256]", f"[{res or (256 if large else 64)}]")
    return _knot_scene_file(dirname, scene_variant(text, **variant), KNOT[large])


def mlt_line(target="bdpt", maxdepth=4, bootstrap=65536, chains=65536, mutations=8):
    """The MLT Integrator line of the card's MLT scene: 65,536 chains take
    mutations x pixels / chains steps (8 at 256x256)."""
    return (f'Integrator "mlt" "integer maxdepth" {maxdepth} "integer bootstrapsamples" '
            f'{bootstrap} "integer chains" {chains} "integer mutationsperpixel" {mutations} '
            f'"string target" "{target}"')


def sppm_line(radius, maxdepth=5, iterations=16, photons=-1):
    """The SPPM Integrator line of the card's SPPM scene (photons -1: one a
    pixel)."""
    return (f'Integrator "sppm" "integer maxdepth" {maxdepth} "integer numiterations" '
            f'{iterations} "integer photonsperiteration" {photons} "float radius" {radius}')


def write_mlt_scene(dirname, large=True, res=None, **line):
    """The bench scene of write_bdpt_scene under mlt_line(**line)."""
    return write_bdpt_scene(dirname, large, res, integrator=mlt_line(**line))


def write_sppm_scene(dirname, radius, large=True, res=None, **line):
    """The bench scene of write_bdpt_scene under sppm_line(radius, **line)."""
    return write_bdpt_scene(dirname, large, res, integrator=sppm_line(radius, **line))


# The calibration scenes of the reference's integrator tests
# (tests/test_integrators.py): a matte sphere on a floor under a point
# light ("point"), the same under a constant infinite light ("env") or in
# a homogeneous fog ("fog"), and a point light inside an absorbing sphere
# of null material ("murk"); and a 36-triangle knot, a glass sphere and a
# floor under a quad area light and a dim infinite light ("knot").
_CAL_HEAD = """LookAt 0 2 6  0 1 0  0 1 0
Camera "perspective" "float fov" 40
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
Sampler "02sequence" "integer pixelsamples" {spp}
{integrator}
"""
_CAL_SPHERE_FLOOR = """AttributeBegin
  Material "matte" "rgb Kd" [0.6 0.4 0.3]
  Translate 0 1 0
  Shape "sphere" "float radius" 1
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.5 0.5 0.5]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-10 0 -10  10 0 -10  10 0 10  -10 0 10]
AttributeEnd
"""
_CAL_MURK = """LookAt 0 0 6  0 0 0  0 1 0
Camera "perspective" "float fov" 40
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
Sampler "02sequence" "integer pixelsamples" {spp}
{integrator}
WorldBegin
MakeNamedMedium "murk" "string type" "homogeneous"
  "rgb sigma_a" [0.8 0.8 0.8] "rgb sigma_s" [0 0 0]
AttributeBegin
  MediumInterface "" "murk"
  LightSource "point" "point from" [0 0 0] "rgb I" [30 30 30]
AttributeEnd
AttributeBegin
  Material ""
  MediumInterface "murk" ""
  Shape "sphere" "float radius" 1
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.6 0.6 0.6]
  Translate 0 -2.2 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-8 0 -8  8 0 -8  8 0 8  -8 0 8]
AttributeEnd
WorldEnd
"""
_CAL_KNOT = """LookAt 3 3 3  0 0 0  0 1 0
Camera "perspective" "float fov" 40
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
Sampler "02sequence" "integer pixelsamples" {spp}
{integrator}
WorldBegin
LightSource "infinite" "rgb L" [0.1 0.12 0.15]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [8 8 8]
  Translate 0 4 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]
AttributeEnd
AttributeBegin
  Material "plastic" "rgb Kd" [0.3 0.3 0.7] "rgb Ks" [0.3 0.3 0.3]
{knot}AttributeEnd
AttributeBegin
  Material "glass"
  Translate 1.2 -0.5 1.2
  Shape "sphere" "float radius" 0.5
AttributeEnd
AttributeBegin
  Material "matte" "rgb Kd" [0.5 0.5 0.5]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-10 -1 -10  10 -1 -10  10 -1 10  -10 -1 10]
AttributeEnd
WorldEnd
"""
CALIBRATION_SPP = {"point": 16, "env": 16, "fog": 32, "murk": 32, "knot": 16}
CALIBRATION_RES = {"point": 20, "env": 16, "fog": 16, "murk": 16, "knot": 16}


def _inline_knot(n_u=6, n_v=3):
    """The bench knot at (n_u, n_v) segments as an inline trianglemesh."""
    m = make_knot_mesh(n_u, n_v, scale=0.45)
    pts = " ".join("%.9g" % x for x in m.p.reshape(-1))
    idx = " ".join(str(int(i)) for i in m.indices.reshape(-1))
    return f'  Shape "trianglemesh" "integer indices" [{idx}]\n    "point P" [{pts}]\n'


def grid_quads_text(n, half=10.0, y=-1.0) -> str:
    """An n x n grid of quads spanning [-half, half]^2 at height y, as an
    inline trianglemesh."""
    xs = np.linspace(-half, half, n + 1)
    pts = [(x, y, z) for z in xs for x in xs]
    idx = []
    for j in range(n):
        for i in range(n):
            a, b = j * (n + 1) + i, j * (n + 1) + i + 1
            c, d = b + n + 1, a + n + 1
            idx += [a, b, c, a, c, d]
    p = " ".join("%.9g" % v for q in pts for v in q)
    return (f'  Shape "trianglemesh" "integer indices" [{" ".join(map(str, idx))}]\n'
            f'    "point P" [{p}]\n')


KD_FLOOR = (6, 10.0, -1.0)   # the kd-tree calibration scene's floor grid


def kdtree_calibration_scene(integrator, res=None, spp=None) -> str:
    """The knot calibration scene under `Accelerator "kdtree"`, its floor a
    6x6 grid of quads (110 world triangles)."""
    text = scene_variant(calibration_scene("knot", integrator, res, spp), accelerator="kdtree")
    floor = ('  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
             '    "point P" [-10 -1 -10  10 -1 -10  10 -1 10  -10 -1 10]\n')
    assert text.count(floor) == 1
    return text.replace(floor, grid_quads_text(*KD_FLOOR))


def calibration_scene(name, integrator, res=None, spp=None) -> str:
    """A calibration scene's text (see above) under the Integrator line
    `integrator`; res and spp default to the reference tests' own."""
    res = res or CALIBRATION_RES[name]
    spp = spp or CALIBRATION_SPP[name]
    kw = dict(res=res, spp=spp, integrator=integrator)
    if name == "murk":
        return _CAL_MURK.format(**kw)
    if name == "knot":
        return _CAL_KNOT.format(knot=_inline_knot(), **kw)
    light = {"point": 'LightSource "point" "point from" [0 4 2] "rgb I" [40 40 40]\n',
             "fog": 'LightSource "point" "point from" [0 4 2] "rgb I" [40 40 40]\n',
             "env": 'LightSource "infinite" "rgb L" [0.6 0.7 0.8]\n'}[name]
    text = _CAL_HEAD.format(**kw) + "WorldBegin\n" + light + _CAL_SPHERE_FLOOR + "WorldEnd\n"
    if name == "fog":
        text = ('MakeNamedMedium "fog" "string type" "homogeneous"\n'
                '  "rgb sigma_a" [0.02 0.02 0.02] "rgb sigma_s" [0.10 0.10 0.10]\n'
                '  "float g" 0.0\nMediumInterface "fog" "fog"\n') + text
    return text


def deep_kd_case(levels=72, n=2048, seed=11):
    """A hand-built kd-tree deeper than a walk's 64-entry stack, and rays
    that overflow it: a chain of `levels` interior nodes splitting x, y, z
    in turn at levels - k (k the level), each below child the next node of
    the chain and each above child a leaf, the last below child a leaf too.
    Half the rays start near the origin and run along the diagonal, so they
    cross every split and push every above leaf: the pushes past the 64th
    are dropped, and the pops past the stack read entry 63. The leaves of
    those dropped pushes list triangle 0, across the diagonal 4.3 units out,
    and entry 63's leaf lists triangle 1, further out, so a walk that kept
    the dropped entries, or read another on those pops, would find another
    hit. Every other leaf lists 0 - 6 of 46 seeded triangles anywhere in
    the box (so one to two 4-prim chunks). The rest of the rays start
    anywhere in the box in any direction; every fifth ray has t_max 40, and
    the second half is any-hit.
    -> (KdTables, triangle vertices [48,3,3], o, d, t_max, anyhit) numpy."""
    rng = np.random.default_rng(seed)
    m = 2 * levels + 1
    flags = np.full(m, LEAF, np.int32)
    flags[:levels] = np.arange(levels) % 3
    split = np.zeros(m, np.float32)
    split[:levels] = levels - np.arange(levels)
    above = np.zeros(m, np.int32)
    above[:levels] = levels + 1 + np.arange(levels)
    leaves = [list(rng.integers(2, 48, rng.integers(0, 7))) for _ in range(levels + 1)]
    for k in range(64, levels):
        leaves[1 + k] = [0] + leaves[1 + k]
    leaves[1 + 63] = [1] + leaves[1 + 63]
    counts = np.zeros(m, np.int32)
    counts[levels:] = [len(x) for x in leaves]
    offs = np.zeros(m, np.int32)
    offs[levels:] = np.cumsum(counts[levels:]) - counts[levels:]
    prims = np.asarray(sum(leaves, []), np.int32)
    u = np.array([1.0, -1.0, 0.0]) / np.sqrt(2.0)
    v = np.array([1.0, 1.0, -2.0]) / np.sqrt(6.0)
    ang = np.radians([90.0, 210.0, 330.0])
    star = 20.0 * (np.cos(ang)[:, None] * u + np.sin(ang)[:, None] * v)
    tris = np.concatenate([np.stack([3.0 + star, 12.0 + star]),
                           rng.uniform(0.0, levels, (46, 1, 3))
                           + rng.uniform(-6.0, 6.0, (46, 3, 3))]).astype(np.float32)
    tab = KdTables(flags, split, above, offs, counts, prims,
                   np.full(3, -1.0, np.float32), np.full(3, levels + 2.0, np.float32))
    half = n // 2
    o = np.concatenate([rng.uniform(0.4, 0.6, (half, 3)),
                        rng.uniform(-1.0, levels + 2.0, (n - half, 3))])
    d = np.concatenate([1.0 + rng.uniform(-1e-3, 1e-3, (half, 3)),
                        rng.normal(size=(n - half, 3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = np.full(n, np.inf, np.float32)
    tm[::5] = 40.0
    anyhit = (np.arange(n) % 2).astype(np.uint8)
    return tab, tris, o.astype(np.float32), d.astype(np.float32), tm, anyhit
