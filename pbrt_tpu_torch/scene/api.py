"""Scene-compiler state machine: directives -> host SceneDescription (port of
pbrt_tpu/scene/api.py). Object instances and animated meshes become shared
prototypes behind per-instance transform pairs; a prototype that holds a
quadric or an emitter is baked, and an animated quadric stays at its start
transform, as in the reference. Textures are named per graphics state,
float and spectrum apart; a texture, a material or a mesh's alpha mask
that names one holds its id. Named media and the medium interface of
the graphics state are recorded on the camera, every shape and every
light, by name, as the reference records them. As in the reference,
TransformTimes is stored and never read, an Option does nothing, a Film
of any kind is the image film, and any accelerator but "kdtree" builds
the BVH. The shapes are those of shapes/factory.py."""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from pbrt_tpu_torch.core import transform as tf
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.scene.paramset import ParamSet

MAX_TRANSFORMS = 2
START_BIT, END_BIT = 1, 2
ALL_BITS = START_BIT | END_BIT


@dataclasses.dataclass
class TextureDecl:
    kind: str                       # the texture class ("checkerboard", ...)
    ttype: str                      # "float" | "spectrum"
    params: ParamSet
    children: Dict[str, int] = dataclasses.field(default_factory=dict)  # param -> texture id
    world_to_texture: Optional[np.ndarray] = None   # 3D mappings
    name: str = ""


@dataclasses.dataclass
class MaterialDecl:
    kind: str
    params: ParamSet
    tex_refs: Dict[str, int] = dataclasses.field(default_factory=dict)  # param -> texture id
    children: Tuple[int, int] = (-1, -1)   # a mix's two materials


@dataclasses.dataclass
class ShapeRecord:
    kind: str
    mesh: object = None             # TriangleMeshData; None for a quadric
    material: int = -1
    area_light: int = -1
    reverse_orientation: bool = False
    quad_type: int = -1             # quadrics: shapes/quadrics.py kind id,
    quad_params: np.ndarray = None  # its [8] parameters, its area
    quad_area: float = 0.0
    o2w: np.ndarray = None          # and its object<->world matrices
    w2o: np.ndarray = None
    medium_inside: str = ""         # the MediumInterface at declaration
    medium_outside: str = ""


@dataclasses.dataclass
class LightRecord:
    kind: str
    params: ParamSet
    l2w: np.ndarray
    w2l: np.ndarray
    shape_index: int = -1           # area lights: index into shapes
    medium: str = ""                # the outside medium at declaration


@dataclasses.dataclass
class GraphicsState:
    material: int = 0               # 0 = the default matte
    named_materials: Dict[str, int] = dataclasses.field(default_factory=dict)
    area_light: Optional[Tuple[str, ParamSet]] = None
    reverse_orientation: bool = False
    float_textures: Dict[str, int] = dataclasses.field(default_factory=dict)
    spectrum_textures: Dict[str, int] = dataclasses.field(default_factory=dict)
    medium_inside: str = ""
    medium_outside: str = ""

    def clone(self):
        return GraphicsState(self.material, dict(self.named_materials),
                             self.area_light, self.reverse_orientation,
                             dict(self.float_textures), dict(self.spectrum_textures),
                             self.medium_inside, self.medium_outside)


class TransformSet:
    """CTM pair for the start and end of the shutter."""

    def __init__(self):
        self.t = [Transform(), Transform()]

    def clone(self):
        ts = TransformSet()
        ts.t = list(self.t)
        return ts

    def is_animated(self):
        return not np.allclose(self.t[0].m, self.t[1].m)


class SceneDescription:
    """Everything build.py needs, accumulated on the host."""

    def __init__(self):
        self.materials: List[MaterialDecl] = [MaterialDecl("matte", ParamSet())]
        self.textures: List[TextureDecl] = []
        self.shapes: List[ShapeRecord] = []
        self.lights: List[LightRecord] = []
        self.media: Dict[str, Tuple[str, ParamSet, np.ndarray]] = {}   # name -> (kind, ps, l2w)
        self.camera_medium_name = ""
        self.camera_kind = "perspective"
        self.camera_params = ParamSet()
        self.camera_to_world = (Transform(), Transform())
        self.sampler_kind = "halton"
        self.sampler_params = ParamSet()
        self.film_params = ParamSet()
        self.filter_kind = "box"
        self.filter_params = ParamSet()
        self.integrator_kind = "path"
        self.integrator_params = ParamSet()
        self.accelerator_kind = "bvh"
        self.accelerator_params = ParamSet()
        # shared-prototype instancing: prototypes hold geometry once;
        # instances are dicts {proto, m_p2w0, m_w2p0, m_p2w1, m_w2p1 (4x4),
        # animated} (Api.object_instance, animated shapes)
        self.prototypes: List[List[ShapeRecord]] = []
        self.instances: List[dict] = []


class Api:
    """The pbrt_* directive surface."""

    def __init__(self):
        self.scene = SceneDescription()
        self.ctm = TransformSet()
        self.active = ALL_BITS
        self.named_coord_systems: Dict[str, TransformSet] = {}
        self.gs = GraphicsState()
        self.attr_stack: List[Tuple[GraphicsState, TransformSet]] = []
        self.xform_stack: List[TransformSet] = []
        self.cwd = "."
        self.transform_times_read = (0.0, 1.0)   # stored, never read (the reference's)
        self.current_object: Optional[str] = None
        self.objects: Dict[str, List[ShapeRecord]] = {}
        self.proto_ids: Dict[str, int] = {}

    # -- transforms ------------------------------------------------------
    def _apply(self, t: Transform):
        for i in range(MAX_TRANSFORMS):
            if self.active & (1 << i):
                self.ctm.t[i] = self.ctm.t[i] * t

    def identity(self):
        for i in range(MAX_TRANSFORMS):
            if self.active & (1 << i):
                self.ctm.t[i] = Transform()

    def translate(self, x, y, z):
        self._apply(tf.translate([x, y, z]))

    def scale(self, x, y, z):
        self._apply(tf.scale([x, y, z]))

    def rotate(self, angle, x, y, z):
        self._apply(tf.rotate(angle, [x, y, z]))

    def look_at(self, ex, ey, ez, lx, ly, lz, ux, uy, uz):
        self._apply(tf.look_at([ex, ey, ez], [lx, ly, lz], [ux, uy, uz]).inverse())

    def transform(self, *m16):
        t = Transform(np.asarray(m16, np.float32).reshape(4, 4).T)
        for i in range(MAX_TRANSFORMS):
            if self.active & (1 << i):
                self.ctm.t[i] = t

    def concat_transform(self, *m16):
        self._apply(Transform(np.asarray(m16, np.float32).reshape(4, 4).T))

    def coordinate_system(self, name):
        self.named_coord_systems[name] = self.ctm.clone()

    def coord_sys_transform(self, name):
        if name in self.named_coord_systems:
            self.ctm = self.named_coord_systems[name].clone()

    def active_transform(self, which):
        self.active = {"All": ALL_BITS, "StartTime": START_BIT,
                       "EndTime": END_BIT}.get(which, ALL_BITS)

    def transform_times(self, t0, t1):
        self.transform_times_read = (t0, t1)

    def transform_begin(self):
        self.xform_stack.append(self.ctm.clone())

    def transform_end(self):
        self.ctm = self.xform_stack.pop()

    def attribute_begin(self):
        self.attr_stack.append((self.gs.clone(), self.ctm.clone()))

    def attribute_end(self):
        self.gs, self.ctm = self.attr_stack.pop()

    def reverse_orientation(self):
        self.gs.reverse_orientation = not self.gs.reverse_orientation

    # -- options ---------------------------------------------------------
    def camera(self, kind, ps):
        self.scene.camera_kind = kind
        self.scene.camera_params = ps
        self.scene.camera_medium_name = self.gs.medium_outside
        self.scene.camera_to_world = (self.ctm.t[0].inverse(), self.ctm.t[1].inverse())
        self.named_coord_systems["camera"] = self.ctm.clone()

    def sampler(self, kind, ps):
        self.scene.sampler_kind = kind
        self.scene.sampler_params = ps

    def film(self, kind, ps):
        self.scene.film_params = ps

    def pixel_filter(self, kind, ps):
        self.scene.filter_kind = kind
        self.scene.filter_params = ps

    def integrator(self, kind, ps):
        self.scene.integrator_kind = kind
        self.scene.integrator_params = ps

    def accelerator(self, kind, ps):
        self.scene.accelerator_kind = kind
        self.scene.accelerator_params = ps

    def option(self, name, ps):
        pass

    # -- world -----------------------------------------------------------
    def world_begin(self):
        self.ctm = TransformSet()
        self.named_coord_systems["world"] = self.ctm.clone()

    def world_end(self):
        pass

    # -- materials -------------------------------------------------------
    def _texture_id(self, tname, float_first):
        """A texture name -> its id in the graphics state, -1 if unknown."""
        maps = (self.gs.float_textures, self.gs.spectrum_textures)
        first, second = maps if float_first else maps[::-1]
        return first.get(tname, second.get(tname, -1))

    def texture(self, name, ttype, tclass, ps):
        decl = TextureDecl(tclass, "float" if ttype == "float" else "spectrum", ps, name=name)
        for pname in list(ps.values):
            if ps.is_texture(pname):
                tid = self._texture_id(ps.texture_name(pname), float_first=True)
                if tid >= 0:
                    decl.children[pname] = tid
        if tclass in ("checkerboard", "dots", "fbm", "wrinkled", "windy", "marble"):
            decl.world_to_texture = self.ctm.t[0].m_inv.copy()
        tid = len(self.scene.textures)
        self.scene.textures.append(decl)
        (self.gs.float_textures if decl.ttype == "float" else self.gs.spectrum_textures)[name] = tid
        return tid

    def _make_material(self, kind, ps: ParamSet) -> int:
        decl = MaterialDecl(kind or "none", ps)
        for pname in list(ps.values):
            if ps.is_texture(pname):
                tid = self._texture_id(ps.texture_name(pname), float_first=False)
                if tid >= 0:
                    decl.tex_refs[pname] = tid
        if kind == "mix":
            decl.children = tuple(self.gs.named_materials.get(
                ps.find_one_string(f"namedmaterial{i}", ""), 0) for i in (1, 2))
        self.scene.materials.append(decl)
        return len(self.scene.materials) - 1

    def _alpha_texture(self, ps: ParamSet, pname) -> int:
        """A mesh's "alpha" / "shadowalpha" -> float texture id (-1: no
        mask); a constant below 1 becomes a constant texture."""
        if ps.is_texture(pname):
            return self._texture_id(ps.texture_name(pname), float_first=True)
        vals = ps.values.get(pname)
        if vals and float(vals[0]) < 1.0:
            cps = ParamSet()
            cps.declare("float", "value", [float(vals[0])])
            self.scene.textures.append(TextureDecl("constant", "float", cps,
                                                   name=f"__alpha{len(self.scene.textures)}"))
            return len(self.scene.textures) - 1
        return -1

    def material(self, kind, ps):
        self.gs.material = self._make_material(kind, ps)

    def make_named_material(self, name, ps):
        self.gs.named_materials[name] = self._make_material(
            ps.find_one_string("type", "matte"), ps)

    def named_material(self, name):
        self.gs.material = self.gs.named_materials.get(name, 0)

    # -- lights ----------------------------------------------------------
    def light_source(self, kind, ps):
        l2w = self.ctm.t[0]
        self.scene.lights.append(LightRecord(kind, ps, l2w.m.copy(), l2w.m_inv.copy(),
                                             medium=self.gs.medium_outside))

    def area_light_source(self, kind, ps):
        self.gs.area_light = (kind, ps)

    # -- media -----------------------------------------------------------
    def make_named_medium(self, name, ps):
        self.scene.media[name] = (ps.find_one_string("type", "homogeneous"), ps,
                                  self.ctm.t[0].m.copy())

    def medium_interface(self, inside, outside):
        self.gs.medium_inside = inside
        self.gs.medium_outside = outside

    # -- instancing ------------------------------------------------------
    def object_begin(self, name):
        self.attribute_begin()
        self.current_object = name
        self.objects[name] = []

    def object_end(self):
        self.current_object = None
        self.attribute_end()

    def object_instance(self, name):
        """Instance the named prototype under the current CTM.

        Prototypes of triangle meshes without area lights share one copy of
        their geometry behind a per-instance transform pair, which also
        carries motion blur. Their vertices hold the full definition-time
        CTM, and the raw instance CTM maps that space to world. Prototypes
        with quadrics or emitters are baked instead (geometry duplicated
        per instance, at the start transform)."""
        recs = self.objects.get(name, [])
        if recs and all(r.mesh is not None and r.area_light < 0 for r in recs):
            if name not in self.proto_ids:
                self.proto_ids[name] = len(self.scene.prototypes)
                self.scene.prototypes.append(list(recs))
            m0, m1 = self.ctm.t
            self.scene.instances.append(dict(
                proto=self.proto_ids[name],
                m_p2w0=m0.m.copy(), m_w2p0=m0.m_inv.copy(),
                m_p2w1=m1.m.copy(), m_w2p1=m1.m_inv.copy(),
                animated=not np.allclose(m0.m, m1.m)))
            return
        self._bake_instance(name)

    def _bake_instance(self, name):
        """Geometry-duplicating fallback for prototypes with quadrics or
        emitters: meshes get their vertices moved, quadrics the instance
        transform composed onto theirs."""
        inst = self.ctm.t[0]
        for rec in self.objects.get(name, []):
            r = copy.copy(rec)
            if r.mesh is not None:
                m = r.mesh
                r.mesh = dataclasses.replace(
                    m, p=np.asarray(inst.point(m.p), np.float32),
                    n=None if m.n is None else np.asarray(inst.normal(m.n), np.float32))
            else:
                comb = inst * Transform(r.o2w)
                r.o2w, r.w2o = comb.m, comb.m_inv
            idx = len(self.scene.shapes)
            self.scene.shapes.append(r)
            if r.area_light >= 0:
                # each baked copy of an emitter gets its own light record
                src = self.scene.lights[r.area_light]
                r.area_light = len(self.scene.lights)
                self.scene.lights.append(LightRecord(
                    src.kind, src.params, inst.m @ src.l2w, src.w2l @ inst.m_inv,
                    shape_index=idx))

    # -- shapes ----------------------------------------------------------
    def shape(self, kind, ps: ParamSet):
        from pbrt_tpu_torch.shapes.factory import make_shapes
        o2w = self.ctm.t[0]
        for rec in make_shapes(kind, ps, o2w, self.cwd):
            if kind in ("trianglemesh", "plymesh"):
                rec.mesh.alpha_tex = self._alpha_texture(ps, "alpha")
                sa = self._alpha_texture(ps, "shadowalpha")
                rec.mesh.shadow_alpha_tex = sa if sa >= 0 else rec.mesh.alpha_tex
            rec.material = self.gs.material
            rec.reverse_orientation = self.gs.reverse_orientation
            rec.medium_inside = self.gs.medium_inside
            rec.medium_outside = self.gs.medium_outside
            if self.gs.area_light is not None:
                akind, aps = self.gs.area_light
                rec.area_light = len(self.scene.lights)
                self.scene.lights.append(LightRecord(akind if akind != "diffuse" else "area",
                                                     aps, o2w.m.copy(), o2w.m_inv.copy()))
            if self.current_object is not None:
                self.objects[self.current_object].append(rec)
            elif self.ctm.is_animated() and rec.mesh is not None and rec.area_light < 0:
                # an animated mesh becomes an animated single-instance
                # prototype; its vertices hold the start transform, so the
                # instance's motion is the change from start to end
                self.scene.prototypes.append([rec])
                m1 = self.ctm.t[1] * self.ctm.t[0].inverse()
                self.scene.instances.append(dict(
                    proto=len(self.scene.prototypes) - 1,
                    m_p2w0=np.eye(4, dtype=np.float32), m_w2p0=np.eye(4, dtype=np.float32),
                    m_p2w1=m1.m.copy(), m_w2p1=m1.m_inv.copy(), animated=True))
            else:
                # a quadric (animated or not) and an emitter stay static at
                # the start transform
                if rec.area_light >= 0:
                    self.scene.lights[rec.area_light].shape_index = len(self.scene.shapes)
                self.scene.shapes.append(rec)
