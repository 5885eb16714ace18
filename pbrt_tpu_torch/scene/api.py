"""Scene-compiler state machine: directives -> host SceneDescription (port of
pbrt_tpu/scene/api.py). Object instances and animated shapes become shared
prototypes behind per-instance transform pairs. Directives the port does not
cover yet (textures, media, quadrics, curves, TransformTimes other than 0 1)
raise NotImplementedError naming what they met. Triangle meshes come inline
(trianglemesh), from PLY files (plymesh) or from Loop subdivision
(loopsubdiv)."""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from pbrt_tpu_torch.core import transform as tf
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.scene.paramset import ParamSet

MAX_TRANSFORMS = 2
START_BIT, END_BIT = 1, 2
ALL_BITS = START_BIT | END_BIT


@dataclasses.dataclass
class MaterialDecl:
    kind: str
    params: ParamSet


@dataclasses.dataclass
class ShapeRecord:
    kind: str
    mesh: object = None             # TriangleMeshData
    material: int = -1
    area_light: int = -1
    reverse_orientation: bool = False


@dataclasses.dataclass
class LightRecord:
    kind: str
    params: ParamSet
    l2w: np.ndarray
    w2l: np.ndarray
    shape_index: int = -1           # area lights: index into shapes


@dataclasses.dataclass
class GraphicsState:
    material: int = 0               # 0 = the default matte
    named_materials: Dict[str, int] = dataclasses.field(default_factory=dict)
    area_light: Optional[Tuple[str, ParamSet]] = None
    reverse_orientation: bool = False

    def clone(self):
        return GraphicsState(self.material, dict(self.named_materials),
                             self.area_light, self.reverse_orientation)


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
        self.shapes: List[ShapeRecord] = []
        self.lights: List[LightRecord] = []
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
        if (t0, t1) != (0.0, 1.0):
            raise NotImplementedError("TransformTimes other than 0 1 is not ported")

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
        self.scene.camera_to_world = (self.ctm.t[0].inverse(), self.ctm.t[1].inverse())
        self.named_coord_systems["camera"] = self.ctm.clone()

    def sampler(self, kind, ps):
        self.scene.sampler_kind = kind
        self.scene.sampler_params = ps

    def film(self, kind, ps):
        if kind != "image":
            raise NotImplementedError(f"film {kind!r} is not ported")
        self.scene.film_params = ps

    def pixel_filter(self, kind, ps):
        self.scene.filter_kind = kind
        self.scene.filter_params = ps

    def integrator(self, kind, ps):
        self.scene.integrator_kind = kind
        self.scene.integrator_params = ps

    def accelerator(self, kind, ps):
        if kind != "bvh":
            raise NotImplementedError(f"accelerator {kind!r} is not ported")
        self.scene.accelerator_kind = kind
        self.scene.accelerator_params = ps

    def option(self, name, ps):
        raise NotImplementedError(f"Option {name!r} is not ported")

    # -- world -----------------------------------------------------------
    def world_begin(self):
        self.ctm = TransformSet()
        self.named_coord_systems["world"] = self.ctm.clone()

    def world_end(self):
        pass

    # -- materials -------------------------------------------------------
    def texture(self, name, ttype, tclass, ps):
        raise NotImplementedError(f"Texture {name!r} ({tclass}) is not ported")

    def _make_material(self, kind, ps: ParamSet) -> int:
        for pname in ps.values:
            if ps.is_texture(pname):
                raise NotImplementedError(
                    f"material {kind!r} parameter {pname!r} names a texture, "
                    "which is not ported")
        self.scene.materials.append(MaterialDecl(kind or "none", ps))
        return len(self.scene.materials) - 1

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
        self.scene.lights.append(LightRecord(kind, ps, l2w.m.copy(), l2w.m_inv.copy()))

    def area_light_source(self, kind, ps):
        self.gs.area_light = (kind, ps)

    # -- media: not ported ------------------------------------------------
    def make_named_medium(self, name, ps):
        raise NotImplementedError(f"MakeNamedMedium {name!r} is not ported")

    def medium_interface(self, inside, outside):
        if inside or outside:
            raise NotImplementedError(
                f"MediumInterface {inside!r} {outside!r} is not ported")

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
        CTM, and the raw instance CTM maps that space to world. Emitting
        prototypes are baked instead (geometry duplicated per instance)."""
        recs = self.objects.get(name, [])
        if recs and all(r.area_light < 0 for r in recs):
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
        """Geometry-duplicating fallback for prototypes with emitters."""
        inst = self.ctm.t[0]
        for rec in self.objects.get(name, []):
            m = rec.mesh
            r = dataclasses.replace(rec, mesh=dataclasses.replace(
                m, p=np.asarray(inst.point(m.p), np.float32),
                n=None if m.n is None else np.asarray(inst.normal(m.n), np.float32)))
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
    def _make_mesh(self, kind, ps: ParamSet, o2w):
        """A shape's triangle mesh in world space (pbrt_tpu/shapes/factory.py's
        trianglemesh, plymesh and loopsubdiv), or None for a PLY file that
        is missing, which is logged and adds no shape."""
        from pbrt_tpu_torch.shapes.triangle import TriangleMeshData, mesh_from_params
        if kind == "trianglemesh":
            return mesh_from_params(ps, o2w)
        if kind not in ("plymesh", "loopsubdiv"):
            raise NotImplementedError(f"shape {kind!r} is not ported")
        for name in ("alpha", "shadowalpha"):
            if name in ps:
                raise NotImplementedError(f"{kind} parameter {name!r} is not ported")
        if kind == "plymesh":
            from pbrt_tpu_torch.shapes.ply import read_ply
            fname = ps.find_one_string("filename", "")
            path = fname if os.path.isabs(fname) else os.path.join(self.cwd, fname)
            if not os.path.exists(path):
                logging.getLogger(__name__).warning("PLY not found: %s", path)
                return None
            v, n, uv, f = read_ply(path)
        else:
            from pbrt_tpu_torch.shapes.loopsubdiv import loop_subdivide
            levels = ps.find_one_int("levels", ps.find_one_int("nlevels", 3))
            v, f, n = loop_subdivide(ps.find_point3s("P"), ps.find_ints("indices").reshape(-1, 3),
                                     levels)
            uv = None
        return TriangleMeshData(f.astype(np.int32), np.asarray(o2w.point(v), np.float32),
                                None if n is None else np.asarray(o2w.normal(n), np.float32),
                                uv, o2w.swaps_handedness())

    def shape(self, kind, ps: ParamSet):
        o2w = self.ctm.t[0]
        mesh = self._make_mesh(kind, ps, o2w)
        if mesh is None:
            return
        rec = ShapeRecord("trianglemesh", mesh=mesh,
                          material=self.gs.material,
                          reverse_orientation=self.gs.reverse_orientation)
        if self.gs.area_light is not None:
            akind, aps = self.gs.area_light
            rec.area_light = len(self.scene.lights)
            self.scene.lights.append(LightRecord(akind if akind != "diffuse" else "area",
                                                 aps, o2w.m.copy(), o2w.m_inv.copy()))
        if self.current_object is not None:
            self.objects[self.current_object].append(rec)
        elif self.ctm.is_animated() and rec.area_light < 0:
            # an animated shape becomes an animated single-instance
            # prototype; its vertices hold the start transform, so the
            # instance's motion is the change from start to end
            self.scene.prototypes.append([rec])
            m1 = self.ctm.t[1] * self.ctm.t[0].inverse()
            self.scene.instances.append(dict(
                proto=len(self.scene.prototypes) - 1,
                m_p2w0=np.eye(4, dtype=np.float32), m_w2p0=np.eye(4, dtype=np.float32),
                m_p2w1=m1.m.copy(), m_w2p1=m1.m_inv.copy(), animated=True))
        else:
            if rec.area_light >= 0:
                self.scene.lights[rec.area_light].shape_index = len(self.scene.shapes)
            self.scene.shapes.append(rec)
