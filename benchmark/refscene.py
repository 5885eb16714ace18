"""The plain reference's own reading of a benchmark scene: a pbrt-v3 scene
file and the meshes it names, into flat NumPy arrays.

It reads pbrt-v3's syntax and its transform and attribute directives
(LookAt, Translate, Scale, Rotate, Identity, Transform, ConcatTransform,
TransformBegin / TransformEnd, AttributeBegin / AttributeEnd, WorldBegin /
WorldEnd), and skips Accelerator, which
does not change the image: the reference builds its own acceleration.
Every other kind of thing it finds by name, in a file of its own
(plugins.py): Shape <kind> in shapes/, Material in materials/, LightSource
in lights/, AreaLightSource in area_lights/; Camera, Sampler and
Integrator are looked up when the reference is built. A directive that it
does not read (ReverseOrientation, Texture, named materials, PixelFilter,
media, object instances, Include, ...) and a kind that has no file fail loudly, so a
scene it cannot render fails instead of rendering something else.
Defaults are pbrt-v3's: matte of Kd 0.5 before any Material, and a
triangle's uv (0,0), (1,0), (1,1) where its mesh gives none.
"""
from __future__ import annotations

import math
import os
import re

import numpy as np

import plugins

_TOKEN = re.compile(r'"[^"]*"|\[|\]|[^\s\[\]"]+')
SKIPPED = {"Accelerator"}
NO_PARAMS = {"LookAt", "Translate", "Scale", "Rotate", "Transform", "ConcatTransform",
             "Identity", "TransformBegin", "TransformEnd", "AttributeBegin", "AttributeEnd",
             "WorldBegin", "WorldEnd"}


def _tokens(text):
    text = re.sub(r"#[^\n]*", "", text)
    return _TOKEN.findall(text)


def _directives(text):
    """-> [(name, [positional args], {param name: (type, [values])})]."""
    toks = _tokens(text)
    out, i = [], 0
    while i < len(toks):
        name = toks[i]
        if not name[0].isalpha():
            raise ValueError(f"scene: unexpected token {name!r}")
        i += 1
        args, params = [], {}
        while i < len(toks) and not toks[i][0].isalpha():
            t = toks[i]
            if t.startswith('"') and " " in t.strip('"') and name not in NO_PARAMS:
                ptype, pname = t.strip('"').split()
                i += 1
                if toks[i] == "[":
                    j = toks.index("]", i)
                    vals = toks[i + 1:j]
                    i = j + 1
                else:
                    vals = [toks[i]]
                    i += 1
                params[pname] = (ptype, [_value(ptype, v) for v in vals])
            elif t in ("[", "]"):
                i += 1
            else:
                args.append(t.strip('"') if t.startswith('"') else float(t))
                i += 1
        out.append((name, args, params))
    return out


def _value(ptype, v):
    if ptype in ("string", "bool"):
        s = v.strip('"')
        return s == "true" if ptype == "bool" else s
    if ptype == "integer":
        return int(v)
    return float(v)


def look_at(pos, look, up):
    """pbrt-v3's LookAt -> camera-to-world [4,4] (float64)."""
    pos, look, up = (np.asarray(a, np.float64) for a in (pos, look, up))
    d = look - pos
    d /= np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    right /= np.linalg.norm(right)
    new_up = np.cross(d, right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, new_up, d, pos
    return m


def _rotate(theta, axis):
    """pbrt-v3's Rotate: theta degrees about axis -> [4,4]."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s, c = math.sin(math.radians(theta)), math.cos(math.radians(theta))
    m = np.eye(4)
    m[0, :3] = [a[0] * a[0] + (1 - a[0] * a[0]) * c, a[0] * a[1] * (1 - c) - a[2] * s,
                a[0] * a[2] * (1 - c) + a[1] * s]
    m[1, :3] = [a[0] * a[1] * (1 - c) + a[2] * s, a[1] * a[1] + (1 - a[1] * a[1]) * c,
                a[1] * a[2] * (1 - c) - a[0] * s]
    m[2, :3] = [a[0] * a[2] * (1 - c) - a[1] * s, a[1] * a[2] * (1 - c) + a[0] * s,
                a[2] * a[2] + (1 - a[2] * a[2]) * c]
    return m


def _transform(name, args):
    """A transform directive -> (matrix, its inverse), or None."""
    if name == "Translate":
        m, inv = np.eye(4), np.eye(4)
        m[:3, 3], inv[:3, 3] = args[:3], -np.asarray(args[:3], np.float64)
        return m, inv
    if name == "Scale":
        return (np.diag([*args[:3], 1.0]),
                np.diag([1.0 / args[0], 1.0 / args[1], 1.0 / args[2], 1.0]))
    if name == "Rotate":
        m = _rotate(args[0], args[1:4])
        return m, m.T
    if name == "LookAt":
        c2w = look_at(args[0:3], args[3:6], args[6:9])
        return np.linalg.inv(c2w), c2w
    if name in ("Transform", "ConcatTransform"):
        m = np.asarray(args[:16], np.float64).reshape(4, 4).T
        return m, np.linalg.inv(m)
    return None


class Scene:
    """Every triangle of the world, flat: p [T,3,3], n [T,3,3] with has_n
    [T], uv [T,3,2], material [T] (an index into materials: (kind, its
    module's parsed parameters)), light [T] (an index into lights, -1 for
    none); lights: the objects of lights/ and area_lights/ modules; the
    camera (kind, parameters, camera-to-world), film, sampler and
    integrator parameters as given."""

    def __init__(self, path):
        self.dir = os.path.dirname(os.path.abspath(path))
        with open(path) as f:
            text = f.read()
        self.materials = [("matte", plugins.load("materials", "matte").parse({}))]
        self.lights = []
        ps, ns, uvs, has_n, mats, lts = [], [], [], [], [], []
        ctm, ctm_inv = np.eye(4), np.eye(4)
        stack, tstack = [], []
        mat, area = ("matte", {}), None
        resolved = {}
        self.camera = self.film = self.sampler = self.integrator = None
        for name, args, params in _directives(text):
            tr = _transform(name, args)
            if name == "Transform":
                ctm, ctm_inv = tr
            elif tr is not None:
                ctm, ctm_inv = ctm @ tr[0], tr[1] @ ctm_inv
            elif name == "Identity":
                ctm, ctm_inv = np.eye(4), np.eye(4)
            elif name in SKIPPED:
                pass
            elif name == "Camera":
                # pbrt-v3: the transform before Camera is camera-from-world
                self.camera = (args[0], params, ctm_inv)
            elif name == "Film":
                self.film = params
            elif name == "Sampler":
                self.sampler = (args[0], params)
            elif name == "Integrator":
                self.integrator = (args[0], params)
            elif name in ("WorldBegin", "WorldEnd"):
                ctm, ctm_inv = np.eye(4), np.eye(4)
            elif name == "AttributeBegin":
                stack.append((ctm, ctm_inv, mat, area))
            elif name == "AttributeEnd":
                ctm, ctm_inv, mat, area = stack.pop()
            elif name == "TransformBegin":
                tstack.append((ctm, ctm_inv))
            elif name == "TransformEnd":
                ctm, ctm_inv = tstack.pop()
            elif name == "LightSource":
                self.lights.append(plugins.load("lights", args[0]).make(params, ctm))
            elif name == "AreaLightSource":
                area = (args[0], params)
            elif name == "Material":
                mat = (args[0], params)
            elif name == "Shape":
                if np.linalg.det(ctm[:3, :3]) < 0:
                    raise ValueError("scene: a shape under a transform that swaps handedness "
                                     "is not read")
                key = id(mat)
                if key not in resolved:
                    resolved[key] = (mat, len(self.materials))
                    self.materials.append((mat[0], plugins.load("materials", mat[0]).parse(mat[1])))
                mi = resolved[key][1]
                p, n, uv, idx = plugins.load("shapes", args[0]).triangles(params, self.dir)
                p = p @ ctm[:3, :3].T + ctm[:3, 3]
                if n is not None:
                    n = n @ np.linalg.inv(ctm[:3, :3])
                T = idx.shape[0]
                ps.append(p[idx])
                ns.append(n[idx] if n is not None else np.zeros((T, 3, 3)))
                has_n.append(np.full(T, n is not None))
                uvs.append(uv[idx] if uv is not None
                           else np.tile(np.array([[0, 0], [1, 0], [1, 1]], np.float64), (T, 1, 1)))
                mats.append(np.full(T, mi))
                light = -1
                if area is not None:
                    self.lights.append(plugins.load("area_lights", area[0]).make(
                        area[1], p[idx].astype(np.float32)))
                    light = len(self.lights) - 1
                lts.append(np.full(T, light))
            else:
                raise ValueError(f"scene: directive {name!r} is not read")
        self.p = np.concatenate(ps).astype(np.float32)
        self.n = np.concatenate(ns).astype(np.float32)
        self.has_n = np.concatenate(has_n)
        self.uv = np.concatenate(uvs).astype(np.float32)
        self.material = np.concatenate(mats)
        self.light = np.concatenate(lts)
        lo, hi = self.p.reshape(-1, 3).min(0), self.p.reshape(-1, 3).max(0)
        self.world_radius = float(np.linalg.norm(hi.astype(np.float64) - lo) * 0.5 + 1e-6)

    @property
    def n_tris(self):
        return int(self.p.shape[0])
