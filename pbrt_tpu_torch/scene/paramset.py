"""Typed parameter sets from .pbrt declarations (port of
pbrt_tpu/scene/paramset.py). Host-side; spectral inputs become RGB here."""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from pbrt_tpu_torch.core.spectrum import blackbody_normalized_rgb, spd_to_rgb, xyz_to_rgb

SPECTRAL_TYPES = {"rgb", "color", "xyz", "blackbody", "spectrum"}
ALL_TYPES = {"integer", "float", "point2", "vector2", "point3", "vector3",
             "point", "vector", "normal", "string", "bool", "texture"} | SPECTRAL_TYPES


class ParamSet:
    """name -> values with declared types."""

    def __init__(self):
        self.values: Dict[str, list] = {}
        self.types: Dict[str, str] = {}

    def declare(self, ptype: str, name: str, raw: list, cwd: str = "."):
        if ptype == "integer":
            vals = [int(v) for v in raw]
        elif ptype in ("float", "rgb", "color", "point", "point3", "vector",
                       "vector3", "normal", "point2", "vector2"):
            vals = [float(v) for v in raw]
        elif ptype == "bool":
            vals = [str(v).strip('"') in ("true", "True") for v in raw]
        elif ptype in ("string", "texture"):
            vals = [str(v).strip('"') for v in raw]
        elif ptype == "xyz":
            arr = np.asarray([float(v) for v in raw], np.float32).reshape(-1, 3)
            vals = list(np.maximum(xyz_to_rgb(arr), 0.0).reshape(-1))
        elif ptype == "blackbody":
            arr = [float(v) for v in raw]
            vals = []
            for i in range(0, len(arr), 2):
                s = arr[i + 1] if i + 1 < len(arr) else 1.0
                vals.extend(blackbody_normalized_rgb(arr[i], s).tolist())
        elif ptype == "spectrum":
            if raw and isinstance(raw[0], str):
                path = os.path.join(cwd, raw[0].strip('"'))
                try:
                    data = np.loadtxt(path).reshape(-1, 2)
                    vals = list(spd_to_rgb(data[:, 0], data[:, 1]))
                except OSError:
                    vals = [0.5, 0.5, 0.5]
            else:
                arr = np.asarray([float(v) for v in raw], np.float32).reshape(-1, 2)
                vals = list(spd_to_rgb(arr[:, 0], arr[:, 1]))
        else:
            raise ValueError(f"unknown param type {ptype!r}")
        self.values[name] = vals
        self.types[name] = ptype

    def __contains__(self, name):
        return name in self.values

    def find_one_float(self, name, default):
        v = self.values.get(name)
        return float(v[0]) if v else float(default)

    def find_one_int(self, name, default):
        v = self.values.get(name)
        return int(v[0]) if v else int(default)

    def find_one_bool(self, name, default):
        v = self.values.get(name)
        return bool(v[0]) if v else bool(default)

    def find_ints(self, name):
        v = self.values.get(name)
        return None if v is None else np.asarray(v, np.int32)

    def find_floats(self, name):
        v = self.values.get(name)
        return None if v is None else np.asarray(v, np.float32)

    def find_point3s(self, name):
        v = self.values.get(name)
        return None if v is None else np.asarray(v, np.float32).reshape(-1, 3)

    def find_one_string(self, name, default):
        v = self.values.get(name)
        return str(v[0]) if v else str(default)

    def find_one_rgb(self, name, default):
        """First 3-vector of a spectral or geometric parameter."""
        v = self.values.get(name)
        t = self.types.get(name)
        if v and (t in SPECTRAL_TYPES or t in ("point", "point3", "vector",
                                               "vector3", "normal")):
            if len(v) >= 3:
                return np.asarray(v[:3], np.float32)
            return np.full(3, float(v[0]), np.float32)
        if v and t in ("float", "integer"):
            return np.full(3, float(v[0]), np.float32)
        return np.asarray(default, np.float32)

    def is_texture(self, name):
        return self.types.get(name) == "texture"

    def texture_name(self, name):
        return self.find_one_string(name, "")

    def as_plain_dict(self):
        return dict(self.values)

    def __repr__(self):
        return f"ParamSet({self.types})"
