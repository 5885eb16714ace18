"""Reconstruction filters (port of pbrt_tpu/filters/__init__.py): box,
triangle, gaussian, mitchell and windowed sinc, and the 16x16 table the
film deposit reads. Host numpy."""
from __future__ import annotations

import dataclasses

import numpy as np

FILTER_TABLE_WIDTH = 16


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    kind: str = "box"
    xwidth: float = 0.5
    ywidth: float = 0.5
    alpha: float = 2.0       # gaussian
    b: float = 1.0 / 3.0     # mitchell
    c: float = 1.0 / 3.0     # mitchell
    tau: float = 3.0         # sinc (lanczos window)

    @property
    def radius(self):
        return (self.xwidth, self.ywidth)


_DEFAULT_WIDTH = {"box": 0.5, "triangle": 2.0, "gaussian": 2.0,
                  "mitchell": 2.0, "sinc": 4.0}


def make_filter(kind: str, params: dict) -> FilterSpec:
    w = _DEFAULT_WIDTH.get(kind)
    if w is None:
        raise NotImplementedError(f"filter {kind!r} is not ported")
    return FilterSpec(kind, float(params.get("xwidth", [w])[0]),
                      float(params.get("ywidth", [w])[0]),
                      alpha=float(params.get("alpha", [2.0])[0]),
                      b=float(params.get("B", [1.0 / 3.0])[0]),
                      c=float(params.get("C", [1.0 / 3.0])[0]),
                      tau=float(params.get("tau", [3.0])[0]))


def _mitchell_1d(x, b, c):
    x = np.abs(2.0 * x)
    big = ((-b - 6 * c) * x ** 3 + (6 * b + 30 * c) * x ** 2
           + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) * (1.0 / 6.0)
    small = ((12 - 9 * b - 6 * c) * x ** 3 + (-18 + 12 * b + 6 * c) * x ** 2
             + (6 - 2 * b)) * (1.0 / 6.0)
    return np.where(x > 1.0, big, small) * (x < 2.0)


def _sinc_windowed(x, radius, tau):
    x = np.abs(x)

    def sinc(v):
        v = np.where(np.abs(v) < 1e-5, 1e-5, v)
        return np.sin(np.pi * v) / (np.pi * v)
    return np.where(x > radius, 0.0, sinc(x) * sinc(x / tau))


def evaluate(spec: FilterSpec, x, y):
    """Filter value at offsets (x, y) from the sample point."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    rx, ry = spec.xwidth, spec.ywidth
    inside = (np.abs(x) <= rx) & (np.abs(y) <= ry)
    if spec.kind == "box":
        v = np.ones_like(x)
    elif spec.kind == "triangle":
        v = np.maximum(0.0, rx - np.abs(x)) * np.maximum(0.0, ry - np.abs(y))
    elif spec.kind == "gaussian":
        a = spec.alpha
        v = np.maximum(0.0, np.exp(-a * x * x) - np.exp(-a * rx * rx)) * \
            np.maximum(0.0, np.exp(-a * y * y) - np.exp(-a * ry * ry))
    elif spec.kind == "mitchell":
        v = _mitchell_1d(x / rx, spec.b, spec.c) * _mitchell_1d(y / ry, spec.b, spec.c)
    elif spec.kind == "sinc":
        v = _sinc_windowed(x, rx, spec.tau) * _sinc_windowed(y, ry, spec.tau)
    else:
        raise NotImplementedError(spec.kind)
    return (v * inside).astype(np.float32)


def build_table(spec: FilterSpec, width: int = FILTER_TABLE_WIDTH):
    """[width, width] table over the positive quadrant."""
    ix = (np.arange(width) + 0.5) / width * spec.xwidth
    iy = (np.arange(width) + 0.5) / width * spec.ywidth
    X, Y = np.meshgrid(ix, iy, indexing="xy")
    return evaluate(spec, X, Y)
