"""Host 4x4 transforms (port of pbrt_tpu/core/transform.py, numpy only).

Scene compilation composes transforms on the host in numpy; the device
applies finished matrices with core/math.py xform_point/xform_vector.
"""
from __future__ import annotations

import numpy as np


class Transform:
    """Immutable (matrix, inverse) pair."""

    __slots__ = ("m", "m_inv")

    def __init__(self, m=None, m_inv=None):
        if m is None:
            m = np.eye(4, dtype=np.float32)
        m = np.asarray(m, np.float32).reshape(4, 4)
        if m_inv is None:
            m_inv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
        else:
            m_inv = np.asarray(m_inv, np.float32).reshape(4, 4)
        self.m = m
        self.m_inv = m_inv

    def __mul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def swaps_handedness(self) -> bool:
        return float(np.linalg.det(self.m[:3, :3])) < 0.0

    def point(self, p):
        return apply_point(self.m, p)

    def vector(self, v):
        return np.asarray(v, np.float32) @ self.m[:3, :3].T

    def normal(self, n):
        return np.asarray(n, np.float32) @ self.m_inv[:3, :3]


def apply_point(m, p):
    p = np.asarray(p, np.float32)
    m = np.asarray(m, np.float32)
    out = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3].T + m[3, 3]
    return np.where(w[..., None] == 1.0, out, out / w[..., None])


def translate(d):
    d = np.asarray(d, np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = d
    mi = np.eye(4, dtype=np.float32)
    mi[:3, 3] = -d
    return Transform(m, mi)


def scale(s):
    s = np.asarray(s, np.float32)
    m = np.diag(np.append(s, 1.0)).astype(np.float32)
    mi = np.diag(np.append(1.0 / s, 1.0)).astype(np.float32)
    return Transform(m, mi)


def rotate(angle_deg, axis):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s = np.sin(np.radians(angle_deg))
    c = np.cos(np.radians(angle_deg))
    m = np.eye(4)
    for i in range(3):
        for j in range(3):
            m[i, j] = a[i] * a[j] * (1 - c) + (c if i == j else 0.0)
    m[0, 1] -= a[2] * s
    m[0, 2] += a[1] * s
    m[1, 0] += a[2] * s
    m[1, 2] -= a[0] * s
    m[2, 0] -= a[1] * s
    m[2, 1] += a[0] * s
    return Transform(m.astype(np.float32), m.T.astype(np.float32))


def look_at(eye, look, up):
    """Camera-to-world transform."""
    eye = np.asarray(eye, np.float64)
    look = np.asarray(look, np.float64)
    up = np.asarray(up, np.float64)
    d = look - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    rn = np.linalg.norm(right)
    if rn < 1e-10:
        right = np.cross(np.array([0.0, 1.0, 0.0]) if abs(d[1]) < 0.9
                         else np.array([1.0, 0.0, 0.0]), d)
        rn = np.linalg.norm(right)
    right /= rn
    new_up = np.cross(d, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = new_up
    c2w[:3, 2] = d
    c2w[:3, 3] = eye
    return Transform(c2w.astype(np.float32))


def orthographic(znear, zfar):
    """Camera-to-screen orthographic projection."""
    return scale([1.0, 1.0, 1.0 / (zfar - znear)]) * translate([0.0, 0.0, -znear])


def perspective(fov_deg, n, f):
    """Camera-to-screen perspective projection."""
    persp = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                      [0, 0, f / (f - n), -f * n / (f - n)], [0, 0, 1, 0]],
                     np.float64)
    inv_tan = 1.0 / np.tan(np.radians(fov_deg) / 2.0)
    return scale([inv_tan, inv_tan, 1.0]) * Transform(persp.astype(np.float32))
