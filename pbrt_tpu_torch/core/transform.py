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


# ---------------------------------------------------------------------------
# quaternions and animated transforms (the reference's animated_transform.rs
# port, pbrt_tpu/core/transform.py:180-270)
# ---------------------------------------------------------------------------

def matrix_to_quaternion(m):
    """Rotation [3,3] -> quaternion [x, y, z, w] (host, float64)."""
    m = np.asarray(m, np.float64)
    tr = np.trace(m)
    if tr > 0.0:
        s = np.sqrt(tr + 1.0)
        w = s / 2.0
        s = 0.5 / s
        return np.array([(m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s,
                         (m[1, 0] - m[0, 1]) * s, w])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max((m[i, i] - (m[j, j] + m[k, k])) + 1.0, 0.0))
    q = np.zeros(4)
    q[i] = s * 0.5
    if s != 0.0:
        s = 0.5 / s
    q[3] = (m[k, j] - m[j, k]) * s
    q[j] = (m[j, i] + m[i, j]) * s
    q[k] = (m[k, i] + m[i, k]) * s
    return q


def quat_rows(x, y, z, w):
    """The rotation matrix of the unit quaternion (x, y, z, w), row by row,
    as 9 entries (tensors or floats)."""
    return [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
            2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
            2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]


def decompose(m):
    """M = T R S by polar iteration (to 1e-4) -> (T [3], q [4], S [3,3]),
    float64."""
    m = np.asarray(m, np.float64)
    t = m[:3, 3].copy()
    r = m[:3, :3].copy()
    for _ in range(100):
        r_next = 0.5 * (r + np.linalg.inv(r.T))
        if np.max(np.abs(r_next - r)) < 1e-4:
            r = r_next
            break
        r = r_next
    s = np.linalg.inv(r) @ m[:3, :3]
    return t, matrix_to_quaternion(r), s


class AnimatedTransform:
    """Two keyframed transforms, interpolated per lane: T and S lerped, R
    slerped (a lerp where sin(theta) < 1e-5), all in float32 as the
    reference's `interpolate` computes them.

    The instance walk (accel/instance.py) interpolates the same way but
    mirrors pbrt_tpu/accel/pallas_instance.py instead: its polar iteration
    runs to 1e-9, its quaternion is extracted and normalised otherwise, its
    guard is 1e-4 and it lerps S and T as S0 + t (S1 - S0). Only the
    quaternion's rotation rows (`quat_rows`) are shared."""

    def __init__(self, t0: Transform, time0: float, t1: Transform, time1: float):
        self.start, self.end = t0, t1
        self.time0, self.time1 = float(time0), float(time1)
        self.animated = not np.allclose(t0.m, t1.m)
        self.T0, self.R0, self.S0 = decompose(t0.m)
        self.T1, self.R1, self.S1 = decompose(t1.m)
        if np.dot(self.R0, self.R1) < 0.0:
            self.R1 = -self.R1
        # the slerp's per-transform constants, in float32
        q0, q1 = self.R0.astype(np.float32), self.R1.astype(np.float32)
        cos_t = np.clip(np.float32(np.sum(q0 * q1, dtype=np.float32)), -1.0, 1.0)
        self.theta = np.float32(np.arccos(cos_t))
        self.sin_t = np.float32(np.sin(self.theta))

    def interpolate(self, time):
        """[N] times -> [N,4,4] float32 matrices (the start matrix repeated
        where the transform does not move)."""
        import torch
        dev = time.device
        n = time.shape[0]
        if not self.animated:
            return torch.as_tensor(self.start.m, device=dev).expand(n, 4, 4)
        c = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        dt = torch.clamp((time - self.time0) / max(self.time1 - self.time0, 1e-9), 0.0, 1.0)
        T = (1.0 - dt)[:, None] * c(self.T0) + dt[:, None] * c(self.T1)
        q0, q1 = c(self.R0), c(self.R1)
        if self.sin_t < 1e-5:
            w0, w1 = 1.0 - dt, dt
        else:
            th = float(self.theta)
            w0 = torch.sin((1.0 - dt) * th) / float(self.sin_t)
            w1 = torch.sin(dt * th) / float(self.sin_t)
        q = w0[:, None] * q0 + w1[:, None] * q1
        q = q / torch.sqrt((q * q).sum(-1, keepdim=True))
        R = torch.stack(quat_rows(q[:, 0], q[:, 1], q[:, 2], q[:, 3]), -1).reshape(n, 3, 3)
        S = (1.0 - dt)[:, None, None] * c(self.S0) + dt[:, None, None] * c(self.S1)
        m = torch.zeros((n, 4, 4), device=dev)
        m[:, :3, :3] = R @ S
        m[:, :3, 3] = T
        m[:, 3, 3] = 1.0
        return m
