"""Vector helpers over [..., 3] float32 tensors (port of pbrt_tpu/core/math.py).

Components are written out (x*x' + y*y' + z*z', left to right) instead of
reduced, so a value is computed in the same order on every device.
"""
from __future__ import annotations

import torch

INF = float("inf")
PI = 3.14159265358979323846
INV_PI = 1.0 / PI
INV_4PI = 1.0 / (4.0 * PI)
PI_OVER_2 = PI / 2.0
PI_OVER_4 = PI / 4.0
ONE_MINUS_EPSILON = 1.0 - 2.0 ** -24
MACHINE_EPSILON = 1.1920929e-07 * 0.5


def gamma_bound(n):
    """pbrt's gamma(n) = n*eps/(1-n*eps) rounding-error bound."""
    ne = n * MACHINE_EPSILON
    return ne / (1.0 - ne)


def vec3(x, y, z):
    x, y, z = torch.broadcast_tensors(x, y, z)
    return torch.stack([x, y, z], -1)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def absdot(a, b):
    return torch.abs(dot(a, b))


def diff_of_products(a, b, c, d):
    """a*b - c*d with the reference's error-correction term."""
    cd = c * d
    err = (-c) * d + cd
    return (a * b - cd) + err


def quadratic(a, b, c):
    """Roots of a t^2 + b t + c = 0 -> (has_solution, t0, t1), t0 <= t1;
    the t values are garbage where has_solution is false. The discriminant
    is a difference of products; a == 0 takes the linear root."""
    discrim = diff_of_products(b, b, 4.0 * a, c)
    has = discrim >= 0.0
    root = torch.sqrt(torch.clamp(discrim, min=0.0))
    q = torch.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    t0 = q / torch.where(a == 0.0, 1.0, a)
    t1 = c / torch.where(q == 0.0, 1.0, q)
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    lin = a == 0.0
    lin_t = -c / torch.where(b == 0.0, 1.0, b)
    return (torch.where(lin, b != 0.0, has), torch.where(lin, lin_t, lo),
            torch.where(lin, lin_t, hi))


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return vec3(diff_of_products(ay, bz, az, by),
                diff_of_products(az, bx, ax, bz),
                diff_of_products(ax, by, ay, bx))


def length_squared(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(length_squared(v))


def normalize(v):
    return v * torch.rsqrt(torch.clamp(length_squared(v), min=1e-20))[..., None]


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


def spherical_theta(v):
    return torch.acos(torch.clamp(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + 2.0 * PI, p)


def face_forward(n, v):
    """Flip n into the hemisphere of v."""
    return torch.where((dot(n, v) < 0.0)[..., None], -n, n)


def max_component(v):
    return torch.amax(v, -1)


def coordinate_system(v1):
    """Branchless orthonormal frame (v2, v3) around unit v1 (Duff et al.)."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = x * y * a
    v2 = vec3(1.0 + sign * x * x * a, sign * b, -sign * x)
    v3 = vec3(b, sign + y * y * a, -y)
    return v2, v3


def next_float_up(x):
    xi = x.view(torch.int32)
    out = torch.where(x >= 0.0, xi + 1, xi - 1).view(torch.float32)
    # -0.0 == 0.0, so both zeros go to the smallest positive denormal
    return torch.where(x == INF, x, torch.where(x == 0.0, 1e-45, out))


def next_float_down(x):
    xi = x.view(torch.int32)
    out = torch.where(x > 0.0, xi - 1, xi + 1).view(torch.float32)
    return torch.where(x == -INF, x, torch.where(x == 0.0, -1e-45, out))


def offset_ray_origin(p, p_err, n, w):
    """Offset a spawned ray origin along n past the hit's error bound."""
    d = dot(torch.abs(n), p_err)
    offset = d[..., None] * n
    offset = torch.where((dot(w, n) < 0.0)[..., None], -offset, offset)
    po = p + offset
    return torch.where(offset > 0.0, next_float_up(po),
                       torch.where(offset < 0.0, next_float_down(po), po))


def xform_point(m, p):
    """Host [4,4] matrix (numpy) applied to [..., 3] points, no divide."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return vec3(*(float(m[i, 0]) * x + float(m[i, 1]) * y + float(m[i, 2]) * z
                  + float(m[i, 3]) for i in range(3)))


def xform_vector(m, v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return vec3(*(float(m[i, 0]) * x + float(m[i, 1]) * y + float(m[i, 2]) * z
                  for i in range(3)))
