"""Monte-Carlo warps and the 1D sampling distribution (port of the parts of
pbrt_tpu/core/sampling.py that the slice's lights and BSDFs use)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch.core.math import INV_PI, PI, PI_OVER_2, PI_OVER_4, vec3, ONE_MINUS_EPSILON


def uniform_sample_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * u[..., 1]
    return vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def concentric_sample_disk(u):
    """Shirley-Chiu concentric map, branchless."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    safe_x = torch.where(ox == 0.0, 1.0, ox)
    safe_y = torch.where(oy == 0.0, 1.0, oy)
    theta = torch.where(use_x, PI_OVER_4 * (oy / safe_x),
                        PI_OVER_2 - PI_OVER_4 * (ox / safe_y))
    x = torch.where(zero, 0.0, r * torch.cos(theta))
    y = torch.where(zero, 0.0, r * torch.sin(theta))
    return torch.stack([x, y], -1)


def cosine_sample_hemisphere(u):
    d = concentric_sample_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return vec3(d[..., 0], d[..., 1], z)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def uniform_sample_cone(u, cos_theta_max):
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = u[..., 1] * 2.0 * PI
    return vec3(torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * PI * (1.0 - cos_theta_max))


def uniform_sample_triangle(u):
    """Barycentrics (b0, b1) from a uniform square sample."""
    su0 = torch.sqrt(torch.clamp(u[..., 0], min=0.0))
    return torch.stack([1.0 - su0, u[..., 1] * su0], -1)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """Beta=2 power heuristic for MIS."""
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    pos = denom > 0.0
    return torch.where(pos, f * f / torch.where(pos, denom, 1.0), 0.0)


@dataclasses.dataclass
class Distribution1D:
    """Piecewise-constant 1D distribution: func [n], cdf [n+1], func_int."""
    func: torch.Tensor
    cdf: torch.Tensor
    func_int: float

    @staticmethod
    def tables(f):
        """Host numpy (func, cdf, func_int), as the reference builds them."""
        f = np.maximum(np.asarray(f, np.float32), 0.0)
        n = f.shape[-1]
        cdf = np.concatenate([np.zeros(1, np.float32),
                              np.cumsum(f, dtype=np.float64).astype(np.float32) / n])
        func_int = np.float32(cdf[-1])
        if func_int > 0.0:
            cdf = cdf / func_int
        else:
            cdf = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
        cdf[-1] = 1.0
        return f, cdf.astype(np.float32), func_int

    @staticmethod
    def from_tables(func, cdf, func_int, device) -> "Distribution1D":
        return Distribution1D(torch.as_tensor(np.array(func, np.float32), device=device),
                              torch.as_tensor(np.array(cdf, np.float32), device=device),
                              float(np.float32(func_int)))

    @property
    def count(self):
        return self.func.shape[-1]

    def sample_discrete(self, u):
        """(offset, pmf, u_remapped)."""
        n = self.count
        offset = torch.clamp(torch.searchsorted(self.cdf, u, right=True) - 1, 0, n - 1)
        pmf = self.discrete_pdf(offset)
        c0 = self.cdf[offset]
        c1 = self.cdf[offset + 1]
        ok = c1 > c0
        u_remap = torch.where(ok, (u - c0) / torch.where(ok, c1 - c0, 1.0), 0.0)
        return offset, pmf, torch.clamp(u_remap, max=ONE_MINUS_EPSILON)

    def discrete_pdf(self, index):
        if self.func_int <= 0.0:
            return torch.zeros(index.shape, dtype=torch.float32, device=index.device)
        denom = torch.tensor(self.func_int, dtype=torch.float32) * self.count
        return self.func[index] / denom.item()


@dataclasses.dataclass
class Distribution2D:
    """2D piecewise-constant distribution (the environment map's importance
    sampling): row-conditional CDFs [h, w+1] and the marginal CDF over rows
    [h+1]. A row whose integral is 0 keeps a flat CDF and gets pdf 0."""
    cond_func: torch.Tensor     # [h, w]
    cond_cdf: torch.Tensor      # [h, w+1]
    cond_int: torch.Tensor      # [h]
    marg_func: torch.Tensor     # [h]
    marg_cdf: torch.Tensor      # [h+1]
    marg_int: float             # on the host, and as a 0-dim tensor beside it
    marg_int_t: torch.Tensor = None

    def __post_init__(self):
        if self.marg_int_t is None:
            self.marg_int_t = torch.tensor(self.marg_int, dtype=torch.float32,
                                           device=self.marg_func.device)

    @staticmethod
    def tables(f):
        """Host numpy (cond_func, cond_cdf, cond_int, marg_func, marg_cdf,
        marg_int) of f [h, w], as the reference builds them."""
        f = np.maximum(np.asarray(f, np.float32), 0.0)
        h, w = f.shape
        cond_cdf = np.concatenate([np.zeros((h, 1), np.float32),
                                   np.cumsum(f, -1, dtype=np.float64).astype(np.float32) / w],
                                  -1)
        cond_int = cond_cdf[:, -1].copy()
        safe = np.where(cond_int > 0, cond_int, 1.0)
        cond_cdf = np.where(cond_int[:, None] > 0, cond_cdf / safe[:, None],
                            np.linspace(0, 1, w + 1, dtype=np.float32)[None])
        cond_cdf[:, -1] = 1.0
        marg_cdf = np.concatenate(
            [[0.0], np.cumsum(cond_int, dtype=np.float64).astype(np.float32) / h])
        marg_int = marg_cdf[-1].copy()
        if marg_int > 0:
            marg_cdf = marg_cdf / marg_int
        else:
            marg_cdf = np.linspace(0, 1, h + 1, dtype=np.float32)
        marg_cdf[-1] = 1.0
        return (f, cond_cdf.astype(np.float32), cond_int, cond_int,
                marg_cdf.astype(np.float32), np.float32(marg_int))

    @staticmethod
    def from_tables(cond_func, cond_cdf, cond_int, marg_func, marg_cdf, marg_int,
                    device) -> "Distribution2D":
        t = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)
        return Distribution2D(t(cond_func), t(cond_cdf), t(cond_int), t(marg_func),
                              t(marg_cdf), float(np.float32(marg_int)))

    def indices(self, u):
        """The row and column u [N, 2] falls in -> (iy, ix, the row's CDF
        [N, w+1]): the count of CDF entries <= u, less one, clamped."""
        h, w = self.cond_func.shape
        iy = torch.clamp(torch.searchsorted(self.marg_cdf, u[:, 1].contiguous(), right=True) - 1,
                         0, h - 1)
        row = self.cond_cdf[iy]
        ix = torch.clamp(torch.searchsorted(row, u[:, 0, None].contiguous(), right=True)[:, 0] - 1,
                         0, w - 1)
        return iy, ix, row

    def sample_continuous(self, u):
        """u [N, 2] -> ((x, y) in [0,1)^2 [N, 2], pdf [N])."""
        h, w = self.cond_func.shape
        iy, ix, row = self.indices(u)
        c0, c1 = self.marg_cdf[iy], self.marg_cdf[iy + 1]
        ok = c1 > c0
        dy = torch.where(ok, (u[:, 1] - c0) / torch.where(ok, c1 - c0, 1.0), 0.0)
        pdf_y = self.marg_func[iy] / self.marg_int_t if self.marg_int > 0 else \
            torch.zeros_like(dy)
        y = (iy.to(torch.float32) + dy) / h
        ux = u[:, 0]
        r0 = row.gather(1, ix[:, None])[:, 0]
        r1 = row.gather(1, (ix + 1)[:, None])[:, 0]
        ok = r1 > r0
        dx = torch.where(ok, (ux - r0) / torch.where(ok, r1 - r0, 1.0), 0.0)
        ci = self.cond_int[iy]
        pdf_x = torch.where(ci > 0, self.cond_func[iy, ix] / torch.where(ci > 0, ci, 1.0), 0.0)
        x = (ix.to(torch.float32) + dx) / w
        return torch.stack([x, y], -1), pdf_x * pdf_y

    def pdf(self, uv):
        h, w = self.cond_func.shape
        ix = torch.clamp((uv[:, 0] * w).to(torch.int64), 0, w - 1)
        iy = torch.clamp((uv[:, 1] * h).to(torch.int64), 0, h - 1)
        if self.marg_int <= 0:
            return torch.zeros_like(uv[:, 0])
        return self.cond_func[iy, ix] / self.marg_int_t
