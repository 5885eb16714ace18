"""The plain reference renderer that decides `correct`: pixels of a
benchmark scene, from nothing but the scene file, its meshes and the
sampler's definition, in plain PyTorch at a chosen float type.

The scene is read by refscene.py; its parts are found by name, each in a
file of its own (plugins.py): the camera, the sampler, the integrator, the
materials and the lights. The integrator follows the estimator that the
port documents, step for step, so that at the same sample draws it gives
the same pixels up to rounding. The film sums each pixel's box-filtered
samples (radius 0.5, pbrt-v3's default filter: a sample on a pixel's left
or top edge also counts for the pixel before it).

What it builds itself: the camera's frame, the triangles' frames and
shading normals, the lights' power distribution, and its acceleration:
no tree, only a cull of ray chunks against boxes of 64 triangles in Morton
order, then Moller-Trumbore tests of every triangle in the boxes a ray
enters (the few large triangles are tested against every ray). It shares
no code, table or buffer with the program under test.

`dtype` sets the float type of every rendering step; the sample draws
and film positions stay integer-exact float32 arithmetic.
"""
from __future__ import annotations

import math

import numpy as np
import torch

import plugins
import refsampler
from refmath import GAMMA7, coordinate_system, cross, dot, next_float, normalize
from refscene import Scene

LEAF = 64


class Accel:
    """Closest-hit queries over a scene's triangles: ray chunks culled
    against boxes of LEAF triangles, then tested triangle by triangle."""

    def __init__(self, p, dtype, device):
        p = np.asarray(p, np.float32)
        T = p.shape[0]
        lo, hi = p.min(1), p.max(1)
        diag = np.linalg.norm(hi - lo, axis=-1)
        loose = diag > 16.0 * max(float(np.median(diag)), 1e-6)
        mesh = np.nonzero(~loose)[0]
        c = 0.5 * (lo[mesh] + hi[mesh])
        q = ((c - c.min(0)) / np.maximum(c.max(0) - c.min(0), 1e-9) * 1023).astype(np.int64)
        code = np.zeros(len(mesh), np.int64)
        for b in range(10):
            for a in range(3):
                code |= ((q[:, a] >> b) & 1) << (3 * b + a)
        order = mesh[np.argsort(code, kind="stable")]
        n_cl = -(-len(order) // LEAF)
        pad = np.full(n_cl * LEAF - len(order), T)        # T: a degenerate triangle
        idx = np.concatenate([order, pad]).reshape(n_cl, LEAF)
        self.clusters = torch.as_tensor(idx, device=device)
        pp = np.concatenate([p, np.zeros((1, 3, 3), np.float32)])
        real = (idx < T)[:, :, None, None]
        clo = np.where(real, pp[idx], np.inf).min((1, 2))     # boxes of the real triangles
        chi = np.where(real, pp[idx], -np.inf).max((1, 2))
        self.lo = torch.as_tensor(clo, dtype=dtype, device=device)
        self.hi = torch.as_tensor(chi, dtype=dtype, device=device)
        self.loose = torch.as_tensor(np.nonzero(loose)[0], device=device)
        t = torch.as_tensor(pp, dtype=dtype, device=device)
        self.p0, self.e1, self.e2 = t[:, 0], t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]
        self.dtype, self.device, self.T = dtype, device, T

    def _test(self, o, d, tmax, tri):
        """Moller-Trumbore of rays o, d [R,3] against triangles tri [R,K]
        -> (t [R,K], inf where missed, b1, b2)."""
        p0, e1, e2 = self.p0[tri], self.e1[tri], self.e2[tri]
        dd = d[:, None, :].expand_as(e2)
        pv = cross(dd, e2)
        det = dot(e1, pv)
        inv = 1.0 / torch.where(det == 0, 1.0, det)
        tv = o[:, None, :] - p0
        u = dot(tv, pv) * inv
        qv = cross(tv, e1)
        v = dot(dd, qv) * inv
        t = dot(e2, qv) * inv
        ok = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) & (t < tmax[:, None])
        return torch.where(ok, t, math.inf), u, v

    def closest(self, o, d, tmax):
        """-> (t [N], inf on a miss; triangle [N], -1 on a miss)."""
        N = o.shape[0]
        best_t = torch.full((N,), math.inf, dtype=self.dtype, device=self.device)
        best_i = torch.full((N,), -1, dtype=torch.int64, device=self.device)
        C = self.lo.shape[0]
        R = max(256, (1 << 23) // max(C, 1))
        for r0 in range(0, N, R):
            oo, dd, tm = o[r0:r0 + R], d[r0:r0 + R], tmax[r0:r0 + R]
            t, i = self._chunk(oo, dd, tm)
            best_t[r0:r0 + R], best_i[r0:r0 + R] = t, i
        return best_t, best_i

    def _chunk(self, o, d, tmax):
        R = o.shape[0]
        inv = 1.0 / torch.where(d == 0, 1e-30, d)
        t0 = (self.lo[None] - o[:, None]) * inv[:, None]
        t1 = (self.hi[None] - o[:, None]) * inv[:, None]
        tn = torch.minimum(t0, t1).amax(-1)
        tf = torch.maximum(t0, t1).amin(-1) * (1 + 3 * 2.0 ** -23)
        ray, cl = torch.nonzero((tn <= tf) & (tf >= 0) & (tn < tmax[:, None]), as_tuple=True)
        bt = torch.full((R,), math.inf, dtype=self.dtype, device=self.device)
        bi = torch.full((R,), self.T + 1, dtype=torch.int64, device=self.device)
        B = 1 << 14
        cand = [(ray[k:k + B], self.clusters[cl[k:k + B]]) for k in range(0, ray.shape[0], B)]
        if self.loose.numel():
            allr = torch.arange(R, device=self.device)
            cand.append((allr, self.loose[None].expand(R, -1)))
        found = []
        for rr, tri in cand:
            t, _, _ = self._test(o[rr], d[rr], tmax[rr], tri)
            tmin, k = t.min(1)
            found.append((rr, tmin, tri.gather(1, k[:, None])[:, 0]))
        for rr, tmin, tri in found:
            bt.scatter_reduce_(0, rr, tmin, "amin")
        for rr, tmin, tri in found:
            win = torch.isfinite(tmin) & (tmin == bt[rr])
            bi.scatter_reduce_(0, rr[win], tri[win], "amin")
        return bt, torch.where(torch.isfinite(bt), bi, -1)

    def bary(self, o, d, tri):
        """(b1, b2) of rays o, d [N,3] on their hit triangles tri [N] (>= 0)."""
        big = torch.full((o.shape[0],), math.inf, dtype=self.dtype, device=self.device)
        _, u, v = self._test(o, d, big, tri[:, None])
        return u[:, 0], v[:, 0]


class Reference:
    """A benchmark scene, read and set up for rendering pixels."""

    def __init__(self, scene_path, seed, dtype=torch.float32, device="cuda"):
        sc = Scene(scene_path)
        self.sc, self.dtype, self.device = sc, dtype, device
        dev = device
        self.res = (int(sc.film["xresolution"][1][0]), int(sc.film["yresolution"][1][0]))
        kind, params = sc.sampler
        self.sampler = plugins.load("samplers", kind).make(params, self.res, seed)
        self.spp = self.sampler.spp
        self.accel = Accel(sc.p, dtype, dev)
        T = self.tensor
        self.tp = T(np.concatenate([sc.p, np.zeros((1, 3, 3), np.float32)]))
        self.tn = T(np.concatenate([sc.n, np.zeros((1, 3, 3), np.float32)]))
        self.has_n = torch.as_tensor(np.append(sc.has_n, False), device=dev)
        self.tuv = T(np.concatenate([sc.uv, np.zeros((1, 3, 2), np.float32)]))
        self.tri_mat = torch.as_tensor(np.append(sc.material, 0), device=dev)
        self.tri_light = torch.as_tensor(np.append(sc.light, -1), device=dev)
        # materials, by kind: {kind index: (module, {parameter: [materials, ...] table})}
        names = sorted({kind for kind, _ in sc.materials})
        kind_of = np.array([names.index(kind) for kind, _ in sc.materials])
        self.m_kind = torch.as_tensor(kind_of, device=dev)
        self.material_kinds = {}
        for k, name in enumerate(names):
            mine = [m for kind, m in sc.materials if kind == name]
            tables = {key: T([m[key] if kind == name else mine[0][key]
                              for kind, m in sc.materials]) for key in mine[0]}
            self.material_kinds[k] = (plugins.load("materials", name), tables)
        # lights and their power distribution
        self.world_radius = sc.world_radius
        self.lights = sc.lights
        for light in self.lights:
            light.setup(self)
        f = np.asarray([light.power(sc.world_radius) for light in self.lights], np.float32)
        cdf = np.concatenate([[0.0], np.cumsum(f, dtype=np.float64) / len(f)]).astype(np.float32)
        func_int = np.float32(cdf[-1])
        self.l_cdf = torch.as_tensor(cdf / func_int, device=dev)       # float32: exact picks
        self.l_pmf = T(f / (func_int * np.float32(len(f))))
        ckind, cparams, c2w = sc.camera
        self.camera = plugins.load("cameras", ckind).make(cparams, c2w, self.res, dtype, dev)
        ikind, iparams = sc.integrator
        self.integrator = plugins.load("integrators", ikind).make(iparams, self)

    def tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    # --- sample positions -------------------------------------------------

    def film_samples(self, px, py):
        """Every sample whose box footprint covers a pixel of (px, py) [P]
        -> (pixel row of the target [S], sample pixel x, y, index [S],
        film position [S,2] float32)."""
        P = len(px)
        rows, sx, sy, ss, pf = [], [], [], [], []
        spp = self.spp
        s_all = np.tile(np.arange(spp), P)
        for dx in (0, 1):
            for dy in (0, 1):
                qx, qy = np.asarray(px) + dx, np.asarray(py) + dy
                ok = (qx < self.res[0]) & (qy < self.res[1])
                qxr, qyr = np.repeat(qx, spp), np.repeat(qy, spp)
                st = refsampler.Stream(self.sampler, qxr, qyr, s_all)
                u = st.d2(0)
                fx = qxr.astype(np.float32) + u[:, 0]
                fy = qyr.astype(np.float32) + u[:, 1]
                tx, ty = np.repeat(np.asarray(px), spp), np.repeat(np.asarray(py), spp)
                # the pixels a sample deposits into: ceil(p - 1) .. floor(p)
                x0, x1 = np.ceil(fx - np.float32(1.0)), np.floor(fx)
                y0, y1 = np.ceil(fy - np.float32(1.0)), np.floor(fy)
                keep = (np.repeat(ok, spp) & (x0 <= tx) & (tx <= x1) & (y0 <= ty) & (ty <= y1))
                rows.append(np.repeat(np.arange(P), spp)[keep])
                sx.append(qxr[keep])
                sy.append(qyr[keep])
                ss.append(s_all[keep])
                pf.append(np.stack([fx, fy], -1)[keep])
        cat = np.concatenate
        return cat(rows), cat(sx), cat(sy), cat(ss), cat(pf)

    def render_pixels(self, px, py, block=1 << 17):
        """Pixels (px, py) [P] of the image -> [P,3] float64 numpy."""
        rows, sx, sy, ss, pf = self.film_samples(px, py)
        P = len(px)
        acc = np.zeros((P, 3))
        wsum = np.zeros(P)
        for k in range(0, len(rows), block):
            L = self.integrator.radiance(sx[k:k + block], sy[k:k + block], ss[k:k + block],
                              pf[k:k + block]).double().cpu().numpy()
            fin = np.isfinite(L).all(-1)
            np.add.at(acc, rows[k:k + block][fin], L[fin])
            np.add.at(wsum, rows[k:k + block][fin], 1.0)
        return np.maximum(np.where(wsum[:, None] > 0, acc / np.maximum(wsum, 1e-20)[:, None], 0.0),
                          0.0)

    # --- surfaces -------------------------------------------------------

    def hit(self, o, d, tmax):
        """Closest hits of rays o, d (unit) -> a dict of the surface frame."""
        t, tri = self.accel.closest(o, d, tmax)
        valid = tri >= 0
        ti = torch.where(valid, tri, self.accel.T)
        b1, b2 = self.accel.bary(o, d, ti)
        b0 = 1.0 - b1 - b2
        P = self.tp[ti]
        p = b0[:, None] * P[:, 0] + b1[:, None] * P[:, 1] + b2[:, None] * P[:, 2]
        dp02, dp12 = P[:, 0] - P[:, 2], P[:, 1] - P[:, 2]
        ng = normalize(cross(dp02, dp12))
        N = self.tn[ti]
        ns = b0[:, None] * N[:, 0] + b1[:, None] * N[:, 1] + b2[:, None] * N[:, 2]
        ns_ok = self.has_n[ti] & (dot(ns, ns) >= 1e-12)
        ns = torch.where(ns_ok[:, None], normalize(ns), ng)
        ng = torch.where((dot(ng, ns) < 0)[:, None], -ng, ng)
        uv = self.tuv[ti]
        duv02, duv12 = uv[:, 0] - uv[:, 2], uv[:, 1] - uv[:, 2]
        det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
        degen = torch.abs(det) < 1e-12
        dpdu = (duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12) / torch.where(degen, 1.0, det)[:, None]
        dpdu = torch.where(degen[:, None], coordinate_system(ng), dpdu)
        ss = normalize(dpdu - ns * dot(ns, dpdu)[:, None])
        ss = torch.where((dot(ss, ss) < 1e-12)[:, None], coordinate_system(ns), ss)
        ts = cross(ns, ss)
        err = GAMMA7 * (torch.abs(b0[:, None] * P[:, 0]) + torch.abs(b1[:, None] * P[:, 1])
                        + torch.abs(b2[:, None] * P[:, 2]))
        mat = self.tri_mat[ti]
        return {"valid": valid, "t": t, "p": p, "ng": ng, "ns": ns, "ss": ss, "ts": ts,
                "err": err, "wo": normalize(-d), "mat": mat, "kind": self.m_kind[mat],
                "light": self.tri_light[ti]}

    def spawn(self, h, w):
        """A ray origin off the surface of h, on w's side."""
        n = h["ng"]
        off = dot(torch.abs(n), h["err"] + 1e-5)[:, None] * n
        off = torch.where((dot(w, n) < 0)[:, None], -off, off)
        po = h["p"] + off
        return torch.where(off > 0, next_float(po, True),
                           torch.where(off < 0, next_float(po, False), po))

    @staticmethod
    def local(h, v):
        """World directions v into h's shading frame."""
        return torch.stack([dot(v, h["ss"]), dot(v, h["ts"]), dot(v, h["ns"])], -1)
