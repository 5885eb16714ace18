"""BVH traversal: kernel tables, the plain PyTorch walk, and the wrapper of
the CUDA kernel (port of pbrt_tpu/accel/pallas_traverse.py).

Contract (the TPU kernel `_kernel_block_queue`'s, without its layout):
  inputs  rays o [N,3], d [N,3], t_max [N] f32 and a per-ray any-hit flag
          anyhit [N] u8, plus the packed tables of `pack_kernel_bvh`;
  outputs t [N] f32 and slot [N] i32 (leaf slot block*8+j, -1 on a miss),
          iters [ceil(N/1024)] i32: per 1024-ray group the largest per-ray
          node-pop count, with bit 24 set if any ray's stack overflowed.
For any-hit rays only `slot >= 0` is part of the contract; both versions
stop such a ray at its first hit and report t = 0 for it.

`traverse` takes the plain version for CPU tensors only. For CUDA tensors
it launches csrc/bvh_traverse.cu or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch.accel import native

LEAF_TRIS = 8        # triangles per leaf block: 8 x 16 floats = 512 bytes
STACK = 64           # per-ray stack entries, in the kernel and the plain walk
GROUP = 1024         # rays per `iters` entry
TINY = 1e-20
FAR_SCALE = 1.00000024   # conservative slab far factor
OVF_BIT = 1 << 24


@dataclasses.dataclass
class KernelBVH:
    """Kernel-layout BVH tables on one device.

    metas [M] i32     ax | cnt<<2 | payload<<6, payload = right child of an
                      interior node or leaf block of a leaf
    nodes [M,16] f32  both children's boxes (left lo,hi, right lo,hi); 12 used
    tris  [L*8,16] f32 leaf blocks of 8 triangles (p0,p1,p2 in lanes 0:9)
    order [L*8] i32   leaf slot -> original triangle id, -1 on padding
    seed  [8,16] f32  occluder seed: the 8 largest triangles
    seed_slots [16] i32  their slots; [8] holds the seed count
    """
    metas: torch.Tensor
    nodes: torch.Tensor
    tris: torch.Tensor
    order: torch.Tensor
    seed: torch.Tensor
    seed_slots: torch.Tensor
    wlo: np.ndarray
    whi: np.ndarray
    max_depth: int

    def to(self, device) -> "KernelBVH":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def tree_depth(right: np.ndarray, cnts: np.ndarray) -> int:
    """Deepest node's depth (root = 0) of a depth-first flattened tree."""
    M = cnts.shape[0]
    depth = np.zeros(M, np.int64)
    for i in range(M):
        if cnts[i] == 0:
            depth[i + 1] = depth[i] + 1
            depth[right[i]] = depth[i] + 1
    return int(depth.max())


def pack_kernel_bvh(bvh, tri_p0, tri_p1, tri_p2, device="cpu") -> KernelBVH:
    """Host re-pack of a built BVH and its original-order triangles into the
    kernel tables (the reference's `pack_pallas_bvh`, same words and slots).
    Raises if a leaf holds more than 8 triangles or the tree is deeper than
    the kernel's stack."""
    cnts = np.asarray(bvh.prim_count)
    offs = np.asarray(bvh.prim_offset)
    right = np.asarray(bvh.right_child)
    axis = np.asarray(bvh.axis)
    order = np.asarray(bvh.prim_order)
    p0 = np.asarray(tri_p0, np.float32)[order]
    p1 = np.asarray(tri_p1, np.float32)[order]
    p2 = np.asarray(tri_p2, np.float32)[order]
    M = cnts.shape[0]
    if int(cnts.max()) > LEAF_TRIS:
        raise ValueError(f"leaf with {int(cnts.max())} > {LEAF_TRIS} triangles")
    depth = tree_depth(right, cnts)
    if depth + 1 > STACK:
        raise ValueError(f"BVH depth {depth} needs {depth + 1} stack entries "
                         f"> the kernel's {STACK}")

    nodes = np.zeros((M, 16), np.float32)
    nodes[:, :12] = np.asarray(bvh.packed)[:, :12]

    leaf_ids = np.nonzero(cnts > 0)[0]
    L = max(len(leaf_ids), 1)
    blocks = np.zeros((L, LEAF_TRIS, 16), np.float32)
    slot_order = np.full(L * LEAF_TRIS, -1, np.int32)
    for b, (s, c) in enumerate(zip(offs[leaf_ids], cnts[leaf_ids])):
        blocks[b, :c, 0:3] = p0[s:s + c]
        blocks[b, :c, 3:6] = p1[s:s + c]
        blocks[b, :c, 6:9] = p2[s:s + c]
        slot_order[b * LEAF_TRIS:b * LEAF_TRIS + c] = order[s:s + c]
    if M >= (1 << 26) or L >= (1 << 26):
        raise ValueError("node or leaf index exceeds the 26-bit payload")
    block_of = np.zeros(M, np.int64)
    block_of[leaf_ids] = np.arange(len(leaf_ids))
    payload = np.where(cnts > 0, block_of, right)
    metas = (axis | (cnts << 2) | (payload << 6)).astype(np.int32)
    packed = np.asarray(bvh.packed)
    wlo = np.minimum(packed[0, 0:3], packed[0, 6:9])
    whi = np.maximum(packed[0, 3:6], packed[0, 9:12])

    # occluder seed: the 8 largest-area triangles and their leaf slots
    area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
    k = min(LEAF_TRIS, p0.shape[0])
    top = np.argsort(-area, kind="stable")[:k]
    valid = slot_order >= 0
    slot_of_orig = np.full(int(order.max()) + 1, -1, np.int32)
    slot_of_orig[slot_order[valid]] = np.nonzero(valid)[0]
    seed = np.zeros((LEAF_TRIS, 16), np.float32)
    seed_slots = np.full(16, -1, np.int32)
    for j, li in enumerate(top):
        seed[j, 0:3], seed[j, 3:6], seed[j, 6:9] = p0[li], p1[li], p2[li]
        seed_slots[j] = slot_of_orig[order[li]]
    seed_slots[8] = k

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return KernelBVH(t(metas), t(nodes), t(blocks.reshape(L * LEAF_TRIS, 16)),
                     t(slot_order), t(seed), t(seed_slots),
                     wlo.astype(np.float32), whi.astype(np.float32), depth)


def far_miss_rays(kb: KernelBVH, n: int, device):
    """(o, d) for rays that miss the root box: they retire dead lanes."""
    far = kb.whi + (kb.whi - kb.wlo) + 1.0
    o = torch.as_tensor(far.astype(np.float32), device=device).expand(n, 3)
    d = torch.tensor([0.0, 0.0, 1.0], device=device).expand(n, 3)
    return o, d


# ---------------------------------------------------------------------------
# plain PyTorch version: a lockstep wavefront walk with the kernel's
# arithmetic and order, so both agree bit for bit
# ---------------------------------------------------------------------------

def _pick(x, y, z, k):
    return torch.where(k == 0, x, torch.where(k == 1, y, z))


class _Rays:
    """Per-ray slab and shear precomputes (the kernel's ray setup)."""

    def __init__(self, o, d):
        self.ox, self.oy, self.oz = o[:, 0], o[:, 1], o[:, 2]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]

        def inv(v):
            return 1.0 / torch.where(torch.abs(v) < TINY,
                                     torch.where(v < 0, -TINY, TINY), v)
        self.ix, self.iy, self.iz = inv(dx), inv(dy), inv(dz)
        self.oxi, self.oyi, self.ozi = (self.ox * self.ix, self.oy * self.iy,
                                        self.oz * self.iz)
        adx, ady, adz = torch.abs(dx), torch.abs(dy), torch.abs(dz)
        zero = torch.zeros_like(dx, dtype=torch.int64)
        self.kz = torch.where((adx >= ady) & (adx >= adz), zero,
                              torch.where(ady >= adz, zero + 1, zero + 2))
        self.kx = (self.kz + 1) % 3
        self.ky = (self.kx + 1) % 3
        dpz = _pick(dx, dy, dz, self.kz)
        self.sz = 1.0 / torch.where(dpz == 0.0, TINY, dpz)
        self.sx = -_pick(dx, dy, dz, self.kx) * self.sz
        self.sy = -_pick(dx, dy, dz, self.ky) * self.sz
        self.neg = torch.stack([dx < 0.0, dy < 0.0, dz < 0.0], -1)

    def take(self, i):
        r = object.__new__(_Rays)
        r.__dict__ = {k: v[i] for k, v in self.__dict__.items()}
        return r

    def slab(self, b, t_best):
        """b: [n,6] box (lo xyz, hi xyz) -> hit mask."""
        t0x = b[:, 0] * self.ix - self.oxi
        t1x = b[:, 3] * self.ix - self.oxi
        t0y = b[:, 1] * self.iy - self.oyi
        t1y = b[:, 4] * self.iy - self.oyi
        t0z = b[:, 2] * self.iz - self.ozi
        t1z = b[:, 5] * self.iz - self.ozi
        tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                         torch.minimum(t0y, t1y)),
                           torch.minimum(t0z, t1z))
        tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                         torch.maximum(t0y, t1y)),
                           torch.maximum(t0z, t1z)) * FAR_SCALE
        return (tn <= tf) & (tf > 0.0) & (tn < t_best)

    def tri(self, v, t_best):
        """v: [n,16] triangle rows -> (hit, t): naive-shear watertight test."""
        def shear(px, py, pz):
            tx, ty, tz = px - self.ox, py - self.oy, pz - self.oz
            vz = _pick(tx, ty, tz, self.kz)
            return (_pick(tx, ty, tz, self.kx) + self.sx * vz,
                    _pick(tx, ty, tz, self.ky) + self.sy * vz, vz * self.sz)
        x0, y0, z0 = shear(v[:, 0], v[:, 1], v[:, 2])
        x1, y1, z1 = shear(v[:, 3], v[:, 4], v[:, 5])
        x2, y2, z2 = shear(v[:, 6], v[:, 7], v[:, 8])
        e0 = x1 * y2 - y1 * x2
        e1 = x2 * y0 - y2 * x0
        e2 = x0 * y1 - y0 * x1
        same = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
        det = e0 + e1 + e2
        t_sc = e0 * z0 + e1 * z1 + e2 * z2
        pos = det > 0
        t_ok = (pos & (t_sc > 1e-4 * det) & (t_sc < t_best * det)) | \
            (~pos & (t_sc < 1e-4 * det) & (t_sc > t_best * det))
        hit = same & (det != 0.0) & t_ok
        return hit, t_sc * (1.0 / torch.where(det == 0.0, TINY, det))


def _test_tris(r, rows, slots, active, anyhit, t_best, slot):
    """Test one triangle per lane and keep the closer hit (any-hit lanes
    record their first hit with t = 0, which no later test can beat)."""
    hit, t = r.tri(rows, t_best)
    ok = hit & active
    t_best = torch.where(ok, torch.where(anyhit, 0.0, t), t_best)
    slot = torch.where(ok, slots, slot)
    return t_best, slot


def traverse_plain(kb: KernelBVH, o, d, t_max, anyhit):
    """The kernel's walk as tensor ops: every ray pops one node per step."""
    n = o.shape[0]
    dev = o.device
    r = _Rays(o, d)
    ah = anyhit.to(torch.bool)
    t_best = t_max.clone()
    slot = torch.full((n,), -1, dtype=torch.int32, device=dev)

    scnt = int(kb.seed_slots[8])
    for j in range(scnt):
        t_best, slot = _test_tris(r, kb.seed[j].expand(n, 16),
                                  kb.seed_slots[j].expand(n),
                                  torch.ones_like(ah), ah, t_best, slot)

    stack = torch.zeros((n, STACK), dtype=torch.int64, device=dev)
    sp = torch.where(ah & (slot >= 0), 0, 1).to(torch.int64)
    pops = torch.zeros(n, dtype=torch.int32, device=dev)
    ovf = torch.zeros(n, dtype=torch.bool, device=dev)
    while True:
        lane = torch.nonzero(sp > 0).squeeze(1)
        if lane.numel() == 0:
            break
        spl = sp[lane] - 1
        idx = stack[lane, spl]
        pops[lane] += 1
        w = kb.metas[idx].to(torch.int64)
        ax, cnt, payload = w & 3, (w >> 2) & 15, (w >> 6) & 0x3FFFFFF
        rl = r.take(lane)
        tb, sl = t_best[lane], slot[lane]
        ahl = ah[lane]

        leaf = cnt > 0
        li = torch.nonzero(leaf).squeeze(1)
        if li.numel():
            rli = rl.take(li)
            blk, c = payload[li], cnt[li]
            tbi, sli, ahi = tb[li], sl[li], ahl[li]
            for j in range(LEAF_TRIS):
                s = blk * LEAF_TRIS + j
                tbi, sli = _test_tris(rli, kb.tris[s], s.to(torch.int32),
                                      c > j, ahi, tbi, sli)
            tb[li], sl[li] = tbi, sli

        ii = torch.nonzero(~leaf).squeeze(1)
        if ii.numel():
            rii = rl.take(ii)
            node = idx[ii]
            rec = kb.nodes[node]
            hl = rii.slab(rec[:, 0:6], tb[ii])
            hr = rii.slab(rec[:, 6:12], tb[ii])
            swap = torch.gather(rii.neg, 1, ax[ii, None]).squeeze(1)
            left, right = node + 1, payload[ii]
            near = torch.where(swap, right, left)
            far = torch.where(swap, left, right)
            h_near = torch.where(swap, hr, hl)
            h_far = torch.where(swap, hl, hr)
            spi = spl[ii]
            ovf_i = torch.zeros_like(h_far)
            for child, h in ((far, h_far), (near, h_near)):
                fits = spi < STACK
                put = h & fits
                ovf_i |= h & ~fits
                lanes_i = lane[ii]
                stack[lanes_i[put], spi[put]] = child[put]
                spi = spi + put.to(torch.int64)
            spl[ii] = spi
            ovf[lane[ii]] |= ovf_i
        # any-hit lanes retire at their first hit
        spl = torch.where(ahl & (sl >= 0), 0, spl)
        t_best[lane], slot[lane], sp[lane] = tb, sl, spl

    g = -(-n // GROUP)
    pad = g * GROUP - n
    pmax = torch.nn.functional.pad(pops, (0, pad)).view(g, GROUP).amax(1)
    oany = torch.nn.functional.pad(ovf, (0, pad)).view(g, GROUP).any(1)
    iters = pmax | torch.where(oany, OVF_BIT, 0).to(torch.int32)
    return t_best, slot, iters


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------

def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _launch(kb: KernelBVH, o, d, t_max, anyhit):
    n = o.shape[0]
    dev = o.device
    M = kb.metas.shape[0]
    for name, x, dt, shp in (
            ("o", o, torch.float32, (n, 3)), ("d", d, torch.float32, (n, 3)),
            ("t_max", t_max, torch.float32, (n,)),
            ("anyhit", anyhit, torch.uint8, (n,)),
            ("metas", kb.metas, torch.int32, (M,)),
            ("nodes", kb.nodes, torch.float32, (M, 16)),
            ("tris", kb.tris, torch.float32, (kb.tris.shape[0], 16)),
            ("seed", kb.seed, torch.float32, (LEAF_TRIS, 16)),
            ("seed_slots", kb.seed_slots, torch.int32, (16,))):
        _check(name, x, dt, shp, dev)
    if kb.tris.shape[0] % LEAF_TRIS:
        raise ValueError("tris rows are not whole 8-triangle blocks")
    if kb.max_depth + 1 > STACK:
        raise ValueError(f"BVH depth {kb.max_depth} exceeds the kernel stack")
    if n >= (1 << 31) - GROUP:
        raise ValueError(f"{n} rays exceed the kernel's 32-bit ray index")
    g = -(-n // GROUP)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.zeros(2 * g, dtype=torch.int32, device=dev)
    if n == 0:
        return t, slot, scratch[:0]
    fn = native.load("bvh_traverse").pbrt_bvh_traverse
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(kb.metas.data_ptr(), kb.nodes.data_ptr(), kb.tris.data_ptr(),
                 kb.seed.data_ptr(), kb.seed_slots.data_ptr(), o.data_ptr(),
                 d.data_ptr(), t_max.data_ptr(), anyhit.data_ptr(), n,
                 t.data_ptr(), slot.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bvh_traverse launch failed: cudaError {err}")
    traverse.launches += 1
    return t, slot, scratch[:g] | (scratch[g:] << 24)


def traverse(kb: KernelBVH, o, d, t_max, anyhit):
    """Closest-hit / any-hit walk -> (t [N], slot [N], iters [ceil(N/1024)]).

    CPU tensors take `traverse_plain`; CUDA tensors launch the kernel or
    raise. `traverse.launches` counts kernel launches."""
    if o.device.type == "cpu":
        return traverse_plain(kb, o, d, t_max, anyhit)
    if o.device.type == "cuda":
        return _launch(kb, o, d, t_max, anyhit)
    raise NotImplementedError(f"no traversal for device {o.device}")


traverse.launches = 0
