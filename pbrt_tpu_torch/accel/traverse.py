"""BVH traversal: kernel tables, the plain PyTorch walks, and the wrappers of
the CUDA kernels (port of pbrt_tpu/accel/pallas_traverse.py).

Contract (the TPU kernels', without their layout):
  inputs  rays o [N,3], d [N,3], t_max [N] f32 and a per-ray any-hit flag
          anyhit [N] u8, plus the packed tables of `pack_kernel_bvh`
          (or of `pack_kernel_bvh4` for the 4-wide walk);
  outputs t [N] f32 and slot [N] i32 (leaf slot block*8+j, -1 on a miss),
          the variants with barycentrics also b1, b2 [N] f32 of the hit,
          and iters [ceil(N/1024)] i32: per 1024-ray group the largest
          per-ray pop count, with bit 24 set if any ray's stack overflowed.
For any-hit rays only `slot >= 0` is part of the contract; every version
stops such a ray at its first hit and reports t = 0 for it.

The TPU kernels are schedules of one walk that differ in three ways, so
the port has one walk with three switches (VARIANTS):
  "queue"   _kernel_block_queue (B1): slab lo*inv - o*inv, the occluder
            seed first, (t, slot) out; b1/b2 come later from kernel_bary;
  "all"     _kernel_block_all (B2): the same walk with b1/b2 out;
  "block"   _kernel_block (B4) and
  "packet"  _kernel (B5): slab (lo - o)*inv, no seed, b1/b2 out. B4 and B5
            compute the same function; one walk and one kernel serve both.
`traverse4` is _kernel_block4_all (B3): B2's contract over the 4-wide
collapse of the same tree.

`traverse` and `traverse4` take the plain versions for CPU tensors only.
For CUDA tensors they launch csrc/bvh_traverse.cu (every 2-wide variant
walks the records of `walk_records` from `KernelBVH.root_word`) or
csrc/bvh4_traverse.cu (over the records of `bvh4_records`), or raise;
nothing falls back.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import time

import numpy as np
import torch

from pbrt_tpu_torch.accel import native

LEAF_TRIS = 8        # triangles per leaf block: 8 x 16 floats = 512 bytes
STACK = 64           # per-ray stack entries of the 2-wide walks
STACK4 = 96          # per-ray stack entries of the 4-wide walk
GROUP = 1024         # rays per `iters` entry
TINY = 1e-20
FAR_SCALE = 1.00000024   # conservative slab far factor
OVF_BIT = 1 << 24
LEAF_TAG = 1 << 30   # 4-wide stack word: leaf block, cnt in bits 26-29
PAYLOAD = 0x3FFFFFF
REC_FLOATS = 16      # a walk record: 12 box floats, 2 child words, 2 spare
REC4_FLOATS = 32     # a BVH4 record: 24 box floats, 4 slot words, the axis word, 3 spare

# variant -> (slab lo*inv - o*inv (else (lo - o)*inv), occluder seed, b1/b2 out)
VARIANTS = {"queue": (True, True, False), "all": (True, True, True),
            "block": (False, False, True), "packet": (False, False, True)}
_BARY_IDS = {"all": 0, "block": 1, "packet": 1}   # the bary entry point's variant


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
    recs [R,16] f32   the 2-wide kernels' walk records, derived from metas
                      and nodes at construction (`walk_records`),
    root_word         the word their walk starts from, and
    recs_ms           the derivation's time in ms (set-up)
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
    recs: torch.Tensor = None
    root_word: int = 0
    recs_ms: float = 0.0

    def __post_init__(self):
        if self.recs is None:
            t0 = time.perf_counter()
            self.recs, words = walk_records(self.metas, self.nodes)
            self.root_word = int(words[0])   # waits for the device
            self.recs_ms = 1e3 * (time.perf_counter() - t0)

    def to(self, device) -> "KernelBVH":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


@dataclasses.dataclass
class KernelBVH4:
    """The 4-wide collapse of a KernelBVH's tree (`_pack_bvh4`'s tables).

    nodes4 [M4,24] f32  4 slot boxes (lo xyz, hi xyz), NaN for an empty slot
    meta4 [4*M4] i32    per slot the word its push puts on the stack: an
                        interior BVH4 node id, or LEAF_TAG | cnt<<26 | block
                        for a leaf; 0 for an empty slot (node 0 is the root)
    axs4 [M4] i32       a0 | a1<<2 | a2<<4: the split axes of the grouping
                        node and of its left and right children
    kb                  the 2-wide tables it was made from: leaf blocks, order
                        and seed
    stack_need          the most stack entries the walk can hold
    recs4 [M4,32] f32   the kernel's records, one 128-byte line a node, made
                        from the three tables above (`bvh4_records`)
    """
    nodes4: torch.Tensor
    meta4: torch.Tensor
    axs4: torch.Tensor
    kb: KernelBVH
    stack_need: int
    recs4: torch.Tensor

    def to(self, device) -> "KernelBVH4":
        return dataclasses.replace(self, kb=self.kb.to(device), **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def walk_records(metas, nodes):
    """The walk records of the redesigned kernels, derived from the meta
    words and node boxes -> (recs [R,16] f32, each node's walk word [M]
    i64; words[0] is the root's).

    A node's walk word is its meta word (ax | cnt<<2 | payload<<6) with an
    interior node's payload replaced by its record: the node's rank among
    the interior nodes. Record r belongs to the r-th interior node i: its
    children's boxes nodes[i, :12] in floats 0:12 and the walk words of its
    children i + 1 and right[i] as int32 bits in floats 12 and 13. A popped
    word then names the one load its visit needs: a leaf's block, or an
    interior node's record with the words of both its children."""
    m = metas.to(torch.int64)
    interior = ((m >> 2) & 15) == 0
    rec = torch.cumsum(interior.to(torch.int64), 0) - 1
    words = torch.where(interior, (m & 3) | (rec << 6), m)
    ids = torch.nonzero(interior).squeeze(1)
    recs = torch.zeros((ids.numel(), REC_FLOATS), dtype=torch.int32, device=metas.device)
    recs[:, :12] = nodes[ids, :12].contiguous().view(torch.int32)
    recs[:, 12] = words[ids + 1].to(torch.int32)
    recs[:, 13] = words[(m[ids] >> 6) & PAYLOAD].to(torch.int32)
    return recs.view(torch.float32), words


def bvh4_records(nodes4, meta4, axs4):
    """The 4-wide kernel's records -> recs4 [M4,32] f32: record r belongs to
    BVH4 node r (so a slot word names its record) and holds its four slot
    boxes nodes4[r] in floats 0:24, its slot words meta4[4r:4r+4] as int32
    bits in 24:28, its axis word axs4[r] in 28, and zeros in 29:32. A
    popped word then names the one aligned 128-byte line its visit needs."""
    M4 = axs4.shape[0]
    recs = torch.zeros((M4, REC4_FLOATS), dtype=torch.int32, device=axs4.device)
    recs[:, :24] = nodes4.contiguous().view(torch.int32)
    recs[:, 24:28] = meta4.view(M4, 4)
    recs[:, 28] = axs4
    return recs.view(torch.float32)


def node_depths(right: np.ndarray, cnts: np.ndarray) -> np.ndarray:
    """Each node's depth below its root in depth-first flattened trees
    (node i's children are i+1 and right[i]; a node no parent names is a
    root, at depth 0)."""
    M = cnts.shape[0]
    depth = np.zeros(M, np.int64)
    for i in range(M):
        if cnts[i] == 0:
            depth[i + 1] = depth[i] + 1
            depth[right[i]] = depth[i] + 1
    return depth


def tree_depth(right: np.ndarray, cnts: np.ndarray) -> int:
    """Deepest node's depth (root = 0) of a depth-first flattened tree."""
    return int(node_depths(right, cnts).max())


def leaf_blocks(offs, cnts, prims, tri_p0, tri_p1, tri_p2):
    """Leaf blocks of the leaves (offs[k], cnts[k]), in that order ->
    (blocks [max(L,1),8,16] f32 with p0,p1,p2 in lanes 0:9, slot_prim
    [max(L,1)*8] i32: the triangle of each slot, -1 on padding). A leaf's
    j-th triangle is prims[offs[k] + j], an index into tri_p0/1/2."""
    offs = np.asarray(offs, np.int64)
    cnts = np.asarray(cnts, np.int64)
    L = max(len(offs), 1)
    leaf = np.repeat(np.arange(len(offs)), cnts)
    j = np.arange(int(cnts.sum())) - np.repeat(np.cumsum(cnts) - cnts, cnts)
    src = np.asarray(prims)[np.repeat(offs, cnts) + j]
    blocks = np.zeros((L, LEAF_TRIS, 16), np.float32)
    for k, p in enumerate((tri_p0, tri_p1, tri_p2)):
        blocks[leaf, j, 3 * k:3 * k + 3] = np.asarray(p, np.float32)[src]
    slot_prim = np.full(L * LEAF_TRIS, -1, np.int32)
    slot_prim[leaf * LEAF_TRIS + j] = src
    return blocks, slot_prim


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
    blocks, slot_order = leaf_blocks(offs[leaf_ids], cnts[leaf_ids], order,
                                     tri_p0, tri_p1, tri_p2)
    L = blocks.shape[0]
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


def pack_kernel_bvh4(kb: KernelBVH) -> KernelBVH4:
    """Collapse the 2-wide tree of kb into 4-wide nodes: the reference's
    `_pack_bvh4`, same boxes, words and axes, without its TPU SMEM cap.
    Each BVH4 node is a BVH2 interior node: a leaf child is one slot (its
    box), an interior child gives its two children as slots and its own box
    is never tested. Nodes are numbered breadth first from the root. Raises
    if the root is a leaf or the walk could need more than the kernel's
    STACK4 entries."""
    metas = kb.metas.cpu().numpy().astype(np.int64)
    packed = kb.nodes.cpu().numpy()[:, :12]
    axis, cnts, payload = metas & 3, (metas >> 2) & 15, (metas >> 6) & PAYLOAD
    right = blockid = payload     # right child of an interior node, block of a leaf
    if cnts[0] > 0:
        raise ValueError("a BVH4 needs an interior root")
    ids = {0: 0}
    queue = collections.deque([0])
    boxes, words, axws = [], [], []
    pending = [0]         # stack entries below each node when it is popped
    need = 1
    empty = np.full(6, np.nan, np.float32)

    def slot_of(g):
        if cnts[g] > 0:
            return LEAF_TAG | (int(min(cnts[g], LEAF_TRIS)) << 26) | int(blockid[g])
        ids[g] = len(ids)
        queue.append(g)
        return ids[g]

    while queue:
        i = queue.popleft()
        nid = ids[i]
        sw, sb = [0, 0, 0, 0], [empty] * 4
        a = [int(axis[i]), 0, 0]
        for side, c in ((0, i + 1), (1, int(right[i]))):
            if cnts[c] > 0:
                sw[2 * side], sb[2 * side] = slot_of(c), packed[i, 6 * side:6 * side + 6]
            else:
                a[1 + side] = int(axis[c])
                for s2, g in ((0, c + 1), (1, int(right[c]))):
                    sw[2 * side + s2] = slot_of(g)
                    sb[2 * side + s2] = packed[c, 6 * s2:6 * s2 + 6]
        boxes.append(sb)
        words.append(sw)
        axws.append(a[0] | (a[1] << 2) | (a[2] << 4))
        k = sum(w != 0 for w in sw)
        need = max(need, pending[nid] + k)
        # a child popped while up to k - 1 of its siblings wait below it
        pending += [pending[nid] + k - 1] * sum(0 < w < LEAF_TAG for w in sw)

    M4 = len(boxes)
    if M4 >= (1 << 26):
        raise ValueError("BVH4 node index exceeds the 26-bit payload")
    if need > STACK4:
        raise ValueError(f"the BVH4 walk needs {need} stack entries > the kernel's {STACK4}")
    dev = kb.metas.device
    t = lambda x, dt: torch.as_tensor(np.asarray(x, dt), device=dev)
    nodes4, meta4, axs4 = (t(np.reshape(boxes, (M4, 24)), np.float32),
                           t(np.reshape(words, -1), np.int32), t(axws, np.int32))
    return KernelBVH4(nodes4, meta4, axs4, kb, need, bvh4_records(nodes4, meta4, axs4))


def tpu_table_bytes(kb: KernelBVH) -> int:
    """Bytes of the reference's VMEM kernel tables for this tree (nodes in
    rows of 8, metadata in rows of 32, leaf blocks, each row 128 lanes of
    4 bytes): what its scene build holds to 12 MiB."""
    M, L = kb.metas.shape[0], kb.tris.shape[0] // LEAF_TRIS
    return (-(-M // 8) + -(-M // 32) + L) * 128 * 4


def far_miss_rays(boxes, n: int, device):
    """(o, d) for rays that miss every box of boxes ((lo, hi) [3] pairs,
    the root boxes of the walks): they retire dead lanes."""
    wlo = np.minimum.reduce([lo for lo, _ in boxes])
    whi = np.maximum.reduce([hi for _, hi in boxes])
    far = whi + (whi - wlo) + 1.0
    o = torch.as_tensor(far.astype(np.float32), device=device).expand(n, 3)
    d = torch.tensor([0.0, 0.0, 1.0], device=device).expand(n, 3)
    return o, d


# ---------------------------------------------------------------------------
# plain PyTorch versions: lockstep wavefront walks with the kernels'
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
        r = object.__new__(type(self))
        r.__dict__ = {k: v[i] for k, v in self.__dict__.items()}
        return r

    def slab(self, b, t_best, mul_sub=True):
        """b: [n,6] box (lo xyz, hi xyz) -> hit mask. mul_sub: the slab
        distances as lo*inv - o*inv, else as (lo - o)*inv."""
        if mul_sub:
            t0x = b[:, 0] * self.ix - self.oxi
            t1x = b[:, 3] * self.ix - self.oxi
            t0y = b[:, 1] * self.iy - self.oyi
            t1y = b[:, 4] * self.iy - self.oyi
            t0z = b[:, 2] * self.iz - self.ozi
            t1z = b[:, 5] * self.iz - self.ozi
        else:
            t0x = (b[:, 0] - self.ox) * self.ix
            t1x = (b[:, 3] - self.ox) * self.ix
            t0y = (b[:, 1] - self.oy) * self.iy
            t1y = (b[:, 4] - self.oy) * self.iy
            t0z = (b[:, 2] - self.oz) * self.iz
            t1z = (b[:, 5] - self.oz) * self.iz
        tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                         torch.minimum(t0y, t1y)),
                           torch.minimum(t0z, t1z))
        tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                         torch.maximum(t0y, t1y)),
                           torch.maximum(t0z, t1z)) * FAR_SCALE
        return (tn <= tf) & (tf > 0.0) & (tn < t_best)

    def tri(self, v, t_best, bary=False):
        """v: [n,16] triangle rows -> (hit, t), or (hit, t, b1, b2) with
        bary: the naive-shear watertight test."""
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
        inv_det = 1.0 / torch.where(det == 0.0, TINY, det)
        if bary:
            return hit, t_sc * inv_det, e1 * inv_det, e2 * inv_det
        return hit, t_sc * inv_det


class _Hits:
    """Per-lane walk results: t_best, slot and, if tracked, b1/b2."""

    def __init__(self, t_best, slot, b1=None, b2=None):
        self.t, self.slot, self.b1, self.b2 = t_best, slot, b1, b2

    def take(self, i):
        return _Hits(*(None if v is None else v[i] for v in (self.t, self.slot, self.b1, self.b2)))

    def put(self, i, h):
        for k in ("t", "slot", "b1", "b2"):
            if getattr(self, k) is not None:
                getattr(self, k)[i] = getattr(h, k)

    def test(self, r, rows, slots, active, anyhit):
        """Test one triangle per lane and keep the closer hit (any-hit lanes
        record their first hit with t = 0, which no later test can beat)."""
        if self.b1 is None:
            hit, t = r.tri(rows, self.t)
            ok = hit & active
        else:
            hit, t, u, v = r.tri(rows, self.t, bary=True)
            ok = hit & active
            self.b1 = torch.where(ok, u, self.b1)
            self.b2 = torch.where(ok, v, self.b2)
        self.t = torch.where(ok, torch.where(anyhit, 0.0, t), self.t)
        self.slot = torch.where(ok, slots, self.slot)


class WalkCounts:
    """What a plain walk did, summed over its rays: interior-node pops,
    triangle tests and instance entries (each also pops one RESTORE), and
    which table entries it touched. The least work a kernel launch must do
    on the same rays (its bound) is computed from these. metas holds one
    word per table entry (ax | cnt<<2 | ...); boxes is the number of box
    tests per interior pop and node_bytes the bytes of an interior entry
    beside its word. max_stack is the most entries any ray's stack held."""

    def __init__(self, metas, boxes=2, node_bytes=48):
        self.metas = metas
        self.boxes, self.node_bytes = boxes, node_bytes
        self.seen = torch.zeros(metas.shape[0], dtype=torch.bool, device=metas.device)
        self.interior = self.tri_tests = self.enters = self.max_stack = 0

    @classmethod
    def for_bvh4(cls, kb4: KernelBVH4) -> "WalkCounts":
        """Counts of the 4-wide walk: entries are its M4 nodes (4 boxes of
        24 floats, 4 slot words and an axis word each), then its leaf
        blocks at M4 + block, as `traverse4_plain` steps them."""
        m = kb4.kb.metas
        leaf_words = m[((m >> 2) & 15) > 0]
        inner = torch.zeros(kb4.axs4.shape[0], dtype=m.dtype, device=m.device)
        return cls(torch.cat([inner, leaf_words]), boxes=4, node_bytes=96 + 16)

    def step(self, node, interior, leaf_cnt, enters):
        """One lockstep step: the popped table nodes, which of them are
        interior, the triangle count of each leaf among them, and the
        number of instance entries."""
        self.seen[node] = True
        self.interior += int(interior.sum())
        self.tri_tests += int(leaf_cnt.sum())
        self.enters += int(enters)

    def stack_height(self, sp):
        """Note the stack heights sp [n] of the lanes after a step."""
        if sp.numel():
            self.max_stack = max(self.max_stack, int(sp.max()))

    def touched(self):
        """-> (interior nodes, leaf triangles, instance leaves) touched once
        or more."""
        cnt = (self.metas[self.seen].to(torch.int64) >> 2) & 15
        return (int((cnt == 0).sum()), int(cnt[(cnt > 0) & (cnt < 15)].sum()),
                int((cnt == 15).sum()))


def _start(kb, o, d, t_max, anyhit, counts, seed, bary):
    """Ray setup and the occluder seed -> (rays, any-hit mask, hits)."""
    n = o.shape[0]
    r = _Rays(o, d)
    ah = anyhit.to(torch.bool)
    zeros = (lambda: torch.zeros(n, dtype=torch.float32, device=o.device)) if bary else \
        (lambda: None)
    h = _Hits(t_max.clone(), torch.full((n,), -1, dtype=torch.int32, device=o.device),
              zeros(), zeros())
    scnt = int(kb.seed_slots[8]) if seed else 0
    if counts is not None:
        counts.tri_tests += scnt * n
    for j in range(scnt):
        h.test(r, kb.seed[j].expand(n, 16), kb.seed_slots[j].expand(n), torch.ones_like(ah), ah)
    return r, ah, h


def _leaf(kb, rl, h, li, blk, cnt, ahl):
    """The 8-triangle block test of the lanes li of the popped set."""
    if li.numel():
        hi = h.take(li)
        rli = rl.take(li)
        b, c, a = blk[li], cnt[li], ahl[li]
        for j in range(LEAF_TRIS):
            s = b * LEAF_TRIS + j
            hi.test(rli, kb.tris[s], s.to(torch.int32), c > j, a)
        h.put(li, hi)


def _iters(pops, ovf):
    n = pops.shape[0]
    g = -(-n // GROUP)
    pad = g * GROUP - n
    pmax = torch.nn.functional.pad(pops, (0, pad)).view(g, GROUP).amax(1)
    oany = torch.nn.functional.pad(ovf, (0, pad)).view(g, GROUP).any(1)
    return pmax | torch.where(oany, OVF_BIT, 0).to(torch.int32)


def _walk(kb, o, d, t_max, anyhit, counts, seed, bary, stack_size, expand):
    """The lockstep walk shared by the 2- and 4-wide versions: every live
    ray pops one stack word per step; expand(...) handles the interior
    words and decode(...) splits a word. -> (hits, iters)."""
    n = o.shape[0]
    dev = o.device
    r, ah, h = _start(kb, o, d, t_max, anyhit, counts, seed, bary)
    stack = torch.zeros((n, stack_size), dtype=torch.int64, device=dev)
    sp = torch.where(ah & (h.slot >= 0), 0, 1).to(torch.int64)
    pops = torch.zeros(n, dtype=torch.int32, device=dev)
    ovf = torch.zeros(n, dtype=torch.bool, device=dev)
    if counts is not None:
        counts.stack_height(sp)

    def push(lanes, spl, child, hit):
        """Push child where hit, in order -> (new stack pointers, overflow)."""
        fits = spl < stack_size
        put = hit & fits
        stack[lanes[put], spl[put]] = child[put]
        return spl + put.to(torch.int64), hit & ~fits

    while True:
        lane = torch.nonzero(sp > 0).squeeze(1)
        if lane.numel() == 0:
            break
        spl = sp[lane] - 1
        word = stack[lane, spl]
        pops[lane] += 1
        rl = r.take(lane)
        hl = h.take(lane)
        ahl = ah[lane]
        spl, ov = expand(word, rl, hl, ahl, lane, spl, push)
        ovf[lane] |= ov
        if counts is not None:
            counts.stack_height(spl)
        # any-hit lanes retire at their first hit
        spl = torch.where(ahl & (hl.slot >= 0), 0, spl)
        h.put(lane, hl)
        sp[lane] = spl
    return h, _iters(pops, ovf)


def traverse_plain(kb: KernelBVH, o, d, t_max, anyhit, counts: WalkCounts = None,
                   variant="queue"):
    """The 2-wide kernel's walk as tensor ops -> (t, slot, iters) for
    "queue", (t, slot, b1, b2, iters) for the other VARIANTS. counts, if
    given, adds up what the walk did (WalkCounts)."""
    mul_sub, seed, bary = VARIANTS[variant]

    def expand(word, rl, hl, ahl, lane, spl, push):
        w = kb.metas[word].to(torch.int64)
        ax, cnt, payload = w & 3, (w >> 2) & 15, (w >> 6) & PAYLOAD
        leaf = cnt > 0
        if counts is not None:
            counts.step(word, ~leaf, cnt, 0)
        _leaf(kb, rl, hl, torch.nonzero(leaf).squeeze(1), payload, cnt, ahl)
        ovf = torch.zeros_like(leaf)
        ii = torch.nonzero(~leaf).squeeze(1)
        if ii.numel():
            rii = rl.take(ii)
            node = word[ii]
            rec = kb.nodes[node]
            hit_l = rii.slab(rec[:, 0:6], hl.t[ii], mul_sub)
            hit_r = rii.slab(rec[:, 6:12], hl.t[ii], mul_sub)
            swap = torch.gather(rii.neg, 1, ax[ii, None]).squeeze(1)
            left, right = node + 1, payload[ii]
            spi, ov = spl[ii], torch.zeros_like(hit_l)
            for child, hit in ((torch.where(swap, left, right), torch.where(swap, hit_l, hit_r)),
                               (torch.where(swap, right, left), torch.where(swap, hit_r, hit_l))):
                spi, o1 = push(lane[ii], spi, child, hit)
                ov |= o1
            spl[ii] = spi
            ovf[ii] = ov
        return spl, ovf

    h, iters = _walk(kb, o, d, t_max, anyhit, counts, seed, bary, STACK, expand)
    if not bary:
        return h.t, h.slot, iters
    return h.t, h.slot, h.b1, h.b2, iters


def traverse4_plain(kb4: KernelBVH4, o, d, t_max, anyhit, counts: WalkCounts = None):
    """The 4-wide kernel's walk as tensor ops (B2's slab, seed and
    barycentrics) -> (t, slot, b1, b2, iters). A popped interior word
    slab-tests its 4 slots and pushes the hit ones far to near: the pair
    order by the node's own split axis, the order inside each pair by its
    child's axis, each by the ray's direction sign on that axis. counts, if
    given, comes from WalkCounts.for_bvh4."""
    kb = kb4.kb
    M4 = kb4.axs4.shape[0]
    words4 = kb4.meta4.view(M4, 4).to(torch.int64)

    def expand(word, rl, hl, ahl, lane, spl, push):
        leaf = (word & LEAF_TAG) != 0
        cnt = torch.where(leaf, (word >> 26) & 15, 0)
        blk = word & PAYLOAD
        if counts is not None:
            counts.step(torch.where(leaf, M4 + blk, word), ~leaf, cnt, 0)
        _leaf(kb, rl, hl, torch.nonzero(leaf).squeeze(1), blk, cnt, ahl)
        ovf = torch.zeros_like(leaf)
        ii = torch.nonzero(~leaf).squeeze(1)
        if ii.numel():
            rii = rl.take(ii)
            nid = word[ii]
            rec, ws = kb4.nodes4[nid], words4[nid]
            axw = kb4.axs4[nid].to(torch.int64)
            tb = hl.t[ii]
            h = [rii.slab(rec[:, 6 * j:6 * j + 6], tb) & (ws[:, j] != 0) for j in range(4)]
            s0, s1, s2 = (torch.gather(rii.neg, 1, ((axw >> (2 * k)) & 3)[:, None]).squeeze(1)
                          for k in range(3))
            sel = torch.where
            e_ln, e_lf = sel(s1, ws[:, 1], ws[:, 0]), sel(s1, ws[:, 0], ws[:, 1])
            h_ln, h_lf = sel(s1, h[1], h[0]), sel(s1, h[0], h[1])
            e_rn, e_rf = sel(s2, ws[:, 3], ws[:, 2]), sel(s2, ws[:, 2], ws[:, 3])
            h_rn, h_rf = sel(s2, h[3], h[2]), sel(s2, h[2], h[3])
            spi, ov = spl[ii], torch.zeros_like(h[0])
            for child, hit in ((sel(s0, e_lf, e_rf), sel(s0, h_lf, h_rf)),
                               (sel(s0, e_ln, e_rn), sel(s0, h_ln, h_rn)),
                               (sel(s0, e_rf, e_lf), sel(s0, h_rf, h_lf)),
                               (sel(s0, e_rn, e_ln), sel(s0, h_rn, h_ln))):
                spi, o1 = push(lane[ii], spi, child, hit)
                ov |= o1
            spl[ii] = spi
            ovf[ii] = ov
        return spl, ovf

    h, iters = _walk(kb, o, d, t_max, anyhit, counts, True, True, STACK4, expand)
    return h.t, h.slot, h.b1, h.b2, iters


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
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


def _check_rays(kb: KernelBVH, o, d, t_max, anyhit):
    """The checks every BVH kernel's wrapper makes before it launches: the
    rays, the leaf blocks and the occluder seed."""
    n = o.shape[0]
    dev = o.device
    for name, x, dt, shp in (
            ("o", o, torch.float32, (n, 3)), ("d", d, torch.float32, (n, 3)),
            ("t_max", t_max, torch.float32, (n,)),
            ("anyhit", anyhit, torch.uint8, (n,)),
            ("tris", kb.tris, torch.float32, (kb.tris.shape[0], 16)),
            ("seed", kb.seed, torch.float32, (LEAF_TRIS, 16)),
            ("seed_slots", kb.seed_slots, torch.int32, (16,))):
        _check(name, x, dt, shp, dev)
    if kb.tris.shape[0] % LEAF_TRIS:
        raise ValueError("tris rows are not whole 8-triangle blocks")
    if n >= (1 << 31) - GROUP:
        raise ValueError(f"{n} rays exceed the kernel's 32-bit ray index")


def _call(lib, fn_name, ins, outs, n, ints, dev):
    """Launch the C entry point fn(ins..., n, ints..., outs..., stream) of a
    kernel library on dev's current stream; raise if the launch failed."""
    fn = getattr(native.load(lib), fn_name)
    fn.argtypes = ([ctypes.c_void_p] * len(ins) + [ctypes.c_int] * (1 + len(ints))
                   + [ctypes.c_void_p] * (len(outs) + 1))
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(x.data_ptr() for x in ins), n, *ints, *(x.data_ptr() for x in outs), stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")


def _launch(kb: KernelBVH, o, d, t_max, anyhit, variant="queue"):
    _check_rays(kb, o, d, t_max, anyhit)
    _check("recs", kb.recs, torch.float32, (kb.recs.shape[0], REC_FLOATS), o.device)
    if kb.max_depth + 1 > STACK:
        raise ValueError(f"BVH depth {kb.max_depth} exceeds the kernel stack")
    n = o.shape[0]
    dev = o.device
    g = -(-n // GROUP)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.zeros(2 * g, dtype=torch.int32, device=dev)
    bary = VARIANTS[variant][2]
    out = [t, slot] + ([torch.empty(n, device=dev), torch.empty(n, device=dev)] if bary else [])
    if n > 0:
        ins = [kb.recs, kb.tris, kb.seed, kb.seed_slots, o, d, t_max, anyhit]
        if bary:
            _call("bvh_traverse", "pbrt_bvh_traverse_bary", ins, out + [scratch], n,
                  [_BARY_IDS[variant], kb.root_word], dev)
            traverse.bary_launches[variant] += 1
        else:
            _call("bvh_traverse", "pbrt_bvh_traverse", ins, out + [scratch], n,
                  [kb.root_word], dev)
            traverse.launches += 1
    return (*out, scratch[:g] | (scratch[g:] << 24))


def traverse(kb: KernelBVH, o, d, t_max, anyhit, variant="queue"):
    """Closest-hit / any-hit walk -> (t [N], slot [N], iters [ceil(N/1024)])
    for variant "queue" (B1), (t, slot, b1, b2, iters) for "all", "block"
    and "packet" (B2, B4, B5).

    CPU tensors take `traverse_plain`; CUDA tensors launch the kernel or
    raise. `traverse.launches` counts the B1 kernel's launches,
    `traverse.bary_launches[variant]` those of the other variants."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown traversal variant {variant!r}")
    if o.device.type == "cpu":
        return traverse_plain(kb, o, d, t_max, anyhit, variant=variant)
    if o.device.type == "cuda":
        return _launch(kb, o, d, t_max, anyhit, variant)
    raise NotImplementedError(f"no traversal for device {o.device}")


traverse.launches = 0
traverse.bary_launches = {"all": 0, "block": 0, "packet": 0}


def _launch4(kb4: KernelBVH4, o, d, t_max, anyhit):
    kb = kb4.kb
    _check_rays(kb, o, d, t_max, anyhit)
    M4 = kb4.axs4.shape[0]
    # the kernel reads recs4 alone; the tables it was made from must agree
    for name, x, dt, shp in (("nodes4", kb4.nodes4, torch.float32, (M4, 24)),
                             ("meta4", kb4.meta4, torch.int32, (4 * M4,)),
                             ("axs4", kb4.axs4, torch.int32, (M4,)),
                             ("recs4", kb4.recs4, torch.float32, (M4, REC4_FLOATS))):
        _check(name, x, dt, shp, o.device)
    if kb4.stack_need > STACK4:
        raise ValueError(f"the BVH4 walk needs {kb4.stack_need} > {STACK4} stack entries")
    n = o.shape[0]
    dev = o.device
    g = -(-n // GROUP)
    out = [torch.empty(n, device=dev), torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, device=dev), torch.empty(n, device=dev)]
    scratch = torch.zeros(2 * g, dtype=torch.int32, device=dev)
    if n > 0:
        _call("bvh4_traverse", "pbrt_bvh4_traverse",
              [kb4.recs4, kb.tris, kb.seed, kb.seed_slots, o, d, t_max, anyhit],
              out + [scratch], n, [], dev)
        traverse4.launches += 1
    return (*out, scratch[:g] | (scratch[g:] << 24))


def traverse4(kb4: KernelBVH4, o, d, t_max, anyhit):
    """The 4-wide walk (B3) -> (t, slot, b1, b2, iters). CPU tensors take
    `traverse4_plain`; CUDA tensors launch the kernel or raise.
    `traverse4.launches` counts kernel launches."""
    if o.device.type == "cpu":
        return traverse4_plain(kb4, o, d, t_max, anyhit)
    if o.device.type == "cuda":
        return _launch4(kb4, o, d, t_max, anyhit)
    raise NotImplementedError(f"no traversal for device {o.device}")


traverse4.launches = 0
