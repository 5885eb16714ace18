"""Host BVH build (port of pbrt_tpu/accel/bvh.py).

The tree comes from csrc/bvh_builder.cpp, the port's unchanged copy of the
reference's C++ builder (pbrt_tpu/native/bvh_builder.cpp), built with g++,
so the port walks the same tree and its leaf slots match the reference's.
There is deliberately no numpy fallback: another builder gives another
tree.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np

from pbrt_tpu_torch.accel import native

MAX_LEAF_PRIMS = 8
SPLIT_IDS = {"sah": 0, "hlbvh": 1, "middle": 2, "equal": 3, "equalcounts": 3}


class HostBVH(NamedTuple):
    """Flattened depth-first tree: node i's left child is i+1."""
    bounds_lo: np.ndarray    # [M,3]
    bounds_hi: np.ndarray    # [M,3]
    right_child: np.ndarray  # [M] int32
    prim_offset: np.ndarray  # [M] int32, first prim of a leaf
    prim_count: np.ndarray   # [M] int32, 0 for interior nodes
    axis: np.ndarray         # [M] int32 split axis
    prim_order: np.ndarray   # [T] int32 leaf order -> original prim id
    packed: np.ndarray       # [M,12] f32 child boxes: left lo,hi, right lo,hi


def _child_boxes(b_lo, b_hi, right, cnts):
    """Both children's bounds per node (the reference's packed record)."""
    M = b_lo.shape[0]
    interior = cnts == 0
    l = np.where(interior, np.minimum(np.arange(M) + 1, M - 1), 0)
    r = np.where(interior, np.maximum(right, 0), 0)
    return np.concatenate([b_lo[l], b_hi[l], b_lo[r], b_hi[r]], 1).astype(np.float32)


def build_bvh(prim_lo: np.ndarray, prim_hi: np.ndarray,
              leaf_size: int = MAX_LEAF_PRIMS, split_method: str = "sah") -> HostBVH:
    """Build over per-primitive world bounds [T,3] with the native builder;
    an unknown split method builds with SAH, as in the reference."""
    fn = native.load("bvh_builder").pbrt_bvh_build
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    fn.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   f32p, f32p, i32p, i32p, i32p, i32p, i32p]
    fn.restype = ctypes.c_int
    T = int(prim_lo.shape[0])
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    cap = max(2 * T, 2)
    b_lo = np.empty((cap, 3), np.float32)
    b_hi = np.empty((cap, 3), np.float32)
    right, offs, cnts, ax = (np.empty(cap, np.int32) for _ in range(4))
    order = np.empty(T, np.int32)
    m = fn(lo.ctypes.data_as(f32p), hi.ctypes.data_as(f32p), T, leaf_size,
           SPLIT_IDS.get(split_method, SPLIT_IDS["sah"]), b_lo.ctypes.data_as(f32p),
           b_hi.ctypes.data_as(f32p), right.ctypes.data_as(i32p),
           offs.ctypes.data_as(i32p), cnts.ctypes.data_as(i32p),
           ax.ctypes.data_as(i32p), order.ctypes.data_as(i32p))
    if m <= 0:
        raise RuntimeError(f"native BVH build failed ({m}) on {T} primitives")
    b_lo, b_hi = b_lo[:m].copy(), b_hi[:m].copy()
    right, offs, cnts, ax = (a[:m].copy() for a in (right, offs, cnts, ax))
    return HostBVH(b_lo, b_hi, right, offs, cnts, ax, order,
                   _child_boxes(b_lo, b_hi, right, cnts))
