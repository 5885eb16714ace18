"""The yardstick's roofline arithmetic: the least time a frame's walks need.

The bound counts only the bytes that the inputs need, whatever walks them,
so a change to the tree or the walk cannot move it: each live ray reads its
origin and direction (24 B), t_max (4 B) and an any-hit flag (1 B) and
writes t and a hit id (8 B); each launch reads each of the scene's
triangles once (nine floats, 36 B). It is bound by bytes; no operation
count is claimed. Peaks: NVIDIA's data sheet for one H100 SXM at 700 W.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
RAY_BYTES = 24 + 4 + 1 + 8
TRI_BYTES = 36


def walk_bytes(live_rays, launches, n_tris):
    return live_rays * RAY_BYTES + launches * n_tris * TRI_BYTES


def walk_bound_ms(live_rays, launches, n_tris):
    return walk_bytes(live_rays, launches, n_tris) / HBM_BYTES_PER_S * 1e3
