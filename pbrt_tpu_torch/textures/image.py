"""Image textures: loading, the mip atlas, bilinear, trilinear and EWA
lookups (port of pbrt_tpu/textures/image.py).

Every image is Lanczos-resampled to a square power of two and packed with
its mip levels into one "mip strip" canvas: level 0 fills x in [0, S);
level l >= 1 sits at x offset Smax, y offset S - (S >> (l - 1)). So any
per-lane (image, level, s, t) is one row gather from the flattened atlas.
The EWA lookup quadratures the filter ellipse on a fixed lattice of
bilinear probes, two mip levels each, as the reference does.

The reference reads PNGs and resamples through PIL. The port has no
imaging library: `load_image` decodes with io/image_io.py::read_png and
converts to 8-bit RGB as PIL's `convert("RGB")` does (16-bit gray clipped
to 255, other 16-bit images by their high byte), and `lanczos_resize` is
PIL's float Lanczos resize: the same weights, computed in double with
libm's sin, summed in the same order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MAX_ANISOTROPY = 8.0


def _to_rgb8(img: np.ndarray) -> np.ndarray:
    """read_png's samples -> [H, W, 3] uint8, as PIL converts to "RGB"."""
    ch = img.shape[-1]
    if img.dtype == np.uint16:
        img = np.minimum(img, 255) if ch == 1 else img >> 8
        img = img.astype(np.uint8)
    return np.repeat(img[..., :1], 3, -1) if ch <= 2 else img[..., :3]


def load_image(path: str, gamma: bool = True) -> np.ndarray:
    """[H, W, 3] float32 linear (sRGB-decoded when gamma)."""
    from pbrt_tpu_torch.io.image_io import read_exr, read_pfm, read_png
    low = path.lower()
    if low.endswith(".exr"):
        return read_exr(path).astype(np.float32)
    if low.endswith(".pfm"):
        return read_pfm(path).astype(np.float32)
    arr = _to_rgb8(read_png(path)).astype(np.float32) / 255.0
    if gamma:
        arr = np.where(arr <= 0.04045, arr / 12.92, ((arr + 0.055) / 1.055) ** 2.4)
    return arr.astype(np.float32)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _lanczos(x: float) -> float:
    def sinc(v):
        if v == 0.0:
            return 1.0
        v *= math.pi
        return math.sin(v) / v
    return sinc(x) * sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _lanczos_coeffs(in_size: int, out_size: int):
    """PIL's precompute_coeffs for the Lanczos filter (support 3) ->
    (first input index [out], weights [out, K] with zeros past each
    window)."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 3.0 * fscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    k = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) / fscale) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        first[xx] = xmin
        k[xx, :xmax] = [v / ww for v in w] if ww != 0.0 else w
    return first, k


def _resample_axis(im: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One separable pass along axis (1: x, 0: y); float64 sums in PIL's
    order, float32 out."""
    first, k = _lanczos_coeffs(im.shape[axis], out_size)
    src = np.moveaxis(im, axis, 0).astype(np.float64)
    acc = np.zeros((out_size,) + src.shape[1:], np.float64)
    for x in range(k.shape[1]):
        idx = np.minimum(first + x, src.shape[0] - 1)
        acc += src[idx] * k[:, x].reshape((-1,) + (1,) * (src.ndim - 1))
    return np.moveaxis(acc.astype(np.float32), 0, axis)


def lanczos_resize(ch: np.ndarray, w: int, h: int) -> np.ndarray:
    """[H0, W0] float32 -> [h, w], as PIL's Image.resize((w, h), LANCZOS)
    of a mode "F" image: the horizontal pass first, each where the size
    changes."""
    if ch.shape[1] != w:
        ch = _resample_axis(ch, w, 1)
    if ch.shape[0] != h:
        ch = _resample_axis(ch, h, 0)
    return ch


def _resample_pow2_square(im: np.ndarray) -> np.ndarray:
    """[H, W, 3] -> [S, S, 3], S the next power of two of max(H, W)."""
    h, w = im.shape[:2]
    s = _next_pow2(max(h, w))
    if h == s and w == s:
        return im.astype(np.float32)
    chans = [lanczos_resize(im[..., c].astype(np.float32), s, s) for c in range(im.shape[2])]
    return np.clip(np.stack(chans, -1), 0.0, None)


def _downsample2(im: np.ndarray) -> np.ndarray:
    """One mip level down: the 2x2 box average."""
    h, w = im.shape[:2]
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    im = im[: h2 * 2, : w2 * 2]
    if h >= 2 and w >= 2:
        return 0.25 * (im[0::2, 0::2] + im[1::2, 0::2] + im[0::2, 1::2] + im[1::2, 1::2])
    if w >= 2:
        return 0.5 * (im[:, 0::2] + im[:, 1::2])
    if h >= 2:
        return 0.5 * (im[0::2] + im[1::2])
    return im


def build_atlas(images):
    """Host: images -> (atlas [n, Smax, Smax + Smax//2, 3] f32, sizes [n, 2]
    int32 (S, S), levels [n] int32)."""
    if not images:
        return (np.zeros((0, 1, 2, 3), np.float32), np.zeros((0, 2), np.int32),
                np.zeros((0,), np.int32))
    sq = [_resample_pow2_square(np.asarray(im, np.float32)) for im in images]
    smax = max(im.shape[0] for im in sq)
    atlas = np.zeros((len(sq), smax, smax + max(smax // 2, 1), 3), np.float32)
    sizes = np.zeros((len(sq), 2), np.int32)
    nlev = np.zeros((len(sq),), np.int32)
    for i, im in enumerate(sq):
        s = im.shape[0]
        sizes[i] = (s, s)
        atlas[i, :s, :s] = im
        lv, level = im, 1
        while lv.shape[0] > 1:
            lv = _downsample2(lv)
            sl = lv.shape[0]
            yoff = s - (s >> (level - 1))
            atlas[i, yoff:yoff + sl, smax:smax + sl] = lv
            level += 1
        nlev[i] = level
    return atlas, sizes, nlev


def _bilinear_at_level(tex, img, st, level):
    """Bilinear sample of images img [N] at per-lane mip levels [N] and
    wrapped (s, t) [N, 2]."""
    S = tex.atlas_size[img, 0]
    smax = tex.atlas.shape[1]
    wl = torch.clamp(S >> level, min=1)
    is0 = level == 0
    xoff = torch.where(is0, 0, smax)
    yoff = torch.where(is0, 0, S - (S >> torch.clamp(level - 1, min=0)))
    wf = wl.to(torch.float32)
    s = st[:, 0] - torch.floor(st[:, 0])
    t = st[:, 1] - torch.floor(st[:, 1])
    x = s * wf - 0.5
    y = (1.0 - t) * wf - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    fx = (x - x0f)[:, None]
    fy = (y - y0f)[:, None]
    K, Ha, Wa = tex.atlas.shape[:3]
    flat = tex.atlas.reshape(K * Ha * Wa, 3)
    img, wl, xoff, yoff = img.to(torch.int64), wl.to(torch.int64), xoff.to(torch.int64), \
        yoff.to(torch.int64)

    def pix(xx, yy):
        return flat[(img * Ha + (yoff + torch.remainder(yy, wl))) * Wa
                    + (xoff + torch.remainder(xx, wl))]

    return (pix(x0, y0) * (1 - fx) * (1 - fy) + pix(x0 + 1, y0) * fx * (1 - fy)
            + pix(x0, y0 + 1) * (1 - fx) * fy + pix(x0 + 1, y0 + 1) * fx * fy)


def _image_of(tex, tid):
    return torch.clamp(tex.image_id[tid], min=0).to(torch.int64)


def sample_atlas(tex, tid, st):
    """Bilinear at level 0 (no differentials)."""
    img = _image_of(tex, tid)
    return _bilinear_at_level(tex, img, st, torch.zeros_like(img))


def _levels(n_levels, width):
    """Fractional mip level of a filter width in uv units -> (floor level,
    the level above, the fraction [N, 1])."""
    lvl_f = torch.clamp(n_levels - 1.0 + torch.log2(torch.clamp(width, min=1e-8)),
                        min=torch.zeros_like(n_levels), max=n_levels - 1.0)
    lvl_f = torch.nan_to_num(lvl_f)   # a NaN width reads level 0, not a bad level
    l0 = torch.floor(lvl_f).to(torch.int64)
    l1 = torch.minimum(l0 + 1, (n_levels - 1.0).to(torch.int64))
    return l0, l1, (lvl_f - l0.to(torch.float32))[:, None]


def sample_atlas_trilinear(tex, tid, st, width):
    """pbrt's MIPMap::lookup: the level where the width spans one texel,
    a lerp of the two bilinear levels around it."""
    img = _image_of(tex, tid)
    l0, l1, f = _levels(tex.atlas_levels[img].to(torch.float32), width)
    return (1.0 - f) * _bilinear_at_level(tex, img, st, l0) + f * _bilinear_at_level(
        tex, img, st, l1)


def _ewa_lattice():
    """The fixed 5x3 quadrature lattice inside the unit disk (15 probes)
    and its Gaussian weights exp(-2 r^2), normalised (the reference's)."""
    pts, wts = [], []
    for s_ in np.linspace(-0.8, 0.8, 5).astype(np.float32):
        for t_ in np.array([-0.6, 0.0, 0.6], np.float32):
            r2 = s_ * s_ + t_ * t_
            if r2 <= 1.0:
                pts.append((float(s_), float(t_)))
                wts.append(np.exp(-2.0 * r2))
    wsum = float(np.sum(wts))
    return [(p, float(w_ / wsum)) for p, w_ in zip(pts, wts)]


def sample_atlas_aniso(tex, tid, st, dst0, dst1):
    """EWA lookup: the footprint st + s dst0 + t dst1 over the unit disk,
    the minor axis scaled up to at most MAX_ANISOTROPY eccentricity, the
    level where it spans one texel, and the Gaussian-weighted lattice of
    probes, each a lerp of two levels; a degenerate footprint takes the
    trilinear lookup."""
    img = _image_of(tex, tid)
    n_levels = tex.atlas_levels[img].to(torch.float32)
    len0 = torch.sqrt(torch.sum(dst0 * dst0, -1))
    len1 = torch.sqrt(torch.sum(dst1 * dst1, -1))
    swap = len1 > len0
    maj_v = torch.where(swap[:, None], dst1, dst0)
    min_v = torch.where(swap[:, None], dst0, dst1)
    major_len = torch.where(swap, len1, len0)
    minor_len = torch.where(swap, len0, len1)
    too_thin = (minor_len * MAX_ANISOTROPY < major_len) & (minor_len > 0)
    scale = torch.where(too_thin, major_len / torch.clamp(minor_len * MAX_ANISOTROPY,
                                                          min=1e-12), 1.0)
    min_v = min_v * scale[:, None]
    minor_len = minor_len * scale
    degenerate = minor_len < 1e-8
    l0, l1, fr = _levels(n_levels, minor_len)
    acc = torch.zeros((tid.shape[0], 3), dtype=tex.atlas.dtype, device=st.device)
    for (s_, t_), w_ in _ewa_lattice():
        p_st = st + maj_v * s_ + min_v * t_
        c = _bilinear_at_level(tex, img, p_st, l0) * (1.0 - fr) \
            + _bilinear_at_level(tex, img, p_st, l1) * fr
        acc = acc + w_ * c
    tri = sample_atlas_trilinear(tex, tid, st, torch.maximum(major_len, minor_len))
    return torch.where(degenerate[:, None], tri, acc)
