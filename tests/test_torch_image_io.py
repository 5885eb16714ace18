"""Image input: the port's PFM, EXR and PNG readers against pbrt_tpu's on
files built here from seeded numpy data, the two reference EXR decoder
behaviours the port mirrors (pinned), and the PNG decoder against PIL.

Tolerances: every reader's pixels bit-equal to the reference reader's
(and to the data, where the format is lossless); load_image bit-equal to
the reference's sRGB decode.
"""
import struct
import zlib

import numpy as np
import pytest

from pbrt_tpu.io import exr_piz as J
from pbrt_tpu.io.image_io import read_exr as j_read_exr, read_pfm as j_read_pfm
from pbrt_tpu_torch.io import exr_piz as P
from pbrt_tpu_torch.io.image_io import (_exr_attr, _exr_predict, read_exr, read_image, read_pfm,
                                        read_png, write_exr, write_pfm, write_png)
from pbrt_tpu_torch.textures.image import load_image

# EXR pixel types: 0 UINT, 1 HALF, 2 FLOAT; compression ids and lines per chunk
LINES = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32, 5: 16}


def _rle(raw: bytes) -> bytes:
    """OpenEXR RLE: runs of 3 or more equal bytes as (count - 1, byte),
    the rest as literal runs (-n, n bytes)."""
    out, i, n = bytearray(), 0, len(raw)
    while i < n:
        j = i
        while j < n and j - i < 128 and raw[j] == raw[i]:
            j += 1
        if j - i >= 3:
            out += bytes([j - i - 1, raw[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 127 and not (j + 2 < n and raw[j] == raw[j + 1] == raw[j + 2]):
            j += 1
        out += bytes([256 - (j - i)]) + raw[i:j]
        i = j
    return bytes(out)


def _write_exr(path, rgb, comp, ctype=2):
    """Scanline EXR of channels B, G, R in pixel type ctype under
    compression comp, each chunk as the OpenEXR layout stores it (stored
    raw where the codec does not shrink it)."""
    h, w, _ = rgb.shape
    chans = b"".join(c + b"\x00" + struct.pack("<iiii", ctype, 0, 1, 1) for c in (b"B", b"G", b"R"))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (struct.pack("<ii", 20000630, 2) + _exr_attr(b"channels", b"chlist", chans + b"\x00")
              + _exr_attr(b"compression", b"compression", bytes([comp]))
              + _exr_attr(b"dataWindow", b"box2i", box)
              + _exr_attr(b"displayWindow", b"box2i", box)
              + _exr_attr(b"lineOrder", b"lineOrder", b"\x00") + b"\x00")
    dt = {1: np.float16, 2: np.float32}[ctype]
    chunks = []
    for y in range(0, h, LINES[comp]):
        nl = min(LINES[comp], h - y)
        planes = [rgb[y:y + nl, :, c].astype(dt) for c in (2, 1, 0)]
        raw = b"".join(planes[c][li].tobytes() for li in range(nl) for c in range(3))
        if comp == 0:
            data = raw
        elif comp == 1:
            data = _rle(_exr_predict(raw))
        elif comp in (2, 3):
            data = zlib.compress(_exr_predict(raw))
        elif comp == 4:
            data = J.piz_compress([pl.view(np.uint16).reshape(-1) for pl in planes],
                                  [(w, nl, 1 if ctype == 1 else 2)] * 3)
        else:
            data = J.pxr24_compress(planes, [("B", ctype), ("G", ctype), ("R", ctype)], w, nl)
        chunks.append((y, data if len(data) < len(raw) else raw))
    pos = len(header) + 8 * len(chunks)
    offsets = b""
    for _, data in chunks:
        offsets += struct.pack("<Q", pos)
        pos += 8 + len(data)
    with open(path, "wb") as f:
        f.write(header + offsets)
        for y, data in chunks:
            f.write(struct.pack("<ii", y, len(data)) + data)


def _smooth(h, w, seed):
    """A smooth image with some noise: every codec shrinks most chunks."""
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    img = np.stack([(yy + xx) / (h + w), yy / h * 0.5, xx / w * 0.25], -1)
    img[::3, ::5] += rng.uniform(0, 0.1, img[::3, ::5].shape)
    return img.astype(np.float32)


def test_pfm_color_and_gray(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 4, (5, 7, 3)).astype(np.float32)
    write_pfm(str(tmp_path / "c.pfm"), img)
    gray = rng.uniform(0, 1, (6, 3)).astype(np.float32)
    with open(tmp_path / "g.pfm", "wb") as f:   # big-endian gray
        f.write(b"Pf\n3 6\n1.0\n" + np.flipud(gray).astype(">f4").tobytes())
    for name, want in (("c.pfm", img), ("g.pfm", np.repeat(gray[..., None], 3, -1))):
        got = read_pfm(str(tmp_path / name))
        assert np.array_equal(got, want)
        assert np.array_equal(got, j_read_pfm(str(tmp_path / name)))
        assert np.array_equal(read_image(str(tmp_path / name)), want)


@pytest.mark.parametrize("comp,ctype", [(0, 2), (1, 2), (1, 1), (2, 2), (3, 2), (3, 1),
                                        (4, 1), (4, 2), (5, 2), (5, 1)])
def test_exr_matches_reference(tmp_path, comp, ctype):
    """None, RLE, ZIPS, ZIP, PIZ and PXR24 chunks, half and float, with a
    short last chunk (PIZ and PXR24 chunks written by the reference's own
    encoders, whose layout its decoders read)."""
    img = _smooth(37, 13, seed=comp)
    path = str(tmp_path / f"c{comp}_{ctype}.exr")
    _write_exr(path, img, comp, ctype)
    got = read_exr(path)
    assert np.array_equal(got, j_read_exr(path))
    want = img.astype(np.float16).astype(np.float32) if ctype == 1 else img
    if comp == 5 and ctype == 2:
        np.testing.assert_allclose(got, want, rtol=2 ** -15)   # 24-bit floats
    else:
        assert np.array_equal(got, want)


def test_exr_uncompressed_round_trip(tmp_path):
    img = np.random.default_rng(2).uniform(0, 1, (9, 13, 3)).astype(np.float32)
    write_exr(str(tmp_path / "u.exr"), img)
    assert np.array_equal(read_image(str(tmp_path / "u.exr")), img)


def _wav2_encode_openexr(a, mx):
    """OpenEXR's wav2Encode (ImfWav.cpp) on a [ny, nx] uint16 plane: 2x2
    quads up to nx - p2 and ny - p2, then the odd column and odd row as
    1-D pairs."""
    a = a.copy()
    ny, nx = a.shape
    enc = P._wenc14 if mx < (1 << 14) else P._wenc16
    p, p2 = 1, 2
    while p2 <= min(nx, ny):
        y = 0
        while y <= ny - p2:
            x = 0
            while x <= nx - p2:
                i00, i01 = enc(a[y, x], a[y, x + p])
                i10, i11 = enc(a[y + p, x], a[y + p, x + p])
                a[y, x], a[y + p, x] = enc(i00, i10)
                a[y, x + p], a[y + p, x + p] = enc(i01, i11)
                x += p2
            if nx & p:
                a[y, x], a[y + p, x] = enc(a[y, x], a[y + p, x])
            y += p2
        if ny & p:
            x = 0
            while x <= nx - p2:
                a[y, x], a[y, x + p] = enc(a[y, x], a[y, x + p])
                x += p2
        p, p2 = p2, p2 << 1
    return a


def test_piz_wavelet_edge_fault_is_mirrored():
    """Mirrored reference fault (exr_piz.py wav2_decode): on a size that is
    not a power of two, a plane OpenEXR's encoder wrote decodes wrong at
    the edges, the same wrong in both packages; on a power of two it
    decodes right."""
    rng = np.random.default_rng(4)
    for shape, exact in (((8, 7), False), ((5, 11), False), ((8, 8), True)):
        a = rng.integers(0, 1000, shape).astype(np.uint16)
        enc = _wav2_encode_openexr(a, 1000)
        got = P.wav2_decode(enc, 1000)
        assert np.array_equal(got, J.wav2_decode(enc, 1000))
        assert np.array_equal(got, a) == exact, shape
        assert np.array_equal(P.wav2_decode(P.wav2_encode(a, 1000), 1000), a)


def test_pxr24_channel_order_fault_is_mirrored():
    """Mirrored reference fault (exr_piz.py pxr24_uncompress): a chunk of
    several lines in OpenEXR's order (each line, then each channel's byte
    planes) decodes channel-major in both packages, so it comes out wrong,
    the same wrong; the reference's own (channel-major) encoding reads
    back."""
    rng = np.random.default_rng(5)
    w, nl = 6, 3
    chs = [("B", 1), ("G", 1)]
    planes = [rng.uniform(0, 1, (nl, w)).astype(np.float16) for _ in chs]
    raw = bytearray()
    for y in range(nl):
        for pl in planes:
            d = np.diff(pl[y].view(np.uint16).astype(np.int64), prepend=0) & 0xFFFF
            raw += ((d >> 8) & 0xFF).astype(np.uint8).tobytes() + (d & 0xFF).astype(np.uint8).tobytes()
    payload = zlib.compress(bytes(raw))
    got = P.pxr24_uncompress(payload, chs, w, nl)
    want = J.pxr24_uncompress(payload, chs, w, nl)
    for g, j, pl in zip(got, want, planes):
        assert np.array_equal(g, j)
    assert not all(np.array_equal(g, pl.astype(np.float32)) for g, pl in zip(got, planes))
    back = P.pxr24_uncompress(J.pxr24_compress(planes, chs, w, nl), chs, w, nl)
    assert all(np.array_equal(g, pl.astype(np.float32)) for g, pl in zip(back, planes))


def _png(path, rows, w, ctype, depth, filters, palette=None):
    """Write a PNG of [h, row_bytes] uint8 rows, row y filtered with
    filters[y % len(filters)] (PNG's five filter types)."""
    h, n = rows.shape
    bpp = max(1, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] * depth // 8)
    out, prior = [], np.zeros(n, np.int64)
    for y in range(h):
        cur, f = rows[y].astype(np.int64), filters[y % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        pa, pb, pc = np.abs(prior - c), np.abs(a - c), np.abs(a + prior - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
        pred = [0, a, prior, (a + prior) >> 1, paeth][f]
        out.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prior = cur

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    if palette is not None:
        body += chunk(b"PLTE", palette.tobytes())
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body + chunk(b"IDAT", zlib.compress(b"".join(out)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,depth", [(2, 8), (6, 8), (0, 8), (4, 8), (2, 16), (0, 16),
                                         (0, 4), (3, 8), (3, 2)])
def test_png_decoder_every_filter(tmp_path, ctype, depth):
    """Rows under all five filters in turn decode to the samples written."""
    rng = np.random.default_rng(ctype * 100 + depth)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    h, w = 11, 9
    top = 1 << depth
    samples = rng.integers(0, top, (h, w, ch)).astype(np.uint16 if depth == 16 else np.uint8)
    if depth == 16:
        rows = samples.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth == 8:
        rows = samples.reshape(h, -1)
    else:
        bits = np.unpackbits(samples[..., 0][..., None], axis=-1)[..., 8 - depth:]
        bits = np.concatenate([bits.reshape(h, -1), np.zeros((h, (-w * depth) % 8), np.uint8)], 1)
        rows = np.packbits(bits, axis=1)
    palette = rng.integers(0, 256, (top, 3)).astype(np.uint8) if ctype == 3 else None
    path = str(tmp_path / "f.png")
    _png(path, rows, w, ctype, depth, [0, 1, 2, 3, 4], palette)
    got = read_png(path)
    if ctype == 3:
        want = palette[samples[..., 0]]
    elif depth < 8:
        want = (samples * (255 // (top - 1))).astype(np.uint8)
    else:
        want = samples
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_png_decoder_raises_on_interlace(tmp_path):
    path = str(tmp_path / "i.png")
    write_png(path, np.zeros((2, 2, 3), np.float32))
    data = bytearray(open(path, "rb").read())
    data[28] = 1   # IHDR's interlace byte
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        read_png(path)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "I;16"])
def test_png_decoder_and_load_image_match_pil(tmp_path, mode):
    """PNGs that PIL writes (its own filter choices): the samples equal
    PIL's, and load_image equals the reference's PIL-based sRGB decode."""
    Image = pytest.importorskip("PIL.Image")
    from pbrt_tpu.textures.image import load_image as j_load_image
    rng = np.random.default_rng(len(mode))
    h, w = 13, 17
    if mode == "I;16":
        im = Image.fromarray(rng.integers(0, 600, (h, w)).astype(np.uint16))
    elif mode == "P":
        im = Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).convert(
            "P", palette=Image.ADAPTIVE, colors=40)
    else:
        ch = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2}[mode]
        a = (np.linspace(0, 255, h * w * ch).reshape(h, w, ch)
             + rng.integers(0, 40, (h, w, ch))).clip(0, 255).astype(np.uint8)
        im = Image.fromarray(a[..., 0] if ch == 1 else a, mode)
    path = str(tmp_path / "pil.png")
    im.save(path)
    got = read_png(path)
    want = np.asarray(Image.open(path).convert("RGB") if mode == "P" else Image.open(path))
    assert np.array_equal(got.reshape(want.shape), want)
    for gamma in (True, False):
        assert np.array_equal(load_image(path, gamma), j_load_image(path, gamma))
