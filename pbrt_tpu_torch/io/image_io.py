"""Image input and output, all numpy (port of pbrt_tpu/io/image_io.py).

Writes PNG (8-bit sRGB), PFM and uncompressed EXR. Reads PFM; EXR with
no, RLE, ZIPS, ZIP, PIZ or PXR24 compression (the last two through
io/exr_piz.py); and PNG, decoded here with zlib (no imaging library): bit
depths 1 to 16, gray, gray+alpha, RGB, RGBA and palette, all five row
filters; Adam7 interlacing raises.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def write_image(path: str, rgb: np.ndarray):
    """Dispatch on the extension; unknown extensions write a PNG."""
    ext = os.path.splitext(path)[1].lower()
    rgb = np.asarray(rgb, np.float32)
    if ext == ".pfm":
        write_pfm(path, rgb)
    elif ext == ".exr":
        write_exr(path, rgb)
    elif ext in (".png", ""):
        write_png(path if ext else path + ".png", rgb)
    else:
        write_png(os.path.splitext(path)[0] + ".png", rgb)


def to_srgb8(rgb_linear: np.ndarray) -> np.ndarray:
    """Linear RGB -> 8-bit sRGB, as the reference's PNG writer rounds."""
    v = np.clip(rgb_linear, 0.0, 1.0)
    srgb = np.where(v <= 0.0031308, 12.92 * v,
                    1.055 * np.power(np.maximum(v, 1e-8), 1.0 / 2.4) - 0.055)
    return (np.clip(srgb, 0, 1) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, rgb_linear: np.ndarray):
    u8 = to_srgb8(rgb_linear)
    h, w = u8.shape[:2]
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


# PNG colour types -> samples per pixel
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) -> [h,
    row_bytes] uint8. bpp: bytes per complete pixel, at least 1."""
    out = np.zeros((h, row_bytes), np.uint8)
    prior = np.zeros(row_bytes, np.int64)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        cur = np.frombuffer(raw, np.uint8, row_bytes, pos + 1).astype(np.int64)
        pos += 1 + row_bytes
        if ftype == 1:      # Sub: a running sum over each byte lane
            pad = (-row_bytes) % bpp
            lanes = np.concatenate([cur, np.zeros(pad, np.int64)]).reshape(-1, bpp)
            cur = (np.cumsum(lanes, 0) & 0xFF).reshape(-1)[:row_bytes]
        elif ftype == 2:    # Up
            cur = (cur + prior) & 0xFF
        elif ftype in (3, 4):   # Average, Paeth: each byte needs the one before
            c, b = cur.tolist(), prior.tolist()
            for i in range(row_bytes):
                a = c[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    c[i] = (c[i] + ((a + b[i]) >> 1)) & 0xFF
                else:
                    cc = b[i - bpp] if i >= bpp else 0
                    pp = a + b[i] - cc
                    pa, pb, pc = abs(pp - a), abs(pp - b[i]), abs(pp - cc)
                    pred = a if pa <= pb and pa <= pc else (b[i] if pb <= pc else cc)
                    c[i] = (c[i] + pred) & 0xFF
            cur = np.asarray(c, np.int64)
        elif ftype != 0:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG -> [H, W, C] samples, uint8 for bit depths up to 8 and
    uint16 for 16 (C: 1 gray, 2 gray+alpha, 3 RGB or palette entries, 4
    RGBA); sub-byte gray is scaled to 0..255 as imaging libraries do, and
    palette indices are resolved to their RGB entries."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos, idat, palette, hdr = 8, [], None, None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNGs are not read")
    if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{path}: PNG colour type {ctype} at bit depth {depth}")
    ch = _PNG_CHANNELS[ctype]
    bits = ch * depth
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, (w * bits + 7) // 8,
                     max(1, bits // 8))
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    elif depth == 8:
        img = rows.reshape(h, w, ch)
    else:
        img = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        img = (img * (1 << np.arange(depth - 1, -1, -1))).sum(-1).astype(np.uint8)[..., None]
        if ctype == 0:
            img = (img * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        img = palette[img[..., 0]]
    return np.ascontiguousarray(img)


def write_pfm(path: str, rgb: np.ndarray):
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little endian
        f.write(np.flipud(rgb).astype("<f4").tobytes())   # bottom-up rows


def _exr_attr(name: bytes, atype: bytes, data: bytes) -> bytes:
    return name + b"\x00" + atype + b"\x00" + struct.pack("<i", len(data)) + data


def write_exr(path: str, rgb: np.ndarray):
    """Minimal uncompressed scanline float32 RGB EXR."""
    h, w = rgb.shape[:2]
    rgb = np.asarray(rgb, np.float32)
    channels = b""
    for name in (b"B", b"G", b"R"):
        channels += name + b"\x00" + struct.pack("<i", 2) + struct.pack("<i", 0) \
            + struct.pack("<ii", 1, 1)
    channels += b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (_exr_attr(b"channels", b"chlist", channels)
              + _exr_attr(b"compression", b"compression", b"\x00")
              + _exr_attr(b"dataWindow", b"box2i", box)
              + _exr_attr(b"displayWindow", b"box2i", box)
              + _exr_attr(b"lineOrder", b"lineOrder", b"\x00")
              + _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
              + _exr_attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0))
              + _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
              + b"\x00")
    magic = struct.pack("<i", 20000630) + struct.pack("<i", 2)
    table_pos = len(magic) + len(header)
    line_size = 8 + w * 4 * 3
    offsets = b"".join(struct.pack("<Q", table_pos + 8 * h + i * line_size)
                       for i in range(h))
    with open(path, "wb") as f:
        f.write(magic + header + offsets)
        for y in range(h):
            f.write(struct.pack("<ii", y, w * 4 * 3))
            for c in (2, 1, 0):
                f.write(rgb[y, :, c].astype("<f4").tobytes())


def read_image(path: str) -> np.ndarray:
    """[H, W, 3] float32 linear RGB by extension: PFM, EXR, else PNG
    (sRGB-decoded, textures/image.py::load_image)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        return read_pfm(path)
    if ext == ".exr":
        return read_exr(path)
    from pbrt_tpu_torch.textures.image import load_image
    return load_image(path)


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        color = f.readline().strip() == b"PF"
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        count = w * h * (3 if color else 1)
        data = np.frombuffer(f.read(count * 4), "<f4" if scale < 0 else ">f4").reshape(h, w, -1)
    img = np.flipud(data).astype(np.float32)   # PFM rows run bottom-up
    return img if color else np.repeat(img, 3, axis=-1)


# scanlines per chunk by EXR compression id: none, RLE, ZIPS, ZIP, PIZ, PXR24
_EXR_LINES = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32, 5: 16}


def _exr_header(data: bytes):
    """-> ({attribute: (type, bytes)}, offset past the header)."""
    if struct.unpack("<i", data[:4])[0] != 20000630:
        raise ValueError("not an EXR file")
    pos, attrs = 8, {}
    while data[pos] != 0:
        e = data.index(b"\x00", pos)
        name = data[pos:e].decode()
        e2 = data.index(b"\x00", e + 1)
        atype = data[e + 1:e2].decode()
        size = struct.unpack("<i", data[e2 + 1:e2 + 5])[0]
        attrs[name] = (atype, data[e2 + 5:e2 + 5 + size])
        pos = e2 + 5 + size
    return attrs, pos + 1


def read_exr(path: str) -> np.ndarray:
    """Scanline EXR -> [H, W, 3] float32; channels R, G, B (or Y for all
    three), stored alphabetically per line as the format requires."""
    from pbrt_tpu_torch.io import exr_piz
    with open(path, "rb") as f:
        data = f.read()
    attrs, pos = _exr_header(data)
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][1][0]
    lines_per_block = _EXR_LINES.get(comp)
    if lines_per_block is None:
        raise ValueError(f"unsupported EXR compression {comp} "
                         "(supported: none/RLE/ZIPS/ZIP/PIZ/PXR24)")
    chs, cdata, cpos = [], attrs["channels"][1], 0
    while cdata[cpos] != 0:
        e = cdata.index(b"\x00", cpos)
        chs.append((cdata[cpos:e].decode(), struct.unpack("<i", cdata[e + 1:e + 5])[0]))
        cpos = e + 17
    nblocks = -(-h // lines_per_block)
    pos += 8 * nblocks   # the offset table: chunks follow in order
    bpp = {0: 4, 1: 2, 2: 4}
    line_bytes = sum(w * bpp[ct] for _, ct in chs)
    out = np.zeros((h, w, 3), np.float32)
    cmap = {"R": 0, "G": 1, "B": 2, "Y": 0}
    for _ in range(nblocks):
        by, size = struct.unpack("<ii", data[pos:pos + 8])
        pos += 8
        nlines = min(lines_per_block, h - (by - y0))
        payload = data[pos:pos + size]
        pos += size
        rows = slice(by - y0, by - y0 + nlines)
        if comp in (4, 5) and size < line_bytes * nlines:
            if comp == 4:
                planes = exr_piz.piz_uncompress(payload, [(w, nlines, 1 if ct == 1 else 2)
                                                          for _, ct in chs])
                vals = []
                for (_, ct), pl in zip(chs, planes):
                    if ct == 1:
                        vals.append(pl.reshape(nlines, w).view(np.float16).astype(np.float32))
                    else:
                        v32 = pl.reshape(nlines, w * 2).view(np.uint32).reshape(nlines, w)
                        vals.append(v32.view(np.float32) if ct == 2 else v32.astype(np.float32))
            else:
                vals = [v.astype(np.float32)
                        for v in exr_piz.pxr24_uncompress(payload, chs, w, nlines)]
            for (cname, _), v in zip(chs, vals):
                if cname in cmap:
                    out[rows, :, cmap[cname]] = v
            continue
        if comp == 0 or size >= line_bytes * nlines:
            raw = payload   # stored raw when compression did not shrink it
        elif comp in (2, 3):
            raw = _exr_unpredict(zlib.decompress(payload))
        else:
            raw = _exr_unpredict(_exr_rle_decode(payload))
        off = 0
        for li in range(nlines):
            for cname, ct in chs:
                dt = {2: "<f4", 1: "<f2"}.get(ct, "<u4")
                vals = np.frombuffer(raw, dt, w, off).astype(np.float32)
                off += w * bpp[ct]
                if cname in cmap:
                    out[by - y0 + li, :, cmap[cname]] = vals
    if all(c[0] == "Y" for c in chs):
        out[:, :, 1] = out[:, :, 0]
        out[:, :, 2] = out[:, :, 0]
    return out


def _exr_unpredict(t: bytes) -> bytes:
    """ZIP/RLE postprocess: undo the byte delta predictor, then interleave
    the two halves (even bytes first, odd bytes second)."""
    d = np.frombuffer(t, np.uint8).astype(np.int64)
    d[1:] -= 128
    rec = (np.cumsum(d) % 256).astype(np.uint8)
    half = (len(rec) + 1) // 2
    out = np.empty(len(rec), np.uint8)
    out[0::2] = rec[:half]
    out[1::2] = rec[half:]
    return out.tobytes()


def _exr_predict(t: bytes) -> bytes:
    """Inverse of _exr_unpredict, for writers and tests."""
    a = np.frombuffer(t, np.uint8)
    d = np.concatenate([a[0::2], a[1::2]]).astype(np.int64)
    d[1:] = d[1:] - d[:-1] + 128
    return (d % 256).astype(np.uint8).tobytes()


def _exr_rle_decode(src: bytes) -> bytes:
    """RLE: a signed count byte; negative -n: n literal bytes follow, else
    the next byte repeats count + 1 times."""
    out, i = bytearray(), 0
    while i < len(src):
        c = src[i]
        i += 1
        if c > 127:
            out += src[i:i + 256 - c]
            i += 256 - c
        else:
            out += bytes([src[i]]) * (c + 1)
            i += 1
    return bytes(out)
