"""Image output: PNG (8-bit sRGB), PFM and uncompressed EXR, all numpy.

PNG is written by hand with zlib and struct (no imaging library needed).
The PFM and EXR writers are pbrt_tpu/io/image_io.py's.
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


def read_png(path: str) -> np.ndarray:
    """Read back an 8-bit RGB PNG as written by write_png -> [H,W,3] uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise ValueError("only 8-bit RGB PNGs are read")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if np.any(rows[:, 0] != 0):
        raise ValueError("only unfiltered PNG rows are read")
    return rows[:, 1:].reshape(h, w, 3).copy()


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
