"""Minimal dependency-free PNG writer (util/simpleimage.cpp PNG-path parity).

The reference's SimpleImage can save .png next to .ppm; here a small
RFC-2083 encoder (zlib from the stdlib, no image libraries) covers the same
surface: 8-bit grayscale or RGB, rows top-down.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png(filename: str, img: np.ndarray) -> None:
    """Write (H, W) grayscale or (H, W, 3) RGB uint8/float array as PNG.

    Float inputs are clamped to [0, 1] and quantized; row 0 is the TOP row
    (flip beforehand for y-up grids, as the PPM writer does).
    """
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 2:
        color_type = 0
        h, w = arr.shape
        raw = arr[:, :, None]
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color_type = 2
        h, w = arr.shape[:2]
        raw = arr
    else:
        raise ValueError(f"write_png wants (H,W) or (H,W,3), got {arr.shape}")

    # filter byte 0 (None) per scanline
    scanlines = b"".join(b"\x00" + raw[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(filename, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(scanlines, 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(filename: str) -> np.ndarray:
    """Read the PNGs write_png produces (8-bit gray/RGB, filter 0/1/2/4) —
    enough for round-trip tests without an image library."""
    with open(filename, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    w = h = None
    color_type = 0
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color_type = struct.unpack(">IIBB", payload[:10])
            assert depth == 8, "only 8-bit supported"
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    ch = 3 if color_type == 2 else 1
    stride = w * ch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    p = 0
    for y in range(h):
        filt = raw[p]
        row = np.frombuffer(raw[p + 1:p + 1 + stride], np.uint8).astype(
            np.int32)
        p += 1 + stride
        if filt == 1:    # Sub
            for i in range(ch, stride):
                row[i] = (row[i] + row[i - ch]) & 0xFF
        elif filt == 2:  # Up
            row = (row + prev) & 0xFF
        elif filt == 4:  # Paeth
            for i in range(stride):
                a = row[i - ch] if i >= ch else 0
                b = prev[i]
                c = prev[i - ch] if i >= ch else 0
                pp = a + b - c
                pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (row[i] + pr) & 0xFF
        elif filt != 0:
            raise ValueError(f"unsupported PNG filter {filt}")
        out[y] = row.astype(np.uint8)
        prev = row
    img = out.reshape(h, w, ch)
    return img[:, :, 0] if ch == 1 else img
