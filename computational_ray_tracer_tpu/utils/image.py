"""Headless image I/O (the presentation-layer replacement, SURVEY §2.3:
GraphicsManager's GL upload becomes PNG/numpy dumps; live progress = periodic
image writes)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img):
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _png_chunk(tag, data):
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def png_bytes(img):
    """8-bit RGB (or grayscale for (H, W)) PNG encoding of ``img``: float in
    [0,1] or uint8. Standard library only (zlib + struct)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        color_type = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"expected (H, W), (H, W, 1) or (H, W, 3), got "
                         f"{arr.shape}")
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    # filter type 0 (None) before every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def write_png(path, img):
    """img: (H, W, 3) or (H, W) float in [0,1] or uint8."""
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def read_image(path):
    """(H, W, 3) float32 in [0,1] (the stbi_load capability,
    RayTracerTestApp.h:79). Needs PIL, which only the texture-loading app
    uses."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def write_npy(path, img):
    np.save(path, np.asarray(img))
