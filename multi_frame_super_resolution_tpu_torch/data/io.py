"""Image output without Pillow: an 8-bit PNG from numpy and the standard
library's zlib (the counterpart of data/io.py::imwrite, which imports
Pillow)."""

from __future__ import annotations

import os
import struct
import zlib
from typing import Union

import numpy as np

PathLike = Union[str, "os.PathLike[str]"]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def imwrite(path: PathLike, img: np.ndarray) -> None:
    """Write a float [0, 1] (or uint8) image, (H, W), (H, W, 1) or
    (H, W, 3), as an 8-bit grayscale or RGB PNG. Floats are clipped and
    quantized as the JAX package's imwrite does: uint8(255 x + 0.5)."""
    img = np.asarray(img)
    if img.dtype in (np.float32, np.float64):
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.dtype != np.uint8:
        raise TypeError(f"imwrite takes float or uint8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color_type = 0
    elif img.ndim == 3 and img.shape[-1] == 3:
        color_type = 2
    else:
        raise ValueError(f"imwrite takes (H, W) or (H, W, 3) images, got {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter 0
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))
