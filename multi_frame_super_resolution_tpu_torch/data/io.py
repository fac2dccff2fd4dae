"""PNG input and output without Pillow, from numpy and the standard
library's zlib (the counterparts of data/io.py's imread and imwrite,
which import Pillow; the GPU host has none)."""

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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (name, samples per pixel) of the types imread decodes
_COLOR_TYPES = {0: ("gray", 1), 2: ("RGB", 3), 4: ("gray+alpha", 2), 6: ("RGBA", 4)}


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth)
    of ``h`` rows of ``stride`` bytes with ``bpp`` bytes per pixel."""
    raw = np.frombuffer(data, np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected {h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:  # a running sum of each byte lane, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):
            # each byte depends on the reconstructed byte bpp to its left
            ln, up, rec = line.tolist(), prev.tolist(), [0] * stride
            for x in range(stride):
                a = rec[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (a + up[x]) >> 1
                else:
                    b, c = up[x], (up[x - bpp] if x >= bpp else 0)
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                rec[x] = (ln[x] + pred) & 0xFF
            cur = np.asarray(rec, np.int64)
        else:
            raise ValueError(f"PNG row filter {kind} is not one of 0-4")
        out[y] = cur
        prev = cur
    return out


def imread(path: PathLike) -> np.ndarray:
    """Read a PNG as float32 RGB (H, W, 3) in [0, 1], as the JAX package's
    imread returns it: 8-bit samples times float32(1/255), 16-bit ones
    times float32(1/65535) (its libpng decoder's scale), gray repeated
    into three channels, alpha dropped.

    Decodes non-interlaced 8- and 16-bit gray, gray+alpha, RGB and RGBA
    with every row filter. Anything else (an interlaced or palette PNG,
    another bit depth, a JPEG or another format) raises ValueError naming
    what is missing."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        kind = "a JPEG" if blob[:3] == b"\xff\xd8\xff" else "not a PNG"
        raise ValueError(f"{os.fspath(path)} is {kind}; the port's imread decodes PNG only (no JPEG decoder)")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(blob):
        (length,), kind = struct.unpack(">I", blob[pos : pos + 4]), blob[pos + 4 : pos + 8]
        data = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{os.fspath(path)}: PNG without an IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if color_type not in _COLOR_TYPES:
        what = "a palette" if color_type == 3 else f"colour type {color_type}"
        raise ValueError(f"{os.fspath(path)}: PNG with {what}; imread decodes gray, gray+alpha, RGB and RGBA")
    if depth not in (8, 16):
        raise ValueError(f"{os.fspath(path)}: PNG of bit depth {depth}; imread decodes 8 and 16")
    if interlace:
        raise ValueError(f"{os.fspath(path)}: interlaced PNG; imread decodes non-interlaced PNG only")
    channels = _COLOR_TYPES[color_type][1]
    bpp = channels * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        samples = rows.view(">u2").reshape(h, w, channels)
        scale = np.float32(1.0 / 65535.0)
    else:
        samples = rows.reshape(h, w, channels)
        scale = np.float32(1.0 / 255.0)
    color = samples[..., :3] if channels >= 3 else np.repeat(samples[..., :1], 3, axis=-1)
    return color.astype(np.float32) * scale


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
