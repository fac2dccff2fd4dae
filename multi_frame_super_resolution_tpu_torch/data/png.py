"""PNG in numpy and the standard library's zlib, as libpng reads it with
the native library's transforms (palette to RGB, gray of 1, 2 and 4 bits
expanded to 8, Adam7 interlacing handled): ``decode`` -> the samples,
``encode`` -> an 8-bit gray or RGB PNG."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (name, samples per pixel, bit depths)
COLOR_TYPES = {0: ("gray", 1, (1, 2, 4, 8, 16)), 2: ("RGB", 3, (8, 16)), 3: ("palette", 1, (1, 2, 4, 8)),
               4: ("gray+alpha", 2, (8, 16)), 6: ("RGBA", 4, (8, 16))}
# Adam7: (first column, first row, column step, row step) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth)
    of ``h`` rows of ``stride`` bytes, each after its filter byte, with
    ``bpp`` bytes per pixel (at least 1)."""
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:  # a running sum of each byte lane, mod 256
            padded = np.concatenate([line, np.zeros(-stride % bpp, np.int64)])
            cur = (np.cumsum(padded.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF)[:stride]
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


def _unpack(rows: np.ndarray, w: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows (h, stride) -> samples (h, w, channels), 1-, 2- and
    4-bit samples unpacked MSB first, 16-bit ones big-endian."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(h, w, channels)
    if depth < 8:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, : w * channels]
    return rows.reshape(h, w, channels)


def _image(data: np.ndarray, w: int, h: int, channels: int, depth: int, name: str) -> tuple:
    """One (sub)image's filtered bytes -> (samples (h, w, channels), bytes used)."""
    stride = -(-w * channels * depth // 8)
    size = h * (stride + 1)
    if data.size < size:
        raise ValueError(f"{name}: PNG image data holds {data.size} bytes, expected {size}")
    rows = unfilter(data[:size], h, stride, max(1, channels * depth // 8))
    return _unpack(rows, w, channels, depth), size


def decode(blob: bytes, name: str = "PNG"):
    """A PNG's bytes -> (samples (H, W, C), bit depth 8 or 16): palette
    images mapped to RGB through PLTE (tRNS leaves the RGB as it is), gray
    of 1, 2 and 4 bits scaled to 8 by 255 / (2^d - 1), Adam7 passes
    unfiltered each at its own width and placed. Anything else raises
    ValueError naming what."""
    pos, header, idat, palette = 8, None, [], None
    while pos + 8 <= len(blob):
        (length,), kind = struct.unpack(">I", blob[pos : pos + 4]), blob[pos + 4 : pos + 8]
        data = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8)[: len(data) // 3 * 3].reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if color_type not in COLOR_TYPES:
        raise ValueError(f"{name}: PNG colour type {color_type}; PNG has 0, 2, 3, 4 and 6")
    kind_name, channels, depths = COLOR_TYPES[color_type]
    if depth not in depths:
        raise ValueError(f"{name}: {kind_name} PNG of bit depth {depth}; PNG allows {depths}")
    if interlace not in (0, 1):
        raise ValueError(f"{name}: PNG interlace method {interlace}; PNG has 0 (none) and 1 (Adam7)")
    if color_type == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    try:
        data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as err:
        raise ValueError(f"{name}: PNG image data does not inflate ({err})") from None
    if not interlace:
        samples, _ = _image(data, w, h, channels, depth, name)
    else:
        samples = np.zeros((h, w, channels), ">u2" if depth == 16 else np.uint8)
        at = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue  # an empty pass has no bytes, not even filter bytes
            sub, used = _image(data[at:], pw, ph, channels, depth, name)
            samples[y0::dy, x0::dx] = sub
            at += used
    if color_type == 3:
        if samples.max(initial=0) >= len(palette):
            raise ValueError(f"{name}: PNG palette index {samples.max()} past its PLTE of {len(palette)} entries")
        return palette[samples[..., 0]], 8
    if depth < 8:
        return samples * np.uint8(255 // ((1 << depth) - 1)), 8
    return samples, depth


def encode(img: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 3) -> the bytes of an 8-bit gray or RGB PNG
    (filter 0 on every row, zlib level 6)."""
    color_type = 0 if img.ndim == 2 else 2
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter 0
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b"")
