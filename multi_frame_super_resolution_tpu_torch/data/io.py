"""Image input and output without Pillow (the counterparts of
data/io.py's imread, imread_gray, imread_u16 and imwrite, which import
Pillow; the GPU host has none). The readers go through the native
library (data/native.py) where it is built, as the JAX package's do,
else through numpy and the standard library's zlib: PNG and baseline
TIFF. imwrite writes PNG."""

from __future__ import annotations

import os
import struct
import zlib
from typing import Union

import numpy as np

from multi_frame_super_resolution_tpu_torch.data import native

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


def _decode_png(blob: bytes, name: str):
    """A non-interlaced 8- or 16-bit gray, gray+alpha, RGB or RGBA PNG ->
    (its samples (H, W, C), bit depth)."""
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
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if color_type not in _COLOR_TYPES:
        what = "a palette" if color_type == 3 else f"colour type {color_type}"
        raise ValueError(f"{name}: PNG with {what}; imread decodes gray, gray+alpha, RGB and RGBA")
    if depth not in (8, 16):
        raise ValueError(f"{name}: PNG of bit depth {depth}; imread decodes 8 and 16")
    if interlace:
        raise ValueError(f"{name}: interlaced PNG; imread decodes non-interlaced PNG only")
    channels = _COLOR_TYPES[color_type][1]
    bpp = channels * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    samples = rows.view(">u2") if depth == 16 else rows
    return samples.reshape(h, w, channels), depth


# TIFF field types the baseline reader takes: BYTE, SHORT, LONG
_TIFF_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4)}
_TIFF_TAGS = {256: "ImageWidth", 257: "ImageLength", 258: "BitsPerSample", 259: "Compression",
              273: "StripOffsets", 277: "SamplesPerPixel", 278: "RowsPerStrip", 279: "StripByteCounts",
              284: "PlanarConfiguration"}


def _decode_tiff(blob: bytes, name: str):
    """A baseline TIFF's first image -> (its samples (H, W, C), bit depth),
    as native/mfsr_native.cpp::decode_tiff reads it: II or MM byte order,
    uncompressed strips, 8- or 16-bit samples in chunky order, 1 or at
    least 3 samples a pixel (the first 3 kept). Anything else raises
    ValueError naming the tag."""
    end = "<" if blob[:2] == b"II" else ">"

    def tag_name(tag):
        return f"TIFF {_TIFF_TAGS[tag]} (tag {tag})"

    try:
        magic, ifd = struct.unpack_from(end + "HI", blob, 2)
        if magic != 42:
            raise ValueError(f"{name}: TIFF header without 42")
        (n_entries,) = struct.unpack_from(end + "H", blob, ifd)
        fields = {}
        for i in range(n_entries):
            entry = ifd + 2 + 12 * i
            tag, kind, count = struct.unpack_from(end + "HHI", blob, entry)
            if tag in _TIFF_TAGS and kind in _TIFF_TYPES:
                code, unit = _TIFF_TYPES[kind]
                at = entry + 8 if unit * count <= 4 else struct.unpack_from(end + "I", blob, entry + 8)[0]
                fields[tag] = struct.unpack_from(f"{end}{count}{code}", blob, at)
    except struct.error as err:
        raise ValueError(f"{name}: truncated TIFF ({err})") from None
    for tag in (256, 257, 273):
        if tag not in fields:
            raise ValueError(f"{name}: no {tag_name(tag)}")
    (width,), (height,), offsets = fields[256], fields[257], fields[273]
    bits, compression, spp = fields.get(258, (8,))[0], fields.get(259, (1,))[0], fields.get(277, (1,))[0]
    rows_per_strip, planar = fields.get(278, (height,))[0], fields.get(284, (1,))[0]
    if compression != 1:
        raise ValueError(f"{name}: {tag_name(259)} {compression}; the port reads uncompressed (1) TIFF only")
    if planar != 1:
        raise ValueError(f"{name}: {tag_name(284)} {planar}; the port reads chunky (1) TIFF only")
    if bits not in (8, 16):
        raise ValueError(f"{name}: {tag_name(258)} {bits}; the port reads 8 and 16")
    if spp == 0 or spp == 2:
        raise ValueError(f"{name}: {tag_name(277)} {spp}; the port reads 1, 3 or more")
    row_bytes = width * spp * bits // 8
    counts = fields.get(279, ())
    rows = np.zeros((height, row_bytes), np.uint8)  # rows no strip covers stay 0, as in the C++ reader
    row = 0
    for s, offset in enumerate(offsets):
        n = min(rows_per_strip, height - row)
        if n <= 0:
            break
        if (s < len(counts) and counts[s] < n * row_bytes) or offset + n * row_bytes > len(blob):
            raise ValueError(f"{name}: TIFF strip {s} holds fewer than its {n} rows")
        rows[row : row + n] = np.frombuffer(blob, np.uint8, n * row_bytes, offset).reshape(n, row_bytes)
        row += n
    samples = rows.view(end + "u2") if bits == 16 else rows
    return samples.reshape(height, width, spp)[..., : 1 if spp == 1 else 3], bits


def _read_samples(path: PathLike):
    """A PNG's or baseline TIFF's samples (H, W, C) and their scale to [0,
    1]: float32(1/255) for 8-bit, float32(1/65535) for 16-bit (the native
    library's scales). Another format raises ValueError."""
    name = os.fspath(path)
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] == _PNG_SIGNATURE:
        samples, depth = _decode_png(blob, name)
    elif blob[:4] in (b"II*\x00", b"MM\x00*"):
        samples, depth = _decode_tiff(blob, name)
    else:
        kind = "a JPEG" if blob[:3] == b"\xff\xd8\xff" else "neither a PNG nor a TIFF"
        raise ValueError(f"{name} is {kind}; without the native reader the port decodes PNG and baseline "
                         "TIFF only (no JPEG decoder)")
    return samples, np.float32(1.0 / 65535.0) if depth == 16 else np.float32(1.0 / 255.0)


def _rgb(samples: np.ndarray, scale: np.float32) -> np.ndarray:
    color = samples[..., :3] if samples.shape[-1] >= 3 else np.repeat(samples[..., :1], 3, axis=-1)
    return color.astype(np.float32) * scale


def _luma(rgb: np.ndarray) -> np.ndarray:
    """The native library's BT.601 luma, in float32 in its order."""
    r, g, b = np.moveaxis(rgb, -1, 0)
    return np.float32(0.299) * r + np.float32(0.587) * g + np.float32(0.114) * b


def imread(path: PathLike) -> np.ndarray:
    """Read an image as float32 RGB (H, W, 3) in [0, 1], as the JAX
    package's imread returns it: 8-bit samples times float32(1/255),
    16-bit ones times float32(1/65535), gray repeated into three channels,
    alpha dropped.

    Reads through the native library (data/native.py: PNG, JPEG, baseline
    TIFF) where it is built, else through numpy: non-interlaced 8- and
    16-bit gray, gray+alpha, RGB and RGBA PNG with every row filter, and
    baseline TIFF (``_decode_tiff``). On the numpy route anything else
    (an interlaced or palette PNG, another bit depth, a compressed TIFF, a
    JPEG) raises ValueError naming what is missing."""
    out = native.imread_native(os.fspath(path))
    if out is not None:
        return out
    return _rgb(*_read_samples(path))


def imread_gray(path: PathLike) -> np.ndarray:
    """Read an image as float32 (H, W) in [0, 1]: the BT.601 luma 0.299 r
    + 0.587 g + 0.114 b in float32 of the scaled channels (gray: r = g =
    b), the native library's function on either route. (The JAX package's
    Pillow route, where its library is not built, returns Pillow's uint8
    "L" instead: another function.)"""
    out = native.imread_native(os.fspath(path), gray=True)
    if out is not None:
        return out
    return _luma(_rgb(*_read_samples(path)))


def imread_u16(path: PathLike) -> np.ndarray:
    """Read a 16-bit (or 8-bit) image, such as the defog app's TIFF inputs,
    as float32 in [0, 1] (the reference's IMREAD_ANYDEPTH and
    convertTo(1/65535), polar_defog.cpp:80-81) as the native library
    returns it, on either route: one channel as the luma of that channel
    repeated (``imread_gray``, within an ulp of the sample), (H, W); else
    RGB (H, W, 3). Compressed or planar TIFFs raise ValueError on the numpy route
    (the JAX package reads them with Pillow; the GPU host has none)."""
    meta = native.probe(os.fspath(path))
    if meta is not None:
        out = native.imread_native(os.fspath(path), gray=meta[2] == 1)
        if out is not None:
            return out
    samples, scale = _read_samples(path)
    rgb = _rgb(samples, scale)
    return _luma(rgb) if samples.shape[-1] == 1 else rgb


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
