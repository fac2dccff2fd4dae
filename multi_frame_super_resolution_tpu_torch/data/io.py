"""Image input and output without Pillow (the counterparts of
data/io.py's imread, imread_gray, imread_u16 and imwrite, which import
Pillow; the GPU host has none). The readers go through the native
library (data/native.py) where it is built, as the JAX package's do,
else through numpy and the standard library's zlib: PNG (data/png.py),
TIFF (data/tiff.py) and JPEG (data/jpeg.py). imwrite writes PNG, JPEG or
TIFF by the path's extension."""

from __future__ import annotations

import os
from typing import Union

import numpy as np

from multi_frame_super_resolution_tpu_torch.data import jpeg, native, png, tiff

PathLike = Union[str, "os.PathLike[str]"]


_WRITERS = {".png": png.encode, ".jpg": jpeg.encode, ".jpeg": jpeg.encode, ".tif": tiff.encode, ".tiff": tiff.encode}


def _read_samples(path: PathLike):
    """A PNG's, TIFF's or JPEG's samples (H, W, C) and their scale to [0,
    1]: float32(1/255) for 8-bit, float32(1/65535) for 16-bit (the native
    library's scales). Another format, or a form the decoders refuse,
    raises ValueError naming it."""
    name = os.fspath(path)
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] == png.SIGNATURE:
        samples, depth = png.decode(blob, name)
    elif blob[:4] in (b"II*\x00", b"MM\x00*"):
        samples, depth = tiff.decode(blob, name)
    elif blob[:3] == b"\xff\xd8\xff":
        samples, depth = jpeg.decode(blob, name), 8
    else:
        raise ValueError(f"{name} is neither a PNG, a TIFF nor a JPEG; without the native reader the port "
                         "decodes those three (BMP, GIF, WebP and the other formats only Pillow reads are refused)")
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
    TIFF) where it is built, else through numpy to the same samples: PNG
    of every colour type, bit depth and row filter, Adam7 too
    (``png.decode``); baseline and progressive Huffman JPEG
    (``jpeg.decode``); TIFF strips, uncompressed or LZW, Deflate or
    PackBits, Predictor 2, chunky or planar (``tiff.decode``). On the
    numpy route anything else raises ValueError naming it. (Where the JAX
    package reads a compressed TIFF through Pillow, it divides by 255 and
    saturates 16-bit gray in imread: another function, ROADMAP.)"""
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
    RGB (H, W, 3). Compressed and planar TIFFs read on the numpy route
    (the native library refuses them; the JAX package reads them with
    Pillow and divides by 65535, within an ulp of this)."""
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
    (H, W, 3), as 8-bit gray or RGB in the format of the path's extension,
    as the JAX package's imwrite does through Pillow: ``.png``; ``.jpg``
    and ``.jpeg``, a baseline JPEG as Pillow's default save writes it
    (quality 75, 4:2:0); ``.tif`` and ``.tiff``, an uncompressed TIFF.
    Another extension raises ValueError. Floats are clipped and quantized
    as the JAX package's imwrite does: uint8(255 x + 0.5)."""
    ext = os.path.splitext(os.fspath(path))[1].lower()
    if ext not in _WRITERS:
        raise ValueError(f"imwrite writes {', '.join(_WRITERS)} files; {os.fspath(path)!r} has the extension "
                         f"{ext!r}")
    img = np.asarray(img)
    if img.dtype in (np.float32, np.float64):
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.dtype != np.uint8:
        raise TypeError(f"imwrite takes float or uint8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[-1] == 3)):
        raise ValueError(f"imwrite takes (H, W) or (H, W, 3) images, got {img.shape}")
    blob = _WRITERS[ext](img)
    with open(path, "wb") as f:
        f.write(blob)
