"""Writers for the image forms Pillow does not write (PNG of 2 and 4 bits,
Adam7 PNG; the TIFF forms are tests/test_torch_readers.py::write_tiff),
Pillow's decode of a file in the layout the port's decoders return, and
the committed files of tests/torch_reader_files/ with their MANIFEST.json.

    python tests/reader_files.py

writes those files again (it needs Pillow: the GPU host has none, so
chip_smoke.py reads the committed files and their digests).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES_DIR = os.path.join(ROOT, "tests", "torch_reader_files")
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """PNG rows (h, stride) of bytes -> each row filtered with the next of
    ``filters`` (0 none, 1 sub, 2 up, 3 average, 4 Paeth), its type first."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        kind = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])[: len(row)]
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])[: len(row)]
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            pa, pb, pc = np.abs(prev - upleft), np.abs(left - upleft), np.abs(left + prev - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out += bytes([kind]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """Samples (h, w, c) at ``depth`` bits -> rows of bytes (h, stride)."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per)))
    shifts = np.arange(8 - depth, -1, -depth)
    return (flat.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def write_png(path, samples, depth=8, color_type=None, palette=None, interlace=False, trns=None,
              filters=(0, 1, 2, 3, 4)):
    """A PNG of ``samples`` (H, W[, C]) at ``depth`` bits (palette indices
    for colour type 3), written with struct and zlib: PLTE from
    ``palette`` (n, 3), tRNS bytes ``trns``, Adam7 passes if
    ``interlace``, row filters cycling through ``filters``."""
    samples = np.asarray(samples)
    samples = samples[..., None] if samples.ndim == 2 else samples
    h, w, c = samples.shape
    if color_type is None:
        color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filter_rows(_pack(sub, depth), bpp, filters)
    else:
        raw = _filter_rows(_pack(samples, depth), bpp, filters)
    blob = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, int(interlace)))
    if palette is not None:
        blob += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        blob += _chunk(b"tRNS", bytes(trns))
    blob += _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(blob)
    return str(path)


def pillow_samples(path) -> np.ndarray:
    """Pillow's decode of ``path`` in the layout the port's decoders
    return: (H, W, C), C = 1 or 3 for JPEG, every channel for PNG
    (palette mapped to RGB, 1-bit gray to 0/255), the first 3 (or 1) for
    TIFF; 16-bit samples as uint16."""
    from PIL import Image

    with Image.open(path) as im:
        kind = im.format
        if im.mode == "P":
            arr = np.asarray(im.convert("RGB"))
        elif im.mode == "1":
            arr = np.asarray(im.convert("L"))
        elif im.mode.startswith("I"):
            arr = np.asarray(im).astype(np.uint16)
        else:
            arr = np.asarray(im)
    arr = arr[..., None] if arr.ndim == 2 else arr
    return arr[..., :3] if kind == "TIFF" and arr.shape[-1] > 3 else arr


def digest(samples: np.ndarray) -> str:
    """sha256 of samples (H, W, C) as little-endian bytes in C order."""
    arr = np.asarray(samples)
    return hashlib.sha256(np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder("<"))).tobytes()).hexdigest()


def city_crop(y: int, x: int, h: int, w: int) -> np.ndarray:
    from PIL import Image

    with Image.open(os.path.join(ROOT, "city_handheld_sr.png")) as im:
        return np.asarray(im.convert("RGB"))[y : y + h, x : x + w]


def _recipes():
    """File name -> (how it is written, a function writing it to a path)."""
    from PIL import Image
    from test_torch_readers import write_tiff

    from multi_frame_super_resolution_tpu_torch.data import jpeg

    rng = np.random.default_rng(22)
    rgb = city_crop(40, 96, 48, 64)
    gray = rgb.mean(-1).astype(np.uint8)
    ramp16 = (np.linspace(0, 1, 64)[None, :] * np.linspace(0.3, 1, 48)[:, None] * 65535).astype(np.uint16)
    noise16 = (ramp16 ^ rng.integers(0, 64, ramp16.shape).astype(np.uint16))

    def pil(arr, **kw):
        return lambda path: Image.fromarray(arr).save(path, **kw)

    def pil_p(arr, **kw):
        return lambda path: Image.fromarray(arr).quantize(16 if kw.get("bits", 8) >= 4 else 2).save(path, **kw)

    recipes = {}
    for i in range(4):  # the car burst: 130 x 228, 4:2:0, quality 90, shifted crops
        crop = city_crop(100 + 3 * i, 300 + 5 * i, 130, 228)
        recipes[f"car/{i + 1}.jpg"] = ("Pillow save(quality=90, subsampling=2)", pil(crop, quality=90, subsampling=2))
    recipes.update({
        "jpeg_444_q95.jpg": ("Pillow save(quality=95, subsampling=0)", pil(rgb, quality=95, subsampling=0)),
        "jpeg_422_q50.jpg": ("Pillow save(quality=50, subsampling=1)", pil(rgb, quality=50, subsampling=1)),
        "jpeg_440_q80.jpg": ("the port's data/jpeg.py encode(quality=80, sampling=(1, 2)) (Pillow writes no 4:4:0)",
                             lambda path: open(path, "wb").write(jpeg.encode(rgb, 80, (1, 2)))),
        "jpeg_gray.jpg": ("Pillow save() of an L image", pil(gray)),
        "jpeg_restart.jpg": ("Pillow save(restart_marker_blocks=3)", pil(rgb, restart_marker_blocks=3)),
        "jpeg_optimize.jpg": ("Pillow save(optimize=True)", pil(rgb, optimize=True)),
        "jpeg_progressive.jpg": ("Pillow save(progressive=True)", pil(rgb, progressive=True)),
        "jpeg_progressive_gray.jpg": ("Pillow save(progressive=True) of an L image", pil(gray, progressive=True)),
        "jpeg_adobe_rgb.jpg": ("Pillow save(keep_rgb=True): RGB stored, Adobe transform 0", pil(rgb, keep_rgb=True)),
        "png_palette8.png": ("Pillow quantize(16).save()", pil_p(rgb)),
        "png_palette4_trns.png": ("Pillow quantize(16).save(bits=4, transparency=3)", pil_p(rgb, bits=4, transparency=3)),
        "png_palette1.png": ("Pillow quantize(2).save(bits=1)", pil_p(rgb, bits=1)),
        "png_gray1.png": ("Pillow save() of a mode-1 image", lambda path: Image.fromarray(gray > 128).save(path)),
        "png_gray2.png": ("tests/reader_files.py write_png(depth=2)", lambda path: write_png(path, gray >> 6, 2)),
        "png_gray4.png": ("tests/reader_files.py write_png(depth=4)", lambda path: write_png(path, gray >> 4, 4)),
        "png_adam7_rgb.png": ("tests/reader_files.py write_png(interlace=True)",
                              lambda path: write_png(path, rgb, interlace=True)),
        "png_adam7_gray2.png": ("tests/reader_files.py write_png(depth=2, interlace=True)",
                                lambda path: write_png(path, gray[:13, :11] >> 6, 2, interlace=True)),
        "png_adam7_gray16.png": ("tests/reader_files.py write_png(depth=16, interlace=True)",
                                 lambda path: write_png(path, noise16, 16, interlace=True)),
        "png_adam7_palette4.png": ("tests/reader_files.py write_png(depth=4, colour type 3, interlace=True)",
                                   lambda path: write_png(path, gray >> 4, 4, 3, rng.integers(0, 256, (16, 3)),
                                                          interlace=True)),
        "tiff_lzw_rgb8.tif": ("Pillow save(compression='tiff_lzw')", pil(rgb, compression="tiff_lzw")),
        "tiff_lzw_pred_gray16.tif": ("Pillow save(compression='tiff_lzw', tiffinfo={317: 2}) of an I;16 image",
                                     pil(noise16, compression="tiff_lzw", tiffinfo={317: 2})),
        "tiff_deflate8_pred_rgb8.tif": ("Pillow save(compression='tiff_adobe_deflate', tiffinfo={317: 2})",
                                        pil(rgb, compression="tiff_adobe_deflate", tiffinfo={317: 2})),
        "tiff_deflate32946_gray8.tif": ("tests/test_torch_readers.py write_tiff(compression=32946, rows_per_strip=7)",
                                        lambda path: write_tiff(path, gray, rows_per_strip=7, compression=32946)),
        "tiff_deflate_pred_gray16_be.tif": (
            "tests/test_torch_readers.py write_tiff(order='>', compression=8, predictor=2)",
            lambda path: write_tiff(path, noise16, ">", compression=8, predictor=2)),
        "tiff_packbits_rgb8.tif": ("Pillow save(compression='packbits')", pil(rgb, compression="packbits")),
        "tiff_planar_rgb8.tif": ("tests/test_torch_readers.py write_tiff(planar=2, rows_per_strip=16)",
                                 lambda path: write_tiff(path, rgb, rows_per_strip=16, planar=2)),
        "tiff_planar_deflate_pred_rgb8.tif": (
            "tests/test_torch_readers.py write_tiff(planar=2, compression=8, predictor=2)",
            lambda path: write_tiff(path, rgb, planar=2, compression=8, predictor=2)),
    })
    return recipes


def write_all(directory: str = FILES_DIR) -> dict:
    """Write every committed file and MANIFEST.json; returns the manifest."""
    import PIL

    manifest = {}
    for name, (how, write) in _recipes().items():
        path = os.path.join(directory, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write(path)
        samples = pillow_samples(path)
        manifest[name] = {"written_by": how, "shape": list(samples.shape), "dtype": str(samples.dtype),
                          "sha256": digest(samples)}
    with open(os.path.join(directory, "MANIFEST.json"), "w") as f:
        json.dump({"pillow": PIL.__version__, "samples": "(H, W, C) little-endian, C order; sha256 of the bytes",
                   "files": manifest}, f, indent=1)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    write_all()
    print(f"wrote {FILES_DIR}")
