"""The port's numpy decoders and encoders (data/jpeg.py, data/png.py,
data/tiff.py) and imwrite by extension, against Pillow and the JAX
package on the CPU.

Samples: each form decodes to Pillow's samples bit for bit (libjpeg-turbo
and libtiff behind Pillow; libpng behind the JAX package's native
library). The public readers: equal to the JAX package's wherever its
native library reads the file (JPEG, PNG); where it reads through Pillow
(compressed and planar TIFF) the port keeps the native formula, within an
ulp of Pillow's division, and 16-bit gray where Pillow's RGB conversion
saturates (ROADMAP, differences of rounding or fidelity). The writer: a
.jpg from the port has the bytes of the JAX package's imwrite (Pillow's
defaults).
"""

import io
import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image
from reader_files import FILES_DIR, city_crop, digest, pillow_samples, write_png
from test_torch_readers import route, write_tiff  # noqa: F401 (route is a fixture)

from multi_frame_super_resolution_tpu.data import imread as jax_imread
from multi_frame_super_resolution_tpu.data import imread_gray as jax_imread_gray
from multi_frame_super_resolution_tpu.data import imread_u16 as jax_imread_u16
from multi_frame_super_resolution_tpu.data import imwrite as jax_imwrite
from multi_frame_super_resolution_tpu.data import native as jax_native
from multi_frame_super_resolution_tpu_torch import data
from multi_frame_super_resolution_tpu_torch.data import jpeg, native, png, tiff

CITY = city_crop(0, 0, 256, 512)
SHAPES = [(1, 1), (7, 13), (17, 33), (130, 228)]
G16 = (np.random.default_rng(9).random((41, 57)) * 65535).astype(np.uint16)
RGB16 = (np.random.default_rng(10).random((9, 11, 3)) * 65535).astype(np.uint16)


def _image(shape, gray=False, seed=0):
    """A crop of the city scene at ``shape`` with a little noise."""
    rng = np.random.default_rng(seed)
    h, w = shape
    y, x = rng.integers(0, 256 - h + 1), rng.integers(0, 512 - w + 1)
    img = np.clip(CITY[y : y + h, x : x + w].astype(np.int64) + rng.integers(-20, 21, (h, w, 3)), 0, 255)
    img = img.astype(np.uint8)
    return img.mean(-1).astype(np.uint8) if gray else img


def _decode(path):
    blob = open(path, "rb").read()
    if blob[:8] == png.SIGNATURE:
        return png.decode(blob, str(path))[0]
    if blob[:2] in (b"II", b"MM"):
        return tiff.decode(blob, str(path))[0]
    return jpeg.decode(blob, str(path))


def _scaled(samples):
    return samples.astype(np.float32) * np.float32(1.0 / (65535.0 if samples.dtype.itemsize == 2 else 255.0))


def _rgb(samples):
    x = _scaled(samples)
    return np.repeat(x[..., :1], 3, -1) if x.shape[-1] < 3 else x[..., :3]


def _luma(samples):
    r, g, b = np.moveaxis(_rgb(samples), -1, 0)
    return np.float32(0.299) * r + np.float32(0.587) * g + np.float32(0.114) * b


# --- JPEG ----------------------------------------------------------------

# form -> (gray, Pillow save arguments); "sampling" forms are written by
# the port's encoder (Pillow writes no 4:4:0)
JPEG_FORMS = {
    "q50_420": (False, dict(quality=50, subsampling=2)),
    "q75_420": (False, dict()),
    "q95_420": (False, dict(quality=95, subsampling=2)),
    "q50_444": (False, dict(quality=50, subsampling=0)),
    "q95_444": (False, dict(quality=95, subsampling=0)),
    "q75_422": (False, dict(subsampling=1)),
    "q95_422": (False, dict(quality=95, subsampling=1)),
    "q80_440": (False, dict(sampling=(1, 2), quality=80)),
    "gray": (True, dict()),
    "gray_factors_2x2": (True, dict(subsampling=2)),  # one component with factors 2 x 2: one block an MCU
    "restart": (False, dict(restart_marker_blocks=2)),
    "restart_444_q95": (False, dict(restart_marker_blocks=1, subsampling=0, quality=95)),
    "optimize": (False, dict(optimize=True)),
    "progressive": (False, dict(progressive=True)),
    "progressive_444_q95": (False, dict(progressive=True, subsampling=0, quality=95)),
    "progressive_gray": (True, dict(progressive=True)),
    "progressive_restart": (False, dict(progressive=True, restart_marker_blocks=3)),
    "adobe_rgb": (False, dict(keep_rgb=True)),
}


def _jpeg_bytes(img, kw):
    if "sampling" in kw:
        return jpeg.encode(img, kw["quality"], kw["sampling"])
    out = io.BytesIO()
    Image.fromarray(img).save(out, "JPEG", **kw)
    return out.getvalue()


def _pillow_decode(blob):
    arr = np.asarray(Image.open(io.BytesIO(blob)))
    return arr[..., None] if arr.ndim == 2 else arr


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("form", list(JPEG_FORMS))
def test_jpeg_samples_match_pillow(form, shape):
    """Baseline and progressive JPEG in every sampling, quality, table and
    restart form: the port's samples equal Pillow's (libjpeg-turbo's
    ISLOW IDCT, fancy upsampling and colour tables) bit for bit."""
    gray, kw = JPEG_FORMS[form]
    blob = _jpeg_bytes(_image(shape, gray, seed=len(form)), kw)
    got = jpeg.decode(blob)
    assert got.dtype == np.uint8 and got.shape == shape + (1 if gray else 3,)
    np.testing.assert_array_equal(got, _pillow_decode(blob))


@settings(max_examples=25, deadline=5000, derandomize=True)
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2**16), quality=st.integers(1, 100),
       subsampling=st.sampled_from([0, 1, 2]), progressive=st.booleans(), gray=st.booleans())
def test_jpeg_samples_match_pillow_hypothesis(h, w, seed, quality, subsampling, progressive, gray):
    """Random shapes, seeds and settings, noise and scene mixed."""
    rng = np.random.default_rng(seed)
    img = _image((h, w), gray, seed)
    if seed % 2:
        img = rng.integers(0, 256, img.shape).astype(np.uint8)
    blob = _jpeg_bytes(img, dict(quality=quality, subsampling=subsampling, progressive=progressive))
    np.testing.assert_array_equal(jpeg.decode(blob), _pillow_decode(blob))


# --- PNG -----------------------------------------------------------------

def _png_forms():
    """form -> (a writer of a path, whether Pillow decodes its samples
    exactly; else they are held against the samples written)."""
    rng = np.random.default_rng(5)
    img, gray = _image((17, 33)), _image((17, 33), gray=True)
    g16 = (rng.random((17, 33)) * 65535).astype(np.uint16)

    def pal(bits, **kw):
        colors = min(1 << bits, 16)
        return lambda p: Image.fromarray(img).quantize(colors).save(p, bits=bits, **kw)

    forms = {
        "palette8": pal(8),
        "palette4": pal(4),
        "palette2": pal(2),
        "palette1": pal(1),
        "palette4_trns": pal(4, transparency=2),
        "gray1": lambda p: Image.fromarray(gray > 100).save(p),
        "gray_trns": lambda p: Image.fromarray(gray).save(p, transparency=7),
        "gray2": lambda p: write_png(p, gray >> 6, 2),
        "gray4": lambda p: write_png(p, gray >> 4, 4),
        "palette2_struct": lambda p: write_png(p, gray >> 6, 2, 3, rng.integers(0, 256, (4, 3))),
    }
    for (h, w) in ((1, 1), (7, 13), (17, 33)):
        tag = f"{h}x{w}"
        forms.update({
            f"adam7_gray1_{tag}": lambda p, h=h, w=w: write_png(p, gray[:h, :w] >> 7, 1, interlace=True),
            f"adam7_gray2_{tag}": lambda p, h=h, w=w: write_png(p, gray[:h, :w] >> 6, 2, interlace=True),
            f"adam7_gray4_{tag}": lambda p, h=h, w=w: write_png(p, gray[:h, :w] >> 4, 4, interlace=True),
            f"adam7_gray8_{tag}": lambda p, h=h, w=w: write_png(p, gray[:h, :w], 8, interlace=True),
            f"adam7_gray16_{tag}": lambda p, h=h, w=w: write_png(p, g16[:h, :w], 16, interlace=True),
            f"adam7_rgb8_{tag}": lambda p, h=h, w=w: write_png(p, img[:h, :w], 8, interlace=True),
            f"adam7_graya8_{tag}": lambda p, h=h, w=w: write_png(p, np.stack([gray, 255 - gray], -1)[:h, :w],
                                                                8, interlace=True),
            f"adam7_rgba8_{tag}": lambda p, h=h, w=w: write_png(
                p, np.concatenate([img, gray[..., None]], -1)[:h, :w], 8, interlace=True),
            f"adam7_palette4_{tag}": lambda p, h=h, w=w: write_png(p, gray[:h, :w] >> 4, 4, 3,
                                                                  rng.integers(0, 256, (16, 3)), interlace=True),
            f"adam7_palette8_trns_{tag}": lambda p, h=h, w=w: write_png(
                p, gray[:h, :w], 8, 3, rng.integers(0, 256, (256, 3)), interlace=True, trns=[0, 128, 255]),
        })
    # 16-bit colour, which Pillow reduces to 8 bits: held against the samples
    forms["adam7_rgb16"] = lambda p: write_png(p, RGB16, 16, interlace=True)
    forms["adam7_graya16"] = lambda p: write_png(p, RGB16[..., :2], 16, interlace=True)
    return forms


PNG_FORMS = _png_forms()


@pytest.mark.parametrize("form", list(PNG_FORMS))
def test_png_samples_match_pillow(tmp_path, form):
    """Palette PNG (1, 2, 4 and 8 bits, with tRNS), gray of 1, 2 and 4 bits,
    and Adam7 in every colour type and depth, with every row filter: the
    port's samples equal Pillow's (16-bit colour: the samples written,
    and the native library's values where it is built)."""
    path = tmp_path / "x.png"
    PNG_FORMS[form](path)
    got = _decode(path)
    if form in ("adam7_rgb16", "adam7_graya16"):
        np.testing.assert_array_equal(got, RGB16[..., : got.shape[-1]])
        if jax_native.available():
            np.testing.assert_array_equal(_rgb(got), jax_native.imread_native(str(path)))
    else:
        np.testing.assert_array_equal(got, pillow_samples(path))


# --- TIFF ----------------------------------------------------------------

def _tiff_forms():
    img, gray, g16 = _image((130, 228)), _image((130, 228), gray=True), G16
    rgba = np.concatenate([img, gray[..., None]], -1)

    def pil(arr, **kw):
        return lambda p: Image.fromarray(arr).save(p, **kw)

    return {
        "lzw_rgb8": pil(img, compression="tiff_lzw"),
        "lzw_gray8": pil(gray, compression="tiff_lzw"),
        "lzw_gray16": pil(g16, compression="tiff_lzw"),
        "lzw_pred_rgb8": pil(img, compression="tiff_lzw", tiffinfo={317: 2}),
        "lzw_pred_gray16": pil(g16, compression="tiff_lzw", tiffinfo={317: 2}),
        "lzw_rgba8": pil(rgba, compression="tiff_lzw"),
        "deflate8_rgb8": pil(img, compression="tiff_adobe_deflate"),
        "deflate8_pred_rgb8": pil(img, compression="tiff_adobe_deflate", tiffinfo={317: 2}),
        "deflate32946_pred_gray16": pil(g16, compression="tiff_deflate", tiffinfo={317: 2}),
        "packbits_rgb8": pil(img, compression="packbits"),
        "packbits_gray16": pil(g16, compression="packbits"),
        "struct_32946_strips_gray8": lambda p: write_tiff(p, gray, rows_per_strip=9, compression=32946),
        "struct_deflate_pred_gray16_be": lambda p: write_tiff(p, g16, ">", 5, compression=8, predictor=2),
        "struct_packbits_rgb8_be": lambda p: write_tiff(p, img, ">", 11, compression=32773),
        "struct_packbits_pred_ignored": lambda p: write_tiff(p, img, compression=32773, predictor=2),
        "struct_planar_rgb8": lambda p: write_tiff(p, img, rows_per_strip=16, planar=2),
        "struct_planar_deflate_pred_rgb8": lambda p: write_tiff(p, img, planar=2, compression=8, predictor=2),
        "struct_planar_packbits_rgb8": lambda p: write_tiff(p, img, rows_per_strip=40, planar=2, compression=32773),
        "struct_planar_rgb16_be": lambda p: write_tiff(p, g16[..., None].repeat(3, -1) ^ 0x0F0F, ">", planar=2),
    }


TIFF_FORMS = _tiff_forms()


@pytest.mark.parametrize("form", list(TIFF_FORMS))
def test_tiff_samples_match_pillow(tmp_path, form):
    """LZW, Deflate (8 and 32946) and PackBits strips, Predictor 2 at 8 and
    16 bits in both byte orders, planar files: the port's samples equal
    Pillow's (libtiff's); 16-bit RGB, which Pillow reduces to 8 bits,
    against the samples written."""
    path = tmp_path / "x.tif"
    TIFF_FORMS[form](path)
    got = _decode(path)
    if form == "struct_planar_rgb16_be":
        np.testing.assert_array_equal(got, G16[..., None].repeat(3, -1) ^ 0x0F0F)
        return
    np.testing.assert_array_equal(got, pillow_samples(path))
    if form == "struct_packbits_pred_ignored":  # libtiff applies no predictor to PackBits strips
        np.testing.assert_array_equal(got, np.diff(_image((130, 228)), axis=1, prepend=np.uint8(0)))


# --- the public readers against the JAX package ---------------------------

PUBLIC_FILES = {
    "jpeg_420": lambda p: Image.fromarray(_image((17, 33))).save(p, "JPEG"),
    "jpeg_progressive_gray": lambda p: Image.fromarray(_image((17, 33), True)).save(p, "JPEG", progressive=True),
    "jpeg_444_restart": lambda p: Image.fromarray(_image((17, 33))).save(p, "JPEG", subsampling=0,
                                                                         restart_marker_blocks=1),
    "png_palette4": PNG_FORMS["palette4_trns"],
    "png_gray2": PNG_FORMS["gray2"],
    "png_adam7_gray16": PNG_FORMS["adam7_gray16_17x33"],
    "png_adam7_rgba8": PNG_FORMS["adam7_rgba8_7x13"],
    "png_adam7_palette8_trns": PNG_FORMS["adam7_palette8_trns_17x33"],
}


@pytest.mark.parametrize("name", list(PUBLIC_FILES))
def test_public_readers_match_jax(tmp_path, route, name):
    """imread, imread_gray and imread_u16 on JPEG and PNG forms, on both
    routes: equal to the native formula, and to the JAX package's where
    its native library reads them (built here: exact)."""
    path = tmp_path / ("x.jpg" if name.startswith("jpeg") else "x.png")
    PUBLIC_FILES[name](path)
    samples = pillow_samples(path) if name != "png_adam7_gray16" else _decode(path)
    got = data.imread(path), data.imread_gray(path), data.imread_u16(path)
    want_u16 = _luma(samples) if samples.shape[-1] in (1, 2) else _rgb(samples)
    for a, b in zip(got, (_rgb(samples), _luma(samples), want_u16)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    if jax_native.available():
        for a, b in zip(got, (jax_imread(path), jax_imread_gray(path), jax_imread_u16(path))):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["lzw_rgb8", "lzw_gray16", "lzw_pred_gray16", "deflate8_pred_rgb8",
                                  "packbits_gray16", "struct_planar_rgb8"])
def test_public_readers_on_libtiff_forms_against_jax_pillow_route(tmp_path, route, name):
    """Compressed and planar TIFFs, which the JAX package reads through
    Pillow: the port returns the native formula (samples times
    float32(1/255) or float32(1/65535); luma in float32). JAX's
    imread_u16 divides instead: within an ulp. JAX's imread converts to
    8-bit RGB: within an ulp on 8-bit files, and 16-bit gray saturates at
    255 (ROADMAP, differences of rounding or fidelity)."""
    path = tmp_path / "x.tif"
    TIFF_FORMS[name](path)
    samples = _decode(path)
    np.testing.assert_array_equal(samples, pillow_samples(path))
    got, gray, u16 = data.imread(path), data.imread_gray(path), data.imread_u16(path)
    np.testing.assert_array_equal(got, _rgb(samples))
    np.testing.assert_array_equal(gray, _luma(samples))
    np.testing.assert_array_equal(u16, _luma(samples) if samples.shape[-1] == 1 else _rgb(samples))
    # JAX's imread_u16 divides the samples: within an ulp of the native scale
    scaled = _scaled(samples)
    np.testing.assert_array_max_ulp(scaled[..., 0] if samples.shape[-1] == 1 else scaled, jax_imread_u16(path),
                                    maxulp=1)
    if samples.dtype == np.uint16:  # Pillow's I;16 -> RGB saturates at 255
        sat = np.minimum(samples, 255).astype(np.float32) / np.float32(255.0)
        np.testing.assert_array_equal(jax_imread(path), np.repeat(sat, 3, -1))
        assert jax_imread(path).max() == 1.0 and got.max() < 1.0
    else:
        np.testing.assert_array_max_ulp(got, jax_imread(path), maxulp=1)


@pytest.mark.parametrize("planar", [1, 2])
def test_rgb16_tiff_against_jax_pillow_route(tmp_path, route, planar):
    """16-bit RGB in a compressed or planar TIFF: the port keeps the 16-bit
    samples (times float32(1/65535)), where JAX's Pillow route reduces
    them to their high byte over 255 (ROADMAP, differences of fidelity)."""
    path = tmp_path / "x.tif"
    write_tiff(path, RGB16, planar=planar, compression=8, predictor=2)
    np.testing.assert_array_equal(data.imread_u16(path), _rgb(RGB16))
    np.testing.assert_array_equal(data.imread(path), _rgb(RGB16))
    high = (RGB16 >> 8).astype(np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(jax_imread_u16(path), high)
    np.testing.assert_array_max_ulp(jax_imread(path), high, maxulp=1)


# --- refusals ------------------------------------------------------------

def _patched_jpeg(path, marker=None, at_sof=None, **kw):
    """A Pillow JPEG with its SOF marker replaced (``marker``) or the SOF
    segment's byte ``at_sof[0]`` set to ``at_sof[1]``."""
    out = io.BytesIO()
    Image.fromarray(_image((17, 33))).save(out, "JPEG", **kw)
    blob = bytearray(out.getvalue())
    sof = next(i for i in range(len(blob) - 1) if blob[i] == 0xFF and blob[i + 1] in (0xC0, 0xC2))
    if marker is not None:
        blob[sof + 1] = marker
    if at_sof is not None:
        blob[sof + 4 + at_sof[0]] = at_sof[1]
    path.write_bytes(bytes(blob))


def _truncated_jpeg(path):
    out = io.BytesIO()
    Image.fromarray(_image((130, 228))).save(out, "JPEG")
    blob = out.getvalue()
    path.write_bytes(blob[: len(blob) // 2] + b"\xff\xd9")


def _incomplete_progressive(path):
    """A progressive JPEG cut after its first scans (DC and the first AC
    band at reduced precision), then EOI: libjpeg would block-smooth it."""
    out = io.BytesIO()
    Image.fromarray(_image((64, 64))).save(out, "JPEG", progressive=True)
    blob = out.getvalue()
    sos = [i for i in range(len(blob) - 1) if blob[i] == 0xFF and blob[i + 1] == 0xDA]
    path.write_bytes(blob[: sos[3]] + b"\xff\xd9")


REFUSALS = {
    "jpeg_sof3_lossless": (lambda p: _patched_jpeg(p, 0xC3), "SOF3 \\(lossless\\)"),
    "jpeg_sof5_hierarchical": (lambda p: _patched_jpeg(p, 0xC5), "SOF5 \\(hierarchical\\)"),
    "jpeg_sof9_arithmetic": (lambda p: _patched_jpeg(p, 0xC9), "SOF9 \\(arithmetic\\)"),
    "jpeg_sof10_arithmetic": (lambda p: _patched_jpeg(p, 0xCA, progressive=True), "SOF10 \\(arithmetic\\)"),
    "jpeg_12_bit": (lambda p: _patched_jpeg(p, at_sof=(0, 12)), "12-bit precision"),
    "jpeg_cmyk": (lambda p: Image.fromarray(_image((17, 33))).convert("CMYK").save(p, "JPEG"),
                  "4 components \\(CMYK/YCCK\\)"),
    "jpeg_sampling_3": (lambda p: _patched_jpeg(p, at_sof=(7, 0x32)), "sampling factors 3 x 2"),
    "jpeg_truncated_scan": (_truncated_jpeg, "truncated JPEG scan"),
    "jpeg_incomplete_progressive": (_incomplete_progressive, "block-smooths"),
    "png_palette_index": (lambda p: write_png(p, np.arange(12).reshape(3, 4) % 16, 4, 3, [[1, 2, 3]] * 5),
                          "palette index 11 past its PLTE of 5"),
    "png_rgb_4_bit": (lambda p: write_png(p, np.zeros((2, 2, 3), int), 4, 2), "RGB PNG of bit depth 4"),
    "png_no_plte": (lambda p: write_png(p, np.zeros((2, 2), int), 8, 3), "palette PNG without a PLTE"),
    "tiff_tiles": (lambda p: write_tiff(p, _image((9, 11)), extra=[(322, 16)]), "tiled TIFF \\(TIFF TileWidth"),
    "tiff_jpeg": (lambda p: write_tiff(p, _image((9, 11)), compression=7), "JPEG-in-TIFF"),
    "tiff_ccitt": (lambda p: write_tiff(p, _image((9, 11), True), compression=2), "Compression \\(tag 259\\) 2"),
    "tiff_old_lzw": (lambda p: write_tiff(p, _image((9, 11)), compression=5, strip=lambda raw: b"\x00\x01" + raw),
                     "old-style"),
    "tiff_predictor_3": (lambda p: write_tiff(p, _image((9, 11)), compression=8, predictor=3),
                         "Predictor \\(tag 317\\) 3"),
    "tiff_white_is_zero": (lambda p: write_tiff(p, _image((9, 11), True), compression=8, extra=[(262, 0)]),
                           "PhotometricInterpretation \\(tag 262\\) 0"),
    "tiff_palette": (lambda p: write_tiff(p, _image((9, 11), True), compression=8, extra=[(262, 3)]),
                     "PhotometricInterpretation \\(tag 262\\) 3"),
    "tiff_ycbcr": (lambda p: write_tiff(p, _image((9, 11)), compression=32773, extra=[(262, 6)]),
                   "PhotometricInterpretation \\(tag 262\\) 6"),
    "tiff_signed": (lambda p: write_tiff(p, _image((9, 11), True), compression=8, extra=[(339, 2)]),
                    "SampleFormat \\(tag 339\\) 2"),
    "tiff_fill_order": (lambda p: write_tiff(p, _image((9, 11), True), compression=8, extra=[(266, 2)]),
                        "FillOrder \\(tag 266\\) 2"),
    "tiff_truncated_deflate": (lambda p: write_tiff(p, _image((9, 11)), compression=8, strip=lambda raw: raw[:20]),
                               "Deflate strip 0 decodes to"),
    "bmp": (lambda p: Image.fromarray(_image((9, 11))).save(p, "BMP"), "neither a PNG, a TIFF nor a JPEG"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_name_what_they_refuse(tmp_path, monkeypatch, case):
    """On the numpy route each form the decoders do not read raises
    ValueError naming its marker, tag or value; none falls back to
    another decoder."""
    monkeypatch.setattr(native, "_library", lambda: (None, "switched off by the test"))
    write, match = REFUSALS[case]
    path = tmp_path / "x.img"
    write(path)
    for reader in (data.imread, data.imread_gray, data.imread_u16):
        with pytest.raises(ValueError, match=match):
            reader(path)


# --- the writer -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (17, 33), (130, 228), (33, 47, 1)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ["rgb", "gray"])
def test_imwrite_jpeg_matches_jax_imwrite(tmp_path, kind, shape):
    """imwrite to .jpg and .jpeg of a float image: the bytes of the JAX
    package's imwrite (Pillow's defaults: quality 75, 4:2:0, JFIF), so
    Pillow decodes both to the same array."""
    rng = np.random.default_rng(sum(shape))
    img = _image(shape[:2], kind == "gray", seed=3).astype(np.float32) / 255.0
    img = np.clip(img + rng.normal(0, 0.02, img.shape).astype(np.float32), 0, 1)
    if len(shape) == 3 and kind == "gray":
        img = img[..., None]
    for ext in (".jpg", ".jpeg"):
        data.imwrite(tmp_path / f"port{ext}", img)
        jax_imwrite(tmp_path / f"jax{ext}", img)
        got, want = (tmp_path / f"port{ext}").read_bytes(), (tmp_path / f"jax{ext}").read_bytes()
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"port{ext}")),
                                      np.asarray(Image.open(tmp_path / f"jax{ext}")))
        assert got == want  # the bytes are equal too
    np.testing.assert_array_equal(data.imread(tmp_path / "port.jpg"), jax_imread(tmp_path / "jax.jpg"))


@pytest.mark.parametrize("ext", [".tif", ".tiff"])
@pytest.mark.parametrize("kind", ["rgb", "gray"])
def test_imwrite_tiff_matches_jax_imwrite(tmp_path, kind, ext):
    """imwrite to .tif and .tiff: an uncompressed TIFF of the same uint8
    samples as the JAX package's (Pillow's), read back equal by Pillow,
    the port and the JAX package."""
    img = _image((17, 33), kind == "gray", seed=4)
    data.imwrite(tmp_path / f"port{ext}", img)
    jax_imwrite(tmp_path / f"jax{ext}", img)
    port, jax = tmp_path / f"port{ext}", tmp_path / f"jax{ext}"
    np.testing.assert_array_equal(np.asarray(Image.open(port)), np.asarray(Image.open(jax)))
    np.testing.assert_array_equal(np.asarray(Image.open(port)), img)
    np.testing.assert_array_equal(data.imread(port), jax_imread(jax))
    np.testing.assert_array_equal(jax_imread(port), jax_imread(jax))
    assert tiff.decode(port.read_bytes())[0].reshape(img.shape).tobytes() == img.tobytes()


@pytest.mark.parametrize("shape", [(7, 13), (7, 13, 3)])
def test_imwrite_png_is_unchanged(tmp_path, shape):
    """imwrite to .png writes the bytes it wrote before: filter 0 on every
    row, zlib level 6, IHDR, IDAT and IEND only."""
    img = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    data.imwrite(tmp_path / "x.png", img)
    raw = np.concatenate([np.zeros((7, 1), np.uint8), img.reshape(7, -1)], 1).tobytes()
    header = struct.pack(">IIBBBBB", 13, 7, 8, 0 if len(shape) == 2 else 2, 0, 0, 0)
    want = b"\x89PNG\r\n\x1a\n" + png.chunk(b"IHDR", header) + png.chunk(b"IDAT", zlib.compress(raw, 6))
    assert (tmp_path / "x.png").read_bytes() == want + png.chunk(b"IEND", b"")
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "x.png")), img)


@pytest.mark.parametrize("name", ["x.bmp", "x.gif", "x.webp", "x", "x.PNG.txt"])
def test_imwrite_other_extension_raises(tmp_path, name):
    """Any other extension raises ValueError naming it and the ones imwrite
    writes; nothing is written (no PNG under another name)."""
    ext = os.path.splitext(name)[1]
    with pytest.raises(ValueError, match=f"extension '{ext}'.*" if ext else "extension ''"):
        data.imwrite(tmp_path / name, np.zeros((4, 4, 3), np.float32))
    assert not (tmp_path / name).exists()


def test_imwrite_extension_is_case_blind(tmp_path):
    img = _image((9, 11))
    data.imwrite(tmp_path / "x.JPG", img)
    jax_imwrite(tmp_path / "y.jpg", img)
    assert (tmp_path / "x.JPG").read_bytes() == (tmp_path / "y.jpg").read_bytes()


# --- the committed files ----------------------------------------------------

MANIFEST = json.load(open(os.path.join(FILES_DIR, "MANIFEST.json")))


@pytest.mark.parametrize("name", list(MANIFEST["files"]))
def test_committed_files_match_manifest(name):
    """Every file in tests/torch_reader_files/: Pillow's decode matches
    MANIFEST.json (shape, dtype, sha256), and so does the port's."""
    entry = MANIFEST["files"][name]
    path = os.path.join(FILES_DIR, name)
    want = pillow_samples(path)
    assert [list(want.shape), str(want.dtype), digest(want)] == [entry["shape"], entry["dtype"], entry["sha256"]]
    got = _decode(path)
    assert list(got.shape) == entry["shape"] and digest(got) == entry["sha256"]


def test_committed_files_are_small():
    total = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(FILES_DIR) for f in fs)
    assert total < 300 * 1024
    assert {n for n in MANIFEST["files"] if n.startswith("car/")} == {f"car/{i}.jpg" for i in range(1, 5)}


def test_car_burst_loads_on_the_numpy_route(tmp_path, monkeypatch):
    """The committed car burst at burst_paths("car"): load_burst on the
    numpy route equals Pillow's samples scaled, and the JAX load_burst."""
    from multi_frame_super_resolution_tpu.data import load_burst as jax_load_burst

    for i, path in enumerate(data.burst_paths("car", str(tmp_path))):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(os.path.join(FILES_DIR, f"car/{i + 1}.jpg"), "rb") as src, open(path, "wb") as dst:
            dst.write(src.read())
    want = np.stack([pillow_samples(p) for p in data.burst_paths("car", str(tmp_path))]) * np.float32(1 / 255)
    jax = jax_load_burst("car", str(tmp_path))
    monkeypatch.setattr(native, "_library", lambda: (None, "switched off by the test"))
    got = data.load_burst("car", str(tmp_path))
    assert got.shape == (4, 130, 228, 3)
    np.testing.assert_array_equal(got, want)
    if jax_native.available():
        np.testing.assert_array_equal(got, jax)


def test_port_decoders_import_no_pillow():
    """In a fresh interpreter the port's readers decode a committed JPEG,
    PNG and TIFF without importing PIL."""
    code = (
        "import sys\n"
        "from multi_frame_super_resolution_tpu_torch.data import native, imread\n"
        "native._library = lambda: (None, 'off')\n"
        f"for f in ('car/1.jpg', 'png_adam7_rgb.png', 'tiff_lzw_rgb8.tif'):\n"
        f"    assert imread({FILES_DIR!r} + '/' + f).ndim == 3\n"
        "assert 'PIL' not in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
