"""The port's image readers (data/io.py's imread, imread_gray and
imread_u16, data/native.py, data/datasets.py::load_burst) and the defog
app's TIFF inputs against the JAX package on the CPU.

Every reader runs on both of its routes: through the native library
(native/mfsr_native.cpp, which the port builds into build/native/) and
through numpy (the library switched off). On both it returns the native
library's values, so the comparisons are exact: against the JAX package
where its own copy of the library is built, and against the formula
(samples times float32(1/255) or float32(1/65535), BT.601 luma in
float32) always.
"""

import os
import struct
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from torch_parity import to_jax

from multi_frame_super_resolution_tpu.apps import polar_defog as jax_app
from multi_frame_super_resolution_tpu.data import imread as jax_imread
from multi_frame_super_resolution_tpu.data import imread_u16 as jax_imread_u16
from multi_frame_super_resolution_tpu.data import native as jax_native
from multi_frame_super_resolution_tpu.models import defog as jdefog
from multi_frame_super_resolution_tpu_torch import data
from multi_frame_super_resolution_tpu_torch.apps import polar_defog as app
from multi_frame_super_resolution_tpu_torch.config import PolarDefogConfig
from multi_frame_super_resolution_tpu_torch.data import native

DEFOG_TOL = dict(rtol=1e-5, atol=1e-6)  # test_torch_defog.py's: the JAX spec's tolerance

_RAMP = np.linspace(0.0, 1.0, 37)[None, :] * np.linspace(0.2, 1.0, 29)[:, None]
# file name -> samples that Pillow writes to it
FILES = {
    "gray16.tiff": (_RAMP * 65535).astype(np.uint16),
    "rgb8.tif": (np.stack([_RAMP, _RAMP**2, 1 - _RAMP], -1) * 255).astype(np.uint8),
    "gray16_be.tiff": (_RAMP[::-1] * 65535).astype(np.uint16),  # written big-endian (MM)
    "gray8.tiff": (_RAMP * 255).astype(np.uint8),
    "rgba8.tiff": (np.stack([_RAMP, _RAMP**2, 1 - _RAMP, _RAMP], -1) * 255).astype(np.uint8),
    "gray16.png": (_RAMP * 65535).astype(np.uint16),
    "rgb8.png": (np.stack([_RAMP, 1 - _RAMP, _RAMP**3], -1) * 255).astype(np.uint8),
    "graya8.png": (np.stack([_RAMP, 1 - _RAMP], -1) * 255).astype(np.uint8),
}


def _write(path, arr):
    if path.name.endswith("_be.tiff"):
        h, w = arr.shape
        Image.frombytes("I;16B", (w, h), arr.astype(">u2").tobytes()).save(path)
    else:
        Image.fromarray(arr).save(path)


def packbits(data: bytes) -> bytes:
    """PackBits (TIFF Compression 32773): runs of 3 to 128 equal bytes as
    repeat packets, the rest as literal packets of up to 128 bytes."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def write_tiff(path, arr, order="<", rows_per_strip=None, planar=1, compression=1, predictor=1, strip=None,
               extra=()):
    """A TIFF of ``arr`` (H, W[, C]), uint8 or uint16, written with struct
    in byte order ``order``: one IFD, strips of ``rows_per_strip`` rows
    (all rows by default), chunky (``planar`` 1) or each plane's strips in
    turn (2; 3 writes chunky data under that tag), horizontal differencing
    per sample with ``predictor`` 2, each strip deflated (``compression``
    8 or 32946) or PackBits-coded (32773). Another compression value is
    written under its tag with the strips raw, or as ``strip(raw)`` makes
    them (``strip`` applies after any compression). ``extra`` holds more
    (tag, value) entries, SHORT, that replace or join the written ones."""
    arr = np.asarray(arr)
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    bits = 8 * arr.dtype.itemsize
    rps = rows_per_strip or h
    kind = np.dtype(f"{order}u{arr.dtype.itemsize}")
    planes = [arr.reshape(h, w, c)] if planar != 2 else [arr.reshape(h, w, c)[..., i : i + 1] for i in range(c)]
    strips = []
    for plane in planes:
        for y in range(0, h, rps):
            rows = plane[y : y + rps].astype(np.int64)
            if predictor == 2:  # each sample minus the one to its left, mod 2^bits
                rows = np.concatenate([rows[:, :1], np.diff(rows, axis=1)], 1) % (1 << bits)
            raw = rows.astype(kind).tobytes()
            if compression in (8, 32946):
                raw = zlib.compress(raw)
            elif compression == 32773:
                raw = packbits(raw)
            if strip is not None:
                raw = strip(raw)
            strips.append(raw)
    offsets, at = [], 8
    for raw in strips:
        offsets.append(at)
        at += len(raw)
    counts = [len(raw) for raw in strips]
    arrays_at = at  # StripOffsets, then StripByteCounts
    ifd_at = arrays_at + 8 * len(strips)
    entries = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, bits), (259, 3, 1, compression),
               (262, 3, 1, 1 if c == 1 else 2), (273, 4, len(strips), offsets), (277, 3, 1, c),
               (278, 4, 1, rps), (279, 4, len(strips), counts), (284, 3, 1, planar)]
    if predictor != 1:
        entries.append((317, 3, 1, predictor))
    for tag, value in extra:
        entries = [e for e in entries if e[0] != tag] + [(tag, 3, 1, value)]
    entries.sort()
    ifd = struct.pack(order + "H", len(entries))
    for tag, kind_, count, value in entries:
        if count == 1:
            value = value[0] if isinstance(value, list) else value
            field = struct.pack(order + ("HH" if kind_ == 3 else "I"), *((value, 0) if kind_ == 3 else (value,)))
        else:
            field = struct.pack(order + "I", arrays_at if tag == 273 else arrays_at + 4 * len(strips))
        ifd += struct.pack(order + "HHI", tag, kind_, count) + field
    with open(path, "wb") as f:
        f.write((b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42, ifd_at))
        f.write(b"".join(strips) + struct.pack(f"{order}{len(strips)}I", *offsets)
                + struct.pack(f"{order}{len(strips)}I", *counts))
        f.write(ifd + struct.pack(order + "I", 0))


def _scaled(arr):
    return arr.astype(np.float32) * np.float32(1.0 / (65535.0 if arr.dtype == np.uint16 else 255.0))


def _rgb(arr):
    x = _scaled(arr)
    x = x[..., None] if x.ndim == 2 else x
    return np.repeat(x[..., :1], 3, -1) if x.shape[-1] < 3 else x[..., :3]


def _luma(arr):
    r, g, b = np.moveaxis(_rgb(arr), -1, 0)
    return np.float32(0.299) * r + np.float32(0.587) * g + np.float32(0.114) * b


@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    """The reader's route: the native library, or numpy with the library
    switched off."""
    if request.param == "native":
        if not native.available():
            pytest.skip(f"the native library is not built here: {native.build_error()}")
    else:
        monkeypatch.setattr(native, "_library", lambda: (None, "switched off by the test"))
    return request.param


@pytest.mark.parametrize("name", list(FILES))
def test_imread_u16_matches_jax(tmp_path, route, name):
    """imread_u16 on Pillow-written TIFFs and PNGs: one channel as the
    luma of the channel repeated, (H, W), else RGB, equal to the formula
    and, where its library is built, to the JAX imread_u16."""
    arr = FILES[name]
    _write(tmp_path / name, arr)
    got = data.imread_u16(tmp_path / name)
    want = _luma(arr) if arr.ndim == 2 else _rgb(arr)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if arr.ndim == 2:  # the luma of a repeated channel moves it by at most an ulp or two
        np.testing.assert_allclose(got, _scaled(arr), rtol=3e-7, atol=0)
    if jax_native.available():
        np.testing.assert_array_equal(got, jax_imread_u16(tmp_path / name))


@pytest.mark.parametrize("name", list(FILES))
def test_imread_gray_is_the_native_luma(tmp_path, route, name):
    """imread_gray: the BT.601 luma in float32 of the scaled channels on
    either route (the JAX package's Pillow route returns Pillow's uint8
    "L", another function: ROADMAP, differences of rounding)."""
    arr = FILES[name]
    _write(tmp_path / name, arr)
    got = data.imread_gray(tmp_path / name)
    assert got.dtype == np.float32 and got.shape == arr.shape[:2]
    np.testing.assert_array_equal(got, _luma(arr))


@pytest.mark.parametrize("name", list(FILES))
def test_imread_gray_matches_jax_native(tmp_path, route, name):
    """imread_gray against the JAX package's native gray read, where its
    library is built (tests/test_native.py's guard)."""
    if not jax_native.available():
        pytest.skip("the JAX package's native library is not built")
    _write(tmp_path / name, FILES[name])
    np.testing.assert_array_equal(data.imread_gray(tmp_path / name),
                                  jax_native.imread_native(str(tmp_path / name), gray=True))


@pytest.mark.parametrize("name", list(FILES))
def test_imread_matches_jax_imread(tmp_path, route, name):
    arr = FILES[name]
    _write(tmp_path / name, arr)
    got = data.imread(tmp_path / name)
    np.testing.assert_array_equal(got, _rgb(arr))
    if jax_native.available():
        np.testing.assert_array_equal(got, jax_imread(tmp_path / name))


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("shape,dtype,rows_per_strip", [
    ((13, 17), np.uint16, 4),  # four strips, the last one short
    ((13, 17, 3), np.uint8, 5),
    ((9, 11, 4), np.uint16, None),  # RGBA: the first three kept
    ((9, 11, 5), np.uint8, 2),  # five samples a pixel: the numpy route only
])
def test_struct_written_tiff_strips(tmp_path, route, order, shape, dtype, rows_per_strip):
    """Baseline TIFFs written with struct in both byte orders, in several
    strips: imread_u16 and imread read them as the formula says."""
    rng = np.random.default_rng(3)
    arr = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = tmp_path / "x.tiff"
    write_tiff(path, arr, order, rows_per_strip)
    if route == "native" and len(shape) == 3 and shape[-1] > 4:
        assert native.imread_native(str(path)) is None  # the C++ reader takes 1, 3 or 4 samples
    np.testing.assert_array_equal(data.imread_u16(path), _luma(arr) if arr.ndim == 2 else _rgb(arr))
    np.testing.assert_array_equal(data.imread(path), _rgb(arr))


@pytest.mark.parametrize("reader", ["imread", "imread_u16", "imread_gray"])
@pytest.mark.parametrize("kind,tag", [("old_lzw", "Compression (tag 259) 5"), ("tiff_jpeg", "Compression (tag 259) 7"),
                                      ("palette_deflate", "PhotometricInterpretation (tag 262) 3")])
def test_tiff_the_port_cannot_read_raises_by_tag(tmp_path, reader, kind, tag):
    """TIFFs the C++ reader refuses and the numpy reader does not decode
    either (LZW, Deflate, PackBits and planar TIFFs it does:
    tests/test_torch_reader_formats.py): old-style (TIFF 5) LZW,
    JPEG-in-TIFF and a palette image: on either route the reader raises
    ValueError naming the tag and its value (the JAX package reads the
    last two with Pillow; README, port limits)."""
    arr = FILES["rgb8.tif"]
    path = tmp_path / "x.tiff"
    if kind == "old_lzw":  # a clear code, LSB first, opens the strip
        write_tiff(path, arr, compression=5, strip=lambda raw: b"\x00\x01" + raw)
    elif kind == "tiff_jpeg":
        Image.fromarray(arr).save(path, compression="jpeg")
        assert jax_imread_u16(path).shape == arr.shape
    else:
        Image.fromarray(arr).convert("P").save(path, compression="tiff_adobe_deflate")
        assert jax_imread_u16(path).shape == arr.shape[:2]
    with pytest.raises(ValueError, match=tag.replace("(", r"\(").replace(")", r"\)")):
        getattr(data, reader)(path)


def _pillow(path, arr, **kw):
    Image.fromarray(arr).save(path, **kw)
    return str(path)


def _u8(rng, shape):
    return (rng.random(shape) * 255).astype(np.uint8)


def _u16(rng, shape):
    return (rng.random(shape) * 65535).astype(np.uint16)


# tests/test_native.py's cases: (name, call(module, tmp_path, rng))
NATIVE_CASES = {
    "probe_png": lambda m, d, rng: m.probe(_pillow(d / "x.png", _u8(rng, (20, 30, 3)))),
    "decode_png": lambda m, d, rng: m.imread_native(_pillow(d / "x.png", _u8(rng, (20, 30, 3)))),
    "decode_png16": lambda m, d, rng: m.imread_native(_pillow(d / "x.png", _u16(rng, (10, 12)))),
    "decode_png16_gray": lambda m, d, rng: m.imread_native(
        _pillow(d / "x.png", _u16(rng, (10, 12))), gray=True),
    "decode_jpeg": lambda m, d, rng: m.imread_native(
        _pillow(d / "x.jpg", _u8(rng, (32, 32, 3)), quality=95)),
    "burst": lambda m, d, rng: m.read_burst_native(
        [_pillow(d / f"f{i}.png", _u8(rng, (16, 18, 3))) for i in range(3)]),
    "burst_shape_mismatch": lambda m, d, rng: m.read_burst_native(
        [_pillow(d / "a.png", _u8(rng, (8, 8, 3))),
         _pillow(d / "b.png", _u8(rng, (9, 8, 3)))]),
    "read_raw_u16": lambda m, d, rng: (
        (d / "x.raw").write_bytes(b"HDR!" + (rng.random((6, 8)) * 65535).astype("<u2").tobytes()),
        m.read_raw_u16(str(d / "x.raw"), 6, 8, offset=4))[1],
    "missing_file": lambda m, d, rng: m.imread_native("/nonexistent/file.png"),
    "tiff16_gray": lambda m, d, rng: (lambda p: (m.probe(p), m.imread_native(p, gray=True)))(
        _pillow(d / "d.tiff", _u16(rng, (37, 53)))),
    "tiff8_rgb": lambda m, d, rng: (lambda p: (m.probe(p), m.imread_native(p)))(
        _pillow(d / "c.tif", _u8(rng, (21, 33, 3)))),
}


@pytest.mark.parametrize("case", list(NATIVE_CASES))
def test_native_binding_matches_jax_native(tmp_path, case):
    """The port's ctypes binding against the JAX package's on
    tests/test_native.py's cases, the same files: equal results (None
    where the JAX binding returns None)."""
    if not (native.available() and jax_native.available()):
        pytest.skip(f"a native library is not built: {native.build_error() or 'the JAX package'}")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = NATIVE_CASES[case](native, tmp_path / "port", np.random.default_rng(0))
    want = NATIVE_CASES[case](jax_native, tmp_path / "jax", np.random.default_rng(0))
    if case in ("burst_shape_mismatch", "missing_file"):
        assert got is None and want is None
    elif case.startswith("probe"):
        assert got == want == (20, 30, 3, 8)
    elif case.startswith("tiff"):
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert got is not None
        np.testing.assert_array_equal(got, want)


def test_native_build_failure_is_reported(tmp_path, monkeypatch):
    """Where the library cannot be built, build() raises with the
    compiler's complaint, available() is False and build_error() says
    why; the readers then serve through numpy."""
    compile_ = native.COMPILE
    monkeypatch.setattr(native, "COMPILE", ("/nonexistent/g++",) + compile_[1:])
    with pytest.raises(OSError):
        native.build(str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "COMPILE", compile_ + ("-include", "no_such_header.h"))
    with pytest.raises(RuntimeError, match="no_such_header"):
        native.build(str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "LIBRARY", str(tmp_path / "lib.so"))
    lib, why = native._library.__wrapped__()  # the uncached loader, with the failing build
    assert lib is None and "no_such_header" in why
    monkeypatch.setattr(native, "_library", lambda: (None, why))
    assert not native.available() and native.build_error() == why
    _write(tmp_path / "x.png", FILES["rgb8.png"])
    np.testing.assert_array_equal(data.imread(tmp_path / "x.png"), _rgb(FILES["rgb8.png"]))


def test_native_library_is_the_ports_own(tmp_path):
    """The port builds native/mfsr_native.cpp into build/native/ (not
    native/, the JAX package's) and rebuilds only a library older than
    the source."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(data.__file__)))
    assert native.LIBRARY == os.path.join(os.path.dirname(root), "build", "native", "libmfsr_native.so")
    built = native.build(str(tmp_path / "lib.so"))
    stamp = os.path.getmtime(built)
    assert native.build(built) == built and os.path.getmtime(built) == stamp
    if native.available():
        assert os.path.samefile(native._library()[0]._name, native.LIBRARY)


def test_load_burst_takes_the_native_burst_read(tmp_path, monkeypatch):
    """load_burst reads through the threaded native load where it is
    built: the car burst's JPEGs load as the JAX load_burst loads them."""
    if not (native.available() and jax_native.available()):
        pytest.skip("a native library is not built")
    monkeypatch.setenv("MFSR_DATA_DIR", str(tmp_path))
    rng = np.random.default_rng(1)
    for path in data.burst_paths("car"):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(_u8(rng, (30, 44, 3))).save(path)
    calls = []
    monkeypatch.setattr(native, "read_burst_native", lambda paths, f=native.read_burst_native: calls.append(paths)
                        or f(paths))
    got = data.load_burst("car")
    assert calls and got.shape == (4, 30, 44, 3)
    np.testing.assert_array_equal(got, jax_native.read_burst_native(data.burst_paths("car")))


def _polar_tiffs(directory, input_type, rng):
    """The defog app's TIFF inputs, 16-bit gray, 48 x 64: a fog pair, or
    0/45/90-degree frames of a partially polarized scene."""
    s = 0.25 + 0.5 * rng.random((48, 64))
    if input_type == 1:
        frames = {"ImageWorst_tiff16.tiff": s * 0.9 + 0.05, "ImageBest_tiff16.tiff": s * 0.6}
    else:
        d, phi = np.linspace(0.1, 0.6, 64)[None, :], np.pi * rng.random((48, 64))
        frames = {f"degree{a}.tiff": 0.5 * s * (1.0 + d * np.cos(2.0 * (np.radians(a) - phi))) for a in (0, 45, 90)}
    for name, x in frames.items():
        Image.fromarray((x * 65535).astype(np.uint16)).save(directory / name)


@pytest.mark.parametrize("input_type,beta", [(1, 1.55), (2, 10.0)])
def test_app_tiff_inputs_match_jax_app(tmp_path, monkeypatch, input_type, beta):
    """polar_defog inputTypes 1 (the TIFF pair) and 2 (the Stokes
    synthesis of 0/45/90-degree TIFFs), one debug frame: the port's A, t
    and R against the JAX app's at the defog tolerance, R through the
    defog kernel's wrapper (its plain version on the CPU)."""
    _polar_tiffs(tmp_path, input_type, np.random.default_rng(input_type))
    argv = ["1", str(input_type), str(beta)]
    for name, run in (("jax", lambda: jax_app.main(argv)), ("port", lambda: app.main(argv, device="cpu"))):
        (tmp_path / name).mkdir()
        for tiff in tmp_path.glob("*.tiff"):
            (tmp_path / name / tiff.name).write_bytes(tiff.read_bytes())
        monkeypatch.chdir(tmp_path / name)
        assert run() == 0
    got, want = (np.load(tmp_path / name / "polar_defog_debug.npz") for name in ("port", "jax"))
    assert got["R"].shape == (48, 64, 3)
    for key in ("A", "t", "R"):
        np.testing.assert_allclose(got[key], want[key], **DEFOG_TOL)
    # the app's inputs are the readers' (imread_u16 on each file)
    iper, ipar = app._load_inputs(input_type, "cpu")
    assert iper.shape == (48, 64, 3) and iper.dtype == torch.float32
    r = jax.jit(lambda a, b: jdefog.polar_defog(a, b, to_jax(PolarDefogConfig(beta=beta))))(iper.numpy(), ipar.numpy())
    np.testing.assert_allclose(got["R"], np.asarray(r), **DEFOG_TOL)
