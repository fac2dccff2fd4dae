"""The port's PNG reader, burst loader and the two BTV-L1 apps
(multi_frame_sr and runall) against the JAX package on the CPU."""

import pathlib
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from multi_frame_super_resolution_tpu.apps import multi_frame_sr as jax_app
from multi_frame_super_resolution_tpu.data import imread as jax_imread
from multi_frame_super_resolution_tpu.data import load_burst as jax_load_burst
from multi_frame_super_resolution_tpu.data import native as jax_native
from multi_frame_super_resolution_tpu_torch import data
from multi_frame_super_resolution_tpu_torch.apps import multi_frame_sr as app
from multi_frame_super_resolution_tpu_torch.apps import runall
from multi_frame_super_resolution_tpu_torch.data import native, png

_RAMP = np.linspace(0.0, 1.0, 37)[None, :] * np.linspace(0.2, 1.0, 29)[:, None]
# Pillow mode -> an array it writes as PNG: 8-bit gray, 16-bit gray,
# gray+alpha, RGB, RGBA
PNG_KINDS = {
    "L": (_RAMP * 255).astype(np.uint8),
    "I;16": (_RAMP * 65535).astype(np.uint16),
    "LA": (np.stack([_RAMP, 1 - _RAMP], -1) * 255).astype(np.uint8),
    "RGB": (np.stack([_RAMP, _RAMP**2, 1 - _RAMP], -1) * 255).astype(np.uint8),
    "RGBA": (np.stack([_RAMP, _RAMP**2, 1 - _RAMP, _RAMP], -1) * 255).astype(np.uint8),
}


def _expected(arr: np.ndarray) -> np.ndarray:
    """float32 RGB of a PNG's samples: times float32(1 / max), gray
    repeated, alpha dropped."""
    scale = np.float32(1.0 / (65535.0 if arr.dtype == np.uint16 else 255.0))
    x = arr.astype(np.float32) * scale
    if x.ndim == 2:
        x = x[..., None]
    return np.repeat(x[..., :1], 3, -1) if x.shape[-1] < 3 else x[..., :3]


@pytest.mark.parametrize("mode", list(PNG_KINDS))
def test_imread_matches_jax_imread(tmp_path, mode):
    """PNGs that Pillow writes (its own row filters): the port's imread
    equals the samples scaled as the JAX package's libpng decoder scales
    them, and the JAX imread itself (bit for bit where its decoder is
    built; Pillow's fallback divides, an ulp apart, and clips 16-bit
    samples, so that case is held against the samples only)."""
    arr = PNG_KINDS[mode]
    path = tmp_path / f"{mode.replace(';', '')}.png"
    Image.fromarray(arr).save(path)
    got = data.imread(path)
    assert got.dtype == np.float32 and got.shape == (29, 37, 3)
    np.testing.assert_array_equal(got, _expected(arr))
    if jax_native.available():
        np.testing.assert_array_equal(got, jax_imread(path))
    elif arr.dtype == np.uint8:
        np.testing.assert_allclose(got, jax_imread(path), rtol=2e-7, atol=0)


@pytest.mark.parametrize("shape", [(29, 37), (29, 37, 3)])
def test_imwrite_imread_round_trip_is_exact(tmp_path, shape):
    arr = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    data.imwrite(tmp_path / "x.png", arr)
    np.testing.assert_array_equal(data.imread(tmp_path / "x.png"), _expected(arr))
    img = arr.astype(np.float32) / 255.0  # floats quantize back to the same bytes
    data.imwrite(tmp_path / "y.png", img)
    np.testing.assert_array_equal(data.imread(tmp_path / "y.png"), _expected(arr))


def test_imread_raises_on_jpeg_and_interlaced_png(tmp_path, monkeypatch):
    """Without the native reader (switched off here) the numpy readers
    decode JPEG, interlaced and palette PNGs to Pillow's samples
    (tests/test_torch_reader_formats.py holds every form), and refuse
    what they do not decode by name: an arithmetic-coded JPEG, and an
    interlaced PNG whose image data is missing."""
    monkeypatch.setattr(native, "_library", lambda: (None, "switched off by the test"))
    Image.fromarray(PNG_KINDS["RGB"]).save(tmp_path / "x.jpg")
    np.testing.assert_array_equal(data.imread(tmp_path / "x.jpg"), _expected(np.asarray(Image.open(tmp_path / "x.jpg"))))
    blob = (tmp_path / "x.jpg").read_bytes()
    at = blob.index(b"\xff\xc0")
    (tmp_path / "a.jpg").write_bytes(blob[:at] + b"\xff\xc9" + blob[at + 2 :])  # SOF0 -> SOF9 (arithmetic)
    with pytest.raises(ValueError, match="JPEG SOF9"):
        data.imread(tmp_path / "a.jpg")
    # an Adam7-interlaced header (Pillow writes none) with no image data
    header = struct.pack(">IIBBBBB", 37, 29, 8, 2, 0, 0, 1)
    (tmp_path / "x.png").write_bytes(b"\x89PNG\r\n\x1a\n" + png.chunk(b"IHDR", header)
                                     + png.chunk(b"IDAT", zlib.compress(b"")) + png.chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="PNG image data holds 0 bytes"):
        data.imread(tmp_path / "x.png")
    Image.fromarray(PNG_KINDS["L"]).convert("P").save(tmp_path / "p.png")
    np.testing.assert_array_equal(data.imread(tmp_path / "p.png"),
                                  _expected(np.asarray(Image.open(tmp_path / "p.png").convert("RGB"))))


def test_load_burst_reads_mfsr_data_dir(tmp_path, monkeypatch):
    """PNG bursts written at the reference paths under MFSR_DATA_DIR (read
    at call time) load as the JAX load_burst loads them; the car burst's
    JPEGs, which write_burst writes as imwrite does, load through the
    native reader where it is built (as in the JAX package) and through
    numpy without it, to Pillow's samples either way."""
    monkeypatch.setenv("MFSR_DATA_DIR", str(tmp_path))
    city = data.synthetic_rgb_burst(np.random.default_rng(0), 5, 24, 40, 2.0)[0]
    iso = data.synthetic_rgb_burst(np.random.default_rng(1), 4, 30, 44, 2.0)[0]
    for name, burst in (("city", city), ("iso", iso)):
        data.write_burst(name, burst, str(tmp_path))
        got = data.load_burst(name)
        assert got.shape == burst.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got, (np.clip(burst, 0, 1) * 255 + 0.5).astype(np.uint8) * np.float32(1 / 255))
        np.testing.assert_allclose(got, jax_load_burst(name, str(tmp_path)), rtol=2e-7, atol=0)
    assert data.write_burst("car", iso, str(tmp_path)) == data.burst_paths("car")
    pillow = np.stack([np.asarray(Image.open(p)) for p in data.burst_paths("car")]) * np.float32(1 / 255)
    if native.available():
        np.testing.assert_array_equal(data.load_burst("car"), jax_load_burst("car", str(tmp_path)))
        np.testing.assert_array_equal(data.load_burst("car"), pillow)
    monkeypatch.setattr(native, "_library", lambda: (None, "switched off by the test"))
    np.testing.assert_array_equal(data.load_burst("car"), pillow)
    with pytest.raises(ValueError, match="got 3 frames"):
        data.write_burst("car", iso[:3], str(tmp_path))
    with pytest.raises(ValueError, match="unknown dataset"):
        data.load_burst("nope")


@pytest.fixture
def small_burst(monkeypatch):
    """Both packages' load_burst routed to one 3 x 48 x 64 RGB burst, as
    tests/test_apps.py runs the JAX app."""
    gray, _ = data.synthetic_burst(np.random.default_rng(0), 3, 48, 64, 2.0)
    burst = np.stack([gray] * 3, axis=-1)
    monkeypatch.setattr("multi_frame_super_resolution_tpu.data.load_burst", lambda name: burst)
    monkeypatch.setattr(data, "load_burst", lambda name: burst)
    monkeypatch.setenv("MFSR_SR_CYCLES", "2")
    return burst


def test_app_matches_jax_app(small_burst, tmp_path, monkeypatch):
    """multi_frame_sr pyrlk city 10 end to end (2 cycles): the port's
    sr_result PNG equals the JAX app's within 1/255 on >= 99.9% of values
    (measured: all of them). The sharpened sr2_result is the bit-exact
    laplacian_sharpen (test_torch_btvl1.py) of that frame before
    quantization; the stencil's 5 c - 4 neighbours scales the frames'
    sub-1/255 differences up to 9-fold, so it is checked for its shape
    and range only."""
    outputs = {}
    for name, run in (("jax", lambda: jax_app.main(["pyrlk", "city", "10"])),
                      ("port", lambda: app.main(["pyrlk", "city", "10"], device="cpu"))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert run() == 0
        outputs[name] = [data.imread(tmp_path / name / f"city_pyrlk_{s}_result.png") for s in ("sr", "sr2")]
    (got, got2), (want, _) = outputs["port"], outputs["jax"]
    assert got.shape == want.shape == got2.shape == (96, 128, 3)
    assert np.mean(np.abs(got - want) <= 1.0 / 255 + 1e-6) >= 0.999
    assert 0.0 <= got2.min() and got2.max() <= 1.0 and got2[0].max() == 0.0  # zeroed border


def test_app_usage_and_device_rule(small_burst, tmp_path, monkeypatch, capsys):
    """A wrong argument count prints the usage and returns -1; without a
    card the app raises unless the CPU is asked for, here with --device."""
    assert app.main(["onlyone"]) == -1
    assert "optFlowName" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["farneback", "city", "1"])
    assert app.main(["farneback", "city", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "sec" in out and "FPS" in out
    assert (tmp_path / "city_farneback_sr_result.png").exists()


def test_runall_quick_runs_on_cpu(tmp_path, monkeypatch, capsys):
    """runall --quick: the defog configuration and farneback on a city PNG
    burst under MFSR_DATA_DIR."""
    monkeypatch.setenv("MFSR_DATA_DIR", str(tmp_path))
    data.write_burst("city", data.synthetic_rgb_burst(np.random.default_rng(2), 5, 32, 48, 2.0)[0], str(tmp_path))
    assert runall.main(["--quick"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "polar_defog beta=1.55" in out and "per-frame dispatch" in out
    assert "multi_frame_sr farneback city 10" in out and "FPS" in out
