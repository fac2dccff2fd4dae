"""The port's utils (metrics, timing, profiling, debug), the ops it
lacked (rotate, downscale, upsample_zero, unsharp_mask, srgb_degamma)
and the getimg and handheld_sr apps, against the JAX package on the
CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, tt

import multi_frame_super_resolution_tpu.utils as jax_utils
from multi_frame_super_resolution_tpu.apps.getimg import main as jax_getimg
from multi_frame_super_resolution_tpu.ops import color as jcolor
from multi_frame_super_resolution_tpu.ops import filters as jfilters
from multi_frame_super_resolution_tpu.ops import geometry as jgeometry
from multi_frame_super_resolution_tpu.utils import metrics as jmetrics
from multi_frame_super_resolution_tpu.utils import timing as jtiming
from multi_frame_super_resolution_tpu_torch import data, utils
from multi_frame_super_resolution_tpu_torch.apps import getimg, handheld_sr
from multi_frame_super_resolution_tpu_torch.config import HandheldConfig
from multi_frame_super_resolution_tpu_torch.models.handheld import handheld_superres, handheld_superres_raw
from multi_frame_super_resolution_tpu_torch.ops import color, filters, geometry
from multi_frame_super_resolution_tpu_torch.utils import debug, metrics, profiling, timing


def test_utils_exports_what_the_jax_utils_export():
    """utils/__init__.py exports the JAX package's names (interpret_pallas,
    a Pallas switch, is not ported)."""
    assert utils.__all__ == jax_utils.__all__
    assert all(hasattr(utils, name) for name in utils.__all__)


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3)], ids=["gray", "rgb"])
@pytest.mark.parametrize("win", [7, 5])
def test_metrics_match_jax(shape, win):
    """mse, psnr (rtol 1e-6) and ssim (rtol 1e-5: the VALID box is a
    separable sum here, a HIGHEST-precision convolution in JAX) on a
    noisy copy of a random image."""
    rng = np.random.default_rng(win)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(shape), 0.0, 1.0).astype(np.float32)
    for name, rtol in (("mse", 1e-6), ("psnr", 1e-6)):
        np.testing.assert_allclose(float(getattr(metrics, name)(tt(a), tt(b))),
                                   float(getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b))), rtol=rtol)
    np.testing.assert_allclose(float(metrics.ssim(tt(a), tt(b), win=win)),
                               float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b), win=win)), rtol=1e-5)
    assert float(metrics.ssim(tt(a), tt(a), win=win)) == pytest.approx(1.0, abs=1e-6)
    assert float(metrics.psnr(tt(a), tt(a))) > 100


ROTATIONS = [
    (0.3, "bilinear", False), (0.3, "bicubic", True), (1.0, "bicubic", False), (-0.7, "nearest", True),
    (np.pi / 2, "nearest", True), (np.pi, "nearest", False), (-np.pi / 2, "bilinear", True),
    (3 * np.pi / 2, "bicubic", True),
]


@pytest.mark.parametrize("shape", [(21, 34), (21, 34, 3)], ids=["gray", "rgb"])
@pytest.mark.parametrize("angle,method,expand", ROTATIONS)
def test_rotate_matches_jax(shape, angle, method, expand):
    """rotate with and without expand=True, exact multiples of 90 degrees
    among them (the canvas sized with the JAX package's 1e-9 guard):
    the same output shape, values within 1e-5 (float32 sine and cosine,
    one ulp apart, through the bicubic taps)."""
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    want = np.asarray(jgeometry.rotate(jnp.asarray(img), angle, method=method, expand=expand))
    got = nn(geometry.rotate(tt(img), angle, method=method, expand=expand))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if method == "nearest" and expand and abs(angle) == np.pi / 2:
        np.testing.assert_array_equal(got, np.rot90(img, k=1 if angle > 0 else -1))


def test_rotate_about_a_given_center_matches_jax():
    img = np.random.default_rng(2).random((24, 30, 3)).astype(np.float32)
    want = np.asarray(jgeometry.rotate(jnp.asarray(img), 0.4, center=(5.0, 20.5)))
    np.testing.assert_allclose(nn(geometry.rotate(tt(img), 0.4, center=(5.0, 20.5))), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(23, 35), (23, 35, 3)], ids=["gray", "rgb"])
def test_resampling_ops_match_jax(shape):
    """downscale (bilinear and bicubic), upsample_zero (exact) and
    unsharp_mask (within 1e-6: the Gaussian's separable sums run in
    another order than JAX's banded matmuls)."""
    img = np.random.default_rng(3).random(shape).astype(np.float32)
    for scale, method in ((2, "bilinear"), (3, "bicubic")):
        want = np.asarray(jgeometry.downscale(jnp.asarray(img), scale, method))
        got = nn(geometry.downscale(tt(img), scale, method))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(nn(geometry.upsample_zero(tt(img), 3)),
                                  np.asarray(jgeometry.upsample_zero(jnp.asarray(img), 3)))
    for sigma, amount in ((1.0, 1.0), (2.0, 0.5)):
        np.testing.assert_allclose(nn(filters.unsharp_mask(tt(img), sigma, amount)),
                                   np.asarray(jfilters.unsharp_mask(jnp.asarray(img), sigma, amount)), rtol=0, atol=1e-6)


def test_srgb_degamma_matches_jax():
    """srgb_degamma within 1e-6 over [-0.2, 1.2] (clamped), and the
    round trip through srgb_gamma within 1e-4 (tests/test_ops_misc.py)."""
    x = np.linspace(-0.2, 1.2, 4001, dtype=np.float32).reshape(1, -1)
    np.testing.assert_allclose(nn(color.srgb_degamma(tt(x))), np.asarray(jcolor.srgb_degamma(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    y = np.random.default_rng(4).random((16, 16)).astype(np.float32)
    np.testing.assert_allclose(nn(color.srgb_degamma(color.srgb_gamma(tt(y)))), y, atol=1e-4)


# utils/debug.py (tests/test_utils_aux.py on the port)


def test_dump_intermediates(tmp_path):
    p = debug.dump_intermediates(str(tmp_path / "dbg.npz"), a=torch.ones((2, 2)), b=np.zeros(3))
    got = np.load(p)
    assert set(got.files) == {"a", "b"}
    np.testing.assert_allclose(got["a"], 1.0)


def test_check_finite_reports():
    rep = debug.check_finite("x", torch.tensor([1.0, float("nan"), 3.0]))
    assert rep["finite_frac"] == pytest.approx(2 / 3)
    assert rep["min"] == 1.0 and rep["max"] == 3.0


def test_guard_finite_scrubs_and_debug_nans_raises():
    """guard_finite scrubs NaN to 0 (infinities to the largest finite
    values, as jnp.nan_to_num); under debug_nans(True) it raises
    FloatingPointError instead, and the switch is scoped."""
    x = torch.tensor([float("nan"), 2.0, float("inf")])
    np.testing.assert_allclose(nn(debug.guard_finite(x))[:2], [0.0, 2.0])
    assert float(debug.guard_finite(x)[2]) == np.finfo(np.float32).max
    with debug.debug_nans(True):
        with pytest.raises(FloatingPointError):
            debug.guard_finite(torch.log(torch.tensor(-1.0)) * 1.0)
        assert float(debug.guard_finite(torch.tensor(2.0))) == 2.0
        with debug.debug_nans(False):
            assert float(debug.guard_finite(torch.tensor(float("nan")))) == 0.0
        with pytest.raises(FloatingPointError):
            debug.guard_finite(x)
    assert float(debug.guard_finite(torch.tensor(float("nan")))) == 0.0


# utils/profiling.py


def test_trace_writes_a_trace_with_the_named_ranges(tmp_path):
    """trace writes a torch.profiler trace under its log_dir, holding the
    ranges of annotate and named."""
    double = profiling.named(lambda x: x * 2.0, "mfsr.test.named")
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("mfsr.test.annotate"):
            double(torch.ones(8))
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    text = (tmp_path / files[0]).read_text()
    assert "mfsr.test.annotate" in text and "mfsr.test.named" in text
    assert double.__name__ == "<lambda>"


# utils/timing.py


def test_measure_refuses_unperturbable_closure():
    """A zero-arg closure repeats one computation on one input: measure()
    refuses it with the JAX package's ValueError."""
    with pytest.raises(ValueError) as port:
        timing.measure(lambda: torch.ones(()), warmup=0, iters=1)
    with pytest.raises(ValueError) as jax_err:
        jtiming.measure(lambda: jnp.ones(()), warmup=0, iters=1)
    assert str(port.value) == str(jax_err.value)


def test_measure_times_are_readback_fenced():
    """measure()'s per-iteration times sit at (or above) the floor of an
    explicit readback-fenced call of the same work, each timed call sees
    its own perturbed input, and the warm-up calls are not timed."""
    import time

    seen = []

    def work(x):
        seen.append(float(x[0, 0]))
        out = x
        for _ in range(20):
            out = out @ x
        return out

    x = torch.from_numpy(np.random.default_rng(0).random((384, 384)).astype(np.float32)) / 384.0
    floors = []
    for i in range(3):
        t0 = time.perf_counter()
        float(work(x * (1.0 + 1e-6 * i)).sum())
        floors.append(time.perf_counter() - t0)
    seen.clear()
    res = timing.measure(work, args=(x,), warmup=1, iters=3)
    assert res.p50 >= 0.25 * sorted(floors)[1]
    assert res.iter_times is not None and len(res.iter_times) == 3
    assert len(seen) == 4 and len(set(seen)) == 4  # warm-up and timed inputs all distinct
    np.testing.assert_allclose(seen, [float(x[0, 0]) * (1 - 1e-5 * i) for i in range(1, 5)], rtol=1e-6)


def test_measure_amortized_perturbs_every_call():
    """measure_amortized: (1 + k) (reps + 1) calls, each on its own input,
    and a positive marginal time per call."""
    seen = []

    def work(x):
        seen.append(float(x[0]))
        return x * 2.0

    sec = timing.measure_amortized(work, (torch.ones(1000),), k=3, reps=2)
    assert sec > 0.0
    assert len(seen) == (1 + 3) * (2 + 1) and len(set(seen)) == len(seen)


def test_benchmark_result_prints_as_jax_does():
    fields = dict(name="handheld-city", seconds=0.5, iters=10, pixels_per_iter=524288.0,
                  iter_times=[0.05] * 10, amortized_sec=0.04)
    port, jax_res = timing.BenchmarkResult(**fields), jtiming.BenchmarkResult(**fields)
    assert str(port) == str(jax_res) and port.as_dict() == jax_res.as_dict()
    assert (port.p50, port.fps, port.mp_per_s, port.amortized_mp_per_s) == (
        jax_res.p50, jax_res.fps, jax_res.mp_per_s, jax_res.amortized_mp_per_s)
    t = timing.Timer()
    t.start()
    assert t.stop() >= 0.0 and t.stop() == t.seconds


# apps/getimg.py


def test_getimg_writes_the_jax_apps_files(tmp_path, monkeypatch):
    """getimg 2 --size 64 --burst 2 on a 96 x 96 source: the same file
    names as the JAX app, each holding the same 8-bit samples byte for
    byte (the PNG containers differ: Pillow, which the JAX app writes
    with, picks adaptive row filters; the port writes filter 0)."""
    src = tmp_path / "big.png"
    data.imwrite(src, np.random.default_rng(0).random((96, 96, 3)).astype(np.float32))
    monkeypatch.chdir(tmp_path)
    args = [str(src), "2", "--size", "64", "--burst", "2", "--out"]
    assert getimg.main(args + ["port"]) == 0
    assert jax_getimg(args + ["jax"]) == 0
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) and len(files) == 8
    assert "subimg0000_gray.png" in files and "subimg0001_burst01.png" in files
    for name in files:
        np.testing.assert_array_equal(data.imread(tmp_path / "port" / name), data.imread(tmp_path / "jax" / name))


def test_getimg_refuses_small_source_and_bad_flags(tmp_path):
    src = tmp_path / "small.png"
    data.imwrite(src, np.random.default_rng(0).random((16, 16, 3)).astype(np.float32))
    assert getimg.main([str(src), "1", "--size", "64"]) == -1
    assert getimg.main([str(src), "1", "--bogus"]) == -1
    assert getimg.main([str(src)]) == -1


# apps/handheld_sr.py


@pytest.fixture
def city_pngs(tmp_path, monkeypatch):
    """A 5 x 64 x 128 city burst written as PNGs under MFSR_DATA_DIR, the
    working directory a fresh one, one timed call per protocol."""
    burst, _ = data.synthetic_rgb_burst(np.random.default_rng(0), 5, 64, 128, 2.0)
    data.write_burst("city", burst, str(tmp_path / "data"))
    monkeypatch.setenv("MFSR_DATA_DIR", str(tmp_path / "data"))
    for key, value in (("WARMUP", "1"), ("ITERS", "1"), ("K", "2"), ("REPS", "1")):
        monkeypatch.setenv(f"MFSR_BENCH_{key}", value)
    (tmp_path / "run").mkdir()
    monkeypatch.chdir(tmp_path / "run")
    return data.load_burst("city")


@pytest.mark.parametrize("raw", [False, True], ids=["rgb", "raw"])
def test_handheld_sr_writes_the_pipelines_image(city_pngs, capsys, raw):
    """handheld_sr city 2 [--raw] --device cpu: prints its BenchmarkResult
    (both protocols) and writes the image of handheld_superres (or, on
    the RGGB mosaic, handheld_superres_raw) at HandheldConfig(scale=2),
    quantized as imwrite quantizes: byte for byte."""
    argv = ["city", "2", "--device", "cpu"] + (["--raw"] if raw else [])
    assert handheld_sr.main(argv) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"handheld-city{'-raw' if raw else ''}: ") and "FPS" in out and "in-graph" in out
    cfg = HandheldConfig(scale=2)
    if raw:
        mosaic = np.stack([data.mosaic_rggb(f) for f in city_pngs])
        want = handheld_superres_raw(tt(mosaic), cfg, device="cpu")
    else:
        want = handheld_superres(tt(city_pngs), cfg, device="cpu")
    got = data.imread("city_handheld_sr.png")
    assert got.shape == (128, 256, 3)
    np.testing.assert_array_equal(got, (np.clip(nn(want), 0, 1) * 255 + 0.5).astype(np.uint8) * np.float32(1 / 255))


def test_handheld_sr_device_rule(city_pngs, monkeypatch):
    """Without a card the app raises unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MFSR_BENCH_AMORTIZED", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        handheld_sr.main(["city", "2"])
    assert handheld_sr.main(["city", "2"], device="cpu") == 0
