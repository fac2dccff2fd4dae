"""The defog path of the port against the JAX package on the CPU:
normalize_minmax, min_channels, the dark channel, the top-k selection
(with ties straddling the k-th rank), stokes_synthesis,
dark_channel_defog, polar_defog with its intermediates, the plain
version of the defog kernel against defog_pallas in interpret mode, the
PNG writer and the app."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, to_jax, tt

from multi_frame_super_resolution_tpu.models import defog as jdefog
from multi_frame_super_resolution_tpu.ops import color as jcolor
from multi_frame_super_resolution_tpu.ops import morphology as jmorph
from multi_frame_super_resolution_tpu.ops import reduce as jreduce
from multi_frame_super_resolution_tpu.pallas_ops import defog_pallas
from multi_frame_super_resolution_tpu_torch.apps import polar_defog as app
from multi_frame_super_resolution_tpu_torch.config import DarkChannelConfig, PolarDefogConfig
from multi_frame_super_resolution_tpu_torch.data import imwrite, synthetic_polar_pair
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels.defog import defog, defog_pixels
from multi_frame_super_resolution_tpu_torch.models import defog as mdefog
from multi_frame_super_resolution_tpu_torch.ops import color, morphology, reduce

# A, t and R: the tolerance of the JAX package's own defog spec
DEFOG_TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(h=120, w=160, seed=0):
    return synthetic_polar_pair(np.random.default_rng(seed), h, w)


@pytest.mark.parametrize("case", ["random", "constant"])
def test_normalize_minmax_matches_jax(case):
    """Elementwise f32 with one min and one max: equal to f32 rounding;
    a constant image takes the 1e-15 floor (no division by zero)."""
    rng = np.random.default_rng(3)
    img = rng.random((40, 50)).astype(np.float32) * 3.0 - 1.0
    if case == "constant":
        img = np.full((8, 9), 0.25, np.float32)
    got = nn(color.normalize_minmax(tt(img)))
    want = np.asarray(jcolor.normalize_minmax(jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("window", [3, 15, 25])
def test_dark_channel_matches_jax(window):
    """Channel min and the erode (two 1-D max-pool passes) select values:
    bit for bit, the valid-region border rule included."""
    img = np.random.default_rng(window).random((37, 53, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        nn(morphology.min_channels(tt(img))), np.asarray(jmorph.min_channels(jnp.asarray(img)))
    )
    np.testing.assert_array_equal(
        nn(mdefog.dark_channel(tt(img), window)), np.asarray(jdefog.dark_channel(jnp.asarray(img), window))
    )
    np.testing.assert_array_equal(
        nn(morphology.dilate(tt(img[..., 0]), window)),
        np.asarray(jmorph.dilate(jnp.asarray(img[..., 0]), window)),
    )


def test_top_k_indices_follow_lax_ties():
    """lax.top_k takes the lowest flat indices among tied values; the
    pattern tiled to 7,000 elements is one where torch.topk does not."""
    flat = np.tile(np.asarray([1, 3, 3, 3, 2, 3, 0], np.float32), 1000)
    for k in (2, 5, 1500, 4000):
        want = np.asarray(jax.lax.top_k(jnp.asarray(flat), k)[1])
        np.testing.assert_array_equal(nn(reduce.top_k_indices(tt(flat), k)), want)


def test_top_k_on_dark_channel_plateaus_matches_lax():
    """A 25 x 25 erode leaves plateaus; on the app's fog the values tied
    at the k-th rank straddle it, and the index set (and order) equals
    lax.top_k's."""
    iper, _ = _pair(300, 400)
    dark = mdefog.dark_channel(tt(iper), 25)
    k = int(0.005 * 300 * 400)
    flat = nn(dark).reshape(-1)
    want = np.asarray(jax.lax.top_k(jnp.asarray(flat), k)[1])
    tied = (flat == flat[want[-1]]).sum()
    taken = (flat[want] == flat[want[-1]]).sum()
    assert tied > taken  # ties straddle the k-th rank
    np.testing.assert_array_equal(nn(reduce.top_k_indices(dark, k)), want)


def test_masks_and_means_match_jax():
    rng = np.random.default_rng(5)
    img = rng.random((30, 40, 3)).astype(np.float32)
    scores = np.round(rng.random((30, 40)) * 20).astype(np.float32)  # many ties
    for k in (1, 17, 300):
        mask = nn(reduce.top_k_mask(tt(scores), k))
        want = np.asarray(jreduce.top_k_mask(jnp.asarray(scores), k))
        np.testing.assert_array_equal(mask, want)
        np.testing.assert_allclose(
            nn(reduce.masked_channel_sums(tt(img), tt(mask))),
            np.asarray(jreduce.masked_channel_sums(jnp.asarray(img), jnp.asarray(want))),
            rtol=1e-5,
        )
        np.testing.assert_allclose(
            nn(reduce.top_k_channel_means(tt(img), tt(scores), k)),
            np.asarray(jreduce.top_k_channel_means(jnp.asarray(img), jnp.asarray(scores), k)),
            rtol=1e-5,
        )


def test_stokes_synthesis_matches_jax():
    rng = np.random.default_rng(7)
    i0, i45, i90 = (rng.random((48, 64)).astype(np.float32) for _ in range(3))
    got = mdefog.stokes_synthesis(tt(i0), tt(i45), tt(i90))
    want = jax.jit(jdefog.stokes_synthesis)(jnp.asarray(i0), jnp.asarray(i45), jnp.asarray(i90))
    for g, w_ in zip(got, want):
        assert g.shape == (48, 64, 3) and g.is_contiguous()
        np.testing.assert_allclose(nn(g), np.asarray(w_), rtol=1e-5, atol=1e-6)


def test_dark_channel_defog_matches_jax():
    """He et al. dehazing: the airlight is a max over the selected pixels,
    the rest elementwise; equal to f32 rounding."""
    img = np.clip(_pair(90, 120, 2)[0] * 1.1, 0, 1)
    cfg = DarkChannelConfig()
    got = nn(mdefog.dark_channel_defog(tt(img), cfg))
    want = np.asarray(jax.jit(jdefog.dark_channel_defog, static_argnums=1)(jnp.asarray(img), to_jax(cfg)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw,beta", [((300, 400), 1.55), ((128, 152), 10.0)])
def test_polar_defog_matches_jax(hw, beta):
    """A, t and R against the jitted JAX function within rtol 1e-5 / atol
    1e-6 on the fog pair, whose dark channel has tied plateaus at the
    k-th rank (measured max abs 5e-7 on R). P and A_inf come from sums of
    the same selected pixels, in another order."""
    iper, ipar = _pair(*hw)
    cfg = PolarDefogConfig(beta=beta)
    want = jax.jit(lambda a, b: jdefog.polar_defog(a, b, to_jax(cfg), return_intermediates=True))(iper, ipar)
    LAUNCHES.clear()
    got = mdefog.polar_defog(tt(iper), tt(ipar), cfg, return_intermediates=True)
    assert not LAUNCHES  # CPU tensors take the plain version
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(nn(g), np.asarray(w_), **DEFOG_TOL)
    assert nn(mdefog.polar_defog(tt(iper), tt(ipar), cfg)).shape == (*hw, 3)


@pytest.mark.parametrize("h,w", [(40, 56), (33, 200)])
def test_defog_pixels_matches_pallas_kernel(h, w):
    """The plain version of the defog kernel against defog_pallas in
    interpret mode, at the JAX spec's shape (40 x 56) and a width that is
    not a multiple of 128, within the spec's tolerance: the interpreted
    kernel lands one f32 ulp away on ~18% of the elements (measured max
    abs 6e-8)."""
    rng = np.random.default_rng(h)
    iper = (rng.random((h, w, 3)) * 0.5 + 0.4).astype(np.float32)
    ipar = (iper * 0.7).astype(np.float32)
    p = np.asarray([0.4, 0.5, 0.6], np.float32)
    ainfi = np.asarray([0.8, 0.85, 0.9], np.float32)
    want = defog_pallas(jnp.asarray(iper), jnp.asarray(ipar), jnp.asarray(p), jnp.asarray(ainfi), interpret=True)
    got = defog_pixels(tt(iper), tt(ipar), tt(p), tt(ainfi))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(nn(g), np.asarray(w_), **DEFOG_TOL)
    # the wrapper takes the plain version on CPU tensors
    for g, w_ in zip(defog(tt(iper), tt(ipar), tt(p), tt(ainfi)), got):
        assert torch.equal(g, w_)


def test_defog_wrapper_checks_its_inputs():
    iper, ipar = (tt(x) for x in _pair(8, 10))
    p, ainfi = torch.full((3,), 0.5), torch.full((3,), 0.8)
    with pytest.raises(TypeError):
        defog(iper.double(), ipar.double(), p, ainfi)
    with pytest.raises(ValueError):
        defog(iper.transpose(0, 1), ipar.transpose(0, 1), p, ainfi)
    with pytest.raises(ValueError):
        defog(iper, ipar, torch.full((2,), 0.5), ainfi)
    with pytest.raises(ValueError):
        defog(iper[..., :2].contiguous(), ipar[..., :2].contiguous(), p, ainfi)


def _read_png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n = int.from_bytes(data[pos : pos + 4], "big")
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        assert int.from_bytes(data[pos + 8 + n : pos + 12 + n], "big") == zlib.crc32(kind + body)
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h = int.from_bytes(chunks[b"IHDR"][:4], "big"), int.from_bytes(chunks[b"IHDR"][4:8], "big")
    channels = {0: 1, 2: 3}[chunks[b"IHDR"][9]]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + w * channels)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape((h, w, channels) if channels == 3 else (h, w))


@pytest.mark.parametrize("shape", [(20, 30, 3), (20, 30), (7, 5, 1)])
def test_imwrite_png_round_trip(tmp_path, shape):
    img = np.random.default_rng(1).random(shape).astype(np.float32) * 1.2 - 0.1
    imwrite(tmp_path / "x.png", img)
    want = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    if want.ndim == 3 and want.shape[-1] == 1:
        want = want[..., 0]
    np.testing.assert_array_equal(_read_png(tmp_path / "x.png"), want)


def test_app_debug_run_matches_jax(tmp_path, monkeypatch, capsys):
    """main(["1", "3", "1.55"], device="cpu"): one frame of the synthetic
    demo on the CPU, asked for explicitly, its R_gpu.png and
    polar_defog_debug.npz, equal to the JAX function on the app's own
    input within the defog tolerance."""
    monkeypatch.chdir(tmp_path)
    assert app.main(["1", "3", "1.55"], device="cpu") == 0
    out = np.load(tmp_path / "polar_defog_debug.npz")
    iper, ipar = synthetic_polar_pair(np.random.default_rng(0))
    cfg = PolarDefogConfig(beta=1.55)
    r, a, t = jax.jit(lambda x, y: jdefog.polar_defog(x, y, to_jax(cfg), return_intermediates=True))(iper, ipar)
    for name, want in (("R", r), ("A", a), ("t", t)):
        np.testing.assert_allclose(out[name], np.asarray(want), **DEFOG_TOL)
    assert _read_png(tmp_path / "R_gpu.png").shape == (300, 400, 3)
    assert "R minmax:" in capsys.readouterr().out


@pytest.mark.parametrize("argv,error,match", [
    (["1", "1", "1.55"], FileNotFoundError, "ImageWorst_tiff16.tiff"),
    (["1", "2", "10"], FileNotFoundError, "degree0.tiff"),
    (["1", "4", "1"], ValueError, "inputType"),
])
def test_app_without_tiff_reader_raises(argv, error, match, tmp_path, monkeypatch):
    """inputTypes 1 and 2 read their TIFF files from the working
    directory: without them they raise naming the first file; an unknown
    inputType raises before any device is chosen (the TIFF inputs
    themselves: tests/test_torch_readers.py)."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(error, match=match):
        app.main(argv, device="cpu" if error is FileNotFoundError else None)


def test_app_usage():
    assert app.main(["1"]) == -1


def test_app_without_card_raises_unless_cpu_is_asked(tmp_path, monkeypatch):
    """No card and no device request: the app raises rather than run on
    the CPU. ``--device cpu`` on the command line runs it there."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["1", "3", "1.55"])
    assert not (tmp_path / "R_gpu.png").exists()
    assert app.main(["1", "3", "1.55", "--device", "cpu"]) == 0
    assert (tmp_path / "R_gpu.png").exists()
