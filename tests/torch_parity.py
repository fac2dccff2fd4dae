"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same numpy input goes through the JAX function and its counterpart
in multi_frame_super_resolution_tpu_torch; the outputs come back as
numpy and are compared with a stated tolerance.

Importing this module pins torch to one thread (the suite runs several
xdist workers on few cores) and turns TF32 off, so that a test run on a
card compares in full float32.
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from multi_frame_super_resolution_tpu_torch.registration import tiles

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def tt(x, device="cpu") -> torch.Tensor:
    """numpy (or JAX) array -> contiguous torch tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(device)


def nn(x) -> np.ndarray:
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def psnr(a, b, peak: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(peak * peak / mse)


def ulp_perturbed(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """float32 ``x`` with each value moved by -1, 0 or +1 ulp at random: an
    input that float32 rounding alone could have produced instead."""
    step = rng.integers(-1, 2, x.shape)
    up, down = np.nextafter(x, np.float32(np.inf)), np.nextafter(x, np.float32(-np.inf))
    return np.where(step > 0, up, np.where(step < 0, down, x)).astype(np.float32)


def bf16_limit(jax_fn, x: np.ndarray, want: np.ndarray, limit: float = 60.0) -> float:
    """The PSNR limit of a bfloat16 configuration against the JAX pipeline
    ``jax_fn`` (a function of the numpy input) whose output on ``x`` is
    ``want``: ``limit`` (the slice's 60 dB), or JAX's own one-ulp spread
    (its output when ``x`` moves by one ulp, against ``want``) less 6.02
    dB, twice its RMS distance, where that is lower: a weight within
    float32 rounding of a bfloat16 boundary rounds either way."""
    spread = psnr(jax_fn(ulp_perturbed(x, np.random.default_rng(5))), want)
    return min(limit, spread - 20.0 * np.log10(2.0))


def to_jax(cfg):
    """The JAX package's config of the same class name as the port's
    ``cfg``, rebuilt field by field (nested configs too); other values
    pass through. The JAX config is imported here: the card tests import
    this module on a host without JAX."""
    if not dataclasses.is_dataclass(cfg):
        return cfg
    from multi_frame_super_resolution_tpu import config as jax_config

    cls = getattr(jax_config, type(cfg).__name__)
    return cls(**{f.name: to_jax(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)})


# the alternates' shifts: beyond the fast branch's +-16 warp clip for
# "image" mode; within a few px for "tile" mode, whose edge tiles would
# otherwise search windows that lie wholly outside the image (identical
# clamped patches, exact ties that the integral images break by rounding)
BIG_SHIFTS = [(18.3, -17.6), (2.6, -1.4), (-19.7, 12.2), (0.3, 20.4)]
SMALL_SHIFTS = [(2.3, -1.6), (-1.4, 0.6), (0.7, 2.2), (-2.3, -0.4)]


def search_inputs(h, w, true_shifts, tile_size=16, seed=0):
    """A reference frame and 4 alternates that are shifted (subpixel,
    bilinear), noisy copies of it, as a burst is: alt_f(p + d_f) =
    ref(p) + noise for the shifts d_f in ``true_shifts``; and rounded
    predictions within 2 px of each d_f. Returns (ref (h, w), alts
    (4, h, w), rounded (4, nty, ntx, 2)), float32 numpy."""
    rng = np.random.default_rng(seed)
    pad = 32
    base = rng.random((h + 2 * pad + 1, w + 2 * pad + 1))
    for axis in (0, 1, 0, 1):  # two [1, 2, 1] / 4 passes per axis
        base = 0.25 * (np.roll(base, 1, axis) + 2.0 * base + np.roll(base, -1, axis))
    # zero-mean (the windows branch's integral images then cancel little),
    # its contrast ramped down to the left so that a threshold of 0.05
    # gates the flattest surfaces
    base = (base - 0.5) * np.linspace(0.02, 1.0, base.shape[1])
    ref = base[pad : pad + h, pad : pad + w]
    alts = []
    for dy, dx in true_shifts:  # alt(q) = base(q - d), bilinear
        y0, x0 = int(np.floor(-dy)), int(np.floor(-dx))
        fy, fx = -dy - y0, -dx - x0

        def crop(oy, ox):
            return base[pad + y0 + oy : pad + y0 + oy + h, pad + x0 + ox : pad + x0 + ox + w]

        moved = ((1 - fy) * ((1 - fx) * crop(0, 0) + fx * crop(0, 1))
                 + fy * ((1 - fx) * crop(1, 0) + fx * crop(1, 1)))
        alts.append(moved + 0.01 * rng.standard_normal((h, w)))
    nty, ntx = -(-h // tile_size), -(-w // tile_size)
    rounded = np.round(np.asarray(true_shifts))[:, None, None, :] + rng.integers(-2, 3, (4, nty, ntx, 2))
    return ref.astype(np.float32), np.stack(alts).astype(np.float32), rounded.astype(np.float32)


def tied_minima(ref, alts, rounded, tile_size: int, radius: int) -> np.ndarray:
    """(N, nty, ntx) bool: tiles of a "tile"-mode search (windows at the
    rounded prediction, clamped per pixel) whose SSD minimum several
    offsets share exactly: identical clamped patches, as on a ragged edge
    tile whose reference tile is edge-padded too. Float32 sums in any two
    orders rank such a tie by rounding, so the argmin there is not the
    function's. Found from float64 direct sums; inputs are numpy."""
    windows = tiles.extract_search_windows_batched(
        tt(alts).double(), tile_size, radius, tt(rounded).to(torch.int32)
    )
    ref_tiles = tiles.extract_ref_tiles(tt(ref).double(), tile_size)
    s = 2 * radius + 1
    ssd = torch.stack([
        ((windows[..., u : u + tile_size, v : v + tile_size] - ref_tiles) ** 2).sum((-2, -1))
        for u in range(s) for v in range(s)
    ], dim=-1)
    return nn((ssd == ssd.amin(-1, keepdim=True)).sum(-1) > 1)


def prealigned_search_inputs(frames: int = 9, h: int = 128, w: int = 256, seed: int = 2):
    """The inputs of RAW_SCALE4's tile searches (T = 8, R = 4, "image"
    mode; coarse level first) on a ``frames`` x h x w RAW burst rotated as
    the city burst is (0/0/5/10/-15 degrees, repeated), as the port's RAW
    path on the CPU hands them over after its own pre-alignment: a list of
    (ref, alts, rounded, tile_size, radius, threshold) with CPU tensors.
    Pre-alignment clamps each rotated frame to its edge, so the alternates
    hold rows that repeat each other to within an ulp."""
    from unittest import mock

    from multi_frame_super_resolution_tpu_torch.config import RAW_SCALE4
    from multi_frame_super_resolution_tpu_torch.data import CITY_ANGLES, mosaic_rggb, synthetic_rgb_burst
    from multi_frame_super_resolution_tpu_torch.models import handheld
    from multi_frame_super_resolution_tpu_torch.registration import align

    angles = (CITY_ANGLES + CITY_ANGLES[1:])[:frames]
    rgb, _ = synthetic_rgb_burst(np.random.default_rng(seed), frames, h, w, 3.0, angles=angles)
    raw = torch.from_numpy(np.stack([mosaic_rggb(f, RAW_SCALE4.cfa_pattern) for f in rgb]))
    calls = []
    search = align.tile_search

    def record(ref, alts, rounded, t, radius, threshold, subpixel, mode):
        assert mode == "image"
        calls.append((ref.clone(), alts.clone(), rounded.clone(), t, radius, threshold))
        return search(ref, alts, rounded, t, radius, threshold, subpixel, mode)

    class _Aligned(Exception):
        pass

    def stop(*args, **kwargs):
        raise _Aligned

    with mock.patch.object(align, "tile_search", record), mock.patch.object(handheld, "tile_warp", stop):
        with pytest.raises(_Aligned):
            handheld.handheld_superres_raw(raw, RAW_SCALE4, device="cpu")
    return calls


ROOT = pathlib.Path(__file__).resolve().parents[1]


def city_hr_raw_burst(frames: int, factor: int, h: int = 256, w: int = 512, seed: int = 7):
    """A true-HR RAW burst: the top-left h x w crop of the tracked
    city_handheld_sr.png as the high-resolution scene, through
    tools/eval_fidelity.py::make_hr_burst (subpixel shifts of up to
    1.5 factor HR px and rotations of up to 0.01 rad, ``factor``-x box
    downsample, RGGB mosaic). Returns (F, h/factor, w/factor) float32
    numpy. Needs JAX (make_hr_burst runs the JAX package's downsample)."""
    import imageio.v3 as iio

    sys.path.insert(0, str(ROOT / "tools"))
    try:
        from eval_fidelity import make_hr_burst
    finally:
        sys.path.remove(str(ROOT / "tools"))
    hr = iio.imread(ROOT / "city_handheld_sr.png")[:h, :w, :3].astype(np.float32) / 255.0
    raw, _ = make_hr_burst(hr, num_frames=frames, seed=seed, max_shift_hr=1.5 * factor, factor=factor)
    return raw.astype(np.float32)


def cuda_device() -> torch.device:
    """The card for a test marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    return torch.device("cuda", 0)
