"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same numpy input goes through the JAX function and its counterpart
in multi_frame_super_resolution_tpu_torch; the outputs come back as
numpy and are compared with a stated tolerance.

Importing this module pins torch to one thread (the suite runs several
xdist workers on few cores) and turns TF32 off, so that a test run on a
card compares in full float32.
"""

import dataclasses

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
    windows = tiles.extract_search_windows(
        tt(alts).double(), tile_size, radius, tt(rounded).to(torch.int32)
    )
    ref_tiles = tiles.extract_ref_tiles(tt(ref).double(), tile_size)
    s = 2 * radius + 1
    ssd = torch.stack([
        ((windows[..., u : u + tile_size, v : v + tile_size] - ref_tiles) ** 2).sum((-2, -1))
        for u in range(s) for v in range(s)
    ], dim=-1)
    return nn((ssd == ssd.amin(-1, keepdim=True)).sum(-1) > 1)


def cuda_device() -> torch.device:
    """The card for a test marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    return torch.device("cuda", 0)
