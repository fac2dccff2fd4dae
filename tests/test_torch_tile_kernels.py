"""The tile-warp and tile-search kernels' plain versions against the JAX
package: the block map against the Pallas tile warp (interpret mode), the
separable map against the selector-matmul warp, the search windows of
"tile" mode against extract_search_windows and the Pallas tile gather, a
transcription of the kernel's "image"-mode window loader against the
windows ssd_surface_image reads. Each wrapper on CPU tensors is its plain
version and launches nothing; the Hopper kernels are held against these
on the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, tt

from multi_frame_super_resolution_tpu.ops.warp_fast import tile_warp_matmul as jax_tile_warp_matmul
from multi_frame_super_resolution_tpu.ops.warp_fast import tile_warp_select as jax_tile_warp_select
from multi_frame_super_resolution_tpu.pallas_ops.tile_gather import tile_gather_pallas
from multi_frame_super_resolution_tpu.pallas_ops.tile_warp import tile_warp_pallas
from multi_frame_super_resolution_tpu.registration.tiles import (
    extract_search_windows as jax_extract_search_windows,
)
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels.tile_search import tile_search
from multi_frame_super_resolution_tpu_torch.kernels.tile_warp import (
    floor_magic,
    tile_warp,
    tile_warp_block,
)
from multi_frame_super_resolution_tpu_torch.ops import warp_fast
from multi_frame_super_resolution_tpu_torch.registration import tiles


@pytest.mark.parametrize("amp", [5, 20])
def test_block_map_matches_pallas_tile_warp(amp):
    """Every tile, block origins clamped at the borders; exact."""
    rng = np.random.default_rng(amp)
    imgs = rng.random((3, 64, 128)).astype(np.float32)
    shifts = rng.integers(-amp, amp + 1, (3, 4, 8, 2)).astype(np.int32)
    want = nn(tile_warp_pallas(jnp.asarray(imgs), jnp.asarray(shifts), 16, interpret=True))
    LAUNCHES.clear()
    got = nn(tile_warp_block(tt(imgs)[:, None], tt(shifts), 16))[:, 0]
    assert not LAUNCHES
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "h,w,t,amp,bound",
    [(64, 128, 16, 20, 16), (128, 256, 16, 5, 16), (50, 70, 16, 20, 16), (40, 72, 8, 9, 6)],
)
def test_separable_map_matches_tile_warp_matmul(h, w, t, amp, bound):
    """Shifts beyond the bound exercise the clip; H and W that are not tile
    multiples exercise the clamps at the real edge. Exact: every output is
    one input value."""
    rng = np.random.default_rng(h + w)
    imgs = rng.random((2, 4, h, w)).astype(np.float32)
    nty, ntx = -(-h // t), -(-w // t)
    shifts = rng.integers(-amp, amp + 1, (2, nty, ntx, 2)).astype(np.int32)
    got = nn(tile_warp(tt(imgs), tt(shifts), t, bound))
    for i in range(2):
        want = nn(jax_tile_warp_matmul(jnp.asarray(imgs[i]), jnp.asarray(shifts[i]), t, bound))
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("bound", [6, 16, 30])
def test_floor_magic_is_floor_division(bound):
    """The one-hot kernel's floor division by its coarse step, a multiply-
    high by floor_magic's numbers, is Python's floor division for every
    clipped shift in [-bound, bound] (at bound 6 the kernel selects
    directly; the step it would take, 4, is checked all the same)."""
    c = max(2, int(np.round(np.sqrt(2 * bound + 1))))
    assert warp_fast.onehot_coarse(bound) == (0 if bound == 6 else c)
    k, m = floor_magic(c, bound)
    assert 0 < m < 1 << 64
    for v in range(-bound, bound + 1):
        assert v + c * k >= 0
        assert (((v + c * k) * m) >> 64) - k == v // c


def test_plain_separable_map_is_the_matmul_form():
    rng = np.random.default_rng(3)
    imgs = tt(rng.random((2, 3, 32, 48)).astype(np.float32))
    shifts = tt(rng.integers(-20, 21, (2, 2, 3, 2)).astype(np.int32))
    torch.testing.assert_close(
        tile_warp(imgs, shifts, 16), warp_fast.tile_warp_matmul(imgs, shifts, 16), rtol=0, atol=0
    )


@pytest.mark.parametrize("h,w,amp", [(64, 96, 3), (50, 70, 6)])
def test_windows_match_extract_search_windows(h, w, amp):
    """Per-pixel clamping everywhere, ragged tile grids included; exact."""
    rng = np.random.default_rng(h)
    imgs = rng.random((3, h, w)).astype(np.float32)
    shifts = rng.integers(-amp, amp + 1, (3, -(-h // 16), -(-w // 16), 2)).astype(np.int32)
    got = nn(tiles.extract_search_windows_batched(tt(imgs), 16, 4, tt(shifts)))
    for i in range(3):
        want = nn(jax_extract_search_windows(
            jnp.asarray(imgs[i]), 16, 4, jnp.asarray(shifts[i], jnp.float32)
        ))
        np.testing.assert_array_equal(got[i], want)


def test_windows_match_pallas_tile_gather_on_interior_tiles():
    """tile_gather_pallas clamps whole blocks; on interior tiles with shifts
    within +-3 no clamp acts, and the two are the same copy."""
    rng = np.random.default_rng(0)
    imgs = rng.random((2, 64, 96)).astype(np.float32)
    shifts = rng.integers(-3, 4, (2, 4, 6, 2)).astype(np.int32)
    want = nn(tile_gather_pallas(jnp.asarray(imgs), jnp.asarray(shifts), 16, 4, interpret=True))
    got = nn(tiles.extract_search_windows_batched(tt(imgs), 16, 4, tt(shifts)))
    assert got.shape == want.shape == (2, 4, 6, 24, 24)
    np.testing.assert_array_equal(got[:, 1:-1, 1:-1], want[:, 1:-1, 1:-1])


def _search_case(seed=1, h=40, w=56, t=16):
    rng = np.random.default_rng(seed)
    ref = tt(rng.random((h, w)).astype(np.float32))
    alts = tt(rng.random((2, h, w)).astype(np.float32))
    rounded = tt(rng.integers(-20, 21, (2, -(-h // t), -(-w // t), 2)).astype(np.float32))
    return ref, alts, rounded


def test_plain_windows_are_extract_search_windows():
    """The wrapper on CPU tensors, "tile" mode: the search over
    extract_search_windows at the rounded prediction; no launch."""
    ref, alts, rounded = _search_case()
    windows = tiles.extract_search_windows_batched(alts, 16, 3, rounded.to(torch.int32))
    ssd = tiles.ssd_surface(tiles.extract_ref_tiles(ref, 16), windows, 3)
    LAUNCHES.clear()
    got = tile_search(ref, alts, rounded, 16, 3, 0.0, True, "tile")
    assert not LAUNCHES
    torch.testing.assert_close(got, rounded + tiles.find_min_shift(ssd, 3), rtol=0, atol=0)


def test_plain_image_search_is_the_fast_branch():
    """The wrapper on CPU tensors, "image" mode: the search over the
    alternates tile-warped by the rounded prediction; no launch."""
    ref, alts, rounded = _search_case(2)
    warped = warp_fast.tile_warp_select(alts, rounded.to(torch.int32), 16)
    ssd = tiles.ssd_surface_image(ref, warped, 16, 4)
    LAUNCHES.clear()
    got = tile_search(ref, alts, rounded, 16, 4, 0.05, False, "image")
    assert not LAUNCHES
    torch.testing.assert_close(got, rounded + tiles.find_min_shift(ssd, 4, 0.05, False), rtol=0, atol=0)


def kernel_image_windows(alts, rounded, t, radius):
    """A transcription, index for index, of csrc/tile_search.cu's
    "image"-mode window loader (warp_source): window (a, b) of tile
    (ty, tx) reads the alternate at the source that
    tile_warp_select(alt, rounded, t, bound=16) gives pixel
    (clip(ty*t + a - R), clip(tx*t + b - R)); the general search's
    loader (warp_source_rt) is the same with t a runtime argument. numpy
    in and out."""
    n, h, w = alts.shape
    t2 = t + 2 * radius
    ints = rounded.astype(np.int64)
    k = np.arange(n)[:, None, None, None, None]
    y = np.clip(np.arange(rounded.shape[1])[:, None, None, None] * t + np.arange(t2)[:, None] - radius, 0, h - 1)
    x = np.clip(np.arange(rounded.shape[2])[:, None, None] * t + np.arange(t2) - radius, 0, w - 1)

    def shift(yy, xx, c):  # the tile's shift, clipped to the warp's bound
        return np.clip(ints[k, yy // t, xx // t, c], -16, 16)

    def coarse(s):  # floor(s / 6) for |s| <= 16, as the kernel forms it
        return (s + 18) // 6 - 3

    s = shift(y, x, 1)
    pr = x + s - 6 * coarse(s)
    xs = np.clip(pr + 6 * coarse(shift(y, np.minimum(pr, w - 1), 1)), 0, w - 1)
    s = shift(y, xs, 0)
    pr = y + s - 6 * coarse(s)
    ys = np.clip(pr + 6 * coarse(shift(np.minimum(pr, h - 1), xs, 0)), 0, h - 1)
    return alts[k, ys, xs]


@pytest.mark.parametrize(
    "h,w,t,radius",
    [(128, 256, 16, 4), (72, 100, 16, 4), (72, 100, 32, 9), (50, 70, 8, 5), (66, 90, 12, 4), (40, 56, 16, 0)],
)
def test_image_window_loader_matches_padded_tile_warp(h, w, t, radius):
    """The kernels' "image"-mode windows (T = 12 and radius 0: the general
    search's) equal, bit for bit, those that ssd_surface_image reads: the JAX tile_warp_select output, edge-padded
    to the tile grid and by R. Shifts up to 24 pass the warp's +-16 clip
    and its two-level decomposition's tile-crossing bands."""
    rng = np.random.default_rng(h + t)
    alts = rng.random((3, h, w)).astype(np.float32)
    nty, ntx = -(-h // t), -(-w // t)
    rounded = rng.integers(-24, 25, (3, nty, ntx, 2)).astype(np.float32)
    got = kernel_image_windows(alts, rounded, t, radius)
    rows = (np.arange(nty) * t)[:, None, None, None] + np.arange(t + 2 * radius)[:, None]
    cols = (np.arange(ntx) * t)[:, None, None] + np.arange(t + 2 * radius)
    for i in range(3):
        warped = nn(jax_tile_warp_select(jnp.asarray(alts[i]), jnp.asarray(rounded[i], jnp.int32), t))
        padded = np.pad(np.pad(warped, ((0, nty * t - h), (0, ntx * t - w)), mode="edge"), radius, mode="edge")
        np.testing.assert_array_equal(got[i], padded[rows, cols])


@pytest.mark.parametrize("bad", ["dtype", "shift_dtype", "shape", "contiguity", "block_ragged"])
def test_tile_warp_rejects_bad_inputs(bad):
    imgs = torch.zeros((2, 3, 32, 48))
    shifts = torch.zeros((2, 2, 3, 2), dtype=torch.int32)
    warp = tile_warp
    if bad == "dtype":
        imgs = imgs.double()
    elif bad == "shift_dtype":
        shifts = shifts.long()
    elif bad == "shape":
        shifts = shifts[:, :1]
    elif bad == "contiguity":
        imgs = imgs.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        imgs = torch.zeros((2, 3, 40, 48))
        shifts = torch.zeros((2, 3, 3, 2), dtype=torch.int32)
        warp = tile_warp_block
    with pytest.raises((TypeError, ValueError)):
        warp(imgs, shifts, 16)


@pytest.mark.parametrize("bad", ["dtype", "shape", "radius", "ref_shape", "contiguity", "mode"])
def test_tile_search_rejects_bad_inputs(bad):
    ref = torch.zeros((32, 48))
    alts = torch.zeros((2, 32, 48))
    rounded = torch.zeros((2, 2, 3, 2))
    radius, mode = 4, "image"
    if bad == "dtype":
        rounded = rounded.to(torch.int32)
    elif bad == "shape":
        alts = alts[None]
    elif bad == "radius":
        radius = -1
    elif bad == "ref_shape":
        ref = ref[:16]
    elif bad == "contiguity":
        rounded = rounded.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        mode = "fft"
    with pytest.raises((TypeError, ValueError)):
        tile_search(ref, alts, rounded, 16, radius, 0.0, True, mode)
