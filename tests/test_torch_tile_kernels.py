"""The tile-warp and tile-window kernels' plain versions against the JAX
package: the block map against the Pallas tile warp (interpret mode), the
separable map against the selector-matmul warp, the windows against
extract_search_windows and the Pallas tile gather. Each wrapper on CPU
tensors is its plain version and launches nothing; the Hopper kernels
are held against these on the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, tt

from multi_frame_super_resolution_tpu.ops.warp_fast import tile_warp_matmul as jax_tile_warp_matmul
from multi_frame_super_resolution_tpu.pallas_ops.tile_gather import tile_gather_pallas
from multi_frame_super_resolution_tpu.pallas_ops.tile_warp import tile_warp_pallas
from multi_frame_super_resolution_tpu.registration.tiles import (
    extract_search_windows as jax_extract_search_windows,
)
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels.tile_gather import tile_gather
from multi_frame_super_resolution_tpu_torch.kernels.tile_warp import (
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
    LAUNCHES.clear()
    got = nn(tile_gather(tt(imgs), tt(shifts), 16, 4))
    assert not LAUNCHES
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
    got = nn(tile_gather(tt(imgs), tt(shifts), 16, 4))
    assert got.shape == want.shape == (2, 4, 6, 24, 24)
    np.testing.assert_array_equal(got[:, 1:-1, 1:-1], want[:, 1:-1, 1:-1])


def test_plain_windows_are_extract_search_windows():
    rng = np.random.default_rng(1)
    imgs = tt(rng.random((2, 40, 56)).astype(np.float32))
    shifts = tt(rng.integers(-5, 6, (2, 3, 4, 2)).astype(np.int32))
    torch.testing.assert_close(
        tile_gather(imgs, shifts, 16, 3),
        tiles.extract_search_windows(imgs, 16, 3, shifts),
        rtol=0, atol=0,
    )


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


@pytest.mark.parametrize("bad", ["dtype", "shape", "pad"])
def test_tile_gather_rejects_bad_inputs(bad):
    imgs = torch.zeros((2, 32, 48))
    shifts = torch.zeros((2, 2, 3, 2), dtype=torch.int32)
    pad = 4
    if bad == "dtype":
        shifts = shifts.float()
    elif bad == "shape":
        imgs = imgs[None]
    else:
        pad = -1
    with pytest.raises((TypeError, ValueError)):
        tile_gather(imgs, shifts, 16, pad)
