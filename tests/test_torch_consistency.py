"""The registration extras: ssd_surface_fft, the shift-consistency solve
(registration/global_shift.py), align_pair with the FFT surfaces and
align_burst_consistent, against the JAX functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, to_jax, tt

from multi_frame_super_resolution_tpu.data import synthetic_burst
from multi_frame_super_resolution_tpu.ops.geometry import translate
from multi_frame_super_resolution_tpu.registration import align as jalign
from multi_frame_super_resolution_tpu.registration import global_shift as jgs
from multi_frame_super_resolution_tpu.registration import tiles as jtiles
from multi_frame_super_resolution_tpu_torch.config import AlignConfig
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.registration import align, global_shift, tiles

# px: subpixel shifts of two float32 searches on a tile whose argmin both
# share, beyond the fit's own movement under the rounding bound
SHIFT_SLACK = 1e-3


@pytest.mark.parametrize("t,r", [(8, 2), (16, 4), (8, 6), (16, 12)])
def test_ssd_surface_fft_matches_jax(t, r):
    """The FFT route against the JAX function within 1e-4 of the
    surface's scale (relative: the two FFT libraries round differently),
    and against the direct surface within 2e-3 (the JAX test's own
    limit, test_registration.py:215-222)."""
    rng = np.random.default_rng(t + r)
    ref = rng.random((3, 2, t, t)).astype(np.float32)
    win = rng.random((3, 2, t + 2 * r, t + 2 * r)).astype(np.float32)
    got = nn(tiles.ssd_surface_fft(tt(ref), tt(win), r))
    want = np.asarray(jtiles.ssd_surface_fft(jnp.asarray(ref), jnp.asarray(win), r))
    assert got.shape == (3, 2, 2 * r + 1, 2 * r + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    direct = nn(tiles.ssd_surface(tt(ref), tt(win), r))
    np.testing.assert_allclose(got, direct, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("frames,span", [(5, 2), (4, 3), (2, 2)])
def test_measurement_pairs_and_design_matrix_match_jax(frames, span):
    pairs = global_shift.measurement_pairs(frames, span)
    assert pairs == jgs.measurement_pairs(frames, span)
    np.testing.assert_array_equal(global_shift.design_matrix(frames, pairs), jgs.design_matrix(frames, pairs))


def _chain_measurements(rng, frames, nty, ntx, outliers):
    """Pair measurements of a true consecutive chain with 0.05 px noise,
    and ``outliers`` of them per tile replaced by values 3-6 px off, so
    that the removal rounds act."""
    pairs = global_shift.measurement_pairs(frames)
    true = rng.uniform(-3.0, 3.0, (frames - 1, nty, ntx, 2))
    a = global_shift.design_matrix(frames, pairs)
    measured = np.einsum("pk,knmc->pnmc", a, true) + rng.normal(0.0, 0.05, (len(pairs), nty, ntx, 2))
    for y in range(nty):
        for x in range(ntx):
            for p in rng.choice(len(pairs), outliers, replace=False):
                measured[p, y, x] += rng.choice([-1, 1], 2) * rng.uniform(3.0, 6.0, 2)
    return pairs, true.astype(np.float32), measured.astype(np.float32)


@pytest.mark.parametrize("outliers", [0, 1, 2])
def test_solve_consistent_shifts_matches_jax(outliers):
    """F = 5 (7 pairs, 3 removal rounds) on a 6 x 7 tile grid: the solved
    chain within 1e-4 px of the JAX function's and the surviving
    measurements identical, with 0, 1 or 2 planted outliers per tile;
    with one outlier the solve recovers the true chain within 0.25 px (5
    times the noise) wherever one measurement was dropped."""
    rng = np.random.default_rng(outliers)
    frames = 5
    pairs, true, measured = _chain_measurements(rng, frames, 6, 7, outliers)
    got_s, got_w = global_shift.solve_consistent_shifts(tt(measured), frames, pairs)
    want_s, want_w = jax.jit(lambda m: jgs.solve_consistent_shifts(m, frames, tuple(pairs)))(jnp.asarray(measured))
    np.testing.assert_array_equal(nn(got_w), np.asarray(want_w))
    np.testing.assert_allclose(nn(got_s), np.asarray(want_s), rtol=0, atol=1e-4)
    dropped = (nn(got_w) == 0).sum(0)
    if outliers == 0:
        assert not dropped.any()
    else:
        assert dropped.any()  # the removal rounds ran
    if outliers == 1:
        ok = dropped == 1
        assert ok.mean() > 0.5
        np.testing.assert_allclose(nn(got_s)[:, ok], true[:, ok], atol=0.25)


def test_shifts_to_reference_matches_jax():
    consecutive = np.random.default_rng(0).normal(0.0, 2.0, (4, 3, 5, 2)).astype(np.float32)
    for ref in range(5):
        got = nn(global_shift.shifts_to_reference(tt(consecutive), ref))
        want = np.asarray(jgs.shifts_to_reference(jnp.asarray(consecutive), ref))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert (got[ref] == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_align_pair_fft_matches_jax(seed):
    """align_pair with the FFT surfaces at R = 12, T = 16, one level
    (test_registration.py:224-237's case: a 96 x 96 frame translated by
    (-9, 11)). The tiles whose argmin float32 rounding decides
    (tiles.fft_undecided) are left out, a quarter at most (measured 3-7
    of 36, the edge column whose windows reach past the frame); on the
    others the port's shift is within SHIFT_SLACK plus the fit's movement
    under the rounding bound of the JAX function's. The inner tiles find
    the translation as the JAX test asks (0.35 px)."""
    rng = np.random.default_rng(seed)
    burst, _ = synthetic_burst(rng, num_frames=1, height=96, width=96, max_shift=3.0)
    img = jnp.asarray(burst[0])
    moved = translate(img, -9.0, 11.0)
    cfg = AlignConfig(tile_size=16, search_radius=12, levels=1, use_fft=True)
    want = np.asarray(jax.jit(lambda a, b: jalign.align_pair(a, b, to_jax(cfg)))(img, moved))
    LAUNCHES.clear()
    got = nn(align.align_pair(tt(img), tt(moved), cfg))
    assert not LAUNCHES  # the FFT branch runs no tile search
    undecided, moved_px = tiles.fft_undecided(tt(img), tt(moved)[None], torch.zeros((1, 6, 6, 2)), 16, 12)
    keep = ~nn(undecided[0])
    assert keep.mean() >= 0.75
    slack = SHIFT_SLACK + nn(moved_px[0])
    assert (np.abs(got - want).max(-1) <= slack)[keep].all()
    inner = got[1:-1, 1:-1]
    np.testing.assert_allclose(inner[..., 0], 9.0, atol=0.35)
    np.testing.assert_allclose(inner[..., 1], -11.0, atol=0.35)


def test_align_burst_consistent_matches_jax(monkeypatch):
    """The consistency alignment of a 4-frame 96 x 96 burst
    (test_registration.py:393-405's case, T = 16, R = 4, two levels)
    against the JAX function within 1e-3 px, and each frame's mean inner
    shift within 0.25 px of the truth as the JAX test asks. The pairs of
    one first frame share an align_frames call: 3 calls, 2 levels each."""
    burst, true_shifts = synthetic_burst(np.random.default_rng(4), num_frames=4, height=96, width=96, max_shift=2.0)
    cfg = AlignConfig(tile_size=16, search_radius=4, levels=2)
    want = np.asarray(jax.jit(lambda b: jalign.align_burst_consistent(b, to_jax(cfg)))(jnp.asarray(burst)))
    calls = []
    search = align.tile_search

    def counted(*args):
        calls.append(args[1].shape[0])
        return search(*args)

    monkeypatch.setattr(align, "tile_search", counted)
    got = nn(align.align_burst_consistent(tt(burst), cfg))
    assert calls == [2, 2, 2, 2, 1, 1]  # alternates per launch: frames 0, 1, 2 as references
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[0], 0.0, atol=1e-5)
    for f in range(1, 4):
        np.testing.assert_allclose(got[f, 1:-1, 1:-1].mean(axis=(0, 1)), -true_shifts[f], atol=0.25)
