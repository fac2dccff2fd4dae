"""The RAW plane-domain order-1 merge (certless plugin branch): its plain
PyTorch version against the JAX merge_burst_raw_planes, and the kernel
wrapper's contract on the CPU. The Hopper kernel is held against the
plain version on the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nn, tt

from multi_frame_super_resolution_tpu.models import fast_merge as jfm
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels.merge_raw import (
    is_bayer,
    merge_raw,
    merge_raw_plain,
    tap_halo,
    tap_table,
)
from multi_frame_super_resolution_tpu_torch.models import fast_merge


def _inputs(rng, f, hh, hw, rb_wider=False):
    """Random merge inputs as tests/test_pallas_ops.py makes them, on CFA
    planes; residual in RAW units up to +-2 so the clip is exercised."""
    planes = rng.random((f, 2, 2, hh, hw)).astype(np.float32)
    residual = ((rng.random((f, hh, hw, 2)) - 0.5) * 4.0).astype(np.float32)
    certainty = rng.random((f, hh, hw, 3)).astype(np.float32)
    omega = (0.5 + rng.random((hh, hw, 3))).astype(np.float32)
    omega[..., 2] *= 0.1  # keep the quadratic PSD-ish
    omega_rb = (omega * 0.5) if rb_wider else omega.copy()
    return planes, residual, certainty, omega, omega_rb.astype(np.float32)


def test_active_taps_with_prune_exp():
    for prune in (6.0, 3.0, 1.5, 1.0):
        for r, rb, s, k in ((2, 1.0, 2, 1.0), (3, 1.0, 2, 4.0), (1, 0.5, 3, 0.25)):
            assert fast_merge._active_taps(r, rb, s, k, prune) == jfm._active_taps(r, rb, s, k, prune)
    # the RAW path's taps: radius 1 + residual bound 1 at e^-1.5
    assert len(fast_merge._active_taps(2, 1.0, 2, 1.0, 1.5)) == 21


@pytest.mark.parametrize(
    "cfa,radius,prune,rb_wider",
    [
        (((0, 1), (1, 2)), 1, 1.5, False),
        (((0, 1), (1, 2)), 1, 1.5, True),
        (((2, 1), (1, 0)), 2, 6.0, True),
        (((1, 0), (2, 1)), 1, 3.0, False),
    ],
)
def test_plain_raw_merge_matches_jax(cfa, radius, prune, rb_wider):
    """F = 3 at 16 x 24 half-res, certless order-1 (m00, cy, cx, b0): sums
    of up to F * |taps| f32 terms; rtol and atol 1e-5."""
    ins = _inputs(np.random.default_rng(radius), 3, 16, 24, rb_wider)
    want = jfm.merge_burst_raw_planes(
        *map(jnp.asarray, ins), cfa, 2, radius, residual_bound=1.0, k_max=1.0,
        phase_output=True, order=1, prune_exp=prune, moment_slots=4, centroid_cert=False,
    )
    LAUNCHES.clear()
    got = merge_raw(*map(tt, ins), cfa, 2, radius, 1.0, 1.0, prune)
    assert not LAUNCHES  # CPU tensors take the plain version
    assert len(got) == len(want) == 4
    for name, g, w_ in zip(("m00", "cy", "cx", "b0"), got, want):
        assert g.shape == (4, 4, 3, 16, 24), name
        np.testing.assert_allclose(nn(g), nn(w_), rtol=1e-5, atol=1e-5, err_msg=name)


def test_wrapper_on_cpu_is_the_plain_version(rng):
    ins = [tt(x) for x in _inputs(rng, 2, 8, 10)]
    cfa = ((0, 1), (1, 2))
    got = merge_raw(*ins, cfa, 2, 1, 1.0, 1.0, 1.5)
    want = merge_raw_plain(*ins, cfa, 2, 1, 1.0, 1.0, 1.5)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)


def test_wrapper_on_cpu_takes_any_pattern(rng):
    """Only the kernel is limited to Bayer patterns: on CPU tensors the
    wrapper computes the plain version for any 2 x 2 pattern."""
    ins = [tt(x) for x in _inputs(rng, 2, 8, 10)]
    cfa = ((0, 1), (1, 1))
    assert not is_bayer(cfa)
    got = merge_raw(*ins, cfa, 2, 1, 1.0, 1.0, 1.5)
    want = merge_raw_plain(*ins, cfa, 2, 1, 1.0, 1.0, 1.5)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)


def _plane_of(z, g):
    """csrc/merge_raw.cu::plane_of: the plane parity z reads in group g."""
    return 2 * ((z // 2 + g // 2) % 2) + (z % 2 + g % 2) % 2


@pytest.mark.parametrize("cfa", [((0, 1), (1, 2)), ((2, 1), (1, 0)), ((1, 0), (2, 1)), ((1, 2), (0, 1))])
def test_tap_table(cfa):
    """The table holds the plane channels, the group ends and every tap,
    sorted by tap parity g = 2*(ky%2) + (kx%2) in list order within a
    group, with its centroid bit (all set without centroid_prune) and
    its index in the list (the bfloat16 order-0 loop's order; the
    prune's bits are checked in test_torch_knob_merge.py). The kernel's
    reading of it matches the JAX loop: in group g
    parity z reads plane ((a+ky)%2, (b+kx)%2) = _plane_of(z, g), and
    the cell each pair {0, 3}, {1, 2} completes reads the chain that pair
    feeds: green cells the pair's ("g", (ky+kx)%2), an R or B cell the
    ("rb", ky%2, kx%2) of the group that read it."""
    taps = fast_merge._active_taps(2, 1.0, 2, 1.0, 1.5)
    table = tap_table(tuple(taps), cfa)
    chan, ends, rows3 = table[:4], table[4:8], table[8:].reshape(-1, 3)
    rows, aux = rows3[:, :2], rows3[:, 2]
    assert list(chan) == [cfa[0][0], cfa[0][1], cfa[1][0], cfa[1][1]]
    want = sorted(taps, key=lambda t: 2 * (t[0] % 2) + t[1] % 2)  # stable
    assert [tuple(r) for r in rows] == want
    assert (aux % 2 == 1).all()
    assert [taps[n] for n in aux // 2] == want
    assert list(ends) == list(np.cumsum([sum(2 * (t[0] % 2) + t[1] % 2 == g for t in taps) for g in range(4)]))
    for t, (ky, kx) in enumerate(rows):
        g = int(np.searchsorted(ends, t, side="right"))
        assert g == 2 * (ky % 2) + kx % 2
        for z in range(4):
            a, b = divmod(z, 2)
            assert _plane_of(z, g) == 2 * ((a + ky) % 2) + (b + kx) % 2
    for pair, groups in enumerate(((0, 3), (1, 2))):
        for z in range(4):
            a, b = divmod(z, 2)
            read = [int(chan[_plane_of(z, g)]) for g in groups]
            if read == [1, 1]:
                assert fast_merge._centroid_chain(cfa, a, b, 1) == ("g", pair)
            else:
                assert sorted(read) == [0, 2]
                for g, ch in zip(groups, read):
                    assert fast_merge._centroid_chain(cfa, a, b, ch) == ("rb", g // 2, g % 2)


@pytest.mark.parametrize("radius,k_max,prune", [(1, 1.0, 1.5), (2, 4.0, 6.0)], ids=["halo1", "halo2"])
@pytest.mark.parametrize("cfa", [((0, 1), (1, 2)), ((2, 1), (1, 0)), ((1, 0), (2, 1)), ((1, 2), (0, 1))])
def test_tap_table_cells_kernel_reading(cfa, radius, k_max, prune):
    """merge_raw_cells_kernel's reading of the table, against a direct
    count over taps and parities. Relabelled z' = z ^ flip with flip =
    pair ^ !green_diag: in both groups of a pair z' = 0 and 3 read green,
    z' = 1 and 2 read R and B, so each of the 12 cells (parity, channel)
    is fed by exactly one (pair, z', group) of the kernel's six cells a
    pair. Within a group, the site each parity reads sits at a fixed
    offset from the site z' = 0 reads (the kernel keeps four numbers a
    group), at any staged row length and plane stride."""
    taps = fast_merge._active_taps(radius + 1, 1.0, 2, k_max, prune)
    table = tap_table(tuple(taps), cfa)
    chan, ends, rows = table[:4], table[4:8], table[8:].reshape(-1, 3)[:, :2]
    green_diag = chan[0] == 1 and chan[3] == 1
    halo = tap_halo(taps)
    sw, sa = 8 + 2 * halo, (2 + 2 * halo) * (8 + 2 * halo)  # CellTile<4, 1>'s staging
    fed = {}
    for pair, groups in enumerate(((0, 3), (1, 2))):
        flip = pair ^ (0 if green_diag else 1)
        for k, g in enumerate(groups):
            group_taps = [tuple(r) for r in rows[(ends[g - 1] if g else 0):ends[g]]]
            assert all(2 * (ky % 2) + kx % 2 == g for ky, kx in group_taps)
            offsets = set()
            for ky, kx in group_taps:
                site = []
                for zp in range(4):
                    z = zp ^ flip
                    a, b = divmod(z, 2)
                    ch = int(chan[_plane_of(z, g)])
                    assert (ch == 1) == (zp in (0, 3))
                    cell = zp if zp in (0, 3) else (zp, k)
                    fed.setdefault((z, ch), set()).add((pair, cell))
                    site.append(_plane_of(z, g) * sa + (a + ky) // 2 * sw + (b + kx) // 2)
                offsets.add(tuple(o - site[0] for o in site))
            assert len(offsets) <= 1
    assert sorted(fed) == [(z, ch) for z in range(4) for ch in range(3)]
    assert all(len(owners) == 1 for owners in fed.values())


def test_tap_halo_and_bayer():
    assert tap_halo(fast_merge._active_taps(2, 1.0, 2, 1.0, 1.5)) == 1
    assert tap_halo(fast_merge._active_taps(3, 1.0, 2, 4.0, 6.0)) == 2
    assert tap_halo([(0, 0)]) == 1
    assert all(is_bayer(c) for c in (((0, 1), (1, 2)), ((2, 1), (1, 0)), ((1, 0), (2, 1)), ((1, 2), (0, 1))))
    assert not any(is_bayer(c) for c in (((0, 1), (1, 1)), ((1, 1), (0, 2)), ((0, 0), (1, 2))))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "omega_rb"])
def test_wrapper_rejects_bad_inputs(rng, bad):
    planes, residual, cert, omega, omega_rb = [tt(x) for x in _inputs(rng, 2, 8, 10)]
    if bad == "dtype":
        planes = planes.double()
    elif bad == "shape":
        residual = residual[..., :1]
    elif bad == "contiguity":
        cert = cert.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        omega_rb = omega_rb[:4]
    with pytest.raises((TypeError, ValueError)):
        merge_raw(planes, residual, cert, omega, omega_rb, ((0, 1), (1, 2)), 2, 1, 1.0, 1.0, 1.5)


@pytest.mark.parametrize("scale", [1, 3, 4])
def test_plain_raw_merge_matches_jax_at_scale(scale):
    """Scales 1, 3 (odd phase offsets) and 4, k_max scaled by (s/2)^2 and
    R/B kernels wider, as the scale-4 configuration runs them; F = 3 at
    12 x 20 half-res; rtol and atol 1e-5."""
    ins = _inputs(np.random.default_rng(scale), 3, 12, 20, rb_wider=True)
    cfa = ((0, 1), (1, 2))
    k_max = (scale / 2.0) ** 2
    want = jfm.merge_burst_raw_planes(
        *map(jnp.asarray, ins), cfa, scale, 1, residual_bound=1.0, k_max=k_max,
        phase_output=True, order=1, prune_exp=1.5, moment_slots=4, centroid_cert=False,
    )
    LAUNCHES.clear()
    got = merge_raw(*map(tt, ins), cfa, scale, 1, 1.0, k_max, 1.5)
    assert not LAUNCHES
    for name, g, w_ in zip(("m00", "cy", "cx", "b0"), got, want):
        assert g.shape == (2 * scale, 2 * scale, 3, 12, 20), name
        np.testing.assert_allclose(nn(g), nn(w_), rtol=1e-5, atol=1e-5, err_msg=name)
