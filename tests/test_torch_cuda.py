"""Tests of the port that need the card: each Hopper kernel (RGB merge in
its five forms, tile warp in its three index maps, tile search, RAW
merge in its four forms at scales 1-4, guided or not, with the merge
knobs' variants, defog; the general forms of the two merges and the
search past the templated kernels) against its plain PyTorch version,
and the RGB, RAW (fast and oracle, with every handheld knob the port
runs), defog and BTV-L1 paths and single-image DNN SR (the bundled
checkpoints' inference, a train step) on the card against the port on
the CPU, the port's former limits among them; the multi-device
layer on the card (batched bursts, the row-sharded RAW path) and the
native reader's build status. They skip without a CUDA device.

This file imports no JAX, so the GPU host (which has none) runs it
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses
import functools
import pathlib

import numpy as np
import pytest
import torch
from torch_parity import (
    BIG_SHIFTS,
    SMALL_SHIFTS,
    cuda_device,
    nn,
    prealigned_search_inputs,
    psnr,
    search_inputs,
    tied_minima,
    tt,
    ulp_perturbed,
)

from multi_frame_super_resolution_tpu_torch.apps.dnn_sr import train_data
from multi_frame_super_resolution_tpu_torch.config import (
    PORT_DEFAULT,
    RAW_BENCH,
    RAW_CERT,
    RAW_CONSISTENT,
    RAW_EXACT,
    RAW_FFT,
    RAW_GUIDED,
    RAW_ORACLE,
    RAW_ORDER0,
    RAW_PORT_DEFAULT,
    RAW_SCALE4,
    RGB_CONSISTENT,
    RGB_DEFAULT,
    RGB_DEFAULT_NOPRE,
    RGB_EXACT,
    RGB_ORACLE,
    RGB_PALLAS,
    AlignConfig,
    BTVConfig,
    FlowConfig,
    LKConfig,
    MergeConfig,
    PolarDefogConfig,
)
from multi_frame_super_resolution_tpu_torch.data import (
    CITY_ANGLES,
    synthetic_burst,
    synthetic_polar_pair,
    synthetic_raw_burst,
    synthetic_rgb_burst,
)
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels import merge as merge_kernel
from multi_frame_super_resolution_tpu_torch.kernels import merge_raw as raw_merge_kernel
from multi_frame_super_resolution_tpu_torch.kernels import tile_search as tile_search_kernel
from multi_frame_super_resolution_tpu_torch.kernels.defog import defog, defog_pixels
from multi_frame_super_resolution_tpu_torch.kernels.merge import merge_fast, merge_fast_plain
from multi_frame_super_resolution_tpu_torch.kernels.merge_raw import merge_raw, merge_raw_plain
from multi_frame_super_resolution_tpu_torch.kernels.tile_search import tile_search
from multi_frame_super_resolution_tpu_torch.kernels.tile_warp import tile_warp, tile_warp_block
from multi_frame_super_resolution_tpu_torch.models import btvl1, dnn_sr, fast_merge
from multi_frame_super_resolution_tpu_torch.models.defog import polar_defog
from multi_frame_super_resolution_tpu_torch.models.handheld import (
    handheld_superres,
    handheld_superres_raw,
    handheld_superres_raw_cascade,
)
from multi_frame_super_resolution_tpu_torch.ops import warp_fast
from multi_frame_super_resolution_tpu_torch.parallel import handheld_superres_raw_sharded, pipeline_halo
from multi_frame_super_resolution_tpu_torch.parallel import mesh as parallel_mesh
from multi_frame_super_resolution_tpu_torch.parallel.runner import make_batched_pipeline
from multi_frame_super_resolution_tpu_torch.registration import tiles
from multi_frame_super_resolution_tpu_torch.registration.optical_flow import create_optical_flow


def _merge_inputs(rng, f, h, w):
    warped = rng.random((f, h, w, 3)).astype(np.float32)
    residual = (rng.random((f, h, w, 2)) * 2.0 - 1.0).astype(np.float32)
    certainty = rng.random((f, h, w, 3)).astype(np.float32)
    omega = (0.5 + rng.random((h, w, 3))).astype(np.float32)
    omega[..., 2] *= 0.1
    return warped, residual, certainty, omega


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(3, 5), (37, 61), (64, 96)])
@pytest.mark.parametrize("radius,k_max,halo", [(1, 1.0, 2), (7, 64.0, 8)], ids=["taps2", "taps8"])
@pytest.mark.parametrize("scale", [1, 2, 3, 4])
@pytest.mark.parametrize("f", [2, 5, 9])
def test_merge_kernel_matches_plain(f, scale, radius, k_max, halo, h, w):
    """F = 2, 5, 9 (the frames are streamed: no cap); scales 1-4; tap
    radius 2 (radius 1, rb 1) and 8 (radius 7, rb 1; k_max 64 keeps the
    |k| = 8 taps at every scale, up to all 289, so the largest halo and
    the shared-memory opt-in above 48 KB are exercised); an image
    smaller than one block's tile and halo, one that is not a multiple
    of the 32 x 8 block, and one that is. ex2.approx, the folded exponent, value x certainty staged and
    FMA contraction against torch ops: rtol and atol 1e-5."""
    dev = cuda_device()
    assert np.abs(merge_kernel.tap_array(radius + 1, 1.0, scale, k_max)).max() == halo
    ins = [tt(x, dev) for x in _merge_inputs(np.random.default_rng(f * 10 + scale), f, h, w)]
    LAUNCHES.clear()
    num, den = merge_fast(*ins, scale, radius, 1.0, k_max)
    torch.cuda.synchronize()
    assert LAUNCHES["merge_fast"] == 1
    num_p, den_p = merge_fast_plain(*ins, scale, radius, 1.0, k_max)
    torch.testing.assert_close(num, num_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(den, den_p, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(3, 5), (37, 61), (64, 96)])
@pytest.mark.parametrize("radius,k_max", [(1, 1.0), (7, 64.0)], ids=["taps2", "taps8"])
@pytest.mark.parametrize("scale", [1, 2, 3, 4])
@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("f", [2, 5])
def test_merge_kernel_phase_forms_match_plain(f, order, scale, radius, k_max, h, w):
    """The default RGB branch's forms: the phase layout (s, s, 3, H, W),
    taps pruned at e^-1.5 (k_max scaled by (s/2)^2, as the path does), in
    order 0 (num, den) and order 1 (m00, m01, m02, b0); the taps8 case
    stages the largest halo. Order 0 at rtol/atol 1e-5 as the interleaved
    form; order 1 at 1e-4: dy and dx reach +-(r + rb) s, so m01 and m02
    sum terms of mixed sign whose rounding does not cancel."""
    dev = cuda_device()
    k_max = k_max * (scale / 2.0) ** 2
    ins = [tt(x, dev) for x in _merge_inputs(np.random.default_rng(f * 10 + scale + order), f, h, w)]
    kw = dict(phase_output=True, order=order, prune_exp=1.5)
    LAUNCHES.clear()
    got = merge_fast(*ins, scale, radius, 1.0, k_max, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["merge_fast"] == 1
    want = merge_fast_plain(*ins, scale, radius, 1.0, k_max, **kw)
    assert len(got) == len(want) == (4 if order else 2)
    tol = 1e-4 if order else 1e-5
    for g, w_ in zip(got, want):
        assert g.shape == (scale, scale, 3, h, w)
        torch.testing.assert_close(g, w_, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_merge_wrapper_raises_on_card_for_order1_forms_it_lacks():
    """Order 1 in the interleaved layout: the kernel has no such form, so
    the wrapper raises (the plain version raises too), and an order the
    merge has no form for raises."""
    dev = cuda_device()
    ins = [tt(x, dev) for x in _merge_inputs(np.random.default_rng(2), 2, 8, 8)]
    with pytest.raises(ValueError, match="phase_output"):
        merge_fast(*ins, 2, 1, 1.0, 1.0, phase_output=False, order=1)
    with pytest.raises(ValueError, match="order"):
        merge_fast(*ins, 2, 1, 1.0, 1.0, phase_output=True, order=2)


@pytest.mark.cuda
def test_merge_wrapper_raises_on_card_for_bad_input():
    dev = cuda_device()
    ins = [tt(x, dev) for x in _merge_inputs(np.random.default_rng(1), 2, 8, 8)]
    with pytest.raises(ValueError):
        merge_fast(ins[0], ins[1].cpu(), ins[2], ins[3], 2, 1, 1.0, 1.0)


@pytest.mark.cuda
def test_slice_on_card_matches_cpu():
    """The slice on the card (merge kernel included) against the same port
    on the CPU (plain merge); TF32 is off, so both run in float32."""
    dev = cuda_device()
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5)
    want = nn(handheld_superres(tt(burst), PORT_DEFAULT, device="cpu"))
    LAUNCHES.clear()
    got = nn(handheld_superres(tt(burst, dev), PORT_DEFAULT))
    assert LAUNCHES["merge_fast"] == 1
    assert psnr(got, want) >= 60.0


@pytest.mark.cuda
def test_entry_points_run_on_card_by_default():
    """Bursts handed over on the CPU, no device asked for: both entry points
    move them to cuda:0 and run there, through the kernels."""
    dev = cuda_device()
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5)
    raw, _ = synthetic_raw_burst(np.random.default_rng(0), 4, 128, 256, 2.5)
    LAUNCHES.clear()
    assert handheld_superres(tt(burst), PORT_DEFAULT).device == dev
    assert handheld_superres_raw(tt(raw), RAW_PORT_DEFAULT).device == dev
    torch.cuda.synchronize()
    assert LAUNCHES["merge_fast"] == 1 and LAUNCHES["merge_raw"] == 1 and LAUNCHES["tile_warp"] == 2
    assert LAUNCHES["tile_search"] == 3 + 2  # one per pyramid level: 3 (RGB), 2 (RAW)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,n,h,w,t,amp",
    [
        (4, 4, 128, 256, 16, 20), (2, 3, 50, 70, 16, 20), (3, 1, 40, 72, 8, 9),
        (2, 5, 64, 96, 32, 20), (2, 5, 40, 72, 8, 9), (2, 5, 37, 61, 8, 9),
        (3, 5, 33, 66, 32, 20), (1, 9, 16, 44, 4, 5), (2, 5, 30, 30, 6, 7),
        (2, 3, 40, 61, 12, 20), (1, 2, 10, 1500, 1, 800),
    ],
)
def test_tile_warp_kernel_matches_plain(b, n, h, w, t, amp):
    """The separable and block maps; N up to 9 (5: the validity plane the
    paths carry; 9: a second batch of loads); T = 1, 4, 6, 8, 12, 16, 32
    (6, 12: 4-groups straddle tiles; the one-hot test's shapes among
    them); W a multiple of 4 (float4 stores) or not (scalar stores, the
    row's end masked). Every output is one input value, so exact."""
    dev = cuda_device()
    rng = np.random.default_rng(h)
    imgs = tt(rng.random((b, n, h, w)).astype(np.float32), dev)
    shifts = tt(rng.integers(-amp, amp + 1, (b, -(-h // t), -(-w // t), 2)).astype(np.int32), dev)
    LAUNCHES.clear()
    got = tile_warp(imgs, shifts, t, 16)
    torch.cuda.synchronize()
    assert LAUNCHES["tile_warp"] == 1
    torch.testing.assert_close(got, warp_fast.tile_warp_matmul(imgs, shifts, t, 16), rtol=0, atol=0)
    if h % t == 0 and w % t == 0:
        got = tile_warp_block(imgs, shifts, t)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, warp_fast.tile_warp_block(imgs, shifts, t), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [0.0, 0.05])
@pytest.mark.parametrize(
    "h,w,t,radius,mode",
    [
        (128, 256, 16, 4, "image"), (64, 128, 16, 4, "image"), (72, 100, 16, 4, "image"),
        (96, 160, 32, 8, "image"), (40, 72, 8, 4, "image"), (72, 100, 16, 12, "image"),
        (128, 256, 16, 4, "tile"), (64, 128, 16, 4, "tile"), (72, 100, 16, 9, "tile"),
        (96, 160, 32, 9, "tile"), (40, 72, 8, 5, "tile"),
    ],
)
def test_tile_search_kernel_matches_plain(h, w, t, radius, mode, threshold):
    """Both modes at the RAW main path's two levels (4 x 128 x 256 and
    4 x 64 x 128, T = 16, R = 4), ragged sizes, T = 8 and 32, R up to 12;
    "image" mode with shifts past the warp's +-16 clip. The kernel sums
    in another order than the plain version: without the subpixel step
    the shifts (integers) are equal on every tile, with it within 1e-3
    px; tiles whose minimum is an exact tie (torch_parity.tied_minima)
    are ranked by rounding and left out."""
    dev = cuda_device()
    ref, alts, rounded = search_inputs(h, w, BIG_SHIFTS if mode == "image" else SMALL_SHIFTS, t)
    untied = ~tied_minima(ref, alts, rounded, t, radius) if mode == "tile" else np.ones(rounded.shape[:3], bool)
    args = [tt(x, dev) for x in (ref, alts, rounded)]
    for sub in (False, True):
        LAUNCHES.clear()
        got = nn(tile_search(*args, t, radius, threshold, sub, mode))
        assert LAUNCHES["tile_search"] == 1
        want = nn(tiles.tile_search(*args, t, radius, threshold, sub, mode))
        if sub:
            np.testing.assert_allclose(got[untied], want[untied], rtol=0, atol=1e-3)
        else:
            np.testing.assert_array_equal(got[untied], want[untied])


@pytest.mark.cuda
def test_tile_search_kernel_matches_plain_on_prealigned_rotations():
    """RAW_SCALE4's two searches (8 alternates, T = 8, R = 4, "image"
    mode) on a burst rotated 5-15 degrees and pre-aligned by the port on
    the CPU: integer parts equal outside tiles.float32_undecided's argmin
    mask, subpixel shifts within 1e-3 px outside both masks."""
    dev = cuda_device()
    for ref, alts, rounded, t, radius, threshold in prealigned_search_inputs():
        undecided, ill = tiles.float32_undecided(ref, alts, rounded, t, radius, threshold)
        args = [x.to(dev) for x in (ref, alts, rounded)]
        for sub in (False, True):
            LAUNCHES.clear()
            got = tile_search(*args, t, radius, threshold, sub, "image").cpu()
            assert LAUNCHES["tile_search"] == 1
            want = tiles.tile_search(ref, alts, rounded, t, radius, threshold, sub, "image")
            if sub:
                keep = ~undecided & ~ill
                torch.testing.assert_close(got[keep], want[keep], rtol=0, atol=1e-3)
            else:
                torch.testing.assert_close(got[~undecided], want[~undecided], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [0.0, 0.05])
@pytest.mark.parametrize(
    "h,w,t,radius,mode",
    [
        (64, 96, 16, 27, "tile"), (64, 96, 16, 27, "image"),  # the templated kernel's largest radius
        (64, 96, 16, 28, "tile"), (64, 96, 16, 40, "tile"), (40, 72, 16, 70, "tile"),
        (64, 96, 16, 0, "tile"), (64, 96, 16, 0, "image"),
        (128, 256, 12, 4, "image"), (64, 128, 12, 4, "image"), (72, 100, 12, 4, "tile"),
        (66, 90, 12, 2, "image"), (70, 100, 48, 4, "image"), (40, 72, 5, 2, "tile"),
        (72, 96, 24, 4, "image"), (66, 99, 33, 4, "tile"), (128, 192, 64, 4, "image"),
        (72, 96, 24, 1, "tile"), (72, 96, 24, 40, "tile"), (66, 99, 33, 40, "image"), (128, 192, 64, 40, "tile"),
        (72, 96, 24, 10, "tile"), (72, 96, 24, 11, "tile"),  # either side of the split into tile rows
        (64, 96, 16, 100, "tile"),  # the surface in device memory, the whole window staged
        (200, 230, 200, 20, "tile"), (200, 230, 200, 20, "image"),  # bands of tile rows
        (32, 48, 16, 120, "tile"), (32, 48, 16, 120, "image"),  # bands of offset rows
    ],
)
def test_tile_search_general_form_matches_plain(h, w, t, radius, mode, threshold):
    """Past the templated kernel (T = 8, 16, 32 and radii 1..27 at T = 16,
    what 48 KB hold): radii past it up to 120, radius 0 (the 1 x 1
    surface: the prediction itself), T = 12 (AlignConfig(tile_size=12)),
    5, 24, 33, 48, 64 and 200 launch the general form, by the same rules
    as the templated one: integer parts equal, subpixel shifts within 1e-3
    px, exact ties left out. The cases lie on both sides of each switch of
    its staging (tile_search.search_plan): (offsets, tile row) items at
    radii up to 10; the surface in shared memory or, at radius 100, in
    device memory; the whole window, or bands of tile rows (T = 200) or
    of offset rows (radius 120)."""
    dev = cuda_device()
    assert tile_search_kernel.library().mfsr_tile_search_max_radius(16) == 27
    ref, alts, rounded = search_inputs(h, w, BIG_SHIFTS if mode == "image" else SMALL_SHIFTS, t)
    untied = ~tied_minima(ref, alts, rounded, t, radius) if mode == "tile" else np.ones(rounded.shape[:3], bool)
    args = [tt(x, dev) for x in (ref, alts, rounded)]
    name = "tile_search" if (t == 16 and radius == 27) else "tile_search_general"
    if name == "tile_search_general":
        plan = tile_search_kernel.search_plan(t, radius)
        assert plan.split == (radius <= 10)
        assert (plan.bu, plan.bt) == (2 * radius + 1, t) or radius == 120 or t == 200
        assert plan.surf_smem != (radius in (100, 120))
    for sub in (False, True):
        LAUNCHES.clear()
        got = nn(tile_search(*args, t, radius, threshold, sub, mode))
        assert dict(LAUNCHES) == {name: 1}
        want = nn(tiles.tile_search(*args, t, radius, threshold, sub, mode))
        if radius == 0:
            np.testing.assert_array_equal(got, rounded)
        if sub:
            np.testing.assert_allclose(got[untied], want[untied], rtol=0, atol=1e-3)
        else:
            np.testing.assert_array_equal(got[untied], want[untied])


def _raw_merge_inputs(rng, f, hh, hw, dev):
    planes = rng.random((f, 2, 2, hh, hw)).astype(np.float32)
    residual = ((rng.random((f, hh, hw, 2)) - 0.5) * 4.0).astype(np.float32)
    cert = rng.random((f, hh, hw, 3)).astype(np.float32)
    omega = (0.5 + rng.random((hh, hw, 3))).astype(np.float32)
    omega[..., 2] *= 0.1
    return [tt(x, dev) for x in (planes, residual, cert, omega, omega * 0.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("hh,hw", [(37, 61), (3, 5)])
@pytest.mark.parametrize("cfa", [((0, 1), (1, 2)), ((2, 1), (1, 0))])
@pytest.mark.parametrize("radius,k_max,prune", [(1, 1.0, 1.5), (1, 1.0, 6.0), (2, 4.0, 6.0)])
@pytest.mark.parametrize("f", [2, 5, 8])
def test_raw_merge_kernel_matches_plain(f, radius, k_max, prune, cfa, hh, hw):
    """F = 2, 5, 8; 21, 25 and 49 taps (radius 2 keeps its |k| = 3 taps
    only with k_max 4: the kernel's halo-2 build); both Bayer orders;
    a size that is not a multiple of the 32 x 4 block and one smaller
    than the block's halo (the edge clamp). ex2.approx, FMA contraction
    and the kernel's tap order within a cell against torch ops: rtol and
    atol 1e-5."""
    dev = cuda_device()
    ins = _raw_merge_inputs(np.random.default_rng(f * 10 + radius), f, hh, hw, dev)
    LAUNCHES.clear()
    got = merge_raw(*ins, cfa, 2, radius, 1.0, k_max, prune)
    torch.cuda.synchronize()
    assert LAUNCHES["merge_raw"] == 1
    want = merge_raw_plain(*ins, cfa, 2, radius, 1.0, k_max, prune)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("hh,hw", [(37, 61), (3, 5)])
@pytest.mark.parametrize("cfa", [((0, 1), (1, 2)), ((2, 1), (1, 0))])
@pytest.mark.parametrize("radius,k_max,prune", [(1, 1.0, 1.5), (2, 4.0, 6.0)], ids=["halo1", "halo2"])
@pytest.mark.parametrize("scale", [1, 3, 4])
@pytest.mark.parametrize("f", [2, 5, 9])
def test_raw_merge_kernel_scales_match_plain(f, scale, radius, k_max, prune, cfa, hh, hw):
    """Scales 1, 3 (odd phase offsets) and 4 (9 frames: the scale-4
    configuration's burst), each with its own thread layout; k_max scaled
    by (s/2)^2 as the path does, at e^-1.5 (the path's taps, halo 1) and
    with radius 2 at e^-6 (halo 2). rtol and atol 1e-5 as at scale 2."""
    dev = cuda_device()
    k_max = k_max * (scale / 2.0) ** 2
    ins = _raw_merge_inputs(np.random.default_rng(f * 10 + scale), f, hh, hw, dev)
    assert raw_merge_kernel.tap_halo(
        fast_merge._active_taps(radius + 1, 1.0, scale, k_max, prune)
    ) == radius
    LAUNCHES.clear()
    got = merge_raw(*ins, cfa, scale, radius, 1.0, k_max, prune)
    torch.cuda.synchronize()
    assert LAUNCHES["merge_raw"] == 1
    want = merge_raw_plain(*ins, cfa, scale, radius, 1.0, k_max, prune)
    for g, w_ in zip(got, want):
        assert g.shape == (2 * scale, 2 * scale, 3, hh, hw)
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("radius,k_max,halo", [(1, 1.0, 1), (2, 4.0, 2)])
def test_raw_merge_kernel_frame_cap(radius, k_max, halo):
    """Every frame's tile is staged in shared memory at once: the most
    frames that fit at scale 2 (30 at halo 1, 22 at halo 2) run the
    resident kernel, one more the streamed kernel's ring; both match the
    plain version."""
    dev = cuda_device()
    cap = raw_merge_kernel.library().mfsr_merge_raw_max_frames(2, halo, 0)
    assert cap == {1: 30, 2: 22}[halo]
    cfa = ((0, 1), (1, 2))
    ins = _raw_merge_inputs(np.random.default_rng(cap), cap, 9, 37, dev)
    LAUNCHES.clear()
    got = merge_raw(*ins, cfa, 2, radius, 1.0, k_max, 6.0)
    torch.cuda.synchronize()
    assert LAUNCHES["merge_raw"] == 1
    want = merge_raw_plain(*ins, cfa, 2, radius, 1.0, k_max, 6.0)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)
    more = _raw_merge_inputs(np.random.default_rng(0), cap + 1, 9, 37, dev)
    LAUNCHES.clear()
    got = merge_raw(*more, cfa, 2, radius, 1.0, k_max, 6.0)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"merge_raw_stream": 1}
    want = merge_raw_plain(*more, cfa, 2, radius, 1.0, k_max, 6.0)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1, 3, 4])
def test_raw_merge_kernel_frame_cap_by_scale(scale):
    """The frame caps of the other layouts (4 pixel rows a block at scale
    1, one at 3 and 4): at least the scale-4 configuration's 9 frames at
    either halo; the cap runs the resident kernel and one more the
    streamed one, both matching the plain version. No scale past 4 has
    a cap: the general form runs it."""
    dev = cuda_device()
    lib = raw_merge_kernel.library()
    caps = {halo: lib.mfsr_merge_raw_max_frames(scale, halo, 0) for halo in (1, 2)}
    assert caps == {1: {1: 30, 3: 66, 4: 66}[scale], 2: {1: 22, 3: 38, 4: 38}[scale]}
    assert lib.mfsr_merge_raw_max_frames(5, 1, 0) == 0
    cfa = ((0, 1), (1, 2))
    k_max = (scale / 2.0) ** 2
    ins = _raw_merge_inputs(np.random.default_rng(scale), caps[1], 9, 37, dev)
    got = merge_raw(*ins, cfa, scale, 1, 1.0, k_max, 1.5)
    want = merge_raw_plain(*ins, cfa, scale, 1, 1.0, k_max, 1.5)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)
    more = _raw_merge_inputs(np.random.default_rng(0), caps[1] + 1, 9, 37, dev)
    LAUNCHES.clear()
    got = merge_raw(*more, cfa, scale, 1, 1.0, k_max, 1.5)
    assert dict(LAUNCHES) == {"merge_raw_stream": 1}
    want = merge_raw_plain(*more, cfa, scale, 1, 1.0, k_max, 1.5)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(3, 5), (37, 61)])
@pytest.mark.parametrize("radius,k_max", [(1, 1.0), (7, 64.0)], ids=["taps2", "taps8"])
@pytest.mark.parametrize("scale", [1, 2, 3, 4])
@pytest.mark.parametrize("f", [1, 2, 5, 9])
def test_merge_kernel_nine_moments_match_plain(f, scale, radius, k_max, h, w):
    """Form 3, the exact solve's 9 moments in the phase layout at e^-1.5
    (k_max scaled by (s/2)^2), a thread per pixel, phase row and two phase
    columns at s = 2 and 4 (one phase at s = 1 and 3): ragged and tiny
    images, the largest halo (taps8), one frame to nine. rtol and atol
    1e-4, as the plugin moments (dy and dx, and their products, in either
    sign). One launch of the templated kernel."""
    dev = cuda_device()
    k_max = k_max * (scale / 2.0) ** 2
    ins = [tt(x, dev) for x in _merge_inputs(np.random.default_rng(f * 10 + scale + 7), f, h, w)]
    kw = dict(phase_output=True, order=1, prune_exp=1.5, moment_slots=9)
    LAUNCHES.clear()
    got = merge_fast(*ins, scale, radius, 1.0, k_max, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"merge_fast": 1}
    want = merge_fast_plain(*ins, scale, radius, 1.0, k_max, **kw)
    assert len(got) == len(want) == 9
    for g, w_ in zip(got, want):
        assert g.shape == (scale, scale, 3, h, w)
        torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("f,h,w", [(5, 256, 512), (1, 250, 500), (2, 250, 500), (9, 250, 500)])
@pytest.mark.parametrize("scale", [1, 2, 3, 4])
def test_merge_kernel_nine_moments_at_the_path_shape(scale, f, h, w):
    """Form 3 at chip_smoke.py's shape: F = 5 at 256 x 512, radius 1, the
    path's taps (RGB_EXACT at scale 2, and at scales 1, 3 and 4); and at
    250 x 500, which no tile divides, on 1, 2 and 9 frames. One launch
    of the templated kernel."""
    dev = cuda_device()
    seed = scale if (f, h, w) == (5, 256, 512) else scale + f
    ins = [tt(x, dev) for x in _merge_inputs(np.random.default_rng(seed), f, h, w)]
    kw = dict(phase_output=True, order=1, prune_exp=1.5, moment_slots=9)
    k_max = (scale / 2.0) ** 2
    LAUNCHES.clear()
    got = merge_fast(*ins, scale, 1, 1.0, k_max, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"merge_fast": 1}
    want = merge_fast_plain(*ins, scale, 1, 1.0, k_max, **kw)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-4)


# the RAW forms beside the certless one: (keyword arguments, outputs,
# tolerance); cert4 is the 9-moment kernel with the per-cell plugin's 4
RAW_FORMS = {
    "order0": (dict(order=0), 2, 1e-5),
    "slots9": (dict(order=1, moment_slots=9), 9, 1e-4),
    "cert4": (dict(order=1, moment_slots=4, centroid_cert=True), 4, 1e-4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("hh,hw", [(37, 61), (3, 5)])
@pytest.mark.parametrize("cfa", [((0, 1), (1, 2)), ((2, 1), (1, 0))])
@pytest.mark.parametrize("radius,k_max,prune", [(1, 1.0, 1.5), (2, 4.0, 6.0)], ids=["halo1", "halo2"])
@pytest.mark.parametrize("scale", [1, 2, 3, 4])
@pytest.mark.parametrize("form", list(RAW_FORMS))
def test_raw_merge_kernel_new_forms_match_plain(form, scale, radius, k_max, prune, cfa, hh, hw):
    """The order-0 form (num, den) at rtol/atol 1e-5, the exact solve's 9
    moments and the per-cell plugin's 4 (parity-interpolated
    displacements, a one-block residual halo) at 1e-4, scales 1-4 (5
    frames, 9 at scale 4), both Bayer orders, both halos, a ragged size
    and one smaller than the halo (edge clamps on every read)."""
    dev = cuda_device()
    kw, n_out, tol = RAW_FORMS[form]
    k_max = k_max * (scale / 2.0) ** 2
    f = 9 if scale == 4 else 5
    ins = _raw_merge_inputs(np.random.default_rng(f * 10 + scale + kw["order"]), f, hh, hw, dev)
    LAUNCHES.clear()
    got = merge_raw(*ins, cfa, scale, radius, 1.0, k_max, prune, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["merge_raw"] == 1
    want = merge_raw_plain(*ins, cfa, scale, radius, 1.0, k_max, prune, **kw)
    assert len(got) == len(want) == n_out
    for g, w_ in zip(got, want):
        assert g.shape == (2 * scale, 2 * scale, 3, hh, hw)
        torch.testing.assert_close(g, w_, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(RAW_FORMS))
@pytest.mark.parametrize("frames,scale", [(5, 2), (9, 4), (9, 2)])
def test_raw_merge_kernel_new_forms_at_the_path_shape(form, frames, scale):
    """The forms at chip_smoke.py's shapes: 128 x 256 half-res, the
    path's 21 taps, F = 5 at scale 2 and F = 9 at scale 4 (R/B kernels
    wider); and F = 9 at scale 2."""
    dev = cuda_device()
    kw, _, tol = RAW_FORMS[form]
    ins = _raw_merge_inputs(np.random.default_rng(frames), frames, 128, 256, dev)
    args = (((0, 1), (1, 2)), scale, 1, 1.0, (scale / 2.0) ** 2, 1.5)
    got = merge_raw(*ins, *args, **kw)
    want = merge_raw_plain(*ins, *args, **kw)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(RAW_FORMS))
@pytest.mark.parametrize("scale", [1, 2, 4])
def test_raw_merge_kernel_new_forms_frame_cap(form, scale):
    """The order-0 form stages every frame's tile at once: it has the
    certless form's caps (its kernel without the chains), at halo 1 and
    2; the halo-1 cap matches the plain version, and so does one more
    frame, which the streamed kernel runs.
    The 9-moment and per-cell forms stream frames through a ring and take
    any number: one frame past the caps they had while they staged every
    frame at once (28, 42 and 56 frames at scales 1, 2 and 4, halo 1)
    matches the plain version."""
    dev = cuda_device()
    kw, _, tol = RAW_FORMS[form]
    lib = raw_merge_kernel.library()
    code = fast_merge.raw_merge_form(kw["order"], kw.get("moment_slots", 4), kw.get("centroid_cert", False))
    caps = {halo: lib.mfsr_merge_raw_max_frames(scale, halo, code) for halo in (1, 2)}
    if form == "order0":
        want = {1: {1: 30, 2: 30, 4: 66}, 2: {1: 22, 2: 22, 4: 38}}
        assert caps == {halo: want[halo][scale] for halo in (1, 2)}
        frames = caps[1]
    else:
        assert caps == {1: 2**31 - 1, 2: 2**31 - 1}
        frames = {1: 28, 2: 42, 4: 56}[scale] + 1
    cfa = ((0, 1), (1, 2))
    args = (cfa, scale, 1, 1.0, (scale / 2.0) ** 2, 1.5)
    ins = _raw_merge_inputs(np.random.default_rng(scale), frames, 5, 37, dev)
    got = merge_raw(*ins, *args, **kw)
    want = merge_raw_plain(*ins, *args, **kw)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=tol, atol=tol)
    if form == "order0":
        more = _raw_merge_inputs(np.random.default_rng(0), caps[1] + 1, 5, 37, dev)
        LAUNCHES.clear()
        got = merge_raw(*more, *args, **kw)
        assert dict(LAUNCHES) == {"merge_raw_stream": 1}
        for g, w_ in zip(got, merge_raw_plain(*more, *args, **kw)):
            torch.testing.assert_close(g, w_, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("frames,hh,hw", [(1, 64, 96), (3, 39, 83)], ids=["one-frame", "ragged-tile"])
@pytest.mark.parametrize("halo", [1, 2])
@pytest.mark.parametrize("scale", [1, 2, 3, 4])
@pytest.mark.parametrize("form", ["slots9", "cert4"])
def test_raw_merge_cells_kernel_one_frame_and_ragged_tiles(form, scale, halo, frames, hh, hw):
    """The cells kernel's frame ring with a single frame (nothing staged
    ahead), and a height and width that are multiples of none of its
    tiles (4, 4, 2 and 2 pixel rows, 32, 16, 16 and 8 columns at scales
    1-4): the last tile row and column hang over the image. Both halos,
    at the forms' tolerance."""
    dev = cuda_device()
    kw, _, tol = RAW_FORMS[form]
    radius, k_max, prune = (1, 1.0, 1.5) if halo == 1 else (2, 4.0, 6.0)
    args = (((2, 1), (1, 0)), scale, radius, 1.0, k_max * (scale / 2.0) ** 2, prune)
    ins = _raw_merge_inputs(np.random.default_rng(frames + scale + halo), frames, hh, hw, dev)
    LAUNCHES.clear()
    got = merge_raw(*ins, *args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["merge_raw"] == 1
    want = merge_raw_plain(*ins, *args, **kw)
    for g, w_ in zip(got, want):
        assert g.shape == (2 * scale, 2 * scale, 3, hh, hw)
        torch.testing.assert_close(g, w_, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hh,hw", [(128, 256), (37, 61)], ids=["path", "ragged"])
@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("form", ["certless", *RAW_FORMS])
def test_raw_merge_kernel_guided_matches_plain(form, scale, hh, hw):
    """The guided merge: the wrapper forms value - guide at R/B sites (the
    guide green_guide_planes of the planes) and runs the form unguided,
    on the card as on the CPU. Each form at the path's 21 taps, F = 5 at
    scale 2 and F = 9 at scale 4, against the plain version with the same
    guide; the forms' own tolerances (the certless one 1e-5)."""
    dev = cuda_device()
    kw, _, tol = RAW_FORMS[form] if form in RAW_FORMS else ({}, 4, 1e-5)
    f = 9 if scale == 4 else 5
    cfa = ((0, 1), (1, 2))
    ins = _raw_merge_inputs(np.random.default_rng(hh + scale), f, hh, hw, dev)
    guide = fast_merge.green_guide_planes(ins[0], cfa).contiguous()
    args = (cfa, scale, 1, 1.0, (scale / 2.0) ** 2, 1.5)
    LAUNCHES.clear()
    got = merge_raw(*ins, *args, guide=guide, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["merge_raw"] == 1
    want = merge_raw_plain(*ins, *args, guide=guide, **kw)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "entry,cfg,launched",
    [
        ("raw", RAW_ORACLE, ()),
        ("raw", dataclasses.replace(RAW_ORACLE, merge=MergeConfig(order=0)), ()),
        ("raw", RAW_EXACT, ("tile_warp", "merge_raw")),
        ("raw", RAW_ORDER0, ("tile_warp", "merge_raw")),
        ("rgb", RGB_ORACLE, ()),
        ("rgb", RGB_EXACT, ("tile_warp", "merge_fast")),
    ],
    ids=["raw-oracle", "raw-oracle-order0", "raw-exact", "raw-order0", "rgb-oracle", "rgb-exact"],
)
def test_correctness_bar_paths_on_card_match_cpu(entry, cfg, launched):
    """The oracle paths (the tile search alone of csrc/; the gather merge
    is plain PyTorch on the card too) and the exact and order-0 fast
    paths (their new merge forms) on a rotated burst on the card, against
    the port on the CPU."""
    dev = cuda_device()
    angles = CITY_ANGLES[:2] + CITY_ANGLES[3:]
    if entry == "raw":
        fn = handheld_superres_raw
        x, _ = synthetic_raw_burst(np.random.default_rng(0), 4, 128, 256, 2.5, angles=angles)
    else:
        fn = handheld_superres
        x, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5, angles=angles)
    want = nn(fn(tt(x), cfg, device="cpu"))
    LAUNCHES.clear()
    got = nn(fn(tt(x, dev), cfg))
    assert LAUNCHES["tile_search"] == cfg.align.levels
    assert all(LAUNCHES[k] == 1 for k in launched)
    assert set(LAUNCHES) - {"tile_search"} == set(launched)
    assert psnr(got, want) >= 60.0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "entry,cfg,searches",
    [
        ("raw", RAW_GUIDED, 2),
        ("raw", RAW_CERT, 2),
        ("raw", RAW_CONSISTENT, 6),
        ("raw", RAW_FFT, 0),
        ("raw", dataclasses.replace(RAW_BENCH, lk=LKConfig(warp_tile=16)), 2),
        ("rgb", RGB_CONSISTENT, 9),
    ],
    ids=["raw-guided", "raw-cert", "raw-consistent", "raw-fft", "raw-warp-tile", "rgb-consistent"],
)
def test_handheld_knobs_on_card_match_cpu(entry, cfg, searches):
    """The handheld knobs on a rotated 4-frame burst on the card, against
    the port on the CPU: the guided merge and the per-cell centroid
    (merge kernel's forms), the consistency solve (a tile search per
    level for each first frame of a measured pair: 3 of them with 4
    frames), the FFT surfaces (no tile search: cuFFT) and LK's
    tile-decomposed warp. Each fast path launches the tile warp and its
    merge once."""
    dev = cuda_device()
    angles = CITY_ANGLES[:2] + CITY_ANGLES[3:]
    if entry == "raw":
        fn, merge = handheld_superres_raw, "merge_raw"
        x, _ = synthetic_raw_burst(np.random.default_rng(0), 4, 128, 256, 2.5, angles=angles)
    else:
        fn, merge = handheld_superres, "merge_fast"
        x, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 128, 256, 2.5, angles=angles)
    want = nn(fn(tt(x), cfg, device="cpu"))
    LAUNCHES.clear()
    got = nn(fn(tt(x, dev), cfg))
    assert LAUNCHES["tile_search"] == searches
    assert LAUNCHES["tile_warp"] == 1 and LAUNCHES[merge] == 1
    assert psnr(got, want) >= 60.0


@pytest.mark.cuda
@pytest.mark.parametrize("fast_extract", [True, False])
def test_raw_slice_on_card_matches_cpu(fast_extract):
    """The RAW slice on the card (tile-warp, tile-search and RAW merge
    kernels; the search on either alignment branch) against the port on
    the CPU."""
    dev = cuda_device()
    cfg = dataclasses.replace(
        RAW_PORT_DEFAULT,
        align=AlignConfig(tile_size=16, search_radius=4, levels=2, fast_extract=fast_extract),
    )
    raw, _ = synthetic_raw_burst(np.random.default_rng(0), 4, 128, 256, 2.5)
    want = nn(handheld_superres_raw(tt(raw), cfg, device="cpu"))
    LAUNCHES.clear()
    got = nn(handheld_superres_raw(tt(raw, dev), cfg))
    assert LAUNCHES["tile_warp"] == 1 and LAUNCHES["merge_raw"] == 1
    assert LAUNCHES["tile_search"] == 2  # one per pyramid level
    assert psnr(got, want) >= 60.0


def _defog_inputs(rng, h, w, dev):
    iper, ipar = synthetic_polar_pair(rng, h, w)
    p = (0.2 + 0.4 * rng.random(3)).astype(np.float32)
    ainfi = (0.6 + 0.3 * rng.random(3)).astype(np.float32)
    return [tt(x, dev) for x in (iper, ipar, p, ainfi)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(1024, 1224), (37, 61)])
def test_defog_kernel_matches_plain(h, w):
    """The kernel runs the plain version's operations in its order with
    IEEE division and nothing to contract into an FMA: bit for bit."""
    dev = cuda_device()
    ins = _defog_inputs(np.random.default_rng(h), h, w, dev)
    LAUNCHES.clear()
    got = defog(*ins, 0.001, 0.999, 0.001, 0.999)
    torch.cuda.synchronize()
    assert LAUNCHES["defog"] == 1
    for g, w_ in zip(got, defog_pixels(*ins, 0.001, 0.999, 0.001, 0.999)):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)


@pytest.mark.cuda
def test_defog_wrapper_raises_on_card_for_bad_input():
    dev = cuda_device()
    iper, ipar, p, ainfi = _defog_inputs(np.random.default_rng(0), 8, 10, dev)
    with pytest.raises(ValueError):  # not contiguous
        defog(iper.transpose(0, 1), ipar.transpose(0, 1), p, ainfi)
    with pytest.raises(TypeError):  # float64
        defog(iper.double(), ipar.double(), p, ainfi)
    with pytest.raises(ValueError):  # P on the host
        defog(iper, ipar, p.cpu(), ainfi)


@pytest.mark.cuda
def test_polar_defog_on_card_launches_the_kernel():
    """polar_defog on CUDA tensors: one defog launch per frame, and the
    same result as the port on the CPU."""
    dev = cuda_device()
    iper, ipar = synthetic_polar_pair(np.random.default_rng(0), 120, 160)
    cfg = PolarDefogConfig(beta=1.55)
    want = [nn(x) for x in polar_defog(tt(iper), tt(ipar), cfg, return_intermediates=True)]
    LAUNCHES.clear()
    got = [nn(x) for x in polar_defog(tt(iper, dev), tt(ipar, dev), cfg, return_intermediates=True)]
    assert LAUNCHES["defog"] == 1
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_prealigned_slices_on_card_match_cpu():
    """RAW_BENCH and RGB_PALLAS (pre-alignment on) on a rotated burst, on
    the card against the port on the CPU."""
    dev = cuda_device()
    angles = CITY_ANGLES[:2] + CITY_ANGLES[3:]
    raw, _ = synthetic_raw_burst(np.random.default_rng(0), 4, 128, 256, 2.5, angles=angles)
    want = nn(handheld_superres_raw(tt(raw), RAW_BENCH, device="cpu"))
    LAUNCHES.clear()
    got = nn(handheld_superres_raw(tt(raw, dev), RAW_BENCH))
    assert LAUNCHES["tile_warp"] == 1 and LAUNCHES["merge_raw"] == 1 and LAUNCHES["tile_search"] == 2
    assert psnr(got, want) >= 60.0
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5, angles=angles)
    want = nn(handheld_superres(tt(burst), RGB_PALLAS, device="cpu"))
    got = nn(handheld_superres(tt(burst, dev), RGB_PALLAS))
    assert psnr(got, want) >= 60.0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "cfg",
    [
        RGB_DEFAULT,
        RGB_DEFAULT_NOPRE,
        dataclasses.replace(RGB_DEFAULT, scale=4),
        dataclasses.replace(RGB_DEFAULT, merge=MergeConfig(rgb_order=1)),
    ],
    ids=["default", "nopre", "scale4", "order1"],
)
def test_rgb_default_branch_on_card_matches_cpu(cfg):
    """The default RGB branch (merge kernel in the phase layout, order 0
    or 1; the gated restore at scale 2) on a rotated burst, on the card
    against the port on the CPU."""
    dev = cuda_device()
    angles = CITY_ANGLES[:2] + CITY_ANGLES[3:]
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5, angles=angles)
    want = nn(handheld_superres(tt(burst), cfg, device="cpu"))
    LAUNCHES.clear()
    got = nn(handheld_superres(tt(burst, dev), cfg))
    assert LAUNCHES["merge_fast"] == 1 and LAUNCHES["tile_warp"] == 1
    assert got.shape == (64 * cfg.scale, 128 * cfg.scale, 3)
    assert psnr(got, want) >= 60.0


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1, 3, 4])
def test_raw_scales_on_card_match_cpu(scale):
    """RAW_SCALE4 at scales 1, 3 and 4 on a 9-frame burst rotated within
    +-0.01 rad, as the JAX package's scale-4 protocol draws its bursts
    (the pre-alignment and the tile warp move every alternate), on the
    card against the port on the CPU."""
    dev = cuda_device()
    cfg = dataclasses.replace(RAW_SCALE4, scale=scale)
    angles = (0.0,) + tuple(np.random.default_rng(3).uniform(-0.01, 0.01, 8).tolist())
    raw, _ = synthetic_raw_burst(np.random.default_rng(0), 9, 64, 128, 2.5, angles=angles)
    want = nn(handheld_superres_raw(tt(raw), cfg, device="cpu"))
    LAUNCHES.clear()
    got = nn(handheld_superres_raw(tt(raw, dev), cfg))
    assert LAUNCHES["merge_raw"] == 1 and LAUNCHES["tile_search"] == 2
    assert got.shape == (64 * scale, 128 * scale, 3)
    assert psnr(got, want) >= 60.0


@pytest.mark.cuda
def test_cascade_and_defaults_on_card_match_cpu():
    """The scale-4 cascade (two merge_raw launches, four tile searches) and
    both entry points without a configuration (HandheldConfig() and
    HandheldConfig(gamma=True), the JAX package's defaults), on the card
    against the port on the CPU."""
    dev = cuda_device()
    raw, _ = synthetic_raw_burst(np.random.default_rng(0), 5, 64, 128, 2.5, angles=CITY_ANGLES)
    want = nn(handheld_superres_raw_cascade(tt(raw), RAW_SCALE4, device="cpu"))
    LAUNCHES.clear()
    got = nn(handheld_superres_raw_cascade(tt(raw, dev), RAW_SCALE4))
    assert LAUNCHES["merge_raw"] == 2 and LAUNCHES["tile_search"] == 4
    assert got.shape == (256, 512, 3) and psnr(got, want) >= 60.0
    assert psnr(nn(handheld_superres_raw(tt(raw, dev))), nn(handheld_superres_raw(tt(raw), device="cpu"))) >= 60.0
    burst, _ = synthetic_rgb_burst(np.random.default_rng(0), 4, 64, 128, 2.5)
    LAUNCHES.clear()
    got = nn(handheld_superres(tt(burst, dev)))
    assert LAUNCHES["merge_fast"] == 1
    assert psnr(got, nn(handheld_superres(tt(burst), device="cpu"))) >= 60.0


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["pyrlk", "farneback", "tvl1", "brox"])
def test_flows_on_card_match_cpu(method):
    """Each flow backend at the default FlowConfig on a 48 x 64 pair (two
    alternates in one call), on the card against the port on the CPU:
    within 1e-3 px; pyrlk, whose bf16 LK window sums round either way
    where a value lies within float32 rounding of a bf16 boundary, within
    twice the CPU run's own spread under one-ulp input perturbations (the
    rule of test_torch_flow.py against JAX)."""
    dev = cuda_device()
    burst, _ = synthetic_burst(np.random.default_rng(0), 3, 48, 64, 2.5)
    fn = create_optical_flow(FlowConfig(method=method))
    want = nn(fn(tt(burst[0]), tt(burst[1:])))
    got = nn(fn(tt(burst[0], dev), tt(burst[1:], dev)))
    diff = np.abs(got - want)
    if method != "pyrlk":
        assert diff.max() <= 1e-3
        return
    rng = np.random.default_rng(5)
    spreads = [np.abs(nn(fn(tt(ulp_perturbed(burst[0], rng)), tt(ulp_perturbed(burst[1:], rng)))) - want)
               for _ in range(2)]
    assert diff.max() <= 2.0 * max(x.max() for x in spreads)
    assert diff.mean() <= 2.0 * max(x.mean() for x in spreads)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [True, False])
def test_btvl1_with_injected_flows_on_card_matches_cpu(fast):
    """The BTV-L1 solver alone (flows injected, RGB, a ragged 26 x 46, 10
    iterations), on the card against the port on the CPU."""
    dev = cuda_device()
    gray, _ = synthetic_burst(np.random.default_rng(0), 3, 26, 46, 2.0)
    burst = np.stack([gray, gray**1.1, gray**0.9], axis=-1).astype(np.float32)
    flows = (np.random.default_rng(3).standard_normal((3, 26, 46, 2)) * 1.5).astype(np.float32)
    cfg = BTVConfig(fast=fast)
    want = nn(btvl1.btvl1_superres(tt(burst), 1, cfg, flows=tt(flows), device="cpu"))
    out = btvl1.btvl1_superres(tt(burst), 1, cfg, flows=tt(flows))
    assert out.device == dev
    assert psnr(nn(out), want) >= 60.0


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["pyrlk", "farneback", "tvl1", "brox"])
def test_btvl1_video_on_card_matches_cpu(method):
    """btvl1_video with each flow backend on a 3 x 48 x 64 x 3 burst (its
    default device, cuda:0, and no kernel launched), against the port on
    the CPU."""
    dev = cuda_device()
    gray, _ = synthetic_burst(np.random.default_rng(1), 3, 48, 64, 2.0)
    burst = np.stack([gray, gray**1.1, gray**0.9], axis=-1).astype(np.float32)
    cfg = BTVConfig(optical_flow=method)
    want = nn(btvl1.btvl1_video(tt(burst), cfg, device="cpu"))
    LAUNCHES.clear()
    out = btvl1.btvl1_video(tt(burst), cfg)
    assert out.device == dev and not any(LAUNCHES.values())
    got = nn(out)
    assert got.shape == (3, 96, 128, 3) and np.isfinite(got).all()
    assert psnr(got, want) >= 60.0



@pytest.mark.cuda
def test_raw_bench_fine_radius_on_card_matches_cpu():
    """RAW_BENCH with align.fine_radius=2 (the finest level's search at
    radius 2) on a rotated burst, on the card against the port on the
    CPU."""
    dev = cuda_device()
    cfg = dataclasses.replace(RAW_BENCH, align=AlignConfig(tile_size=16, search_radius=4, levels=2, fine_radius=2))
    angles = CITY_ANGLES[:2] + CITY_ANGLES[3:]
    raw, _ = synthetic_raw_burst(np.random.default_rng(0), 4, 128, 256, 2.5, angles=angles)
    want = nn(handheld_superres_raw(tt(raw), cfg, device="cpu"))
    LAUNCHES.clear()
    got = nn(handheld_superres_raw(tt(raw, dev), cfg))
    assert LAUNCHES["tile_search"] == 2 and LAUNCHES["tile_warp"] == 1 and LAUNCHES["merge_raw"] == 1
    assert psnr(got, want) >= 60.0


def _raw_burst(frames, h, w):
    return synthetic_raw_burst(np.random.default_rng(0), frames, h, w, 2.5)[0]


def _rgb_burst(frames, h, w):
    return synthetic_rgb_burst(np.random.default_rng(0), frames, h, w, 2.5)[0]


_ALIGN = dict(tile_size=16, search_radius=4, levels=2)
# the values the port refused on the card until its general kernel forms
# (README.md's former port limits), and a non-Bayer pattern: (entry point,
# burst, configuration, the launches of the run)
PORT_LIMITS = {
    "tile_size=12": (handheld_superres_raw, (_raw_burst, 4, 128, 256),
                     dataclasses.replace(RAW_PORT_DEFAULT, align=AlignConfig(**{**_ALIGN, "tile_size": 12})),
                     {"tile_search_general": 2, "tile_warp": 1, "merge_raw": 1}),
    "fine_radius=0": (handheld_superres_raw, (_raw_burst, 4, 128, 256),
                      dataclasses.replace(RAW_PORT_DEFAULT, align=AlignConfig(**_ALIGN, fine_radius=0)),
                      {"tile_search": 1, "tile_search_general": 1, "tile_warp": 1, "merge_raw": 1}),
    "109 RAW taps": (handheld_superres_raw, (_raw_burst, 4, 128, 256),
                     dataclasses.replace(RAW_PORT_DEFAULT, merge=MergeConfig(radius=5, prune_exp=40.0)),
                     {"tile_search": 2, "tile_warp": 1, "merge_raw_general": 1}),
    "31 RAW frames": (handheld_superres_raw, (_raw_burst, 31, 64, 128), RAW_PORT_DEFAULT,
                      {"tile_search": 2, "tile_warp": 1, "merge_raw_stream": 1}),
    "RGB tap radius 9": (handheld_superres, (_rgb_burst, 4, 64, 128),
                         dataclasses.replace(RGB_DEFAULT_NOPRE, merge=MergeConfig(radius=8)),
                         {"tile_search": 3, "tile_warp": 1, "merge_fast": 1}),
    "RAW scale 5": (handheld_superres_raw, (_raw_burst, 4, 64, 128), dataclasses.replace(RAW_PORT_DEFAULT, scale=5),
                    {"tile_search": 2, "tile_warp": 1, "merge_raw_general": 1}),
    "RGB scale 5": (handheld_superres, (_rgb_burst, 4, 64, 128), dataclasses.replace(RGB_DEFAULT_NOPRE, scale=5),
                    {"tile_search": 3, "tile_warp": 1, "merge_fast_general": 1}),
    "cfa ((0, 1), (2, 1))": (handheld_superres_raw, (_raw_burst, 4, 128, 256),
                             dataclasses.replace(RAW_PORT_DEFAULT, cfa_pattern=((0, 1), (2, 1))),
                             {"tile_search": 2, "tile_warp": 1, "merge_raw_nonbayer": 1}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("limit", list(PORT_LIMITS))
def test_port_limits_on_card_match_cpu(limit):
    """Each former limit of the port (a value the JAX function computes)
    and a non-Bayer pattern run on the card through the general kernel
    forms (a long burst through the streamed RAW merge, a non-Bayer
    pattern through the non-Bayer kernel, an RGB tap radius of 9 through
    the templated merge, whose staged halo reaches 25), with the run's
    launches as listed, and agree with the port on the CPU at 60 dB."""
    dev = cuda_device()
    fn, (make, *shape), cfg, launches = PORT_LIMITS[limit]
    burst = make(*shape)
    want = nn(fn(tt(burst), cfg, device="cpu"))
    LAUNCHES.clear()
    got = nn(fn(tt(burst, dev), cfg))
    assert {k: v for k, v in LAUNCHES.items() if v} == launches
    assert got.shape == want.shape and np.isfinite(got).all()
    assert psnr(got, want) >= 60.0


@pytest.mark.cuda
def test_use_pallas_tap_radius_9_raises_as_in_jax():
    """The interleaved merge form (use_pallas) keeps merge_fast_pallas's
    own limit, a tap radius of at most 8 (pallas_ops/merge.py:154): the
    one value that still raises, on either device, naming it."""
    dev = cuda_device()
    cfg = dataclasses.replace(RGB_PALLAS, prealign=False, merge=MergeConfig(use_pallas=True, radius=8))
    for device in (dev, torch.device("cpu")):
        with pytest.raises(ValueError, match="merge_fast_pallas's 8-row halo"):
            handheld_superres(tt(_rgb_burst(4, 64, 128), device), cfg, device=device)


CHECKPOINTS = pathlib.Path(__file__).resolve().parents[1] / "multi_frame_super_resolution_tpu" / "data" / "checkpoints"


def _bundled(algo):
    state_dict, _ = dnn_sr.load_params(str(CHECKPOINTS / f"{algo}_x2.npz"))
    model = dnn_sr.create_sr_model(algo, 2)
    model.load_state_dict(state_dict)
    return model


@pytest.mark.cuda
@pytest.mark.parametrize("algo", dnn_sr.SR_ALGORITHMS)
def test_dnn_sr_on_card_matches_cpu(algo):
    """Each bundled checkpoint through dnn_sr on its default device,
    cuda:0 (cuDNN convolutions in float32, TF32 off), against the port on
    the CPU on a 64 x 96 x 3 image: within 1e-4 max abs and 60 dB; no
    kernel of csrc/ launches."""
    dev = cuda_device()
    img = np.random.default_rng(0).random((64, 96, 3)).astype(np.float32)
    model = _bundled(algo)
    want = nn(dnn_sr.dnn_sr(model, tt(img), device="cpu"))
    LAUNCHES.clear()
    out = dnn_sr.dnn_sr(model, tt(img))
    assert out.device == dev and not any(LAUNCHES.values())
    got = nn(out)
    assert got.shape == (128, 192, 3)
    assert np.abs(got - want).max() <= 1e-4 and psnr(got, want) >= 60.0


@pytest.mark.cuda
@pytest.mark.parametrize("algo", dnn_sr.SR_ALGORITHMS)
def test_dnn_train_step_on_card_matches_cpu(algo):
    """One train step (init_state from torch.Generator seed 0, Adam at
    1e-3) on the app's first batch, on the card against the port on the
    CPU: the loss within rtol 1e-4; the parameters within 1e-5 where the
    CPU gradient is at least 1e-4 in magnitude, and within 2 lr
    everywhere (Adam moves a parameter by about lr * sign(g))."""
    dev = cuda_device()
    lr, hr = (torch.from_numpy(x).permute(0, 3, 1, 2).contiguous() for x in train_data(2, batches=1)[0])
    results = []
    for device in ("cpu", dev):
        model = dnn_sr.create_sr_model(algo, 2)
        state, opt = dnn_sr.init_state(model, torch.Generator().manual_seed(0), lr[:1].to(device))
        state, loss = dnn_sr.make_train_step(model, opt)(state, lr.to(device), hr.to(device))
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        results.append((float(loss), {k: p.detach().cpu() for k, p in state.params.items()}, grads))
    (loss_cpu, params_cpu, grads_cpu), (loss_card, params_card, _) = results
    np.testing.assert_allclose(loss_card, loss_cpu, rtol=1e-4)
    for k, p in params_card.items():
        diff = (p - params_cpu[k]).abs()
        assert diff.max() <= 2e-3, k
        decided = grads_cpu[k].abs() >= 1e-4
        assert not decided.any() or diff[decided].max() <= 1e-5, k


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["scan", "vmap"])
def test_batched_bursts_on_card_equal_single_calls(mode):
    """make_batched_pipeline at RAW_BENCH on 4 distinct bursts on the
    card (vmap: over 4 mesh positions on cuda:0): each output equal to its
    single call bit for bit (no kernel of csrc/ uses atomics), each burst
    launching what a single call launches."""
    dev = cuda_device()
    bursts = torch.stack([tt(synthetic_raw_burst(np.random.default_rng(seed), 5, 128, 256, 2.5,
                                                 angles=CITY_ANGLES)[0], dev) for seed in range(4)])
    single = functools.partial(handheld_superres_raw, cfg=RAW_BENCH)
    LAUNCHES.clear()
    singles = [single(b) for b in bursts]
    one = dict(LAUNCHES)
    mesh = parallel_mesh.make_mesh(("data",), (4,), [dev] * 4) if mode == "vmap" else None
    LAUNCHES.clear()
    out = make_batched_pipeline(single, mesh, mode=mode)(bursts)
    assert dict(LAUNCHES) == one and out.device == dev
    for i in range(4):
        assert torch.equal(out[i], singles[i]), i


@pytest.mark.cuda
def test_sharded_raw_on_card_matches_cpu_sharded():
    """handheld_superres_raw_sharded at RAW_BENCH (pre-alignment on, halo
    2 * pipeline_halo(prealign_px=8) = 128 rows) over 4 shards of 128 rows
    on cuda:0, against the same run over 4 positions on the CPU: the
    interior (2 * halo output rows trimmed) at 60 dB, each shard launching
    the single run's kernels."""
    dev = cuda_device()
    angles = (0.0,) + tuple(np.random.default_rng(3).uniform(-0.01, 0.01, 4).tolist())
    raw = synthetic_raw_burst(np.random.default_rng(5), 5, 512, 256, 2.5, angles=angles)[0]
    halo = 2 * pipeline_halo(RAW_BENCH, prealign_px=8)
    outs = []
    for device in (dev, torch.device("cpu")):
        mesh = parallel_mesh.make_mesh(("spatial",), (4,), [device] * 4)
        LAUNCHES.clear()
        outs.append(nn(handheld_superres_raw_sharded(tt(raw, device), RAW_BENCH, mesh, halo=halo)))
        if device == dev:
            assert dict(LAUNCHES) == {"tile_search": 8, "tile_warp": 4, "merge_raw": 4}
    m = 2 * halo
    assert outs[0].shape == (1024, 512, 3)
    assert psnr(outs[0][m:-m], outs[1][m:-m]) >= 60.0


@pytest.mark.cuda
def test_native_reader_build_status(tmp_path):
    """The native reader on the GPU host: built (and then reading a PNG as
    the numpy reader does), or not, with the reason; printed either way."""
    cuda_device()
    from multi_frame_super_resolution_tpu_torch.data import imread, imwrite, native

    print(f"native reader: available {native.available()}; {native.build_error() or native.LIBRARY}")
    if not native.available():
        assert native.build_error()
        return
    img = np.random.default_rng(0).integers(0, 256, (24, 40, 3)).astype(np.uint8)
    imwrite(tmp_path / "x.png", img)
    np.testing.assert_array_equal(imread(tmp_path / "x.png"), img.astype(np.float32) * np.float32(1.0 / 255.0))


# the bfloat16 forms against their plain versions: a weight that
# ex2.approx and torch.exp round to neighbouring bfloat16 values moves
# one term by a bfloat16 step (2^-8 of it), and the bfloat16 sums after it
# may round the other way; at most BF16_SHARE of the values (or two, on
# the tiny shapes) lie beyond float32 rounding (1e-4), none beyond
# BF16_TOL (RAW and RGB order 0) or CBF16_TOL (the centroid's products,
# S rho (w c) up to ~4 x 1.4)
BF16_TOL = dict(rtol=2**-5, atol=2**-6)
CBF16_TOL = dict(rtol=1e-4, atol=2**-4)
BF16_SHARE = 1e-3


def _assert_bf16_close(got, want, tol):
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, **tol)
        beyond = int(((g - w_).abs() > 1e-4 + 1e-4 * w_.abs()).sum())
        assert beyond <= max(2, BF16_SHARE * g.numel()), beyond


# the knob variants of the RAW merge: (keyword arguments, tolerance)
RAW_KNOBS = {
    "exact_weights": (dict(order=1, exact_weights=True), None),
    "exact_weights9": (dict(order=1, moment_slots=9, exact_weights=True), None),
    "block": (dict(order=1, centroid_cert=True, centroid_block=True), None),
    "shared_res": (dict(order=1, centroid_cert=True, centroid_shared_res=True), None),
    "prune": (dict(order=1, centroid_cert=True, centroid_prune=1.0), None),
    "prune-shared_res": (dict(order=1, centroid_cert=True, centroid_prune=1.0, centroid_shared_res=True), None),
    "exact_weights-block": (dict(order=1, exact_weights=True, centroid_block=True), None),
    "centroid_bf16": (dict(order=1, centroid_cert=True, centroid_bf16=True), CBF16_TOL),
    "exact_weights-centroid_bf16": (dict(order=1, exact_weights=True, centroid_bf16=True), CBF16_TOL),
    "bf16": (dict(order=0, bf16=True), BF16_TOL),
}


@pytest.mark.cuda
@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
@pytest.mark.parametrize("hh,hw", [(128, 256), (37, 61), (3, 5)])
@pytest.mark.parametrize("cfa", [((0, 1), (1, 2)), ((2, 1), (1, 0))])
@pytest.mark.parametrize("scale", [1, 2, 3, 4])
@pytest.mark.parametrize("knob", list(RAW_KNOBS))
def test_raw_merge_kernel_knob_forms_match_plain(knob, scale, cfa, hh, hw, guided):
    """The knobs' kernel variants (csrc/merge_raw.cu: the exact weights
    at 4 and 9 slots, the block and shared-residual centroid, the
    centroid's tap bits, bfloat16 centroid products, the bfloat16 order
    0) against their plain versions at the path's taps, F = 9 at scales
    1-4, both Bayer orders, the path's shape, a ragged one and one smaller
    than the halo. The float32 variants at ORDER1_TOL (1e-4); the
    bfloat16 ones by _assert_bf16_close."""
    dev = cuda_device()
    kw, tol = RAW_KNOBS[knob]
    ins = _raw_merge_inputs(np.random.default_rng(scale * 7 + hh), 9, hh, hw, dev)
    if guided:
        kw = dict(kw, guide=fast_merge.green_guide_planes(ins[0], cfa).contiguous())
    args = (cfa, scale, 1, 1.0, (scale / 2.0) ** 2, 1.5)
    LAUNCHES.clear()
    got = merge_raw(*ins, *args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["merge_raw"] == 1
    want = merge_raw_plain(*ins, *args, **kw)
    assert len(got) == len(want)
    if tol is None:
        for g, w_ in zip(got, want):
            torch.testing.assert_close(g, w_, rtol=1e-4, atol=1e-4)
    else:
        _assert_bf16_close(got, want, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(256, 512), (37, 61), (3, 5)])
@pytest.mark.parametrize(
    "f,scale,radius,k_max",
    [(f, s, 1, None) for f in (1, 2, 5) for s in (1, 2, 3, 4)] + [(2, 2, 8, 64.0), (2, 2, 10, 64.0)],
)
def test_merge_kernel_bf16_form_matches_plain(f, scale, radius, k_max, h, w):
    """Form 4, the default RGB branch's bfloat16 order 0 (phase layout,
    bfloat16 products and per-frame sums, a float32 sum over frames),
    against its plain version at e^-1.5, by _assert_bf16_close: F = 1, 2
    and 5 at scales 1-4 (lane pairs of two phase columns, of two phase
    rows and a lone phase at s = 3, of two pixels at s = 1), and tap radii
    9 and 11 at s = 2 (k_max 64 keeps the outer taps; the staged halo
    reaches 9 and 11)."""
    dev = cuda_device()
    ins = [tt(x, dev) for x in _merge_inputs(np.random.default_rng(f * 10 + scale + 3 + radius), f, h, w)]
    kw = dict(phase_output=True, prune_exp=1.5, bf16=True)
    k_max = k_max or (scale / 2.0) ** 2
    LAUNCHES.clear()
    got = merge_fast(*ins, scale, radius, 1.0, k_max, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["merge_fast"] == 1
    _assert_bf16_close(got, merge_fast_plain(*ins, scale, radius, 1.0, k_max, **kw), BF16_TOL)
    with pytest.raises(ValueError, match="phase layout"):
        merge_fast(*ins, scale, 1, 1.0, k_max, prune_exp=1.5, bf16=True)


@pytest.mark.cuda
def test_bf16_forms_round():
    """The bfloat16 forms compute another function than the float32
    ones: at the path's shapes most values differ from the float32 form's
    beyond float32 rounding, the order-0 sums by less than 2^-5 relative
    (a few bfloat16 steps)."""
    dev = cuda_device()
    raw = _raw_merge_inputs(np.random.default_rng(1), 5, 128, 256, dev)
    args = (((0, 1), (1, 2)), 2, 1, 1.0, 1.0, 1.5)
    rgb = [tt(x, dev) for x in _merge_inputs(np.random.default_rng(2), 5, 256, 512)]
    pairs = [
        (merge_raw(*raw, *args, order=0, bf16=True), merge_raw(*raw, *args, order=0), True),
        (merge_raw(*raw, *args, centroid_cert=True, centroid_bf16=True)[1:3],
         merge_raw(*raw, *args, centroid_cert=True)[1:3], False),
        (merge_fast(*rgb, 2, 1, 1.0, 1.0, phase_output=True, prune_exp=1.5, bf16=True),
         merge_fast(*rgb, 2, 1, 1.0, 1.0, phase_output=True, prune_exp=1.5), True),
    ]
    for b16, f32, sums in pairs:
        for b, f in zip(b16, f32):
            diff = (b - f).abs()
            assert (diff > 1e-4 + 1e-4 * f.abs()).double().mean().item() > 0.5
            if sums:
                assert (diff / f.abs().clamp_min(1e-2)).max().item() < 2**-5


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,n,h,w,t,amp",
    [(4, 4, 128, 256, 16, 20), (2, 5, 37, 61, 8, 9), (3, 5, 33, 66, 32, 20), (1, 9, 16, 44, 4, 5),
     (2, 3, 40, 61, 12, 20), (1, 2, 10, 1500, 1, 800)],
)
@pytest.mark.parametrize("bound", [16, 6, 4, 30, 700])
def test_tile_warp_onehot_map_matches_plain(b, n, h, w, t, amp, bound):
    """The one-hot index map (warp_matmul=False): tile_warp_select's
    function, the two-level indexing at bounds 16, 30 and 700 (coarse
    steps 6, 8 and 37) and the direct one at bounds 4 and 6 (windows 9
    and 13); T = 12, not a power of two, and T = 4 and 12, where a block's
    8 rows straddle two tile rows; T = 1 on 1,500 columns at bound 700,
    whose index tables pass 48 KB (the per-element form); exact. At
    bound 16 it differs from the separable map where a band crosses a
    tile seam."""
    dev = cuda_device()
    rng = np.random.default_rng(h + bound)
    imgs = tt(rng.random((b, n, h, w)).astype(np.float32), dev)
    shifts = tt(rng.integers(-amp, amp + 1, (b, -(-h // t), -(-w // t), 2)).astype(np.int32), dev)
    LAUNCHES.clear()
    got = tile_warp(imgs, shifts, t, bound, onehot=True)
    torch.cuda.synchronize()
    assert LAUNCHES["tile_warp"] == 1
    torch.testing.assert_close(got, warp_fast.tile_warp_select(imgs, shifts[:, None], t, bound), rtol=0, atol=0)
    if bound == 16 and amp > 6:
        assert bool((got != tile_warp(imgs, shifts, t, bound)).any())


# the RAW merge's forms and knobs on the general kernel: (keyword
# arguments, tolerance; None: _assert_bf16_close's rules with the given tolerance)
RAW_GENERAL = {
    "certless": (dict(order=1), dict(rtol=1e-5, atol=1e-5)),
    "order0": (dict(order=0), dict(rtol=1e-5, atol=1e-5)),
    "slots9": (dict(order=1, moment_slots=9), dict(rtol=1e-4, atol=1e-4)),
    "cert4": (dict(order=1, centroid_cert=True), dict(rtol=1e-4, atol=1e-4)),
    **{knob: (kw, dict(rtol=1e-4, atol=1e-4) if tol is None else None) for knob, (kw, tol) in RAW_KNOBS.items()},
}


@pytest.mark.cuda
@pytest.mark.parametrize("hh,hw", [(37, 61), (3, 5)])
@pytest.mark.parametrize(
    "scale,radius,cfa",
    [(5, 1, ((0, 1), (1, 2))), (6, 1, ((2, 1), (1, 0))), (2, 1, ((0, 1), (2, 1))), (3, 1, ((1, 1), (0, 2))),
     (2, 4, ((0, 1), (1, 2))), (7, 1, ((0, 1), (1, 2))), (5, 5, ((1, 0), (2, 1)))],
    ids=["S5", "S6", "cfa-0121", "cfa-1102-S3", "121taps", "S7", "169taps-S5"],
)
@pytest.mark.parametrize("form", list(RAW_GENERAL))
def test_raw_merge_general_form_matches_plain(form, scale, radius, cfa, hh, hw):
    """The general form in every form and knob of the RAW merge: scales
    5, 6 and 7 (phase groups over grid z past 32 phases), 121 taps
    (radius 4, rb 1: taps to +-5 at e^-60) and 169 at S = 5 (to +-6 at
    e^-100: a staged halo of 3), F = 5, guided for the bfloat16 order 0, a ragged
    size and one smaller than the taps' reach; two non-Bayer patterns on
    the non-Bayer kernel. Against the plain version at each form's
    tolerance, the bfloat16 ones by _assert_bf16_close."""
    dev = cuda_device()
    kw, tol = RAW_GENERAL[form]
    ins = _raw_merge_inputs(np.random.default_rng(scale * 7 + hh + radius), 5, hh, hw, dev)
    if form == "bf16":
        kw = dict(kw, guide=fast_merge.green_guide_planes(ins[0], cfa).contiguous())
    prune = {4: 60.0, 5: 100.0}.get(radius, 1.5)
    args = (cfa, scale, radius, 1.0, (scale / 2.0) ** 2, prune)
    if radius >= 4:
        assert len(fast_merge._active_taps(radius + 1, 1.0, scale, (scale / 2.0) ** 2, prune)) == (
            2 * radius + 3) ** 2
    LAUNCHES.clear()
    got = merge_raw(*ins, *args, **kw)
    torch.cuda.synchronize()
    launched = "merge_raw_general" if raw_merge_kernel.is_bayer(cfa) else "merge_raw_nonbayer"
    assert dict(LAUNCHES) == {launched: 1}
    want = merge_raw_plain(*ins, *args, **kw)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert g.shape == (2 * scale, 2 * scale, 3, hh, hw)
    if tol is None:
        _assert_bf16_close(got, want, CBF16_TOL if "centroid_bf16" in form else BF16_TOL)
    else:
        for g, w_ in zip(got, want):
            torch.testing.assert_close(g, w_, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "form,hh,hw",
    [(form, hh, hw) for hh, hw in ((9, 13), (3, 5)) for form in ("slots9", "cert4")]
    + [(knob, 9, 13) for knob in ("exact_weights", "exact_weights9", "block", "shared_res", "prune",
                                  "centroid_bf16")])
def test_raw_merge_past_any_general_block_matches_plain(form, hh, hw):
    """The 9-moment and per-cell forms of a Bayer merge at 3,721 taps (to
    +-30 at e^-1e4, S = 2), where the general cells block's frame ring and
    tap table pass a block's 232,448 bytes: the non-Bayer kernel runs it,
    with every knob of the two forms (at 9 x 13). F = 3, a ragged size and
    one smaller than the taps' reach. Against the plain version at the
    form's tolerance (the bfloat16 centroid by _assert_bf16_close)."""
    dev = cuda_device()
    kw, tol = RAW_GENERAL[form]
    ins = _raw_merge_inputs(np.random.default_rng(hh), 3, hh, hw, dev)
    args = (((0, 1), (1, 2)), 2, 29, 1.0, 1.0, 1e4)
    assert len(fast_merge._active_taps(30, 1.0, 2, 1.0, 1e4)) == 61 ** 2
    LAUNCHES.clear()
    got = merge_raw(*ins, *args, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"merge_raw_nonbayer": 1}
    want = merge_raw_plain(*ins, *args, **kw)
    if tol is None:
        _assert_bf16_close(got, want, CBF16_TOL)
        return
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, **tol)


def _ring_frames(scale: int, form: str, length) -> int:
    """Burst lengths past the certless / order-0 frame cap at ``scale``
    (halo 1) that exercise the streamed kernel's ring: the cap + 1, a
    last chunk of one frame, whole chunks only, and 130 frames."""
    lib = raw_merge_kernel.library()
    cap = lib.mfsr_merge_raw_max_frames(scale, 1, 0)
    chunk = lib.mfsr_merge_raw_stream_chunk(scale, 1, 0 if form == "certless" else 1)
    assert 1 <= chunk <= cap
    one_past = next(n * chunk + 1 for n in range(1, 1000) if n * chunk + 1 > cap + 1)
    whole = next(n * chunk for n in range(1, 1000) if n * chunk > cap)
    return {"cap+1": cap + 1, "chunk+1": one_past, "whole": whole, "130": 130}[length]


BAYER = ((0, 1), (1, 2))
_GREEN_ANTI = ((1, 0), (2, 1))  # a Bayer pattern with its greens on the other diagonal


def _shuffle_taps(monkeypatch, seed):
    """Hands the wrapper and the plain version the same tap list in
    another order (a permutation from ``seed``): a cell's bfloat16 sum
    follows the list's order, whatever the taps' groups."""
    active = fast_merge._active_taps

    def shuffled(*args, **kwargs):
        taps = list(active(*args, **kwargs))
        return [taps[n] for n in np.random.default_rng(seed).permutation(len(taps))]

    monkeypatch.setattr(fast_merge, "_active_taps", shuffled)
    monkeypatch.setattr(raw_merge_kernel, "_active_taps", shuffled)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["list", "shuffled", "guided"])
@pytest.mark.parametrize("frames", [1, 5, "cap"])
@pytest.mark.parametrize("cfa", [BAYER, _GREEN_ANTI])
@pytest.mark.parametrize("scale", [1, 2, 3, 4])
def test_raw_merge_bf16_order0_templated_matches_plain(scale, cfa, frames, variant, monkeypatch):
    """The templated bfloat16 order 0 (each tap-group pair's taps in the
    list's order) at S = 1-4, both green diagonals, F = 1, 5 and the frame
    cap of its halo, on the list's order, a permutation of it (the taps of
    a pair in another order; the wrapper and the plain version are handed
    the same list) and guided, at a ragged size. Launches merge_raw alone;
    against the plain version by _assert_bf16_close at BF16_TOL."""
    dev = cuda_device()
    if variant == "shuffled":
        _shuffle_taps(monkeypatch, scale)
    k_max = (scale / 2.0) ** 2
    args = (cfa, scale, 1, 1.0, k_max, 1.5)
    taps = tuple(raw_merge_kernel._active_taps(2, 1.0, scale, k_max, 1.5))
    cap = raw_merge_kernel.library().mfsr_merge_raw_max_frames(scale, raw_merge_kernel.tap_halo(taps), 1)
    f = cap if frames == "cap" else frames
    ins = _raw_merge_inputs(np.random.default_rng(100 + 10 * scale + f), f, 37, 61, dev)
    kw = dict(order=0, bf16=True)
    if variant == "guided":
        kw["guide"] = fast_merge.green_guide_planes(ins[0], cfa).contiguous()
    LAUNCHES.clear()
    got = merge_raw(*ins, *args, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"merge_raw": 1}
    _assert_bf16_close(got, merge_raw_plain(*ins, *args, **kw), BF16_TOL)


def _far_taps(monkeypatch, reach):
    """Hands the wrapper and the plain version the same sparse tap list,
    reaching +-``reach`` in both axes (in list order, ky outer)."""
    taps = [(ky, kx) for ky in (-reach, 1 - reach, -1, 0, 1, reach // 2, reach)
            for kx in (-reach, -1, 0, 1, reach - 1)]
    monkeypatch.setattr(fast_merge, "_active_taps", lambda *args, **kwargs: list(taps))
    monkeypatch.setattr(raw_merge_kernel, "_active_taps", lambda *args, **kwargs: list(taps))
    return tuple(taps)


@pytest.mark.cuda
@pytest.mark.parametrize("reach", [80, 400])
@pytest.mark.parametrize("scale", [1, 2])
@pytest.mark.parametrize("form", ["certless", "order0", "slots9", "cert4", "bf16", "centroid_bf16"])
def test_raw_merge_nonbayer_windows_match_plain(form, scale, reach, monkeypatch):
    """Taps reaching +-80 and +-400 (35 of them, a list handed to the
    wrapper and the plain version alike; omega x 1e-4 x (80 / reach)^2,
    so that the far taps weigh): the non-Bayer kernel stages their rows in
    windows (more than one, from nonbayer_plan), each staged in turn, the
    bfloat16 knobs' with every frame or one tap a window (then its sums
    kept across chunks of one frame), and at +-400 on S = 1 forms 0 and 1
    on an 8 x 1 tile; S = 1 and 2, F = 3, 30 x 50 on ((0,
    1), (2, 1)). Launches merge_raw_nonbayer alone; against the plain
    version at the form's tolerance, its atol grown with the displacement
    where the form sums displacement terms (below), the bfloat16 ones by
    _assert_bf16_close."""
    dev = cuda_device()
    taps = _far_taps(monkeypatch, reach)
    kw, tol = RAW_GENERAL[form]
    planes, res, cert, om_g, om_rb = _raw_merge_inputs(np.random.default_rng(scale), 3, 30, 50, dev)
    ins = [planes, res, cert, om_g * (1e-4 * (80 / reach) ** 2), om_rb * (1e-4 * (80 / reach) ** 2)]
    # radius + ceil(rb) = reach: the plain version pads its planes by the taps' reach
    args = (NONBAYER["column"], scale, reach - 1, 1.0, (scale / 2.0) ** 2, 1.5)
    form_id = fast_merge.raw_merge_form(kw["order"], kw.get("moment_slots", 4), kw.get("centroid_cert", False))
    plan, windows = raw_merge_kernel.nonbayer_plan(scale, form_id, taps, 3, "bf16" in form)
    assert len(windows) > 1
    assert (plan[:2].tolist() == [8, 1]) == (reach == 400 and scale == 1 and form in ("certless", "order0", "bf16"))
    LAUNCHES.clear()
    got = merge_raw(*ins, *args, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"merge_raw_nonbayer": 1}
    want = merge_raw_plain(*ins, *args, **kw)
    if tol is None:
        _assert_bf16_close(got, want, CBF16_TOL if form == "centroid_bf16" else BF16_TOL)
        return
    # float32 sums of terms that grow with the taps' displacement (up to S x
    # reach an axis, against ~3 S at the path's taps), whose rounding the two
    # implementations take in different orders: the centroid chains by its
    # ratio, the moments (dy^2 w c, ...) by its square (an H100: certless at
    # +-400 3.6e-5 apart, 9 slots at +-80 5.6e-3 on moments of ~1e5); order 0
    # has no displacement term. A misread site moves a value by O(1) of it.
    grow = {"certless": reach / 3.0, "slots9": (reach / 3.0) ** 2, "cert4": (reach / 3.0) ** 2}.get(form, 1.0)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=tol["rtol"], atol=tol["atol"] * grow)


# 2 x 2 patterns the non-Bayer kernel takes: green in a column, green in a
# row, and one green site (B on two)
NONBAYER = {"column": ((0, 1), (2, 1)), "row": ((1, 1), (0, 2)), "one-green": ((0, 1), (2, 2))}


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 40])
@pytest.mark.parametrize("scale", [1, 2, 3, 5])
@pytest.mark.parametrize("pattern", list(NONBAYER))
@pytest.mark.parametrize("form", list(RAW_GENERAL))
def test_raw_merge_nonbayer_kernel_matches_plain(form, pattern, scale, frames):
    """The non-Bayer kernel in its four forms and every knob on three kinds
    of pattern, at S = 1, 2, 3 and 5, F = 1 and 40 (40: the float32 forms'
    frames in chunks through the ring at S = 1; the bfloat16 knobs' in
    windows of one tap), at a ragged size smaller than a tile. Launches
    merge_raw_nonbayer alone; against the plain version at each form's
    tolerance, the bfloat16 ones by _assert_bf16_close."""
    dev = cuda_device()
    kw, tol = RAW_GENERAL[form]
    cfa = NONBAYER[pattern]
    ins = _raw_merge_inputs(np.random.default_rng(10 * scale + frames), frames, 11, 19, dev)
    args = (cfa, scale, 1, 1.0, (scale / 2.0) ** 2, 1.5)
    LAUNCHES.clear()
    got = merge_raw(*ins, *args, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"merge_raw_nonbayer": 1}
    want = merge_raw_plain(*ins, *args, **kw)
    assert [g.shape for g in got] == [w_.shape for w_ in want]
    if tol is None:
        _assert_bf16_close(got, want, CBF16_TOL if "centroid_bf16" in form else BF16_TOL)
    else:
        for g, w_ in zip(got, want):
            torch.testing.assert_close(g, w_, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "form,frames,launched,scale,cfa",
    [("certless", 31, "merge_raw_stream", 2, BAYER), ("certless", 70, "merge_raw_stream", 4, BAYER),
     ("order0", 31, "merge_raw_stream", 2, BAYER), ("order0", 70, "merge_raw_stream", 4, BAYER),
     ("bf16", 31, "merge_raw_general", 2, BAYER), ("certless", 1, "merge_raw_general", 2, BAYER),
     ("order0", 1, "merge_raw_general", 2, BAYER), ("bf16", 40, "merge_raw_general", 2, BAYER),
     ("bf16", 1, "merge_raw_general", 2, BAYER), ("bf16", 130, "merge_raw_general", 2, BAYER),
     ("certless", 130, "merge_raw_general", 2, BAYER)]
    # the streamed kernel's ring at every scale and both green diagonals
    + [(form, length, "merge_raw_stream", scale, cfa) for form in ("certless", "order0") for scale in (1, 2, 3, 4)
       for cfa in (BAYER, _GREEN_ANTI) for length in ("cap+1", "chunk+1", "whole", "130")],
)
@pytest.mark.parametrize("hh,hw", [(40, 72), (3, 5), (37, 61)])
def test_raw_merge_streams_any_frames(form, frames, launched, scale, cfa, hh, hw):
    """Bursts past the certless and order-0 frame caps (30 at S = 2, 66 at
    S = 4, halo 1): the float32 forms stream through the streamed
    kernel's ring, at scales 1-4 and both green diagonals on bursts whose
    last chunk is partial (the cap + 1), holds one frame, or is whole, and
    on 130 frames; the bfloat16 order 0 through the general form (at F =
    40 one chunk, staged once; at F = 130 and S = 2 more frames than the
    general form's chunk, each chunk staged once a pass of 4 taps); F = 1
    with a 121-tap list runs the general form, at F = 130 with 121 taps
    it streams chunks too. A ragged size, one that no tile divides and
    one smaller than the taps' reach. Against the plain version at
    rtol/atol 1e-5 (the bfloat16 one by _assert_bf16_close)."""
    dev = cuda_device()
    kw = RAW_GENERAL[form][0]
    radius, prune = (4, 60.0) if frames == 1 or (frames == 130 and form == "certless") else (1, 1.5)
    if isinstance(frames, str):  # a ring case
        frames = _ring_frames(scale, form, frames)
        rng = np.random.default_rng(frames + scale)
    else:
        rng = np.random.default_rng(frames)
    ins = _raw_merge_inputs(rng, frames, hh, hw, dev)
    args = (cfa, scale, radius, 1.0, (scale / 2.0) ** 2, prune)
    LAUNCHES.clear()
    got = merge_raw(*ins, *args, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {launched: 1}
    want = merge_raw_plain(*ins, *args, **kw)
    if form == "bf16":
        _assert_bf16_close(got, want, BF16_TOL)
        return
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1, 2, 3, 4])
def test_raw_merge_stream_ring_halo2(scale):
    """The ring at a staged halo of 2 (taps to +-3, smaller chunks): the
    certless form on the cap + 1 and 130 frames, a 5 x 37 image, against
    the plain version at rtol/atol 1e-5."""
    dev = cuda_device()
    cfa = ((0, 1), (1, 2))
    args = (cfa, scale, 2, 1.0, 4.0 * (scale / 2.0) ** 2, 6.0)
    assert raw_merge_kernel.tap_halo(tuple(fast_merge._active_taps(3, 1.0, scale, args[4], 6.0))) == 2
    cap = raw_merge_kernel.library().mfsr_merge_raw_max_frames(scale, 2, 0)
    for frames in (cap + 1, 130):
        ins = _raw_merge_inputs(np.random.default_rng(frames), frames, 5, 37, dev)
        LAUNCHES.clear()
        got = merge_raw(*ins, *args)
        torch.cuda.synchronize()
        assert dict(LAUNCHES) == {"merge_raw_stream": 1}
        for g, w_ in zip(got, merge_raw_plain(*ins, *args)):
            torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_raw_merge_stream_entry_takes_the_float32_forms_past_the_cap():
    """mfsr_merge_raw_stream runs the certless and order-0 forms past the
    frame cap at scales 1-4 (its ring, mfsr_merge_raw_stream_chunk
    frames a slot, is fixed at build time: smaller at halo 2, none for
    another scale, halo or form) and refuses the other forms and scales;
    mfsr_merge_raw refuses a burst past the cap of those forms."""
    dev = cuda_device()
    lib = raw_merge_kernel.library()
    for scale in (1, 2, 3, 4):
        for form in (0, 1):
            assert lib.mfsr_merge_raw_stream_chunk(scale, 1, form) > lib.mfsr_merge_raw_stream_chunk(scale, 2, form) >= 1
    assert [lib.mfsr_merge_raw_stream_chunk(*a) for a in ((5, 1, 0), (2, 3, 0), (2, 1, 2))] == [0, 0, 0]
    taps = tuple(fast_merge._active_taps(2, 1.0, 2, 1.0, 1.5))
    table = raw_merge_kernel.tap_table(taps, BAYER)
    frames = lib.mfsr_merge_raw_max_frames(2, 1, 0) + 1
    ins = _raw_merge_inputs(np.random.default_rng(0), frames, 8, 40, dev)
    out = torch.empty((4, 4, 4, 3, 8, 40), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def args(scale, form):
        return [t.data_ptr() for t in ins] + [out.data_ptr(), frames, 8, 40, scale, form, 1.0, table.ctypes.data,
                                              len(taps)]

    assert lib.mfsr_merge_raw_stream(*args(2, 0), stream) == 0
    assert lib.mfsr_merge_raw_stream(*args(2, 1), stream) == 0
    assert lib.mfsr_merge_raw_stream(*args(2, 2), stream) != 0
    assert lib.mfsr_merge_raw_stream(*args(5, 0), stream) != 0
    assert lib.mfsr_merge_raw(*args(2, 0), 0, stream) != 0
    torch.cuda.synchronize()


# the RGB merge's forms on the general kernel: (keyword arguments, tolerance)
RGB_GENERAL = {
    "interleaved": (dict(), dict(rtol=1e-5, atol=1e-5)),
    "phase": (dict(phase_output=True), dict(rtol=1e-5, atol=1e-5)),
    "order1": (dict(phase_output=True, order=1), dict(rtol=1e-4, atol=1e-4)),
    "slots9": (dict(phase_output=True, order=1, moment_slots=9), dict(rtol=1e-4, atol=1e-4)),
    "bf16": (dict(phase_output=True, bf16=True), None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(37, 61), (3, 5)])
@pytest.mark.parametrize(
    "scale,radius,k_max,launched",
    [(5, 1, None, "merge_fast_general"), (6, 2, None, "merge_fast_general"), (2, 8, 64.0, "merge_fast"),
     (3, 10, 64.0, "merge_fast"), (7, 1, None, "merge_fast_general"), (2, 19, 1e4, "merge_fast"),
     (5, 7, 64.0, "merge_fast_general"), (2, 28, 1e4, "merge_fast_general"), (1, 34, 1e4, "merge_fast_unstaged"),
     (2, 34, 1e4, "merge_fast_unstaged"), (1, 39, 1e4, "merge_fast_unstaged")],
    ids=["S5", "S6", "r9", "r11", "S7", "r20", "S5-r8", "r29", "r35", "r35-S2", "r40"])
@pytest.mark.parametrize("form", list(RGB_GENERAL))
def test_merge_general_form_matches_plain(form, scale, radius, k_max, launched, h, w):
    """The RGB merge's five forms past the templated layouts' first build:
    scales 5, 6 and 7 (phase rows over grid z past 1024 threads) and s = 5
    at tap radius 8 on the general form; tap radii 9, 11 and 20 at s = 2-3
    on the templated kernel (its staged halo now reaches 25; at radius 20
    the tile keeps its rows, the frame buffers up to 166 KB); tap radius
    29 on the general form in bands of tap rows (k_max 64 or 1e4 keeps the
    outer taps); tap radius 35 at s = 1 and 2 and 40 at s = 1, launched as
    merge_fast_unstaged (the kernel these ran on before). These shapes are
    small: each launch spreads frames (and, but for bfloat16, bands of
    taps) over grid z and adds the parts after. The interleaved form
    (use_pallas) past radius 8 raises, as merge_fast_pallas does. Against
    the plain version at each form's tolerance."""
    dev = cuda_device()
    kw, tol = RGB_GENERAL[form]
    ins = [tt(x, dev) for x in _merge_inputs(np.random.default_rng(scale * 3 + h), 3, h, w)]
    args = (scale, radius, 1.0, k_max or (scale / 2.0) ** 2)
    kw = dict(kw, prune_exp=1.5)
    if form == "interleaved" and radius > 7:
        with pytest.raises(ValueError, match="merge_fast_pallas"):
            merge_fast(*ins, *args, **kw)
        return
    LAUNCHES.clear()
    got = merge_fast(*ins, *args, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {launched: 1}
    want = merge_fast_plain(*ins, *args, **kw)
    if tol is None:
        _assert_bf16_close(got, want, BF16_TOL)
    else:
        for g, w_ in zip(got, want):
            torch.testing.assert_close(g, w_, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("f,h,w,split", [(5, 16, 32, True), (3, 256, 528, False)], ids=["split", "whole"])
@pytest.mark.parametrize("form", list(RGB_GENERAL)[1:])
def test_merge_wide_taps_split_matches_plain(form, f, h, w, split):
    """A tap reach of 35 (5,041 taps, s = 1) on either side of the general
    form's split: at 5 x 16 x 32 its grid holds under a wave, so frames
    and (but for bfloat16) bands of taps spread over grid z and
    merge_fast_combine_kernel adds the parts; at 3 x 256 x 528 it holds
    more, one part. Against the plain version at each form's tolerance."""
    dev = cuda_device()
    kw, tol = RGB_GENERAL[form]
    ins = [tt(x, dev) for x in _merge_inputs(np.random.default_rng(h), f, h, w)]
    args = (1, 34, 1.0, 1e4)
    kw = dict(kw, prune_exp=6.0)
    form_id = 4 if kw.get("bf16") else (3 if kw.get("moment_slots") == 9 else (2 if kw.get("order") else 1))
    plan = merge_kernel.general_plan(1, form_id, (35, 1.0, 1, 1e4, 6.0), f, h, w)
    assert (plan.parts > 1) == split and (plan.tap_groups == 1 or form != "bf16")
    LAUNCHES.clear()
    got = merge_fast(*ins, *args, **kw)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"merge_fast_unstaged": 1}
    want = merge_fast_plain(*ins, *args, **kw)
    if tol is None:
        _assert_bf16_close(got, want, BF16_TOL)
    else:
        for g, w_ in zip(got, want):
            torch.testing.assert_close(g, w_, **tol)
