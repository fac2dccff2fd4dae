"""The values the port refused on the card until its general kernel forms
(scales past 4, taps past +-4, RGB tap radii past 8, long RAW bursts,
any 2 x 2 pattern, any tile size and search radius), on the CPU against
the JAX package: the RAW merge at the function level at scales 5 and 6
in every form, the host logic the general forms add (which kernel runs,
their tables) against transcriptions of the kernels' builds, a
transcription of the general tile search against the plain search, and
the RAW pipeline on a 31-frame burst. The RGB merge at scales 5 and 6
and the other pipelines at these values are in
tests/test_torch_port_limits_*.py, so that their JAX compilations (5-45 s
each here) spread over the workers; the card runs the same values in
tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import SMALL_SHIFTS, nn, psnr, search_inputs, tied_minima, to_jax, tt

from multi_frame_super_resolution_tpu.models import fast_merge as jfm
from multi_frame_super_resolution_tpu.models.handheld import (
    handheld_superres_raw as jax_handheld_superres_raw,
)
from multi_frame_super_resolution_tpu_torch.config import RAW_PORT_DEFAULT
from multi_frame_super_resolution_tpu_torch.data import synthetic_raw_burst
from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels import merge as merge_kernel
from multi_frame_super_resolution_tpu_torch.kernels import merge_raw as raw_kernel
from multi_frame_super_resolution_tpu_torch.kernels import tile_search as search_kernel
from multi_frame_super_resolution_tpu_torch.kernels.merge_raw import merge_raw_plain
from multi_frame_super_resolution_tpu_torch.models import fast_merge
from multi_frame_super_resolution_tpu_torch.models.handheld import handheld_superres_raw
from multi_frame_super_resolution_tpu_torch.registration import tiles

# order 0 sums w c v and w c: rounding alone; the order-1 moments sum
# terms of mixed sign up to (r + rb) s (tests/test_torch_knob_merge.py)
TOL = dict(rtol=1e-5, atol=1e-5)
ORDER1_TOL = dict(rtol=1e-4, atol=1e-4)


def _planes_inputs(rng, f, hh, hw):
    planes = rng.random((f, 2, 2, hh, hw)).astype(np.float32)
    residual = rng.normal(0.0, 0.4, (f, hh, hw, 2)).astype(np.float32)
    cert = rng.random((f, hh, hw, 3)).astype(np.float32)
    om_g = (rng.random((hh, hw, 3)) * 0.5 + 0.5).astype(np.float32)
    om_g[..., 2] = 0.1
    om_rb = (rng.random((hh, hw, 3)) * 0.5 + 0.4).astype(np.float32)
    om_rb[..., 2] = 0.05
    return planes, residual, cert, om_g, om_rb


# merge_burst_raw_planes' forms: (keyword arguments, outputs, tolerance)
RAW_FORMS = {
    "order0": (dict(order=0), 2, TOL),
    "certless": (dict(order=1, moment_slots=4, centroid_cert=False), 4, ORDER1_TOL),
    "slots9": (dict(order=1, moment_slots=9), 9, ORDER1_TOL),
    "cert4": (dict(order=1, moment_slots=4, centroid_cert=True), 4, ORDER1_TOL),
}
# a Bayer pattern at scale 5, a non-Bayer one (green in one column) at 6
SCALE_CFA = {5: ((1, 0), (2, 1)), 6: ((0, 1), (2, 1))}


@pytest.mark.parametrize("scale", [5, 6])
@pytest.mark.parametrize("form", list(RAW_FORMS))
def test_raw_merge_forms_match_jax_past_scale_4(form, scale):
    """Every form of merge_burst_raw_planes at scales 5 and 6 (the general
    kernel's scales on the card), the second on a non-Bayer pattern,
    against the JAX function in the phase layout at the spec of
    tests/test_torch_knob_merge.py (radius 1, residual bound 0.5, e^-3),
    at each form's tolerance."""
    kw, n_out, tol = RAW_FORMS[form]
    cfa = SCALE_CFA[scale]
    ins = _planes_inputs(np.random.default_rng(10 * scale + len(form)), 3, 8, 10)
    spec = dict(radius=1, residual_bound=0.5, k_max=(scale / 2.0) ** 2, prune_exp=3.0)
    want = jfm.merge_burst_raw_planes(*(jnp.asarray(x) for x in ins), cfa, scale, **spec, phase_output=True,
                                      **kw)
    got = merge_raw_plain(*(tt(x) for x in ins), cfa, scale, **spec, **kw)
    assert len(got) == len(want) == n_out
    for g, w_ in zip(got, want):
        assert g.shape == (2 * scale, 2 * scale, 3, 8, 10)
        np.testing.assert_allclose(nn(g), np.asarray(w_), **tol)


def _frame_cap(scale: int, halo: int) -> int:
    """A transcription of csrc/merge_raw.cu's max_frames for the certless
    and order-0 forms: every frame's staged tile (kTileH + 2 halo rows of
    32 + 2 halo sites, four planes of float2) and its residual (float2 a
    pixel) in 227 KB."""
    tile_h = 4 if scale <= 2 else 1
    sites = (tile_h + 2 * halo) * (32 + 2 * halo)
    return 227 * 1024 // ((4 * sites + 32 * tile_h) * 8)


def test_frame_cap_transcription():
    """The caps the card reports (tests/test_torch_cuda.py::
    test_raw_merge_kernel_frame_cap_by_scale) at halo 1 and 2."""
    assert {s: (_frame_cap(s, 1), _frame_cap(s, 2)) for s in (1, 2, 3, 4)} == {
        1: (30, 22), 2: (30, 22), 3: (66, 38), 4: (66, 38)}


BAYER = ((0, 1), (1, 2))


@pytest.mark.parametrize(
    "scale,radius,prune,cfa,frames,form,bf16,general,launched",
    [
        (2, 1, 1.5, BAYER, 5, fast_merge.CERTLESS, False, False, "merge_raw"),  # the main path
        (4, 1, 1.5, BAYER, 66, fast_merge.ORDER0, True, False, "merge_raw"),
        (2, 3, 20.0, BAYER, 22, fast_merge.ORDER0, True, False, "merge_raw"),  # 69 taps to +-4: halo 2, a cap of 22
        (5, 1, 1.5, BAYER, 5, fast_merge.CERTLESS, False, True, "merge_raw_general"),
        (6, 1, 1.5, BAYER, 5, fast_merge.PER_CELL, False, True, "merge_raw_general"),
        (2, 4, 60.0, BAYER, 5, fast_merge.CERTLESS, False, True, "merge_raw_general"),  # 121 taps
        # other patterns: the non-Bayer kernel, not the general form
        (2, 1, 1.5, ((0, 1), (2, 1)), 5, fast_merge.NINE_MOMENTS, False, False, "merge_raw_nonbayer"),
        (2, 1, 1.5, ((1, 1), (0, 2)), 5, fast_merge.ORDER0, False, False, "merge_raw_nonbayer"),
        (2, 1, 1.5, BAYER, 31, fast_merge.CERTLESS, False, False, "merge_raw_stream"),  # streamed
        (2, 1, 1.5, BAYER, 31, fast_merge.ORDER0, False, False, "merge_raw_stream"),  # streamed
        # the bfloat16 order 0 has no templated streamed form: the general form streams it
        (2, 1, 1.5, BAYER, 31, fast_merge.ORDER0, True, True, "merge_raw_general"),
        (4, 1, 1.5, BAYER, 67, fast_merge.ORDER0, True, True, "merge_raw_general"),
        (2, 2, 20.0, BAYER, 23, fast_merge.ORDER0, True, True, "merge_raw_general"),  # 49 taps to +-3: halo 2
        (2, 1, 1.5, BAYER, 500, fast_merge.PER_CELL, False, False, "merge_raw"),  # a frame ring: no cap
        (5, 5, 100.0, ((2, 1), (1, 0)), 5, fast_merge.PER_CELL, False, True, "merge_raw_general"),  # 169 taps
        # past any general block (3,721 taps to +-30: the cells ring and tap
        # table past 232,448 bytes): the non-Bayer kernel; the certless form
        # still fits there
        (2, 29, 1e4, BAYER, 5, fast_merge.PER_CELL, False, True, "merge_raw_nonbayer"),
        (2, 29, 1e4, BAYER, 5, fast_merge.NINE_MOMENTS, False, True, "merge_raw_nonbayer"),
        (2, 29, 1e4, BAYER, 5, fast_merge.CERTLESS, False, True, "merge_raw_general"),
    ],
)
def test_raw_merge_uses_general_exactly_past_the_builds(scale, radius, prune, cfa, frames, form, bf16, general,
                                                        launched):
    """merge_raw runs the templated kernels wherever they are built for the
    call (scales 1-4, taps within +-4, Bayer; the bfloat16 order 0
    within the frame cap of the taps' halo), the general form on every
    other Bayer merge that a general block takes and the non-Bayer kernel
    on other patterns and past any general block."""
    taps = tuple(fast_merge._active_taps(radius + 1, 1.0, scale, (scale / 2.0) ** 2, prune))
    if radius >= 4:
        assert len(taps) == (2 * radius + 3) ** 2
    cap = _frame_cap(scale, min(raw_kernel.tap_halo(taps), 2)) if scale <= 4 else 0
    assert raw_kernel.uses_general(scale, taps, cfa, frames, form, cap, bf16) == general
    assert raw_kernel.kernel_name(scale, taps, cfa, frames, form, cap, bf16) == launched


@pytest.mark.parametrize("form", [fast_merge.CERTLESS, fast_merge.ORDER0, fast_merge.NINE_MOMENTS,
                                  fast_merge.PER_CELL])
def test_raw_general_block_fits(form):
    """The RAW general form's block (general_block) at every scale 1-8,
    staged halos 1-15 (taps reaching 0-30) with the most taps that reach
    (the full square) and 1, 5, 40 and 130 frames: its threads within
    the kernel's 512 (a block's z within 64), its phase groups covering
    the scale's phases with none empty, its shared bytes the layout's
    (forms 0 and 1: the chunk's frames, each four planes' tile and halo
    and the residual, 8 B a site, and two ints a tap; forms 2 and 3: the
    ring's three slots, 8 B a site, and two float4 rows a tap) within
    232,448, the chunk (forms 0 and 1) the most frames that fit, at least
    one; None exactly where not one frame fits."""
    cells = form in (fast_merge.NINE_MOMENTS, fast_merge.PER_CELL)
    for scale in range(1, 9):
        n = scale * scale
        for halo in range(1, 16):
            n_taps = (4 * halo + 1) ** 2
            for frames in (1, 5, 40, 130):
                blk = raw_kernel.general_block(scale, halo, n_taps, frames, form)
                if cells:
                    stage = 4 * (1 + 2 * halo) * (8 + 2 * halo) + 3 * 10
                    smem = ((3 * stage + 1) // 2 * 2) * 8 + 32 * n_taps
                    if smem > 232448:
                        assert blk is None
                        continue
                    tw, th, phases, groups, chunk, got = blk
                    assert (tw, th, chunk, got) == (8, 1, 0, smem)
                    assert (phases + 3) // 4 * 32 <= 512 and phases <= 32
                    assert 1 + groups * (phases - 1) >= n > 1 + (groups - 1) * (phases - 1) or groups == 1 == n
                    continue
                tw, th = (16, 4 if n <= 8 else (2 if n <= 16 else 1)) if n <= 16 else (8, 1)
                frame = (4 * (th + 2 * halo) * (tw + 2 * halo) + tw * th) * 8
                fit = (232448 - 8 * n_taps) // frame
                if fit < 1:
                    assert blk is None
                    continue
                assert blk[:2] == (tw, th)
                _, _, phases, groups, chunk, smem = blk
                assert tw * th * phases <= 512 and phases <= 64
                assert phases * groups >= n > phases * (groups - 1)
                assert chunk == min(frames, fit) >= 1
                assert smem == chunk * frame + 8 * n_taps <= 232448
    # the S = 5 check's blocks (8 x 1 pixels x 25 phases; the cells forms one
    # group a pair), and 3,721 taps past any cells block
    assert raw_kernel.general_block(5, 1, 25, 5, form)[:5] == ((8, 1, 25, 1, 0) if cells else (8, 1, 25, 1, 5))
    assert (raw_kernel.general_block(2, 15, 3721, 5, form) is None) == cells


@pytest.mark.parametrize("form", [fast_merge.CERTLESS, fast_merge.ORDER0, fast_merge.NINE_MOMENTS,
                                  fast_merge.PER_CELL])
def test_certless_and_order0_stream_past_the_cap(form):
    """The certless and order-0 forms stage every frame's tile at once up
    to the cap (30 at S = 2, halo 1) and run the streamed kernel past it;
    the 9-moment and per-cell forms stream through their ring at any
    length (no separate form)."""
    cap = _frame_cap(2, 1)
    assert not raw_kernel.streams(form, cap, cap)
    assert raw_kernel.streams(form, cap + 1, cap) == (form in (fast_merge.CERTLESS, fast_merge.ORDER0))


@pytest.mark.parametrize("form", [fast_merge.CERTLESS, fast_merge.ORDER0])
@pytest.mark.parametrize("halo", [1, 2])
@pytest.mark.parametrize("scale", [1, 2, 3, 4])
def test_stream_routes_every_scale_and_halo(scale, halo, form):
    """Past the frame cap of the taps' staged halo (and only there) the
    float32 certless and order-0 forms run the streamed kernel, at every
    templated scale and both halos, and the bfloat16 order 0 the general
    form: on 1 frame, the cap, the cap + 1 and 130 frames."""
    radius, k_max, prune = (1, 1.0, 1.5) if halo == 1 else (2, 4.0, 6.0)
    taps = tuple(fast_merge._active_taps(radius + 1, 1.0, scale, k_max * (scale / 2.0) ** 2, prune))
    assert raw_kernel.tap_halo(taps) == halo
    cap = _frame_cap(scale, halo)
    for frames in (1, cap, cap + 1, 130):
        past = frames > cap
        assert raw_kernel.kernel_name(scale, taps, BAYER, frames, form, cap) == (
            raw_kernel.STREAM if past else raw_kernel.NAME)
        if form == fast_merge.ORDER0:
            assert raw_kernel.kernel_name(scale, taps, BAYER, frames, form, cap, True) == (
                raw_kernel.GENERAL if past else raw_kernel.NAME)


def _chain_id(cfa, a, b, ch):
    """fast_merge._centroid_chain's chain as the general kernel numbers it."""
    cid = fast_merge._centroid_chain(cfa, a, b, ch)
    if cid is None:
        return -1
    return cid[1] if cid[0] == "g" else 2 + 2 * cid[1] + cid[2]


@pytest.mark.parametrize("cfa", [BAYER, ((2, 1), (1, 0)), ((0, 1), (2, 1)), ((1, 1), (0, 2)), ((0, 0), (1, 2))])
def test_cell_table(cfa):
    """The general kernel's host table: each plane's channel, then each
    cell's certless chain in (a, b, ch) order; on a Bayer pattern each
    green cell reads the green chain of its diagonal and each R/B cell the
    chain of the tap parity that lands on its plane; a channel the
    pattern lacks has none."""
    table = raw_kernel.cell_table(cfa)
    assert table.dtype == np.int32 and table.shape == (16,)
    assert table[:4].tolist() == [cfa[0][0], cfa[0][1], cfa[1][0], cfa[1][1]]
    chains = table[4:].reshape(2, 2, 3)
    for a in (0, 1):
        for b in (0, 1):
            for ch in range(3):
                assert chains[a, b, ch] == _chain_id(cfa, a, b, ch)
                if ch not in np.asarray(cfa):
                    assert chains[a, b, ch] == -1
    if cfa == BAYER:
        # green at (0, 1) and (1, 0): parity (a, b) reads green for taps
        # with (a + ky + b + kx) odd; R at (0, 0) for ky = a, kx = b mod 2
        assert chains[0, 0].tolist() == [2, 1, 5] and chains[1, 1].tolist() == [5, 1, 2]


def _staged_offset(z, g, ky, kx, sa, sw):
    """A transcription of csrc/merge_raw.cu's staged_offset: the site
    parity z reads for a tap (ky, kx) of group g, plane z ^ g at
    ((a + ky) // 2, (b + kx) // 2)."""
    return (z ^ g) * sa + (((z >> 1) + ky) >> 1) * sw + (((z & 1) + kx) >> 1)


@pytest.mark.parametrize("radius,scale,centroid", [(4, 2, None), (5, 5, None), (5, 5, 1.0), (7, 3, 4.0)])
def test_tap_table_past_81_taps(radius, scale, centroid):
    """The host table of the templated and the general forms beyond the
    templated kernels' 81 taps (121, 169 and 289 taps), against a
    brute-force listing: the group ends (cumulative counts of the tap
    parities g = 2 (ky % 2) + kx % 2), each group's rows with the
    centroid's taps first and in list order within, each row's centroid
    flag and list index, the staged halo (the taps' reach in half-res
    sites), and the staged offsets the kernels form from each row: every
    parity reads a site inside its staged tile, at an offset whose
    difference from parity 0's is the group's own."""
    cfa = BAYER
    taps = tuple(fast_merge._active_taps(radius + 1, 1.0, scale, (scale / 2.0) ** 2, 1e3))
    assert len(taps) == (2 * radius + 3) ** 2 > 81
    inner = None if centroid is None else frozenset(
        fast_merge._active_taps(radius + 1, 1.0, scale, (scale / 2.0) ** 2, centroid))
    table = raw_kernel.tap_table(taps, cfa, inner)
    assert table[:4].tolist() == [0, 1, 1, 2]
    rows = table[8:].reshape(-1, 3)
    ends, listed = [], []
    for g in range(4):
        group = [(n, t) for n, t in enumerate(taps) if 2 * (t[0] % 2) + t[1] % 2 == g]
        flag = [inner is None or t in inner for _, t in group]
        listed += [n for (n, _), c in zip(group, flag) if c] + [n for (n, _), c in zip(group, flag) if not c]
        ends.append(len(listed))
    assert table[4:8].tolist() == ends
    assert [int(a) >> 1 for a in rows[:, 2]] == listed
    assert [tuple(r) for r in rows[:, :2].tolist()] == [taps[n] for n in listed]
    assert [int(a) & 1 for a in rows[:, 2]] == [int(inner is None or taps[n] in inner) for n in listed]
    np.testing.assert_array_equal(raw_kernel.table_rows(taps, cfa, inner), rows)
    halo = raw_kernel.tap_halo(taps)
    reach = radius + 1  # the taps' largest |ky|, |kx|
    assert halo == (reach + 1) // 2
    for tw, th in ((8, 1), (16, 4)):  # the general cells and certless tiles
        sw, sa = tw + 2 * halo, (th + 2 * halo) * (tw + 2 * halo)
        for ky, kx, _ in rows.tolist():
            g = 2 * (ky & 1) + (kx & 1)
            o0 = _staged_offset(0, g, ky, kx, sa, sw)
            for z in range(4):
                o = _staged_offset(z, g, ky, kx, sa, sw) - o0 + _staged_offset(0, g, g >> 1, g & 1, sa, sw)
                assert o == _staged_offset(z, g, g >> 1, g & 1, sa, sw)  # the group's fixed offset
                # from the tile's corner pixels, at (halo, halo) and (halo + th - 1,
                # halo + tw - 1) of their plane, the site stays in the staged tile
                for y, x in ((0, 0), (th - 1, tw - 1)):
                    assert 0 <= halo + y + ((z >> 1) + ky) // 2 < th + 2 * halo
                    assert 0 <= halo + x + ((z & 1) + kx) // 2 < sw


def test_general_taps_past_81():
    """The general kernel's device table: the 121 taps of +-5 in the
    list's order, (ky, kx, centroid bit), the bit cleared outside the
    pruned centroid's taps."""
    taps = tuple(fast_merge._active_taps(5, 1.0, 2, 1.0, 60.0))
    rows = raw_kernel.general_taps(taps)
    assert rows.shape == (121, 3) and rows.dtype == np.int32
    assert [tuple(r[:2]) for r in rows.tolist()] == list(taps)
    assert rows[:, 2].all()
    inner = frozenset(fast_merge._active_taps(5, 1.0, 2, 1.0, 1.0))
    rows = raw_kernel.general_taps(taps, inner)
    assert rows[:, 2].tolist() == [int(t in inner) for t in taps]
    assert 0 < rows[:, 2].sum() < 121


@pytest.mark.parametrize("listed", [False, True])
def test_nonbayer_rows_order(listed):
    """The non-Bayer kernel's tap rows: general_taps' (ky, kx, centroid
    bit) and a 0, in the list's order for the bfloat16 knobs and else
    sorted by tap-parity group, the list's order kept within a group."""
    taps = tuple(fast_merge._active_taps(3, 1.0, 2, 4.0, 6.0))
    inner = frozenset(fast_merge._active_taps(3, 1.0, 2, 4.0, 1.0))
    rows = raw_kernel.nonbayer_rows(taps, inner, listed)
    assert rows.shape == (len(taps), 4) and rows.dtype == np.int32 and not rows[:, 3].any()
    order = list(range(len(taps)))
    if not listed:
        order.sort(key=lambda n: 2 * (taps[n][0] % 2) + taps[n][1] % 2)
    assert [tuple(r[:2]) for r in rows.tolist()] == [taps[n] for n in order]
    assert rows[:, 2].tolist() == [int(taps[n] in inner) for n in order]
    windows = ((0, 3, -2, 0), (3, len(taps), -1, 2))
    table = raw_kernel.nonbayer_table(taps, inner, listed, windows)
    assert table.shape == (len(taps) + 2, 4) and table[len(taps):].tolist() == [list(w) for w in windows]


def _nonbayer_cases():
    """(scale, taps, frames): the full square of taps reaching 2 to 101 (past
    a block's shared memory: windows of rows) at scales 1-8 and 1 to 130
    frames, and a cross of taps reaching 400 (at S = 1 past what the
    32 x 8 tile's rows of sites hold: the 8 x 1 tile)."""
    def square(r):
        return tuple((ky, kx) for ky in range(-r, r + 1) for kx in range(-r, r + 1))

    cross = ((0, -400), (-400, 0), (0, 0), (1, 1), (400, 0), (0, 400))
    return [(s, square(r), f) for s in (1, 2, 3, 4, 5, 6, 8) for r, f in ((2, 1), (2, 5), (2, 40), (2, 130), (30, 3))] + [
        (2, square(101), 3), (5, square(60), 2), (1, square(2), 400), (1, cross, 5), (2, cross, 40)]


def _check_nonbayer_plan(form, listed, scale, taps, frames):
    """nonbayer_plan(scale, form, taps, frames, listed) against a
    transcription of the kernel's layout; returns the plan."""
    halves = 2 if form in (fast_merge.NINE_MOMENTS, fast_merge.PER_CELL) else 1
    plan, windows = raw_kernel.nonbayer_plan(scale, form, taps, frames, listed)
    tw, th, phases, groups, hx, rows, chunk, slots, n_win, smem, *ends = plan.tolist()
    n = scale * scale
    assert tw * th * phases * halves <= 512 and phases * halves <= 64
    assert tw * th * phases * halves >= 144 or tw == 8
    if groups == 1:
        assert phases == n
    else:
        assert 1 + groups * (phases - 1) >= n > 1 + (groups - 1) * (phases - 1)
    ky, kx = (raw_kernel.nonbayer_rows(taps, None, listed)[:, k] for k in (0, 1))
    assert hx == max(1, max(max(abs(k // 2), abs((k + 1) // 2)) for k in kx.tolist()))
    assert n_win == len(windows) and windows[0][0] == 0 and windows[-1][1] == len(taps)
    sw = tw + 2 * hx
    for (t0, t1, lo, hi), nxt in zip(windows, windows[1:] + ((len(taps),),)):
        assert t0 < t1 == nxt[0]
        assert (lo, hi) == (int((ky[t0:t1] // 2).min()), int(((ky[t0:t1] + 1) // 2).max()))
        assert th + hi - lo <= rows
        for k_y, k_x in zip(ky[t0:t1].tolist(), kx[t0:t1].tolist()):
            for z in range(4):
                for y, x in ((0, 0), (th - 1, tw - 1)):
                    assert 0 <= y - lo + ((z >> 1) + k_y) // 2 < th + hi - lo
                    assert 0 <= x + hx + ((z & 1) + k_x) // 2 < sw
    steps = n_win * -(-frames // chunk)
    assert 1 <= chunk <= frames and slots == (2 if steps > 1 else 1)
    ring = -(-slots * chunk * (4 * rows * sw + (th + 2) * (tw + 2)) * 8 // 16) * 16
    ring += chunk * 32 * tw * th * phases * halves if halves == 2 else 0  # the per-frame records
    assert ring <= smem <= 232448
    assert smem == max(ring, 144 * tw * th if form == fast_merge.PER_CELL else 0)
    if listed and chunk < frames:
        assert all(t1 - t0 == 1 for t0, t1, _, _ in windows)
    if listed:
        assert ends == [len(taps)] * 4
    else:
        g = [2 * (k_y % 2) + k_x % 2 for k_y, k_x in zip(ky.tolist(), kx.tolist())]
        assert g == sorted(g) and ends == np.cumsum([g.count(k) for k in range(4)]).tolist()
    return plan


@pytest.mark.parametrize("listed", [False, True])
@pytest.mark.parametrize("form", [fast_merge.CERTLESS, fast_merge.ORDER0, fast_merge.NINE_MOMENTS,
                                  fast_merge.PER_CELL])
def test_nonbayer_plan_fits_and_covers(form, listed):
    """nonbayer_plan against a transcription of the kernel's layout, at
    scales 1-8, tap reaches 2-101 (the full square of taps) and 400 (a
    cross of taps) and 1-400 frames: at most 512 threads and 64 a block's
    z, about 256 (32 pixels x the phases where they fit; 8 x 1 where a
    tile's rows of sites do not); phase groups covering the scale's
    phases (past one, each with phase 0 first, none empty); the windows
    covering the rows in order, each its taps' exact half-res row span,
    within the plan's rows; every site a thread reads for a window's taps
    inside its slot; the ring (slots x chunk frames of four planes' rows
    x (tw + 2 hx) sites and the residual's (th + 2) x (tw + 2), 8 B a
    site, 16-byte aligned; forms 2 and 3: 32 B more a thread and frame)
    and the shared residual's exchange within the bytes, those within
    232,448; two slots exactly where the steps are more than one; the
    bfloat16 knobs' taps in windows of one when the frames take chunks;
    the group ends the rows'."""
    for scale, taps, frames in _nonbayer_cases():
        plan = _check_nonbayer_plan(form, listed, scale, taps, frames)
        if max(abs(k) for t in taps for k in t) == 400:
            # forms 0 and 1 at S = 1: 32 x 8 pixels cannot stage 9 rows of 432 sites
            halves = 2 if form in (fast_merge.NINE_MOMENTS, fast_merge.PER_CELL) else 1
            assert (plan[:2].tolist() == [8, 1]) == (scale == 1 and halves == 1)
    # the main shapes: every frame at once in one window, 256 threads
    halves = 2 if form in (fast_merge.NINE_MOMENTS, fast_merge.PER_CELL) else 1
    taps = tuple(fast_merge._active_taps(2, 1.0, 2, 1.0, 1.5))
    plan, windows = raw_kernel.nonbayer_plan(2, form, taps, 5, listed)
    assert plan[:3].tolist() == ([32, 2, 4] if halves == 1 else [32, 1, 4]) and len(windows) == 1
    assert plan[6:8].tolist() == [5, 1]


def test_rgb_merge_uses_general_past_the_build():
    """merge_fast's general form runs at scales past 4 and taps reaching
    past 25 (kMaxRadius, the templated layouts' staged halo), the
    templated one elsewhere (tap radii 9-25 too); the interleaved form
    (use_pallas) refuses a tap radius past 8 on either device, as
    merge_fast_pallas does, and so does a scale below 1."""
    assert not merge_kernel.uses_general(2, 2) and not merge_kernel.uses_general(4, 8)
    assert not merge_kernel.uses_general(2, 9) and not merge_kernel.uses_general(4, 25)
    assert merge_kernel.uses_general(5, 2) and merge_kernel.uses_general(2, 26) and merge_kernel.uses_general(0, 1)
    z = [torch.zeros(s) for s in ((2, 8, 8, 3), (2, 8, 8, 2), (2, 8, 8, 3), (8, 8, 3))]
    with pytest.raises(ValueError, match="merge_fast_pallas's 8-row halo"):
        merge_kernel.merge_fast(*z, 2, 8, 1.0, 1.0)
    with pytest.raises(ValueError, match="scale"):
        merge_kernel.merge_fast(*z, 0, 1, 1.0, 1.0)
    LAUNCHES.clear()
    for out in merge_kernel.merge_fast(*z, 5, 8, 1.0, 1.0, phase_output=True):
        assert out.shape == (5, 5, 3, 8, 8)
    assert not LAUNCHES


def _templated_smem(scale: int, halo: int, form: int) -> int:
    """A transcription of csrc/merge.cu's templated launch: two frame
    buffers of its tile (kTileH rows of 32 pixels, Layout<S, kForm>) and
    halo, 48 B a site, or (form 0) one parked output array."""
    tile_h = {3: {1: 8, 2: 2}.get(scale, 1), 2: {1: 8, 2: 4}.get(scale, 2)}.get(form, 8)
    threads = 32 * tile_h * (scale * scale if form == 3 else (scale if form == 2 else 1))
    park = threads * scale * scale * 12 if form == 0 else 0
    return max((tile_h + 2 * halo) * (32 + 2 * halo) * 48, park)


@pytest.mark.parametrize("form", range(5))
def test_rgb_general_tile_fits(form):
    """The general form's block (general_tile) at every scale 1-8 and taps
    reaching 0-40 (and 287, where a tap row goes in column chunks): at
    least one pixel and one phase row, its threads within the kernel's
    bound (512 for form 3 and for pieces, else 1024), its phase rows covering the scale in the
    groups over grid z, its two buffers (48 B a staged site, 32 B a run)
    within 232,448 bytes. The whole tile and halo, 8 pixels wide, where
    they fit half of that (reaches to 22); past it bands of tap rows on a
    32-pixel-wide tile, within a quarter where one fits. The templated
    layouts within the same bytes at scales 1-4 and reaches to 25."""

    def staged(tw, th, band, cols):
        return (th + band - 1) * (tw + cols - 1) * 48 + band * 32

    for scale in range(1, 9):
        for halo in [*range(41), 287]:
            tw, th, rows, groups, band, cols = merge_kernel.general_tile(scale, halo, form)
            full = 2 * halo + 1
            assert tw >= 1 and th >= 1 and 1 <= rows <= scale and 1 <= band <= full and 1 <= cols <= full
            assert tw * th * rows * scale <= (512 if form == 3 or band < full or cols < full else 1024)
            assert rows * groups >= scale and (rows - 1) * groups < scale
            assert staged(tw, th, band, cols) <= 232448
            if staged(8, 1, full, full) <= 232448 // 2:
                assert (tw, band, cols) == (8, full, full)
            else:
                assert tw == 32 and (band < full or staged(tw, th, band, cols) > 232448 // 4)
                assert cols == full or band == 1
            if scale <= 4 and halo <= 25:
                assert _templated_smem(scale, halo, form) <= 232448
    assert merge_kernel.general_tile(2, 34, form)[4:] == (11, 69)
    assert merge_kernel.general_tile(1, 35, form) == (32, 8, 1, 1, 4, 71)
    assert merge_kernel.general_tile(1, 287, form)[4:] == (1, 574)
    assert merge_kernel.general_tile(5, 2, form)[:4] == (8, 1, 5, 1)


# the general form's launches: (scale, radius, k_max, prune_exp, frames, h,
# w, whether the plan splits over grid z)
RGB_PLANS = {
    "r35-5x16x32": (1, 34, 1e4, 6.0, 5, 16, 32, True),  # chip_smoke.py's check
    "r35-4x64x128": (1, 34, 1e4, 6.0, 4, 64, 128, True),  # the limit path's burst
    "r35-3x256x528": (1, 34, 1e4, 6.0, 3, 256, 528, False),
    "r35-S2-37x61": (2, 34, 1e4, 6.0, 3, 37, 61, True),
    "r40-3x5": (1, 39, 1e4, 6.0, 3, 3, 5, True),
    "S5-5x256x512": (5, 1, 6.25, 1.5, 5, 256, 512, False),  # chip_smoke.py's s=5 check: one piece
    "S5-3x37x61": (5, 1, 6.25, 1.5, 3, 37, 61, True),
    "S7-1x3x5": (7, 1, 12.25, 1.5, 1, 3, 5, True),  # one frame: taps alone (none in bfloat16)
}


@pytest.mark.parametrize("form", range(5))
@pytest.mark.parametrize("case", list(RGB_PLANS))
def test_rgb_general_plan_covers_taps_and_frames(case, form):
    """general_plan: its pieces hold the tap list's runs in the list's
    order, each within the tile's band and columns and its buffers; its
    bytes within 232,448; the frame chunks and tap groups cover every
    frame and every piece once, in order (the combine's order), bfloat16
    (form 4) never split over taps; a split exactly where the grid holds
    under a wave of an H100 (132 SMs times the blocks an SM holds); the
    device table as csrc/merge.cu reads it."""
    scale, radius, k_max, prune, frames, h, w, split = RGB_PLANS[case]
    key = (radius + 1, 1.0, scale, k_max, prune)
    taps = merge_kernel.tap_array(*key)
    plan = merge_kernel.general_plan(scale, form, key, frames, h, w)
    halo = int(np.abs(taps).max())
    tw, th, rows, groups, band, cols = merge_kernel.general_tile(scale, halo, form)
    assert (plan.tile_w, plan.tile_h, plan.rows, plan.groups) == (tw, th, rows, groups)
    split = split and (form != 4 or frames > 1)  # bfloat16 splits frames alone
    assert (plan.parts > 1) == split and (plan.tap_groups == 1 or form != 4)
    # the runs, piece by piece, are the tap list in order
    listed = [(ky, kx0 + k) for p in plan.pieces for ky, kx0, n in plan.runs[p[4]:p[5]] for k in range(n)]
    assert listed == [tuple(t) for t in taps.tolist()]
    assert [p[4] for p in plan.pieces[1:]] == [p[5] for p in plan.pieces[:-1]] and plan.pieces[0][4] == 0
    for ky_lo, kx_lo, n_rows, n_cols, r0, r1 in plan.pieces:
        assert n_rows <= band and n_cols <= cols and (plan.whole or r1 - r0 <= plan.max_runs)
        assert (th + n_rows - 1) * (tw + n_cols - 1) <= plan.max_sites
        for ky, kx0, n in plan.runs[r0:r1]:
            assert ky_lo <= ky < ky_lo + n_rows and kx_lo <= kx0 and kx0 + n <= kx_lo + n_cols
    assert plan.max_sites * 48 + plan.max_runs * 32 <= plan.smem <= 232448
    # frames and pieces split evenly, each once, none empty (csrc's ranges)
    fc, tg, n_pieces = plan.frame_chunks, plan.tap_groups, len(plan.pieces)
    chunks = [range(c * frames // fc, (c + 1) * frames // fc) for c in range(fc)]
    assert [f for c in chunks for f in c] == list(range(frames)) and all(chunks)
    pieces = [range(g * n_pieces // tg, (g + 1) * n_pieces // tg) for g in range(tg)]
    assert [p for g in pieces for p in g] == list(range(n_pieces)) and all(pieces)
    blocks = -(-w // tw) * -(-h // th) * groups
    staged = (th + band - 1) * (tw + cols - 1) * 48 + band * 32  # the tile's band, before the split's
    per_sm = max(1, min(2048 // (tw * th * rows * scale), 233472 // (staged + 1024), 32))
    assert (blocks < 132 * per_sm) == RGB_PLANS[case][-1]
    # one piece and no split: the whole tile (runs in the parameters)
    assert plan.whole == (n_pieces == 1 and (band, cols) == (2 * halo + 1,) * 2 and plan.parts == 1)
    table = merge_kernel.general_table(scale, form, key, frames, h, w).reshape(-1, 4)
    assert table.dtype == np.int32 and len(table) == 2 * n_pieces + len(plan.runs)
    for i, (ky_lo, kx_lo, n_rows, n_cols, r0, r1) in enumerate(plan.pieces):
        sw = tw + n_cols - 1
        assert table[2 * i].tolist() == [ky_lo, kx_lo, sw, (th + n_rows - 1) * sw]
        assert table[2 * i + 1].tolist() == [r0, r1 - r0, 0, 0]
        for j, (ky, kx0, n) in enumerate(plan.runs[r0:r1]):
            row = table[2 * n_pieces + r0 + j]
            assert row[:2].view(np.float32).tolist() == [ky * scale, kx0 * scale]
            assert row[2:].tolist() == [(ky - ky_lo) * sw + kx0 - kx_lo, n]


def test_rgb_general_pieces_chunk_long_runs():
    """general_pieces past any band (a tap row in chunks of ``cols``
    columns): the runs split at ``cols`` taps, the pieces one run each,
    the list's order kept; within a band, rows join a piece."""
    taps = np.asarray([(ky, kx) for ky in range(-2, 3) for kx in range(-2, 3)], np.int32)
    pieces, runs = merge_kernel.general_pieces(taps, 1, 3)
    assert runs == tuple((ky, kx, n) for ky in range(-2, 3) for kx, n in ((-2, 3), (1, 2)))
    assert pieces == tuple((r[0], r[1], 1, r[2], i, i + 1) for i, r in enumerate(runs))
    pieces, runs = merge_kernel.general_pieces(taps, 2, 5)
    assert runs == tuple((ky, -2, 5) for ky in range(-2, 3))
    assert pieces == ((-2, -2, 2, 5, 0, 2), (0, -2, 2, 5, 2, 4), (2, -2, 1, 5, 4, 5))


def _max_radius(t: int) -> int:
    """A transcription of csrc/tile_search.cu's mfsr_tile_search_max_radius:
    the largest radius whose staging (window rows padded to an odd stride
    past 3 offsets, the tile, the row energies, the surface) fits 48 KB,
    -1 for a tile size without a templated build."""
    if t not in (8, 16, 32):
        return -1

    def floats(r):
        t2, s_n = t + 2 * r, 2 * r + 1
        return t2 * ((t2 + 2) | 1) + t * (t + 1) + t2 * s_n + s_n * s_n

    r = 0
    while 4 * floats(r + 1) <= 48 * 1024:
        r += 1
    return r


@pytest.mark.parametrize(
    "t,radius,general",
    [(16, 4, False), (16, 27, False), (16, 28, True), (16, 0, True), (8, 1, False), (32, 9, False),
     (12, 4, True), (48, 4, True), (5, 2, True)],
)
def test_tile_search_uses_general_past_the_build(t, radius, general):
    """The general search runs for tile sizes other than 8, 16 and 32,
    radius 0 and radii past the 48 KB staging (27 at T = 16)."""
    assert _max_radius(16) == 27
    assert search_kernel.uses_general(t, radius, _max_radius(t)) == general


@pytest.mark.parametrize(
    "t,radius",
    [(12, 4), (16, 0), (16, 30), (16, 70), (5, 2), (48, 4), (24, 1), (33, 40), (64, 40), (24, 10), (24, 11),
     (16, 100), (200, 20), (16, 120), (240, 1), (16, 23000)],
)
def test_search_plan_fits_and_covers(t, radius):
    """The general search's staging (search_plan): its bytes (a
    transcription of csrc/tile_search.cu's general_floats) within
    232,448; (offsets, tile row) items exactly where the offset items
    would leave more than half of 256 threads idle; the whole window and
    tile where they fit, with the surface in shared memory where it fits
    beside them; else bands whose stages cover every (offset row, tile
    row) pair once, each offset's rows in row order (the sums' order), and
    stage every window row those pairs read."""
    plan = search_kernel.search_plan(t, radius)
    s_n = 2 * radius + 1
    n_v = -(-s_n // 4) * 4
    stride = (n_v + t - 1) | 1

    def floats(bu, bt, surf):
        return (bt * t + (bu + bt - 1) * stride + (bt * bu * n_v if plan.split else 0)
                + (s_n * s_n if surf else 0))

    assert plan.smem == 4 * floats(plan.bu, plan.bt, plan.surf_smem) <= 232448
    assert 1 <= plan.bu <= s_n and 1 <= plan.bt <= t
    assert plan.split == (2 * s_n * -(-s_n // 4) <= 256)
    whole = [surf for surf in (True, False) if 4 * floats(s_n, t, surf) <= 232448]
    if whole:
        assert (plan.bu, plan.bt, plan.surf_smem) == (s_n, t, whole[0])
    if s_n * t > 1e5:
        return  # the pairs' walk below: too many to list
    seen = {u: [] for u in range(s_n)}
    for u0 in range(0, s_n, plan.bu):  # the kernel's loops
        for i0 in range(0, t, plan.bt):
            rows = range(u0 + i0, u0 + i0 + min(plan.bu, s_n - u0) + min(plan.bt, t - i0) - 1)
            for u in range(u0, min(u0 + plan.bu, s_n)):
                for i in range(i0, min(i0 + plan.bt, t)):
                    assert u + i in rows
                    seen[u].append(i)
    assert all(v == list(range(t)) for v in seen.values())


def general_search(ref, alts, rounded, t, radius, threshold, subpixel, mode):
    """A transcription of csrc/tile_search.cu's general search: per (frame,
    tile, offset) the sum of (F - W)^2 over the reference tile (clamped to
    the image) and the window at the offset (clamped per pixel at the
    tile's prediction; image mode: tile_warp_select's source per pixel),
    then find_min_shift (first minimum, the gates, the fit where a 3 x 3
    neighbourhood exists). float64 sums."""
    n, h, w = alts.shape
    nty, ntx = tiles.tile_counts(h, w, t)
    if mode == "image":
        alts = tiles.tile_warp_select(alts, rounded.to(torch.int32), t)
    s_n = 2 * radius + 1
    rows = torch.arange(nty)[:, None] * t + torch.arange(t)  # (nty, t)
    cols = torch.arange(ntx)[:, None] * t + torch.arange(t)
    ref_t = ref.double()[rows.clamp(max=h - 1)[:, None, :, None], cols.clamp(max=w - 1)[None, :, None, :]]
    ssd = torch.empty((n, nty, ntx, s_n, s_n), dtype=torch.float64)
    pre = (torch.zeros_like(rounded) if mode == "image" else rounded).long()
    # the window's columns at every offset v: (ntx, t + 2R), then (ntx, s_n, t)
    wcols = torch.arange(ntx)[:, None] * t + torch.arange(t + 2 * radius) - radius
    for k in range(n):
        wx = (wcols[None] + pre[k, :, :, 1, None]).clamp(0, w - 1)  # (nty, ntx, t + 2R)
        for u in range(s_n):
            wy = (rows[:, None, :] + pre[k, :, :, 0, None] + u - radius).clamp(0, h - 1)  # (nty, ntx, t)
            win = alts[k].double()[wy[..., :, None], wx[..., None, :]]  # (nty, ntx, t, t + 2R)
            win = win.unfold(-1, t, 1)  # (nty, ntx, t, s_n, t): offset v, column j
            ref_b = ref_t[:, :, :, None, :]
            ssd[k, :, :, u] = ((ref_b - win) ** 2).sum((-3, -1))
    return rounded + tiles.find_min_shift(ssd.float(), radius, threshold, subpixel)


@pytest.mark.parametrize(
    "h,w,t,radius,mode",
    [(48, 60, 12, 4, "image"), (48, 60, 12, 3, "tile"), (40, 56, 16, 0, "tile"), (40, 56, 16, 0, "image"),
     (40, 72, 16, 30, "tile"), (30, 44, 5, 2, "tile")],
)
def test_general_search_transcription_matches_plain(h, w, t, radius, mode):
    """The general search's function against the plain search (the
    wrapper on CPU tensors): integer parts equal, subpixel shifts within
    1e-3 px, at T = 12 and 5, radius 0 (the prediction itself) and a
    radius past the templated kernel's 27 at T = 16."""
    inputs = search_inputs(h, w, SMALL_SHIFTS, t)
    # exact ties of clamped patches are ranked by rounding: left out
    untied = torch.from_numpy(
        ~tied_minima(*inputs, t, radius) if mode == "tile" else np.ones(inputs[2].shape[:3], bool))
    ref, alts, rounded = (tt(x) for x in inputs)
    for sub in (False, True):
        LAUNCHES.clear()
        want = search_kernel.tile_search(ref, alts, rounded, t, radius, 0.0, sub, mode)
        assert not LAUNCHES
        got = general_search(ref, alts, rounded, t, radius, 0.0, sub, mode)
        if radius == 0:
            torch.testing.assert_close(got, rounded, rtol=0, atol=0)
        torch.testing.assert_close(got[untied], want[untied], rtol=0, atol=1e-3 if sub else 0.0)


def test_raw_pipeline_on_31_frames_matches_jax():
    """A 31-frame burst at 64 x 128 RAW (motion up to 2.5 px), past the
    certless merge's 30-frame cap at scale 2 (a general-kernel merge on
    the card), through RAW_PORT_DEFAULT's path against the jitted JAX
    pipeline: 60 dB. Measured 119.7 dB."""
    raw = synthetic_raw_burst(np.random.default_rng(0), 31, 64, 128, 2.5)[0]
    want = nn(jax.jit(jax_handheld_superres_raw, static_argnums=1)(jnp.asarray(raw), to_jax(RAW_PORT_DEFAULT)))
    got = nn(handheld_superres_raw(tt(raw), RAW_PORT_DEFAULT, device="cpu"))
    assert got.shape == (128, 256, 3) and np.isfinite(got).all()
    assert psnr(got, want) >= 60.0
