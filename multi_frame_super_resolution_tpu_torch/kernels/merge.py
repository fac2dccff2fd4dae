"""Wrapper of the Hopper merge kernels (csrc/merge.cu), the counterpart of
pallas_ops/merge.py::merge_fast_pallas and of the default RGB branch's
merge (models/fast_merge.py::merge_burst_fast in the phase layout, order
0 in float32 or bfloat16, or the order-1 moments of the plugin solve (4)
or the exact solve (9)). The templated kernel takes scales 1-4 and taps
within +-25; its general form (S = 0) every other scale and any taps
(uses_general), staged in pieces of the tap list and spread over the card
as general_plan says, its launches counted under ``merge_fast_general``,
or past a tap reach of 34 under ``merge_fast_unstaged`` (the name of the
kernel those merges ran before, kept so that counts compare).

On CUDA tensors it launches the kernel or raises; it never falls back.
On CPU tensors it computes the kernel's plain PyTorch version,
models/fast_merge.py::merge_burst_fast, with the same taps, through
``merge_fast_plain`` (the plain version with the wrapper's signature).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
from multi_frame_super_resolution_tpu_torch.kernels.build import (
    bind,
    check_tensor,
    launch,
    load_library,
)
from multi_frame_super_resolution_tpu_torch.models.fast_merge import (
    _active_taps,
    merge_burst_fast,
)
from multi_frame_super_resolution_tpu_torch.ops.filters import _const_array

NAME = "merge_fast"
GENERAL = "merge_fast_general"  # the general form's launches
WIDE = "merge_fast_unstaged"  # the general form's launches past a tap reach of WIDE_REACH
WIDE_REACH = 34
SOURCE = "merge.cu"
# merge_fast_pallas's own halo (pallas_ops/merge.py:154), which the
# interleaved form (use_pallas) keeps
_PALLAS_RADIUS = 8
_MAX_TAP_RADIUS = 25  # kMaxRadius in csrc/merge.cu: the templated layouts' largest staged halo
_SMEM_MAX = 232448  # kMaxSmem: the shared memory a block can opt in to (sm_90)
_SITE_BYTES = 48  # a staged site: a float4 and a float2, in two buffers
_RUN_BYTES = 32  # a staged run: an int4, in two buffers
# an H100's SMs, and what one SM holds: threads, shared memory (the
# plans' estimate of the blocks in flight)
_SMS, _SM_THREADS, _SM_SMEM = 132, 2048, 233472


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = bind(
        load_library(SOURCE), "mfsr_merge_fast",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float],
    )
    return bind(
        lib, "mfsr_merge_fast_general",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
        + [ctypes.c_void_p] + [ctypes.c_int] * 10 + [ctypes.c_void_p],
    )


def uses_general(scale: int, halo: int) -> bool:
    """Whether the templated kernel's layouts do not take the merge: a
    scale past 4 or taps reaching past +-25 (``halo``: the largest
    |ky|, |kx| of the list). general_plan then gives the general form's
    launch."""
    return not 1 <= scale <= 4 or halo > _MAX_TAP_RADIUS


def _staged(tw: int, th: int, band: int, cols: int) -> int:
    """Bytes of the general form's two buffers for a piece of ``band`` tap
    rows and ``cols`` tap columns (at most ``band`` runs) on a tw x th
    tile: its (th + band - 1) x (tw + cols - 1) sites and its runs."""
    return (th + band - 1) * (tw + cols - 1) * _SITE_BYTES + band * _RUN_BYTES


@functools.lru_cache(maxsize=None)
def general_tile(scale: int, halo: int, form: int) -> Tuple[int, int, int, int, int, int]:
    """The general form's block at ``scale`` for taps of reach ``halo`` in
    kernel form ``form``: (tile_w, tile_h, rows, groups, band, cols), a
    thread per pixel of a tile_w x tile_h tile and phase of ``rows`` phase
    rows, grid z over the ``groups`` of rows, within the form's thread
    bound (form 3's 27 accumulators: 512, else 1024); the taps staged in
    pieces of at most ``band`` tap rows and ``cols`` tap columns (then
    within 512 threads: merge_fast_pieces_kernel's bound).

    - The whole tile and halo (band = cols = 2 halo + 1), where its two
      buffers fit half of the 232,448 bytes a block may have: 8 pixels
      wide (a warp reads 8 sites at 4 phases; small blocks, several an SM:
      at s = 5 it measured fastest of widths 4, 8, 16 and 32 on an NVIDIA
      H100), taller at scales below 3 (to 256 threads).
    - Past that (a reach past 22), bands of tap rows on a 32-pixel-wide
      tile, as tall as 256 threads allow: a band's buffers within a
      quarter of 232,448 bytes (four blocks an SM), or within all of it;
      past any band (a reach past 286 at s = 1), a tap row at a time in
      chunks of ``cols`` columns."""
    full = 2 * halo + 1

    def block(tw, fits=lambda th: True, max_threads=512 if form == 3 else 1024):
        while tw > 1 and tw * scale > max_threads:
            tw //= 2
        th = 1
        while th < 8 and fits(2 * th) and tw * 2 * th * scale * scale <= 256:
            th *= 2
        rows = max(1, min(scale, max_threads // (tw * th * scale)))
        groups = -(-scale // rows)
        return tw, th, -(-scale // groups), groups  # the groups evened out

    tw, th, rows, groups = block(8)
    if _staged(tw, 1, full, full) <= _SMEM_MAX // 2:
        tw, th, rows, groups = block(8, lambda th: _staged(tw, th, full, full) <= _SMEM_MAX)
        return tw, th, rows, groups, full, full
    tw, th, rows, groups = block(32, max_threads=512)  # the pieces kernel's bound
    for budget in (_SMEM_MAX // 4, _SMEM_MAX):
        band = max((b for b in range(1, full + 1) if _staged(tw, th, b, full) <= budget), default=0)
        if band:
            return tw, th, rows, groups, band, full
    cols = (_SMEM_MAX - _RUN_BYTES) // (th * _SITE_BYTES) - tw + 1
    return tw, th, rows, groups, 1, min(cols, full)


def general_pieces(taps: np.ndarray, band: int, cols: int) -> Tuple[tuple, tuple]:
    """The tap list (n, 2) as the general form's pieces: (pieces, runs),
    runs (ky, kx0, len) of consecutive taps of one row (kx rising by 1, at
    most ``cols`` long) in list order, and pieces (ky_lo, kx_lo, tap rows,
    tap columns, first run, end run) of consecutive runs whose taps span at
    most ``band`` rows and ``cols`` columns."""
    runs = []
    for ky, kx in taps.tolist():
        last = runs[-1] if runs else None
        if last and last[0] == ky and last[1] + last[2] == kx and last[2] < cols:
            last[2] += 1
        else:
            runs.append([ky, kx, 1])
    pieces, span = [], None
    for i, (ky, kx0, n) in enumerate(runs):
        if span is not None:
            y_lo, x_lo, y_hi, x_hi = min(span[0], ky), min(span[1], kx0), max(span[2], ky), max(span[3], kx0 + n - 1)
            if y_hi - y_lo < band and x_hi - x_lo < cols:
                span = [y_lo, x_lo, y_hi, x_hi]
                continue
            pieces.append((span[0], span[1], span[2] - span[0] + 1, span[3] - span[1] + 1, first, i))
        span, first = [ky, kx0, ky, kx0 + n - 1], i
    if span is not None:
        pieces.append((span[0], span[1], span[2] - span[0] + 1, span[3] - span[1] + 1, first, len(runs)))
    return tuple(pieces), tuple(map(tuple, runs))


class GeneralPlan(NamedTuple):
    """A launch of the general form (csrc/merge.cu's Geometry): the block,
    the splits over grid z, the pieces and the shared bytes."""

    tile_w: int
    tile_h: int
    rows: int
    groups: int  # of phase rows
    frame_chunks: int
    tap_groups: int  # of pieces
    whole: bool  # one piece, the whole tile and halo: merge_fast_kernel<0, form>
    pieces: tuple  # (ky_lo, kx_lo, tap rows, tap columns, first run, end run)
    runs: tuple  # (ky, kx0, len)
    max_sites: int
    max_runs: int
    smem: int

    @property
    def parts(self) -> int:
        """The partial sums the combine adds (1: no split)."""
        return self.frame_chunks * self.tap_groups


@functools.lru_cache(maxsize=None)
def general_plan(scale: int, form: int, key: tuple, frames: int, h: int, w: int) -> GeneralPlan:
    """The general form's launch for the taps tap_array(*key) at ``scale``
    in kernel form ``form`` over F x h x w inputs: general_tile's block,
    and where its grid holds less than one wave (132 SMs times the blocks
    an SM holds), chunks of the frames and (form 4 aside: its per-frame
    bfloat16 sums are one chain) groups of pieces over grid z, for about
    two waves; the pieces then as many as the tap groups want, each at
    most the tile's band. The combine adds the parts in chunk order, then
    group order. ``whole``: one piece, the whole tile and halo, no split
    (merge_fast_kernel<0, form>, its runs in the kernel's parameters);
    else merge_fast_pieces_kernel<form> and the device table
    (general_table)."""
    taps = tap_array(*key)
    halo = int(np.abs(taps).max(initial=0))
    tw, th, rows, groups, band, cols = general_tile(scale, halo, form)
    threads = tw * th * rows * scale
    blocks = -(-w // tw) * -(-h // th) * groups
    per_sm = max(1, min(_SM_THREADS // threads, _SM_SMEM // (_staged(tw, th, band, cols) + 1024), 32))
    want = -(-2 * _SMS * per_sm // blocks) if blocks < _SMS * per_sm else 1
    frame_chunks = min(frames, want)
    tap_groups = 1 if form == 4 else -(-want // frame_chunks)
    whole = band == cols == 2 * halo + 1 and tap_groups == frame_chunks == 1
    if tap_groups > 1:
        tap_rows = int(np.ptp(taps[:, 0])) + 1
        band = min(band, -(-tap_rows // tap_groups))
    if whole:  # staged from -halo in both axes, as the templated kernel stages
        _, runs = general_pieces(taps, band, cols)
        pieces = ((-halo, -halo, band, cols, 0, len(runs)),)
    else:
        pieces, runs = general_pieces(taps, band, cols)
    tap_groups = max(1, min(tap_groups, len(pieces)))
    max_sites = max((th + p[2] - 1) * (tw + p[3] - 1) for p in pieces)
    max_runs = 0 if whole else max(p[5] - p[4] for p in pieces)
    park = th * rows * tw * scale * 12 if form == 0 else 0  # form 0's parked output rows
    smem = max(max_sites * _SITE_BYTES + max_runs * _RUN_BYTES, park)
    return GeneralPlan(tw, th, rows, groups, frame_chunks, tap_groups, whole, pieces, runs, max_sites,
                       max_runs, smem)


def general_table(scale: int, form: int, key: tuple, frames: int, h: int, w: int) -> np.ndarray:
    """general_plan's device table (csrc/merge.cu's Geometry), int32: per
    piece (ky_lo, kx_lo, staged row length, staged sites) and (first run,
    runs, 0, 0), then per run (ky s, kx0 s as float32 bits, the offset of
    its first site from the piece's first, len)."""
    plan = general_plan(scale, form, key, frames, h, w)
    rows, runs = [], []
    for ky_lo, kx_lo, n_rows, n_cols, r0, r1 in plan.pieces:
        sw = plan.tile_w + n_cols - 1
        rows += [ky_lo, kx_lo, sw, (plan.tile_h + n_rows - 1) * sw, r0, r1 - r0, 0, 0]
        for ky, kx0, n in plan.runs[r0:r1]:
            kys, kxs = np.asarray([ky * scale, kx0 * scale], np.float32).view(np.int32).tolist()
            runs += [kys, kxs, (ky - ky_lo) * sw + kx0 - kx_lo, n]
    return np.asarray(rows + runs, np.int32)


def tap_array(
    r_taps: int, residual_bound: float, scale: int, k_max: float, prune_exp: float = 6.0
) -> np.ndarray:
    """The kernel's host tap list: fast_merge._active_taps as contiguous
    int32 (n, 2) rows (ky, kx), built once per key and read-only (shared
    by every call)."""
    return _tap_array(r_taps, float(residual_bound), scale, float(k_max), float(prune_exp))


@functools.lru_cache(maxsize=None)
def _tap_array(r_taps: int, residual_bound: float, scale: int, k_max: float, prune_exp: float) -> np.ndarray:
    taps = np.ascontiguousarray(
        np.asarray(
            _active_taps(r_taps, residual_bound, scale, k_max, prune_exp), np.int32
        ).reshape(-1, 2)
    )
    taps.flags.writeable = False
    return taps


@functools.lru_cache(maxsize=None)
def _tap_args(
    r_taps: int, residual_bound: float, scale: int, k_max: float, prune_exp: float = 6.0
) -> Tuple[int, int]:
    """(host address, count) of tap_array's rows: what a launch passes."""
    taps = tap_array(r_taps, residual_bound, scale, k_max, prune_exp)
    return taps.ctypes.data, len(taps)


@functools.lru_cache(maxsize=None)
def _tap_reach(*key) -> int:
    """The largest |ky|, |kx| of tap_array(*key): the kernels' staged halo."""
    return int(np.abs(tap_array(*key)).max(initial=0))


def merge_fast_plain(
    warped: torch.Tensor,
    residual: torch.Tensor,
    certainty: torch.Tensor,
    omega_inv: torch.Tensor,
    scale: int,
    radius: int = 2,
    residual_bound: float = 1.0,
    k_max: float = 1.0,
    phase_output: bool = False,
    order: int = 0,
    prune_exp: float = 6.0,
    moment_slots: int = 4,
    bf16: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The plain version with ``merge_fast``'s signature: models/
    fast_merge.py::merge_burst_fast, which takes the JAX function's."""
    return merge_burst_fast(
        warped, residual, certainty, omega_inv, scale, radius, residual_bound, k_max,
        phase_output=phase_output, bf16=bf16, order=order, prune_exp=prune_exp, moment_slots=moment_slots,
    )


def merge_fast(
    warped: torch.Tensor,
    residual: torch.Tensor,
    certainty: torch.Tensor,
    omega_inv: torch.Tensor,
    scale: int,
    radius: int = 2,
    residual_bound: float = 1.0,
    k_max: float = 1.0,
    phase_output: bool = False,
    order: int = 0,
    prune_exp: float = 6.0,
    moment_slots: int = 4,
    bf16: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Static-tap merge: warped (F, H, W, 3), residual (F, H, W, 2),
    certainty (F, H, W, 3), omega_inv (H, W, 3), all float32 and
    contiguous on one device -> (num, den), each (sH, sW, 3), or
    (s, s, 3, H, W) with ``phase_output``; ``order=1`` (with
    ``phase_output``) -> the plugin solve's moments (m00, m01, m02, b0),
    or with ``moment_slots=9`` the exact solve's nine (see
    fast_merge.merge_burst_fast). Taps are those of
    fast_merge._active_taps at ``prune_exp``; the defaults are
    merge_fast_pallas's. ``bf16`` (order 0; order 1 ignores it):
    bfloat16 products and per-frame sums (the kernel's form 4, the phase
    layout only). The interleaved form (``phase_output=False``, order 0:
    merge_fast_pallas) refuses a tap radius past 8, as merge_fast_pallas
    does. On CUDA the outputs are views of one allocation."""
    if warped.ndim != 4:
        raise ValueError(f"warped must be (F, H, W, 3), got {tuple(warped.shape)}")
    f, h, w = warped.shape[:3]
    dev = warped.device
    check_tensor("warped", warped, (f, h, w, 3), dev)
    check_tensor("residual", residual, (f, h, w, 2), dev)
    check_tensor("certainty", certainty, (f, h, w, 3), dev)
    check_tensor("omega_inv", omega_inv, (h, w, 3), dev)
    if scale < 1:
        raise ValueError(f"the merge takes scale >= 1, got {scale}")
    if order not in (0, 1):
        raise ValueError(f"the merge takes order 0 or 1, got {order}")
    if order == 1 and not phase_output:
        raise ValueError("the order-1 merge writes the phase layout: pass phase_output=True")
    if order == 1 and moment_slots not in (4, 9):
        raise ValueError(f"the order-1 merge returns 4 or 9 moment slots, got {moment_slots}")
    r_taps = radius + math.ceil(residual_bound)
    if r_taps > _PALLAS_RADIUS and order == 0 and not phase_output:
        raise ValueError(
            f"tap radius {r_taps} exceeds merge_fast_pallas's {_PALLAS_RADIUS}-row halo "
            "(pallas_ops/merge.py:154, the JAX package's own limit of use_pallas)"
        )
    bf16 = bf16 and order == 0
    if bf16 and not phase_output:
        raise ValueError("the bf16 merge form writes the phase layout: pass phase_output=True")

    if dev.type == "cpu":
        return merge_fast_plain(
            warped, residual, certainty, omega_inv, scale, radius,
            residual_bound, k_max, phase_output, order, prune_exp, moment_slots, bf16,
        )

    # cached per key: with the list rebuilt in numpy per call, a call took
    # 0.12-0.26 ms against the first kernel's 0.095 ms of device time
    # (NVIDIA H100 80GB HBM3, 700.00 W)
    key = (r_taps, float(residual_bound), scale, float(k_max), float(prune_exp))
    taps_ptr, n_taps = _tap_args(*key)
    halo = _tap_reach(*key)
    if order == 1:
        form, n_out = (2, 4) if moment_slots == 4 else (3, 9)
    else:
        form, n_out = (4 if bf16 else int(phase_output)), 2
    shape = (scale, scale, 3, h, w) if phase_output else (h * scale, w * scale, 3)
    out = torch.empty((n_out,) + shape, dtype=torch.float32, device=dev)
    args = (warped.data_ptr(), residual.data_ptr(), certainty.data_ptr(),
            omega_inv.data_ptr(), out.data_ptr(), f, h, w, scale, form)
    if uses_general(scale, halo):
        plan = general_plan(scale, form, key, f, h, w)
        # the plan's table on the card, made once per (plan, device)
        table = None if plan.whole else _const_array(general_table, (scale, form, key, f, h, w), dev)
        parts = None
        if plan.parts > 1:
            parts = torch.empty((plan.parts, n_out, scale, scale, 3, h, w), dtype=torch.float32, device=dev)
        launch(library(), "mfsr_merge_fast_general", dev, *args, taps_ptr, n_taps, float(residual_bound),
               None if table is None else table.data_ptr(), len(plan.pieces), plan.tile_w, plan.tile_h,
               plan.rows, plan.groups, plan.frame_chunks, plan.tap_groups, plan.max_sites, plan.max_runs,
               plan.smem, None if parts is None else parts.data_ptr())
        LAUNCHES[WIDE if halo > WIDE_REACH else GENERAL] += 1
        return tuple(out.unbind(0))
    launch(library(), "mfsr_merge_fast", dev, *args, taps_ptr, n_taps, float(residual_bound))
    LAUNCHES[NAME] += 1
    return tuple(out.unbind(0))
