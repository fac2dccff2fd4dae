"""Wrapper of the Hopper RAW merge kernels (csrc/merge_raw.cu): the
plane-domain merge of the RAW path in four forms: order 1 as the
certless plugin branch (the main path), order 0 (float32 or bfloat16),
order 1 with the exact solve's 9 moments, and order 1 with the per-cell
plugin moments (centroid_cert or exact_weights, with the centroid
knobs); the order-1 forms but the certless one take exact_weights. Each
reads R/B as colour differences when given a guide. The JAX package
computes it outside Pallas (models/fast_merge.py::merge_burst_raw_planes);
it has the skeleton of pallas_ops/merge.py::merge_fast_pallas.

The templated kernels take scales 1-4, taps within +-4 and Bayer
patterns; their certless and float32 order-0 forms stage the frames
whose tiles fit a block's shared memory at once and, past that many,
stream them through a ring of small chunks (merge_raw_stream_kernel;
launches counted under ``merge_raw_stream``).
Their general form (the S = 0 instantiations: any scale, any tap list,
any number of frames, every form and knob, its block from
general_block) takes every other Bayer merge, its launches counted under
``merge_raw_general``; other 2 x 2 patterns, and Bayer merges whose taps
no general block fits, run the non-Bayer kernel (``merge_raw_nonbayer``).
kernel_name says which runs.

On CUDA tensors it launches a kernel or raises; it never falls back.
On CPU tensors it computes the plain PyTorch version,
models/fast_merge.py::merge_burst_raw_planes, with the same taps, through
``merge_raw_plain`` (the plain version with the wrapper's signature).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

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
    CERTLESS,
    NINE_MOMENTS,
    ORDER0,
    PER_CELL,
    _active_taps,
    _centroid_chain,
    guided_planes,
    merge_burst_raw_planes,
    raw_merge_form,
)
from multi_frame_super_resolution_tpu_torch.ops.filters import _const_array

NAME = "merge_raw"
GENERAL = "merge_raw_general"  # the general form's launches
STREAM = "merge_raw_stream"  # the certless and order-0 forms' streamed launches
NONBAYER = "merge_raw_nonbayer"  # the non-Bayer kernel's launches
SOURCE = "merge_raw.cu"
_MAX_TAP = 4  # the templated kernels' taps lie within +-4 (kMaxTaps = 81 in csrc/merge_raw.cu)
_SCALES = (1, 2, 3, 4)  # the templated kernels' instantiations (Layout<S>, CellTile in csrc/merge_raw.cu)
_SMEM_MAX = 232448  # kMaxSmem in csrc/merge_raw.cu: the shared memory a block can opt in to (sm_90)
_RING = 3  # kRing: the cells kernel's frame slots
_SM_HALF = 233472 // 2 - 1024  # a block's share of an SM's shared memory at two blocks an SM (kSmSmem)


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = bind(
        load_library(SOURCE), "mfsr_merge_raw",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int],
    )
    bind(
        lib, "mfsr_merge_raw_general",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8,
    )
    bind(
        lib, "mfsr_merge_raw_nonbayer",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int],
    )
    bind(
        lib, "mfsr_merge_raw_stream",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int],
    )
    for query in (lib.mfsr_merge_raw_max_frames, lib.mfsr_merge_raw_stream_chunk):
        query.argtypes = [ctypes.c_int] * 3
        query.restype = ctypes.c_int
    return lib


def tap_halo(taps) -> int:
    """The most half-res sites a tap reaches from its pixel, (a + k) // 2
    over both parities a (at least 1): the kernel's staged halo."""
    return max([1] + [abs((a + k) // 2) for t in taps for k in t for a in (0, 1)])


def is_bayer(cfa) -> bool:
    """Green on one diagonal of the 2 x 2 pattern, R and B on the other:
    the patterns the kernel takes."""
    q = [int(cfa[0][0]), int(cfa[0][1]), int(cfa[1][0]), int(cfa[1][1])]
    return sorted(q) == [0, 1, 1, 2] and (q[0] == q[3] == 1 or q[1] == q[2] == 1)


@functools.lru_cache(maxsize=None)
def general_block(scale: int, halo: int, n_taps: int, frames: int, form: int
                  ) -> Optional[Tuple[int, int, int, int, int, int]]:
    """The general form's block for ``n_taps`` taps of staged halo
    ``halo`` (tap_halo) at ``scale`` on ``frames`` frames:
    (tile_w, tile_h, phases, groups, chunk, shared bytes), the last six
    arguments of mfsr_merge_raw_general, the shared bytes sized as
    csrc/merge_raw.cu's layouts use them, within 232,448. None where not
    even one frame fits: the non-Bayer kernel runs the merge.

    Forms 0 and 1 (merge_raw_kernel<0, ...>): a thread per (pixel, phase),
    16 x th pixels to 16 phases (th 4, 2 or 1: to 512 threads) and 8 x 1
    past them (8 x 1 measured faster at S = 5 than 16 x 1 and, as 8 x 4,
    slower at S = 2 than 16 x 4 on an NVIDIA H100 80GB HBM3 at 700.00 W),
    the phases in groups of at most 512 threads over grid z; as many
    frames a chunk as fit beside the tap rows (two ints a tap), each frame
    the tile and halo of four planes and the residual, a float2 a site.
    Forms 2 and 3 (merge_raw_cells_kernel<0, ...>): 8 x 1 pixels, at most
    32 phases a block (padded to a warp's 4, both pairs' blocks over grid
    z); past 32, groups of phase 0 and a share of the others; the ring's
    three frame slots (four planes' tile and halo, the residual's 3 x 10
    sites) and the tap table (two float4 rows a tap); chunk 0."""
    n = scale * scale
    if form in (NINE_MOMENTS, PER_CELL):
        tw, th = 8, 1
        groups = 1 if n <= 32 else -(-(n - 1) // 31)
        phases = n if groups == 1 else 1 + -(-(n - 1) // groups)
        stage = 4 * (th + 2 * halo) * (tw + 2 * halo) + (th + 2) * (tw + 2)
        smem = ((_RING * stage + 1) & ~1) * 8 + 2 * n_taps * 16
        return (tw, th, phases, groups, 0, smem) if smem <= _SMEM_MAX else None
    tw = 16 if n <= 16 else 8
    th = 1 if tw == 8 else (4 if 16 * 4 * n <= 512 else (2 if 16 * 2 * n <= 512 else 1))
    groups = -(-n // (512 // (tw * th)))
    phases = -(-n // groups)
    frame = (4 * (th + 2 * halo) * (tw + 2 * halo) + tw * th) * 8
    table = 2 * n_taps * 4
    chunk = min(frames, max(0, _SMEM_MAX - table) // frame)
    return (tw, th, phases, groups, chunk, chunk * frame + table) if chunk else None


@functools.lru_cache(maxsize=None)
def kernel_name(scale: int, taps: tuple, cfa: tuple, frames: int, form: int, frame_cap: int,
                bf16: bool = False) -> str:
    """The launch a merge runs: the non-Bayer kernel on a pattern other
    than Bayer; the general form at a scale past 4, a tap beyond +-4, or
    the bfloat16 order 0 on more frames than ``frame_cap``
    (mfsr_merge_raw_max_frames at the taps' halo: the frames its
    templated kernel stages at once), or the non-Bayer kernel there
    where no general block fits (general_block); else the templated
    kernels, streamed where ``streams``."""
    if not is_bayer(cfa):
        return NONBAYER
    if uses_general(scale, taps, cfa, frames, form, frame_cap, bf16):
        return GENERAL if general_block(scale, tap_halo(taps), len(taps), frames, form) else NONBAYER
    return STREAM if streams(form, frames, frame_cap) else NAME


def uses_general(scale: int, taps: tuple, cfa: tuple, frames: int, form: int, frame_cap: int,
                 bf16: bool = False) -> bool:
    """Whether the general form runs a Bayer merge: a scale past 4, a tap
    beyond +-4, or the bfloat16 order 0 on more frames than
    ``frame_cap``. (Other patterns run the non-Bayer kernel.)"""
    return is_bayer(cfa) and (scale not in _SCALES or any(abs(k) > _MAX_TAP for t in taps for k in t)
                              or (bf16 and form == ORDER0 and frames > frame_cap))


def streams(form: int, frames: int, frame_cap: int) -> bool:
    """Whether a templated launch of the certless or order-0 form streams
    the frames (more than ``frame_cap``, the frames it stages at once)."""
    return form in (CERTLESS, ORDER0) and frames > frame_cap


@functools.lru_cache(maxsize=None)
def cell_table(cfa: tuple) -> np.ndarray:
    """The non-Bayer kernel's host table (int32, 16): the channel of each
    plane q = 2*qa + qb, then the certless chain each cell (a, b, ch)
    reads (fast_merge._centroid_chain), at 3 (2a + b) + ch: 0 and 1 the
    green chains ("g", p), 2 + 2 p + q the R/B chains ("rb", p, q), -1
    none."""
    chan = [int(cfa[q // 2][q % 2]) for q in range(4)]
    chains = []
    for a in (0, 1):
        for b in (0, 1):
            for ch in range(3):
                cid = _centroid_chain(cfa, a, b, ch)
                chains.append(-1 if cid is None else (cid[1] if cid[0] == "g" else 2 + 2 * cid[1] + cid[2]))
    table = np.asarray(chan + chains, np.int32)
    table.flags.writeable = False
    return table


def general_taps(taps: tuple, centroid_taps: Optional[frozenset] = None) -> np.ndarray:
    """The non-Bayer kernel's tap table (int32 (n, 3)): the taps in list
    order as (ky, kx, c), c = 1 where the tap feeds the per-cell centroid
    (every tap when ``centroid_taps`` is None)."""
    return np.asarray([(ky, kx, int(centroid_taps is None or (ky, kx) in centroid_taps)) for ky, kx in taps],
                      np.int32).reshape(-1, 3)


@functools.lru_cache(maxsize=None)
def nonbayer_rows(taps: tuple, centroid_taps: Optional[frozenset] = None, listed: bool = False) -> np.ndarray:
    """The non-Bayer kernel's tap rows (int32 (n, 4)): general_taps' (ky,
    kx, centroid bit) and a 0, in the list's order where ``listed`` (the
    bfloat16 knobs, whose cells sum their taps in that order) and else
    stably sorted by tap-parity group g = 2 (ky % 2) + kx % 2, the order
    the kernel runs the float32 forms in, group by group."""
    rows = general_taps(taps, centroid_taps)
    if not listed:
        rows = rows[np.argsort(2 * (rows[:, 0] % 2) + rows[:, 1] % 2, kind="stable")]
    rows = np.concatenate([rows, np.zeros((len(rows), 1), np.int32)], 1)
    rows.flags.writeable = False
    return rows


def nonbayer_table(taps: tuple, centroid_taps: Optional[frozenset], listed: bool, windows: tuple) -> np.ndarray:
    """The non-Bayer kernel's device table: nonbayer_rows, then the
    windows' (t0, t1, dylo, dyhi) rows (nonbayer_plan)."""
    return np.concatenate([nonbayer_rows(taps, centroid_taps, listed),
                           np.asarray(windows, np.int32).reshape(-1, 4)])


@functools.lru_cache(maxsize=None)
def nonbayer_plan(scale: int, form: int, taps: tuple, frames: int, listed: bool = False
                  ) -> Tuple[np.ndarray, tuple]:
    """The non-Bayer kernel's launch plan for ``taps`` (nonbayer_rows'
    order, ``listed`` for the bfloat16 knobs) at ``scale`` on ``frames``
    frames: (plan, windows). plan (int32, 14) is mfsr_merge_raw_nonbayer's:
    tile_w, tile_h, phases, groups, hx, rows, chunk, slots, n_win, shared
    bytes and the rows' four group ends; windows the (t0, t1, dylo, dyhi)
    runs of rows staged together, dylo and dyhi the least and most half-res
    row a run's taps reach ((a + ky) // 2 over both parities a).

    A thread per (pixel, phase) (forms 2 and 3: and parity row), about
    256 a block: tw x th pixels (tw 8, 16 or 32) x the phases, at most 32
    threads a pixel; past them grid z over groups of phases, each with
    phase 0 first. A frame's slot holds the four planes' rows x (tw + 2
    hx) sites and the residual's (th + 2) x (tw + 2), 8 B a site; forms 2
    and 3 add, after the ring (16-byte aligned), 32 B a thread and frame
    of the chunk (the residual's per-frame terms). Every
    frame at once in one window where it fits two blocks an SM (the
    bfloat16 knobs: one block); else a ring of two slots of `chunk`
    frames, the rows in windows where one frame of every row does not
    fit (the bfloat16 knobs: windows of one tap once the frames run in
    chunks, so that each tap's frame sums are whole); an 8 x 1 tile where
    the tile's own rows do not fit. Raises where not even that fits (taps
    past about +-1,800 columns)."""
    halves = 2 if form in (NINE_MOMENTS, PER_CELL) else 1
    n = scale * scale
    max_p = 32 // halves
    if n <= max_p:
        groups, phases = 1, n
    else:
        groups = -(-(n - 1) // (max_p - 1))
        phases = 1 + -(-(n - 1) // groups)
    pix = max(1, 256 // (phases * halves))
    rows_t = nonbayer_rows(taps, None, listed)
    n_taps = len(rows_t)
    lo = (rows_t[:, 0] // 2).tolist() or [0]
    hi = ((rows_t[:, 0] + 1) // 2).tolist() or [0]
    hx = max([1] + [max(abs(k // 2), abs((k + 1) // 2)) for k in rows_t[:, 1].tolist()])

    def fit(tw, th):  # the ring of a tw x th tile: (rows, chunk, slots, windows, bytes), or None
        sw, rs = tw + 2 * hx, (th + 2) * (tw + 2)
        rec = 32 * tw * th * phases * halves if halves == 2 else 0  # forms 2 and 3: a record a thread and frame

        def frame(rows):  # a frame's bytes in a slot
            return (4 * rows * sw + rs) * 8

        def need(rows, chunk, slots):  # the ring, 16-byte aligned, and the records
            return -(-slots * chunk * frame(rows) // 16) * 16 + chunk * rec

        def most_chunk(rows, budget):  # the most frames a slot of two within budget
            chunk = budget // (2 * frame(rows) + rec)
            while chunk > 0 and need(rows, chunk, 2) > budget:
                chunk -= 1
            return chunk

        def most_rows(chunk, slots, budget):  # the most staged rows within budget
            rows = max(0, (budget - chunk * rec - 16) // (8 * slots * chunk) - rs) // (4 * sw)
            while rows > 0 and need(rows, chunk, slots) > budget:
                rows -= 1
            return rows

        def windows(max_rows, one_tap=False):
            wins, t0 = [], 0
            while t0 < n_taps:
                a, b, t1 = lo[t0], hi[t0], t0 + 1
                while t1 < n_taps and not one_tap and th + max(b, hi[t1]) - min(a, lo[t1]) <= max_rows:
                    a, b, t1 = min(a, lo[t1]), max(b, hi[t1]), t1 + 1
                wins.append((t0, t1, a, b))
                t0 = t1
            return wins or [(0, 0, 0, 0)]

        whole = [(0, n_taps, min(lo), max(hi))]
        rows_all = th + max(hi) - min(lo)
        if need(rows_all, frames, 1) <= (_SMEM_MAX if listed else _SM_HALF):
            wins, chunk = whole, frames
        elif listed and most_rows(frames, 2, _SMEM_MAX) >= th + 1:
            wins, chunk = windows(most_rows(frames, 2, _SMEM_MAX)), frames  # every frame, rows in windows
        elif listed:
            wins = windows(th + 1, one_tap=True)
            chunk = min(frames, most_chunk(th + 1, _SM_HALF) or most_chunk(th + 1, _SMEM_MAX))
        elif need(rows_all, 1, 2) <= _SMEM_MAX:
            wins = whole
            chunk = min(frames, most_chunk(rows_all, _SM_HALF) or most_chunk(rows_all, _SMEM_MAX))
        else:
            wins = windows(most_rows(1, 2, _SMEM_MAX))
            chunk = 1
        rows = max(th + b - a for _, _, a, b in wins)
        slots = 2 if len(wins) * -(-frames // max(chunk, 1)) > 1 else 1
        if chunk < 1 or need(rows, chunk, slots) > _SMEM_MAX:
            return None
        # the shared-residual centroid passes its phase-0 sums through the ring
        return rows, chunk, slots, wins, max(need(rows, chunk, slots), 144 * tw * th if form == PER_CELL else 0)

    # the tile, or 8 x 1 pixels where its rows of sites do not fit
    tw = min(32, 8 * -(-pix // 8))
    th = max(1, pix // tw)
    ring = fit(tw, th)
    if ring is None:
        tw, th = 8, 1
        ring = fit(tw, th)
    if ring is None:
        raise ValueError(f"the non-Bayer RAW merge stages rows of {8 + 2 * hx} sites a plane: two rows of them pass "
                         "a block's shared memory")
    rows, chunk, slots, wins, smem = ring
    g = 2 * (rows_t[:, 0] % 2) + rows_t[:, 1] % 2
    ends = [n_taps] * 4 if listed else np.cumsum([int((g == k).sum()) for k in range(4)]).tolist()
    plan = np.asarray([tw, th, phases, groups, hx, rows, chunk, slots, len(wins), smem, *ends], np.int32)
    plan.flags.writeable = False
    return plan, tuple(wins)


# the variant bits of a launch (csrc/merge_raw.cu's flags)
EXACT_WEIGHTS, BF16, BLOCK, SHARED = 1, 2, 4, 8


@functools.lru_cache(maxsize=None)
def tap_table(taps: tuple, cfa: tuple, centroid_taps: Optional[frozenset] = None) -> np.ndarray:
    """The kernel's host table (int32): the channel of each plane
    q = 2*qa + qb (4 values); the end of each tap-parity group
    g = 2*(ky%2) + (kx%2) (4); then the taps as (ky, kx, aux) rows,
    sorted by group, then those in ``centroid_taps`` (all taps when None:
    the taps that feed the per-cell centroid) first, then in list order,
    aux = c + 2 n with c = 1 for a centroid tap and n the tap's index in
    the list (the bfloat16 order-0 loop runs in list order). Within a
    group a parity always reads the same plane, and the taps feed the
    same two certless chains (fast_merge._centroid_chain)."""
    chan = [int(cfa[q // 2][q % 2]) for q in range(4)]

    def outside(t):
        return centroid_taps is not None and t not in centroid_taps

    listed = sorted(enumerate(taps), key=lambda nt: outside(nt[1]))  # stable: list order within
    groups = [[(n, t) for n, t in listed if 2 * (t[0] % 2) + t[1] % 2 == g] for g in range(4)]
    ends = np.cumsum([len(grp) for grp in groups]).tolist()
    rows = [k for grp in groups for n, t in grp
            for k in (*t, int(not outside(t)) + 2 * n)]
    table = np.asarray(chan + ends + rows, np.int32)
    table.flags.writeable = False  # cached and shared by every call
    return table


def table_rows(taps: tuple, cfa: tuple, centroid_taps: Optional[frozenset] = None) -> np.ndarray:
    """tap_table's (ky, kx, aux) rows as an (n, 3) array: the general
    form's copy on the card."""
    return np.array(tap_table(taps, cfa, centroid_taps)[8:]).reshape(-1, 3)


def merge_raw_plain(
    planes: torch.Tensor,
    residual: torch.Tensor,
    certainty: torch.Tensor,
    omega_inv: torch.Tensor,
    omega_inv_rb: torch.Tensor,
    cfa,
    scale: int,
    radius: int = 2,
    residual_bound: float = 1.0,
    k_max: float = 1.0,
    prune_exp: float = 6.0,
    order: int = 1,
    moment_slots: int = 4,
    guide: Optional[torch.Tensor] = None,
    centroid_cert: bool = False,
    exact_weights: bool = False,
    centroid_prune: Optional[float] = None,
    centroid_bf16: bool = False,
    centroid_block: bool = False,
    centroid_shared_res: bool = False,
    bf16: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The plain version with ``merge_raw``'s signature, in the phase
    layout: models/fast_merge.py::merge_burst_raw_planes, which takes the
    JAX function's."""
    return merge_burst_raw_planes(
        planes, residual, certainty, omega_inv, omega_inv_rb, cfa, scale, radius, residual_bound, k_max,
        guide=guide, phase_output=True, bf16=bf16, order=order, prune_exp=prune_exp, moment_slots=moment_slots,
        exact_weights=exact_weights, centroid_prune=centroid_prune, centroid_bf16=centroid_bf16,
        centroid_block=centroid_block, centroid_shared_res=centroid_shared_res, centroid_cert=centroid_cert,
    )


def merge_raw(
    planes: torch.Tensor,
    residual: torch.Tensor,
    certainty: torch.Tensor,
    omega_inv: torch.Tensor,
    omega_inv_rb: torch.Tensor,
    cfa,
    scale: int,
    radius: int = 2,
    residual_bound: float = 1.0,
    k_max: float = 1.0,
    prune_exp: float = 6.0,
    order: int = 1,
    moment_slots: int = 4,
    guide: Optional[torch.Tensor] = None,
    centroid_cert: bool = False,
    exact_weights: bool = False,
    centroid_prune: Optional[float] = None,
    centroid_bf16: bool = False,
    centroid_block: bool = False,
    centroid_shared_res: bool = False,
    bf16: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """RAW plane merge: planes (F, 2, 2, hh, hw), residual (F, hh, hw, 2)
    in RAW units, certainty (F, hh, hw, 3), omega_inv and omega_inv_rb
    (hh, hw, 3), and the optional guide (F, 2, 2, hh, hw), all float32
    and contiguous on one device -> the outputs of the form that
    fast_merge.raw_merge_form(order, moment_slots, centroid_cert,
    exact_weights) names: the certless (m00, cy, cx, b0); order 0's (num,
    den); the exact solve's 9 moments; the per-cell (m00, m01, m02, b0);
    each (2s, 2s, 3, hh, hw), under the knobs of
    fast_merge.merge_burst_raw_planes (dead ones ignored, as there). With
    a guide, the difference planes (fast_merge.guided_planes) are formed
    here in one elementwise pass, on either device, and merged unguided.
    On CUDA tensors a templated kernel runs where it applies and the
    general kernel everywhere else (uses_general); the outputs are
    views of one allocation."""
    if planes.ndim != 5:
        raise ValueError(f"planes must be (F, 2, 2, hh, hw), got {tuple(planes.shape)}")
    f, hh, hw = planes.shape[0], planes.shape[3], planes.shape[4]
    dev = planes.device
    check_tensor("planes", planes, (f, 2, 2, hh, hw), dev)
    check_tensor("residual", residual, (f, hh, hw, 2), dev)
    check_tensor("certainty", certainty, (f, hh, hw, 3), dev)
    check_tensor("omega_inv", omega_inv, (hh, hw, 3), dev)
    check_tensor("omega_inv_rb", omega_inv_rb, (hh, hw, 3), dev)
    form = raw_merge_form(order, moment_slots, centroid_cert, exact_weights)
    # the knobs each form reads (merge_burst_raw_planes ignores the others)
    bf16 = bf16 and form == ORDER0
    exact_weights = exact_weights and form in (NINE_MOMENTS, PER_CELL)
    per_cell = form == PER_CELL
    shared = per_cell and centroid_shared_res
    block = per_cell and (centroid_block or shared)
    centroid_bf16 = per_cell and centroid_bf16 and not block  # the block branch comes first
    centroid_prune = centroid_prune if per_cell else None
    if guide is not None:
        check_tensor("guide", guide, (f, 2, 2, hh, hw), dev)
        planes = guided_planes(planes, guide, cfa, bf16)
    if dev.type == "cpu":
        return merge_raw_plain(
            planes, residual, certainty, omega_inv, omega_inv_rb, cfa, scale,
            radius, residual_bound, k_max, prune_exp, order, moment_slots,
            centroid_cert=centroid_cert, exact_weights=exact_weights, centroid_prune=centroid_prune,
            centroid_bf16=centroid_bf16, centroid_block=block, centroid_shared_res=shared, bf16=bf16,
        )
    r_taps = radius + int(np.ceil(residual_bound))
    taps = tuple(_active_taps(r_taps, residual_bound, scale, k_max, prune_exp))
    pattern = tuple(tuple(int(c) for c in row) for row in cfa)
    n_out = (4, 2, 9, 4)[form]  # csrc/merge_raw.cu's form numbers
    lib = library()
    frame_cap = lib.mfsr_merge_raw_max_frames(scale, tap_halo(taps), form) if scale in _SCALES else 0
    centroid_taps = None if centroid_prune is None else frozenset(
        _active_taps(r_taps, residual_bound, scale, k_max, centroid_prune))
    flags = ((EXACT_WEIGHTS if exact_weights else 0) | (BF16 if bf16 or centroid_bf16 else 0)
             | (BLOCK if block else 0) | (SHARED if shared else 0))
    out = torch.empty((n_out, 2 * scale, 2 * scale, 3, hh, hw), dtype=torch.float32, device=dev)
    args = (planes.data_ptr(), residual.data_ptr(), certainty.data_ptr(),
            omega_inv.data_ptr(), omega_inv_rb.data_ptr(), out.data_ptr(),
            f, hh, hw, scale, form, float(residual_bound))
    name = kernel_name(scale, taps, pattern, f, form, frame_cap, bf16)
    if name == NONBAYER:
        # the bfloat16 knobs keep each cell's taps in the list's order
        listed = bf16 or centroid_bf16
        plan, windows = nonbayer_plan(scale, form, taps, f, listed)
        # the tap table on the card, made once per (taps, centroid, order, windows, device)
        dev_taps = _const_array(nonbayer_table, (taps, centroid_taps, listed, windows), dev)
        launch(lib, "mfsr_merge_raw_nonbayer", dev, *args, dev_taps.data_ptr(), len(taps),
               cell_table(pattern).ctypes.data, plan.ctypes.data, flags)
        LAUNCHES[name] += 1
        return tuple(out.unbind(0))
    # built once per (taps, pattern): rebuilt per call it held a call to
    # 0.66 ms against the first kernel's 0.18 ms (NVIDIA H100 80GB HBM3,
    # 700.00 W)
    table = tap_table(taps, pattern, centroid_taps)
    if name == GENERAL:
        # its rows on the card too, made once per (taps, pattern, centroid, device)
        rows = _const_array(table_rows, (taps, pattern, centroid_taps), dev)
        launch(lib, "mfsr_merge_raw_general", dev, *args, table.ctypes.data, rows.data_ptr(), len(taps), flags,
               *general_block(scale, tap_halo(taps), len(taps), f, form))
    elif name == STREAM:
        launch(lib, "mfsr_merge_raw_stream", dev, *args, table.ctypes.data, len(taps))
    else:
        launch(lib, "mfsr_merge_raw", dev, *args, table.ctypes.data, len(taps), flags)
    LAUNCHES[name] += 1
    return tuple(out.unbind(0))
