"""Global shift-consistency solve with outlier rejection (counterpart of
registration/global_shift.py, the reference's ShiftMinimizer,
ShiftMinimizerKernels.cu:28-258).

Unknowns are the F-1 consecutive frame-to-frame shifts s_k of a tile;
each measured pair (i, j) observes sum_{k=i..j-1} s_k. Every tile's
least-squares problem is solved at once, as a batch of small normal
equations, and the outlier loop is a fixed number of rounds of masked
updates (checkForOutliers: the worst measurement with squared residual
above 1 px^2 is dropped each round). Nothing here reads a value back to
the host: the rounds are ``torch.where`` updates, the solve is
``torch.linalg.solve_ex`` (no error check, so no sync), and the normal
equations are elementwise products and sums (no matmul, so no TF32).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from port_bench.reference.ops.filters import _const_array


def measurement_pairs(num_frames: int, max_span: int = 2) -> List[Tuple[int, int]]:
    """All (i, j), i < j, with span j - i <= max_span, span by span: the
    consecutive chain (span 1) first, which keeps the system full-rank."""
    return [(i, i + span) for span in range(1, max_span + 1) for i in range(num_frames - span)]


def design_matrix(num_frames: int, pairs: Sequence[Tuple[int, int]]) -> np.ndarray:
    """(P, F-1) 0/1 matrix mapping the consecutive shifts to the pair
    measurements (copyShiftMatrix)."""
    a = np.zeros((len(pairs), num_frames - 1), np.float32)
    for p, (i, j) in enumerate(pairs):
        a[p, i:j] = 1.0
    return a


def _solve(a: torch.Tensor, m: torch.Tensor, weights: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """Weighted ridge least squares of every tile: a (P, K), m (N, P, 2),
    weights (N, P), reg = ridge I (K, K) -> s (N, K, 2) solving
    (A^T W A + ridge I) s = A^T W m."""
    aw = weights[:, :, None] * a  # (N, P, K)
    ata = (aw[:, :, :, None] * a[None, :, None, :]).sum(1) + reg  # (N, K, K)
    atm = (aw[:, :, :, None] * m[:, :, None, :]).sum(1)  # (N, K, 2)
    return torch.linalg.solve_ex(ata, atm)[0]


def solve_consistent_shifts(
    measured: torch.Tensor,
    num_frames: int,
    pairs: Sequence[Tuple[int, int]],
    max_outliers: Optional[int] = None,
    ridge: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """measured (P, nty, ntx, 2): the per-pair tile shifts -> (consecutive
    shifts (F-1, nty, ntx, 2), weights (P, nty, ntx): 1 for the
    measurements that survived outlier rejection, 0 for the dropped).

    ``max_outliers`` rounds (default P - (F-1), which keeps at least the
    chain's count of rows) each drop, per tile, the first measurement of
    largest weighted squared residual if that exceeds 1 px^2, and solve
    again."""
    p, nty, ntx, _ = measured.shape
    a = _const_array(design_matrix, (num_frames, tuple(pairs)), measured.device)
    if max_outliers is None:
        max_outliers = max(p - (num_frames - 1), 0)
    m = measured.permute(1, 2, 0, 3).reshape(nty * ntx, p, 2)
    weights = torch.ones((nty * ntx, p), dtype=torch.float32, device=measured.device)
    reg = ridge * torch.eye(num_frames - 1, device=measured.device)
    s = _solve(a, m, weights, reg)
    rows = torch.arange(p, device=measured.device)
    for _ in range(max_outliers):
        resid = (a[None, :, :, None] * s[:, None, :, :]).sum(2) - m  # (N, P, 2)
        d2 = (resid * resid).sum(-1) * weights  # removed rows score 0
        worst = d2.argmax(-1, keepdim=True)  # the first maximum, as jnp.argmax
        remove = d2.gather(-1, worst) > 1.0
        weights = torch.where(remove & (rows == worst), 0.0, weights)
        s = _solve(a, m, weights, reg)
    consecutive = s.reshape(nty, ntx, num_frames - 1, 2).permute(2, 0, 1, 3)
    return consecutive, weights.reshape(nty, ntx, p).permute(2, 0, 1)


def shifts_to_reference(consecutive: torch.Tensor, ref_index: int) -> torch.Tensor:
    """Consecutive shifts (F-1, nty, ntx, 2) -> per-frame shifts relative
    to the reference frame (F, nty, ntx, 2) (getOptimalShifts): the
    partial sums of the chain minus the reference's."""
    csum = torch.cat([torch.zeros_like(consecutive[:1]), consecutive.cumsum(0)], dim=0)
    return csum - csum[ref_index]
