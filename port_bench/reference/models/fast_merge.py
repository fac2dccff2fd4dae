"""Static-tap kernel-regression merges (counterpart of models/fast_merge.py):
the plain PyTorch versions of the merge kernels.

- ``merge_burst_fast``: the RGB merge, order 0 (in float32, or with
  bfloat16 products and accumulation) and the order-1 moments of the
  plugin solve (4 slots) or of the exact 3x3 solve (9 slots)
  (kernels/merge.py, csrc/merge.cu);
- ``merge_burst_raw_planes``: the RAW plane-domain merge: order 0 (float32
  or bfloat16), and order 1 as the certless plugin branch (4 slots), the
  per-cell plugin branch (4 slots, ``centroid_cert`` or
  ``exact_weights``, with the centroid knobs) or the exact solve's 9
  moments (kernels/merge_raw.py, csrc/merge_raw.cu); R/B read as colour
  differences against ``green_guide_planes`` when given a guide.

Frames arrive warped into reference geometry by their per-tile integer
shifts; what remains per output pixel is a static tap window around its
nearest input sample, with the bounded subpixel residual folded into the
Gaussian weights. All output phases are accumulated at input resolution.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from port_bench.reference.ops.filters import _const
from port_bench.reference.ops.warp_fast import _pad_last2, _shifted, interleave_phases_planes


def _output_phase_offsets(s: int) -> np.ndarray:
    """phi(o % s) = (o + 0.5)/s - 0.5 - o//s: the constant fractional
    position of each output phase relative to its nearest input sample."""
    o = np.arange(s, dtype=np.float32)
    return (o + 0.5) / s - 0.5


def _active_taps(
    r_taps: int, residual_bound: float, scale: int, k_max: float, prune_exp: float = 6.0
):
    """Static tap pruning: keep taps whose best-case Gaussian weight
    exceeds e^-prune_exp, with |d|_min per axis = max(0, |k| - rb -
    max|phi|) * s in output-grid units and the largest clamped kernel
    variance k_max. The default 6.0 is merge_fast_pallas's threshold; the
    default merge branches pass MergeConfig.prune_exp."""
    phi_max = float(np.max(np.abs(_output_phase_offsets(scale))))
    taps = []
    for ky in range(-r_taps, r_taps + 1):
        for kx in range(-r_taps, r_taps + 1):
            dy = max(0.0, abs(ky) - residual_bound - phi_max) * scale
            dx = max(0.0, abs(kx) - residual_bound - phi_max) * scale
            if (dy * dy + dx * dx) / (2.0 * max(k_max, 1e-6)) <= prune_exp:
                taps.append((ky, kx))
    return taps


def merge_burst_fast(
    warped: torch.Tensor,
    residual: torch.Tensor,
    certainty: torch.Tensor,
    omega_inv: torch.Tensor,
    scale: int,
    radius: int = 2,
    residual_bound: float = 1.0,
    k_max: float = 1.0,
    phase_output: bool = False,
    bf16: bool = False,
    order: int = 0,
    prune_exp: float = 6.0,
    moment_slots: int = 9,
) -> Tuple[torch.Tensor, ...]:
    """Merge tile-warped RGB frames onto the scale-x output grid, with the
    JAX function's parameters, order and defaults (kernels/merge.py::
    merge_fast_plain takes the wrapper's).

    warped (F, H, W, 3); residual (F, H, W, 2) subpixel flow, clamped to
    +-residual_bound; certainty (F, H, W, 3); omega_inv (H, W, 3). Taps
    are _active_taps(..., prune_exp). Returns (num, den), each
    (sH, sW, 3), or channel-leading (s, s, 3, H, W) phase stacks with
    ``phase_output``. ``order=1`` (with ``phase_output``) returns the
    plugin solve's moments (m00, m01, m02, b0) = (sum cw, sum cw dy,
    sum cw dx, sum cw v) instead, each (s, s, 3, H, W), cw = weight x
    certainty and (dy, dx) the displacement the weight uses (the JAX
    function's moment_slots=4); with ``moment_slots=9`` the exact
    solve's (m00, m01, m02, m11, m12, m22, b0, b1, b2), models/merge.py::
    solve_order1's order.

    The frame axis is a batch dimension: each frame's taps are summed in
    tap order and the frames are then added in order, the summation
    order of the JAX scan.

    ``bf16`` (order 0; order 1 ignores it, as the JAX function does): the
    values and certainties are rounded to bfloat16, each weight is
    evaluated in float32 and rounded, the products w c and v (w c) and a
    frame's sums over the taps are bfloat16, and the frames are added in
    float32 (fast_merge.py:134-136, :165-195).
    """
    if order == 1 and not phase_output:
        raise ValueError("the order-1 merge writes the phase layout: pass phase_output=True")
    f, h, w = warped.shape[:3]
    s = scale
    r_taps = radius + int(np.ceil(residual_bound))
    taps = _active_taps(r_taps, residual_bound, s, k_max, prune_exp)
    phi = _output_phase_offsets(s)
    if order == 1 and moment_slots not in (4, 9):
        raise ValueError(f"the order-1 merge returns 4 or 9 moment slots, got {moment_slots}")
    n_acc = moment_slots if order == 1 else 2
    acc_dt = torch.bfloat16 if bf16 and order == 0 else torch.float32

    oxx = omega_inv[..., 0]
    oyy = omega_inv[..., 1]
    oxy = omega_inv[..., 2]
    # channel-leading planes, edge-padded once: every tap is a view
    img = _pad_last2(torch.movedim(warped, -1, 1).to(acc_dt), r_taps, r_taps)  # (F, 3, H+2r, W+2r)
    cert = _pad_last2(torch.movedim(certainty, -1, 1).to(acc_dt), r_taps, r_taps)
    res_y = residual[..., 0].clamp(-residual_bound, residual_bound)  # (F, H, W)
    res_x = residual[..., 1].clamp(-residual_bound, residual_bound)

    # acc[k][py][px]: (F, 3, H, W)
    acc = [[[None] * s for _ in range(s)] for _ in range(n_acc)]

    def add(k, py, px, term):
        acc[k][py][px] = term if acc[k][py][px] is None else acc[k][py][px] + term

    for ky, kx in taps:
        val = _shifted(img, r_taps, ky, kx, h, w)
        cert_k = _shifted(cert, r_taps, ky, kx, h, w)
        dy0 = (ky - res_y) * s
        dx0 = (kx - res_x) * s
        for py in range(s):
            dy = dy0 - float(phi[py] * s)
            for px in range(s):
                dx = dx0 - float(phi[px] * s)
                wgt = torch.exp(
                    -0.5 * (dx * dx * oxx + dy * dy * oyy + 2.0 * dx * dy * oxy)
                ).to(acc_dt)
                cw = wgt[:, None] * cert_k
                cwv = val * cw
                if order == 1 and n_acc == 4:
                    add(0, py, px, cw)
                    add(1, py, px, cw * dy[:, None])
                    add(2, py, px, cw * dx[:, None])
                    add(3, py, px, cwv)
                elif order == 1:
                    dye, dxe = dy[:, None], dx[:, None]
                    cwdy, cwdx = cw * dye, cw * dxe
                    for k, term in enumerate((
                        cw, cwdy, cwdx, cwdy * dye, cwdy * dxe, cwdx * dxe, cwv, cwv * dye, cwv * dxe,
                    )):
                        add(k, py, px, term)
                else:
                    add(0, py, px, cwv)
                    add(1, py, px, cw)

    def finish(acc_k):
        # (s, s, F, 3, H, W) -> frames summed in order -> (s, s, 3, H, W)
        stack = torch.stack([torch.stack(row, 0) for row in acc_k], 0).float()
        total = stack[:, :, 0]
        for i in range(1, f):
            total = total + stack[:, :, i]
        if phase_output:
            return total
        return total.permute(3, 0, 4, 1, 2).reshape(h * s, w * s, 3)

    return tuple(finish(a) for a in acc)


def _shift_last2(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped static shift of the last two axes:
    out[..., y, x] = img[..., clamp(y + dy), clamp(x + dx)]."""
    h, w = img.shape[-2], img.shape[-1]
    pad = max(abs(dy), abs(dx), 1)
    return _shifted(_pad_last2(img, pad, pad), pad, dy, dx, h, w)


def raw_to_planes(raw: torch.Tensor) -> torch.Tensor:
    """Bayer mosaic(s) (..., H, W) -> CFA planes (..., 2, 2, H//2, W//2),
    planes[..., a, b] = raw[..., a::2, b::2], as a strided view (the JAX
    function's 0/1 selector matmul exists for the TPU's layouts)."""
    hh, hw = raw.shape[-2] // 2, raw.shape[-1] // 2
    lead = raw.shape[:-2]
    k = len(lead)
    x = raw[..., : 2 * hh, : 2 * hw].reshape(lead + (hh, 2, hw, 2))
    return x.permute(*range(k), k + 1, k + 3, k, k + 2)


def planes_to_raw(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of raw_to_planes: (..., 2, 2, hh, hw) -> (..., 2*hh, 2*hw)."""
    hh, hw = planes.shape[-2], planes.shape[-1]
    lead = planes.shape[:-4]
    k = len(lead)
    x = planes.permute(*range(k), k + 2, k, k + 3, k + 1)  # (..., hh, 2, hw, 2)
    return x.reshape(lead + (2 * hh, 2 * hw))


def grad_phases(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradient of a channel-leading phase stack
    (n, n, C, hh, hw) in OUTPUT pixel units: phase (r, c) holds output
    pixel (n*i + r, n*j + c), so the output-row neighbour of phase r is
    phase r-1, wrapping to phase n-1 one plane row up (edge-clamped)."""
    n = x.shape[0]
    gy = torch.stack(
        [
            0.5 * (
                (x[r + 1] if r < n - 1 else _shift_last2(x[0], 1, 0))
                - (x[r - 1] if r > 0 else _shift_last2(x[n - 1], -1, 0))
            )
            for r in range(n)
        ],
        dim=0,
    )
    gx = torch.stack(
        [
            0.5 * (
                (x[:, c + 1] if c < n - 1 else _shift_last2(x[:, 0], 0, 1))
                - (x[:, c - 1] if c > 0 else _shift_last2(x[:, n - 1], 0, -1))
            )
            for c in range(n)
        ],
        dim=1,
    )
    return gy, gx


def _centroid_chain(cfa, a: int, b: int, ch: int) -> Optional[tuple]:
    """The certless centroid chain that cell (a, b, ch) reads, or None.

    Chains are keyed by TAP parity: green taps of a cell class share
    (ky + kx) % 2, single-position channels share (ky % 2, kx % 2); a
    tap feeds ("g", (ky + kx) % 2) with the green weights and
    ("rb", ky % 2, kx % 2) with the R/B weights (fast_merge.py:632-675,
    :876-889)."""
    pat = np.asarray(cfa)
    if ch == 1:
        g_pos = [(qa, qb) for qa in (0, 1) for qb in (0, 1) if int(pat[qa][qb]) == 1]
        if not g_pos:
            return None
        pa, pb = g_pos[0]
        return ("g", (pa + pb - a - b) % 2)
    pos = {int(pat[qa][qb]): (qa, qb) for qa in (0, 1) for qb in (0, 1)}
    if ch not in pos:
        return None
    pa, pb = pos[ch]
    return ("rb", (pa - a) % 2, (pb - b) % 2)


def green_guide_planes(planes: torch.Tensor, cfa) -> torch.Tensor:
    """Gradient-weighted green estimate at every CFA site, in the plane
    domain (fast_merge.py:254-298): (F, 2, 2, hh, hw) -> the same shape.
    A non-green site holds the Hamilton-Adams estimate of its four
    full-res green neighbours, horizontal and vertical mixed by inverse
    gradient (Wu-Zhang); a green site holds itself. The guided R/B merge
    accumulates R - G and B - G against it."""
    pat = np.asarray(cfa)
    eps = 1e-6
    out = [[None, None], [None, None]]
    for a in (0, 1):
        for b in (0, 1):
            p = planes[:, a, b]
            if int(pat[a][b]) == 1:
                out[a][b] = p
                continue
            # full-res green neighbours (2i+a+-1, 2j+b) and (2i+a, 2j+b+-1)
            up = _shift_last2(planes[:, (a - 1) % 2, b], (a - 1) // 2, 0)
            down = _shift_last2(planes[:, (a + 1) % 2, b], (a + 1) // 2, 0)
            left = _shift_last2(planes[:, a, (b - 1) % 2], 0, (b - 1) // 2)
            right = _shift_last2(planes[:, a, (b + 1) % 2], 0, (b + 1) // 2)
            # the same channel +-2 full-res px away: the Laplacian correction
            lap_v = 2.0 * p - _shift_last2(p, -1, 0) - _shift_last2(p, 1, 0)
            lap_h = 2.0 * p - _shift_last2(p, 0, -1) - _shift_last2(p, 0, 1)
            est_v = 0.5 * (up + down) + 0.25 * lap_v
            est_h = 0.5 * (left + right) + 0.25 * lap_h
            gv = (up - down).abs() + lap_v.abs()
            gh = (left - right).abs() + lap_h.abs()
            wh = (gv + eps) / (gv + gh + 2.0 * eps)
            out[a][b] = wh * est_h + (1.0 - wh) * est_v
    return torch.stack([torch.stack(row, 1) for row in out], 1)


def guided_planes(planes: torch.Tensor, guide: torch.Tensor, cfa, bf16: bool = False) -> torch.Tensor:
    """The planes a guided merge reads: value - guide at R/B sites, the
    value at green ones. The JAX function subtracts before its static
    shift, so merging these planes unguided is its guided merge, bit for
    bit (fast_merge.py:464-465, :691-692). With ``bf16`` the difference
    is taken of the bfloat16-rounded value and guide and rounded, as the
    JAX function's bf16 merge takes it (:370-374); the planes stay
    float32, holding bfloat16 values at R/B sites."""
    rb = _const(tuple(int(c) != 1 for row in cfa for c in row), planes.device, torch.bool)
    if bf16:
        diff = (planes.to(torch.bfloat16) - guide.to(torch.bfloat16)).float()
    else:
        diff = planes - guide
    return torch.where(rb.reshape(2, 2, 1, 1), diff, planes)


# the forms of the RAW merge (csrc/merge_raw.cu's form numbers)
CERTLESS, ORDER0, NINE_MOMENTS, PER_CELL = 0, 1, 2, 3


def raw_merge_form(order: int, moment_slots: int = 4, centroid_cert: bool = False,
                   exact_weights: bool = False) -> int:
    """The form of the RAW merge that (order, moment_slots, centroid_cert,
    exact_weights) select: CERTLESS (order 1, 4 slots, no certainty in
    the centroid and block-centre weights: slots 1 and 2 hold the
    finished centroid, the JAX package's ``_certless``), ORDER0,
    NINE_MOMENTS (9 slots; centroid_cert has no effect there) or PER_CELL
    (order 1, 4 slots, centroid_cert or exact_weights: raw m01, m02). The
    wrapper launches this form and the pipeline reads the layout from it,
    so the two cannot disagree."""
    if order == 0:
        return ORDER0
    if order != 1 or moment_slots not in (4, 9):
        raise ValueError(
            f"the RAW merge takes order 0, or order 1 with 4 or 9 slots, got {order}, {moment_slots}"
        )
    if moment_slots == 9:
        return NINE_MOMENTS
    return PER_CELL if centroid_cert or exact_weights else CERTLESS


def merge_burst_raw_planes(
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
    guide: Optional[torch.Tensor] = None,
    phase_output: bool = False,
    bf16: bool = False,
    order: int = 0,
    prune_exp: float = 6.0,
    moment_slots: int = 9,
    exact_weights: bool = False,
    centroid_prune: Optional[float] = None,
    centroid_bf16: bool = False,
    centroid_block: bool = False,
    centroid_shared_res: bool = False,
    centroid_cert: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """CFA-aware merge on half-resolution planes (fast_merge.py:301-511
    and _merge_planes_order1), with the JAX function's parameters, order
    and defaults (kernels/merge_raw.py::merge_raw_plain takes the
    wrapper's). Four forms (raw_merge_form):

    - ``order=0``: (num, den) = (sum w c v, sum w c); with ``bf16``
      (fast_merge.py:365-374, :445-474) the planes and certainties are
      rounded to bfloat16 and each weight is evaluated in float32 and
      rounded; each tap's frame sums are taken in float32 and rounded,
      and the taps accumulate in bfloat16. The products follow the jitted
      JAX function, whose compiler forms a product that feeds a float32
      sum in float32 (exact for two bfloat16 factors): w c rounds to
      bfloat16 only on the value's path, (w c) v and the den's w c do not;
    - ``order=1, moment_slots=4``: the certless plugin branch
      (centroid_cert=False): (m00, cy, cx, b0), the weight sum, the
      finalized centroid clip(m01 / sum w, +-2) and clip(m02 / sum w,
      +-2) of the shared certless chains, and the weighted value sum;
    - ``order=1, moment_slots=9``: the exact solve's moments (m00, m01,
      m02, m11, m12, m22, b0, b1, b2) of models/merge.py::solve_order1,
      per cell and certainty-weighted. Their displacements dy = s (ky -
      rho_y) take rho = the residual interpolated at the phase row's
      position inside its Bayer block (a 2-tap bilinear blend with the
      neighbouring block, the oracle's per-pixel flow) plus phi; the
      weights keep the block-centre residual;
    - ``order=1, moment_slots=4`` with ``centroid_cert`` or
      ``exact_weights``: the per-cell plugin branch (fast_merge.py:
      714-801): (m00, m01, m02, b0), m01 summed per tap as s (ky sum_f w
      c - sum_f rho_y w c) (the compact rho fields), m02 likewise. Its
      knobs, in the JAX branch order: ``centroid_prune`` (taps outside
      _active_taps(..., centroid_prune) add only m00 and b0), then
      ``centroid_block`` (rho = the block-centre residual + phi) and
      ``centroid_shared_res`` (implies block: the residual sums taken at
      phase 0 and folded into m01, m02 after the tap loop, each phase
      with its own m00, fast_merge.py:811-831), else the compact rho
      with ``centroid_bf16`` (rho and w c rounded to bfloat16, their
      products, exact in float32, summed there: the jitted JAX
      function's rounding).

    ``exact_weights`` (order 1): each cell's Gaussian weight is evaluated
    at its moments' parity-interpolated displacement, one weight per
    parity, in place of the block-centre weights (fast_merge.py:695-703).

    ``guide`` (green_guide_planes of ``planes``): R/B sites read value -
    guide (guided_planes), so channels 0 and 2 hold R - G and B - G.

    planes (F, 2, 2, hh, hw) warped by integer plane shifts; residual
    (F, hh, hw, 2) in RAW pixel units (clipped to +-residual_bound here);
    certainty (F, hh, hw, 3); omega_inv / omega_inv_rb (hh, hw, 3) for
    green and R/B. With ``phase_output`` each output is the phase layout
    (2s, 2s, 3, hh, hw), phase index (a*s + py, b*s + px), which the
    pipelines and the kernel take; without it (the JAX default) each is
    interleaved to the image (2s*hh, 2s*hw, 3).

    A tap (ky, kx) lands on plane ((a+ky)%2, (b+kx)%2) at half-res offset
    ((a+ky)//2, (b+kx)//2) for output parity (a, b). Per tap, the frame
    axis is summed first and the sum then added to the accumulator, the
    JAX order."""
    form = raw_merge_form(order, moment_slots, centroid_cert, exact_weights)
    bf16 = bf16 and form == ORDER0  # order 1 ignores it, as in JAX
    if guide is not None:
        planes = guided_planes(planes, guide, cfa, bf16)
    f, _, _, hh, hw = planes.shape
    s = scale
    nph = s * s
    r_taps = radius + int(np.ceil(residual_bound))
    taps = _active_taps(r_taps, residual_bound, s, k_max, prune_exp)
    phi = _output_phase_offsets(s)
    phi_y = np.repeat(phi, s)  # per phase ph = py*s + px
    phi_x = np.tile(phi, s)
    dev = planes.device
    phiy_b = _const(tuple((phi_y * s).tolist()), dev).reshape(nph, 1, 1, 1)
    phix_b = _const(tuple((phi_x * s).tolist()), dev).reshape(nph, 1, 1, 1)
    phiy_r = _const(tuple(phi_y.tolist()), dev).reshape(nph, 1, 1)
    phix_r = _const(tuple(phi_x.tolist()), dev).reshape(nph, 1, 1)
    pat = np.asarray(cfa)
    certless = form == CERTLESS
    per_cell = form == PER_CELL
    exact_weights = exact_weights and form != ORDER0
    n_out = {CERTLESS: 4, ORDER0: 2, NINE_MOMENTS: 9, PER_CELL: 4}[form]
    # the per-cell centroid knobs (dead in the other forms, as in JAX)
    shared = per_cell and centroid_shared_res
    block = per_cell and (centroid_block or shared)
    cbf16 = per_cell and centroid_bf16
    ctaps = (
        None if not per_cell or centroid_prune is None
        else set(_active_taps(r_taps, residual_bound, s, k_max, centroid_prune))
    )
    n_slots = n_out + (2 if shared else 0)  # shared: the phase-0 residual sums
    acc_dt = torch.bfloat16 if bf16 else torch.float32

    res_y = residual[..., 0].clamp(-residual_bound, residual_bound)  # (F, hh, hw)
    res_x = residual[..., 1].clamp(-residual_bound, residual_bound)
    om_g = torch.movedim(omega_inv, -1, 0)  # (3, hh, hw)
    om_rb = torch.movedim(omega_inv_rb, -1, 0)
    # plane and certainty reads are views of one edge-padded copy each
    pad = max(1, (r_taps + 1) // 2)
    planes_p = _pad_last2(planes.to(acc_dt), pad, pad)
    cert_p = _pad_last2(torch.movedim(certainty, -1, 1).to(acc_dt), pad, pad)  # (F, 3, ., .)

    rho_y = rho_x = rho_yf = rho_xf = None
    if form in (NINE_MOMENTS, PER_CELL):
        # per parity a (b) the compact (s, F, hh, hw) query offsets: the
        # residual at phase row (column) p of the block, i + (a + phi[p] -
        # 0.5) / 2 in half-res units, blended with the neighbouring block,
        # + phi[p]
        def parity_rho(res, a, axis):
            rows = []
            for p in range(s):
                g = (a + phi[p] - 0.5) / 2.0
                ga = abs(float(g))
                sgn = 1 if g > 0 else -1
                nb = _shift_last2(res, sgn, 0) if axis == "y" else _shift_last2(res, 0, sgn)
                res1 = ((1.0 - ga) * res + ga * nb).clamp(-residual_bound, residual_bound)
                rows.append(res1 + float(phi[p]))
            return torch.stack(rows, 0)

        rho_y = [parity_rho(res_y, a, "y") for a in (0, 1)]
        rho_x = [parity_rho(res_x, b, "x") for b in (0, 1)]
        # (nph, F, hh, hw), phase ph = py*s + px: the moments' (and the
        # exact weights') displacement fields
        rho_yf = [r.repeat_interleave(s, dim=0) for r in rho_y]
        rho_xf = [r.repeat(s, 1, 1, 1) for r in rho_x]

    def quadp(dx, dy, om):
        return torch.exp(-0.5 * (dx * dx * om[0] + dy * dy * om[1] + 2.0 * dx * dy * om[2]))

    def add(store, key, i, term, n=3):
        cell = store.setdefault(key, [None] * n)
        cell[i] = term if cell[i] is None else cell[i] + term

    cells = {}  # (a, b, ch) -> n_slots sums over (nph, hh, hw)
    chains = {}  # certless: chain id -> [sum w, folded m01, folded m02]
    sf = float(s)
    for ky, kx in taps:
        if not exact_weights:
            dy_w = ((ky - res_y) * s)[None] - phiy_b  # (nph, F, hh, hw)
            dx_w = ((kx - res_x) * s)[None] - phix_b
            w_g = quadp(dx_w, dy_w, om_g).to(acc_dt)
            w_rb = quadp(dx_w, dy_w, om_rb).to(acc_dt)
        if certless:
            for cid, wf in ((("g", (ky + kx) % 2), w_g), (("rb", ky % 2, kx % 2), w_rb)):
                red_w = wf.sum(1)
                red_ry = (res_y * wf).sum(1)
                red_rx = (res_x * wf).sum(1)
                add(chains, cid, 0, red_w)
                add(chains, cid, 1, sf * ((float(ky) - phiy_r) * red_w - red_ry))
                add(chains, cid, 2, sf * ((float(kx) - phix_r) * red_w - red_rx))
        if form == NINE_MOMENTS or exact_weights:
            dy_m = [sf * (float(ky) - r) for r in rho_yf]
            dx_m = [sf * (float(kx) - r) for r in rho_xf]
        for a in (0, 1):
            qa, da = (a + ky) % 2, (a + ky) // 2
            for b in (0, 1):
                qb, db = (b + kx) % 2, (b + kx) // 2
                ch = int(pat[qa][qb])
                val = _shifted(planes_p[:, qa, qb], pad, da, db, hh, hw)
                cert_s = _shifted(cert_p[:, ch], pad, da, db, hh, hw)
                if exact_weights:
                    w = quadp(dx_m[b], dy_m[a], om_g if ch == 1 else om_rb)
                else:
                    w = w_g if ch == 1 else w_rb
                key = (a, b, ch)
                if form == ORDER0 and bf16:
                    # the compiled JAX function's rounding: a product that
                    # feeds a float32 sum is formed in float32 (exact for
                    # two bfloat16 factors), so w c rounds only on the
                    # value's path; each tap's frame sums round
                    wc32 = w.float() * cert_s[None].float()
                    add(cells, key, 0, (wc32.to(acc_dt).float() * val[None].float()).sum(1).to(acc_dt), n_slots)
                    add(cells, key, 1, wc32.sum(1).to(acc_dt), n_slots)
                    continue
                wc = w * cert_s[None]
                wcv = wc * val[None]
                if form == ORDER0:
                    add(cells, key, 0, wcv.sum(1), n_slots)
                    add(cells, key, 1, wc.sum(1), n_slots)
                    continue
                if certless:
                    terms = (wc, None, None, wcv)
                elif per_cell and ctaps is not None and (ky, kx) not in ctaps:
                    # outside the centroid's taps: m00 and b0 only
                    terms = (wc, None, None, wcv)
                elif per_cell and block:
                    red_wc = wc.sum(1)
                    if shared:
                        # the residual sums at phase 0 alone (folded below)
                        red_ry = (res_y * wc[:1]).sum(1)
                        red_rx = (res_x * wc[:1]).sum(1)
                        reds = (red_wc, sf * (float(ky) - phiy_r) * red_wc, sf * (float(kx) - phix_r) * red_wc,
                                wcv.sum(1), red_ry, red_rx)
                    else:
                        red_ry = (res_y * wc).sum(1)
                        red_rx = (res_x * wc).sum(1)
                        reds = (red_wc, sf * ((float(ky) - phiy_r) * red_wc - red_ry),
                                sf * ((float(kx) - phix_r) * red_wc - red_rx), wcv.sum(1))
                    for i, term in enumerate(reds):
                        add(cells, key, i, term, n_slots)
                    continue
                elif per_cell:
                    # s (k sum wc - sum rho wc), the compact rho broadcast
                    # against the phase-split weights (s, s, F, hh, hw)
                    red_wc = wc.sum(1)
                    wc5 = wc.reshape(s, s, f, hh, hw)
                    ry_p, rx_p = rho_y[a][:, None], rho_x[b][None, :]
                    if cbf16:  # bfloat16 factors; their products, exact in float32, summed there
                        wc5, ry_p, rx_p = (x.to(torch.bfloat16).float() for x in (wc5, ry_p, rx_p))
                    red_ry = (ry_p * wc5).sum(2).reshape(nph, hh, hw)
                    red_rx = (rx_p * wc5).sum(2).reshape(nph, hh, hw)
                    reds = (red_wc, sf * (float(ky) * red_wc - red_ry),
                            sf * (float(kx) * red_wc - red_rx), wcv.sum(1))
                    for i, term in enumerate(reds):
                        add(cells, key, i, term, n_slots)
                    continue
                else:
                    dy, dx = dy_m[a], dx_m[b]
                    terms = (wc, dy * wc, dx * wc, dy * dy * wc, dy * dx * wc, dx * dx * wc,
                             wcv, dy * wcv, dx * wcv)
                for i, term in enumerate(terms):
                    if term is not None:  # the frame axis dies here
                        add(cells, key, i, term.sum(1), n_slots)

    if shared:
        # the shared residual average folded into m01 and m02: mu = R0 /
        # m00[phase 0], each phase's term mu m00[phase]; cells whose taps
        # all lie outside the centroid's have no residual sums
        for cell in cells.values():
            if cell[0] is None or cell[n_out] is None:
                continue
            m00_0 = cell[0][:1]
            inv0 = torch.where(m00_0 > 1e-8, 1.0 / m00_0.clamp_min(1e-8), 0.0)
            cell[1] = cell[1] - sf * cell[n_out] * inv0 * cell[0]
            cell[2] = cell[2] - sf * cell[n_out + 1] * inv0 * cell[0]

    cent = {}
    for cid, (wsum, m1, m2) in chains.items():
        inv = torch.where(wsum > 1e-8, 1.0 / wsum.clamp_min(1e-8), 0.0)
        cent[cid] = ((m1 * inv).clamp(-2.0, 2.0), (m2 * inv).clamp(-2.0, 2.0))

    outs = [planes.new_zeros((2 * s, 2 * s, 3, hh, hw)) for _ in range(n_out)]
    for a in (0, 1):
        for b in (0, 1):
            rows, cols = slice(a * s, a * s + s), slice(b * s, b * s + s)
            for ch in range(3):
                cell = cells.get((a, b, ch))
                if cell is not None:
                    for i, part in enumerate(cell[:n_out]):
                        if part is not None:
                            outs[i][rows, cols, ch] = part.reshape(s, s, hh, hw).float()
                if certless:
                    chain = cent.get(_centroid_chain(cfa, a, b, ch))
                    if chain is not None:
                        outs[1][rows, cols, ch] = chain[0].reshape(s, s, hh, hw)
                        outs[2][rows, cols, ch] = chain[1].reshape(s, s, hh, hw)
    if not phase_output:
        return tuple(interleave_phases_planes(o) for o in outs)
    return tuple(outs)
