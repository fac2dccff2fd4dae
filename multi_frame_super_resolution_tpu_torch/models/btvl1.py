"""BTV-L1 multi-frame super-resolution (counterpart of models/btvl1.py).

For each output frame: take the temporal window [t-r, t+r], estimate a
dense optical flow from each window frame to the target with a chosen
backend, and run ``iterations`` steps of L1 data-term subgradient descent
with a bilateral-total-variation prior (Farsiu et al.) at ``scale``.

The degradation operator is warp, blur and decimation. Every window, and
every alternate frame of a window, runs as one batched computation: a
leading window axis stands for the JAX package's ``vmap`` over targets
and alternates. High-resolution images are kept channel-leading inside,
(..., C, sH, sW), so the warps work on planes. The iterations are a
Python loop of plain tensor ops: the path launches no hand kernel (the
JAX path reaches no Pallas kernel either).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from multi_frame_super_resolution_tpu_torch import resolve_device
from multi_frame_super_resolution_tpu_torch.config import BTVConfig, FlowConfig
from multi_frame_super_resolution_tpu_torch.ops.color import rgb_to_gray
from multi_frame_super_resolution_tpu_torch.ops.filters import (
    _const,
    _const_array,
    gaussian_kernel_1d,
    separable_filter_planes,
)
from multi_frame_super_resolution_tpu_torch.ops.geometry import warp_backward_planes
from multi_frame_super_resolution_tpu_torch.ops.warp_fast import (
    _pad_last2,
    _shifted,
    decompose_flow,
    tile_bounded_taps,
    upsample_int,
    warp_taps,
)
from multi_frame_super_resolution_tpu_torch.registration.optical_flow import create_optical_flow


def _blur_taps(cfg: BTVConfig) -> np.ndarray:
    sigma = cfg.blur_sigma if cfg.blur_sigma > 0 else cfg.scale * 0.5
    size = 2 * int(np.ceil(2 * sigma)) + 1
    return gaussian_kernel_1d(sigma, size)


def _blur(img: torch.Tensor, cfg: BTVConfig) -> torch.Tensor:
    """The degradation's blur H of planes (..., H, W), replicate border."""
    k = _blur_taps(cfg)
    return separable_filter_planes(img, k, k)


def _blur_decimate(img: torch.Tensor, cfg: BTVConfig, s: int) -> torch.Tensor:
    """Blur then s-strided block mean of planes (..., H, W), computed at the
    kept samples only: the Gaussian composed with the s-wide box in
    float64, each tap a strided view of the edge-padded image times one
    Python float, summed tap by tap (ops of the JAX function, in its
    order)."""
    taps = _blur_taps(cfg)
    r = len(taps) // 2
    h, w = img.shape[-2] // s * s, img.shape[-1] // s * s
    img = img[..., :h, :w]
    k = np.convolve(np.asarray(taps, np.float64), np.ones(s, np.float64) / s)
    xp = _pad_last2(img, r, r + s - 1)

    def axis_pass(x, axis):
        n = (h if axis == -2 else w) // s
        out = None
        for t, kt in enumerate(k):
            term = x.narrow(axis, t, (n - 1) * s + 1)
            term = (term[..., ::s, :] if axis == -2 else term[..., ::s]) * float(kt)
            out = term if out is None else out + term
        return out

    return axis_pass(axis_pass(xp, -2), -1)


def _adjoint_phase_taps(cfg: BTVConfig, s: int):
    """Per output phase p, the (source offset, weight) pairs of the
    polyphase adjoint blur: out[s i + p] = sum_t k[t] / s r[(s i + p + t - r) // s],
    duplicate offsets merged in float64; and the largest |offset|."""
    k = np.asarray(_blur_taps(cfg), np.float64) / s
    r2 = len(k) // 2
    phase_taps = []
    for p in range(s):
        d: dict = {}
        for t in range(len(k)):
            src = (p + t - r2) // s
            d[src] = d.get(src, 0.0) + float(k[t])
        phase_taps.append(sorted(d.items()))
    return phase_taps, max(abs(o) for taps in phase_taps for o, _ in taps)


def _adjoint_blur_up(r: torch.Tensor, cfg: BTVConfig, s: int) -> torch.Tensor:
    """``_blur(_block_mean_adjoint(r, s))`` of planes (..., h, w) ->
    (..., s h, s w), polyphase: per axis, each of the s output phases is a
    short correlation of the edge-padded low-resolution residual with the
    phase's merged taps, and the phases interleave."""
    phase_taps, pad = _adjoint_phase_taps(cfg, s)
    h, w = r.shape[-2], r.shape[-1]
    xp = _pad_last2(r, pad, pad)

    def axis_up(x, axis, length):
        phases = []
        for p in range(s):
            acc = None
            for off, wgt in phase_taps[p]:
                term = x.narrow(axis, pad + off, length) * wgt
                acc = term if acc is None else acc + term
            phases.append(acc)
        stacked = torch.stack(phases, dim=axis)
        shape = list(phases[0].shape)
        shape[axis] *= s
        return stacked.reshape(shape)

    return axis_up(axis_up(xp, -2, h), -1, w)


def _block_mean(x: torch.Tensor, s: int) -> torch.Tensor:
    """s x s block means of planes (..., H, W)."""
    h, w = x.shape[-2] // s, x.shape[-1] // s
    return x[..., : h * s, : w * s].reshape(x.shape[:-2] + (h, s, w, s)).mean(dim=(-3, -1))


def _block_mean_adjoint(r: torch.Tensor, s: int) -> torch.Tensor:
    """Exact adjoint of _block_mean: r / s^2 broadcast into each block."""
    return r.repeat_interleave(s, dim=-2).repeat_interleave(s, dim=-1) / (s * s)


def _btv_offsets(p: int):
    """The offsets d of the BTV prior's pairs (d, -d), |dy|, |dx| <= p, in
    the JAX function's order."""
    return [(dy, dx) for dy in range(0, p + 1) for dx in range(-p, p + 1) if dy > 0 or dx > 0]


def _btv_gradient(x: torch.Tensor, cfg: BTVConfig) -> torch.Tensor:
    """Subgradient of the bilateral TV prior of planes (..., H, W): for each
    offset pair (d, -d), 2 alpha^(|dy|+|dx|) (s_d - S_{-d} s_d) with
    s_d = sign(x - S_d x), the shifts edge-clamped. Every offset's terms
    are formed in one batch; they are summed one by one in the JAX
    function's order."""
    p = cfg.btv_kernel_size // 2
    h, w = x.shape[-2], x.shape[-1]
    offsets = _btv_offsets(p)
    weights = _const(tuple(2.0 * cfg.alpha ** (abs(dy) + abs(dx)) for dy, dx in offsets), x.device, x.dtype)
    xp = _pad_last2(x, p, p)
    s = torch.sign(x - torch.stack([_shifted(xp, p, dy, dx, h, w) for dy, dx in offsets]))
    sp = _pad_last2(s, p, p)
    back = torch.stack([_shifted(sp[k], p, -dy, -dx, h, w) for k, (dy, dx) in enumerate(offsets)])
    terms = weights.reshape((-1,) + (1,) * x.ndim) * (s - back)
    grad = terms[0]
    for term in terms[1:]:
        grad = grad + term
    return grad


def _int_array(values: tuple) -> np.ndarray:
    return np.asarray(values, np.int64)


def _index(values, device: torch.device) -> torch.Tensor:
    """A small index list on ``device``, copied there once (see
    ops/filters.py::_const_array)."""
    return _const_array(_int_array, (tuple(values),), device)


def _window_index(f: int, r: int) -> np.ndarray:
    """(F, 2r + 1): the frames of each target's window, wrapping."""
    return np.asarray([[(t + d) % f for d in range(-r, r + 1)] for t in range(f)], np.int64)


def _solve_windows(
    frames: torch.Tensor,
    cfg: BTVConfig,
    flow_cfg: Optional[FlowConfig],
    flows: Optional[torch.Tensor],
) -> torch.Tensor:
    """Solve a batch of temporal windows (B, n, H, W, C) whose center frame
    is each window's target -> (B, sH, sW, C). ``flows`` (B, n, H, W, 2),
    when given, replaces flow estimation for every window frame."""
    s = cfg.scale
    center = cfg.temporal_radius
    n_window = frames.shape[1]
    # estimated flows leave the center frame out: it is the target, its
    # flow is zero and its warp the identity. Injected flows are honored
    # for every window frame, the center included.
    identity_center = flows is None
    alt_idx = [i for i in range(n_window) if i != center] if identity_center else list(range(n_window))
    with record_function("mfsr.btv.flow"):
        if flows is None:
            flow_fn = create_optical_flow(flow_cfg or FlowConfig(method=cfg.optical_flow))
            gray = rgb_to_gray(frames) if frames.shape[-1] == 3 else frames[..., 0]
            # every alternate of every window in one call: moved(x + flow) ~= target(x)
            alt_flows = flow_fn(gray[:, center : center + 1], gray.index_select(1, _index(alt_idx, gray.device)))
        else:
            alt_flows = flows
    with record_function("mfsr.btv.init"):
        hr_flows = upsample_int(alt_flows, s, "bilinear") * s  # (B, n_alts, sH, sW, 2)
        x = upsample_int(frames[:, center], s, "bicubic").permute(0, 3, 1, 2)  # (B, C, sH, sW)
        planes = frames.permute(0, 1, 4, 2, 3)  # (B, n, C, H, W)
        frames_alt = planes.index_select(1, _index(alt_idx, planes.device))
        frame_c = planes[:, center]
        if cfg.fast:
            rb = cfg.warp_residual_bound
            sh, sw = x.shape[-2], x.shape[-1]

            def taps(fl):
                # the decomposed warp's gather taps, composed once: the
                # flows are fixed over the iterations. One shift field per
                # frame, shared by its channel planes.
                tile_int, res = decompose_flow(fl, cfg.warp_tile)
                return tile_bounded_taps(tile_int.unsqueeze(-4), res.clamp(-rb, rb).unsqueeze(-4), cfg.warp_tile,
                                         rb, sh, sw)

            fwd, inv = taps(-hr_flows), taps(hr_flows)
            warp = warp_taps
        else:
            fwd, inv = -hr_flows.unsqueeze(-4), hr_flows.unsqueeze(-4)
            warp = warp_backward_planes
    with record_function("mfsr.btv.iterate"):
        n_alts = len(alt_idx)
        for _ in range(cfg.iterations):
            xs = x.unsqueeze(1).expand((x.shape[0], n_alts) + x.shape[1:])
            # the estimate warped into each alternate's geometry, blurred and
            # decimated: the simulated low-resolution frames
            resid_alt = torch.sign(_blur_decimate(warp(xs, fwd), cfg, s) - frames_alt)
            data_grad = warp(_adjoint_blur_up(resid_alt, cfg, s), inv).sum(dim=1)
            if identity_center:
                resid_c = torch.sign(_blur_decimate(x, cfg, s) - frame_c)
                data_grad = data_grad + _adjoint_blur_up(resid_c, cfg, s)
            grad = data_grad + cfg.lam * _btv_gradient(x, cfg)
            # tau is the classical 8-bit-range step; both gradient terms are
            # sign-valued, so it is rescaled to [0, 1] intensities
            x = x - (cfg.tau / 255.0) * grad
        return x.clamp(0.0, 1.0).permute(0, 2, 3, 1)


def _channels_last(burst: torch.Tensor) -> torch.Tensor:
    return burst if burst.ndim == 4 else burst.unsqueeze(-1)


def _btvl1_window(
    frames: torch.Tensor,
    cfg: BTVConfig = BTVConfig(),
    flow_cfg: Optional[FlowConfig] = None,
    flows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Solve one temporal window (n, H, W[, C]) whose center frame is the
    target -> (sH, sW[, C]), on the device of ``frames``."""
    out = _solve_windows(_channels_last(frames)[None], cfg, flow_cfg, None if flows is None else flows[None])[0]
    return out if frames.ndim == 4 else out[..., 0]


def btvl1_superres(
    burst: torch.Tensor,
    target: int,
    cfg: BTVConfig = BTVConfig(),
    flow_cfg: Optional[FlowConfig] = None,
    flows: Optional[torch.Tensor] = None,
    *,
    device=None,
) -> torch.Tensor:
    """Super-resolve frame ``target`` of a burst (F, H, W[, C]) from the
    temporal window [target - r, target + r] (wrapping, as the reference's
    cycled frame source does) -> (scale H, scale W[, C]).

    ``flows`` (window, H, W, 2), when given, replaces flow estimation (the
    custom DenseOpticalFlowExt of the reference). Runs on cuda:0 unless
    ``device`` names another device; without a card it raises unless the
    CPU is asked for."""
    dev = resolve_device(device, "btvl1_superres", 'device="cpu"')
    f = burst.shape[0]
    window = [(target + d) % f for d in range(-cfg.temporal_radius, cfg.temporal_radius + 1)]
    frames = burst.to(dev).index_select(0, _index(window, dev))
    return _btvl1_window(frames, cfg, flow_cfg, None if flows is None else flows.to(dev))


def btvl1_video(
    burst: torch.Tensor,
    cfg: BTVConfig = BTVConfig(),
    flow_cfg: Optional[FlowConfig] = None,
    *,
    device=None,
) -> torch.Tensor:
    """Super-resolve every frame of a burst (F, H, W[, C]) -> (F, scale H,
    scale W[, C]): the reference app's stream of frames. All F windows run
    as one batch. Runs on cuda:0 unless ``device`` names another device;
    without a card it raises unless the CPU is asked for."""
    dev = resolve_device(device, "btvl1_video", 'device="cpu"')
    burst = burst.to(dev)
    f = burst.shape[0]
    r = cfg.temporal_radius
    windows = _channels_last(burst)[_const_array(_window_index, (f, r), dev)]  # (F, n, H, W, C)
    out = _solve_windows(windows, cfg, flow_cfg, None)
    return out if burst.ndim == 4 else out[..., 0]
