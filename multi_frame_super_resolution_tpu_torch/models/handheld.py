"""End-to-end handheld multi-frame super-resolution (counterpart of
models/handheld.py), both entry points on their fast paths and, with
cfg.fast=False, on the gather-based oracle paths:

- ``handheld_superres``: RGB burst in, ``_handheld_fast``
  (handheld.py:235-479). Global similarity pre-alignment (cfg.prealign)
  -> half-res tile-pyramid alignment -> per-tile integer warp of the
  alternates -> smooth subpixel residual + Lucas-Kanade refinement ->
  robustness on the warped frames -> structure-tensor kernel parameters
  -> static-tap merge -> weight-threshold normalization against a
  bicubic fallback. With cfg.rgb_half_stats LK and robustness run on the
  2x-downsampled frames and their results are lifted back
  (handheld.py:350-395). The merge runs on one of two branches, as in
  the JAX package: merge.use_pallas (the merge_fast_pallas form, order 0,
  interleaved) or the default branch (phase layout, prune at
  merge.prune_exp, order 0 in float32 or, with merge.bf16, bfloat16, or
  the plugin order-1 solve, the gated restore at scale 2, one phase
  interleave).
- ``handheld_superres_raw``: Bayer RAW burst in, ``_handheld_raw_fast``
  (handheld.py:534-555, :656-915), the main path. Everything runs in the
  CFA-plane domain: global similarity pre-alignment (cfg.prealign) ->
  half-res alignment -> integer plane warps -> residual
  + LK at half res -> robustness -> plane merge -> solve
  -> noise-gated restore -> one phase interleave. Scales 1-4;
  ``handheld_superres_raw_cascade`` runs scale 4 with the upsampled
  scale-2 result as its fallback (handheld.py:492-531). The merge is the
  certless plugin order 1 (the default), the plugin order 1 with the
  per-cell centroid (merge.centroid_cert or merge.exact_weights, with
  the centroid knobs centroid_block, centroid_shared_res, centroid_prune
  and centroid_bf16), order 1 with the exact 3x3 solve
  (merge.solver='exact'), or order 0 (merge.order=0, bfloat16 with
  merge.bf16); with merge.guided_rb each merges R - G and B - G against
  a green estimate of the warped planes and adds G back
  (handheld.py:822-869).
- the oracle (cfg.fast=False; handheld.py:145-232 and :550-633): the
  reference's accumulateImagesSuperRes math. Tile alignment densified to
  a bilinear per-pixel flow, LK at cfg.lk (the gather warp by default),
  robustness by a per-pixel gather at the rounded flow, and a gather
  merge of each output pixel's 5 x 5 window (at least) around its
  nearest sample, order 0 or order 1 with either solve; the fallback is
  the bicubic upscale of the reference frame (RAW: of its demosaic),
  the restore the output-resolution FIR. The RAW oracle aligns on the
  half-resolution quad subsample and merges the full-resolution mosaic.

Every path aligns the burst against frame 0, or, with
cfg.use_consistency, through the shift-consistency solve over pairs of
frames (registration/align.py::align_burst_consistent).

Both run on cuda:0 unless ``device`` names another device (``"cpu"`` or
a ``torch.device``); without a card and without that request they raise
RuntimeError and never fall back to the CPU. After the checks of config
and shape, the burst (and an override's transform) is moved to that
device before any stage runs. On CUDA the tile warp, the search windows
and the merges go through the Hopper kernels. The tile warp computes the
function of the JAX package's selector matmul (cfg.warp_matmul, the
default) or of its one-hot select (warp_matmul=False), which mis-warps
bands that cross tiles at bound 16, as the JAX function does. The pre-alignment's
validity mask rides through the tile warp as one more plane and
multiplies the certainty.

``prealign_override``: optional (st, origin, global_hw), a
SimilarityTransform (registration/logpolar.py, leading axis F - 1)
applied about the center of a ``global_hw`` image whose [0, 0] sits at
``origin`` instead of one estimated from this burst (half-res units on
the RAW path).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from multi_frame_super_resolution_tpu_torch import resolve_device
from multi_frame_super_resolution_tpu_torch.config import (
    HandheldConfig,
    MergeConfig,
    check_supported,
    check_supported_raw,
)
from multi_frame_super_resolution_tpu_torch.kernels.merge import merge_fast
from multi_frame_super_resolution_tpu_torch.kernels.merge_raw import merge_raw
from multi_frame_super_resolution_tpu_torch.kernels.tile_warp import tile_warp
from multi_frame_super_resolution_tpu_torch.models.fast_merge import (
    CERTLESS,
    grad_phases,
    green_guide_planes,
    planes_to_raw,
    raw_merge_form,
    raw_to_planes,
)
from multi_frame_super_resolution_tpu_torch.models.merge import (
    apply_weighting,
    apply_weighting_order1,
    grad_image,
    kernel_params,
    merge_burst_raw,
    merge_burst_rgb,
    smoothed_structure_tensor,
    solve_order1,
    solve_plugin,
)
from multi_frame_super_resolution_tpu_torch.models.robustness import robustness_mask
from multi_frame_super_resolution_tpu_torch.ops.color import rgb_to_gray, srgb_gamma
from multi_frame_super_resolution_tpu_torch.ops.debayer import debayer, debayer_subsample
from multi_frame_super_resolution_tpu_torch.ops.geometry import downsample2_planes, resize, upscale
from multi_frame_super_resolution_tpu_torch.ops.restore import (
    restore_gain,
    restore_image,
    restore_phases,
    temporal_noise_stat,
)
from multi_frame_super_resolution_tpu_torch.ops.warp_fast import (
    _repeat_tiles,
    interleave_phases_planes,
    tile_shift_decompose,
    upsample_int,
    upsample_int_phases_planes,
)
from multi_frame_super_resolution_tpu_torch.registration.align import (
    align_burst,
    align_burst_consistent,
    flow_from_tile_shifts,
)
from multi_frame_super_resolution_tpu_torch.registration.lucas_kanade import lk_refine
from multi_frame_super_resolution_tpu_torch.registration.prealign import (
    apply_burst_similarity,
    apply_planes_similarity,
    prealign_burst,
    prealign_planes,
)


def _scaled_merge_cfg(cfg: HandheldConfig) -> MergeConfig:
    """Merge config with the kernel variance clamps rescaled to the output
    grid by (scale/2)^2, so their input-pixel footprint stays constant."""
    m = (cfg.scale / 2.0) ** 2
    if m == 1.0:
        return cfg.merge
    return dataclasses.replace(
        cfg.merge,
        k_min=cfg.merge.k_min * m,
        k_max=cfg.merge.k_max * m,
        k_min_rb=cfg.merge.k_min_rb * m,
    )


def _on_device(who, burst, prealign_override, device):
    """The burst (contiguous) and the override on the entry point's device
    (see the module docstring)."""
    dev = resolve_device(device, who, 'device="cpu"')
    if prealign_override is not None:
        st, origin, global_hw = prealign_override
        st = dataclasses.replace(st, **{f.name: getattr(st, f.name).to(dev) for f in dataclasses.fields(st)})
        prealign_override = (st, origin, global_hw)
    return burst.to(dev).contiguous(), prealign_override


def _prealign(x, gray, cfg: HandheldConfig, prealign_override, apply_fn, estimate_fn):
    """``x`` and its validity after global pre-alignment: the override's
    transform applied by ``apply_fn`` (apply_burst_similarity or
    apply_planes_similarity), else one estimated from ``gray`` by
    ``estimate_fn`` (prealign_burst or prealign_planes)."""
    if prealign_override is not None:
        st, origin, global_hw = prealign_override
        return apply_fn(x, st, cfg.prealign_cfg, origin=origin, global_hw=global_hw)
    return estimate_fn(x, gray, cfg.prealign_cfg)


def handheld_superres(
    burst: torch.Tensor, cfg: HandheldConfig = HandheldConfig(), prealign_override=None, *, device=None
) -> torch.Tensor:
    """RGB burst (F, H, W, 3) float32, frame 0 the reference ->
    merged (scale*H, scale*W, 3) in [0, 1], on cuda:0 unless ``device``
    names another device. Raises ValueError for config knobs the port
    does not implement (config.check_supported)."""
    check_supported(cfg)
    if burst.ndim != 4 or burst.shape[-1] != 3 or burst.shape[0] < 2:
        raise ValueError(f"burst must be (F>=2, H, W, 3), got {tuple(burst.shape)}")
    if burst.dtype != torch.float32:
        raise TypeError(f"burst must be float32, got {burst.dtype}")
    burst, prealign_override = _on_device("handheld_superres", burst, prealign_override, device)
    if not cfg.fast:
        return _handheld_oracle(burst, cfg, prealign_override)
    return _handheld_fast(burst, cfg, prealign_override)


def _align(gray: torch.Tensor, cfg: HandheldConfig) -> torch.Tensor:
    """Per-tile shifts (F, nty, ntx, 2) of a grayscale burst against frame
    0: directly, or through the shift-consistency solve."""
    if cfg.use_consistency:
        return align_burst_consistent(gray, cfg.align)
    return align_burst(gray, cfg.align)


def _burst_flows(gray: torch.Tensor, cfg: HandheldConfig) -> torch.Tensor:
    """Tile-align a grayscale burst (F, H, W) against frame 0, densify the
    tile shifts to a bilinear per-pixel flow and refine it by LK at
    cfg.lk: flows (F, H, W, 2), frame 0's zero."""
    f, h, w = gray.shape
    with record_function("mfsr.align"):
        tile_shifts = _align(gray, cfg)
        flows = flow_from_tile_shifts(tile_shifts, cfg.align.tile_size, h, w)
    if cfg.use_lk:
        with record_function("mfsr.lk"):
            alts = lk_refine(gray[0], gray[1:], flows[1:], cfg.lk)
            flows = torch.cat([torch.zeros_like(alts[:1]), alts], dim=0)
    return flows


def _burst_certainty(rgb: torch.Tensor, flows: torch.Tensor, cfg: HandheldConfig) -> torch.Tensor:
    """Robustness certainties (F, H, W, 3) by the gather at each frame's
    rounded flow; the reference frame's are 1."""
    with record_function("mfsr.robustness"):
        alts = robustness_mask(rgb[0], rgb[1:], flows[1:], cfg.robustness, bounded=0)[..., :3]
        return torch.cat([torch.ones_like(alts[:1]), alts], dim=0)


def _oracle_merge(merge_fn, merge_args, cfg: HandheldConfig, order: int, fallback: torch.Tensor) -> torch.Tensor:
    """The oracle's gather merge at order 0 or 1 (the solve cfg.merge.solver
    names) and its weight-threshold finalize against ``fallback``."""
    with record_function("mfsr.merge"):
        moments = merge_fn(*merge_args, order=order)
    with record_function("mfsr.solve"):
        if order == 1:
            est, m00 = _o1_solve(moments, cfg, grad_image, precomputed_centroid=False)
            return apply_weighting_order1(est, m00, fallback, cfg.merge.weight_threshold)
        return apply_weighting(*moments, fallback, cfg.merge.weight_threshold)


def _oracle_finish(out: torch.Tensor, cfg: HandheldConfig, stat_fn) -> torch.Tensor:
    """The gated output-resolution restore at scale 2 (``stat_fn()`` gives
    the noise statistic), gamma, and the clip to [0, 1]."""
    if cfg.final_restore and cfg.scale == 2:
        with record_function("mfsr.restore"):
            out = _gated_restore(out, cfg, stat_fn(), restore_image)
    with record_function("mfsr.finalize"):
        if cfg.gamma:
            out = srgb_gamma(out)
        return out.clamp(0.0, 1.0)


def _handheld_oracle(burst: torch.Tensor, cfg: HandheldConfig, prealign_override=None) -> torch.Tensor:
    """The RGB gather path (handheld.py:164-232): alignment, flows, LK and
    robustness at full resolution on the unwarped frames."""
    gray = rgb_to_gray(burst)
    prevalid = None
    if cfg.prealign:
        with record_function("mfsr.prealign"):
            burst, prevalid = _prealign(
                burst, gray, cfg, prealign_override, apply_burst_similarity, prealign_burst
            )
            gray = rgb_to_gray(burst)
    flows = _burst_flows(gray, cfg)
    cert = _burst_certainty(burst, flows, cfg)
    if prevalid is not None:
        cert = cert * prevalid[..., None]  # frame 0's validity is all ones

    with record_function("mfsr.kernel_params"):
        omega_inv = kernel_params(smoothed_structure_tensor(gray[0], cfg.st_window), _scaled_merge_cfg(cfg))
        fallback = upscale(burst[0], cfg.scale, "bicubic")
    rgb_order = cfg.merge.order if cfg.merge.rgb_order is None else cfg.merge.rgb_order
    # the reference's 5 x 5 window at least: the gather has no prune_exp
    # compensation for a fast-path radius below 2
    oracle_radius = max(cfg.merge.radius, 2)
    out = _oracle_merge(
        merge_burst_rgb, (burst, flows, cert, omega_inv, cfg.scale, oracle_radius), cfg, rgb_order, fallback
    )

    def stat():
        # the unwarped frames registered by their rounded flows inside the
        # statistic, at half resolution (the gate's calibration scale)
        flows_half = torch.movedim(downsample2_planes(torch.movedim(flows, -1, 1)), 1, -1) * 0.5
        return temporal_noise_stat(downsample2_planes(gray), flows=flows_half)

    return _oracle_finish(out, cfg, stat)


def _handheld_fast(burst: torch.Tensor, cfg: HandheldConfig, prealign_override=None) -> torch.Tensor:
    # the record_function ranges name the stages in a profiler trace
    f, h, w = burst.shape[:3]
    t = cfg.align.tile_size
    gray = rgb_to_gray(burst)
    prevalid = None
    if cfg.prealign:
        with record_function("mfsr.prealign"):
            burst, prevalid = _prealign(
                burst, gray, cfg, prealign_override, apply_burst_similarity, prealign_burst
            )
            gray = rgb_to_gray(burst)
    # motion is estimated on half-res luma and lifted to full res; the
    # merge still sees full-res samples
    half = cfg.half_align and h % 2 == 0 and w % 2 == 0
    with record_function("mfsr.align"):
        if half:
            gray_est = downsample2_planes(gray)
            warp_t = 2 * t  # the half-res tile grid covers 2t full-res px
        else:
            gray_est = gray
            warp_t = t
        tile_shifts = _align(gray_est, cfg)
        if half:
            tile_shifts = tile_shifts * 2.0
        int_shifts, res_tiles = tile_shift_decompose(tile_shifts)

    # integer tile warp of the alternates' channel planes (and the
    # pre-alignment validity as a 4th) into reference geometry (the
    # function of tile_warp_matmul or tile_warp_select; the kernel on CUDA)
    with record_function("mfsr.tile_warp"):
        planes = burst[1:].permute(0, 3, 1, 2)  # (f-1, 3, h, w)
        if prevalid is not None:
            planes = torch.cat([planes, prevalid[1:, None]], dim=1)
        warped_planes = tile_warp(planes.contiguous(), int_shifts[1:], warp_t, onehot=not cfg.warp_matmul)
        valid_w = None if prevalid is None else warped_planes[:, 3]
        warped_alts = warped_planes[:, :3].permute(0, 2, 3, 1)
        warped = torch.cat([burst[:1], warped_alts], dim=0).contiguous()

    def lift(res):  # (..., nty, ntx, 2) -> (..., h, w, 2)
        return _repeat_tiles(res, warp_t, h, w)

    # residual = smooth dense flow minus the block-constant integer warp
    if cfg.smooth_residual:
        smooth_flow = flow_from_tile_shifts(tile_shifts, warp_t, h, w)
        res_flow = smooth_flow - lift(int_shifts.float())
    else:
        res_flow = lift(res_tiles)

    # LK and robustness of the reference frame are overwritten (zero flow,
    # certainty 1), so only the alternates are computed. With half-res
    # statistics both run on the 2x-downsampled frames (the residual
    # halved on the way down, doubled on the way up) and their results are
    # lifted back by the bilinear 2x upsample, cropped to (h, w)
    half_stats = cfg.rgb_half_stats and h % 2 == 0 and w % 2 == 0
    if half_stats:
        warped_h = downsample2_planes(warped, channel_last=True)
    res_alts = res_flow[1:]
    if cfg.use_lk:
        with record_function("mfsr.lk"):
            lk_cfg = dataclasses.replace(
                cfg.lk, bounded_warp=max(int(cfg.residual_bound) + 1, 2)
            )
            if half_stats:
                gray_wh = rgb_to_gray(warped_h)
                res_h = lk_refine(
                    gray_wh[0], gray_wh[1:], downsample2_planes(res_alts, channel_last=True) * 0.5, lk_cfg
                )
                res_alts = (upsample_int(res_h, 2, "bilinear") * 2.0)[:, :h, :w]
            else:
                gray_w = rgb_to_gray(warped)
                res_alts = lk_refine(gray_w[0], gray_w[1:], res_alts, lk_cfg)
    res_alts = res_alts.clamp(-cfg.residual_bound, cfg.residual_bound)
    res_flow = torch.cat([torch.zeros_like(res_flow[:1]), res_alts], dim=0)

    with record_function("mfsr.robustness"):
        if half_stats:
            cert_h = robustness_mask(
                warped_h[0], warped_h[1:], downsample2_planes(res_alts, channel_last=True) * 0.5,
                cfg.robustness, bounded=2,
            )[..., :3]
            cert_alts = upsample_int(cert_h, 2, "bilinear")[:, :h, :w]
        else:
            cert_alts = robustness_mask(
                warped[0], warped[1:], res_alts, cfg.robustness, bounded=2
            )[..., :3]
        if valid_w is not None:
            cert_alts = cert_alts * valid_w[..., None]
        cert = torch.cat([torch.ones_like(cert_alts[:1]), cert_alts], dim=0)

    with record_function("mfsr.kernel_params"):
        st = smoothed_structure_tensor(gray[0], cfg.st_window)
        merge_cfg = _scaled_merge_cfg(cfg)
        omega_inv = kernel_params(st, merge_cfg)

    rgb_order = cfg.merge.order if cfg.merge.rgb_order is None else cfg.merge.rgb_order
    merge_args = (
        warped, res_flow.contiguous(), cert.contiguous(), omega_inv.contiguous(),
        cfg.scale, cfg.merge.radius, cfg.residual_bound,
    )
    if cfg.merge.use_pallas:
        with record_function("mfsr.merge"):
            num, den = merge_fast(*merge_args, k_max=merge_cfg.k_max)
        with record_function("mfsr.finalize"):
            fallback = upsample_int(burst[0], cfg.scale, "bicubic")
            out = apply_weighting(num, den, fallback, cfg.merge.weight_threshold)
            if cfg.gamma:
                out = srgb_gamma(out)
            return out.clamp(0.0, 1.0)

    # the default branch: every finalize step in the channel-leading phase
    # domain ((s, s, 3, h, w)), one interleave at the end
    with record_function("mfsr.merge"):
        moments = merge_fast(
            *merge_args, k_max=merge_cfg.k_max, phase_output=True, order=rgb_order,
            prune_exp=cfg.merge.prune_exp, moment_slots=_moment_slots(cfg), bf16=cfg.merge.bf16,
        )
    with record_function("mfsr.solve"):
        fallback_p = upsample_int_phases_planes(burst[0], cfg.scale, "bicubic")
        if rgb_order == 1:
            est_p, m00_p = _o1_solve(moments, cfg, grad_phases, precomputed_centroid=False)
            out_p = apply_weighting_order1(est_p, m00_p, fallback_p, cfg.merge.weight_threshold)
        else:
            out_p = apply_weighting(*moments, fallback_p, cfg.merge.weight_threshold)
    if cfg.final_restore and cfg.scale == 2:
        with record_function("mfsr.restore"):
            res_half = torch.movedim(downsample2_planes(torch.movedim(res_flow[1:], -1, 1)), 1, -1)
            stat = temporal_noise_stat(downsample2_planes(rgb_to_gray(warped)), residual=res_half * 0.5)
            out_p = _gated_restore(out_p, cfg, stat, restore_phases)
    with record_function("mfsr.finalize"):
        if cfg.gamma:
            out_p = srgb_gamma(out_p)
        return interleave_phases_planes(out_p).clamp(0.0, 1.0)


def _gated_restore(out, cfg: HandheldConfig, stat, restore_fn):
    """The restoration FIR scaled by the noise-adaptive gain when
    cfg.restore_noise_gate (fused into restore_fn's accumulation), else
    at full strength."""
    if not cfg.restore_noise_gate:
        return restore_fn(out)
    g = restore_gain(stat, cfg.restore_gate_lo, cfg.restore_gate_hi)
    return restore_fn(out, gain=g)


def _moment_slots(cfg: HandheldConfig) -> int:
    """The fast merges' order-1 moment slots: 4 for the plugin solve, 9
    for the exact one."""
    return 4 if cfg.merge.solver == "plugin" else 9


def _o1_solve(moments, cfg: HandheldConfig, grad_fn, precomputed_centroid: bool):
    """MergeConfig.solver's order-1 solve: the plugin solver on the
    merge's 4 moment slots (or the oracle's 9), its gradient from
    ``grad_fn`` in the estimate's layout, or the exact 3x3 solve
    (solve_order1) on 9 slots. ``precomputed_centroid``: slots 1/2 hold
    the finalized centroid, as the RAW merge's certless chains return it
    (the JAX package's ``_certless`` case; the RAW path reads it from the
    form its merge ran)."""
    if cfg.merge.solver == "plugin":
        return solve_plugin(
            moments, grad_fn, cfg.merge.plugin_iters, precomputed_centroid=precomputed_centroid
        )
    return solve_order1(moments, cfg.merge.ridge)


def _subsample_from_planes(planes: torch.Tensor, cfa) -> torch.Tensor:
    """(F, 2, 2, hh, hw) CFA planes -> half-res RGB (F, hh, hw, 3) with
    same-channel sites averaged (deBayersSubSample3 semantics)."""
    pat = [[int(c) for c in row] for row in cfa]
    out = []
    for c in range(3):
        sites = [(a, b) for a in (0, 1) for b in (0, 1) if pat[a][b] == c]
        n = max(len(sites), 1)
        acc = None
        for a, b in sites:
            p = planes[:, a, b] / n
            acc = p if acc is None else acc + p
        out.append(acc if acc is not None else torch.zeros_like(planes[:, 0, 0]))
    return torch.stack(out, dim=-1)


def _image_phases(img: torch.Tensor, n: int) -> torch.Tensor:
    """(n*hh, n*hw, C) image -> channel-leading phase planes
    (n, n, C, hh, hw): the inverse of interleave_phases_planes."""
    h, w, c = img.shape
    return img.reshape(h // n, n, w // n, n, c).permute(1, 3, 4, 0, 2)


def handheld_superres_raw_cascade(
    raw_burst: torch.Tensor, cfg: HandheldConfig, *, device=None
) -> torch.Tensor:
    """Scale 4 as a 2x cascade (handheld.py:492-531): the scale-2 pipeline
    (gamma off), its output upsampled 2x bicubic, and the scale-4 pipeline
    with that image as its weight-threshold fallback and the threshold
    raised to at least 1.0. Both runs align and pre-align the burst on
    their own, as the JAX function's do."""
    if cfg.scale != 4:
        raise ValueError(f"the cascade targets scale 4 (2x o 2x), got scale {cfg.scale}")
    sr2 = handheld_superres_raw(
        raw_burst, dataclasses.replace(cfg, scale=2, gamma=False), device=device
    )
    fallback = upscale(sr2, 2, "bicubic")
    cfg4 = dataclasses.replace(
        cfg,
        merge=dataclasses.replace(
            cfg.merge, weight_threshold=max(cfg.merge.weight_threshold, 1.0)
        ),
    )
    return handheld_superres_raw(raw_burst, cfg4, fallback_hr=fallback, device=device)


def handheld_superres_raw(
    raw_burst: torch.Tensor,
    cfg: HandheldConfig = HandheldConfig(gamma=True),
    prealign_override=None,
    fallback_hr: torch.Tensor | None = None,
    *,
    device=None,
) -> torch.Tensor:
    """Bayer RAW burst (F, H, W) float32 in [0, 1], frame 0 the reference,
    H and W even -> merged RGB (scale*H, scale*W, 3) in [0, 1], on cuda:0
    unless ``device`` names another device. ``fallback_hr`` (scale*H,
    scale*W, 3) replaces the weight-threshold fallback (the half-res RGB
    upsampled). Raises ValueError for config knobs the port does not
    implement (config.check_supported_raw)."""
    check_supported_raw(cfg)
    if raw_burst.ndim != 3 or raw_burst.shape[0] < 2:
        raise ValueError(f"raw_burst must be (F>=2, H, W), got {tuple(raw_burst.shape)}")
    if raw_burst.shape[1] % 2 or raw_burst.shape[2] % 2:
        raise ValueError(f"RAW dims must be even (Bayer quads), got {tuple(raw_burst.shape)}")
    if raw_burst.dtype != torch.float32:
        raise TypeError(f"raw_burst must be float32, got {raw_burst.dtype}")
    f, h, w = raw_burst.shape
    if fallback_hr is not None:
        want = (cfg.scale * h, cfg.scale * w, 3)
        if tuple(fallback_hr.shape) != want:
            raise ValueError(f"fallback_hr must be {want}, got {tuple(fallback_hr.shape)}")
    raw_burst, prealign_override = _on_device("handheld_superres_raw", raw_burst, prealign_override, device)
    if fallback_hr is not None:
        fallback_hr = fallback_hr.to(raw_burst.device)
    if not cfg.fast:
        return _handheld_raw_oracle(raw_burst, cfg, prealign_override, fallback_hr)
    return _handheld_raw_fast(raw_burst, cfg, prealign_override, fallback_hr)


def _handheld_raw_oracle(
    raw_burst: torch.Tensor, cfg: HandheldConfig, prealign_override=None, fallback_hr=None
) -> torch.Tensor:
    """The RAW gather path (handheld.py:556-633): alignment, flows, LK and
    robustness on the half-resolution quad subsample, the merge on the
    full-resolution mosaic with the flows and kernel parameters resized
    to it."""
    f, h, w = raw_burst.shape
    cfa = cfg.cfa_pattern
    half = debayer_subsample(raw_burst, cfa)
    gray_half = rgb_to_gray(half)
    prevalid = None
    if cfg.prealign:
        with record_function("mfsr.prealign"):
            planes, prevalid = _prealign(
                raw_to_planes(raw_burst), gray_half, cfg, prealign_override,
                apply_planes_similarity, prealign_planes,
            )
            raw_burst = planes_to_raw(planes)
            half = debayer_subsample(raw_burst, cfa)
            gray_half = rgb_to_gray(half)
    flows_half = _burst_flows(gray_half, cfg)
    cert = _burst_certainty(half, flows_half, cfg)
    if prevalid is not None:
        cert = cert * prevalid[..., None]

    with record_function("mfsr.kernel_params"):
        # half-res kernel parameters and flows (x2: RAW pixels) on the RAW grid
        st = smoothed_structure_tensor(gray_half[0], cfg.st_window)
        omega_inv = resize(kernel_params(st, _scaled_merge_cfg(cfg)), h, w, "bilinear")
        flows_raw = resize(flows_half, h, w, "bilinear") * 2.0
        if fallback_hr is not None:
            fallback = fallback_hr
        else:
            fallback = upscale(debayer(raw_burst[0], cfa), cfg.scale, "bicubic")
    oracle_radius = max(cfg.merge.radius, 2)  # see _handheld_oracle
    out = _oracle_merge(
        merge_burst_raw, (raw_burst, flows_raw, cert, omega_inv, cfa, cfg.scale, oracle_radius),
        cfg, cfg.merge.order, fallback,
    )
    return _oracle_finish(out, cfg, lambda: temporal_noise_stat(gray_half, flows=flows_half))


def _handheld_raw_fast(
    raw_burst: torch.Tensor, cfg: HandheldConfig, prealign_override=None, fallback_hr=None
) -> torch.Tensor:
    f, h, w = raw_burst.shape
    t = cfg.align.tile_size
    hh, hw = h // 2, w // 2
    cfa = cfg.cfa_pattern

    with record_function("mfsr.align"):
        planes = raw_to_planes(raw_burst)  # (F, 2, 2, hh, hw) view
        half = _subsample_from_planes(planes, cfa)
        gray_half = rgb_to_gray(half)
    prevalid = None
    if cfg.prealign:
        with record_function("mfsr.prealign"):
            planes, prevalid = _prealign(
                planes, gray_half, cfg, prealign_override, apply_planes_similarity, prealign_planes
            )
            half = _subsample_from_planes(planes, cfa)
            gray_half = rgb_to_gray(half)

    with record_function("mfsr.align"):
        tile_shifts = _align(gray_half, cfg)  # half-res units
        int_half, res_tiles = tile_shift_decompose(tile_shifts)

    # integer plane warp == even RAW-unit warp (the CFA phase is kept),
    # the pre-alignment validity warped as a 5th plane; the reference
    # frame needs no warp, LK or robustness
    with record_function("mfsr.tile_warp"):
        stack = planes[1:].reshape(f - 1, 4, hh, hw)
        if prevalid is not None:
            stack = torch.cat([stack, prevalid[1:, None]], dim=1)
        warped_stack = tile_warp(stack.contiguous(), int_half[1:], t, bound=16, onehot=not cfg.warp_matmul)
        valid_w = None if prevalid is None else warped_stack[:, 4]
        warped_alts = warped_stack[:, :4].reshape(f - 1, 2, 2, hh, hw)
        warped = torch.cat([planes[:1], warped_alts], dim=0)

    # residual at half res = smooth dense flow minus the block-constant
    # integer warp, then LK on the warped half-res luma
    with record_function("mfsr.lk"):
        if cfg.smooth_residual:
            smooth_half = flow_from_tile_shifts(tile_shifts[1:], t, hh, hw)
            res_alts = smooth_half - _repeat_tiles(int_half[1:].float(), t, hh, hw)
        else:
            res_alts = _repeat_tiles(res_tiles[1:], t, hh, hw)
        warped_half = _subsample_from_planes(warped, cfa)
        gray_wh = rgb_to_gray(warped_half)
        if cfg.use_lk:
            lk_cfg = dataclasses.replace(cfg.lk, bounded_warp=2)
            res_alts = lk_refine(gray_wh[0], gray_wh[1:], res_alts, lk_cfg)
        # half-res residual within +-residual_bound/2, so RAW units stay
        # within +-residual_bound
        res_alts = res_alts.clamp(-0.5 * cfg.residual_bound, 0.5 * cfg.residual_bound)
        res_half = torch.cat([torch.zeros_like(res_alts[:1]), res_alts], dim=0)

    with record_function("mfsr.robustness"):
        cert_alts = robustness_mask(
            warped_half[0], warped_half[1:], res_alts, cfg.robustness, bounded=2
        )[..., :3]
        if valid_w is not None:
            cert_alts = cert_alts * valid_w[..., None]
        cert_half = torch.cat([torch.ones_like(cert_alts[:1]), cert_alts], dim=0)

    with record_function("mfsr.kernel_params"):
        st = smoothed_structure_tensor(gray_half[0], cfg.st_window)
        mc = _scaled_merge_cfg(cfg)
        omega_half = kernel_params(st, mc)
        # wider kernels for the 2x-sparser R/B channels
        mc_rb = dataclasses.replace(mc, k_min=max(mc.k_min, mc.k_min_rb))
        omega_half_rb = kernel_params(st, mc_rb)

    order = cfg.merge.order
    slots = _moment_slots(cfg)
    m = cfg.merge
    with record_function("mfsr.merge"):
        # guided: R/B merge as colour differences against the green
        # estimate of the warped planes, frame 0 included
        guide = green_guide_planes(warped, cfa).contiguous() if m.guided_rb else None
        moments = merge_raw(
            warped, (res_half * 2.0).contiguous(), cert_half.contiguous(),
            omega_half.contiguous(), omega_half_rb.contiguous(), cfa, cfg.scale,
            m.radius, cfg.residual_bound, k_max=mc.k_max,
            prune_exp=m.prune_exp, order=order, moment_slots=slots,
            guide=guide, centroid_cert=m.centroid_cert, exact_weights=m.exact_weights,
            centroid_prune=m.centroid_prune, centroid_bf16=m.centroid_bf16,
            centroid_block=m.centroid_block, centroid_shared_res=m.centroid_shared_res, bf16=m.bf16,
        )

    # all finalize math in the channel-leading phase domain
    # ((2s, 2s, 3, hh, hw)), one interleave at the end; the fallback is
    # fallback_hr, or the half-res RGB upsampled 2s-x
    with record_function("mfsr.solve"):
        if fallback_hr is not None:
            fallback_p = _image_phases(fallback_hr, 2 * cfg.scale)
        else:
            fallback_p = upsample_int_phases_planes(half[0], 2 * cfg.scale, "bilinear")
        if guide is not None:
            # channels 0 and 2 hold R - G and B - G: so does their fallback
            fb_g = fallback_p[:, :, 1]
            fallback_p = torch.stack([fallback_p[:, :, 0] - fb_g, fb_g, fallback_p[:, :, 2] - fb_g], dim=2)
        if order == 1:
            # the certless form returns the finalized centroid in slots 1/2
            certless = raw_merge_form(order, slots, m.centroid_cert, m.exact_weights) == CERTLESS
            est_p, m00_p = _o1_solve(moments, cfg, grad_phases, precomputed_centroid=certless)
            out_p = apply_weighting_order1(est_p, m00_p, fallback_p, cfg.merge.weight_threshold)
        else:
            out_p = apply_weighting(*moments, fallback_p, cfg.merge.weight_threshold)
        if guide is not None:
            g = out_p[:, :, 1]
            out_p = torch.stack([g + out_p[:, :, 0], g, g + out_p[:, :, 2]], dim=2)

    if cfg.final_restore and cfg.scale == 2:
        with record_function("mfsr.restore"):
            stat = temporal_noise_stat(gray_wh, residual=res_half[1:])
            out_p = _gated_restore(out_p, cfg, stat, restore_phases)

    with record_function("mfsr.finalize"):
        if cfg.gamma:
            out_p = srgb_gamma(out_p)
        return interleave_phases_planes(out_p).clamp(0.0, 1.0)
