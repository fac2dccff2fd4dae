"""Configuration: the port's own frozen dataclasses.

Each copies, with the same name, fields and defaults, the dataclass of
multi_frame_super_resolution_tpu/config.py, where every field is
explained. The port imports nothing of the JAX package; the parity tests
rebuild the JAX dataclass from a port config (tests/torch_parity.py::
to_jax).

``check_supported`` (RGB path) and ``check_supported_raw`` (RAW path)
name every knob value the port does not take and raise instead of
silently computing something else (the rule of the JAX code at
models/handheld.py:411-420): the solvers and log-polar kernels the JAX
package does not define either, and use_pallas with rgb_order=1 (the
JAX function raises there too). Every scale runs: the merge kernels'
general forms take the scales past 4.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    tile_size: int = 16
    search_radius: int = 4
    fine_radius: Optional[int] = None
    levels: int = 3
    downsample: int = 2
    peak_threshold: float = 0.0
    subpixel: bool = True
    fast_extract: bool = True
    use_fft: bool = False


@dataclasses.dataclass(frozen=True)
class LKConfig:
    half_window: int = 8
    iterations: int = 2
    min_sigma: float = 1e-4
    bounded_warp: int = 0
    warp_tile: int = 0
    bf16: bool = True


@dataclasses.dataclass(frozen=True)
class RobustnessConfig:
    alpha: float = 0.004
    beta: float = 1e-4
    threshold_m: float = 0.8
    s: float = 1.5
    t: float = 0.12


@dataclasses.dataclass(frozen=True)
class MergeConfig:
    k_detail: float = 0.25
    k_denoise: float = 3.0
    k_stretch: float = 2.0
    k_shrink: float = 2.0
    d_th: float = 0.001
    d_tr: float = 0.006
    k_min: float = 0.25
    k_max: float = 1.0
    k_min_rb: float = 0.25
    guided_rb: bool = False
    weight_threshold: float = 1e-2
    order: int = 1
    rgb_order: Optional[int] = 0
    ridge: float = 0.02
    solver: str = "plugin"
    plugin_iters: int = 1
    exact_weights: bool = False
    centroid_prune: Optional[float] = None
    centroid_bf16: bool = False
    centroid_block: bool = False
    centroid_cert: bool = False
    centroid_shared_res: bool = False
    prune_exp: float = 1.5
    radius: int = 1
    use_pallas: bool = False
    bf16: bool = False


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    apodization_ratio: float = 0.12
    eps: float = 1e-15
    subpixel: bool = True
    logpolar_interp: str = "bicubic"
    fast_warp: bool = False
    downsample: int = 1
    peak_upsample: int = 0
    lp_radius_step: int = 1
    lp_matmul: bool = False


PREALIGN_FAST = RegistrationConfig(
    logpolar_interp="bilinear", fast_warp=True, downsample=2, peak_upsample=16,
    lp_radius_step=2, lp_matmul=True,
)


@dataclasses.dataclass(frozen=True)
class HandheldConfig:
    align: AlignConfig = AlignConfig()
    lk: LKConfig = LKConfig()
    robustness: RobustnessConfig = RobustnessConfig()
    merge: MergeConfig = MergeConfig()
    scale: int = 2
    cfa_pattern: Tuple[Tuple[int, int], Tuple[int, int]] = ((0, 1), (1, 2))  # RGGB, 0=R 1=G 2=B
    use_lk: bool = True
    st_window: int = 3
    gamma: bool = False
    fast: bool = True
    residual_bound: float = 1.0
    half_align: bool = True
    rgb_half_stats: bool = False
    use_consistency: bool = False
    smooth_residual: bool = True
    final_restore: bool = True
    restore_noise_gate: bool = True
    restore_gate_lo: float = 0.014
    restore_gate_hi: float = 0.020
    warp_matmul: bool = True
    prealign: bool = True
    prealign_cfg: RegistrationConfig = PREALIGN_FAST


@dataclasses.dataclass(frozen=True)
class DarkChannelConfig:
    window: int = 15
    omega: float = 0.95
    t0: float = 0.1
    top_percent: float = 0.001


@dataclasses.dataclass(frozen=True)
class PolarDefogConfig:
    radius: int = 12
    percent: float = 0.005
    beta: float = 1.55
    t_min: float = 0.001
    t_max: float = 0.999
    r_min: float = 0.001
    r_max: float = 0.999


@dataclasses.dataclass(frozen=True)
class BTVConfig:
    scale: int = 2
    iterations: int = 10
    temporal_radius: int = 1
    tau: float = 1.3
    lam: float = 0.03
    alpha: float = 0.7
    btv_kernel_size: int = 7
    blur_sigma: float = 0.0
    optical_flow: str = "pyrlk"
    fast: bool = True
    warp_tile: int = 16
    warp_residual_bound: int = 1


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    method: str = "pyrlk"
    pyramid_levels: int = 3
    lk_half_window: int = 6
    lk_iterations: int = 5
    fb_poly_n: int = 5
    fb_poly_sigma: float = 1.1
    fb_win_size: int = 13
    fb_iterations: int = 5
    tv_tau: float = 0.25
    tv_lambda: float = 0.15
    tv_theta: float = 0.3
    tv_iterations: int = 30
    tv_warps: int = 3
    brox_alpha: float = 0.03
    brox_gamma: float = 8.0
    brox_epsilon: float = 1e-3
    brox_presmooth: float = 0.8
    brox_outer_iterations: int = 3
    brox_inner_iterations: int = 3
    brox_solver_iterations: int = 12
    brox_omega: float = 0.9


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """Warmup-then-measure protocol of the benchmark harnesses."""

    warmup: int = 5
    iters: int = 20


# the RGB fast path through the merge kernel without global pre-alignment
PORT_DEFAULT = HandheldConfig(prealign=False, merge=MergeConfig(use_pallas=True))

# the RAW main path (bench.py's configuration) without global
# pre-alignment: fast path, LK, order-1 merge with the plugin solver and
# the certless centroid, gated restore, scale 2
RAW_PORT_DEFAULT = HandheldConfig(
    align=AlignConfig(tile_size=16, search_radius=4, levels=2),
    gamma=False,
    prealign=False,
)


# bench.py's configuration, letter for letter: the RAW main path with
# global pre-alignment
RAW_BENCH = HandheldConfig(align=AlignConfig(tile_size=16, search_radius=4, levels=2), gamma=False)

# the RGB fast path through the merge kernel, with global pre-alignment
RGB_PALLAS = HandheldConfig(merge=MergeConfig(use_pallas=True))

# the JAX package's default for handheld_superres: the RGB fast path's
# default merge branch (phase layout, prune at e^-1.5, gated restore),
# with global pre-alignment, and the same without it
RGB_DEFAULT = HandheldConfig()
RGB_DEFAULT_NOPRE = HandheldConfig(prealign=False)

# the JAX package's scale-4 RAW configuration (tests/test_fidelity.py's
# scale-4 and cascade tests), letter for letter
RAW_SCALE4 = HandheldConfig(
    align=AlignConfig(tile_size=8, search_radius=4, levels=2),
    gamma=False,
    scale=4,
    merge=MergeConfig(k_min_rb=0.5),
)

# the correctness bar's configurations (PARITY.md): bench.py's RAW
# configuration on the gather oracle, with the exact 3x3 solve, and with
# the order-0 merge; the RGB default on the oracle, and its default
# branch with the exact solve of the order-1 merge
RAW_ORACLE = dataclasses.replace(RAW_BENCH, fast=False)
RAW_EXACT = dataclasses.replace(RAW_BENCH, merge=MergeConfig(solver="exact"))
RAW_ORDER0 = dataclasses.replace(RAW_BENCH, merge=MergeConfig(order=0))
RGB_ORACLE = HandheldConfig(fast=False)
RGB_EXACT = HandheldConfig(merge=MergeConfig(rgb_order=1, solver="exact"))

# bench.py's RAW configuration with one handheld knob each: the guided
# R/B merge (colour differences against a green estimate), the per-cell
# centroid of the plugin solve, the shift-consistent alignment, the FFT
# SSD surfaces; and the RGB default with the shift-consistent alignment
RAW_GUIDED = dataclasses.replace(RAW_BENCH, merge=MergeConfig(guided_rb=True))
RAW_CERT = dataclasses.replace(RAW_BENCH, merge=MergeConfig(centroid_cert=True))
RAW_CONSISTENT = dataclasses.replace(RAW_BENCH, use_consistency=True)
RAW_FFT = dataclasses.replace(RAW_BENCH, align=dataclasses.replace(RAW_BENCH.align, use_fft=True))
RGB_CONSISTENT = HandheldConfig(use_consistency=True)

# the merge and warp knobs, each bench.py's RAW configuration (RAW_CERT
# for the per-cell centroid's four variants, RAW_ORDER0 for the order-0
# bf16 accumulation) or the RGB default with one knob changed: Gaussian
# weights at the parity-interpolated displacement (the per-cell layout),
# the block-centre centroid, its shared-residual refinement, the centroid
# restricted to the taps of a tighter prune (e^-1: the inner 3 x 3), bf16
# centroid products, bf16 order-0 accumulation (RAW and RGB), LK and
# robustness at half resolution (RGB), and the one-hot tile warp
RAW_EXACT_WEIGHTS = dataclasses.replace(RAW_BENCH, merge=MergeConfig(exact_weights=True))
RAW_CERT_BLOCK = dataclasses.replace(RAW_BENCH, merge=MergeConfig(centroid_cert=True, centroid_block=True))
RAW_CERT_SHARED = dataclasses.replace(RAW_BENCH, merge=MergeConfig(centroid_cert=True, centroid_shared_res=True))
RAW_CERT_PRUNE = dataclasses.replace(RAW_BENCH, merge=MergeConfig(centroid_cert=True, centroid_prune=1.0))
RAW_CERT_BF16 = dataclasses.replace(RAW_BENCH, merge=MergeConfig(centroid_cert=True, centroid_bf16=True))
RAW_ORDER0_BF16 = dataclasses.replace(RAW_BENCH, merge=MergeConfig(order=0, bf16=True))
RAW_ONEHOT_WARP = dataclasses.replace(RAW_BENCH, warp_matmul=False)
RGB_BF16 = HandheldConfig(merge=MergeConfig(bf16=True))
RGB_HALF_STATS = HandheldConfig(rgb_half_stats=True)
RGB_ONEHOT_WARP = HandheldConfig(warp_matmul=False)

_REMAP_METHODS = ("bilinear", "bicubic", "nearest")


def _common_unsupported(cfg: HandheldConfig) -> List[str]:
    bad = []
    if cfg.prealign and cfg.prealign_cfg.logpolar_interp not in _REMAP_METHODS:
        bad.append(f"prealign_cfg.logpolar_interp={cfg.prealign_cfg.logpolar_interp!r}")
    if cfg.merge.solver not in ("plugin", "exact"):
        bad.append(f"merge.solver={cfg.merge.solver!r}")
    return bad


def _raise(bad: List[str], start: str) -> None:
    if bad:
        raise ValueError(
            "not implemented by the PyTorch port: " + ", ".join(bad)
            + f"; start from {start}"
        )


def check_supported(cfg: HandheldConfig) -> None:
    """Raise ``ValueError`` naming each knob of ``cfg`` that selects an RGB
    path the port does not implement."""
    bad = _common_unsupported(cfg)
    m = cfg.merge
    rgb_order = m.order if m.rgb_order is None else m.rgb_order
    if cfg.fast and m.use_pallas and rgb_order == 1:
        # the JAX function raises here too: its Pallas merge is order 0
        bad.append("merge.rgb_order=1 with merge.use_pallas=True")
    _raise(bad, "config.RGB_DEFAULT")


def check_supported_raw(cfg: HandheldConfig) -> None:
    """Raise ``ValueError`` naming each knob of ``cfg`` that selects a RAW
    path the port does not implement."""
    _raise(_common_unsupported(cfg), "config.RAW_BENCH")
