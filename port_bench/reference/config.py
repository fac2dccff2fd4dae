"""The handheld pipeline's configuration: frozen dataclasses with the
fields and defaults of the program's ``config.py`` (and of the JAX
package's, where each field is explained). The benchmark builds one from
a configuration file (``port_bench/configs/``) for the reference, and the
program's own from the same file."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
