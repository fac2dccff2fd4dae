"""The yardstick of the kernel rooflines: published peaks of one NVIDIA
H100 SXM, the operations per work item of each merge kernel's function
(frozen from ``chip_smoke.py::WORK``, where each term is derived), and
the items and bytes of a merge call at a cell's shapes.

A roofline's least time is the larger of the bytes over the HBM rate and
the operations over their peak rate; its share is that time over the
kernel's device time. Items count the work the function needs at the
call's shapes (frames x input pixels x taps x phases, the taps those the
call's tap list keeps), and bytes count each input byte once and each
output byte once: a later kernel that computes the same function reads
the same count.
"""

from __future__ import annotations

import dataclasses
import math

from port_bench.reference.models.fast_merge import _active_taps

# HBM3 bytes/s, float32 and bfloat16 FLOP/s outside the tensor cores, and
# the SFU's exp/s (16 a clock per SM, 132 SMs, 1.98 GHz boost)
HBM_BYTES_S, F32_FLOPS_S, BF16_FLOPS_S, EXP_S = 3.35e12, 67e12, 133.8e12, 16 * 132 * 1.98e9

# (f32 flops, exp[, bfloat16 flops]) per work item
WORK = {
    # RGB merge, order 0, per (frame, input pixel, tap, phase)
    "merge_fast": (19.5, 1),
    "merge_fast s=4": (17.5, 1),
    "merge_fast s=1": (4 + 12 + 1 + 4 + 4, 1),
    "merge_fast s=5": (4 + 12 + 1 / 5 + 4 / 5 + 4 / 25, 1),
    "merge_fast order 1": (31.5, 1),
    "merge_fast order 1 s=5": (4 + 24 + 1 / 5 + 4 / 5 + 4 / 25, 1),
    "merge_fast 9 slots": (4 + 54 + 0.5 + 2 + 1, 1),
    "merge_fast 9 slots s=4": (4 + 54 + 0.25 + 1 + 0.25, 1),
    "merge_fast 9 slots s=5": (4 + 54 + 1 / 5 + 4 / 5 + 4 / 25, 1),
    "merge_fast bf16": (4 + 1 + 0.5 + 2 + 1, 1, 15),
    "merge_fast bf16 s=4": (4 + 1 + 0.25 + 1 + 0.25, 1, 15),
    "merge_fast bf16 s=5": (4 + 1 + 1 / 5 + 4 / 5 + 4 / 25, 1, 15),
    # RAW merge, per (frame, half-res pixel, tap, phase)
    "merge_raw": (38.5, 2),
    "merge_raw S=1": (34 + 1 + 6 + 4, 2),
    "merge_raw S=3": (34 + 1 / 3 + 2 + 4 / 9, 2),
    "merge_raw S=4": (34 + 0.25 + 1.5 + 0.25, 2),
    "merge_raw S=5": (34 + 1 / 5 + 6 / 5 + 4 / 25, 2),
    "merge_raw order 0": (8 + 16 + 0.5 + 3 + 1, 2),
    "merge_raw order 0 S=4": (8 + 16 + 0.25 + 1.5 + 0.25, 2),
    "merge_raw order 0 S=5": (8 + 16 + 1 / 5 + 6 / 5 + 4 / 25, 2),
    "merge_raw 9 slots": (8 + 72 + 8 / 2 + 8 / 2, 2),
    "merge_raw 9 slots S=4": (8 + 72 + 8 / 4 + 8 / 4, 2),
    "merge_raw 9 slots S=5": (8 + 72 + 8 / 5 + 8 / 5, 2),
    "merge_raw cert4": (8 + 32 + 8 / 2 + 8 / 2, 2),
    "merge_raw cert4 S=4": (8 + 32 + 8 / 4 + 8 / 4, 2),
    "merge_raw cert4 S=5": (8 + 32 + 8 / 5 + 8 / 5, 2),
}


@dataclasses.dataclass(frozen=True)
class Bound:
    items: int
    flops: float
    bf16_flops: float
    exps: float
    bytes: int

    def least_s(self) -> float:
        """The least time the chip could take: bytes or operations."""
        ops_s = max(self.flops / F32_FLOPS_S + self.bf16_flops / BF16_FLOPS_S, self.exps / EXP_S)
        return max(self.bytes / HBM_BYTES_S, ops_s)

    def bound_by(self) -> str:
        ops_s = max(self.flops / F32_FLOPS_S + self.bf16_flops / BF16_FLOPS_S, self.exps / EXP_S)
        return "bytes" if self.bytes / HBM_BYTES_S >= ops_s else "operations"


def n_taps(scale: int, radius: int, residual_bound: float, k_max: float, prune_exp: float) -> int:
    """The taps a merge call keeps (fast_merge._active_taps)."""
    r_taps = radius + math.ceil(residual_bound)
    return len(_active_taps(r_taps, residual_bound, scale, k_max, prune_exp))


def _key(base: str, form: str, scale: int, letter: str) -> str | None:
    name = base + (f" {form}" if form else "")
    at_scale = f"{name} {letter}={scale}"
    if at_scale in WORK:
        return at_scale
    return name if scale == 2 and name in WORK else None


def _bound(key: str | None, items: int, nbytes: int) -> Bound | None:
    if key is None:
        return None
    flops, exps, bf16 = (*WORK[key], 0.0)[:3]
    return Bound(items, flops * items, bf16 * items, exps * items, nbytes)


def merge_raw_bound(merge: dict, scale: int, k_max: float, residual_bound: float, frames: int, height: int,
                    width: int) -> Bound | None:
    """The RAW merge call of a burst (frames, height, width) at ``scale``:
    planes (F, 2, 2, hh, hw), residual (F, hh, hw, 2), certainty (F, hh,
    hw, 3) and two kernel-parameter planes (hh, hw, 3) in, the form's
    moments (n, 2S, 2S, 3, hh, hw) out, all float32. ``merge`` is the
    configuration's merge settings, ``k_max`` its clamp at this scale,
    ``residual_bound`` the configuration's.
    None for a form the table has no entry for."""
    hh, hw = height // 2, width // 2
    if merge["guided_rb"] or merge["bf16"] or merge["exact_weights"]:
        return None
    if merge["order"] == 0:
        form, n_out = "order 0", 2
    elif merge["solver"] != "plugin":
        form, n_out = "9 slots", 9
    elif merge["centroid_cert"]:
        if merge["centroid_block"] or merge["centroid_shared_res"] or merge["centroid_bf16"] or (
                merge["centroid_prune"] is not None):
            return None
        form, n_out = "cert4", 4
    else:
        form, n_out = "", 4
    taps = n_taps(scale, merge["radius"], residual_bound, k_max, merge["prune_exp"])
    items = frames * hh * hw * taps * scale ** 2
    ins = 4 * (frames * 4 * hh * hw + frames * hh * hw * (2 + 3) + 2 * hh * hw * 3)
    outs = 4 * n_out * (2 * scale) ** 2 * 3 * hh * hw
    return _bound(_key("merge_raw", form, scale, "S"), items, ins + outs)


def merge_fast_bound(merge: dict, scale: int, k_max: float, residual_bound: float, frames: int, height: int,
                     width: int) -> Bound | None:
    """The RGB merge call (phase layout) of a burst (frames, height, width,
    3): warped (F, H, W, 3), residual (F, H, W, 2), certainty (F, H, W, 3)
    and kernel parameters (H, W, 3) in, the form's outputs (n, s, s, 3, H,
    W) out, all float32. None where the table has no entry."""
    if merge["use_pallas"]:
        return None
    rgb_order = merge["order"] if merge["rgb_order"] is None else merge["rgb_order"]
    if rgb_order == 1:
        form, n_out = ("order 1", 4) if merge["solver"] == "plugin" else ("9 slots", 9)
    else:
        form, n_out = ("bf16", 2) if merge["bf16"] else ("", 2)
    taps = n_taps(scale, merge["radius"], residual_bound, k_max, merge["prune_exp"])
    items = frames * height * width * taps * scale ** 2
    ins = 4 * (frames * height * width * (3 + 2 + 3) + height * width * 3)
    outs = 4 * n_out * scale ** 2 * 3 * height * width
    return _bound(_key("merge_fast", form, scale, "s"), items, ins + outs)
