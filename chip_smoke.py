#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. The card: name and power limit (nvidia-smi).
2. Build: compiles csrc/merge.cu with nvcc for sm_90a (timed as set-up).
3. Kernel check: the merge kernel against its plain PyTorch version on
   the card, at the slice's shapes (F=5, 256 x 512, scale 2, radius 1,
   residual bound 1, k_max 1), random inputs from a seed.
4. Slice: handheld_superres on a synthetic 5 x 256 x 512 x 3 RGB burst
   (the city burst's geometry) on the card. The output must be
   (512, 1024, 3), finite and in [0, 1]; the merge kernel must have been
   launched; it must agree (PSNR >= 60 dB) with the same run with the
   merge swapped for its plain version, and a small burst on the card
   must agree with the port on the CPU.
5. Timing with CUDA events after warm-up, each burst distinct (scaled by
   1 - 1e-5 i): ms per burst and output MP/s of the slice, ms of the
   merge kernel beside its plain version.
6. Where the time goes: one burst under torch.profiler, host and device
   ms of each pipeline stage (the mfsr.* ranges of models/handheld.py)
   and the card's busy share.

The last lines are the card line, a JSON line of the kernels, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

F, H, W, SCALE = 5, 256, 512, 2
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)  # expf and FMA contraction vs torch ops
PSNR_MIN = 60.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = torch.mean((a.double() - b.double()) ** 2).item()
    return float("inf") if mse == 0.0 else 10.0 * np.log10(1.0 / mse)


def time_cuda(fn, iters: int, warmup: int) -> float:
    """Mean ms per call of ``fn`` between CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def merge_inputs(rng: np.random.Generator, dev: torch.device):
    """Random merge inputs as tests/test_pallas_ops.py makes them."""
    warped = rng.random((F, H, W, 3)).astype(np.float32)
    residual = (rng.random((F, H, W, 2)) * 2.0 - 1.0).astype(np.float32)
    cert = rng.random((F, H, W, 3)).astype(np.float32)
    omega = (0.5 + rng.random((H, W, 3))).astype(np.float32)
    omega[..., 2] *= 0.1
    return [torch.from_numpy(x).to(dev) for x in (warped, residual, cert, omega)]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from multi_frame_super_resolution_tpu_torch.config import PORT_DEFAULT
    from multi_frame_super_resolution_tpu_torch.data import synthetic_rgb_burst
    from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
    from multi_frame_super_resolution_tpu_torch.kernels import merge as kmerge
    from multi_frame_super_resolution_tpu_torch.models import fast_merge, handheld

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}  (torch {torch.__version__}, CUDA {torch.version.cuda})")

    # 2. build
    t0 = time.perf_counter()
    lib = kmerge.library()
    print(f"build: {kmerge.SOURCE} in {time.perf_counter() - t0:.2f} s (set-up)")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernel against its plain version at the slice's shapes
    merge_args = (SCALE, 1, 1.0, 1.0)
    ins = merge_inputs(np.random.default_rng(0), dev)
    num_k, den_k = kmerge.merge_fast(*ins, *merge_args)
    torch.cuda.synchronize()
    num_p, den_p = fast_merge.merge_burst_fast(*ins, *merge_args)
    errs = {}
    for name, got, want in (("num", num_k, num_p), ("den", den_k, den_p)):
        diff = (got - want).abs()
        errs[name] = (diff.max().item(), (diff / want.abs().clamp_min(1e-6)).max().item())
        print(f"kernel check {name}: max abs {errs[name][0]:.3e}, max rel {errs[name][1]:.3e} "
              f"(tolerance rtol {KERNEL_TOL['rtol']}, atol {KERNEL_TOL['atol']})")
        torch.testing.assert_close(got, want, **KERNEL_TOL)
    max_abs_err = max(e[0] for e in errs.values())

    # 4. the slice end to end on the card
    burst_np, _ = synthetic_rgb_burst(np.random.default_rng(0), F, H, W, 3.0)
    burst = torch.from_numpy(burst_np).to(dev)
    cfg = PORT_DEFAULT
    LAUNCHES.clear()
    out = handheld.handheld_superres(burst, cfg)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches.get(kmerge.NAME, 0) < 1:
        raise RuntimeError(f"the slice did not launch the merge kernel: {launches}")
    if tuple(out.shape) != (SCALE * H, SCALE * W, 3):
        raise RuntimeError(f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()) or out.min() < 0.0 or out.max() > 1.0:
        raise RuntimeError("output not finite or outside [0, 1]")
    with mock.patch.object(handheld, "merge_fast", fast_merge.merge_burst_fast):
        out_plain = handheld.handheld_superres(burst, cfg)
    p_plain = psnr(out, out_plain)
    small = torch.from_numpy(synthetic_rgb_burst(np.random.default_rng(1), 4, 64, 128, 2.5)[0])
    p_cpu = psnr(handheld.handheld_superres(small.to(dev), cfg).cpu(),
                 handheld.handheld_superres(small, cfg))
    print(f"slice: {F}x{H}x{W}x3 -> {tuple(out.shape)}, merge launches {launches}, "
          f"PSNR vs plain merge {p_plain:.2f} dB, small burst card vs CPU {p_cpu:.2f} dB "
          f"(limit {PSNR_MIN} dB)")
    if p_plain < PSNR_MIN or p_cpu < PSNR_MIN:
        raise RuntimeError("the slice disagrees with its reference")

    # 5. timing
    kernel_ms = time_cuda(lambda: kmerge.merge_fast(*ins, *merge_args), iters=50, warmup=5)
    plain_ms = time_cuda(lambda: fast_merge.merge_burst_fast(*ins, *merge_args), iters=5, warmup=2)
    kernel_ms2 = time_cuda(lambda: kmerge.merge_fast(*ins, *merge_args), iters=50, warmup=5)
    print(f"merge at {F}x{H}x{W}, s={SCALE}, 25 taps: kernel {kernel_ms:.4f} / {kernel_ms2:.4f} ms, "
          f"plain {plain_ms:.4f} ms  [{card}]")

    bursts = [burst * (1.0 - 1e-5 * i) for i in range(13)]
    times = []
    for i, b in enumerate(bursts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        start.record()
        handheld.handheld_superres(b, cfg)
        end.record()
        end.synchronize()
        if i >= 3:  # the first three are warm-up
            times.append((start.elapsed_time(end), (time.perf_counter() - t_host) * 1e3))
    ms = statistics.median(t[0] for t in times)
    host_ms = statistics.median(t[1] for t in times)
    mp_s = SCALE * H * SCALE * W / (ms * 1e-3) / 1e6
    print(f"slice timing: median {ms:.3f} ms/burst (host clock {host_ms:.3f} ms) over "
          f"{len(times)} bursts, {mp_s:.2f} output MP/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB  [{card}]")

    profile_stages(handheld, burst, cfg, ms, card)

    print(json.dumps({"kernels": [{
        "name": kmerge.NAME,
        "route": "cuda",
        "source": "multi_frame_super_resolution_tpu_torch/csrc/merge.cu",
        "replaces": "multi_frame_super_resolution_tpu/pallas_ops/merge.py:132",
        "launches": launches.get(kmerge.NAME, 0),
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


def profile_stages(handheld, burst, cfg, burst_ms: float, card: str) -> None:
    """Host and device ms of each pipeline stage over one profiled burst,
    and the share of an unprofiled burst (``burst_ms``) the card is busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        handheld.handheld_superres(burst, cfg)
        torch.cuda.synchronize()
    stages, kernels_us, launches = {}, 0.0, 0
    for evt in prof.key_averages():
        if evt.key.startswith("mfsr."):
            # the host-side range carries the device time of its kernels
            if evt.cpu_time_total > stages.get(evt.key, (0.0, 0.0))[0]:
                stages[evt.key] = (evt.cpu_time_total, evt.device_time_total)
        elif evt.device_type == DeviceType.CUDA and not evt.is_user_annotation:
            kernels_us += evt.self_device_time_total  # kernels and copies
            launches += evt.count
    for name, (host_us, dev_us) in sorted(stages.items(), key=lambda kv: -kv[1][0]):
        print(f"stage {name}: host {host_us / 1e3:.3f} ms, device {dev_us / 1e3:.3f} ms")
    print(f"profile: {launches} device ops, {kernels_us / 1e3:.3f} ms device time per burst; "
          f"card busy {100.0 * kernels_us / 1e3 / burst_ms:.1f}% of {burst_ms:.3f} ms/burst  [{card}]")


if __name__ == "__main__":
    sys.exit(main())
