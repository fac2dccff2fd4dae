#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. The card: name and power limit (nvidia-smi).
2. Build: compiles the four kernels of csrc/ with nvcc for sm_90a, one
   nvcc process each, all at once (timed as set-up).
3. Kernel checks, each kernel against its plain PyTorch version on the
   card at the shapes its path gives it, inputs from a seed:
   - merge (csrc/merge.cu): F=5, 256 x 512, scale 2, radius 1, residual
     bound 1, k_max 1 (the RGB slice); rtol and atol 1e-5;
   - tile warp (csrc/tile_warp.cu): 4 frames x 4 CFA planes of 128 x 256,
     T=16; separable map with shifts in +-20 (the +-16 clip acts), block
     map with shifts in +-5; bit-exact;
   - tile windows (csrc/tile_gather.cu): 4 x 128 x 256, T=16, pad 4;
     bit-exact;
   - RAW merge (csrc/merge_raw.cu): F=5, 128 x 256 half-res, the RAW
     slice's 21 taps; rtol and atol 1e-5.
4. Slices on the card, each driven with the launch counts set to 0 just
   before and read just after: handheld_superres on a synthetic
   5 x 256 x 512 x 3 RGB burst (merge and tile-warp kernels), and
   handheld_superres_raw on that burst mosaicked to 5 x 256 x 512 under
   config.RAW_PORT_DEFAULT (tile-warp and RAW merge kernels) and under
   its windows-branch variant align.fast_extract=False (window kernel
   too). Each output must have its shape, be finite and in [0, 1], agree
   (PSNR >= 60 dB) with the same run with every kernel swapped for its
   plain version, and a small burst on the card must agree with the
   port on the CPU.
5. Timing with CUDA events after warm-up, each burst distinct (scaled by
   1 - 1e-5 i): ms per burst and output MP/s of each slice; ms per call
   of each kernel beside its plain version, and the kernel's device time
   from the profiler.
6. Where the time goes: one burst of each slice under torch.profiler:
   host and device ms of each pipeline stage (the mfsr.* ranges of
   models/handheld.py, with each kernel's own profiler row added to its
   stage, and the CUDA-event time around its launches beside it), and
   the card's busy share.

The last lines are a JSON line of the kernels, the card line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
EXACT = dict(rtol=0.0, atol=0.0)  # the copies move values, they compute nothing
PSNR_MIN = 60.0
PKG = "multi_frame_super_resolution_tpu_torch"
KERNELS = {  # name -> (source, the TPU kernel or JAX function it replaces)
    "merge_fast": (f"{PKG}/csrc/merge.cu", "multi_frame_super_resolution_tpu/pallas_ops/merge.py:132"),
    "tile_warp": (f"{PKG}/csrc/tile_warp.cu", "multi_frame_super_resolution_tpu/pallas_ops/tile_warp.py:58"),
    "tile_gather": (f"{PKG}/csrc/tile_gather.cu", "multi_frame_super_resolution_tpu/pallas_ops/tile_gather.py:52"),
    "merge_raw": (f"{PKG}/csrc/merge_raw.cu", "multi_frame_super_resolution_tpu/models/fast_merge.py:301"),
}
# the profiler's names of the kernels' __global__ functions
KERNEL_SYMBOLS = {
    "merge_fast": "merge_fast_kernel", "tile_warp": "tile_warp_kernel",
    "tile_gather": "tile_gather_kernel", "merge_raw": "merge_raw_kernel",
}


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


def compare(label: str, got, want, tol: dict) -> float:
    """Print max abs and max rel error of ``got`` against ``want`` (tuples
    of tensors) beside the tolerance, raise outside it; return max abs."""
    worst = 0.0
    for i, (g, w_) in enumerate(zip(got, want)):
        diff = (g.double() - w_.double()).abs()
        abs_err = diff.max().item()
        rel_err = (diff / w_.double().abs().clamp_min(1e-6)).max().item()
        print(f"kernel check {label}[{i}]: max abs {abs_err:.3e}, max rel {rel_err:.3e} "
              f"(tolerance rtol {tol['rtol']}, atol {tol['atol']})")
        torch.testing.assert_close(g, w_, **tol)
        worst = max(worst, abs_err)
    return worst


def check_output(label: str, out: torch.Tensor, shape: tuple) -> None:
    if tuple(out.shape) != shape:
        raise RuntimeError(f"{label}: output shape {tuple(out.shape)}, expected {shape}")
    if not bool(torch.isfinite(out).all()) or out.min() < 0.0 or out.max() > 1.0:
        raise RuntimeError(f"{label}: output not finite or outside [0, 1]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from multi_frame_super_resolution_tpu_torch.config import (
        PORT_DEFAULT,
        RAW_PORT_DEFAULT,
        AlignConfig,
    )
    from multi_frame_super_resolution_tpu_torch.data import (
        mosaic_rggb,
        synthetic_raw_burst,
        synthetic_rgb_burst,
    )
    from multi_frame_super_resolution_tpu_torch.kernels import LAUNCHES
    from multi_frame_super_resolution_tpu_torch.kernels import merge as kmerge
    from multi_frame_super_resolution_tpu_torch.kernels import merge_raw as kmerge_raw
    from multi_frame_super_resolution_tpu_torch.kernels import tile_gather as ktile_gather
    from multi_frame_super_resolution_tpu_torch.kernels import tile_warp as ktile_warp
    from multi_frame_super_resolution_tpu_torch.kernels.build import build_all
    from multi_frame_super_resolution_tpu_torch.models import fast_merge, handheld
    from multi_frame_super_resolution_tpu_torch.ops import warp_fast
    from multi_frame_super_resolution_tpu_torch.registration import align, tiles

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}  (torch {torch.__version__}, CUDA {torch.version.cuda})")

    # 2. build, all four sources at once
    modules = (kmerge, ktile_warp, ktile_gather, kmerge_raw)
    t0 = time.perf_counter()
    libs = build_all(m.library for m in modules)
    print(f"build: {', '.join(m.SOURCE for m in modules)} in "
          f"{time.perf_counter() - t0:.2f} s (set-up, one nvcc each, in parallel)")
    for lib in libs:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")

    # plain versions with the wrappers' signatures
    def plain_tile_warp(imgs, shifts, t, bound=16):
        return warp_fast.tile_warp_matmul(imgs, shifts, t, bound)

    def plain_tile_gather(imgs, shifts, t, pad):
        return tiles.extract_search_windows(imgs, t, pad, shifts)

    # 3. each kernel against its plain version at its path's shapes
    rng = np.random.default_rng(0)
    merge_args = (SCALE, 1, 1.0, 1.0)
    rgb_ins = [torch.from_numpy(x).to(dev) for x in (
        rng.random((F, H, W, 3)).astype(np.float32),
        (rng.random((F, H, W, 2)) * 2.0 - 1.0).astype(np.float32),
        rng.random((F, H, W, 3)).astype(np.float32),
        np.concatenate([0.5 + rng.random((H, W, 2)), 0.1 * (0.5 + rng.random((H, W, 1)))], -1).astype(np.float32),
    )]
    hh, hw = H // 2, W // 2
    nty, ntx = hh // 16, hw // 16
    planes4 = torch.from_numpy(rng.random((F - 1, 4, hh, hw)).astype(np.float32)).to(dev)
    sep_shifts = torch.from_numpy(rng.integers(-20, 21, (F - 1, nty, ntx, 2)).astype(np.int32)).to(dev)
    blk_shifts = torch.from_numpy(rng.integers(-5, 6, (F - 1, nty, ntx, 2)).astype(np.int32)).to(dev)
    gray4 = planes4[:, 0].contiguous()
    win_shifts = torch.from_numpy(rng.integers(-4, 5, (F - 1, nty, ntx, 2)).astype(np.int32)).to(dev)
    omega = 0.5 + rng.random((hh, hw, 3))
    omega[..., 2] *= 0.1
    raw_ins = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
        rng.random((F, 2, 2, hh, hw)), (rng.random((F, hh, hw, 2)) - 0.5) * 4.0,
        rng.random((F, hh, hw, 3)), omega, omega,
    )]
    cfa = RAW_PORT_DEFAULT.cfa_pattern
    raw_args = (cfa, SCALE, 1, 1.0, 1.0, RAW_PORT_DEFAULT.merge.prune_exp)

    calls = {  # name -> [(label, kernel call, plain call, tolerance)]
        "merge_fast": [("merge", lambda: kmerge.merge_fast(*rgb_ins, *merge_args),
                        lambda: fast_merge.merge_burst_fast(*rgb_ins, *merge_args), KERNEL_TOL)],
        "tile_warp": [
            ("tile_warp separable", lambda: (ktile_warp.tile_warp(planes4, sep_shifts, 16),),
             lambda: (plain_tile_warp(planes4, sep_shifts, 16),), EXACT),
            ("tile_warp block", lambda: (ktile_warp.tile_warp_block(planes4, blk_shifts, 16),),
             lambda: (warp_fast.tile_warp_block(planes4, blk_shifts, 16),), EXACT),
        ],
        "tile_gather": [("tile_gather", lambda: (ktile_gather.tile_gather(gray4, win_shifts, 16, 4),),
                         lambda: (plain_tile_gather(gray4, win_shifts, 16, 4),), EXACT)],
        "merge_raw": [("merge_raw", lambda: kmerge_raw.merge_raw(*raw_ins, *raw_args),
                       lambda: fast_merge.merge_burst_raw_planes(*raw_ins, *raw_args), KERNEL_TOL)],
    }
    max_abs_err = {}
    for name, checks in calls.items():
        max_abs_err[name] = 0.0
        for label, kernel_call, plain_call, tol in checks:
            got = kernel_call()
            torch.cuda.synchronize()
            max_abs_err[name] = max(max_abs_err[name], compare(label, got, plain_call(), tol))

    # 4. the slices end to end on the card
    @contextlib.contextmanager
    def plain_kernels():
        with mock.patch.object(handheld, "merge_fast", fast_merge.merge_burst_fast), \
                mock.patch.object(handheld, "tile_warp", plain_tile_warp), \
                mock.patch.object(handheld, "merge_raw", fast_merge.merge_burst_raw_planes), \
                mock.patch.object(align, "tile_gather", plain_tile_gather):
            yield

    def drive(fn, burst, cfg, expect):
        """Run one path with the counts at 0 just before, read just after."""
        LAUNCHES.clear()
        out = fn(burst, cfg)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        missing = [k for k in expect if launches.get(k, 0) < 1]
        if missing:
            raise RuntimeError(f"the path did not launch {missing}: {launches}")
        return out, launches

    def check_slice(label, fn, burst, cfg, expect, small_burst):
        out, launches = drive(fn, burst, cfg, expect)
        check_output(label, out, (SCALE * burst.shape[1], SCALE * burst.shape[2], 3))
        with plain_kernels():
            LAUNCHES.clear()
            out_plain = fn(burst, cfg)
            if LAUNCHES:
                raise RuntimeError(f"the plain run launched kernels: {dict(LAUNCHES)}")
        p_plain = psnr(out, out_plain)
        p_cpu = psnr(fn(small_burst.to(dev), cfg).cpu(), fn(small_burst, cfg))
        print(f"slice {label}: {tuple(burst.shape)} -> {tuple(out.shape)}, launches {launches}, "
              f"PSNR vs plain kernels {p_plain:.2f} dB, small burst card vs CPU {p_cpu:.2f} dB "
              f"(limit {PSNR_MIN} dB)")
        if p_plain < PSNR_MIN or p_cpu < PSNR_MIN:
            raise RuntimeError(f"slice {label} disagrees with its reference")
        return launches

    rgb_np, _ = synthetic_rgb_burst(np.random.default_rng(0), F, H, W, 3.0)
    rgb_burst = torch.from_numpy(rgb_np).to(dev)
    rgb_small = torch.from_numpy(synthetic_rgb_burst(np.random.default_rng(1), 4, 64, 128, 2.5)[0])
    rgb_launches = check_slice("rgb", handheld.handheld_superres, rgb_burst, PORT_DEFAULT,
                               ("merge_fast", "tile_warp"), rgb_small)

    raw_burst = torch.from_numpy(np.stack([mosaic_rggb(f, cfa) for f in rgb_np])).to(dev)
    raw_small = torch.from_numpy(synthetic_raw_burst(np.random.default_rng(1), 4, 128, 256, 2.5)[0])
    raw_windows_cfg = dataclasses.replace(RAW_PORT_DEFAULT, align=AlignConfig(
        tile_size=16, search_radius=4, levels=2, fast_extract=False))
    stats = []
    noise_stat = handheld.temporal_noise_stat

    def recording_stat(gray, residual):
        stat = noise_stat(gray, residual)
        stats.append(float(stat))
        return stat

    with mock.patch.object(handheld, "temporal_noise_stat", recording_stat):
        raw_launches = check_slice("raw", handheld.handheld_superres_raw, raw_burst,
                                   RAW_PORT_DEFAULT, ("tile_warp", "merge_raw"), raw_small)
    print(f"raw restore gate: temporal noise statistic {stats[0]:.6f} "
          f"(gate {RAW_PORT_DEFAULT.restore_gate_lo}-{RAW_PORT_DEFAULT.restore_gate_hi})")
    win_launches = check_slice("raw windows", handheld.handheld_superres_raw, raw_burst,
                               raw_windows_cfg, ("tile_warp", "merge_raw", "tile_gather"), raw_small)

    # 5. timing: kernels beside their plain versions, then the slices
    kernel_ms, plain_ms = {}, {}
    for name, checks in calls.items():
        _, kernel_call, plain_call, _ = checks[0]
        k1 = time_cuda(kernel_call, iters=50, warmup=5)
        p = time_cuda(plain_call, iters=5, warmup=2)
        k2 = time_cuda(kernel_call, iters=50, warmup=5)
        kernel_ms[name], plain_ms[name] = k1, p
        print(f"kernel {name} ({checks[0][0]}): kernel {k1:.4f} / {k2:.4f} ms per call, "
              f"{kernel_device_ms(kernel_call, KERNEL_SYMBOLS[name]):.4f} ms device time "
              f"(profiler); plain {p:.4f} ms per call  [{card}]")

    def time_slice(label, fn, burst, cfg):
        bursts = [burst * (1.0 - 1e-5 * i) for i in range(13)]
        times = []
        for i, b in enumerate(bursts):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t_host = time.perf_counter()
            start.record()
            fn(b, cfg)
            end.record()
            end.synchronize()
            if i >= 3:  # the first three are warm-up
                times.append((start.elapsed_time(end), (time.perf_counter() - t_host) * 1e3))
        ms = statistics.median(t[0] for t in times)
        host_ms = statistics.median(t[1] for t in times)
        mp_s = SCALE * burst.shape[1] * SCALE * burst.shape[2] / (ms * 1e-3) / 1e6
        print(f"slice timing {label}: median {ms:.3f} ms/burst (host clock {host_ms:.3f} ms) over "
              f"{len(times)} bursts, {mp_s:.2f} output MP/s; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB  [{card}]")
        return ms

    rgb_ms = time_slice("rgb", handheld.handheld_superres, rgb_burst, PORT_DEFAULT)
    raw_ms = time_slice("raw", handheld.handheld_superres_raw, raw_burst, RAW_PORT_DEFAULT)
    win_ms = time_slice("raw windows", handheld.handheld_superres_raw, raw_burst, raw_windows_cfg)

    # 6. where the time goes
    for label, fn, burst, cfg, ms in (
        ("rgb", handheld.handheld_superres, rgb_burst, PORT_DEFAULT, rgb_ms),
        ("raw", handheld.handheld_superres_raw, raw_burst, RAW_PORT_DEFAULT, raw_ms),
        ("raw windows", handheld.handheld_superres_raw, raw_burst, raw_windows_cfg, win_ms),
    ):
        profile_stages(label, fn, burst, cfg, ms, card, handheld, align)

    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": KERNELS[name][0],
        "replaces": KERNELS[name][1],
        "launches": launches.get(name, 0),
        "max_abs_err": max_abs_err[name],
        "ms": kernel_ms[name],
        "plain_ms": plain_ms[name],
    } for name, launches in (
        ("merge_fast", rgb_launches), ("tile_warp", raw_launches),
        ("tile_gather", win_launches), ("merge_raw", raw_launches),
    )]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


def kernel_device_ms(call, symbol: str, iters: int = 20) -> float:
    """Mean device time of the kernel ``symbol`` over ``iters`` calls under
    torch.profiler: the kernel alone, without the host's launch cost that
    a loop timed with events includes when the wrapper is slower than the
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if symbol in e.key]
    if not rows:
        raise RuntimeError(f"the profiler saw no {symbol}")
    return sum(e.self_device_time_total for e in rows) / sum(e.count for e in rows) / 1e3


def profile_stages(label, fn, burst, cfg, burst_ms, card, handheld, align) -> None:
    """Host and device ms of each pipeline stage over one profiled burst,
    each kernel's CUDA-event time in that burst (the events bracket the
    wrapper's launch), the profiler's own rows for the kernels, and the
    share of an unprofiled burst (``burst_ms``) the card is busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    events = []

    def timed(name, wrapper):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = wrapper(*args, **kwargs)
            end.record()
            events.append((name, start, end))
            return out
        return call

    patches = [
        mock.patch.object(handheld, "merge_fast", timed("merge_fast", handheld.merge_fast)),
        mock.patch.object(handheld, "tile_warp", timed("tile_warp", handheld.tile_warp)),
        mock.patch.object(handheld, "merge_raw", timed("merge_raw", handheld.merge_raw)),
        mock.patch.object(align, "tile_gather", timed("tile_gather", align.tile_gather)),
    ]
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(burst, cfg)
            torch.cuda.synchronize()
    event_ms = {}
    for name, start, end in events:
        event_ms[name] = event_ms.get(name, 0.0) + start.elapsed_time(end)
    stage_of = {"merge_fast": "mfsr.merge", "merge_raw": "mfsr.merge",
                "tile_warp": "mfsr.tile_warp", "tile_gather": "mfsr.align"}

    stages, kernels_us, launches, kernel_rows = {}, 0.0, 0, {}
    for evt in prof.key_averages():
        if evt.key.startswith("mfsr."):
            # the host-side range carries the device time of its kernels
            if evt.cpu_time_total > stages.get(evt.key, (0.0, 0.0))[0]:
                stages[evt.key] = (evt.cpu_time_total, evt.device_time_total)
        elif evt.device_type == DeviceType.CUDA and not evt.is_user_annotation:
            kernels_us += evt.self_device_time_total  # kernels and copies
            launches += evt.count
            for name, symbol in KERNEL_SYMBOLS.items():
                if symbol in evt.key:
                    kernel_rows[name] = (evt.count, evt.self_device_time_total)
    # the ctypes launches run under no ATen op, so the ranges' device time
    # leaves the kernels out; their own profiler rows are added to their
    # stage here, and the events around each launch are shown beside
    for name, (host_us, dev_us) in sorted(stages.items(), key=lambda kv: -kv[1][0]):
        extra = ""
        for k in event_ms:
            if stage_of[k] == name:
                count, k_us = kernel_rows.get(k, (0, 0.0))
                dev_us += k_us
                extra += (f"; kernel {k}: {count} launches, {k_us / 1e3:.4f} ms device time "
                          f"(profiler row), {event_ms[k]:.4f} ms between CUDA events around them")
        print(f"stage {label} {name}: host {host_us / 1e3:.3f} ms, device {dev_us / 1e3:.3f} ms{extra}")
    print(f"profile {label}: {launches} device ops, {kernels_us / 1e3:.3f} ms device time per burst; "
          f"card busy {100.0 * kernels_us / 1e3 / burst_ms:.1f}% of {burst_ms:.3f} ms/burst  [{card}]")


if __name__ == "__main__":
    sys.exit(main())
