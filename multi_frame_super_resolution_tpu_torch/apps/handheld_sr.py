"""Handheld burst-SR CLI (counterpart of apps/handheld_sr.py), the
flagship pipeline over the bundled bursts:

    python -m multi_frame_super_resolution_tpu_torch.apps.handheld_sr [inputName] [scale] [--raw] [--device DEV]

Runs the end-to-end align + robustness + kernel-regression merge,
``HandheldConfig(scale=scale)``, on a named burst (city | car | iso, read
by ``data.load_burst`` under MFSR_DATA_DIR), reports seconds,
FPS and MP/s with the warmup-then-measure protocol (``utils.timing.
measure``; MFSR_BENCH_WARMUP and MFSR_BENCH_ITERS, 2 and 10 by default)
and the amortized per-call time (``measure_amortized``, MFSR_BENCH_K and
MFSR_BENCH_REPS, 8 and 2; MFSR_BENCH_AMORTIZED=0 skips it), and writes
``{input}_handheld_sr.png`` to the working directory. ``--raw`` mosaics
the burst first (RGGB) and runs the Bayer RAW pipeline.

Runs on cuda:0 unless ``--device`` (``main(device=...)``) names another
device, such as ``cpu``; with no card and no such request it raises.
"""

from __future__ import annotations

import os
import sys


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv[:-1]:
        at = argv.index("--device")
        device = argv[at + 1]
        del argv[at : at + 2]
    use_raw = "--raw" in argv
    argv = [a for a in argv if a != "--raw"]
    input_name = argv[0] if argv else "city"
    scale = int(argv[1]) if len(argv) > 1 else 2

    import numpy as np
    import torch

    from multi_frame_super_resolution_tpu_torch import resolve_device
    from multi_frame_super_resolution_tpu_torch.config import HandheldConfig
    from multi_frame_super_resolution_tpu_torch.data import imwrite, load_burst, mosaic_rggb
    from multi_frame_super_resolution_tpu_torch.models.handheld import handheld_superres, handheld_superres_raw
    from multi_frame_super_resolution_tpu_torch.utils.timing import measure, measure_amortized

    burst_np = load_burst(input_name)
    cfg = HandheldConfig(scale=scale)
    dev = resolve_device(device, "handheld_sr", "--device cpu (main(device='cpu'))")

    if use_raw:
        data = torch.from_numpy(np.stack([mosaic_rggb(f) for f in burst_np])).to(dev)
        entry = handheld_superres_raw
    else:
        data = torch.from_numpy(burst_np).to(dev)
        entry = handheld_superres

    def fn(b):
        return entry(b, cfg, device=dev)

    out_px = burst_np.shape[1] * scale * burst_np.shape[2] * scale
    # per-dispatch protocol: perturbed inputs + value-readback fence
    result = measure(
        fn,
        args=(data,),
        warmup=max(int(os.environ.get("MFSR_BENCH_WARMUP", "2")), 1),
        iters=max(int(os.environ.get("MFSR_BENCH_ITERS", "10")), 1),
        name=f"handheld-{input_name}{'-raw' if use_raw else ''}",
        pixels_per_iter=float(out_px),
    )
    if os.environ.get("MFSR_BENCH_AMORTIZED", "1") != "0":
        result.amortized_sec = measure_amortized(
            fn,
            (data,),
            k=max(int(os.environ.get("MFSR_BENCH_K", "8")), 2),
            reps=max(int(os.environ.get("MFSR_BENCH_REPS", "2")), 1),
        )
    print(result)

    imwrite(f"{input_name}_handheld_sr.png", fn(data).cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
