"""Multi-frame SR CLI (counterpart of apps/multi_frame_sr.py), the
reference app's surface and protocol (multi_frame_sr.cpp:122-210):

    python -m multi_frame_super_resolution_tpu_torch.apps.multi_frame_sr [optFlowName inputName iterations] [--device DEV]

  * optFlowName: farneback | tvl1 | brox | pyrlk
  * inputName:   city | car | iso (read by data.load_burst: the data root
    is MFSR_DATA_DIR, else the reference checkout; car's frames are JPEG)
  * iterations:  BTV-L1 iterations (default 10)

With no arguments: farneback city 10. Runs ``MFSR_SR_CYCLES`` cycles (10
by default) of btvl1_video over the whole burst, cycle i's burst scaled
by 1 + 1e-7 i and each cycle fenced by a scalar readback, and times the
last half (the first half is warm-up); prints seconds and FPS, and
writes ``{input}_{optflow}_sr_result.png`` and the Laplacian-sharpened
``..._sr2_result.png`` of the last frame to the working directory.

Runs on cuda:0 unless ``--device`` (``main(device=...)``) names another
device, such as ``cpu``; with no card and no such request it raises.
"""

from __future__ import annotations

import os
import sys
import time


def time_cycles(cycle, num_times: int = 10):
    """The reference protocol: ``num_times`` cycles of ``cycle(scale)``, one
    burst's stream of output frames, cycle i's input scaled by
    1 + 1e-7 i and fenced by a scalar readback; the last half timed on the
    host clock, the first half warm-up (multi_frame_sr.cpp:149, 166).
    Returns (seconds over the timed cycles, timed cycles, last output)."""
    real_times = min(max(num_times // 2, 1), num_times - 1)
    results, t_start = None, None
    for i in range(num_times):
        if i == num_times - real_times:
            t_start = time.perf_counter()
        results = cycle(1.0 + 1e-7 * i)
        float(results.sum())
    return time.perf_counter() - t_start, real_times, results


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv[:-1]:
        at = argv.index("--device")
        device = argv[at + 1]
        del argv[at : at + 2]
    if len(argv) == 0:
        opt_flow, input_name, iterations = "farneback", "city", 10
    elif len(argv) == 3:
        opt_flow, input_name = argv[0], argv[1]
        iterations = max(int(argv[2]), 1)
    else:
        print("multi_frame_sr optFlowName inputName iterations [--device DEV]")
        print("\toptFlowName: farneback, tvl1, brox, pyrlk")
        print("\tinputName: city, car, iso")
        print("\titerations: integer, 1, 10, etc.")
        print("\tDEV: the torch device, cuda:0 by default")
        return -1

    import torch

    from multi_frame_super_resolution_tpu_torch import data, resolve_device
    from multi_frame_super_resolution_tpu_torch.config import BTVConfig
    from multi_frame_super_resolution_tpu_torch.models.btvl1 import btvl1_video
    from multi_frame_super_resolution_tpu_torch.ops.filters import laplacian_sharpen

    burst_np = data.load_burst(input_name)
    num_images = burst_np.shape[0]
    for i in range(num_images):
        print(f"{input_name}[{i}], {burst_np.shape[2]}x{burst_np.shape[1]}")

    dev = resolve_device(device, "multi_frame_sr", "--device cpu (main(device='cpu'))")
    burst = torch.from_numpy(burst_np).to(dev)
    cfg = BTVConfig(scale=2, iterations=iterations, temporal_radius=1, optical_flow=opt_flow)
    # MFSR_SR_CYCLES shortens the reference protocol's 10 cycles
    num_times = max(int(os.environ.get("MFSR_SR_CYCLES", "10")), 2)
    elapsed, real_times, results = time_cycles(lambda scale: btvl1_video(burst * scale, cfg, device=dev), num_times)
    print(f"{elapsed} sec")
    print(f"{(num_images * real_times) / elapsed} FPS")

    out = results[-1]
    data.imwrite(f"{input_name}_{opt_flow}_sr_result.png", out.cpu().numpy())
    data.imwrite(f"{input_name}_{opt_flow}_sr2_result.png", laplacian_sharpen(out).cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
