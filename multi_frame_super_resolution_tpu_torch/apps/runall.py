"""The benchmark matrix (counterpart of apps/runall.py; the reference's
runall.sh:1-15): the polarization-defog configurations, then BTV-L1 SR at
10 iterations for 4 optical flows x the datasets, one summary line each.

    python -m multi_frame_super_resolution_tpu_torch.apps.runall [--quick] [--device DEV]

  * defog: the synthetic demo input (inputType 3) at beta 1.55 and 10:
    frames each dispatched alone and fenced by a scalar readback (host
    clock), then, labelled, the device time per frame of the same frames
    launched back to back between CUDA events (on a card only);
  * BTV-L1: btvl1_superres of frame 0 at scale 2 on every burst that
    data.load_burst can read (the data root is MFSR_DATA_DIR, else the
    reference checkout; without the native reader the car burst's JPEGs
    cannot be read and are reported as skipped), one call per frame of the burst after a warm-up
    call, each fenced by a scalar readback.

``--quick``: one defog configuration with 8 frames, and farneback on the
city burst with 2 calls. Runs on cuda:0 unless ``--device``
(``main(device=...)``) names another device; with no card and no such
request it raises.
"""

from __future__ import annotations

import sys
import time


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv[:-1]:
        at = argv.index("--device")
        device = argv[at + 1]
        del argv[at : at + 2]
    quick = "--quick" in argv

    import torch

    from multi_frame_super_resolution_tpu_torch import resolve_device
    from multi_frame_super_resolution_tpu_torch.apps.polar_defog import _load_inputs, time_frames
    from multi_frame_super_resolution_tpu_torch.config import BTVConfig, PolarDefogConfig
    from multi_frame_super_resolution_tpu_torch.data import load_burst
    from multi_frame_super_resolution_tpu_torch.models.btvl1 import btvl1_superres
    from multi_frame_super_resolution_tpu_torch.models.defog import polar_defog

    dev = resolve_device(device, "runall", "--device cpu (main(device='cpu'))")
    flows = ["farneback", "tvl1", "pyrlk", "brox"]
    datasets = ["city", "car", "iso"]
    if quick:
        flows, datasets = flows[:1], datasets[:1]

    iper, ipar = _load_inputs(3, dev)
    frames = 8 if quick else 64
    for beta in [1.55] if quick else [1.55, 10.0]:
        cfg = PolarDefogConfig(beta=beta)
        ms, dev_ms = time_frames(lambda scale: polar_defog(iper * scale, ipar, cfg), warmup=1, frames=frames)
        print(f"polar_defog beta={beta}: {ms * frames / 1e3:.3f} sec, {1e3 / ms:.2f} FPS (per-frame dispatch)")
        if dev_ms is None:
            print(f"polar_defog beta={beta}: back-to-back device time not measured (no CUDA device)")
        else:
            print(f"polar_defog beta={beta}: {dev_ms * frames / 1e3:.3f} sec, {1e3 / dev_ms:.2f} FPS "
                  f"(back to back between CUDA events, device time; not the reference protocol)")

    for ds in datasets:
        try:
            burst = torch.from_numpy(load_burst(ds)).to(dev)
        except (OSError, ValueError) as err:
            print(f"multi_frame_sr {ds}: skipped ({err})")
            continue
        n = 2 if quick else burst.shape[0]
        for flow in flows:
            cfg = BTVConfig(scale=2, iterations=10, optical_flow=flow)

            def sr(scale, cfg=cfg):
                return float(btvl1_superres(burst * scale, 0, cfg, device=dev).sum())

            sr(1.0)  # warm-up
            t0 = time.perf_counter()
            for i in range(n):
                sr(1.0 + i * 1e-6)
            dt = time.perf_counter() - t0
            print(f"multi_frame_sr {flow} {ds} 10: {dt:.3f} sec, {n / dt:.2f} FPS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
