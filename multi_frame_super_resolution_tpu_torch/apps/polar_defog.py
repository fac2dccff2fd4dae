"""Polarization-defog CLI (counterpart of apps/polar_defog.py):

    python -m multi_frame_super_resolution_tpu_torch.apps.polar_defog debug inputType beta [--device DEV]

  * debug: 0 | 1 (1 => a single frame, intermediates dumped to
    polar_defog_debug.npz)
  * inputType: 1 => the 16-bit TIFF pair ImageWorst_tiff16.tiff /
    ImageBest_tiff16.tiff (gray files repeated into three channels);
    2 => degree0/45/90.tiff through the Stokes synthesis; 3 => the
    synthetic fog demo (300 x 400; not in the reference). The TIFFs are
    read from the working directory by ``data.imread_u16``.
  * beta: polarization scale (1.55 for type 1, 10 for type 2)

Runs on cuda:0 unless ``--device`` (``main(device=...)``) names another
device, such as ``cpu``; with no card and no such request it raises
rather than run on the CPU. Without debug: 32
warm-up and 256 timed frames, each dispatched alone and fenced by a
scalar readback (the reference protocol), with each frame's input
scaled by 1 + 1e-7 i; then, labeled, the device time per frame over 256
frames launched back to back between CUDA events with no readback inside
(not the reference protocol; on a card only). Writes R_gpu.png.
"""

from __future__ import annotations

import sys
import time


def _load_inputs(input_type: int, device):
    """(Iper, Ipar), each (H, W, 3) float32 on ``device``, of an inputType."""
    import numpy as np
    import torch

    from multi_frame_super_resolution_tpu_torch.data import imread_u16, synthetic_polar_pair

    def read(path):
        return torch.from_numpy(imread_u16(path)).to(device)

    if input_type == 1:
        iper, ipar = read("ImageWorst_tiff16.tiff"), read("ImageBest_tiff16.tiff")
        if iper.ndim == 2:
            iper, ipar = (x[..., None].expand(*x.shape, 3).contiguous() for x in (iper, ipar))
        return iper, ipar
    if input_type == 2:
        from multi_frame_super_resolution_tpu_torch.models.defog import stokes_synthesis

        return stokes_synthesis(read("degree0.tiff"), read("degree45.tiff"), read("degree90.tiff"))
    if input_type == 3:
        return tuple(torch.from_numpy(x).to(device) for x in synthetic_polar_pair(np.random.default_rng(0)))
    raise ValueError("inputType must be 1, 2 or 3")


def time_frames(frame, warmup: int = 32, frames: int = 256):
    """Time ``frame(scale)``, one defog frame of the input scaled by
    ``scale`` that returns R. First the reference protocol: ``warmup``
    then ``frames`` frames, each dispatched alone and fenced by a scalar
    readback of R, frame i's input scaled by 1 - 1e-7 i (warm-up) or
    1 + 1e-7 i (timed); host clock. Then, when R lies on a card, the
    device time of the timed frames launched back to back between CUDA
    events with no readback inside (not the reference protocol; what a
    pipelined caller sees). Returns (ms per frame, device ms per frame or
    None without a card)."""
    import torch

    for i in range(warmup):
        float(frame(1.0 - 1e-7 * i).sum())
    t0 = time.perf_counter()
    for i in range(frames):
        r = frame(1.0 + 1e-7 * i)
        float(r.sum())
    ms = (time.perf_counter() - t0) * 1e3 / frames
    if not r.is_cuda:
        return ms, None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(frames):
        frame(1.0 + 1e-7 * i)
    end.record()
    end.synchronize()
    return ms, start.elapsed_time(end) / frames


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--device" in argv[:-1]:
        at = argv.index("--device")
        device = argv[at + 1]
        del argv[at : at + 2]
    if len(argv) != 3:
        print("polar_defog debug inputType beta [--device DEV]")
        print("\tdebug: 0 or 1")
        print("\tinputType: 1, 2 or 3 (3: synthetic demo)")
        print("\tbeta: 1.55 for 1 and 10 for 2, need to adjust")
        print("\tDEV: the torch device, cuda:0 by default (cpu: the plain versions)")
        return -1
    debug = bool(int(argv[0]))
    input_type = int(argv[1])
    beta = float(argv[2])
    if input_type not in (1, 2, 3):
        raise ValueError("inputType must be 1, 2 or 3")

    import numpy as np

    from multi_frame_super_resolution_tpu_torch import resolve_device
    from multi_frame_super_resolution_tpu_torch.config import PolarDefogConfig
    from multi_frame_super_resolution_tpu_torch.data import imwrite
    from multi_frame_super_resolution_tpu_torch.models.defog import polar_defog

    cfg = PolarDefogConfig(beta=beta)
    dev = resolve_device(device, "polar_defog", "--device cpu (main(device='cpu'))")
    iper, ipar = _load_inputs(input_type, dev)

    def fn(scale: float):
        return polar_defog(iper * scale, ipar, cfg, return_intermediates=True)

    if not debug:
        real_num = 256
        ms, dev_ms = time_frames(lambda scale: fn(scale)[0], warmup=32, frames=real_num)
        print(f"{ms * real_num / 1e3} sec ({real_num} frames, per-frame dispatch — reference protocol)")
        print(f"{1e3 / ms} FPS")
        if dev_ms is not None:
            print(f"{dev_ms * real_num / 1e3} sec ({real_num} frames back to back between CUDA events — "
                  f"device time, not the reference protocol)")
            print(f"{1e3 / dev_ms} FPS (back to back, device time)")
        else:
            print("back-to-back device time: not measured (no CUDA device)")
    r, a, t = fn(1.0)

    out = r.cpu().numpy()
    imwrite("R_gpu.png", out)
    if debug:
        np.savez("polar_defog_debug.npz", A=a.cpu().numpy(), t=t.cpu().numpy(), R=out)
        print("A minmax:", float(a.min()), float(a.max()))
        print("t minmax:", float(t.min()), float(t.max()))
        print("R minmax:", float(r.min()), float(r.max()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
