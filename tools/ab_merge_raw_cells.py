"""In-call A/B of sources of the port's RAW merge kernel
(multi_frame_super_resolution_tpu_torch/csrc/merge_raw.cu): the per-cell
plugin form (form 3, RAW_CERT's merge, every knob off) timed from each
source in one process on one card, so that the sources share the card's
clock and power state.

Each source is built with kernels/build.py's nvcc flags, all at once,
and loaded with ctypes. A source named with --no-flags has the launcher
from before the merge knobs (no flags argument, a two-column tap table).
The inputs are random, from a seed: chip_smoke.py's RAW merge shapes,
S=2 with 5 frames (RAW_BENCH at 5 x 256 x 512) and S=4 with 9 frames and
k_max 4 (RAW_SCALE4's merge). Each source runs 200 launches a round over
6 rounds, the sources in turn, the order reversed every other round.

Prints per source its build seconds, its registers and spills (ptxas -v)
for the S=2 instantiation, and per shape its median and least ms a launch
and the largest difference of its outputs from the first source's; then
the card's name and power limit.

Run on the card from the root of the repo:
    python tools/ab_merge_raw_cells.py NAME=PATH.cu [NAME=PATH.cu ...] [--no-flags NAME,...]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from multi_frame_super_resolution_tpu_torch.config import RAW_PORT_DEFAULT, RGB_DEFAULT  # noqa: E402
from multi_frame_super_resolution_tpu_torch.kernels.build import NVCC_FLAGS, _nvcc  # noqa: E402
from multi_frame_super_resolution_tpu_torch.kernels.merge_raw import tap_table  # noqa: E402
from multi_frame_super_resolution_tpu_torch.models.fast_merge import _active_taps  # noqa: E402

BUILD = Path(__file__).resolve().parents[1] / "build" / "ab_merge_raw_cells"
FORM_CELLS4 = 3  # csrc/merge_raw.cu's form number of the per-cell plugin moments


def build(sources: dict) -> dict:
    """Build every source at once; return name -> (library path, nvcc
    log, seconds from the start to its end)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out = {}

    def run(name, src):
        lib = BUILD / f"lib{name}.so"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), src], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
        out[name] = (lib, proc.stdout + proc.stderr, time.perf_counter() - t0)

    threads = [threading.Thread(target=run, args=item) for item in sources.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if len(out) != len(sources):
        raise SystemExit("a build failed")
    return out


def ptxas_s2(log: str) -> str:
    """The ptxas -v lines of the S=2, 4-slot cells kernel with every knob
    off (template arguments 2, 4 then false ones, or 2, 4 alone)."""
    lines = log.splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry" in line and "merge_raw_cells_kernel" in line and (
            "ILi2ELi4ELb0ELb0E" in line and "ELb1E" not in line or "ILi2ELi4EEEv" in line
        ):
            # the next lines: "Function properties", the stack and spills, the registers
            return " | ".join(x.split(":", 1)[-1].strip() for x in lines[k + 2:k + 4])
    return "not found"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", help="NAME=PATH.cu")
    ap.add_argument("--no-flags", default="", help="comma-separated names whose launcher takes no flags")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sources = dict(s.split("=", 1) for s in args.sources)
    no_flags = set(filter(None, args.no_flags.split(",")))
    built = build(sources)
    fns = {}
    for name, (lib_path, log, secs) in built.items():
        print(f"{name}: built in {secs:.1f} s; S=2 cells kernel: {ptxas_s2(log)}")
        fn = ctypes.CDLL(str(lib_path)).mfsr_merge_raw
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
                       + ([] if name in no_flags else [ctypes.c_int]) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    hh, hw = 128, 256
    omega = 0.5 + rng.random((hh, hw, 3))
    omega[..., 2] *= 0.1

    def inputs(frames, rb_scale):
        return [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
            rng.random((frames, 2, 2, hh, hw)), (rng.random((frames, hh, hw, 2)) - 0.5) * 4.0,
            rng.random((frames, hh, hw, 3)), omega, omega * rb_scale)]

    cfa = tuple(tuple(int(c) for c in row) for row in RAW_PORT_DEFAULT.cfa_pattern)
    cases = [("S=2, F=5", inputs(5, 1.0), 2, 1.0, RAW_PORT_DEFAULT.merge.prune_exp),
             ("S=4, F=9", inputs(9, 0.5), 4, 4.0, RGB_DEFAULT.merge.prune_exp)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    names = list(sources)
    for label, ins, s, k_max, prune in cases:
        taps = _active_taps(2, 1.0, s, k_max, prune)
        table3 = tap_table(tuple(taps), cfa)
        rows = table3[8:].reshape(-1, 3)[:, :2]
        table2 = np.ascontiguousarray(np.concatenate([table3[:8], rows.ravel()]).astype(np.int32))
        frames = ins[0].shape[0]
        outs = {n: torch.empty((4, 2 * s, 2 * s, 3, hh, hw), device=dev) for n in names}

        def call(name):
            head = [t.data_ptr() for t in ins] + [outs[name].data_ptr(), frames, hh, hw, s, FORM_CELLS4, 1.0]
            if name in no_flags:
                err = fns[name](*head, table2.ctypes.data, len(taps), stream)
            else:
                err = fns[name](*head, table3.ctypes.data, len(taps), 0, stream)
            if err:
                raise SystemExit(f"{name}: launch failed ({err})")

        for n in names:
            call(n)
        torch.cuda.synchronize()
        times = {n: [] for n in names}
        for rnd in range(6):
            for n in names if rnd % 2 == 0 else names[::-1]:
                for _ in range(20):
                    call(n)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(200):
                    call(n)
                end.record()
                end.synchronize()
                times[n].append(start.elapsed_time(end) / 200)
        for n in names:
            diff = (outs[n] - outs[names[0]]).abs().max().item()
            print(f"{label}, {len(taps)} taps: {n} median {np.median(times[n]):.5f} ms, least {min(times[n]):.5f} ms, "
                  f"max |diff| from {names[0]} {diff:.3g}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
