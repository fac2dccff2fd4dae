"""In-call A/B of the main path's three kernels between checkouts of the
port: the certless RAW merge at S=2 (RAW_BENCH's merge), the tile search
at T=16, R=4 in "image" mode (the RAW path's fine level) and the RGB
merge's phase layout at e^-1.5 (RGB_DEFAULT's merge), at chip_smoke.py's
phase-3 shapes and seeds.

Each checkout runs in a process of its own (the package is imported from
that checkout's root and builds its kernels into its own build/), in the
order given and then reversed (A B B A for two), that sequence
``--repeat N`` times (default 1), so that the checkouts share the card's
clock and power state. A run times each kernel by the profiler's device
time over 200 calls, 3 rounds, and prints one JSON line; the summary
gives each checkout's median, least and most round; then the card's name
and power limit.

Run on the card from the root of the repo, e.g. with the parent commit
unpacked into build/parent:
    python tools/ab_main_kernels.py --repeat 5 parent=build/parent change=.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from multi_frame_super_resolution_tpu_torch.config import RAW_PORT_DEFAULT
from multi_frame_super_resolution_tpu_torch.data import synthetic_burst
from multi_frame_super_resolution_tpu_torch.kernels import merge, merge_raw, tile_search
from multi_frame_super_resolution_tpu_torch.kernels.build import build_all

assert merge.__file__.startswith(str(__import__("pathlib").Path(sys.argv[1]).resolve()))
build_all([merge.library, merge_raw.library, tile_search.library])
dev = torch.device("cuda", 0)
F, H, W = 5, 256, 512
hh, hw = H // 2, W // 2
rng = np.random.default_rng(0)
rgb = [torch.from_numpy(x).to(dev) for x in (
    rng.random((F, H, W, 3)).astype(np.float32),
    (rng.random((F, H, W, 2)) * 2.0 - 1.0).astype(np.float32),
    rng.random((F, H, W, 3)).astype(np.float32),
    np.concatenate([0.5 + rng.random((H, W, 2)), 0.1 * (0.5 + rng.random((H, W, 1)))], -1).astype(np.float32),
)]
omega = 0.5 + rng.random((hh, hw, 3))
omega[..., 2] *= 0.1
raw = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
    rng.random((F, 2, 2, hh, hw)), (rng.random((F, hh, hw, 2)) - 0.5) * 4.0,
    rng.random((F, hh, hw, 3)), omega, omega,
)]
burst, offsets = synthetic_burst(rng, F, hh, hw, 3.0)
burst = burst + 0.01 * rng.standard_normal(burst.shape)
grid = (F - 1, -(-hh // 16), -(-hw // 16))
rounded = np.round(-offsets[1:])[:, None, None, :] + rng.integers(-2, 3, grid + (2,))
search = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (burst[0], burst[1:], rounded)]
cfa = RAW_PORT_DEFAULT.cfa_pattern
calls = {
    "merge_raw S=2 (RAW_BENCH)": (
        lambda: merge_raw.merge_raw(*raw, cfa, 2, 1, 1.0, 1.0, RAW_PORT_DEFAULT.merge.prune_exp), "merge_raw_kernel"),
    "tile_search image 4x128x256": (lambda: tile_search.tile_search(*search, 16, 4, 0.0, True, "image"),
                                    "tile_search_kernel"),
    "merge_fast phase layout, e^-1.5": (lambda: merge.merge_fast(*rgb, 2, 1, 1.0, 1.0, phase_output=True,
                                                                 prune_exp=1.5), "merge_fast_kernel"),
}
out = {}
for label, (call, symbol) in calls.items():
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(200):
                call()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and symbol in e.key]
        rounds.append(sum(e.self_device_time_total for e in rows) / 1e3 / sum(e.count for e in rows))
    out[label] = rounds
print(json.dumps(out))
'''


def main(argv) -> int:
    repeat = 1
    if argv[:1] == ["--repeat"]:
        repeat, argv = int(argv[1]), argv[2:]
    roots = [a.split("=", 1) for a in argv]
    order = (roots + roots[::-1]) * repeat
    results = {name: {} for name, _ in roots}
    for name, root in order:
        proc = subprocess.run([sys.executable, "-c", CHILD, str(Path(root).resolve())], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr)
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{name}: " + ", ".join(f"{k} {min(v):.5f} ms" for k, v in run.items()))
        for k, v in run.items():
            results[name].setdefault(k, []).extend(v)
    for k in results[roots[0][0]]:
        print(f"{k}: " + "; ".join(
            f"{name} median {sorted(r[k])[len(r[k]) // 2]:.5f}, least {min(r[k]):.5f}, most {max(r[k]):.5f} ms "
            f"device time a launch ({len(r[k])} rounds)"
            for name, r in results.items()))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
