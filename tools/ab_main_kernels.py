"""In-call A/B of the port's merge and search kernels between checkouts,
at chip_smoke.py's phase-3 shapes and seeds (F=5, 256 x 512 RGB, 128 x
256 half-res RAW). Two groups of calls:

- ``main``: the main path's three kernels, the certless RAW merge at S=2
  (RAW_BENCH's merge), the tile search at T=16, R=4 in "image" mode (the
  RAW path's fine level) and the RGB merge's phase layout at e^-1.5
  (RGB_DEFAULT's merge), each 200 calls a round;
- ``general``: the general forms, the RGB merge at s=5 (phase layout,
  interleaved, order 1, 9 slots, bfloat16), at tap radii 9 and 11 and at
  a tap reach of 35 (s=1, phase layout at e^-6, k_max 1e4, on 5 x 16 x
  32 and 4 x 64 x 128), the RAW merge at S=5 in every form and knob,
  guided, the bfloat16 order 0 on 40 frames, 109 taps and a non-Bayer
  pattern, four templated RAW forms at S=1-2 that share their source,
  and the general tile search at chip_smoke.py's cases (T=12 in "image"
  mode, radius 0 in both modes, radius 30 in "tile" mode, at 4 x 128 x
  256 and 4 x 64 x 128), each ``--calls`` calls a round (default 30);
- ``stream9``: the RAW merge's streamed form (the certless and order-0
  forms past their frame caps: F=40 at S=2 and F=70 at S=4, RAW_BENCH's,
  RAW_ORDER0's and RAW_SCALE4's merges), the RGB merge's 9 slots at s=2
  (RGB_EXACT's merge) and s=4, and its interleaved, order-1 and bfloat16
  forms at s=2, each ``--calls`` calls a round;
- ``bf16nb``: the RAW merge's templated bfloat16 order 0 at S=1-3 (F=5)
  and S=4 (F=9, RAW_SCALE4's merge), the float32 order 0 at S=2 and S=4
  beside it, and the non-Bayer kernel: the certless form, order 0, 9
  slots and the per-cell 4 at S=2 on ((0, 1), (2, 1)), the certless form
  at S=3 on ((1, 1), (0, 2)), and the 9 slots of a Bayer merge at 3,721
  taps (to +-30) on 3 x 64 x 128, each ``--calls`` calls a round;
- ``bf16warp``: the RGB merge's bfloat16 phase layout (form 4) at s=1-4
  (F=5, 256 x 512, e^-1.5; RGB_BF16's merge at s=2), and the tile warp's
  three index maps (separable, block, one-hot at bound 16) on 4 x 4
  planes of 128 x 256 at T=16, each ``--calls`` calls a round.

``--only main`` (the default), ``--only general``, ``--only stream9``,
``--only bf16nb`` or ``--only bf16warp`` picks one group, ``--only all`` the five. Each checkout runs in a process of its own (the
package imported from that checkout's root, its kernels built into its
own build/), in the order given and then reversed (A B B A for two),
that sequence ``--repeat N`` times (default 1), so that the checkouts
share the card's clock and power state. A run times each call by the
profiler's device time of its kernels (those whose names hold the
call's symbol; one launch a call for the main group) over 3 rounds and
prints one JSON line (a round counts only if the profiler recorded every
launch of its calls; one that did not is repeated, up to 3 times, and
the repeats are printed); the summary gives each checkout's median, least
and most round and the first checkout's median over each other's; then
the card's name and power limit.

Run on the card from the root of the repo, with the parent commit
unpacked into build/parent:
    python tools/ab_main_kernels.py --repeat 4 --only all parent=build/parent change=.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
calls_n, only = int(sys.argv[2]), sys.argv[3]
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from multi_frame_super_resolution_tpu_torch.config import RAW_PORT_DEFAULT
from multi_frame_super_resolution_tpu_torch.data import synthetic_burst
from multi_frame_super_resolution_tpu_torch.kernels import merge, merge_raw, tile_search, tile_warp
from multi_frame_super_resolution_tpu_torch.kernels.build import build_all
from multi_frame_super_resolution_tpu_torch.models import fast_merge

assert merge.__file__.startswith(str(__import__("pathlib").Path(sys.argv[1]).resolve()))
build_all([merge.library, merge_raw.library, tile_search.library, tile_warp.library])
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
raw40 = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
    rng.random((40, 2, 2, hh, hw)), (rng.random((40, hh, hw, 2)) - 0.5) * 4.0, rng.random((40, hh, hw, 3)),
)] + raw[3:]
burst, offsets = synthetic_burst(rng, F, hh, hw, 3.0)
burst = burst + 0.01 * rng.standard_normal(burst.shape)
grid = (F - 1, -(-hh // 16), -(-hw // 16))
rounded = np.round(-offsets[1:])[:, None, None, :] + rng.integers(-2, 3, grid + (2,))
search = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (burst[0], burst[1:], rounded)]
cfa = RAW_PORT_DEFAULT.cfa_pattern
prune = 1.5
calls = {}  # label: (call, kernel-name symbol, calls a round, warm-up calls)
if only in ("main", "all"):
    calls.update({
        "merge_raw S=2 (RAW_BENCH)": (
            lambda: merge_raw.merge_raw(*raw, cfa, 2, 1, 1.0, 1.0, RAW_PORT_DEFAULT.merge.prune_exp),
            "merge_raw_kernel", 200, 20),
        "tile_search image 4x128x256": (lambda: tile_search.tile_search(*search, 16, 4, 0.0, True, "image"),
                                        "tile_search_kernel", 200, 20),
        "merge_fast phase layout, e^-1.5": (
            lambda: merge.merge_fast(*rgb, 2, 1, 1.0, 1.0, phase_output=True, prune_exp=prune),
            "merge_fast_kernel", 200, 20),
    })
if only in ("general", "all"):
    phase = dict(phase_output=True, prune_exp=prune)
    phase5 = (5, 1, 1.0, 2.5**2)
    raw5 = (cfa, 5, 1, 1.0, 2.5**2, prune)
    raw2 = (cfa, 2, 1, 1.0, 1.0, prune)
    cert4 = dict(order=1, moment_slots=4, centroid_cert=True)
    guide = fast_merge.green_guide_planes(raw[0], cfa).contiguous()
    rgb_forms = {
        "merge_fast phase layout, e^-1.5, s=5": (phase5, phase),
        "merge_fast interleaved, e^-6, s=5": (phase5, {}),
        "merge_fast order 1, e^-1.5, s=5": (phase5, dict(phase, order=1)),
        "merge_fast 9 slots, e^-1.5, s=5": (phase5, dict(phase, order=1, moment_slots=9)),
        "merge_fast phase layout bf16, e^-1.5, s=5": (phase5, dict(phase, bf16=True)),
        "merge_fast phase layout, e^-6, tap radius 9": ((2, 8, 1.0, 64.0), dict(phase, prune_exp=6.0)),
        "merge_fast phase layout, e^-6, tap radius 11": ((2, 10, 1.0, 64.0), dict(phase, prune_exp=6.0)),
    }
    raw_forms = {
        "merge_raw S=5 certless": (raw, raw5, {}),
        "merge_raw S=5 order 0": (raw, raw5, dict(order=0)),
        "merge_raw S=5 9 slots": (raw, raw5, dict(order=1, moment_slots=9)),
        "merge_raw S=5 cert4 (form 3)": (raw, raw5, cert4),
        "merge_raw S=5 exact_weights": (raw, raw5, dict(order=1, moment_slots=4, exact_weights=True)),
        "merge_raw S=5 exact_weights 9 slots": (raw, raw5, dict(order=1, moment_slots=9, exact_weights=True)),
        "merge_raw S=5 cert block": (raw, raw5, dict(cert4, centroid_block=True)),
        "merge_raw S=5 cert shared": (raw, raw5, dict(cert4, centroid_shared_res=True)),
        "merge_raw S=5 cert prune": (raw, raw5, dict(cert4, centroid_prune=1.0)),
        "merge_raw S=5 cert bf16": (raw, raw5, dict(cert4, centroid_bf16=True)),
        "merge_raw S=5 order 0 bf16": (raw, raw5, dict(order=0, bf16=True)),
        "merge_raw S=5 guided": (raw, raw5, dict(guide=guide)),
        "merge_raw order 0 bf16, F=40, S=2": (raw40, raw2, dict(order=0, bf16=True)),
        "merge_raw 109 taps, S=2": (raw, (cfa, 2, 5, 1.0, 1.0, 40.0), {}),
        "merge_raw cfa ((0, 1), (2, 1)), S=2": (raw, (((0, 1), (2, 1)), 2, 1, 1.0, 1.0, prune), {}),
        # templated forms beside them (their instantiations share the source)
        "templated: merge_raw 9 slots S=2": (raw, raw2, dict(order=1, moment_slots=9)),
        "templated: merge_raw cert4 S=2": (raw, raw2, cert4),
        "templated: merge_raw cert shared S=2": (raw, raw2, dict(cert4, centroid_shared_res=True)),
        "templated: merge_raw order 0 bf16 S=1": (raw, (cfa, 1, 1, 1.0, 0.25, prune), dict(order=0, bf16=True)),
    }
    calls.update({label: (lambda a=a, kw=kw: merge.merge_fast(*rgb, *a, **kw), "merge", calls_n, 3)
                  for label, (a, kw) in rgb_forms.items()})
    # a tap reach of 35 (5,041 taps) at s=1, chip_smoke.py's two shapes
    for f, h, w in ((5, 16, 32), (4, 64, 128)):
        ins = [x[:f, :h, :w].contiguous() for x in rgb[:3]] + [rgb[3][:h, :w].contiguous()]
        calls[f"merge_fast phase layout, e^-6, tap reach 35, s=1, {f} x {h} x {w}"] = (
            lambda ins=ins: merge.merge_fast(*ins, 1, 34, 1.0, 1e4, phase_output=True, prune_exp=6.0),
            "merge", calls_n, 3)
    # the general search at chip_smoke.py's cases: a burst shifted by up to
    # 3 px, predictions within 2 px, a tenth of the tiles at 17-20 px in
    # "image" mode
    def search_case(h, w, outliers, t):
        b, off = synthetic_burst(rng, F, h, w, 3.0)
        b = b + 0.01 * rng.standard_normal(b.shape)
        g = (F - 1, -(-h // t), -(-w // t))
        r = np.round(-off[1:])[:, None, None, :] + rng.integers(-2, 3, g + (2,))
        if outliers:
            miss = rng.random(g) < 0.1
            r[miss] = rng.choice([-1, 1], (miss.sum(), 2)) * rng.integers(17, 21, (miss.sum(), 2))
        return [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (b[0], b[1:], r)]
    for h, w, t, radius, mode in ((hh, hw, 12, 4, "image"), (hh // 2, hw // 2, 12, 4, "image"),
                                  (hh, hw, 16, 0, "tile"), (hh, hw, 16, 0, "image"),
                                  (hh, hw, 16, 30, "tile"), (hh // 2, hw // 2, 16, 30, "tile")):
        ins = search_case(h, w, mode == "image", t)
        calls[f"tile_search_general {mode} 4x{h}x{w} T={t} R={radius}"] = (
            lambda ins=ins, t=t, radius=radius, mode=mode: tile_search.tile_search(*ins, t, radius, 0.0, True, mode),
            "tile_search", calls_n, 3)
    calls.update({label: (lambda i=i, a=a, kw=kw: merge_raw.merge_raw(*i, *a, **kw), "merge", calls_n, 3)
                  for label, (i, a, kw) in raw_forms.items()})
if only in ("stream9", "all"):
    phase = dict(phase_output=True, prune_exp=prune)
    raw2 = (cfa, 2, 1, 1.0, 1.0, prune)
    raw4 = (cfa, 4, 1, 1.0, 4.0, prune)
    nine = dict(phase_output=True, prune_exp=prune, order=1, moment_slots=9)
    # RAW_SCALE4's merge on 70 frames (R/B kernels wider), from a seed of
    # its own so that the other groups' inputs stay as they were
    r70 = np.random.default_rng(70)
    raw70 = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
        r70.random((70, 2, 2, hh, hw)), (r70.random((70, hh, hw, 2)) - 0.5) * 4.0, r70.random((70, hh, hw, 3)),
        omega, omega * 0.5,
    )]
    # one kernel a call, named differently in each checkout: the prefix
    calls.update({label: (lambda i=i, a=a, kw=kw: merge_raw.merge_raw(*i, *a, **kw), "merge_raw", calls_n, 3)
                  for label, (i, a, kw) in {
                      "merge_raw stream F=40, S=2": (raw40, raw2, {}),
                      "merge_raw stream order 0, F=40, S=2": (raw40, raw2, dict(order=0)),
                      "merge_raw stream F=70, S=4": (raw70, raw4, {}),
                      "merge_raw stream order 0, F=70, S=4": (raw70, raw4, dict(order=0)),
                  }.items()})
    calls.update({label: (lambda a=a: merge.merge_fast(*rgb, *a, **nine), "merge_fast", calls_n, 3)
                  for label, a in {"merge_fast 9 slots, s=2": (2, 1, 1.0, 1.0),
                                   "merge_fast 9 slots, s=4": (4, 1, 1.0, 4.0)}.items()})
    # the templated RGB forms beside it (their layouts share its source)
    calls.update({label: (lambda kw=kw: merge.merge_fast(*rgb, 2, 1, 1.0, 1.0, **kw), "merge_fast", calls_n, 3)
                  for label, kw in {"templated: merge_fast interleaved, e^-6, s=2": {},
                                    "templated: merge_fast order 1, e^-1.5, s=2": dict(phase, order=1),
                                    "templated: merge_fast bf16, e^-1.5, s=2": dict(phase, bf16=True)}.items()})
if only in ("bf16nb", "all"):
    # the bfloat16 RAW order 0 at S=1-4 and the non-Bayer kernel, with the
    # float32 order 0 at S=2 and S=4 beside them; RAW_SCALE4's merge (9
    # frames, k_max 4, R/B kernels wider) from a seed of its own, so that
    # the other groups' inputs stay as they were
    r9 = np.random.default_rng(9)
    raw9 = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
        r9.random((9, 2, 2, hh, hw)), (r9.random((9, hh, hw, 2)) - 0.5) * 4.0, r9.random((9, hh, hw, 3)),
        omega, omega * 0.5,
    )]
    # 3,721 taps (to +-30) on 3 frames of 64 x 128: the Bayer 9 slots past any general block
    crop = [raw[0][:3, :, :, :64, :128], raw[1][:3, :64, :128], raw[2][:3, :64, :128], raw[3][:64, :128],
            raw[4][:64, :128]]
    crop = [x.contiguous() for x in crop]
    order0, bf16 = dict(order=0), dict(order=0, bf16=True)
    slots9, cert4 = dict(order=1, moment_slots=9), dict(order=1, moment_slots=4, centroid_cert=True)
    column, row = ((0, 1), (2, 1)), ((1, 1), (0, 2))
    calls.update({label: (lambda i=i, a=a, kw=kw: merge_raw.merge_raw(*i, *a, **kw), "merge_raw", calls_n, 3)
                  for label, (i, a, kw) in {
                      "merge_raw order 0 bf16, S=1": (raw, (cfa, 1, 1, 1.0, 0.25, prune), bf16),
                      "merge_raw order 0 bf16, S=2 (RAW_ORDER0_BF16)": (raw, (cfa, 2, 1, 1.0, 1.0, prune), bf16),
                      "merge_raw order 0 bf16, S=3": (raw, (cfa, 3, 1, 1.0, 2.25, prune), bf16),
                      "merge_raw order 0 bf16, S=4, F=9": (raw9, (cfa, 4, 1, 1.0, 4.0, prune), bf16),
                      "yardstick: merge_raw order 0, S=2 (RAW_ORDER0)": (raw, (cfa, 2, 1, 1.0, 1.0, prune), order0),
                      "yardstick: merge_raw order 0, S=4, F=9": (raw9, (cfa, 4, 1, 1.0, 4.0, prune), order0),
                      "merge_raw nonbayer ((0, 1), (2, 1)), S=2": (raw, (column, 2, 1, 1.0, 1.0, prune), {}),
                      "merge_raw nonbayer order 0, S=2": (raw, (column, 2, 1, 1.0, 1.0, prune), order0),
                      "merge_raw nonbayer 9 slots, S=2": (raw, (column, 2, 1, 1.0, 1.0, prune), slots9),
                      "merge_raw nonbayer cert4, S=2": (raw, (column, 2, 1, 1.0, 1.0, prune), cert4),
                      "merge_raw nonbayer ((1, 1), (0, 2)), S=3": (raw, (row, 3, 1, 1.0, 2.25, prune), {}),
                      "merge_raw nonbayer 3,721 taps 9 slots, S=2, 3 x 64 x 128": (
                          crop, (cfa, 2, 29, 1.0, 1.0, 1e4), slots9),
                  }.items()})

if only in ("bf16warp", "all"):
    # the RGB merge's bfloat16 form at s=1-4, and the warp's three maps on
    # chip_smoke.py's planes, from a seed of their own so that the other
    # groups' inputs stay as they were
    bf16 = dict(phase_output=True, prune_exp=prune, bf16=True)
    calls.update({f"merge_fast bf16, e^-1.5, s={s}": (
        lambda s=s: merge.merge_fast(*rgb, s, 1, 1.0, (s / 2.0) ** 2, **bf16), "merge_fast", calls_n, 3)
        for s in (1, 2, 3, 4)})
    r20 = np.random.default_rng(20)
    planes = torch.from_numpy(r20.random((F - 1, 4, hh, hw)).astype(np.float32)).to(dev)
    grid16 = (F - 1, -(-hh // 16), -(-hw // 16), 2)
    sep = torch.from_numpy(r20.integers(-20, 21, grid16).astype(np.int32)).to(dev)
    blk = torch.from_numpy(r20.integers(-5, 6, grid16).astype(np.int32)).to(dev)
    calls.update({label: (call, "tile_warp", calls_n, 3) for label, call in {
        "tile_warp separable, 4x4x128x256": lambda: tile_warp.tile_warp(planes, sep, 16),
        "tile_warp block, 4x4x128x256": lambda: tile_warp.tile_warp_block(planes, blk, 16),
        "tile_warp onehot, bound 16, 4x4x128x256": lambda: tile_warp.tile_warp(planes, sep, 16, onehot=True),
    }.items()})


def profiled(call, symbol, n):
    """The device time (us) and the launches of the kernels whose names
    hold ``symbol`` over ``n`` calls, as the profiler recorded them."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and symbol in e.key]
    return sum(e.self_device_time_total for e in rows), sum(e.count for e in rows)


out, repeated = {}, {}
for label, (call, symbol, n, warm) in calls.items():
    for _ in range(warm):
        call()
    torch.cuda.synchronize()
    # the kernels a call launches (from the first of up to 4 profiled
    # rounds whose launches are a whole multiple of its n calls), and then
    # rounds that recorded every launch of their n calls: a round that
    # recorded fewer or more is repeated, up to 3 times, else the run fails
    per_call = 0
    for _ in range(4):
        launches = profiled(call, symbol, n)[1]
        if launches and launches % n == 0:
            per_call = launches // n
            break
    if per_call < 1:
        sys.exit(f"{label}: no round of {n} calls recorded a whole number of kernels named like {symbol!r} a call")
    rounds = []
    while len(rounds) < 3:
        for attempt in range(4):
            total, launches = profiled(call, symbol, n)
            if launches == n * per_call:
                break
            repeated[label] = repeated.get(label, 0) + 1
        else:
            sys.exit(f"{label}: {launches} of {n * per_call} launches recorded in 4 tries of a round")
        rounds.append(total / 1e3 / n)
    out[label] = rounds
if repeated:
    print("rounds repeated for launches the profiler missed: " + json.dumps(repeated))
print(json.dumps(out))
'''


def main(argv) -> int:
    repeat, calls, only = 1, 30, "main"
    while argv[:1] in (["--repeat"], ["--calls"], ["--only"]):
        if argv[0] == "--repeat":
            repeat = int(argv[1])
        elif argv[0] == "--calls":
            calls = int(argv[1])
        else:
            only = argv[1]
        argv = argv[2:]
    if only not in ("main", "general", "stream9", "bf16nb", "bf16warp", "all"):
        print(f"--only takes main, general, stream9, bf16nb, bf16warp or all, not {only}")
        return 2
    roots = [a.split("=", 1) for a in argv]
    order = (roots + roots[::-1]) * repeat
    results = {name: {} for name, _ in roots}
    for name, root in order:
        proc = subprocess.run([sys.executable, "-c", CHILD, str(Path(root).resolve()), str(calls), only],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr)
            return 1
        *notes, last = proc.stdout.strip().splitlines()
        run = json.loads(last)
        for note in notes:
            print(f"{name}: {note}")
        print(f"{name}: " + ", ".join(f"{k} {min(v):.5f} ms" for k, v in run.items()), flush=True)
        for k, v in run.items():
            results[name].setdefault(k, []).extend(v)
    first = roots[0][0]
    for k in results[first]:
        medians = {name: sorted(r[k])[len(r[k]) // 2] for name, r in results.items()}
        ratio = "".join(f"; {first} / {name} {medians[first] / medians[name]:.2f}x"
                        for name in medians if name != first)
        print(f"{k}: " + "; ".join(
            f"{name} median {medians[name]:.5f}, least {min(r[k]):.5f}, most {max(r[k]):.5f} ms "
            f"device time a call ({len(r[k])} rounds)" for name, r in results.items()) + ratio)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
