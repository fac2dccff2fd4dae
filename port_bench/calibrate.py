"""The readings a cell's limits are set from (``checks/<cell>.json``), at
the cell's own size, in one process:

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 [--fault-seeds 201,202,203] [--out FILE]

For each of ``--seeds``: the program's timed entry on the first input of
that seed's pool against the plain reference (the lower reading is the
largest). For each of ``--control-seeds``: the adapter's control (for
the handheld cells the reference with everything it hands from stage to
stage held in bfloat16) against the reference (the upper reading is the
smallest). For each of ``--fault-seeds``: each of the adapter's
``FAULTS`` planted under the program's entry, against the reference. One JSON line per reading goes to stdout
and, with ``--out``, to that file; the benchmark's own runs never run
this. Needs a card, as ``run.py`` does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench import check, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = run.Cell.load(args.workload, mix_override={"pool": 1})
    adapter, generator = cell.adapter(), cell.generator()
    subject = adapter.subject(cell.config, cell.mix, dev)
    subject.prebuild()
    faulty = {name: adapter.subject(cell.config, cell.mix, dev, entry_wrap=wrap)
              for name, wrap in adapter.FAULTS.items()}
    out_file = open(args.out, "a") if args.out else None

    def first_input(seed):
        return generator.call_input(generator.make_pool(seed, cell.mix, subject.needs, dev), 0, cell.mix)

    def emit(kind, seed, numbers, **extra):
        line = json.dumps({"cell": cell.name, "kind": kind, "seed": seed, **numbers, **extra})
        print(line, flush=True)
        if out_file:
            out_file.write(line + "\n")
            out_file.flush()

    def timed(fn, x):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            y = fn(x)
        torch.cuda.synchronize(dev)
        return y, time.perf_counter() - t0

    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    subject(first_input(0))
    for seed in seeds:
        x = first_input(seed)
        out, prog_s = timed(subject, x)
        want, ref_s = timed(subject.reference, x)
        emit("program", seed, check.compare(out, want), program_s=prog_s, reference_s=ref_s)
    for seed in control_seeds:
        x = first_input(seed)
        want, _ = timed(subject.reference, x)
        got, ctl_s = timed(subject.control, x)
        emit("control", seed, check.compare(got, want), control_s=ctl_s)
    for seed in fault_seeds:
        x = first_input(seed)
        want, _ = timed(subject.reference, x)
        for name, broken in faulty.items():
            got, _ = timed(broken, x)
            emit(f"fault {name}", seed, check.compare(got, want))
    print(f"card: {run.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
