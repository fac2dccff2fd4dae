"""The benchmark of the PyTorch / CUDA port of handheld burst
super-resolution (``multi_frame_super_resolution_tpu_torch``).

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process runs one cell of ``BENCHMARK.json`` once, from the root of a
checkout, on cuda:0. Everything of a cell is found by name, and nothing
of one is written here: the configuration's file (``configs/``, named in
``BENCHMARK.json``) names its adapter (``adapters/<adapter>.py``), which
builds the program's call, the reference's and the readers' fields; the
traffic mix (``traffic/<traffic>.json``) names its generator
(``traffic/<generator>.py``); the limits are ``checks/<cell>.json``; each
metric's reader is ``end_to_end/<name>.py`` or ``metrics/<name>.py``.
Set-up imports, builds or loads the kernels (the program keeps them in
``build/kernels/`` of the checkout, the compile cache), makes the input
pool on the card from the seed and warms up the cell's own shapes. With
``--trace 0`` it then runs a closed loop of one client for ``--seconds``
and reports the end-to-end metrics; with ``--trace 1`` it profiles the
mix's ``trace_bursts`` calls and reports the per-layer metrics. Either
way a sample of its calls, drawn from the seed, is compared with the
plain reference once the loop has ended (``check.py``), each compared
number printed beside its limit. Without a card it exits with 2 and
prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in the process
FORBIDDEN = ("jax", "jaxlib", "flax", "multi_frame_super_resolution_tpu")
PROFILE_TRIES = 3


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path):
    """The module of the file ``path``, loaded under a name of its own."""
    name = "port_bench_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(kind: str, name: str, bench: Path = BENCH):
    """The ``read`` function of ``<kind>/<name>.py``."""
    return load_module(bench / kind / f"{name}.py").read


def loaded_forbidden() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def host_line() -> str:
    """The host's load averages, the mean clock of its cores and the cores
    this process may use: what a host-paced cell's spread follows."""
    try:
        mhz = [float(line.split(":")[1]) for line in Path("/proc/cpuinfo").read_text().splitlines()
               if line.startswith("cpu MHz")]
    except OSError:
        mhz = []
    clock = f"{sum(mhz) / len(mhz):.0f} MHz mean over {len(mhz)} cores" if mhz else "clock unknown"
    return f"load {os.getloadavg()}, {clock}, {len(os.sched_getaffinity(0))} cores usable"


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration file and its mix,
    all read from the checkout at ``root``."""

    name: str
    spec: dict
    workload: dict
    config: dict
    mix: dict
    bench: Path

    @classmethod
    def load(cls, name: str, spec: dict | None = None, mix_override: dict | None = None,
             root: Path = ROOT) -> "Cell":
        spec = spec or load_spec(root)
        workload = find(spec["workloads"], name, "workload")
        config = json.loads((root / find(spec["configs"], workload["config"], "config")["file"]).read_text())
        bench = root / BENCH.name
        mix = json.loads((bench / "traffic" / f"{workload['traffic']}.json").read_text())
        return cls(name, spec, workload, config, dict(mix, **(mix_override or {})), bench)

    def metrics(self, section: str) -> list:
        """The cell's entries of ``end_to_end`` or ``per_layer``."""
        return [m for m in self.spec[section] if "workloads" not in m or self.name in m["workloads"]]

    def adapter(self):
        """The configuration's adapter module (``adapters/<adapter>.py``)."""
        return load_module(self.bench / "adapters" / f"{self.config['adapter']}.py")

    def generator(self):
        """The mix's generator module (``traffic/<generator>.py``)."""
        return load_module(self.bench / "traffic" / f"{self.mix['generator']}.py")

    def reader(self, kind: str, name: str):
        return load_reader(kind, name, self.bench)

    def limits(self) -> dict:
        from port_bench import check

        return check.load_limits(self.name, self.bench / "checks")


def readers_context(cell: Cell, subject, summary) -> types.SimpleNamespace:
    """What a per-layer reader gets: the trace's summary, the cell's
    configuration and mix, and the fields its adapter gives."""
    return types.SimpleNamespace(summary=summary, config=cell.config, mix=cell.mix, **subject.reader_fields())


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, entry_wrap=None) -> dict:
    """One run of ``cell``: set-up, the timed loop or the traced window,
    and the check. Returns the result's fields. ``entry_wrap`` (tests and
    calibration) wraps the program's entry point."""
    import torch

    from port_bench import check, trace

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    subject = cell.adapter().subject(cell.config, cell.mix, device, entry_wrap)
    generator = cell.generator()
    if cuda:
        subject.prebuild()
    mix = cell.mix
    pool = generator.make_pool(seed, mix, subject.needs, device)
    calls = 0
    for _ in range(int(mix["warmup_bursts"])):
        subject(generator.call_input(pool, calls, mix))
        calls += 1
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T0

    sample = check.Sample(int(mix["check_bursts"]), seed)
    latencies, attempted, failed = [], 0, 0
    result = {}

    def one_call(record=None):
        nonlocal calls, attempted, failed
        x = generator.call_input(pool, calls, mix)
        sync()
        t0 = time.perf_counter()
        try:
            if record is None:
                out = subject(x)
            else:
                with record(trace.BURST_RANGE):
                    out = subject(x)
                    sync()
            sync()
        except Exception as err:  # a call that fails counts as failed, and the run goes on
            print(f"call {calls} failed: {type(err).__name__}: {err}", file=sys.stderr)
            out = None
        t1 = time.perf_counter()
        attempted += 1
        if out is None or tuple(out.shape) != tuple(subject.output_shape):
            failed += 1
        else:
            latencies.append(t1 - t0)
            sample.offer(calls, out)
        calls += 1
        return t1

    print(f"host before the window: {host_line()}", file=sys.stderr)
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        n = int(mix["trace_bursts"])
        for attempt in range(1, PROFILE_TRIES + 1):
            with profile(activities=activities) as prof:
                for _ in range(n):
                    one_call(record_function)
            summary = trace.summarize(trace.collect(prof, n))
            if summary.ops_per_burst > 0 or not cuda:
                break
            if attempt == PROFILE_TRIES:
                raise RuntimeError(f"{PROFILE_TRIES} profiles recorded no device op")
            print(f"profile {attempt} recorded no device op; again", file=sys.stderr)
        total = sum(summary.stage_ms.values())
        print(f"traced {n} bursts: {summary.ops_per_burst} device ops and {summary.device_ms_per_burst} device ms a "
              f"burst; stages {summary.stage_ms} add up to {total} ms; {summary.unlaunched_ops} ops without a "
              f"recorded launch; busy {summary.busy_s} s of {summary.window_s} s", file=sys.stderr)
        if abs(total - summary.device_ms_per_burst) > 1e-9 * max(1.0, total):
            raise RuntimeError("the stages do not add up to the device total")
        ctx = readers_context(cell, subject, summary)
        metrics = {}
        for m in cell.metrics("per_layer"):
            value = cell.reader("metrics", m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["device_extra"] = {"busy_s": summary.busy_s, "window_s": summary.window_s}
        result["breakdown"] = trace.breakdown(summary)
    else:
        start = time.perf_counter()
        end = start
        while end - start < seconds:
            end = one_call()
        run = types.SimpleNamespace(latencies_s=latencies, window_s=end - start, setup_s=setup_s,
                                    output_pixels=subject.output_pixels)
        metrics = {}
        for m in cell.metrics("end_to_end"):
            metrics[m["name"]] = {"value": cell.reader("end_to_end", m["name"])(run), "unit": m["unit"]}
        lat_ms = sorted(1e3 * t for t in latencies)
        if lat_ms:
            print(f"{len(lat_ms)} bursts in {end - start} s; latency ms min {lat_ms[0]}, median "
                  f"{lat_ms[len(lat_ms) // 2]}, max {lat_ms[-1]}", file=sys.stderr)
    print(f"host after the window: {host_line()}", file=sys.stderr)

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.empty_cache()
    numbers = reference_numbers(cell, subject, generator, pool, sample)
    limits = cell.limits()
    result.update(
        correct=failed == 0 and check.verdict(numbers, limits), attempted=attempted, failed=failed,
        metrics=metrics, memory_peak_bytes=peak,
        checks={k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()},
    )
    return result


def reference_numbers(cell: Cell, subject, generator, pool: list, sample) -> dict:
    """The compared numbers, worst over the sampled calls: the reference
    run on each sampled call's input, made from the pool as it was."""
    from port_bench import check

    readings = []
    for i, out in sorted(sample.kept, key=lambda kv: kv[0]):
        want = subject.reference(generator.call_input(pool, i, cell.mix))
        readings.append(check.compare(out, want))
        print(f"call {i} against the reference: {readings[-1]}", file=sys.stderr)
    return check.worst(readings)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = Cell.load(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    found = loaded_forbidden()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
           "memory_peak_bytes": result["memory_peak_bytes"]}
    dev.update(result.get("device_extra", {}))
    line = {"correct": result["correct"], "attempted": result["attempted"], "failed": result["failed"],
            "metrics": result["metrics"], "device": dev}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    print(f"card: {card_line()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
