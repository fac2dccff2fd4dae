"""The harness on the CPU: names resolve to files, the end-to-end readers
take every burst of the window, the stages add up on a synthetic trace,
the roofline arithmetic at the mixes' shapes, and no JAX anywhere.

    python -m pytest port_bench/tests -q
"""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import run, trace, work

BENCH = Path(run.__file__).resolve().parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
JAX_NAMES = {"jax", "jaxlib", "flax", "multi_frame_super_resolution_tpu"}
PORT = "multi_frame_super_resolution_tpu_torch"


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    c = run.Cell.load(cell)
    assert c.config["name"] == c.workload["config"]
    assert c.mix["frames"] >= 2 and c.mix["zoom"] >= 1
    assert c.limits() and (BENCH / "checks" / f"{cell}.json").exists()
    subject = c.adapter().subject(c.config, c.mix, "cpu")
    assert subject.cfg.scale == subject.ref_cfg.scale == c.mix["zoom"]
    assert callable(c.generator().make_pool) and callable(c.generator().call_input)
    for m in c.metrics("end_to_end"):
        assert callable(c.reader("end_to_end", m["name"]))
    for m in c.metrics("per_layer"):
        assert callable(c.reader("metrics", m["name"]))


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_file_holds_every_field(config):
    """Each configuration file names every field of the handheld
    configuration but the scale, which the mix's zoom sets."""
    import dataclasses

    from port_bench.reference import config as rc

    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    fields = json.loads((ROOT / entry["file"]).read_text())["handheld_config"]

    def check(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        assert set(d) == names - ({"scale"} if cls is rc.HandheldConfig else set())
        for f in dataclasses.fields(cls):
            if dataclasses.is_dataclass(f.default):
                check(type(f.default), d[f.name])

    check(rc.HandheldConfig, fields)


def _run(latencies):
    return types.SimpleNamespace(latencies_s=latencies, window_s=sum(latencies), setup_s=1.0,
                                 output_pixels=3072 * 4096)


def test_end_to_end_readers_take_every_burst():
    """One stalled burst among 200 moves both the rate and the tail: the
    tail is an order statistic of the bursts themselves, not of medians
    of chunks."""
    mp_s = run.load_reader("end_to_end", "output_mp_s")
    p95 = run.load_reader("end_to_end", "burst_ms_p95")
    steady = list(np.linspace(0.1, 0.2, 200))
    stalled = [1.0] + steady[1:]  # the fastest burst stalls
    assert mp_s(_run([0.1] * 200)) == pytest.approx(3072 * 4096 / 1e6 / 0.1)
    assert mp_s(_run(stalled)) < mp_s(_run(steady))
    assert p95(_run(steady)) == pytest.approx(np.percentile(steady, 95) * 1e3)
    assert p95(_run(stalled)) > p95(_run(steady))
    assert p95(_run(stalled)) == pytest.approx(np.percentile(stalled, 95) * 1e3)


def _synthetic_trace():
    # host ranges, launches by correlation id, device ops; window 0..1000
    ranges = (("mfsr.prealign", 0, 100), ("mfsr.align", 100, 200), ("mfsr.merge", 200, 300),
              ("mfsr.solve", 210, 230))  # solve nested inside merge
    launches = {1: 10, 2: 50, 3: 150, 4: 220, 5: 250, 6: 400}
    ops = (trace.DeviceOp("k_pre", 100, 30, 1), trace.DeviceOp("k_pre2", 140, 10, 2),
           trace.DeviceOp("tile_search_kernel", 300, 50, 3), trace.DeviceOp("solve_op", 360, 20, 4),
           trace.DeviceOp("merge_raw_kernel<2>", 380, 100, 5), trace.DeviceOp("glue", 600, 40, 6),
           trace.DeviceOp("lost", 700, 5, 99))
    return trace.Trace(ranges, launches, ops, (0, 1000), 2)


def test_stages_add_up_to_device_total():
    s = trace.summarize(_synthetic_trace())
    assert s.stage_ms["mfsr.prealign"] == pytest.approx(40 / 1e6 / 2)
    assert s.stage_ms["mfsr.align"] == pytest.approx(50 / 1e6 / 2)
    assert s.stage_ms["mfsr.solve"] == pytest.approx(20 / 1e6 / 2)  # the innermost range
    assert s.stage_ms["mfsr.merge"] == pytest.approx(100 / 1e6 / 2)
    assert s.stage_ms[trace.OTHER] == pytest.approx(45 / 1e6 / 2)  # no range open; no launch recorded
    assert sum(s.stage_ms.values()) == pytest.approx(s.device_ms_per_burst)
    assert s.ops_per_burst == 3.5 and s.unlaunched_ops == 1
    assert s.busy_s == pytest.approx(255 / 1e9) and s.window_s == pytest.approx(1e-6)
    # idle before an op is charged to the stage that launched it; the tail to other
    assert s.idle_s_by_stage["mfsr.prealign"] == pytest.approx((100 + 10) / 1e9)
    assert s.idle_s_by_stage[trace.OTHER] == pytest.approx((120 + 60 + 295) / 1e9)
    assert sum(s.idle_s_by_stage.values()) == pytest.approx(s.window_s - s.busy_s)
    assert s.kernel_sum("merge_raw") == pytest.approx(100 / 1e6 / 2)


def test_readers_of_the_synthetic_trace():
    s = trace.summarize(_synthetic_trace())
    cell = run.Cell.load("raw_zoom2")
    subject = cell.adapter().subject(cell.config, cell.mix, "cpu")
    ctx = run.readers_context(cell, subject, s)
    total = sum(run.load_reader("metrics", m["name"])(ctx) or 0.0
                for m in SPEC["per_layer"] if m["name"].startswith("stage_ms."))
    assert total == pytest.approx(s.device_ms_per_burst)
    assert run.load_reader("metrics", "device_ops_per_burst")(ctx) == 3.5
    assert run.load_reader("metrics", "device_idle_pct")(ctx) == pytest.approx(100 * (1 - 255 / 1000))
    assert run.load_reader("metrics", "merge_fast_roofline")(ctx) is None  # a RAW cell
    roof = run.load_reader("metrics", "merge_raw_roofline")(ctx)
    assert roof == pytest.approx(100 * work.merge_raw_bound(
        ctx.merge, 2, 1.0, 1.0, 8, 1536, 2048).least_s() * 1e3 / (100 / 1e6 / 2))
    empty = trace.summarize(trace.Trace((), {}, (), (0, 1000), 1))
    ctx = run.readers_context(cell, subject, empty)
    for m in SPEC["per_layer"]:  # nothing to read: nothing returned, never 0
        assert run.load_reader("metrics", m["name"])(ctx) is None


def test_breakdown_lists():
    b = trace.breakdown(trace.summarize(_synthetic_trace()))
    assert b["device_ops"][0] == ["merge_raw_kernel<2>", pytest.approx(100 / 1e9)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


@pytest.mark.parametrize("mix,scale,hh,hw", [("zoom2_8f", 2, 768, 1024), ("zoom4_8f", 4, 384, 512)])
def test_merge_raw_work_and_bytes(mix, scale, hh, hw):
    """Hand-computed: 21 taps survive the e^-1.5 prune at k_max (s/2)^2;
    items frames x half-res pixels x taps x S^2; bytes: planes 4, residual
    2, certainty 3 floats a frame and pixel, two 3-float kernel planes, 4
    moments of (2S)^2 x 3 floats a pixel."""
    m = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    merge = json.loads((BENCH / "configs" / "handheld_raw.json").read_text())["handheld_config"]["merge"]
    k_max = (scale / 2) ** 2
    assert work.n_taps(scale, 1, 1.0, k_max, 1.5) == 21
    b = work.merge_raw_bound(merge, scale, k_max, 1.0, m["frames"], m["height"], m["width"])
    items = 8 * hh * hw * 21 * scale ** 2
    assert b.items == items == 528_482_304
    assert b.bytes == 4 * (8 * hh * hw * 9 + 6 * hh * hw) + 4 * 4 * (2 * scale) ** 2 * 3 * hh * hw
    per = {2: (38.5, 2), 4: (36.0, 2)}[scale]
    assert (b.flops, b.exps) == (per[0] * items, per[1] * items)
    assert b.bound_by() == "operations"
    assert b.least_s() == pytest.approx(max(b.flops / 67e12, b.exps / (16 * 132 * 1.98e9)))


@pytest.mark.parametrize("mix,scale", [("zoom2_8f", 2), ("zoom4_8f", 4)])
def test_merge_fast_work_and_bytes(mix, scale):
    m = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    merge = json.loads((BENCH / "configs" / "handheld_rgb.json").read_text())["handheld_config"]["merge"]
    h, w = m["height"], m["width"]
    b = work.merge_fast_bound(merge, scale, (scale / 2) ** 2, 1.0, 8, h, w)
    items = 8 * h * w * 21 * scale ** 2
    assert b.items == items
    assert b.bytes == 4 * (8 * h * w * 8 + h * w * 3) + 4 * 2 * scale ** 2 * 3 * h * w
    assert b.flops == {2: 19.5, 4: 17.5}[scale] * items and b.exps == items


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(str(p.relative_to(BENCH)) for p in BENCH.rglob("*.py")))
def test_no_jax_import(path):
    """No module under port_bench/ imports JAX or the JAX package (each
    top-level name compared whole: the port's name begins with the JAX
    package's); the reference imports nothing of the port either."""
    tops = {name.split(".")[0] for name in _imports(BENCH / path)}
    assert not tops & JAX_NAMES
    if path.startswith("reference"):
        assert PORT not in tops


def test_no_jax_loaded_in_a_fresh_interpreter():
    code = (
        "import sys, glob, runpy\n"
        "import port_bench.run, port_bench.check, port_bench.trace, port_bench.work, port_bench.calibrate\n"
        "import port_bench.reference.models.handheld\n"
        "import multi_frame_super_resolution_tpu_torch.models.handheld\n"
        "from port_bench import run\n"
        "for kind in ('metrics', 'end_to_end'):\n"
        "    for p in glob.glob(f'port_bench/{kind}/*.py'):\n"
        "        run.load_reader(kind, p.split('/')[-1][:-3])\n"
        "for kind in ('adapters', 'traffic'):\n"
        "    for p in glob.glob(f'port_bench/{kind}/*.py'):\n"
        "        run.load_module(run.Path(p))\n"
        "print(run.loaded_forbidden())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_loads_nothing_of_the_port():
    code = ("import sys\nimport port_bench.reference.models.handheld, port_bench.reference.kernels\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('multi_frame_super_resolution_tpu_torch', 'multi_frame_super_resolution_tpu', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    cells = [w["name"] for w in SPEC["workloads"]]
    reports = {e["name"]: set(e.get("workloads", cells)) for e in SPEC["end_to_end"]}
    assert all(r <= set(cells) for r in reports.values())
    for m in SPEC["per_layer"]:
        # each cell that reads the metric reports the end-to-end metric it moves
        assert set(m.get("workloads", cells)) <= reports[m["moves"]]
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    for m in SPEC["end_to_end"]:
        assert (BENCH / "end_to_end" / f"{m['name']}.py").exists()


# a configuration of another kind, a mix with a generator of its own and a
# per-layer metric, each a new file: the output is the mean of the
# input's frames, its reference the same mean taken in float64
DUMMY_ADAPTER = """
class Subject:
    def __init__(self, config, mix, device, entry_wrap=None):
        def entry(x, cfg):
            return x.mean(dim=0)
        self.entry = entry_wrap(entry) if entry_wrap is not None else entry
        self.needs = {"channels": config["channels"]}
        self.output_shape = (mix["height"], mix["width"], config["channels"])
        self.output_pixels = mix["height"] * mix["width"]
        self.frames = mix["frames"]

    def prebuild(self):
        pass

    def __call__(self, x):
        return self.entry(x, None)

    def reference(self, x):
        return x.double().mean(dim=0).float()

    def reader_fields(self):
        return {"frames": self.frames}


def subject(config, mix, device, entry_wrap=None):
    return Subject(config, mix, device, entry_wrap)


FAULTS = {}
"""
DUMMY_GENERATOR = """
import torch


def make_pool(seed, mix, needs, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (mix["frames"], mix["height"], mix["width"], needs["channels"])
    return [torch.rand(shape, generator=gen, device=device) for _ in range(mix["pool"])]


def call_input(pool, i, mix):
    return pool[i % len(pool)]
"""
DUMMY_METRIC = """
def read(ctx):
    return float(ctx.frames)
"""


def test_a_new_configuration_mix_and_metric_are_new_files_and_entries(tmp_path):
    """A configuration that is no handheld one, a mix with a generator of
    its own and a per-layer metric go in as new files and new entries of
    BENCHMARK.json, and a run finds, runs and checks them, with no edit
    to any file that was there."""
    bench = tmp_path / BENCH.name
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "adapters" / "frame_mean.py").write_text(DUMMY_ADAPTER)
    (bench / "traffic" / "uniform_frames.py").write_text(DUMMY_GENERATOR)
    (bench / "traffic" / "tiny_uniform.json").write_text(json.dumps(
        {"generator": "uniform_frames", "frames": 3, "height": 8, "width": 16, "pool": 2,
         "warmup_bursts": 1, "trace_bursts": 2, "check_bursts": 2}))
    (bench / "configs" / "frame_mean.json").write_text(json.dumps(
        {"name": "frame_mean", "adapter": "frame_mean", "channels": 3}))
    (bench / "checks" / "mean_tiny.json").write_text(json.dumps({"limits": {"max_abs": 1e-6}}))
    (bench / "metrics" / "frames_seen.py").write_text(DUMMY_METRIC)
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "frame_mean", "source": "https://example.org/frame-mean",
                            "file": f"{BENCH.name}/configs/frame_mean.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "mean_tiny", "config": "frame_mean", "traffic": "tiny_uniform",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher", "source": "program_counter",
                              "layer": "test", "moves": "output_mp_s", "workloads": ["mean_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = run.Cell.load("mean_tiny", root=tmp_path)
    cpu = torch.device("cpu")
    result = run.run_cell(cell, 2**31 + 5, 0.05, False, cpu)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {m["name"] for m in SPEC["end_to_end"] if "workloads" not in m}
    traced = run.run_cell(cell, 2**31 + 5, 0.05, True, cpu)
    assert traced["correct"] and traced["metrics"] == {"frames_seen": {"value": 3.0, "unit": "frames"}}
    broken = run.run_cell(cell, 2**31 + 5, 0.05, False, cpu,
                          entry_wrap=lambda entry: (lambda x, cfg: entry(x, cfg) + 1e-3))
    assert not broken["correct"] and broken["checks"]["max_abs"]["value"] > 1e-6
    assert all(p.read_bytes() == data for p, data in before.items())
