"""The check that decides ``correct``, on the CPU at a size a test run
holds: the traffic generator is a function of the seed, the plain
reference agrees with the program's CPU path, and a run with the timed
path broken underneath (each of the adapter's faults), or with the
control in the program's place, comes out not correct. The card test
runs a short cell on cuda:0.

    python -m pytest port_bench/tests -q
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench import check, run

ROOT = Path(run.__file__).resolve().parents[1]
SMALL = {"frames": 4, "height": 64, "width": 128, "pool": 2, "warmup_bursts": 1, "trace_bursts": 2,
         "check_bursts": 2}
CELLS = ("raw_zoom2", "rgb_zoom2")
CPU = torch.device("cpu")


def _subject(cell, entry_wrap=None, **mix):
    c = run.Cell.load(cell, mix_override=dict(SMALL, **mix))
    return c, c.adapter().subject(c.config, c.mix, CPU, entry_wrap), c.generator()


def _pool(cell, seed, **mix):
    c, subject, generator = _subject(cell, **mix)
    return generator.make_pool(seed, c.mix, subject.needs, CPU)


@pytest.mark.parametrize("cell", CELLS)
def test_generator_is_a_function_of_the_seed(cell):
    seed = 2**31 + 977  # past 32 signed bits
    a, b, c = _pool(cell, seed), _pool(cell, seed), _pool(cell, seed + 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    for x in a:
        assert x.dtype == torch.float32 and 0.0 <= float(x.min()) and float(x.max()) <= 1.0
    generator = run.Cell.load(cell).generator()
    assert generator.call_input(a, 3, {"perturb": 1e-5}).equal(a[1] * (1.0 - 3e-5))


@pytest.mark.parametrize("cell", CELLS)
def test_reference_matches_the_program_on_the_cpu(cell):
    """The plain reference against the program's CPU path (its kernels'
    plain versions): the same function, so the same output."""
    c, subject, generator = _subject(cell)
    x = _pool(cell, 5)[0]
    numbers = check.compare(subject(x), subject.reference(x))
    assert numbers["max_abs"] <= 1e-6, numbers


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = run.run_cell(run.Cell.load(cell, mix_override=SMALL), 2**31 + 3, 0.2, False, CPU)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["checks"]) == set(check.load_limits(cell))


FAULTS = run.Cell.load(CELLS[0]).adapter().FAULTS


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault):
    """The rest of a run driven with the timed path broken underneath:
    half of the frames left out, an answer altered where it is made, or
    the tile warp wrong on one row of tiles."""
    c = run.Cell.load(cell, mix_override=SMALL)
    result = run.run_cell(c, 11, 0.2, False, CPU, entry_wrap=c.adapter().FAULTS[fault])
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The control, the reference with what each stage hands on held in
    bfloat16, in the program's place: it fails the cell's limits."""
    c, subject, _ = _subject(cell)

    def control(entry):
        def call(burst, cfg):
            return subject.control(burst)
        return call

    result = run.run_cell(c, 13, 0.2, False, CPU, entry_wrap=control)
    assert not result["correct"], result["checks"]


def test_sample_is_drawn_from_the_seed():
    def kept(seed):
        s = check.Sample(3, seed)
        for i in range(50):
            s.offer(i, None)
        return sorted(i for i, _ in s.kept)

    assert kept(1) == kept(1) and len(kept(1)) == 3
    assert any(kept(1) != kept(s) for s in range(2, 6))


def test_compare_reads_shape_and_nan_as_infinite():
    a = torch.zeros(4, 4, 3)
    assert check.compare(a, torch.zeros(4, 5, 3))["rms"] == float("inf")
    b = a.clone()
    b[0, 0, 0] = float("nan")
    assert check.compare(b, a)["max_abs"] == float("inf")


def test_compare_quantiles():
    """Ranks floor(q (n - 1)) of the sorted absolute differences."""
    want = torch.zeros(100, 10, 3)
    out = want.clone().reshape(-1)
    out[:] = torch.arange(3000, dtype=torch.float32) / 3000.0
    out = out[torch.randperm(3000, generator=torch.Generator().manual_seed(0))].reshape(100, 10, 3)
    n = check.compare(out, want)
    assert n["p50_abs"] == pytest.approx(1499 / 3000) and n["p90_abs"] == pytest.approx(2699 / 3000)
    assert n["p99_abs"] == pytest.approx(2969 / 3000) and n["max_abs"] == pytest.approx(2999 / 3000)
    assert n["rms"] == pytest.approx(float((torch.arange(3000.0) / 3000).square().mean().sqrt()))
    # values past 1e-4, 1e-3 and 1e-2: i / 3000 in float32 is past 1e-4 from
    # i = 1, past 1e-3 from i = 3 (just above), past 1e-2 from i = 31
    # (30 / 3000 rounds just under 1e-2)
    assert n["share_over_1e-4"] == pytest.approx(2999 / 3000)
    assert n["share_over_1e-3"] == pytest.approx(2997 / 3000)
    assert n["share_over_1e-2"] == pytest.approx(2969 / 3000)


@pytest.mark.cuda
def test_short_run_on_the_card():
    """A short traced and untraced run of the first cell on cuda:0: the
    result line's keys, ``correct`` true."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    for traced in ("0", "1"):
        out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell, "--seed", "2147483777",
                              "--seconds", "3", "--trace", traced], cwd=ROOT, capture_output=True, text=True,
                             timeout=1200)
        assert out.returncode == 0, out.stderr[-4000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] and list(line)[-1] == "checks"
        assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
        if traced == "1":
            assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
