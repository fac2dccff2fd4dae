"""How ``correct`` is decided: the program's outputs of a sample of the
window's calls, drawn from the seed, against the plain reference
(``port_bench/reference``) run on the same inputs once the window has
closed.

Each compared number is taken over the whole output of a call and the
worst over the sample is held to its limit, which the cell's file
``checks/<cell>.json`` gives with the readings it was set from. The
faults a cell can have are its adapter's (``FAULTS``); the tests and
``calibrate.py`` plant them under the timed path.
"""

from __future__ import annotations

import json
import math
import random
from pathlib import Path

import torch

CHECKS_DIR = Path(__file__).resolve().parent / "checks"
# the numbers compare() gives, each worse when larger: quantiles of the
# absolute difference (p90_abs: its 90th percentile), its largest value,
# its root mean square, and the share of the values (0 to 1) that it
# puts past a threshold (share_over_1e-3: past 1e-3)
QUANTILES = {"p50_abs": 0.5, "p90_abs": 0.9, "p99_abs": 0.99, "p999_abs": 0.999, "p9999_abs": 0.9999}
SHARES = {"share_over_1e-4": 1e-4, "share_over_1e-3": 1e-3, "share_over_1e-2": 1e-2}
NUMBERS = (*QUANTILES, "max_abs", "rms", *SHARES)


def load_limits(cell: str, checks_dir: Path = CHECKS_DIR) -> dict:
    """{number: limit} of the cell (``checks/<cell>.json``)."""
    return json.loads((checks_dir / f"{cell}.json").read_text())["limits"]


def compare(out: torch.Tensor, want: torch.Tensor) -> dict:
    """The numbers of one output against the reference's, over every
    value of the image: quantiles of the absolute difference (the value
    at rank floor(q (n - 1)) in ascending order), its largest value, its
    root mean square and the shares past each threshold. A shape that
    differs, or a value that is not finite, reads infinity."""
    if tuple(out.shape) != tuple(want.shape):
        return {k: math.inf for k in NUMBERS}
    d = (out.double() - want.double()).abs().reshape(-1)
    if not bool(torch.isfinite(d).all()):
        return {k: math.inf for k in NUMBERS}
    ranked = torch.sort(d).values
    n = ranked.numel()
    numbers = {k: float(ranked[int(q * (n - 1))]) for k, q in QUANTILES.items()}
    numbers.update(max_abs=float(ranked[-1]), rms=float(d.square().mean().sqrt()))
    for k, t in SHARES.items():
        numbers[k] = int((d > t).sum()) / n
    return numbers


def worst(readings: list) -> dict:
    """The largest reading of each number over several compare()s."""
    return {k: max(r[k] for r in readings) for k in NUMBERS} if readings else {}


def verdict(numbers: dict, limits: dict) -> bool:
    """Whether every limited number lies within its limit."""
    return bool(numbers) and all(numbers.get(k, math.inf) <= lim for k, lim in limits.items())


class Sample:
    """A reservoir of ``k`` of the window's calls, drawn from the seed:
    after n calls offered, each is in it with probability k / n."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(int(seed))
        self.kept = []  # (call index, output)
        self.seen = 0

    def offer(self, i: int, out) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((i, out))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.kept[j] = (i, out)
