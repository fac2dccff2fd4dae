"""Benchmark timing utilities (counterpart of utils/timing.py).

The reference's warmup-then-measure FPS protocol
(multi_frame_sr.cpp:149,187-206 and polar_defog.cpp:126-141,298-300),
with the JAX package's two rules:

  1. Every timed call ends on a host VALUE READBACK of its result (a
     scalar sum), which waits for the device: PyTorch returns before the
     card has finished.
  2. Every timed call gets a slightly PERTURBED copy of the inputs
     (scaled by 1 - 1e-5 i), so no two calls compute on equal data.

``measure`` reports per-call latency, host dispatch included;
``measure_amortized`` reports the marginal cost of one more call in a
back-to-back run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class BenchmarkResult:
    name: str
    seconds: float            # total timed wall clock
    iters: int
    pixels_per_iter: float = 0.0
    iter_times: Optional[list] = None  # per-iteration seconds
    amortized_sec: Optional[float] = None  # marginal sec/iter (measure_amortized)

    @property
    def sec_per_iter(self) -> float:
        return self.seconds / max(self.iters, 1)

    @property
    def p50(self) -> float:
        """Median per-iteration latency in seconds."""
        if not self.iter_times:
            return self.sec_per_iter
        times = sorted(self.iter_times)
        return times[len(times) // 2]

    @property
    def fps(self) -> float:
        return self.iters / self.seconds if self.seconds > 0 else float("inf")

    @property
    def mp_per_s(self) -> float:
        """Megapixels of output produced per second (per-dispatch)."""
        if self.seconds <= 0:
            return float("inf")
        return self.pixels_per_iter * self.iters / self.seconds / 1e6

    @property
    def amortized_mp_per_s(self) -> float:
        """MP/s at the amortized latency (None -> per-dispatch)."""
        if self.amortized_sec is None or self.amortized_sec <= 0:
            return self.mp_per_s
        return self.pixels_per_iter / self.amortized_sec / 1e6

    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "seconds": self.seconds,
            "iters": self.iters,
            "fps": self.fps,
            "mp_per_s": self.mp_per_s,
            "amortized_sec": self.amortized_sec,
        }

    def __str__(self) -> str:  # mirrors the reference's "sec\nFPS" prints
        s = f"{self.name}: {self.seconds:.4f} sec, {self.fps:.2f} FPS"
        if self.pixels_per_iter:
            s += f", {self.mp_per_s:.1f} MP/s (per-dispatch)"
        if self.amortized_sec is not None:
            s += (
                f"; in-graph {self.amortized_sec * 1e3:.2f} ms/iter"
                + (
                    f", {self.amortized_mp_per_s:.1f} MP/s"
                    if self.pixels_per_iter
                    else ""
                )
            )
        return s


def _first_tensor(out) -> torch.Tensor:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    return _first_tensor(out[0])


def _readback(out) -> float:
    """Host value readback of the first tensor of a result (a tensor, or a
    tuple, list or dict of them): waits for the device. Returns the scalar
    so callers can keep it live."""
    return float(_first_tensor(out).sum())


def _perturbed(args: tuple, i: float) -> tuple:
    """Floating-point tensors of ``args`` scaled by (1 - 1e-5 * i):
    numerically negligible, but no two calls see equal inputs."""
    return tuple(
        a * (1.0 - 1e-5 * i) if isinstance(a, torch.Tensor) and a.is_floating_point() else a
        for a in args
    )


def measure(
    fn: Callable[..., Any],
    *,
    warmup: int = 5,
    iters: int = 20,
    name: str = "bench",
    pixels_per_iter: float = 0.0,
    args: tuple = (),
) -> BenchmarkResult:
    """Run ``fn(*args)`` ``warmup`` times untimed, then ``iters`` times
    timed with per-iteration input perturbation and a value-readback
    fence.

    ``fn`` returns a tensor (or a tuple, list or dict of them). Pass the
    inputs via ``args``: a zero-argument closure cannot be perturbed, so
    every timed call would repeat one computation on one input.
    """
    if not args:
        raise ValueError(
            "measure() needs the device inputs via args=(...) so each "
            "timed iteration can perturb them (see BENCH_NOTES.md); a "
            "zero-arg closure re-times one cached call."
        )
    for i in range(warmup):
        _readback(fn(*_perturbed(args, i + 1)))
    iter_times = []
    start = time.perf_counter()
    for i in range(iters):
        a = _perturbed(args, warmup + 1 + i)
        t0 = time.perf_counter()
        _readback(fn(*a))
        iter_times.append(time.perf_counter() - t0)
    seconds = time.perf_counter() - start
    return BenchmarkResult(
        name=name, seconds=seconds, iters=iters,
        pixels_per_iter=pixels_per_iter, iter_times=iter_times,
    )


def _cuda_device(args: tuple) -> Optional[torch.device]:
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return a.device
    return None


def measure_amortized(
    fn: Callable[..., Any],
    args: tuple,
    *,
    k: int = 8,
    reps: int = 3,
) -> float:
    """Marginal per-call seconds of ``fn(*args)``: ``k`` calls back to back,
    each on its own perturbed inputs, timed against 1 call on distinct
    inputs, (T_k - T_1) / (k - 1), medians over ``reps``. Where an input
    lies on the card the time runs between two CUDA events around the
    calls; on the CPU it is the host clock up to a readback of the last
    result.

    The JAX package runs the k calls as one ``lax.scan`` program, with no
    dispatch between them. PyTorch has no such program: here the host
    dispatches every op of every call, and the card runs them as they
    come. So the result is the device's time per call only where the
    device is slower than the host's dispatch of a call; where the host
    is slower (a path of many small ops), it is the host's dispatch time
    per call. Neither includes the readback and the launch latency of the
    first op, which the subtraction cancels."""
    dev = _cuda_device(args)
    n_variants = (1 + k) * (reps + 1)
    variants = [_perturbed(args, 10.0 * (i + 1)) for i in range(n_variants)]
    if dev is not None:
        torch.cuda.synchronize(dev)

    def run(inputs) -> float:
        if dev is None:
            t0 = time.perf_counter()
            for a in inputs:
                out = fn(*a)
            _readback(out)
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for a in inputs:
            out = fn(*a)
        end.record()
        _readback(out)
        return start.elapsed_time(end) / 1e3

    run(variants[:1])  # warm
    run(variants[1 : 1 + k])
    t1s, tks = [], []
    for r in range(reps):
        at = (1 + k) * (r + 1)
        t1s.append(run(variants[at : at + 1]))
        tks.append(run(variants[at + 1 : at + 1 + k]))
    return max(float(np.median(tks)) - float(np.median(t1s)), 1e-9) / (k - 1)


class Timer:
    """Simple start/stop timer mirroring cv::TickMeter usage in the
    reference harnesses."""

    def __init__(self) -> None:
        self._start: Optional[float] = None
        self.seconds: float = 0.0

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is not None:
            self.seconds += time.perf_counter() - self._start
            self._start = None
        return self.seconds
