"""From a torch.profiler trace to what the per-layer metrics read.

Every device op (kernel, copy, memset) of the traced bursts goes to
exactly one stage: the innermost ``mfsr.*`` range open on the host when
the op was launched, found through the CUDA runtime call that launched
it (the profiler gives both the same correlation id), or ``other`` where
no range was open or no launch was recorded. That holds for the ATen
ops and for the program's ctypes kernel launches alike, so the stages
plus ``other`` add up to the device total.

``collect`` reads a finished profile into plain lists; ``summarize``
works on those lists alone, so a synthetic trace tests it on the CPU.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

OTHER = "other"
STAGE_PREFIX = "mfsr."
BURST_RANGE = "port_bench.burst"
NAME_CHARS = 160  # a kernel's C++ signature runs to thousands


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    correlation: int


@dataclasses.dataclass(frozen=True)
class Trace:
    """A traced window: the host's ``mfsr.*`` ranges (name, start, end),
    the host time of each launch by correlation id, the device ops, and
    the window's bounds (the first traced burst's start to the last's
    end, in the profiler's clock)."""

    ranges: Tuple[Tuple[str, int, int], ...]
    launches: Dict[int, int]
    ops: Tuple[DeviceOp, ...]
    window: Tuple[int, int]
    bursts: int


@dataclasses.dataclass(frozen=True)
class Summary:
    bursts: int
    window_s: float
    busy_s: float
    ops_per_burst: float
    device_ms_per_burst: float
    stage_ms: Dict[str, float]  # per burst, by stage (``other`` included)
    kernel_ms: Dict[str, float]  # per burst, by device op name
    idle_s_by_stage: Dict[str, float]  # the window's idle time, by the stage launching the op waited for
    unlaunched_ops: int  # device ops whose launch the profile did not record

    def stage_sum(self, stages: Sequence[str]) -> float:
        return sum(self.stage_ms.get(s, 0.0) for s in stages)

    def kernel_sum(self, symbol: str) -> float:
        """Device ms per burst of the ops whose name holds ``symbol``."""
        return sum(ms for name, ms in self.kernel_ms.items() if symbol in name)


def stage_of(ranges: Sequence[Tuple[str, int, int]], t_ns: Optional[int]) -> str:
    """The innermost range (latest start) open at host time ``t_ns``."""
    if t_ns is None:
        return OTHER
    best, best_start = OTHER, None
    for name, start, end in ranges:
        if start <= t_ns < end and (best_start is None or start >= best_start):
            best, best_start = name, start
    return best


def _union_s(intervals: List[Tuple[int, int]]) -> float:
    total, cur_lo, cur_hi = 0, None, None
    for lo, hi in sorted(intervals):
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total / 1e9


def summarize(trace: Trace) -> Summary:
    """Stages, busy time and idle gaps of a traced window."""
    lo, hi = trace.window
    ranges = sorted(trace.ranges, key=lambda r: r[1])
    starts = [r[1] for r in ranges]
    ops = sorted((op for op in trace.ops if lo <= op.start_ns < hi), key=lambda op: op.start_ns)
    stage_ns: Dict[str, int] = {}
    kernel_ns: Dict[str, int] = {}
    idle_ns: Dict[str, int] = {}
    unlaunched = 0
    reach = lo  # the latest end of the ops so far: the device is idle before it
    for op in ops:
        launched = trace.launches.get(op.correlation)
        if launched is None:
            unlaunched += 1
        # ranges that start after the launch cannot hold it
        open_ranges = ranges[: bisect.bisect_right(starts, launched)] if launched is not None else []
        stage = stage_of(open_ranges, launched)
        stage_ns[stage] = stage_ns.get(stage, 0) + op.dur_ns
        kernel_ns[op.name] = kernel_ns.get(op.name, 0) + op.dur_ns
        if op.start_ns > reach:
            idle_ns[stage] = idle_ns.get(stage, 0) + op.start_ns - reach
        reach = max(reach, op.start_ns + op.dur_ns)
    if hi > reach:
        idle_ns[OTHER] = idle_ns.get(OTHER, 0) + hi - reach
    n = max(trace.bursts, 1)
    return Summary(
        bursts=trace.bursts,
        window_s=(hi - lo) / 1e9,
        busy_s=_union_s([(op.start_ns, min(op.start_ns + op.dur_ns, hi)) for op in ops]),
        ops_per_burst=len(ops) / n,
        device_ms_per_burst=sum(op.dur_ns for op in ops) / 1e6 / n,
        stage_ms={k: v / 1e6 / n for k, v in stage_ns.items()},
        kernel_ms={k: v / 1e6 / n for k, v in kernel_ns.items()},
        idle_s_by_stage={k: v / 1e9 for k, v in idle_ns.items()},
        unlaunched_ops=unlaunched,
    )


def breakdown(summary: Summary, top: int = 10) -> dict:
    """The device ops that took most time (their names cut to
    ``NAME_CHARS``), and the idle time by the stage the device waited for,
    each at most ``top`` entries, in seconds over the traced window."""
    ops = sorted(summary.kernel_ms.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary.idle_s_by_stage.items(), key=lambda kv: -kv[1])[:top]
    return {
        "device_ops": [[name[:NAME_CHARS], ms * summary.bursts / 1e3] for name, ms in ops],
        "idle_gaps": [[name, s] for name, s in gaps],
    }


def collect(prof, bursts: int) -> Trace:
    """The lists ``summarize`` reads, from a finished torch.profiler
    profile whose window is the ``BURST_RANGE`` ranges on the host."""
    from torch.autograd import DeviceType

    ranges, launches, ops, window = [], {}, [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append(DeviceOp(name, e.start_ns(), e.duration_ns(), e.correlation_id()))
        elif e.is_user_annotation() or name.startswith(STAGE_PREFIX) or name == BURST_RANGE:
            if name.startswith(STAGE_PREFIX):
                ranges.append((name, e.start_ns(), e.end_ns()))
            elif name == BURST_RANGE:
                window.append((e.start_ns(), e.end_ns()))
        elif name.startswith("cu") and e.correlation_id():
            # a CUDA runtime or driver call: the host side of a launch
            launches[e.correlation_id()] = e.start_ns()
    if not window:
        raise RuntimeError("the profile holds no traced burst")
    return Trace(tuple(ranges), launches, tuple(ops), (min(w[0] for w in window), max(w[1] for w in window)),
                 bursts)
