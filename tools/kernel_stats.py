"""Registers, spills and the innermost loops' SASS of CUDA sources of the
port, side by side: each source is built as the port builds it (nvcc,
sm_90a, kernels/build.py's flags), one nvcc process each, all at once.

Prints, for each source, one ptxas line per kernel instantiation (its
registers and spills), then each instantiation of the first source
against the others (how many keep their registers and spills), then, for
every function whose mangled name holds a ``--sass`` substring, its
innermost loops (a backward branch whose body holds no other) with their
instruction counts by opcode (MUFU, F2FP, HMUL2, HADD2, HFMA2, FFMA, LDS,
...): the instructions a thread issues per trip. The functions' SASS goes
to build/sass/.

Run on the GPU host from the root of the repo (it needs nvcc and
cuobjdump), e.g. a source against the parent commit's copy:
    python tools/kernel_stats.py --sass merge_fast_bf16_kernel \\
        parent=build/parent/multi_frame_super_resolution_tpu_torch/csrc/merge.cu \\
        change=multi_frame_super_resolution_tpu_torch/csrc/merge.cu
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import ptxas_table  # noqa: E402
from multi_frame_super_resolution_tpu_torch.kernels.build import NVCC_FLAGS, _nvcc  # noqa: E402

OUT = ROOT / "build" / "sass"
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)([.A-Z0-9_]*)\s*([^;]*);")


def build(source: str) -> tuple:
    """(ptxas log, SASS of every function) of ``source`` built as the port builds it."""
    OUT.mkdir(parents=True, exist_ok=True)
    fd, lib = tempfile.mkstemp(suffix=".so", dir=OUT)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", lib, source], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
        cuobjdump = Path(_nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True, text=True, check=True).stdout
    finally:
        os.unlink(lib)
    return proc.stdout + proc.stderr, sass


def functions(sass: str) -> dict:
    """{mangled name: its SASS text} of a cuobjdump -sass listing."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = part.split("\n", 1)
        out[name.strip()] = body
    return out


def innermost_loops(body: str) -> list:
    """[(first address, last address, Counter of opcodes)] of the
    function's innermost loops: a branch to an earlier address closes a
    loop from there; a loop is innermost if no other lies inside it."""
    instrs = [(int(m.group(1), 16), m.group(3), m.group(5)) for m in INSTR.finditer(body)]
    loops = []
    for addr, op, args in instrs:
        target = re.search(r"0x([0-9a-f]+)", args) if op == "BRA" else None
        if target and int(target.group(1), 16) <= addr:
            loops.append((int(target.group(1), 16), addr))
    inner = [(a, b) for a, b in loops if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]
    return [(a, b, collections.Counter(op for addr, op, _ in instrs if a <= addr <= b)) for a, b in sorted(set(inner))]


def main(argv) -> int:
    patterns = []
    while argv[:1] == ["--sass"]:
        patterns.append(argv[1])
        argv = argv[2:]
    named = [a.split("=", 1) for a in argv]
    if not named or any(len(n) != 2 for n in named):
        print(__doc__)
        return 2
    with ThreadPoolExecutor(max_workers=len(named)) as pool:
        built = dict(zip((n for n, _ in named), pool.map(lambda ns: build(ns[1]), named)))
    tables = {}
    for name, (log, _) in built.items():
        rows = ptxas_table(log)
        tables[name] = dict(r.split(": ", 1) for r in rows)
        for row in rows:
            print(f"ptxas {name}: {row}")
    first, *others = [n for n, _ in named]
    for other in others:
        same = [k for k, v in tables[first].items() if tables[other].get(k) == v]
        print(f"ptxas {first} against {other}: {len(same)} of {len(tables[first])} instantiations keep their "
              f"registers and spills ({len(tables[other])} in {other})")
        for k, v in tables[first].items():
            if tables[other].get(k) != v:
                print(f"  {k}: {first} {v}; {other} {tables[other].get(k, 'absent')}")
    for name, (_, sass) in built.items():
        for fn, body in functions(sass).items():
            if not any(p in fn for p in patterns):
                continue
            (OUT / f"{name}_{fn[:120]}.txt").write_text(body)
            for a, b, ops in innermost_loops(body):
                if sum(ops.values()) < 8:
                    continue
                keys = ("MUFU", "F2FP", "HMUL2", "HADD2", "HFMA2", "FFMA", "FADD", "FMUL", "LDS", "PRMT")
                print(f"sass {name} {fn}: loop 0x{a:x}-0x{b:x}, {sum(ops.values())} instructions; "
                      + ", ".join(f"{k} {ops[k]}" for k in keys) + "; all " + dict(ops.most_common()).__repr__())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
