"""Build a CUDA source of ``csrc/`` into a shared library with a plain C
interface and load it with ctypes; the checks every kernel wrapper makes.

The build runs at first use, with ``nvcc`` for ``sm_90a`` (Hopper), into
``build/kernels/`` at the root of the checkout. The library's file name
carries a hash of its source and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the kernels")


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (if its library is not built yet) and load
    it. ``build_log`` on the returned library holds what nvcc printed
    (-Xptxas -v: registers and spills per kernel), empty when it was
    already built."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib_path = BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            log = proc.stdout + proc.stderr
            os.replace(tmp, lib_path)  # atomic: concurrent builds agree
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    lib.build_log = log
    return lib


def build_all(loaders: Iterable[Callable[[], ctypes.CDLL]]) -> list:
    """Run the ``library()`` loaders of several kernels at once, one nvcc
    process each (each loader is cached, so later calls load nothing)."""
    loaders = list(loaders)
    with ThreadPoolExecutor(max_workers=max(1, len(loaders))) as pool:
        return list(pool.map(lambda load: load(), loaders))


def check_tensor(
    name: str, x: torch.Tensor, shape: tuple, device: torch.device,
    dtype: torch.dtype = torch.float32,
) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel takes."""
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(lib: ctypes.CDLL, fn: str, device: torch.device, *args) -> None:
    """Call the C launcher ``fn`` of ``lib`` with ``args`` and the current
    stream of ``device``; raise if the launch failed (the launcher
    returns cudaGetLastError())."""
    if device.type != "cuda":
        raise ValueError(f"{fn} launches on cuda tensors, got {device}")
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{fn} launch failed: {lib.mfsr_cuda_error_string(err).decode()}"
        )


def bind(lib: ctypes.CDLL, fn: str, argtypes: list) -> ctypes.CDLL:
    """Declare the C launcher ``fn`` (its stream argument last, returning
    a cudaError_t as int) and the library's error-string function."""
    getattr(lib, fn).argtypes = list(argtypes) + [ctypes.c_void_p]
    getattr(lib, fn).restype = ctypes.c_int
    lib.mfsr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mfsr_cuda_error_string.restype = ctypes.c_char_p
    return lib
