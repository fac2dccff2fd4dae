"""ctypes binding of the native C++ image loader (counterpart of
data/native.py): libpng, libjpeg and a baseline TIFF reader, with
threaded burst loads, from ``native/mfsr_native.cpp`` at the root of the
checkout.

The port builds its own copy of the library at first use, with
``native/Makefile``'s compiler flags and libraries, into
``build/native/libmfsr_native.so`` (never into ``native/``, and it never
loads the JAX package's copy). Where the build fails (no g++, or no
libpng or libjpeg headers), ``available()`` is False, ``build_error()``
says why, and every reader returns None: the callers in ``data/io.py``
and ``data/datasets.py`` then read through numpy, as the JAX package
falls back to Pillow. This is host file I/O; no device work falls back.
Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
from typing import List, Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "mfsr_native.cpp")
LIBRARY = os.path.join(_ROOT, "build", "native", "libmfsr_native.so")
# native/Makefile's CXX, CXXFLAGS and LDLIBS
COMPILE = ("g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
LDLIBS = ("-lpng", "-ljpeg", "-lpthread")
BUILD_TIMEOUT_S = 120


def build(library: Optional[str] = None) -> str:
    """Compile ``SOURCE`` into ``library`` (default ``LIBRARY``) unless it
    is there and no older than the source; return its path. The compiler writes a temporary file
    that replaces ``library`` whole, so concurrent builds agree. Raises
    RuntimeError with the compiler's output when it fails, OSError when
    there is no compiler."""
    library = library or LIBRARY
    if os.path.exists(library) and os.path.getmtime(library) >= os.path.getmtime(SOURCE):
        return library
    os.makedirs(os.path.dirname(library), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(library))
    os.close(fd)
    try:
        proc = subprocess.run([*COMPILE, "-o", tmp, SOURCE, *LDLIBS], capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"{COMPILE[0]} failed on {SOURCE} (exit {proc.returncode}):\n"
                               f"{(proc.stdout + proc.stderr)[-2000:]}")
        os.replace(tmp, library)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return library


@functools.cache
def _library() -> Tuple[Optional[ctypes.CDLL], str]:
    """(the loaded library, "") or (None, why it is not there)."""
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError, subprocess.SubprocessError) as err:
        return None, f"{type(err).__name__}: {err}"
    c_int_p, c_float_p = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    signatures = {
        "mfsr_probe": [ctypes.c_char_p, c_int_p, c_int_p, c_int_p, c_int_p],
        "mfsr_read_image_f32": [ctypes.c_char_p, c_float_p, ctypes.c_int, ctypes.c_int, ctypes.c_int],
        "mfsr_read_burst_f32": [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, c_float_p,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int],
        "mfsr_read_raw_u16": [ctypes.c_char_p, c_float_p, ctypes.c_int, ctypes.c_int, ctypes.c_long,
                              ctypes.c_float],
    }
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib, ""


def available() -> bool:
    """Whether the library is built and loaded (building it at first call)."""
    return _library()[0] is not None


def build_error() -> str:
    """Why the library is not available ("" when it is)."""
    return _library()[1]


def _floats(out: np.ndarray):
    return out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def probe(path: str) -> Optional[Tuple[int, int, int, int]]:
    """(h, w, channels, bit_depth) from the file's header, or None without
    the library or on any failure."""
    lib = _library()[0]
    if lib is None:
        return None
    h, w, c, bits = (ctypes.c_int() for _ in range(4))
    if lib.mfsr_probe(os.fsencode(path), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c), ctypes.byref(bits)):
        return None
    return h.value, w.value, c.value, bits.value


def imread_native(path: str, gray: bool = False) -> Optional[np.ndarray]:
    """float32 in [0, 1], RGB (H, W, 3) or BT.601 luma (H, W) with
    ``gray``; None without the library or on any failure."""
    lib = _library()[0]
    info = probe(path)
    if lib is None or info is None:
        return None
    h, w = info[:2]
    out = np.empty((h, w, 1 if gray else 3), np.float32)
    if lib.mfsr_read_image_f32(os.fsencode(path), _floats(out), h, w, out.shape[-1]):
        return None
    return out[..., 0] if gray else out


def read_burst_native(paths: List[str]) -> Optional[np.ndarray]:
    """Threaded load of same-size frames -> (F, H, W, 3) float32; None
    without the library, on any failure, or if the frames' sizes differ."""
    lib = _library()[0]
    if lib is None or not paths:
        return None
    infos = [probe(p) for p in paths]
    if any(i is None or i[:2] != infos[0][:2] for i in infos):
        return None
    h, w = infos[0][:2]
    out = np.empty((len(paths), h, w, 3), np.float32)
    names = (ctypes.c_char_p * len(paths))(*(os.fsencode(p) for p in paths))
    if lib.mfsr_read_burst_f32(names, len(paths), _floats(out), h, w, 3):
        return None
    return out


def read_raw_u16(path: str, h: int, w: int, offset: int = 0, max_val: float = 65535.0) -> Optional[np.ndarray]:
    """Packed little-endian uint16 RAW at byte ``offset`` -> float32 (H, W)
    divided by ``max_val``; None without the library or on any failure."""
    lib = _library()[0]
    if lib is None:
        return None
    out = np.empty((h, w), np.float32)
    if lib.mfsr_read_raw_u16(os.fsencode(path), _floats(out), h, w, offset, max_val):
        return None
    return out
