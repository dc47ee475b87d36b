"""Native host-side kernels (C++, loaded with ctypes).

The serial algorithm the reference implements in C++ that does not map to
data-parallel execution, the heap-based fast march (``fastmarch.cpp``, a
byte-for-byte copy of the JAX package's), is C++ here too. It is compiled
with ``g++ -O2 -shared -fPIC`` on first use into
``build/native/libfastmarch-<hash>.so`` at the repository root, beside
``kernels/_build.py``'s ``build/torch_kernels`` (the hash covers the
source and the flags, so an edited source is rebuilt). Nothing is built at
import, and nothing is built into the package. A failed build or load
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fastmarch.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_LIB = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libfastmarch-{digest[:12]}.so"


def build() -> Path:
    """Compile the fast march unless it is built; returns the library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o",
                               str(tmp)], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native fastmarch: g++ not runnable: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError("native fastmarch: g++ failed:\n" + proc.stderr)
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use. Raises when it cannot be
    built or loaded."""
    global _LIB
    if _LIB is None:
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"native fastmarch: cannot load {path}: "
                               f"{e}") from e
        lib.mtpu_reinit_march.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.mtpu_reinit_march.restype = None
        _LIB = lib
    return _LIB


def reinit_march(phi, flags, vel=None, max_time: float = 4.0,
                 ignore_walls: bool = False, correct_outer_layer: bool = True,
                 obstacle_type: int = 2):
    """Reference-exact reinitMarching (levelset.cpp:120-229 doReinitMarch).

    phi [z,y,x] float32, flags [z,y,x] int32, vel (3,z,y,x) float32 or
    None, as numpy arrays (or tensors, read on the host). Returns (phi,
    vel) as new numpy arrays."""
    lib = get_lib()
    phi = np.ascontiguousarray(np.asarray(phi, np.float32)).copy()
    flags = np.ascontiguousarray(np.asarray(flags, np.int32))
    sz, sy, sx = phi.shape
    is3d = 1 if sz > 1 else 0
    if vel is not None:
        vel = np.ascontiguousarray(np.asarray(vel, np.float32)).copy()
        vptr = vel.ctypes.data_as(ctypes.c_void_p)
    else:
        vptr = ctypes.c_void_p(0)
    lib.mtpu_reinit_march(
        phi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vptr, sx, sy, sz, is3d, float(max_time),
        1 if ignore_walls else 0, 1 if correct_outer_layer else 0,
        int(obstacle_type))
    return phi, vel
