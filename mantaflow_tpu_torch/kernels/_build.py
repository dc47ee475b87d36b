"""Builds the CUDA sources in ``mantaflow_tpu_torch/csrc`` and loads them.

Each ``csrc/<name>.cu`` exports plain C launch functions. It is compiled by
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/lib<name>-<hash>.so`` at
the repository root (the hash covers the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source is rebuilt) and loaded with
``ctypes``. Nothing here runs at import:
the first call of a kernel wrapper builds its library, and ``build()``
compiles several sources in parallel, one ``nvcc`` process each.

Counters (``utils/trace.py``): ``kernels.compiles`` (``nvcc`` processes),
``kernels.nvcc_s`` (seconds waiting for them) and ``kernels.build_s`` (the
rest of ``build()`` and ``load()``: hashing the sources, loading the
libraries; the same work whether or not ``nvcc`` had to run).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..utils import trace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("window_advect", "cg_solve", "extrap_layer", "rebin",
           "advect_bucket", "p2g_levelset", "p2g_mac", "union_levelset",
           "flip_blend", "rebin_zshard", "rebin_fused")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# the FLIP kernels and the window advection keep their plain versions'
# rounding: no a*b+c contracted into one fused multiply-add (the window
# advection's z-slab instance equals its one-domain instance bit for bit
# whatever the compiler makes of either)
EXTRA_FLAGS = {name: ("-fmad=false",) for name in
               ("window_advect", "extrap_layer", "advect_bucket",
                "p2g_levelset", "p2g_mac", "union_levelset", "flip_blend")}

# the shared memory one block may opt in to on an H100 (227 KB); the launch
# plans of the kernels that stage in shared memory fit within it
SMEM_OPTIN_BYTES = 232448

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return found


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile the named sources that are not built yet, all at once.

    Returns each compiled source's compiler log (``ptxas`` register and
    shared-memory use). Raises if any compile fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    t_nvcc = time.perf_counter()
    trace.count("kernels.build_s", t_nvcc - t0)
    if not todo:
        return {}
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        trace.count("kernels.compiles")
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp, library_path(n))
    trace.count("kernels.nvcc_s", time.perf_counter() - t_nvcc)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        build([name])
        t0 = time.perf_counter()
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
        trace.count("kernels.build_s", time.perf_counter() - t0)
    return _loaded[name]


@contextlib.contextmanager
def caller_device():
    """Gives the caller its current CUDA device back after a launch: each
    export selects its tensors' device with ``cudaSetDevice``, which
    PyTorch's current device follows."""
    prev = torch.cuda.current_device()
    try:
        yield
    finally:
        torch.cuda.set_device(prev)


@functools.cache
def launcher(name: str, argtypes: tuple):
    """A function that launches ``csrc/<name>.cu``'s kernel through its
    ``<name>_launch(*argtypes)`` export and raises if the launch was
    refused (the export returns ``cudaGetLastError()``)."""
    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    err_str = getattr(lib, f"{name}_error_string")
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p

    def launch(*args):
        with caller_device():
            err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: "
                               + err_str(err).decode())
    return launch
