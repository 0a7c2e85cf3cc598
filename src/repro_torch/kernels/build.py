"""Kernel build: `nvcc` → one shared library per CUDA source, loaded with
ctypes.

Each `kernels/csrc/<name>.cu` has a plain C interface (no PyTorch headers),
so `nvcc` takes seconds per source. The libraries go into
``build/repro_torch/`` at the root of the checkout, named by a hash of the
sources and flags, and are built at first use: every missing library is
compiled at once, one `nvcc` process per source, all started together.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
SOURCES = ("ft_gemm", "ft_gemm_chain", "ft_gemm_sm90", "ft_gemm_level_sm90",
           "grouped_sm90", "flash_bwd_sm90",
           "flash_fwd_sm90", "flash_decode_sm90", "batched_sm90", "flash_ft",
           "flash_ft_bwd", "flash_decode", "tgmm", "gemm_naive")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float      # nvcc wall time; 0.0 when the library was cached
    log: str            # nvcc's output, including the -Xptxas -v lines


_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILDS: Dict[str, BuildResult] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU (CUDA toolkit on PATH or under "
                       "/usr/local/cuda)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, BuildResult]:
    """Build every library that is not on disk yet (in parallel) and
    return the build record of each."""
    with _LOCK:
        todo = [n for n in SOURCES if n not in _BUILDS]
        procs = {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for n in todo:
            path = _lib_path(n)
            if path.exists():
                _BUILDS[n] = BuildResult(n, path, 0.0, "")
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, path, time.perf_counter())
        failed = []
        for n, (proc, tmp, path, t0) in procs.items():
            log, _ = proc.communicate()
            dt = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, path)
            _BUILDS[n] = BuildResult(n, path, dt, log)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return {n: _BUILDS[n] for n in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``kernels/csrc/<name>.cu``, built on first use
    together with every other source."""
    lib = _LIBS.get(name)
    if lib is None:
        rec = build_all()[name]
        with _LOCK:
            lib = _LIBS.setdefault(name, ctypes.CDLL(str(rec.path)))
    return lib


def check_device(t) -> None:
    """The libraries link the CUDA runtime statically, so their launches go
    to CUDA device 0 of their own runtime; tensors elsewhere raise."""
    if t.device.type != "cuda" or t.device.index not in (None, 0):
        raise ValueError(f"the CUDA kernels run on cuda:0, got {t.device}")


class Kernel:
    """One C entry point of a kernel library and its launch counter.

    ``launches`` is a plain integer, raised by one for every launch that the
    CUDA runtime accepted, so a run can show that a path went through the
    kernel. The C function returns its ``cudaGetLastError()``; a nonzero
    code raises."""

    def __init__(self, lib: str, symbol: str, argtypes: Sequence):
        self.lib_name = lib
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None
        self._err = None

    def _bind(self):
        lib = library(self.lib_name)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{self.lib_name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def __call__(self, *args) -> None:
        if self._fn is None:
            self._bind()
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} "
                               f"({self._err(rc).decode()})")
        self.launches += 1


class LaunchTotal:
    """The sum of several kernels' launch counters: one function served by
    more than one instance (K1's 2-D total over its SIMT and tensor-core
    instances)."""

    def __init__(self, *kernels: Kernel):
        self.kernels = kernels

    @property
    def launches(self) -> int:
        return sum(k.launches for k in self.kernels)
