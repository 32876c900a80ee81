"""Build and load the hand-written CUDA kernels of ``csrc/``.

The kernels are compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface and loaded with :mod:`ctypes` —
no PyTorch headers are compiled, so a build takes seconds. The library is
built at first use into ``jets_tpu_torch/_build/`` (git-ignored), under a
name keyed by a hash of the source, so an edited source is rebuilt and a
stale library is never loaded.

Nothing here runs at import time: importing the package needs neither
``nvcc`` nor a GPU. On a machine without CUDA the wrappers in
:mod:`jets_tpu_torch.ops.cuda_solver` only ever take their plain PyTorch
versions (for CPU tensors), and never reach :func:`load_library`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["has_cuda", "load_library", "check", "SOURCE", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "solver_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lib = None
build_seconds = None  # wall time of the build this process ran (None: cached)
build_log = None  # nvcc's output of that build (ptxas registers and spills)

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "jt_error_string": ([_INT], ctypes.c_char_p),
    "jt_lap3d_num_partials": ([_I64] * 3, _I64),
    "jt_xw_update": ([_P] * 6 + [_I64, _P], _INT),
    "jt_laplacian3d": ([_P, _P] + [_I64] * 3 + [_P], _INT),
    "jt_lap3d_axpy_norm2": ([_P] * 6 + [_I64] * 3 + [_P], _INT),
}


def has_cuda() -> bool:
    """True if PyTorch sees a CUDA device."""
    return torch.cuda.is_available()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _build(so: Path) -> None:
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    """The kernel library, built from :data:`SOURCE` on first use."""
    global _lib
    if _lib is None:
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        so = BUILD_DIR / f"solver_kernels_{digest}.so"
        if not so.is_file():
            _build(so)
        lib = ctypes.CDLL(str(so))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch)."""
    if err != 0:
        msg = load_library().jt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
