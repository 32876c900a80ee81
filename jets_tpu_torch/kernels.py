"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source in :data:`SOURCES` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library of its own with a plain C interface and
loaded with :mod:`ctypes` — no PyTorch headers are compiled, so a build
takes seconds. A library is built at first use into
``jets_tpu_torch/_build/`` (git-ignored), under a name keyed by a hash of
its source and the compiler flags, so an edited source is rebuilt and a
stale library is never loaded. :func:`build_all` starts one ``nvcc`` per
missing library, all at once, and waits for them.

Nothing here runs at import time: importing the package needs neither
``nvcc`` nor a GPU. On a machine without CUDA the wrappers in
:mod:`jets_tpu_torch.ops.cuda_solver`, :mod:`jets_tpu_torch.ops.cuda_wave`,
:mod:`jets_tpu_torch.ops.cuda_vti` and :mod:`jets_tpu_torch.ops.cuda_tti`
only ever take their plain PyTorch
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

__all__ = ["has_cuda", "load_library", "build_all", "nvcc_log", "check", "SOURCES", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent
SOURCES = {
    "solver": _PKG / "csrc" / "solver_kernels.cu",
    "wave": _PKG / "csrc" / "wave_kernels.cu",
    "vti": _PKG / "csrc" / "vti_kernels.cu",
    "tti": _PKG / "csrc" / "tti_kernels.cu",
}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: dict = {}
build_seconds: dict = {}  # library -> wall time of the build this process ran
build_log: dict = {}  # library -> nvcc's output of that build (ptxas registers, spills)

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "solver": {
        "jt_error_string": ([_INT], ctypes.c_char_p),
        "jt_lap3d_num_partials": ([_I64] * 3, _I64),
        "jt_xw_update": ([_P] * 6 + [_I64, _P], _INT),
        "jt_laplacian3d": ([_P, _P] + [_I64] * 3 + [_P], _INT),
        "jt_lap3d_axpy_norm2": ([_P] * 6 + [_I64] * 3 + [_P], _INT),
        "jt_cg_num_partials": ([_I64], _I64),
        "jt_cg_update": ([_P] * 7 + [_I64, _P], _INT),
        "jt_p_update": ([_P] * 3 + [_I64, _P], _INT),
        "jt_lsmr_update": ([_P] * 8 + [_I64, _P], _INT),
    },
    "wave": {
        "jt_error_string": ([_INT], ctypes.c_char_p),
        "jt_leapfrog_step": ([_P] * 8 + [_I64, _P] + [_I64] * 3 + [_INT, _P], _INT),
        "jt_adjoint_step": ([_P] * 11 + [_I64] * 3 + [_INT, _INT, _P], _INT),
        "jt_q_step": ([_P] * 9 + [_I64, _P] + [_I64] * 3 + [_INT, _INT, _P], _INT),
        "jt_leapfrog_step2d": ([_P, _I64] * 7 + [_P] + [_I64] * 3 + [_INT, _P], _INT),
        "jt_adjoint_step2d": ([_P, _I64] * 7 + [_P, _P] + [_I64] * 3 + [_INT, _INT, _P],
                              _INT),
        "jt_q_adjoint_step": ([_P] * 16 + [_I64] * 3 + [_INT] * 3 + [_P], _INT),
    },
    "vti": {
        "jt_error_string": ([_INT], ctypes.c_char_p),
        "jt_vti_num_partials": ([_I64] * 3, _I64),
        "jt_vti_step": ([_P] * 13 + [_I64] + [_P] * 2 + [_I64] * 3 + [_INT, _P], _INT),
        "jt_vti_hist_step": ([_P] * 15 + [_I64] + [_P] * 5 + [_I64] * 3
                             + [_INT, _INT, _P], _INT),
        "jt_vti_adjoint_step": ([_P] * 23 + [_I64] * 3 + [_INT, _INT, _P], _INT),
    },
    "tti": {
        "jt_error_string": ([_INT], ctypes.c_char_p),
        "jt_tti_num_partials": ([_I64] * 3, _I64),
        "jt_tti_smem_bytes": ([_INT, _INT], _I64),
        "jt_tti_step": ([_P] * 17 + [_I64] + [_P] * 2 + [_I64] * 3 + [_INT, _INT, _P],
                        _INT),
        "jt_tti_hist_step": ([_P] * 19 + [_I64] + [_P] * 5 + [_I64] * 3
                             + [_INT, _INT, _INT, _P], _INT),
        "jt_tti_adjoint_step": ([_P] * 33 + [_I64] * 3 + [_INT, _INT, _INT, _P], _INT),
    },
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


def _so_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{SOURCES[name].stem}_{h.hexdigest()[:16]}.so"


def build_all(names=None) -> None:
    """Build every missing library of ``names`` (default: all), one
    ``nvcc`` process per source, started together."""
    names = list(SOURCES) if names is None else list(names)
    todo = [(n, _so_path(n)) for n in names]
    todo = [(n, so) for n, so in todo if not so.is_file()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for n, so in todo:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs.append((n, so, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, so, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        build_seconds[n] = time.perf_counter() - t0
        build_log[n] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        else:
            so.with_suffix(".log").write_text(out)
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))


def nvcc_log(name: str) -> str:
    """nvcc's output of the build of the current ``SOURCES[name]`` library
    (ptxas registers, spills, shared memory), whichever process built it;
    empty if it was built without one."""
    if name in build_log:
        return build_log[name]
    log = _so_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load_library(name: str = "solver") -> ctypes.CDLL:
    """The kernel library built from ``SOURCES[name]``, built on first use."""
    if name not in _libs:
        so = _so_path(name)
        if not so.is_file():
            build_all([name])
        lib = ctypes.CDLL(str(so))
        for fname, (argtypes, restype) in _SIGNATURES[name].items():
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = restype
        _libs[name] = lib
    return _libs[name]


def check(err: int, name: str, library: str = "solver") -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch)."""
    if err != 0:
        msg = load_library(library).jt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
