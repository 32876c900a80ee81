"""Model-content hashing — CRC32C over tensor bytes (counterpart of
``jets_tpu/utils/hashing.py``).

Reference: the ``CRC32c.crc32c`` overload for Float32/64/Complex model arrays
("for hashing models", ``src/Jets.jl:1284-1286``), used to cache/validate
model vectors across runs. Here the hash walks any pytree of tensors
(plain tensors, BlockVectors, solver states) deterministically.

Backend: the port's copy of the native C++ CRC32C (``_crc32c.cpp``), built
once with g++ into ``jets_tpu_torch/_build/`` (SSE4.2 hardware CRC when
available) and loaded via ctypes; a pure-Python implementation with the
same values if no compiler is present (:func:`native` says which).

:func:`crc32c` gives the JAX package's values on the same bytes, and a
leaf's bytes are its raw memory (a bfloat16 tensor's are JAX's bfloat16
bytes). :func:`tree_hash` chains a CRC of the port's own structure string
(``torch.utils._pytree``'s spec), which JAX's ``repr(treedef)`` is not, so
tree hashes do not compare across the two packages; the leaf chain after
it does.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ["crc32c", "tree_hash", "native"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_lib() -> Optional[ctypes.CDLL]:
    from .native import build_and_load

    src = os.path.join(os.path.dirname(__file__), "_crc32c.cpp")
    lib = build_and_load(src, "libjets_torch_crc32c", optional_flags=("-msse4.2",),
                         timeout=120)
    if lib is None:
        return None
    lib.jets_crc32c.restype = ctypes.c_uint32
    lib.jets_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _LIB = _build_lib()
        _TRIED = True
    return _LIB


def native() -> bool:
    """Whether :func:`crc32c` runs the native library (else the Python
    fallback, with the same values)."""
    return _get_lib() is not None


# pure-python fallback (slice-by-1 table CRC32C)
_PY_TABLE = None


def _py_table():
    global _PY_TABLE
    if _PY_TABLE is None:
        poly = 0x82F63B78
        tbl = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            tbl.append(crc)
        _PY_TABLE = tbl
    return _PY_TABLE


def crc32c(data: bytes, seed: int = 0) -> int:
    """CRC32C of a byte string."""
    lib = _get_lib()
    if lib is not None:
        return int(lib.jets_crc32c(data, len(data), seed & 0xFFFFFFFF))
    tbl = _py_table()
    crc = ~seed & 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ tbl[(crc ^ b) & 0xFF]
    return (~crc) & 0xFFFFFFFF


def _leaf_bytes(x) -> bytes:
    """The raw bytes of a leaf: a tensor copied to the host, made contiguous
    and viewed as bytes (so a dtype numpy lacks, such as bfloat16, hashes
    too), anything else through :func:`numpy.asarray` as the JAX package
    takes it."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def tree_hash(tree) -> int:
    """Deterministic CRC32C content hash of any pytree of tensors (models,
    BlockVectors, solver states): a CRC of the structure string, then each
    leaf's bytes chained in flattening order, so structure changes also
    change the hash."""
    leaves, spec = pytree.tree_flatten(tree)
    h = crc32c(str(spec).encode())
    for leaf in leaves:
        if leaf is not None:  # a leaf here, an empty subtree to JAX: no bytes
            h = crc32c(_leaf_bytes(leaf), seed=h)
    return h
