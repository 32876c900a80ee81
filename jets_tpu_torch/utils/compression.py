"""Lossy wavefield compression — the reference family's CvxCompress slot
(counterpart of ``jets_tpu/utils/compression.py``, byte for byte).

JetPackWaveFD's production propagators serialize the nonlinear forward
wavefield with a lossy C++ wavelet compressor so the Born/adjoint pass can
re-read it instead of recomputing or holding it raw; ``remat_blocks`` is
the recompute-based answer, and THIS module is the serialization-based one:
fixed-rate block-floating-point quantization of f32 snapshots (the port's
copy of the native C++ ``_compress.cpp``, built with g++ into
``jets_tpu_torch/_build/``, and a byte-identical pure-numpy fallback;
:func:`native` says which runs), plus :class:`SnapshotStore`, an
append/read store for forward snapshots in an FWI/RTM loop (disk- or
memory-backed). The format and the store files are the JAX package's, so
each package reads what the other writes, and so are the bytes, but for
blocks whose max |x| is below ``qmax / FLT_MAX`` (``(x / max) * qmax``
here; the JAX package's ``qmax / max`` overflows there, and its native
code and numpy fallback round the inf differently).

A tensor on any device is accepted: it is copied to the host, then
encoded. :func:`decompress_array` and :meth:`SnapshotStore.read` return
numpy, as in the JAX package.

Rate/accuracy: ``bits=b`` gives ~``32/b``× compression (256-value blocks
add one f32 scale each, ~1.6% overhead) and ~``6·(b−2)`` dB SNR against
the block dynamic range — bits=12 ≈ 2.7× at ~60 dB, the regime seismic
imaging uses in practice (CvxCompress defaults to similar rates).
"""
from __future__ import annotations

import ctypes
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["compress_array", "decompress_array", "compression_ratio",
           "SnapshotStore", "native"]

_BLK = 256
_BITS = (4, 8, 12, 16)
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    from .native import build_and_load

    src = os.path.join(os.path.dirname(__file__), "_compress.cpp")
    lib = build_and_load(src, "libjets_torch_compress",
                         extra_flags=("-ffp-contract=off",))
    if lib is None:
        return None
    lib.jets_compress_bound.restype = ctypes.c_int64
    lib.jets_compress_bound.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.jets_compress_f32.restype = ctypes.c_int64
    lib.jets_compress_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.jets_decompress_f32.restype = None
    lib.jets_decompress_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    _LIB = lib
    return _LIB


def native() -> bool:
    """Whether the codec runs the native library (else the numpy fallback,
    with the same bytes)."""
    return _get_lib() is not None


def _host_f32(a) -> np.ndarray:
    """``a`` (a tensor on any device, or anything numpy takes) as a flat,
    contiguous float32 host array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to(device="cpu", dtype=torch.float32).contiguous().numpy()
    return np.ascontiguousarray(np.asarray(a), np.float32).ravel()


def _check_bits(bits: int) -> int:
    if bits not in _BITS:
        raise ValueError(f"bits must be one of {_BITS}, got {bits}")
    return int(bits)


def _pack_np(q: np.ndarray, bits: int) -> np.ndarray:
    """Pack unsigned ``bits``-wide ints (uint32) little-endian."""
    m = q.shape[0]
    if bits == 8:
        return q.astype(np.uint8)
    if bits == 16:
        return q.astype("<u2").view(np.uint8)
    if bits == 4:
        if m % 2:
            q = np.concatenate([q, np.zeros(1, np.uint32)])
        return (q[0::2] | (q[1::2] << 4)).astype(np.uint8)
    # 12: spread each value's 3 bytes at its bit offset and OR-reduce
    nb = (m * 12 + 7) // 8
    out = np.zeros(nb + 2, np.uint32)  # +2 slack for the last spans
    bitpos = np.arange(m, dtype=np.int64) * 12
    byte = bitpos >> 3
    off = (bitpos & 7).astype(np.uint32)
    v = q << off
    np.bitwise_or.at(out, byte, v & 0xFF)
    np.bitwise_or.at(out, byte + 1, (v >> 8) & 0xFF)
    np.bitwise_or.at(out, byte + 2, (v >> 16) & 0xFF)
    return out[:nb].astype(np.uint8)


def _unpack_np(p: np.ndarray, m: int, bits: int) -> np.ndarray:
    if bits == 8:
        return p[:m].astype(np.int32)
    if bits == 16:
        return p[: 2 * m].view("<u2").astype(np.int32)
    if bits == 4:
        b = p[: (m + 1) // 2]
        u = np.empty(2 * b.shape[0], np.int32)
        u[0::2] = b & 0xF
        u[1::2] = b >> 4
        return u[:m]
    nb = (m * 12 + 7) // 8
    buf = np.zeros(nb + 2, np.uint32)
    buf[:nb] = p[:nb]
    bitpos = np.arange(m, dtype=np.int64) * 12
    byte = bitpos >> 3
    off = (bitpos & 7).astype(np.uint32)
    v = buf[byte] | (buf[byte + 1] << 8) | (buf[byte + 2] << 16)
    return ((v >> off) & 0xFFF).astype(np.int32)


def _compress_np(x: np.ndarray, bits: int) -> bytes:
    qmax = (1 << (bits - 1)) - 1
    chunks = []
    for b0 in range(0, x.shape[0], _BLK):
        blk = x[b0:b0 + _BLK]
        maxv = np.float32(np.max(np.abs(blk))) if blk.size else np.float32(0)
        with np.errstate(over="ignore"):
            scale = np.float32(qmax) / maxv if maxv > 0 else np.float32(0)
        inv_scale = maxv / np.float32(qmax) if maxv > 0 else np.float32(0)
        # a block below qmax / FLT_MAX scales as (x / max) * qmax (see
        # _compress.cpp), where blk * scale would be inf or NaN
        v = (blk / maxv) * np.float32(qmax) if np.isinf(scale) else blk * scale
        q = np.clip(np.rint(v).astype(np.int32), -qmax, qmax)
        chunks.append(np.float32(inv_scale).tobytes())
        chunks.append(_pack_np((q + qmax).astype(np.uint32), bits).tobytes())
    return b"".join(chunks)


def _decompress_np(buf: np.ndarray, n: int, bits: int) -> np.ndarray:
    qmax = (1 << (bits - 1)) - 1
    out = np.empty(n, np.float32)
    pos = 0
    for b0 in range(0, n, _BLK):
        m = min(_BLK, n - b0)
        inv_scale = buf[pos:pos + 4].view(np.float32)[0]
        pos += 4
        nb = (m * bits + 7) // 8
        q = _unpack_np(buf[pos:pos + nb], m, bits)
        pos += nb
        out[b0:b0 + m] = (q - qmax).astype(np.float32) * inv_scale
    return out


def compression_ratio(n: int, bits: int) -> float:
    """Achieved ratio raw/compressed for ``n`` f32 values."""
    nblk = (n + _BLK - 1) // _BLK
    return (4.0 * n) / (4.0 * nblk + (n * bits + 7) // 8)


def compress_array(a, bits: int = 12) -> bytes:
    """Compress a float32 array or tensor (on any device: copied to the host
    first) to block-float bytes (native C++ when the toolchain exists, numpy
    otherwise — identical bytes either way)."""
    bits = _check_bits(bits)
    x = _host_f32(a)
    lib = _get_lib()
    if lib is not None:
        bound = lib.jets_compress_bound(x.size, bits)
        out = np.empty(bound, np.uint8)
        nw = lib.jets_compress_f32(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.size, bits,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out[:nw].tobytes()
    return _compress_np(x, bits)


def decompress_array(buf: bytes, shape: Sequence[int],
                     bits: int = 12) -> np.ndarray:
    """Inverse of :func:`compress_array`; returns float32 of ``shape``."""
    bits = _check_bits(bits)
    n = int(np.prod(shape)) if len(shape) else 1
    src = np.frombuffer(buf, np.uint8)
    lib = _get_lib()
    if lib is not None:
        out = np.empty(n, np.float32)
        lib.jets_decompress_f32(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, bits,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out.reshape(shape)
    return _decompress_np(src, n, bits).reshape(shape)


class SnapshotStore:
    """Append/read store for compressed forward-wavefield snapshots.

    The serialization half of the adjoint-state memory trade
    (``remat_blocks`` is the recompute half): append each forward snapshot
    during modeling, read them back (in any order) during the
    imaging/adjoint sweep. ``path=None`` keeps the compressed bytes in
    host memory; with a path, snapshots stream to one flat file +
    ``<path>.json`` header (same convention as ``ShotGatherStore``).

    >>> store = SnapshotStore(shape=u.shape, bits=12)
    >>> for t in range(nt):
    ...     u = step(u); store.append(u)
    >>> u_hat_t = store.read(t)
    """

    def __init__(self, shape: Sequence[int], bits: int = 12,
                 path: Optional[str] = None):
        self.shape = tuple(int(s) for s in shape)
        self.bits = _check_bits(bits)
        self.path = path
        self._offsets = [0]
        self._mem = [] if path is None else None
        self._f = open(path, "wb+") if path is not None else None

    def __len__(self) -> int:
        return len(self._offsets) - 1

    @property
    def nbytes(self) -> int:
        return self._offsets[-1]

    @property
    def ratio(self) -> float:
        n = int(np.prod(self.shape))
        return len(self) * 4.0 * n / max(self.nbytes, 1)

    def append(self, a) -> int:
        shape = tuple(a.shape) if isinstance(a, torch.Tensor) else np.asarray(a).shape
        if shape != self.shape:
            raise ValueError(f"snapshot shape {shape} != {self.shape}")
        buf = compress_array(a, self.bits)
        if self._mem is not None:
            self._mem.append(buf)
        else:
            self._f.seek(self._offsets[-1])
            self._f.write(buf)
        self._offsets.append(self._offsets[-1] + len(buf))
        return len(self) - 1

    def read(self, i: int) -> np.ndarray:
        if not -len(self) <= i < len(self):
            raise IndexError(i)
        i = i % len(self)
        if self._mem is not None:
            buf = self._mem[i]
        else:
            self._f.seek(self._offsets[i])
            buf = self._f.read(self._offsets[i + 1] - self._offsets[i])
        return decompress_array(buf, self.shape, self.bits)

    def close(self) -> None:
        if self._f is not None:
            with open(self.path + ".json", "w") as f:
                json.dump({"shape": list(self.shape), "bits": self.bits,
                           "offsets": self._offsets}, f)
            self._f.close()
            self._f = None

    @staticmethod
    def open(path: str) -> "SnapshotStore":
        """Re-open a closed disk-backed store for reading."""
        with open(path + ".json") as f:
            hdr = json.load(f)
        st = SnapshotStore.__new__(SnapshotStore)
        st.shape = tuple(hdr["shape"])
        st.bits = int(hdr["bits"])
        st.path = path
        st._offsets = list(hdr["offsets"])
        st._mem = None
        st._f = open(path, "rb")
        return st
