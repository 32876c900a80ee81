"""Shot-gather store + native async block loader (counterpart of
``jets_tpu/utils/dataloader.py``).

Host-side data loading for block-distributed inversion (SURVEY §5:
"host-local data loading per shot-gather block"): observed data for many
shots rarely fits in device memory at once; the loader streams fixed-size
shot blocks from a raw on-disk store into host buffers on C++ background
threads (the port's copy of ``_dataloader.cpp``, built with g++ into
``jets_tpu_torch/_build/``) while the card computes, and with
``device_put=True`` the iterator hands them over as tensors on the device
(the card unless the caller asks for the CPU).

Falls back to ``numpy.memmap`` (synchronous) when no C++ toolchain exists
(:attr:`ShotGatherLoader.native` says which runs).

Store format, the JAX package's (each package reads the other's stores):
``<path>`` raw little-endian array data + ``<path>.json`` header with
shape/dtype/blocking.
"""
from __future__ import annotations

import ctypes
import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.spaces import resolve_device

__all__ = ["ShotGatherStore", "ShotGatherLoader"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    from .native import build_and_load

    src = os.path.join(os.path.dirname(__file__), "_dataloader.cpp")
    lib = build_and_load(src, "libjets_torch_loader")
    if lib is None:
        return None
    lib.jets_loader_open.restype = ctypes.c_void_p
    lib.jets_loader_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ]
    lib.jets_loader_next.restype = ctypes.c_int64
    lib.jets_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.jets_loader_close.restype = None
    lib.jets_loader_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


class ShotGatherStore:
    """Raw on-disk store of stacked shot gathers ``(nshots, *block_shape)``."""

    def __init__(self, path: str):
        self.path = path
        with open(path + ".json") as f:
            hdr = json.load(f)
        self.nshots = int(hdr["nshots"])
        self.block_shape = tuple(hdr["block_shape"])
        self.dtype = np.dtype(hdr["dtype"])
        self.block_bytes = int(
            np.prod(self.block_shape) * self.dtype.itemsize
        )

    @staticmethod
    def create(path: str, data) -> "ShotGatherStore":
        """Write a stacked (nshots, ...) array or tensor (on any device) to a
        new store."""
        a = (data.detach().cpu().numpy() if isinstance(data, torch.Tensor)
             else np.asarray(data))
        hdr = {
            "nshots": int(a.shape[0]),
            "block_shape": list(a.shape[1:]),
            "dtype": a.dtype.name,
        }
        with open(path, "wb") as f:
            f.write(np.ascontiguousarray(a).tobytes())
        with open(path + ".json", "w") as f:
            json.dump(hdr, f)
        return ShotGatherStore(path)


class ShotGatherLoader:
    """Iterate shot blocks of a store with native background prefetch.

    >>> store = ShotGatherStore.create("shots.bin", d_obs)
    >>> for idx, block in ShotGatherLoader(store, batch_shots=8, device_put=True):
    ...     r = F_blocks[idx](m) - block   # the block is already on the card

    With ``device_put=True`` each block comes out as
    ``torch.as_tensor(block, device=device)``: ``device=None`` is the card
    (and raises without one), ``device="cpu"`` keeps it on the host.
    """

    def __init__(self, store: ShotGatherStore, batch_shots: int = 1,
                 queue_depth: int = 4, device_put: bool = False, device=None):
        self.store = store
        self.batch = int(batch_shots)
        if store.nshots % self.batch:
            raise ValueError(
                f"batch_shots {self.batch} does not divide nshots {store.nshots}"
            )
        self.queue_depth = queue_depth
        self.device_put = device_put
        self.device = resolve_device(device) if device_put else None
        self._lib = _get_lib()

    @property
    def native(self) -> bool:
        return self._lib is not None

    def _out(self, a: np.ndarray):
        return torch.as_tensor(a, device=self.device) if self.device_put else a

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        st = self.store
        nblocks = st.nshots // self.batch
        blk_bytes = st.block_bytes * self.batch
        out_shape = (self.batch,) + st.block_shape
        if self._lib is not None:
            h = self._lib.jets_loader_open(
                st.path.encode(), blk_bytes, nblocks, self.queue_depth
            )
            if not h:
                raise OSError(f"cannot open store {st.path}")
            try:
                buf = ctypes.create_string_buffer(blk_bytes)
                while True:
                    idx = self._lib.jets_loader_next(h, buf)
                    if idx == -1:
                        break
                    if idx == -2:
                        raise IOError(f"short read in store {st.path}")
                    a = np.frombuffer(
                        buf.raw, dtype=st.dtype
                    ).reshape(out_shape).copy()
                    yield int(idx), self._out(a)
            finally:
                self._lib.jets_loader_close(h)
        else:  # synchronous memmap fallback
            mm = np.memmap(st.path, dtype=st.dtype, mode="r",
                           shape=(st.nshots,) + st.block_shape)
            for i in range(nblocks):
                a = np.array(mm[i * self.batch : (i + 1) * self.batch])
                yield i, self._out(a)
