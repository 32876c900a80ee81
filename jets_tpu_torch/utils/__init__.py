"""The port's ``utils`` layer (counterpart of ``jets_tpu/utils``): pytree
vector helpers (``tree``), CRC32C content hashing, npz checkpoint/resume,
the block-float snapshot codec and store, the shot-gather store and its
native prefetching loader, NaN/Inf guards and profiling. The native pieces
are the JAX package's C++ sources, copied, built with g++ into
``jets_tpu_torch/_build/`` at first use. The JAX package's orbax checkpoint
pair (sharded leaves) is not ported yet."""
from . import tree
from .checkpoint import load_checkpoint, save_checkpoint
from .compression import (
    SnapshotStore,
    compress_array,
    compression_ratio,
    decompress_array,
)
from .dataloader import ShotGatherLoader, ShotGatherStore
from .guards import assert_finite, checked
from .hashing import crc32c, tree_hash
from .profiling import instrument, op_cost, trace

__all__ = [
    "tree",
    "save_checkpoint",
    "load_checkpoint",
    "ShotGatherStore",
    "ShotGatherLoader",
    "SnapshotStore",
    "compress_array",
    "decompress_array",
    "compression_ratio",
    "checked",
    "assert_finite",
    "crc32c",
    "tree_hash",
    "instrument",
    "op_cost",
    "trace",
]
