"""The port's ``utils`` layer (counterpart of ``jets_tpu/utils``): pytree
vector helpers (``tree``), CRC32C content hashing, npz checkpoint/resume,
the block-float snapshot codec and store, the shot-gather store and its
native prefetching loader, NaN/Inf guards and profiling. The native pieces
are the JAX package's C++ sources, copied, built with g++ into
``jets_tpu_torch/_build/`` at first use. The sharded checkpoint pair keeps
the JAX package's orbax names and writes ``torch.distributed.checkpoint``
directories."""
from . import tree
from .checkpoint import (load_checkpoint, load_checkpoint_orbax, save_checkpoint,
                         save_checkpoint_orbax)
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
    "save_checkpoint_orbax",
    "load_checkpoint_orbax",
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
