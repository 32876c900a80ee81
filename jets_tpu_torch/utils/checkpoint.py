"""Checkpoint / resume — solver-state and model-vector persistence
(counterpart of the npz pair of ``jets_tpu/utils/checkpoint.py``).

The reference has no in-repo checkpointing (SURVEY §5); its only germ is the
CRC32C content hash. The Krylov and nonlinear solver states
(:class:`~jets_tpu_torch.solvers.krylov.LSQRState` etc.) are NamedTuples of
tensors, so saving/restoring is pytree serialization plus an integrity hash,
and a restored state passes straight back into the solver's ``state=``
argument to resume.

:func:`save_checkpoint` writes one ``.npz`` file in the JAX package's
layout: ``leaf_<i>`` host arrays in flattening order, ``__treedef__`` (the
port's structure string, as bytes) and ``__meta__`` (JSON: the CRC32C
content hash of :func:`~.hashing.tree_hash` beside the caller's ``meta``),
written to a temporary file and moved into place. A leaf whose dtype numpy
lacks (bfloat16) is stored as the signed integers of its width, bit for bit.

:func:`save_checkpoint_orbax` / :func:`load_checkpoint_orbax` keep the
names of the JAX package's orbax pair for sharded leaves, but write and
read the directory format of :mod:`torch.distributed.checkpoint` (DCP), not
orbax's. A sharded leaf is a :class:`torch.distributed.tensor.DTensor`
(``ShardedSpace.to_dtensor`` of a rank's slab): every rank writes only its
slab of it; a tensor leaf is replicated and written once. On load the
``like`` leaves set the layout: a DTensor there receives its slabs whatever
world wrote them (DCP reads the chunks that overlap), a tensor the whole
array, so another world's checkpoint reshards as orbax does with ``like``'s
shardings.
"""
from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .hashing import tree_hash

__all__ = ["save_checkpoint", "load_checkpoint", "save_checkpoint_orbax",
           "load_checkpoint_orbax"]

_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _has_numpy_dtype(dtype: torch.dtype) -> bool:
    try:
        torch.empty(0, dtype=dtype).numpy()
        return True
    except TypeError:
        return False


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array with its bytes unchanged."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu().contiguous()
    if not _has_numpy_dtype(t.dtype):  # keep the bits as integers of its width
        t = t.view(_INT_OF_WIDTH[t.element_size()])
    return t.numpy()


def _restore(a: np.ndarray, like):
    """The stored array ``a`` as a leaf like ``like``: a tensor on ``like``'s
    device in its dtype (integers stored for a dtype numpy lacks are viewed
    back, anything else cast), a Python scalar of ``like``'s type, or the
    array itself."""
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.array(a))
        if not _has_numpy_dtype(like.dtype) and t.dtype == _INT_OF_WIDTH.get(
                like.element_size()):
            t = t.view(like.dtype)
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (bool, int, float, complex)):
        return type(like)(a.item())
    return a


def save_checkpoint(path: str, tree: Any, *, meta: dict | None = None) -> int:
    """Serialize a pytree (solver state, model vector, ...) to ``path``.

    Returns the CRC32C content hash stored alongside the data.
    """
    leaves = [leaf for leaf in pytree.tree_leaves(tree) if leaf is not None]
    spec = pytree.tree_structure(tree)
    h = tree_hash(tree)
    payload = {f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)}
    payload["__treedef__"] = np.frombuffer(str(spec).encode(), dtype=np.uint8)
    payload["__meta__"] = np.frombuffer(
        json.dumps({"crc32c": h, **(meta or {})}).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
    return h


def load_checkpoint(path: str, like: Any) -> Tuple[Any, dict]:
    """Restore a pytree saved by :func:`save_checkpoint`.

    ``like`` provides the pytree structure and, leaf by leaf, the device and
    dtype (e.g. the state of a short solve, or the previous state object).
    Returns ``(tree, meta)``; raises ``ValueError`` if the stored content
    hash does not match the restored data (corruption / dtype drift).
    """
    like_leaves, spec = pytree.tree_flatten(like)
    stored = [i for i, lk in enumerate(like_leaves) if lk is not None]
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        if n != len(stored):
            raise ValueError(f"checkpoint {path}: {n} leaves stored, "
                             f"{len(stored)} in the structure given")
        leaves = list(like_leaves)  # None stays None, as JAX stores no leaf for it
        for j, i in enumerate(stored):
            leaves[i] = _restore(z[f"leaf_{j}"], like_leaves[i])
    tree = pytree.tree_unflatten(leaves, spec)
    h = tree_hash(tree)
    if h != meta["crc32c"]:
        raise ValueError(
            f"checkpoint {path}: content hash mismatch "
            f"(stored {meta['crc32c']}, restored {h})"
        )
    return tree, meta


def _dcp_state(tree):
    """``(state dict, spec)``: the tree's leaves (``None`` left out) as
    ``leaf_<i>``, tensors on the host, and its structure string."""
    leaves, spec = pytree.tree_flatten(tree)
    state = {}
    for i, leaf in enumerate(leaves):
        if leaf is None:
            continue
        if isinstance(leaf, torch.Tensor) and not _is_dtensor(leaf):
            leaf = leaf.detach().cpu()
        state[f"leaf_{i}"] = leaf
    state["__treedef__"] = str(spec)
    return state, leaves, spec


def _in_group() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def save_checkpoint_orbax(path: str, tree: Any) -> None:
    """Save a pytree, possibly with SHARDED leaves, as a DCP directory
    checkpoint (:mod:`torch.distributed.checkpoint`'s format, not orbax's).
    A DTensor leaf is written slab by slab, each rank its own; a tensor leaf
    is the same on every rank and written once; ints and other Python
    values are pickled. Runs on every rank of the default group, or alone
    in a process without one. Restore with :func:`load_checkpoint_orbax`."""
    import torch.distributed.checkpoint as dcp

    state, _, _ = _dcp_state(tree)
    dcp.save(state, checkpoint_id=os.path.abspath(path), no_dist=not _in_group())


def load_checkpoint_orbax(path: str, like: Any) -> Any:
    """Restore a checkpoint written by :func:`save_checkpoint_orbax`.

    ``like`` supplies the structure and, leaf by leaf, the layout: a DTensor
    leaf is filled with its slab of the stored array (another world's slabs
    reshard), a tensor leaf with the whole array, on its device and in its
    dtype; a Python value is replaced by the stored one. Raises
    ``ValueError`` if the stored structure is not ``like``'s."""
    import torch.distributed.checkpoint as dcp

    state, leaves, spec = _dcp_state(like)
    want = state["__treedef__"]
    dcp.load(state, checkpoint_id=os.path.abspath(path), no_dist=not _in_group())
    if state["__treedef__"] != want:
        raise ValueError(f"checkpoint {path}: stored structure {state['__treedef__']} is "
                         f"not {want}")
    out = list(leaves)
    for i, lk in enumerate(leaves):
        if lk is None:
            continue
        v = state[f"leaf_{i}"]
        if isinstance(lk, torch.Tensor) and not _is_dtensor(lk):
            v = v.to(device=lk.device, dtype=lk.dtype)
        out[i] = v
    return pytree.tree_unflatten(out, spec)
