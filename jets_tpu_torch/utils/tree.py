"""Vector helpers used by the solvers (counterpart of
``jets_tpu/utils/tree.py``): elementwise arithmetic over tensors or nested
containers of tensors, via :mod:`torch.utils._pytree`, and
:func:`ravel_pytree`, the counterpart of ``jax.flatten_util.ravel_pytree``.
Inner products and norms belong to the owning space."""
from __future__ import annotations

import functools

import torch
from torch.utils import _pytree as pytree

__all__ = ["tmap", "add", "sub", "scale", "axpy", "xpay", "zeros_like", "ravel_pytree"]


def tmap(fn, *trees):
    return pytree.tree_map(fn, *trees)


def add(x, y):
    return tmap(lambda a, b: a + b, x, y)


def sub(x, y):
    return tmap(lambda a, b: a - b, x, y)


def scale(a, x):
    return tmap(lambda v: a * v, x)


def axpy(a, x, y):
    """a*x + y."""
    return tmap(lambda xi, yi: a * xi + yi, x, y)


def xpay(x, a, y):
    """x + a*y."""
    return tmap(lambda xi, yi: xi + a * yi, x, y)


def zeros_like(x):
    return tmap(torch.zeros_like, x)


def ravel_pytree(tree):
    """``(flat, unravel)``: the leaves of ``tree`` (a tensor, a
    :class:`~jets_tpu_torch.core.blockspace.BlockVector`, or a tuple or list
    of them) raveled and concatenated into one 1-D tensor of their promoted
    dtype, and the inverse, which casts each piece back to its leaf's dtype.
    Leaves go in :func:`torch.utils._pytree.tree_flatten` order, which for
    these types is ``jax.flatten_util.ravel_pytree``'s (a BlockVector's
    blocks in block order); dict leaves follow insertion order, where JAX
    sorts the keys."""
    leaves, spec = pytree.tree_flatten(tree)
    if not leaves:
        return torch.zeros(0), lambda flat: pytree.tree_unflatten([], spec)
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in leaves))
    shapes = [t.shape for t in leaves]
    sizes = [t.numel() for t in leaves]
    dtypes = [t.dtype for t in leaves]
    flat = torch.cat([t.reshape(-1).to(dtype) for t in leaves])

    def unravel(flat):
        parts = torch.split(flat, sizes)
        return pytree.tree_unflatten(
            [p.reshape(sh).to(dt) for p, sh, dt in zip(parts, shapes, dtypes)], spec)

    return flat, unravel
