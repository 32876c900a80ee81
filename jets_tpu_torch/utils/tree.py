"""Vector helpers used by the Krylov solvers (counterpart of
``jets_tpu/utils/tree.py``): elementwise arithmetic over tensors or nested
containers of tensors, via :mod:`torch.utils._pytree`. Inner products and
norms belong to the owning space."""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

__all__ = ["tmap", "add", "sub", "scale", "axpy", "xpay", "zeros_like"]


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
