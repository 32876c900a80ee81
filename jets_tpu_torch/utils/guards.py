"""Numerical sanity guards — the framework's "sanitizer" layer
(counterpart of ``jets_tpu/utils/guards.py``).

The reference has no race detection or sanitizers (single-threaded pure
Julia; SURVEY §5) — correctness is guarded mathematically by the gates. A
NaN born inside a long Krylov loop on the card silently poisons everything
downstream, so there is an explicit guard layer:

* :func:`checked` wraps any operator so every forward, tangent and adjoint
  (stated or derived) checks its output for NaN/Inf and raises
  ``FloatingPointError("non-finite output of <name>.forward")`` (or
  ``.tangent``, ``.adjoint``), the JAX package's message. PyTorch has no
  checkify: the check is eager, one ``isfinite().all()`` reduction per
  output leaf and one host read per apply, a sync of the card that suits
  debugging runs, not production ones. Under ``torch.func.grad``/``vjp``/
  ``jvp`` the values are concrete and the check runs; under
  ``torch.func.vmap`` no data-dependent ``bool`` can be taken, so the
  check is skipped inside the vmapped function (the apply outside the
  transform is still checked).
* :func:`assert_finite` validates any pytree eagerly (host-side).

Wrap operators with ``checked`` in debugging runs; production runs use the
raw operators (zero overhead).
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from ..core.jet import AdjointOperator, Jet, Operator

__all__ = ["checked", "assert_finite"]


def assert_finite(tree, name: str = "value") -> None:
    """Host-side finiteness check of every leaf (eager; forces a sync)."""
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        t = torch.as_tensor(leaf.detach() if isinstance(leaf, torch.Tensor) else leaf)
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"{name}{pytree.keystr(path)} contains NaN/Inf")


def _all_finite(leaf: torch.Tensor):
    """``isfinite(leaf).all()`` as a Python bool, or None inside
    ``torch.func.vmap``, where a data-dependent bool cannot be taken."""
    ok = torch.isfinite(leaf).all()
    try:
        return bool(ok)
    except RuntimeError as e:
        if "data-dependent control flow" in str(e):
            return None
        raise


def _check(x, tag):
    for leaf in pytree.tree_leaves(x):
        if isinstance(leaf, torch.Tensor) and _all_finite(leaf) is False:
            raise FloatingPointError(f"non-finite output of {tag}")
    return x


def _derived_adjoint(df, dom):
    """The adjoint derived from the unchecked tangent ``df`` as
    :class:`~jets_tpu_torch.core.jet.Jet` derives it (the vjp of the linear
    tangent map at a zero primal, made contiguous)."""
    def dft(dd, m0, state):
        _, vjp = torch.func.vjp(lambda dm: df(dm, m0, state), dom.zeros())
        (out,) = vjp(dd)
        return out.contiguous() if isinstance(out, torch.Tensor) else out

    return dft


def checked(op: Operator, name: str = "operator") -> Operator:
    """Return an operator whose forward/tangent/adjoint outputs are checked
    for NaN/Inf on every apply (see the module docstring)::

        checked(A, "A")(m)   # raises FloatingPointError naming A.forward
    """
    if isinstance(op, AdjointOperator):
        raise TypeError("wrap the underlying operator, not its adjoint")
    j = op.jet

    def f(m, state, __f=j.f):
        return _check(__f(m, state), f"{name}.forward")

    def df(dm, m0, state, __df=j.df):
        return _check(__df(dm, m0, state), f"{name}.tangent")

    inner = j.dft if j.dft is not None else _derived_adjoint(j.df, j.dom)

    def dft(dd, m0, state, __dft=inner):
        return _check(__dft(dd, m0, state), f"{name}.adjoint")

    new_jet = Jet(
        dom=j.dom, rng=j.rng, f=f, df=df, dft=dft, upstate=j.upstate,
        m0=j.m0, state=j.state, perfstat=j.perfstat_fn, close=j.close_fn,
    )
    return type(op)(new_jet)
