"""The jet core — L1 (counterpart of ``jets_tpu/core/jet.py``).

A *jet* is a function together with a linearization point: forward map
``f``, tangent map ``df`` (the Jacobian action at ``m0``) and adjoint
tangent map ``dft``. Kernel signatures are those of the JAX package:

* forward:  ``f(m, state) -> d``
* tangent:  ``df(dm, m0, state) -> dd``
* adjoint:  ``dft(dd, m0, state) -> dm``
* state refresh: ``upstate(m0, state) -> dict`` merged into state

Jets and operators are immutable: ``at``/``linearize``/``with_state``
return new objects. A missing ``dft`` is derived from ``df`` with
:func:`torch.func.vjp`, which for a linear map returns the conjugate
transpose directly (also for complex spaces); ``dft="self"`` marks an
operator as self-adjoint. Operators are plain Python objects holding
tensors — PyTorch runs eagerly, so nothing has to be registered as a
pytree.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .spaces import Space

__all__ = [
    "Jet",
    "Operator",
    "LinearOperator",
    "AdjointOperator",
    "jet_of",
    "point",
    "linearize",
    "jacobian",
    "adjoint",
    "state",
    "with_state",
    "perfstat",
    "close",
]


class Jet:
    """Immutable (function, linearization point) record.

    Defaulting rules of the JAX package: no ``f`` ⇒ linear (``f`` = ``df``);
    no ``df`` ⇒ ``f`` is linear and is its own tangent; ``dft=None`` ⇒
    derived by ``torch.func.vjp``; ``dft="self"`` ⇒ self-adjoint.
    """

    __slots__ = ("dom", "rng", "f", "df", "dft", "upstate", "m0", "_state",
                 "perfstat_fn", "close_fn")

    def __init__(
        self,
        *,
        dom: Space,
        rng: Space,
        f: Optional[Callable] = None,
        df: Optional[Callable] = None,
        dft: Any = None,
        upstate: Optional[Callable] = None,
        m0: Any = None,
        state: Optional[Dict[str, Any]] = None,
        perfstat: Optional[Callable] = None,
        close: Optional[Callable] = None,
    ):
        if f is None and df is None:
            raise ValueError("Jet needs at least one of f (forward) / df (tangent)")
        if f is None:
            f = _linear_forward_from_df(df)
        if df is None:
            df = _tangent_from_linear_f(f)
        if dft == "self":
            dft = _self_adjoint_from_df(df)
        sset = object.__setattr__
        sset(self, "dom", dom)
        sset(self, "rng", rng)
        sset(self, "f", f)
        sset(self, "df", df)
        sset(self, "dft", dft)  # None => derived with torch.func.vjp
        sset(self, "upstate", upstate)
        sset(self, "m0", m0)
        sset(self, "_state", dict(state or {}))
        sset(self, "perfstat_fn", perfstat)
        sset(self, "close_fn", close)

    def __setattr__(self, *a):  # pragma: no cover - defensive
        raise AttributeError("Jet is immutable; use at()/with_state()")

    @property
    def state(self) -> Dict[str, Any]:
        return dict(self._state)

    def replace(self, **kw) -> "Jet":
        cfg = dict(
            dom=self.dom, rng=self.rng, f=self.f, df=self.df, dft=self.dft,
            upstate=self.upstate, m0=self.m0, state=self._state,
            perfstat=self.perfstat_fn, close=self.close_fn,
        )
        cfg.update(kw)
        return Jet(**cfg)

    def at(self, m0) -> "Jet":
        """A new jet pinned at ``m0``; runs the ``upstate`` hook."""
        s = self._state
        if self.upstate is not None:
            s = {**s, **self.upstate(m0, dict(s))}
        return self.replace(m0=m0, state=s)

    def apply_f(self, m):
        return self.f(m, dict(self._state))

    def apply_df(self, dm):
        return self.df(dm, self.m0, dict(self._state))

    def apply_dft(self, dd):
        if self.dft is not None:
            return self.dft(dd, self.m0, dict(self._state))
        return self._transpose_apply(dd)

    def _transpose_apply(self, dd):
        """Adjoint derived from ``df``: the vjp of the linear tangent map at
        a zero primal is ``df^H dd`` (PyTorch's complex vjp convention
        conjugates, so no wrapping is needed). The result is made
        contiguous (a vjp through an FFT returns a strided view), as the
        solver kernels take contiguous members only."""
        m0, st = self.m0, dict(self._state)
        _, vjp = torch.func.vjp(lambda dm: self.df(dm, m0, st), self.dom.zeros())
        (out,) = vjp(dd)
        return out.contiguous() if isinstance(out, torch.Tensor) else out

    def __repr__(self) -> str:
        return f"Jet({self.dom} -> {self.rng})"


# the derived kernels name what they derive from, so that two operators
# built alike compare alike (parallel/hetero._structure_key)
def _linear_forward_from_df(df):
    def f(m, state, __df=df):
        return __df(m, None, state)

    f.__wrapped_df__ = df
    return f


def _tangent_from_linear_f(f):
    def df(dm, m0, state, __f=f):
        return __f(dm, state)

    df.__wrapped_f__ = f
    return df


def _self_adjoint_from_df(df):
    def dft(dd, m0, state, __df=df):
        return __df(dd, m0, state)

    dft.__self_adjoint_from__ = df
    return dft


class Operator:
    """A (possibly nonlinear) operator wrapping a jet.

    Apply with ``A(m)`` or ``A @ m``; ``A @ B`` composes when ``B`` is an
    operator or a raw 2-D matrix that is not shaped like a domain member. ``linearize(A, m0)`` returns a new pinned
    :class:`LinearOperator`.
    """

    __slots__ = ("jet",)

    def __init__(self, jet: Jet):
        object.__setattr__(self, "jet", jet)

    def __setattr__(self, *a):  # pragma: no cover
        raise AttributeError(f"{type(self).__name__} is immutable")

    @property
    def dom(self) -> Space:
        return self.jet.dom

    @property
    def rng(self) -> Space:
        return self.jet.rng

    @property
    def domain(self) -> Space:
        return self.dom

    @property
    def range(self) -> Space:
        return self.rng

    @property
    def shape(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        return (self.rng.shape, self.dom.shape)

    @property
    def size(self) -> Tuple[int, int]:
        return (self.rng.size, self.dom.size)

    @property
    def state(self) -> Dict[str, Any]:
        return self.jet.state

    def __call__(self, m):
        return self.jet.apply_f(m)

    def _compose_or_apply(self, other):
        """``A @ B`` composes when ``B`` is an operator; a raw 2-D tensor or
        array that is NOT shaped like a domain member is wrapped into a
        matrix operator (on this operator's device, unless it is a tensor,
        which keeps its own) and composed; anything else is applied."""
        from . import algebra

        if isinstance(other, Operator):
            return algebra.compose(self, other)
        shp = getattr(other, "shape", None)
        if shp is not None and tuple(shp) != self.dom.local_shape and len(shp) == 2:
            return algebra.compose(self, algebra._wrap(other, self.dom.device))
        return self(other)

    def __matmul__(self, other):
        return self._compose_or_apply(other)

    def __mul__(self, other):
        from . import algebra

        if isinstance(other, (int, float, complex)):
            return algebra.scale(other, self)
        return self._compose_or_apply(other)

    def __rmul__(self, a):
        from . import algebra

        if isinstance(a, (int, float, complex)):
            return algebra.scale(a, self)
        return NotImplemented

    def __add__(self, other):
        from . import algebra

        return algebra.add(self, other)

    def __sub__(self, other):
        from . import algebra

        return algebra.subtract(self, other)

    def __neg__(self):
        from . import algebra

        return algebra.scale(-1.0, self)

    def linearize(self, m0) -> "LinearOperator":
        """Pin at ``m0``: always a new, independent operator."""
        return LinearOperator(self.jet.at(m0))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.dom} -> {self.rng})"


class LinearOperator(Operator):
    """Linear operator, possibly pinned at ``m0``; applies the tangent ``df``.
    ``A.H`` is the lazy adjoint."""

    def __call__(self, m):
        return self.jet.apply_df(m)

    @property
    def H(self) -> "AdjointOperator":
        return AdjointOperator(self)

    @property
    def T(self) -> "AdjointOperator":
        return self.H

    def adjoint_apply(self, d):
        return self.jet.apply_dft(d)

    def linearize(self, m0) -> "LinearOperator":
        return self


class AdjointOperator(LinearOperator):
    """Lazy adjoint: domain and range swap, and ``H`` unwraps."""

    __slots__ = ("op",)

    def __init__(self, op: LinearOperator):
        object.__setattr__(self, "op", op)
        object.__setattr__(self, "jet", op.jet)

    @property
    def dom(self) -> Space:
        return self.op.rng

    @property
    def rng(self) -> Space:
        return self.op.dom

    def __call__(self, d):
        return self.op.adjoint_apply(d)

    def adjoint_apply(self, m):
        return self.op(m)

    @property
    def H(self) -> LinearOperator:
        return self.op

    def __repr__(self) -> str:
        return f"Adjoint({self.op!r})"


def jet_of(op: Operator) -> Jet:
    return op.jet


def point(op: Operator):
    """The pinned linearization point (or None)."""
    return op.jet.m0


def linearize(F: Operator, m0) -> LinearOperator:
    return F.linearize(m0)


def jacobian(F: Operator, m0) -> LinearOperator:
    return F.linearize(m0)


def adjoint(A: LinearOperator) -> LinearOperator:
    return A.H


def _child_ops(j: Jet):
    for v in j.state.values():
        for child in (v if isinstance(v, (tuple, list)) else [v]):
            if isinstance(child, Operator):
                yield child


def state(op: Operator, key: Optional[str] = None):
    """The operator's state, or one entry of it, searching child operators
    of combinators when the key is not its own."""
    s = op.jet.state
    if key is None:
        return s
    if key in s:
        return s[key]
    hits = []
    for child in _child_ops(op.jet):
        try:
            hits.append(state(child, key))
        except KeyError:
            pass
    if not hits:
        raise KeyError(key)
    if len(hits) > 1:
        raise KeyError(f"state key {key!r} is ambiguous across child operators")
    return hits[0]


def with_state(op: Operator, **updates) -> Operator:
    """A new operator with merged state."""
    new_jet = op.jet.replace(state={**op.jet._state, **updates})
    if isinstance(op, AdjointOperator):
        return AdjointOperator(type(op.op)(new_jet))
    return type(op)(new_jet)


def perfstat(op: Operator):
    """Per-operator perf metrics hook; combinators return the first
    non-None stat of their children."""
    j = op.jet
    if j.perfstat_fn is not None:
        return j.perfstat_fn(j)
    for child in _child_ops(j):
        s = perfstat(child)
        if s is not None:
            return s
    return None


def close(op: Operator) -> None:
    """Release external resources held by an operator and its children."""
    j = op.jet
    if j.close_fn is not None:
        j.close_fn(j)
    for child in _child_ops(j):
        close(child)
