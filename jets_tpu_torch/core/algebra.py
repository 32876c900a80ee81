"""Operator algebra — L2: composition, sums, scalar scaling, vec
(counterpart of ``jets_tpu/core/algebra.py``).

As in the JAX package, a combinator is not a new class but another jet
whose kernels are module-level functions and whose child operators live in
the jet's ``state``; "which combinator is this?" is answered by kernel
identity (``op.jet.f is _composite_f``).

A raw 2-D tensor or array in an operator expression is wrapped into a
:func:`~jets_tpu_torch.ops.matrix.matrix_operator`, as in the JAX package.
The wrapped matrix lives on a device: a tensor keeps its own, an array
goes to the device of the operators beside it, and with none beside it to
the CUDA card (:func:`~jets_tpu_torch.core.spaces.resolve_device`).
"""
from __future__ import annotations

import torch

from .jet import AdjointOperator, Jet, LinearOperator, Operator
from .spaces import Space

__all__ = ["compose", "add", "subtract", "scale", "vec", "is_composite", "is_sum"]


def _wrap(x, device=None) -> Operator:
    """``x`` as an operator: operators pass through and a raw 2-D tensor or
    array becomes a matrix operator (a tensor on its own device, an array
    on ``device``)."""
    if isinstance(x, Operator):
        return x
    if getattr(x, "ndim", None) == 2:
        from ..ops.matrix import matrix_operator

        return matrix_operator(
            x, device=x.device if isinstance(x, torch.Tensor) else device)
    raise TypeError(f"cannot interpret {type(x).__name__} as an operator")


def _device_of(xs):
    """The device of the first operator among ``xs``; None when there is
    none (a lone raw matrix then goes to the card)."""
    for x in xs:
        if isinstance(x, Operator):
            return x.dom.device
    return None


def _is_linear(op: Operator) -> bool:
    return isinstance(op, LinearOperator)


# -- composition ---------------------------------------------------------------


def _composite_f(m, state):
    """Forward: children right-to-left (innermost first)."""
    for child in reversed(state["ops"]):
        m = child(m)
    return m


def _composite_df(dm, m0, state):
    for child in reversed(state["ops"]):
        if not isinstance(child, LinearOperator):
            raise ValueError(
                "tangent of a nonlinear composite requires linearize(op, m0) first"
            )
        dm = child(dm)
    return dm


def _composite_dft(dd, m0, state):
    """(A∘B)^H = B^H ∘ A^H."""
    for child in state["ops"]:
        dd = child.adjoint_apply(dd)
    return dd


def _composite_upstate(m0, state):
    """Pin each child at the propagated intermediate point."""
    new_rev = []
    m = m0
    for child in reversed(state["ops"]):
        new_rev.append(child.linearize(m))
        m = child(m)
    return {"ops": tuple(reversed(new_rev))}


def is_composite(op: Operator) -> bool:
    return op.jet.f is _composite_f


def compose(*operators) -> Operator:
    """``compose(A, B, ...)`` = A ∘ B ∘ … (rightmost applied first). Chains
    flatten; the result is linear iff every child is."""
    ops = []
    dev = _device_of(operators)
    for op in operators:
        op = _wrap(op, dev)
        if is_composite(op) and not isinstance(op, AdjointOperator):
            ops.extend(op.jet.state["ops"])
        else:
            ops.append(op)
    if len(ops) == 1:
        return ops[0]
    for a, b in zip(ops[:-1], ops[1:]):
        if a.dom != b.rng:
            raise ValueError(
                f"compose: domain/range mismatch: {a.dom} (domain of left) != "
                f"{b.rng} (range of right)"
            )
    j = Jet(
        dom=ops[-1].dom,
        rng=ops[0].rng,
        f=_composite_f,
        df=_composite_df,
        dft=_composite_dft,
        upstate=_composite_upstate,
        state={"ops": tuple(ops)},
    )
    cls = LinearOperator if all(_is_linear(o) for o in ops) else Operator
    return cls(j)


# -- sums ----------------------------------------------------------------------


def _signed_sum(terms):
    acc = None
    for sgn, term in terms:
        term = term if sgn > 0 else -term
        acc = term if acc is None else acc + term
    return acc


def _sum_f(m, state):
    return _signed_sum((s, c(m)) for s, c in zip(state["sgns"], state["ops"]))


def _sum_df(dm, m0, state):
    for child in state["ops"]:
        if not isinstance(child, LinearOperator):
            raise ValueError(
                "tangent of a nonlinear sum requires linearize(op, m0) first"
            )
    return _signed_sum((s, c(dm)) for s, c in zip(state["sgns"], state["ops"]))


def _sum_dft(dd, m0, state):
    return _signed_sum(
        (s, c.adjoint_apply(dd)) for s, c in zip(state["sgns"], state["ops"])
    )


def _sum_upstate(m0, state):
    """All children linearize at the same point."""
    return {"ops": tuple(child.linearize(m0) for child in state["ops"])}


def is_sum(op: Operator) -> bool:
    return op.jet.f is _sum_f


def _terms(op: Operator, sgn: int, device):
    """Flatten nested sums with sign bookkeeping: ``A - (B - C)`` becomes
    ``A - B + C``."""
    op = _wrap(op, device)
    if is_sum(op) and not isinstance(op, AdjointOperator):
        s = op.jet.state
        return [(sgn * cs, c) for cs, c in zip(s["sgns"], s["ops"])]
    return [(sgn, op)]


def _make_sum(terms) -> Operator:
    sgns = tuple(int(s) for s, _ in terms)
    ops = tuple(o for _, o in terms)
    dom, rng = ops[0].dom, ops[0].rng
    for o in ops[1:]:
        if o.dom != dom or o.rng != rng:
            raise ValueError(
                f"sum: all operators need matching spaces; got {o.dom}->{o.rng} "
                f"vs {dom}->{rng}"
            )
    j = Jet(
        dom=dom,
        rng=rng,
        f=_sum_f,
        df=_sum_df,
        dft=_sum_dft,
        upstate=_sum_upstate,
        state={"ops": ops, "sgns": sgns},
    )
    cls = LinearOperator if all(_is_linear(o) for o in ops) else Operator
    return cls(j)


def add(A, B) -> Operator:
    dev = _device_of((A, B))
    return _make_sum(_terms(A, +1, dev) + _terms(B, +1, dev))


def subtract(A, B) -> Operator:
    dev = _device_of((A, B))
    return _make_sum(_terms(A, +1, dev) + _terms(B, -1, dev))


# -- scalar scaling ------------------------------------------------------------


def _scale_df(dm, m0, state):
    return state["a"] * dm


def _scale_dft(dd, m0, state):
    a = state["a"]
    return (a.conj() if isinstance(a, torch.Tensor) else a.conjugate()) * dd


def scale(a, A) -> Operator:
    """``a * A`` — the scaling composed onto ``A`` (``(aI) ∘ A``)."""
    A = _wrap(A)
    rng = A.rng
    if isinstance(a, complex) and not rng.dtype.is_complex:
        raise TypeError(
            f"scaling a {rng.dtype} operator by {a!r} would promote to complex; "
            "cast the scalar first"
        )
    j = Jet(dom=rng, rng=rng, df=_scale_df, dft=_scale_dft, state={"a": a})
    return compose(LinearOperator(j), A)


# -- vec -----------------------------------------------------------------------


def _vec_f(m, state):
    op = state["op"]
    return op.rng.ravel(op(op.dom.reshape(m)))


def _vec_df(dm, m0, state):
    op = state["op"]
    if not isinstance(op, LinearOperator):
        raise ValueError("tangent of vec(op) requires linearize first")
    return op.rng.ravel(op(op.dom.reshape(dm)))


def _vec_dft(dd, m0, state):
    op = state["op"]
    return op.dom.ravel(op.adjoint_apply(op.rng.reshape(dd)))


def _vec_upstate(m0, state):
    op = state["op"]
    return {"op": op.linearize(op.dom.reshape(m0))}


def vec(A) -> Operator:
    """The operator over flattened 1-D spaces; a no-op if it is 1-D→1-D
    over dense or symmetric spaces. Block spaces are always adapted: a
    ``BlockVector`` is a tuple of blocks, which ``vec`` flattens into one
    tensor. An n-D symmetric space cannot be flattened: its
    multiplicity-weighted inner product has no flat-``Space`` equivalent,
    and dropping the weights would break every adjoint downstream."""
    from .blockspace import BlockSpace
    from .spaces import MappedSymmetricSpace, SymmetricSpace

    A = _wrap(A)
    if (A.dom.ndim == 1 and A.rng.ndim == 1
            and not isinstance(A.dom, BlockSpace) and not isinstance(A.rng, BlockSpace)):
        return A
    for sp in (A.dom, A.rng):
        if isinstance(sp, (SymmetricSpace, MappedSymmetricSpace)) and sp.ndim > 1:
            raise NotImplementedError(
                "vec() of an operator over an n-D SymmetricSpace would drop "
                "its multiplicity weights; reshape at the call site instead")
    j = Jet(
        dom=Space((A.dom.size,), A.dom.dtype, A.dom.device),
        rng=Space((A.rng.size,), A.rng.dtype, A.rng.device),
        f=_vec_f,
        df=_vec_df,
        dft=_vec_dft,
        upstate=_vec_upstate,
        state={"op": A},
    )
    return (LinearOperator if _is_linear(A) else Operator)(j)
