"""Stacked block operators on one device (counterpart of
``stacked_block_operator`` in ``jets_tpu/parallel/sharded.py``).

A tall block column: every block (shot) maps the SAME model ``m`` to its
own data block, with per-block parameters stacked along a leading axis::

    d[b] = f(m, bstate[b])               forward
    m'   = Σ_b f'(d[b], bstate[b])        adjoint

Where the JAX package ``vmap``s an unbatched per-block kernel, the port
writes the batch dimension out: child kernels receive the WHOLE stacked
``bstate`` (every entry with its leading ``nblocks`` axis) merged with the
shared ``sstate``, and return stacked results. Block-invariant work (the
flagship's sampled stencil) is therefore computed once, not once per shot.
``shot_map="map"`` instead runs the kernels in a Python loop over shots,
each call seeing a one-block slice (leading axis of length 1).

The mesh path (sharding shots over devices, psum of the adjoint) is not
ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..core.jet import Jet, LinearOperator, Operator
from ..core.spaces import Space
from ..utils.tree import tmap

__all__ = ["stacked_block_operator"]


def _blocks(state):
    """The (bstate, sstate) pairs a kernel is called with: the whole stack
    once (``vmap``), or one single-block slice per shot (``map``)."""
    bstate, sstate = state["bstate"], state["sstate"]
    if state["shot_map"] == "map":
        for b in range(state["nblocks"]):
            yield {**{k: v[b:b + 1] for k, v in bstate.items()}, **sstate}
    else:
        yield {**bstate, **sstate}


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _stacked_f(m, state):
    return _cat([state["child_f"](m, bs) for bs in _blocks(state)])


def _stacked_df(dm, m0, state):
    return _cat([state["child_df"](dm, m0, bs) for bs in _blocks(state)])


def _stacked_dft(dd, m0, state):
    """Adjoint accumulation. ``stack_dft(dd, m0, state) -> model`` consumes
    the whole stack at once (in both shot modes, as in the JAX package);
    ``child_dft(dd, m0, state)`` returns stacked per-block model-space
    contributions (a tensor or a pytree such as a ``BlockVector``), summed
    over the block axis."""
    child_dft, stack_dft = state["child_dft"], state["stack_dft"]
    if stack_dft is not None:
        return stack_dft(dd, m0, {**state["bstate"], **state["sstate"]})
    if state["shot_map"] == "map":
        parts = [dd[b:b + 1] for b in range(state["nblocks"])]
    else:
        parts = [dd]
    acc = None
    for d_b, bs in zip(parts, _blocks(state)):
        term = tmap(lambda t: torch.sum(t, dim=0), child_dft(d_b, m0, bs))
        acc = term if acc is None else acc + term
    return acc


def _stacked_upstate(m0, state):
    # the model is shared across blocks; nothing block-local to refresh
    return {}


def stacked_block_operator(
    *,
    nblocks: int,
    dom: Space,
    rng_block: Space,
    bstate: Dict[str, Any],
    df: Callable,
    f: Optional[Callable] = None,
    dft: Optional[Callable] = None,
    stack_dft: Optional[Callable] = None,
    sstate: Optional[Dict[str, Any]] = None,
    mesh: Any = None,
    shot_map: str = "vmap",
) -> Operator:
    """Homogeneous tall block-column operator over a stacked block axis.

    ``bstate``: stacked per-block tensors (leading dim ``nblocks``).
    ``sstate``: shared tensors, merged into every kernel's state; keys must
    not collide with ``bstate``. ``df``/``f``/``dft`` are batched child
    kernels (see the module docstring); ``dft=None`` and ``stack_dft=None``
    derive the adjoint with ``torch.func.vjp`` of the tangent: of the whole
    stack (``vmap``), or of each block's in turn (``map``). The wave stacks
    give their own (``ops/wave._multishot_operator``: autograd of the
    forward, which their remat segments need). The range is
    ``(nblocks,) + rng_block.shape``.
    ``mesh`` must be None: sharding over devices is not ported yet.
    """
    if mesh is not None:
        raise NotImplementedError(
            "stacked_block_operator(mesh=...) is not ported yet "
            "(ROADMAP queue 1 item 18, distribution)"
        )
    if shot_map not in ("vmap", "map"):
        raise ValueError(f"shot_map must be 'vmap' or 'map', got {shot_map!r}")
    sstate = dict(sstate or {})
    for k, v in bstate.items():
        if k in sstate:
            raise ValueError(f"state key {k!r} appears in both bstate and sstate")
        if v.shape[0] != nblocks:
            raise ValueError(
                f"bstate[{k!r}] leading dim {v.shape[0]} != nblocks {nblocks}"
            )
    rng = Space((nblocks,) + rng_block.shape, rng_block.dtype, rng_block.device)
    state = {
        "child_f": f if f is not None else (lambda m, bs, __df=df: __df(m, None, bs)),
        "child_df": df,
        "child_dft": dft,
        "stack_dft": stack_dft,
        "bstate": dict(bstate),
        "sstate": sstate,
        "nblocks": nblocks,
        "shot_map": shot_map,
    }
    have_adjoint = dft is not None or stack_dft is not None
    if not have_adjoint and shot_map == "map":
        # sequential mode: derive the adjoint per block (vjp of that block's
        # tangent), so one shot's tape is held at a time, as the JAX
        # package's _auto_child_dft does
        def _auto_child_dft(d_b, m0, bs, __df=df):
            prim = m0 if m0 is not None else dom.zeros()
            _, vjp = torch.func.vjp(lambda dm: __df(dm, m0, bs), prim)
            (out,) = vjp(d_b)
            return tmap(lambda t: t[None], out)

        state["child_dft"] = _auto_child_dft
        have_adjoint = True
    j = Jet(
        dom=dom,
        rng=rng,
        f=_stacked_f,
        df=_stacked_df,
        dft=_stacked_dft if have_adjoint else None,
        upstate=_stacked_upstate if f is not None else None,
        state=state,
    )
    return (Operator if f is not None else LinearOperator)(j)
