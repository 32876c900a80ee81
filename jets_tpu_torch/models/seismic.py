"""Flagship model: multi-shot linearized seismic-style inversion
(counterpart of ``jets_tpu/models/seismic.py``).

Per-shot physics, kept linear::

    d_b = R_b [ w_b ⊙ (L m) ] = w_b[rcv] * (L m)[rcv]

with ``L`` the order-2 Laplacian, per-shot weights ``wr`` (nshots, nrecv)
that live at the receiver points only, and receivers on a regular interior
subgrid shared by all shots (or, when the receiver count cannot be laid out
as one, a jittered strided line with stencil stamps).

``impl="fused"`` (default) samples the stencil taps directly on a gathered
3-block-per-axis sub-array in the forward (no dense sweep), and in the
adjoint deposits per axis, then runs ONE dense Laplacian sweep — on a CUDA
3-D float32 grid the hand-written kernel ``cuda_solver.laplacian3d`` (K3),
bitwise equal to :func:`laplacian_nd`. ``epilogue_hook=True`` (3-D)
advertises the fused adjoint tail ``vh = A^H dd + s·v`` with ``‖vh‖`` to
the LSQR solver; on a 3-D float32 grid it is ``cuda_solver.lap3d_axpy_norm2``
(K2). ``impl="composed"`` is the explicit ``S ∘ L`` composition through the
operator algebra.

The JAX package draws the geometry and weights with ``jax.random``; the
port draws its own with a :class:`torch.Generator`, and
:func:`seismic_operator_from_arrays` builds the operator from given arrays,
so the two packages can be held against each other on the same operator.

With ``mesh=`` (a :class:`~jets_tpu_torch.parallel.sharded.BlockMesh`) the
shots shard over the mesh's ranks: each rank keeps its slab of ``wr``,
the data are its slab of shots, and the adjoint sums the rank's shots (the
3-D tail through K3 on that local sum), then all-reduces once. The fused
epilogue hook is left out under a mesh, as in the JAX package. On a 2-D
(block × grid) mesh (:func:`~jets_tpu_torch.parallel.gspmd.make_mesh_2d`) the
model grid splits too: the domain is the rank's slab of the leading grid
dimension over ``"grid"``, the range its shots over ``"block"``; the forward
and the adjoint exchange one halo plane (:func:`_grid_sharded_kernels`), the
adjoint all-reduces over the block group only.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.algebra import compose
from ..core.jet import Operator, with_state
from ..core.spaces import Space, resolve_device
from ..ops.cuda_solver import lap3d_axpy_norm2, laplacian3d
from ..ops.stencil import laplacian_nd as _lap
from ..ops.stencil import laplacian_operator
from ..parallel.collectives import gather_blocks, halo_exchange, sum_replicated
from ..parallel.runner import local_block_range
from ..parallel.sharded import ShardedSpace, grid_axis, stacked_block_operator

__all__ = [
    "make_seismic_operator",
    "make_seismic_problem",
    "seismic_operator_from_arrays",
]


def _receiver_grid(grid_shape, nreceivers):
    """Factor ``nreceivers`` into a regular INTERIOR subgrid of the model:
    per-axis (start, stride, count), centered, with a ≥1-cell margin so
    every stencil tap of every receiver stays in bounds.

    Returns ``(starts, strides, counts)`` or ``None`` if the grid can't
    hold ``nreceivers`` with margins.
    """
    nd = len(grid_shape)

    def prime_factors(n):
        fs, p = [], 2
        while p * p <= n:
            while n % p == 0:
                fs.append(p)
                n //= p
            p += 1
        if n > 1:
            fs.append(n)
        return sorted(fs, reverse=True)

    counts = [1] * nd
    for f in prime_factors(int(nreceivers)):
        # give the factor to the axis with the most remaining room
        ax = max(range(nd), key=lambda a: (grid_shape[a] - 2) / (counts[a] * f))
        counts[ax] *= f
    if any(c > s - 2 for c, s in zip(counts, grid_shape)):
        return None
    starts, strides = [], []
    for s, c in zip(grid_shape, counts):
        interior = s - 2
        sr = max(1, interior // c)
        span = (c - 1) * sr
        starts.append(1 + (interior - span - 1) // 2)
        strides.append(sr)
    return tuple(starts), tuple(strides), tuple(counts)


def _dense_lap(z):
    """The adjoint's one dense order-2 sweep: K3 for 3-D float32 (its plain
    version on the CPU), :func:`laplacian_nd` otherwise — bitwise equal."""
    if z.ndim == 3 and z.dtype == torch.float32:
        return laplacian3d(z)
    return _lap(z)


# -- regular (subgrid) geometry --------------------------------------------------


def _axis_sample(u, axes_idx):
    """Sample ``u`` on the receiver subgrid by per-axis gathers, major axis
    first (the later gathers act on an already small tensor)."""
    g = u
    for ax, idx in enumerate(axes_idx):
        g = torch.index_select(g, ax, idx)
    return g


def _axis_deposit(g, grid_shape, axes_idx):
    """Adjoint of :func:`_axis_sample`: per-axis scatter-adds, minor axis
    first. Subgrid indices are distinct, so each add lands on a zero and
    the result is exact."""
    for ax in reversed(range(len(grid_shape))):
        shape = list(g.shape)
        shape[ax] = grid_shape[ax]
        g = torch.zeros(shape, dtype=g.dtype, device=g.device).index_add_(
            ax, axes_idx[ax], g)
    return g


def _make_axis_sample_df(axes_idx):
    def df(m, m0, bs):
        return _axis_sample(m, axes_idx).reshape(-1) * bs["wr"]

    return df


def _make_axis_sample_stack_dft(grid_shape, counts, axes_idx, with_lap):
    def stack_dft(dd, m0, bs):
        g = torch.sum(dd * bs["wr"], dim=0).reshape(counts)
        z = _axis_deposit(g, grid_shape, axes_idx)
        return _dense_lap(z) if with_lap else z

    return stack_dft


def _make_adjoint_axpy_norm_hook(grid_shape, counts, axes_idx, dom):
    """Solver epilogue hook (see ``solvers/krylov._adjoint_axpy_norm``):
    ``v_hat = A^H dd + s·v`` and ``‖v_hat‖``. On a 3-D float32 grid the
    dense tail (Laplacian sweep, axpy, norm) is one call of K2; otherwise
    the same math runs as plain torch ops."""

    def hook(dd, v, s, state):
        g = torch.sum(dd * state["bstate"]["wr"], dim=0).reshape(counts)
        z = _axis_deposit(g, grid_shape, axes_idx)
        if z.dtype == torch.float32 and len(grid_shape) == 3:
            vh, n2 = lap3d_axpy_norm2(z, v, s)
            return vh, torch.sqrt(n2)
        vh = _lap(z) + s * v
        return vh, dom.norm(vh)

    return hook


def _make_sampled_stencil_df(grid_shape, counts, axes_idx):
    """Sweep-free forward ``(L m)[subgrid] * wr``: per axis gather the index
    set ``[idx-1, idx, idx+1]``, then combine the 2·nd+1 taps on the small
    ``(3c0, 3c1, …)`` tensor in the SAME add order as :func:`laplacian_nd`,
    so the result is bitwise that of the composed operator. The sampled
    stencil is block-invariant and computed once for all shots."""
    nd = len(grid_shape)
    cat_idx = [torch.cat([idx - 1, idx, idx + 1]) for idx in axes_idx]

    def _blk_slice(pos):
        return tuple(slice(b * c, (b + 1) * c) for b, c in zip(pos, counts))

    center = (1,) * nd
    taps = [(center, -2.0 * nd)]
    for ax in range(nd):
        for b in (0, 2):
            taps.append((tuple(b if i == ax else 1 for i in range(nd)), 1.0))

    def df(m, m0, bs):
        E = m
        for ax in range(nd):
            E = torch.index_select(E, ax, cat_idx[ax])
        lv = None
        for pos, cf in taps:
            t = cf * E[_blk_slice(pos)]
            lv = t if lv is None else lv + t
        return lv.reshape(-1) * bs["wr"]

    return df


# -- the grid-sharded model of a block × grid mesh -------------------------------


def _grid_sharded_kernels(grid_shape, counts, axes_idx, dom, gax):
    """``(df, stack_dft)`` of the sampled-stencil operator on a model whose
    leading dimension is split over the mesh axis ``gax`` (``dom``, a
    :class:`ShardedSpace`). The forward exchanges one halo plane of ``m``
    with the neighbours along ``gax``, samples the stencil taps at the
    receiver rows this rank's slab owns, in :func:`_make_sampled_stencil_df`'s
    add order, and sums the sampled rows over ``gax``: each receiver lives on
    one rank, so adding the others' zeros is exact and the traces are the
    unsharded ones bit for bit. The adjoint deposits the owned receiver rows
    into the slab, exchanges its halo and applies ``L`` on the extended slab
    (K3 on a 3-D float32 grid), keeping the interior: the slab of the
    unsharded adjoint, bit for bit."""
    mesh, sl = dom.mesh, dom.slices[0]
    z0, Dl = sl.start, sl.stop - sl.start
    idx0 = axes_idx[0].cpu().numpy()
    rows_np = np.nonzero((idx0 >= z0) & (idx0 < z0 + Dl))[0]
    dev = axes_idx[0].device
    rows = torch.as_tensor(rows_np, device=dev)
    loc0 = torch.as_tensor(idx0[rows_np] - z0, device=dev)
    local_idx = (loc0,) + tuple(axes_idx[1:])
    nd = len(grid_shape)
    cat_idx = [torch.cat([i - 1, i, i + 1]) for i in (loc0 + 1,) + tuple(axes_idx[1:])]
    own = (len(rows_np),) + tuple(counts[1:])

    def _blk_slice(pos):
        return tuple(slice(b * c, (b + 1) * c) for b, c in zip(pos, own))

    center = (1,) * nd
    taps = [(center, -2.0 * nd)]
    for ax in range(nd):
        for b in (0, 2):
            taps.append((tuple(b if i == ax else 1 for i in range(nd)), 1.0))

    def df(m, m0, bs):
        E = halo_exchange(m, 1, mesh, 0, gax)
        for ax in range(nd):
            E = torch.index_select(E, ax, cat_idx[ax])
        lv = None
        for pos, cf in taps:
            t = cf * E[_blk_slice(pos)]
            lv = t if lv is None else lv + t
        full = torch.zeros(tuple(counts), dtype=m.dtype, device=m.device)
        full = full.index_copy(0, rows, lv)
        return sum_replicated(full, mesh, gax).reshape(-1) * bs["wr"]

    def stack_dft(dd, m0, bs):
        g = torch.sum(dd * bs["wr"], dim=0).reshape(counts)
        z = _axis_deposit(g.index_select(0, rows), dom.local_shape, local_idx)
        return _dense_lap(halo_exchange(z, 1, mesh, 0, gax))[1:1 + Dl]

    return df, stack_dft


# -- irregular geometry: receiver-local stencil stamps ---------------------------


def _laplacian_stamps(grid_shape, rcv, dtype, device):
    """Flat indices and coefficients of every order-2 stencil tap at each
    receiver, ``(2*nd+1, nrecv)`` each; taps off the grid get coefficient 0
    (the zero boundary)."""
    nd = len(grid_shape)
    rcv_np = np.asarray(rcv, dtype=np.int64)
    coords = np.stack(np.unravel_index(rcv_np, grid_shape))  # (nd, nrecv)
    strides = np.ones(nd, dtype=np.int64)
    for ax in range(nd - 2, -1, -1):
        strides[ax] = strides[ax + 1] * grid_shape[ax + 1]
    idx = [rcv_np]
    coef = [np.full(rcv_np.shape, -2.0 * nd)]
    for ax in range(nd):
        for delta in (-1, 1):
            c = coords[ax] + delta
            valid = (c >= 0) & (c < grid_shape[ax])
            idx.append(np.where(valid, rcv_np + delta * strides[ax], rcv_np))
            coef.append(valid.astype(np.float64))
    return (
        torch.as_tensor(np.stack(idx), dtype=torch.int64, device=device),
        torch.as_tensor(np.stack(coef), dtype=dtype, device=device),
    )


def _stamp_df(m, m0, bs):
    """``(L m)[rcv]`` from the receiver stamps (once for all shots), then
    the per-shot weights."""
    lv = torch.sum(m.reshape(-1)[bs["sidx"]] * bs["scoef"], dim=0)  # (nrecv,)
    return lv * bs["wr"]


def _make_stamp_stack_dft(grid_shape):
    def stack_dft(dd, m0, bs):
        """``L^T S^T dd``: reduce the weighted residuals over shots, then one
        scatter-add of the stencil stamps."""
        g = torch.sum(dd * bs["wr"], dim=0)  # (nrecv,)
        vals = bs["scoef"] * g[None, :]  # (nstamp, nrecv)
        z = torch.zeros(int(np.prod(grid_shape)), dtype=dd.dtype, device=dd.device)
        return z.index_add_(0, bs["sidx"].reshape(-1), vals.reshape(-1)).reshape(
            grid_shape)

    return stack_dft


def _sample_df(u, m0, bs):
    """Gather the wavefield at the receivers, weight per shot."""
    return u.reshape(-1)[bs["rcv"]] * bs["wr"]


def _make_sample_stack_dft(grid_shape):
    def stack_dft(dd, m0, bs):
        g = torch.sum(dd * bs["wr"], dim=0)  # (nrecv,)
        z = torch.zeros(int(np.prod(grid_shape)), dtype=dd.dtype, device=dd.device)
        return z.index_add_(0, bs["rcv"], g).reshape(grid_shape)

    return stack_dft


# -- constructors ----------------------------------------------------------------


def _irregular_receivers(ncells, nreceivers, generator):
    step = max(1, ncells // nreceivers)
    jitter = torch.randint(0, step, (nreceivers,), generator=generator)
    return (torch.arange(nreceivers) * step + jitter) % ncells


def _subgrid_receivers(grid_shape, grid_geom):
    starts, strides_g, counts = grid_geom
    axes_idx = [s + st * np.arange(c) for s, st, c in zip(starts, strides_g, counts)]
    mesh_idx = np.stack(np.meshgrid(*axes_idx, indexing="ij"), axis=-1).reshape(
        -1, len(grid_shape))
    return torch.as_tensor(np.ravel_multi_index(mesh_idx.T, grid_shape))


def _illumination(grid_shape, nshots, rcv, generator, dtype):
    """Per-shot gaussian illumination around a random source location,
    evaluated at the receiver points only: ``(nshots, nrecv)``."""
    centers = torch.stack(
        [torch.randint(0, s, (nshots,), generator=generator) for s in grid_shape],
        dim=1,
    ).to(dtype)
    sigma = torch.tensor(max(grid_shape) / 4.0, dtype=dtype)
    rcv_coords = torch.stack(
        torch.unravel_index(torch.as_tensor(rcv), tuple(grid_shape)), dim=-1
    ).to(dtype)  # (nrecv, nd)
    r2 = torch.sum((rcv_coords[None, :, :] - centers[:, None, :]) ** 2, dim=-1)
    return torch.exp(-0.5 * r2 / sigma**2)


def _tensor(a, dtype, device):
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))  # a writable copy of any array-like
    return a.to(dtype=dtype, device=device)


def seismic_operator_from_arrays(
    grid_shape: Sequence[int],
    nshots: int,
    nreceivers: int,
    *,
    wr,
    rcv=None,
    impl: str = "fused",
    epilogue_hook: bool = False,
    mesh=None,
    axis: str = "block",
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Operator:
    """The operator ``A = S ∘ L`` from given per-shot receiver weights ``wr``
    (nshots, nreceivers) and, for an irregular geometry (a receiver count
    :func:`_receiver_grid` cannot lay out), the flat receiver indices
    ``rcv`` (nreceivers,). ``rcv`` is not used with a regular subgrid, which
    is fixed by the grid shape and the receiver count. ``mesh``/``axis``
    shard the shots (the module docstring); the operator is then built on
    the mesh's device. On a 2-D mesh the model's leading dimension also
    splits over the other axis (:func:`~jets_tpu_torch.parallel.sharded.grid_axis`):
    the domain is a :class:`ShardedSpace` of the rank's grid slab
    (:func:`_grid_sharded_kernels`; the fused regular geometry only)."""
    grid_shape = tuple(int(s) for s in grid_shape)
    device = mesh.device if mesh is not None else resolve_device(device)
    if impl not in ("fused", "composed"):
        raise ValueError(f"impl must be 'fused' or 'composed', got {impl!r}")
    dom = Space(grid_shape, dtype, device)
    rng_block = Space((nreceivers,), dtype, device)
    wr = _tensor(wr, dtype, device)
    if tuple(wr.shape) != (nshots, nreceivers):
        raise ValueError(f"wr has shape {tuple(wr.shape)}, expected ({nshots}, {nreceivers})")
    common = dict(nblocks=nshots, dom=dom, rng_block=rng_block, bstate={"wr": wr},
                  mesh=mesh, axis=axis)

    grid_geom = _receiver_grid(grid_shape, nreceivers)
    gax = grid_axis(mesh, axis)
    if gax is not None:
        if grid_geom is None or impl != "fused":
            raise ValueError(f"a model sharded over mesh axis {gax!r} takes the fused "
                             "operator on a regular receiver subgrid")
        dom = common["dom"] = ShardedSpace(grid_shape, dtype, mesh, spec=(gax,))
        axes_idx = tuple(torch.arange(c, device=device) * st + s
                         for s, st, c in zip(*grid_geom))
        df, stack_dft = _grid_sharded_kernels(grid_shape, grid_geom[2], axes_idx, dom, gax)
        return stacked_block_operator(**common, df=df, stack_dft=stack_dft)
    if grid_geom is not None:
        starts, strides_g, counts = grid_geom
        axes_idx = tuple(
            torch.arange(c, device=device) * st + s
            for s, st, c in zip(starts, strides_g, counts)
        )
        if impl == "fused":
            op = stacked_block_operator(
                **common,
                df=_make_sampled_stencil_df(grid_shape, counts, axes_idx),
                stack_dft=_make_axis_sample_stack_dft(
                    grid_shape, counts, axes_idx, with_lap=True),
            )
            if epilogue_hook and len(grid_shape) == 3 and mesh is None:
                op = with_state(
                    op,
                    adjoint_axpy_norm=_make_adjoint_axpy_norm_hook(
                        grid_shape, counts, axes_idx, dom),
                )
            return op
        S = stacked_block_operator(
            **common,
            df=_make_axis_sample_df(axes_idx),
            stack_dft=_make_axis_sample_stack_dft(
                grid_shape, counts, axes_idx, with_lap=False),
        )
        return compose(S, laplacian_operator(grid_shape, dtype, device))

    if rcv is None:
        raise ValueError(
            f"{nreceivers} receivers do not fit a regular subgrid of {grid_shape}: "
            "pass the receiver indices rcv"
        )
    rcv = _tensor(rcv, torch.int64, device)
    if impl == "fused":
        sidx, scoef = _laplacian_stamps(grid_shape, rcv.cpu().numpy(), dtype, device)
        return stacked_block_operator(
            **common,
            sstate={"sidx": sidx, "scoef": scoef},
            df=_stamp_df,
            stack_dft=_make_stamp_stack_dft(grid_shape),
        )
    S = stacked_block_operator(
        **common,
        sstate={"rcv": rcv},
        df=_sample_df,
        stack_dft=_make_sample_stack_dft(grid_shape),
    )
    return compose(S, laplacian_operator(grid_shape, dtype, device))


def make_seismic_operator(
    grid_shape: Sequence[int],
    nshots: int,
    nreceivers: int,
    generator: Optional[torch.Generator] = None,
    *,
    wr=None,
    rcv=None,
    mesh=None,
    axis: str = "block",
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
    impl: str = "fused",
    epilogue_hook: bool = False,
) -> Operator:
    """Build the multi-shot linearized modeling operator ``A = S ∘ L``,
    drawing the per-shot weights (and an irregular geometry's receiver
    jitter) from ``generator`` (a CPU generator; default seed 0), so the
    same seed gives the same operator on every device. Explicit ``wr`` and
    ``rcv`` arrays are used as given instead (see
    :func:`seismic_operator_from_arrays`).

    Model space: ``grid_shape`` (2-D or 3-D) on ``device`` (``None``: the
    CUDA card). Range: ``(nshots, nreceivers)``. ``mesh``/``axis`` shard
    the shots over a mesh's ranks (the module docstring): every rank draws
    the same global arrays and keeps its slab.
    """
    grid_shape = tuple(int(s) for s in grid_shape)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    grid_geom = _receiver_grid(grid_shape, nreceivers)
    if rcv is None:
        if grid_geom is not None:
            rcv = _subgrid_receivers(grid_shape, grid_geom)
        else:
            rcv = _irregular_receivers(int(np.prod(grid_shape)), nreceivers, g)
    if wr is None:
        wr = _illumination(grid_shape, nshots, rcv, g, dtype)
    return seismic_operator_from_arrays(
        grid_shape, nshots, nreceivers, wr=wr, rcv=rcv, impl=impl,
        epilogue_hook=epilogue_hook, mesh=mesh, axis=axis, dtype=dtype, device=device,
    )


def make_seismic_problem(
    grid_shape: Sequence[int],
    nshots: int,
    nreceivers: int,
    seed: int = 0,
    *,
    wr=None,
    rcv=None,
    mesh=None,
    axis: str = "block",
    noise: float = 0.0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
    impl: str = "fused",
    epilogue_hook: bool = False,
) -> Tuple[Operator, torch.Tensor, torch.Tensor]:
    """Operator + ground-truth reflectivity model + observed data.

    Everything random is drawn on the CPU from ``torch.Generator`` seeded
    with ``seed``, then moved to ``device``; ``wr``/``rcv`` as in
    :func:`make_seismic_operator`. ``noise`` adds gaussian
    observation noise of that relative amplitude (use it for benchmarks, so
    Krylov loops run their full iteration budget). Under ``mesh`` the data
    are the rank's slab of shots: the noise's scale is the standard
    deviation of the global data and its draw is the global draw's slab,
    so a seed gives the same global problem on any mesh. On a 2-D mesh
    ``m_true`` is the rank's slab of the grid.
    """
    g = torch.Generator().manual_seed(seed)
    device = mesh.device if mesh is not None else resolve_device(device)
    A = make_seismic_operator(
        grid_shape, nshots, nreceivers, g, wr=wr, rcv=rcv, mesh=mesh, axis=axis,
        dtype=dtype, device=device, impl=impl, epilogue_hook=epilogue_hook,
    )
    # sparse spike reflectivity over a weak smooth background
    n = A.dom.size
    spikes = torch.randperm(n, generator=g)[: max(4, n // 200)]
    bg = 0.05 * torch.randn(n, generator=g, dtype=dtype)
    flat = torch.zeros(n, dtype=dtype)
    flat[spikes] = 1.0
    m_true = (flat + bg).reshape(A.dom.shape).to(device)
    if isinstance(A.dom, ShardedSpace):  # the rank's slab of the grid
        m_true = A.dom.local(m_true).contiguous()
    d_obs = A(m_true)
    if noise > 0:
        d_all, lo = d_obs, 0
        if mesh is not None:
            lo = local_block_range(nshots, mesh, axis)[0]
            d_all = gather_blocks(d_obs, nshots, mesh, axis)
        scale = noise * torch.std(d_all, correction=0)
        eps = torch.randn(A.rng.shape, generator=g, dtype=dtype)[lo:lo + len(d_obs)]
        d_obs = d_obs + scale * eps.to(device)
    return A, m_true, d_obs
