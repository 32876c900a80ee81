"""The five BASELINE configurations as runnable problems (counterpart of
``jets_tpu/models/configs.py``).

Each builder returns ``(operator, solver_fn, d_obs, info)`` at its full
benchmark size by default, or at a smaller size for tests:

1. diagonal ∘ matrix ∘ diagonal composite — CG on a 1000 × 1000 SPD system;
2. the 1-D convolution/derivative chain ``A = D ∘ S`` — LSQR deconvolution, 10⁴;
3. a 2-D blur stencil on a 512² grid — CGLS deblurring;
4. a 64-block multi-shot seismic operator on 128² — LSQR;
5. the 3-D seismic operator over 256 shots on 128 × 128 × 64 — LSQR.

Every builder builds on ``device`` (``None``: the CUDA card). Random draws
come from ``torch.Generator().manual_seed(seed)`` on the CPU and are then
moved, so a seed gives the same problem on every device; the JAX package
draws with ``jax.random``. The drawn arrays can be given instead (config 1
``M``, ``w``, ``x_true``; configs 2–3 ``x_true``; configs 4–5 the seismic
``wr``), which carries a problem of the JAX package into the port.
Configs 1–3 default to float64, as the JAX builders do; 4–5 to float32.
"""
from __future__ import annotations

import torch

from ..core.algebra import compose
from ..core.spaces import as_tensor, resolve_device, true_div
from ..ops.conv import conv1d_operator, derivative_operator
from ..ops.diagonal import diagonal_operator
from ..ops.matrix import matrix_operator
from ..ops.stencil import blur2d_operator
from ..solvers import cg, cgls, lsqr
from .seismic import make_seismic_problem

__all__ = [
    "config1_spd_cg",
    "config2_deconv_lsqr",
    "config3_deblur_cgls",
    "config4_distributed_lsqr",
    "config5_seismic3d_pod",
    "run_config",
]


def _draw(given, draw, dtype, device):
    """``given`` (an array or a tensor) as a ``dtype`` tensor on ``device``,
    or a fresh CPU draw moved there."""
    return as_tensor(given if given is not None else draw()).to(dtype=dtype, device=device)


def config1_spd_cg(n: int = 1000, seed: int = 0, dtype: torch.dtype = torch.float64,
                   *, M=None, w=None, x_true=None,
                   device: torch.device | str | None = None):
    """``W^½ S W^½`` with ``S = M Mᵀ/n + 2I`` and ``W`` a diagonal in
    ``[1, 2)`` — SPD, solved by CG."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    M = _draw(M, lambda: torch.randn((n, n), generator=g, dtype=dtype), dtype, device)
    w = _draw(w, lambda: 1.0 + torch.rand((n,), generator=g, dtype=dtype), dtype, device)
    x_true = _draw(x_true, lambda: torch.randn((n,), generator=g, dtype=dtype), dtype,
                   device)
    spd = true_div(M @ M.T, float(n)) + 2.0 * torch.eye(n, dtype=dtype, device=device)
    ws = torch.sqrt(w)
    A = compose(diagonal_operator(ws, device=device), matrix_operator(spd, device=device),
                diagonal_operator(ws, device=device))
    return A, (lambda op, b, **kw: cg(op, b, **kw)), A(x_true), {"x_true": x_true}


def config2_deconv_lsqr(n: int = 10_000, seed: int = 0,
                        dtype: torch.dtype = torch.float64, *, x_true=None,
                        device: torch.device | str | None = None):
    """``A = D ∘ S`` (first difference after a Gaussian wavelet of 25
    samples) on sparse spikes, solved by LSQR."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    t = torch.arange(25, dtype=dtype)
    wavelet = torch.exp(-0.5 * ((t - 12.0) / 3.0) ** 2)
    A = compose(derivative_operator(n, 1.0, dtype, device),
                conv1d_operator(wavelet, n, dtype, device))

    def spikes():
        x = torch.zeros((n,), dtype=dtype)
        x[torch.randint(5, n - 5, (n // 100,), generator=g)] = 1.0
        return x

    x_true = _draw(x_true, spikes, dtype, device)
    return A, (lambda op, b, **kw: lsqr(op, b, **kw)), A(x_true), {"x_true": x_true}


def config3_deblur_cgls(side: int = 512, seed: int = 0,
                        dtype: torch.dtype = torch.float64, *, x_true=None,
                        device: torch.device | str | None = None):
    """A 2-D Gaussian blur of radius 3 on sparse point sources, deblurred
    by CGLS."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    A = blur2d_operator((side, side), radius=3, dtype=dtype, device=device)
    x_true = _draw(x_true, lambda: (torch.rand((side, side), generator=g, dtype=dtype)
                                    > 0.995).to(dtype), dtype, device)
    return A, (lambda op, b, **kw: cgls(op, b, **kw)), A(x_true), {"x_true": x_true}


def config4_distributed_lsqr(nblocks: int = 64, grid=(128, 128), nrecv: int = 512,
                             seed: int = 0, mesh=None,
                             dtype: torch.dtype = torch.float32, *, wr=None,
                             device: torch.device | str | None = None):
    """The multi-shot seismic operator with ``nblocks`` shots on a 2-D grid,
    solved by LSQR; with ``mesh`` the shots shard over its ranks and the
    adjoint all-reduces over them (``make_seismic_problem``)."""
    A, m_true, d = make_seismic_problem(grid, nblocks, nrecv, seed=seed, wr=wr,
                                        mesh=mesh, noise=0.02, dtype=dtype, device=device)
    return A, (lambda op, b, **kw: lsqr(op, b, **kw)), d, {"m_true": m_true}


def config5_seismic3d_pod(nshots: int = 256, grid=(128, 128, 64), nrecv: int = 2048,
                          seed: int = 0, mesh=None, dtype: torch.dtype = torch.float32,
                          *, wr=None,
                          device: torch.device | str | None = None):
    """The 3-D linearized seismic operator over ``nshots`` shots, solved by
    LSQR; ``mesh`` as for :func:`config4_distributed_lsqr`."""
    A, m_true, d = make_seismic_problem(grid, nshots, nrecv, seed=seed, wr=wr,
                                        mesh=mesh, noise=0.02, dtype=dtype, device=device)
    return A, (lambda op, b, **kw: lsqr(op, b, **kw)), d, {"m_true": m_true}


def run_config(builder, *, maxiter: int = 100, tol: float = 1e-8, **kw):
    """Build and solve a config; returns ``(result, relative_residual, A)``."""
    A, solve, d, info = builder(**kw)
    res = solve(A, d, maxiter=maxiter, tol=tol)
    rel = float(A.rng.norm(A(res.x) - d)) / float(A.rng.norm(d))
    return res, rel, A
