"""Plain reference of the multi-shot linearized seismic operator and of
LSQR on it, in plain PyTorch.

``A m = [wr_b * (L m)[receivers]]_b``: the order-2 Laplacian with a zero
boundary, sampled on a regular subgrid of receivers (C order, axis 0
major) and weighted per shot by ``wr`` (nshots, nreceivers). Its adjoint
is ``L`` of the weighted residuals summed over shots and placed at the
receivers (``L`` is symmetric). LSQR is Paige and Saunders' (1982)
algorithm as published, with no damping; ``history[i]`` is ``|phibar|``
after iteration ``i + 1``. The reference runs in float64; the control in
bfloat16. Nothing here imports the program or takes anything it made.
"""
from __future__ import annotations

import torch

__all__ = ["Seismic", "lsqr"]


class Seismic:
    def __init__(self, grid_shape, receivers, wr, dtype=torch.float64):
        self.shape = tuple(int(s) for s in grid_shape)
        self.dtype = dtype
        dev = wr.device
        self.idx = [torch.as_tensor(a, device=dev) for a in receivers]
        self.counts = tuple(len(a) for a in receivers)
        self.wr = wr.to(dtype)

    def laplacian(self, m):
        out = -6.0 * m
        for ax in range(3):
            n = m.shape[ax]
            lo = [slice(None)] * 3
            hi = [slice(None)] * 3
            lo[ax], hi[ax] = slice(0, n - 1), slice(1, n)
            out[tuple(hi)] += m[tuple(lo)]
            out[tuple(lo)] += m[tuple(hi)]
        return out

    def sample(self, m):
        """``(L m)`` at the receivers, from the 7 taps of each."""
        iz, iy, ix = self.idx
        lv = -6.0 * m[iz][:, iy][:, :, ix]
        for ax in range(3):
            for d in (-1, 1):
                sh = [iz, iy, ix]
                sh[ax] = sh[ax] + d
                lv = lv + m[sh[0]][:, sh[1]][:, :, sh[2]]
        return lv.reshape(-1)

    def forward(self, m):
        return self.wr * self.sample(m.to(self.dtype))[None, :]

    def adjoint(self, d):
        g = torch.sum(self.wr * d.to(self.dtype), 0).reshape(self.counts)
        z = torch.zeros(self.shape, dtype=self.dtype, device=d.device)
        iz, iy, ix = self.idx
        z[iz[:, None, None], iy[None, :, None], ix[None, None, :]] = g
        return self.laplacian(z)


def lsqr(A: Seismic, b, iterations: int):
    """``(x, history)`` after ``iterations`` iterations from ``x = 0``."""
    dt = A.dtype
    b = b.to(dt)
    beta = torch.linalg.vector_norm(b)
    u = b / beta
    v = A.adjoint(u)
    alpha = torch.linalg.vector_norm(v)
    v = v / alpha
    w = v.clone()
    x = torch.zeros_like(v)
    phibar, rhobar = beta, alpha
    hist = torch.empty(iterations, dtype=torch.float64, device=b.device)
    for i in range(iterations):
        u = A.forward(v) - alpha * u
        beta = torch.linalg.vector_norm(u)
        u = u / beta
        v = A.adjoint(u) - beta * v
        alpha = torch.linalg.vector_norm(v)
        v = v / alpha
        rho = torch.sqrt(rhobar**2 + beta**2)
        c, s = rhobar / rho, beta / rho
        theta = s * alpha
        rhobar = -c * alpha
        phi = c * phibar
        phibar = s * phibar
        x = x + (phi / rho) * w
        w = v - (theta / rho) * w
        hist[i] = torch.abs(phibar)
    return x, hist
