"""Plain reference of windowed isotropic acoustic FWI in 2-D and 3-D: the
traces, the least-squares objective and its gradient, in plain PyTorch.

The scheme, as the configuration states it (``c`` velocity, ``C = c^2
dt^2 / dx^2``, ``L`` the order-``p`` Laplacian with a zero boundary, ``S``
the sponge, ``w`` the Ricker wavelet)::

    u_{k+1} = S * (2 u_k - u_{k-1} + C * L u_k) + dt^2 w_k delta_src,
    u_0 = u_{-1} = 0,   d_k = u_{k+1}[receivers],   k = 0 .. nt-1.

With a recording interval ``dtrec`` the traces kept are ``R d``: sample
``j`` at time ``j dtrec`` is the linear interpolation between the rows
``k`` and ``k + 1`` whose times ``k dt`` bracket it. The objective is
``phi = 1/2 sum_shots |R d - obs|^2``. Its gradient is the discrete
adjoint of the scheme: with ``r = R^T (R d - obs)``, ``e_j = S a_j`` and
``e_{nt+1} = e_{nt+2} = 0``,

    a_j = P^T r_{j-1} + 2 e_{j+1} + L(C e_{j+1}) - e_{j+2},   j = nt .. 1,
    dphi/dC = sum_k L(u_k) * e_{k+1},   dphi/dc = dphi/dC * 2 c dt^2 / dx^2,

where ``u_k`` is read back from the stored history: each shot's snapshot
coded to ``levels`` signed integer levels of its largest magnitude
(``int8``: 127, as the configuration states; the control's ``int4``: 7),
rounded half to even. Each shot runs in its window of the model; its
gradient is added into the full model's.

The control's ``fields="bfloat16"`` rounds every wavefield the scheme
stores (``u``, ``a``) to bfloat16 as it is written and computes each
step from those in float32, as a program that keeps its fields in
bfloat16 would. (Computing the Laplacian itself in bfloat16 rounds its
coefficients, whose sum is then no longer 0: the scheme grows without
bound and gives no number to compare.)

``L`` is the Kronecker sum of the 1-D banded second-difference matrices,
applied as one matrix product per axis (TF32 off). Shots run together as
a leading batch dimension as far as their histories fit in
``HISTORY_BUDGET_BYTES``. Nothing here imports the program or takes
anything it made.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["D2_COEFFS", "Laplacian", "ricker", "sponge", "resampling", "Scheme", "batch",
           "HISTORY_BUDGET_BYTES"]

# d2u/dx2 ~ (c0 u_i + sum_s c_s (u_{i-s} + u_{i+s})) / h^2 (Fornberg)
D2_COEFFS = {
    2: (-2.0, (1.0,)),
    4: (-5.0 / 2.0, (4.0 / 3.0, -1.0 / 12.0)),
    8: (-205.0 / 72.0, (8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0, -1.0 / 560.0)),
}
LEVELS = {"int8": 127.0, "int4": 7.0}
HISTORY_BUDGET_BYTES = 40e9


def _banded(n: int, order: int, dtype, device) -> torch.Tensor:
    c0, cs = D2_COEFFS[order]
    m = np.diag(np.full(n, c0))
    for s, c in enumerate(cs, start=1):
        m += np.diag(np.full(n - s, c), s) + np.diag(np.full(n - s, c), -s)
    return torch.as_tensor(m, dtype=dtype, device=device)


class Laplacian:
    """``L u`` for ``u`` of shape ``(..., *shape)``: the sum over axes of the
    axis's banded matrix applied along it (each matrix is symmetric)."""

    def __init__(self, shape, order: int, dtype, device):
        self.shape = tuple(shape)
        self.mats = [_banded(n, order, dtype, device) for n in shape]

    def __call__(self, u):
        nd = len(self.shape)
        out = torch.matmul(u, self.mats[-1])
        for ax in range(nd - 1):
            lead = u.shape[:u.ndim - nd + ax]
            v = u.reshape(*lead, self.shape[ax], -1)
            out += torch.matmul(self.mats[ax], v).reshape(u.shape)
        return out


def ricker(nt: int, dt: float, freq: float) -> torch.Tensor:
    """The Ricker wavelet of peak ``freq``, delayed by ``1/freq`` (capped at
    a quarter of the record), float64."""
    t = np.arange(nt) * dt - min(1.0 / freq, 0.25 * nt * dt)
    a = (math.pi * freq * t) ** 2
    return torch.as_tensor((1 - 2 * a) * np.exp(-a))


def sponge(shape, width: int, strength: float, free_surface: bool) -> torch.Tensor:
    """The product over axes of ``exp(-strength (width - e)^2 / width)`` for
    a cell ``e < width`` cells from a damped edge (1 elsewhere); with a free
    surface, axis 0's top edge is not damped. Float64 on the CPU."""
    out = torch.ones(shape, dtype=torch.float64)
    for ax, n in enumerate(shape):
        i = np.arange(n)
        e = (n - 1 - i) if (free_surface and ax == 0) else np.minimum(i, n - 1 - i)
        f = np.where(e < width, np.exp(-strength * (width - e) ** 2.0 / width), 1.0)
        out = out * torch.as_tensor(f).reshape([n if a == ax else 1 for a in range(len(shape))])
    return out


def resampling(nt: int, dt: float, dtrec):
    """``(i0, w)`` of the samples kept at ``dtrec``: sample ``j`` is
    ``(1 - w_j) d[i0_j] + w_j d[i0_j + 1]``, every ``j dtrec`` up to the
    last row's time ``(nt - 1) dt``; ``None`` without ``dtrec``."""
    if dtrec is None:
        return None
    t = np.arange(int(np.floor((nt - 1) * dt / dtrec + 1e-9)) + 1) * (dtrec / dt)
    i0 = np.minimum(np.floor(t), nt - 2).astype(np.int64)
    return i0, t - i0


class Scheme:
    """The scheme on a window for a batch of shots (a leading dimension of
    every field), in float32, its fields stored in ``fields`` (float32;
    the control's bfloat16)."""

    def __init__(self, cfg: dict, device, fields: str = "float32", history: str = "int8"):
        dtype = torch.float32
        self.cfg, self.device, self.dtype = cfg, device, dtype
        if fields == "bfloat16":
            self.store = lambda x: x.to(torch.bfloat16).to(dtype)
        elif fields == "float32":
            self.store = lambda x: x
        else:
            raise ValueError(f"fields must be 'float32' or 'bfloat16', not {fields!r}")
        self.shape = tuple(cfg["window_shape"])
        self.nt, self.dt = int(cfg["nt"]), float(cfg["dt_s"])
        self.dx = float(cfg["spacing_m"])
        self.lap = Laplacian(self.shape, int(cfg["space_order"]), dtype, device)
        self.S = sponge(self.shape, int(cfg["sponge_width"]), float(cfg["sponge_strength"]),
                        bool(cfg["free_surface"])).to(dtype=dtype, device=device)
        w = ricker(self.nt, self.dt, float(cfg["peak_frequency_hz"])) * self.dt**2
        self.src_amp = w.to(dtype=dtype, device=device)
        self.levels = LEVELS[history]
        self.rs = resampling(self.nt, self.dt, cfg.get("dtrec_s"))
        self.hist = None

    def _C(self, c):
        return (c.double() ** 2 * (self.dt**2 / self.dx**2)).to(self.dtype)

    def record(self, tr):
        """The traces kept, ``R d``, in float64."""
        if self.rs is None:
            return tr.double()
        i0, w = (torch.as_tensor(a, device=tr.device) for a in self.rs)
        w = w.reshape((-1,) + (1,) * (tr.ndim - 1))
        return (1 - w) * tr[i0].double() + w * tr[i0 + 1].double()

    def record_transpose(self, r):
        """``R^T r`` on the rows of every step, float64."""
        if self.rs is None:
            return r
        i0, w = (torch.as_tensor(a, device=r.device) for a in self.rs)
        w = w.reshape((-1,) + (1,) * (r.ndim - 1))
        out = torch.zeros((self.nt,) + tuple(r.shape[1:]), dtype=torch.float64,
                          device=r.device)
        out.index_add_(0, i0, (1 - w) * r)
        out.index_add_(0, i0 + 1, w * r)
        return out

    def traces(self, c, src, rcv, store: bool = False):
        """``(nt, nshots, nrcv)`` traces, every step's, of the windows'
        velocities ``c`` ``(nshots, *shape)`` with the window-relative source
        indices ``src`` ``(nshots,)``; with ``store`` the coded history
        ``u_0 .. u_{nt-1}`` is kept."""
        B = c.shape[0]
        C = self._C(c)
        u_prev = torch.zeros(c.shape, dtype=self.dtype, device=self.device)
        u = torch.zeros_like(u_prev)
        out = torch.empty((self.nt, B, rcv.numel()), dtype=self.dtype, device=self.device)
        shots = torch.arange(B, device=self.device)
        if store:
            self.hist = torch.empty((self.nt,) + tuple(c.shape), dtype=torch.int8,
                                    device=self.device)
            self.scale = torch.empty((self.nt, B), dtype=torch.float32, device=self.device)
        for k in range(self.nt):
            if store:
                s = torch.clamp(torch.amax(torch.abs(u).reshape(B, -1), 1).float(), min=1e-30)
                self.scale[k] = s / self.levels
                q = u.float() * (self.levels / s).reshape((B,) + (1,) * len(self.shape))
                self.hist[k] = torch.round(q).to(torch.int8)
            nxt = self.lap(u)
            nxt *= C
            nxt += 2 * u
            nxt -= u_prev
            nxt *= self.S
            flat = nxt.view(B, -1)
            flat[shots, src] += self.src_amp[k]
            nxt = self.store(nxt)
            out[k] = nxt.view(B, -1)[:, rcv]
            u_prev, u = u, nxt
        return out

    def gradient(self, c, rcv, resid):
        """``dphi/dc`` on each window ``(nshots, *shape)``, for the residual
        of every step ``resid`` ``(nt, nshots, nrcv)``, from the history the
        last ``traces(store=True)`` kept."""
        B = c.shape[0]
        C = self._C(c)
        e1 = torch.zeros(c.shape, dtype=self.dtype, device=self.device)  # e_{j+1}
        e2 = torch.zeros_like(e1)  # e_{j+2}
        gC = torch.zeros(c.shape, dtype=torch.float32, device=self.device)
        resid = resid.to(self.dtype)
        bshape = (B,) + (1,) * len(self.shape)
        for j in range(self.nt, 0, -1):
            a = self.lap(C * e1)
            a += 2 * e1
            a -= e2
            a.view(B, -1)[:, rcv] += resid[j - 1]
            a *= self.S
            a = self.store(a)
            u = self.hist[j - 1].to(self.dtype) * self.scale[j - 1].to(self.dtype).reshape(bshape)
            gC += (self.lap(u) * a).float()
            e1, e2 = a, e1
        self.hist = None
        return gC * (2.0 * c.float()) * (self.dt**2 / self.dx**2)


def _window(m, corner, shape):
    return m[tuple(slice(int(c0), int(c0) + int(n)) for c0, n in zip(corner, shape))]


def batch(cfg: dict, shots, rcv_flat, c0, *, c_true=None, device, fields: str = "float32",
          history: str = "int8"):
    """The reference's outputs for the shots ``[(corner, src), ...]`` with
    the window-relative receivers ``rcv_flat``: ``{"traces"}`` (nshots,
    ntrec, nrcv) of ``c0``, and with ``c_true`` the objective against the
    traces of ``c_true``, ``{"phi", "grad"}``."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sch = Scheme(cfg, device, fields, history)
        rcv = torch.as_tensor(rcv_flat, device=device)
        shape = sch.shape
        per = math.prod(shape) * sch.nt  # history bytes a shot
        at_once = max(1, int(HISTORY_BUDGET_BYTES // per))
        out = {"traces": []}
        if c_true is not None:
            out["phi"] = 0.0
            out["grad"] = torch.zeros(c0.shape, dtype=torch.float32, device=device)
        for b0 in range(0, len(shots), at_once):
            group = shots[b0:b0 + at_once]
            src = torch.as_tensor([s for _, s in group], device=device)
            cw = torch.stack([_window(c0, corner, shape) for corner, _ in group])
            if c_true is None:
                out["traces"].append(sch.record(sch.traces(cw, src, rcv)))
                continue
            ct = torch.stack([_window(c_true, corner, shape) for corner, _ in group])
            obs = sch.record(sch.traces(ct, src, rcv))
            del ct
            tr = sch.record(sch.traces(cw, src, rcv, store=True))
            resid = tr - obs
            out["phi"] += 0.5 * float(torch.sum(resid * resid))
            del obs
            g = sch.gradient(cw, rcv, sch.record_transpose(resid))
            for (corner, _), gb in zip(group, g):
                _window(out["grad"], corner, shape).add_(gb)
            out["traces"].append(tr)
        out["traces"] = torch.cat(out["traces"], 1).transpose(0, 1).float()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
