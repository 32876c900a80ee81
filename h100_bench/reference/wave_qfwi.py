"""Plain reference of windowed visco-acoustic (constant-Q) FWI in 3-D: the
traces, the least-squares objective and its gradient with respect to the
velocity ``c`` and the quality factor ``Q``, in plain PyTorch.

The scheme, as the configuration states it: Kosloff friction at the rate
``pi f0 / Q``, centred in time, on ``reference/wave_fwi.py``'s leapfrog
(``C = c^2 dt^2 / dx^2``, ``L`` the order-``p`` Laplacian with a zero
boundary, ``S`` the sponge, ``w`` the Ricker wavelet), with ``g = pi f0 dt
/ Q``, ``og = 1 - g`` and ``ig = 1 / (1 + g)``::

    u_{k+1} = S * ig * (2 u_k - og u_{k-1} + C L u_k) + dt^2 w_k delta_src,
    u_0 = u_{-1} = 0,   d_k = u_{k+1}[receivers],   k = 0 .. nt-1.

The traces kept (``dtrec``) and the objective ``phi = 1/2 sum_shots |R d -
obs|^2`` are ``wave_fwi.py``'s. The gradient is the discrete adjoint of
the scheme: with ``r = R^T (R d - obs)``, ``sbar_k = S a_{k+1}``, ``ebar_k
= ig sbar_k`` and ``ebar_nt = sbar_nt = 0``,

    a_k = P^T r_{k-1} + 2 ebar_k + L(C ebar_k) - og ebar_{k+1},  k = nt-1 .. 0,
    a_nt = P^T r_{nt-1},
    dphi/dC  = sum_k L(u_k) ebar_k,
    dphi/dig = sum_k sbar_k (2 u_k + C L u_k) - og u_k sbar_{k+1},
    dphi/dog = -sum_k u_k ebar_{k+1},
    dphi/dg  = -dphi/dog - ig^2 dphi/dig,
    dphi/dc  = dphi/dC * 2 c dt^2 / dx^2,   dphi/dQ = -dphi/dg * g / Q,

``u_k`` read back from the stored history coded as ``wave_fwi.py`` codes
it (``int8``: 127 levels of each shot's snapshot's largest magnitude; the
control's ``int4``: 7). With ``g = 0`` (``Q`` infinite) every step, and so
the traces, ``phi`` and ``dphi/dc``, is ``wave_fwi.py``'s bit for bit.

Controls: ``fields="bfloat16"`` rounds every wavefield the scheme stores
(``u``, ``sbar``) to bfloat16 as it is written, as ``wave_fwi.py`` does;
``friction="bfloat16"`` rounds ``g`` to bfloat16 in both sweeps (its
chain factor ``g / Q`` stays unrounded), as a program that streams the
friction field in bfloat16 would.

Shots run together as a leading batch dimension as far as their
histories fit in ``wave_fwi.HISTORY_BUDGET_BYTES``; each runs in its
window of the model and its gradient pair is added into the full model's.
Matrix products with TF32 off. Nothing here imports the program or takes
anything it made.
"""
from __future__ import annotations

import math

import torch

from .wave_fwi import (HISTORY_BUDGET_BYTES, LEVELS, Laplacian, _window, resampling, ricker,
                       sponge)

__all__ = ["QScheme", "batch", "q_friction"]


def q_friction(q, cfg: dict) -> torch.Tensor:
    """``g = pi f0 dt / Q`` in float32 (computed in float64)."""
    return (math.pi * float(cfg["f0_hz"]) * float(cfg["dt_s"]) / q.double()).float()


class QScheme:
    """The scheme on a window for a batch of shots (a leading dimension of
    every field), in float32; ``fields`` and ``friction`` the controls'
    bfloat16 or float32, ``history`` the history's code."""

    def __init__(self, cfg: dict, device, fields: str = "float32", history: str = "int8",
                 friction: str = "float32"):
        dtype = torch.float32
        self.cfg, self.device, self.dtype = cfg, device, dtype
        if fields not in ("float32", "bfloat16") or friction not in ("float32", "bfloat16"):
            raise ValueError("fields and friction are 'float32' or 'bfloat16'")
        self.store = ((lambda x: x.to(torch.bfloat16).to(dtype)) if fields == "bfloat16"
                      else (lambda x: x))
        self.round_g = ((lambda g: g.to(torch.bfloat16).to(dtype)) if friction == "bfloat16"
                        else (lambda g: g))
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

    def _og_ig(self, q):
        g = self.round_g(q_friction(q, self.cfg))
        return g, 1.0 - g, 1.0 / (1.0 + g)

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

    def traces(self, c, q, src, rcv, store: bool = False):
        """``(nt, nshots, nrcv)`` traces, every step's, of the windows'
        ``(c, Q)`` ``(nshots, *shape)`` with the window-relative source
        indices ``src`` ``(nshots,)``; with ``store`` the coded history
        ``u_0 .. u_{nt-1}`` is kept."""
        B = c.shape[0]
        C = self._C(c)
        _, og, ig = self._og_ig(q)
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
                code = u.float() * (self.levels / s).reshape((B,) + (1,) * len(self.shape))
                self.hist[k] = torch.round(code).to(torch.int8)
            nxt = self.lap(u)
            nxt *= C
            nxt += 2 * u
            nxt -= og * u_prev
            nxt *= ig
            nxt *= self.S
            flat = nxt.view(B, -1)
            flat[shots, src] += self.src_amp[k]
            nxt = self.store(nxt)
            out[k] = nxt.view(B, -1)[:, rcv]
            u_prev, u = u, nxt
        return out

    def gradient(self, c, q, rcv, resid):
        """``(dphi/dc, dphi/dQ)`` on each window ``(nshots, *shape)``, for the
        residual of every step ``resid`` ``(nt, nshots, nrcv)``, from the
        history the last ``traces(store=True)`` kept."""
        B = c.shape[0]
        C = self._C(c)
        _, og, ig = self._og_ig(q)
        zeros = torch.zeros(c.shape, dtype=self.dtype, device=self.device)
        s1 = e1 = zeros  # sbar_{k+1}, ebar_{k+1}
        gC, gig, gog = (torch.zeros_like(zeros) for _ in range(3))
        resid = resid.to(self.dtype)
        bshape = (B,) + (1,) * len(self.shape)
        a = zeros.clone()  # a_nt
        a.view(B, -1)[:, rcv] += resid[self.nt - 1]
        for k in range(self.nt - 1, -1, -1):
            sb = self.store(a * self.S)
            e = ig * sb
            u = self.hist[k].to(self.dtype) * self.scale[k].to(self.dtype).reshape(bshape)
            lu = self.lap(u)
            gC += lu * e
            gig += sb * (2 * u + C * lu) - og * (u * s1)
            gog -= u * e1
            if k > 0:
                a = self.lap(C * e)
                a += 2 * e
                a -= og * e1
                a.view(B, -1)[:, rcv] += resid[k - 1]
            s1, e1 = sb, e
        self.hist = None
        gc = gC * (2.0 * c.float()) * (self.dt**2 / self.dx**2)
        gg = -gog.double() - (ig.double() ** 2) * gig.double()
        gq = -gg * q_friction(q, self.cfg).double() / q.double()
        return gc, gq.float()


def batch(cfg: dict, shots, rcv_flat, c0, q0, *, c_true=None, q_true=None, device,
          fields: str = "float32", history: str = "int8", friction: str = "float32"):
    """The reference's outputs for the shots ``[(corner, src), ...]`` with
    the window-relative receivers ``rcv_flat``: ``{"traces"}`` (nshots,
    ntrec, nrcv) of ``(c0, q0)``, and with ``(c_true, q_true)`` the
    objective against the traces of ``(c_true, q_true)``, ``{"phi", "grad",
    "gradq"}`` (the gradient's velocity and Q blocks on the full grid)."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        sch = QScheme(cfg, device, fields, history, friction)
        rcv = torch.as_tensor(rcv_flat, device=device)
        shape = sch.shape
        per = math.prod(shape) * sch.nt  # history bytes a shot
        at_once = max(1, int(HISTORY_BUDGET_BYTES // per))
        out = {"traces": []}
        if c_true is not None:
            out["phi"] = 0.0
            out["grad"] = torch.zeros(c0.shape, dtype=torch.float32, device=device)
            out["gradq"] = torch.zeros(c0.shape, dtype=torch.float32, device=device)
        for b0 in range(0, len(shots), at_once):
            group = shots[b0:b0 + at_once]
            src = torch.as_tensor([s for _, s in group], device=device)

            def windows(m):
                return torch.stack([_window(m, corner, shape) for corner, _ in group])

            cw, qw = windows(c0), windows(q0)
            if c_true is None:
                out["traces"].append(sch.record(sch.traces(cw, qw, src, rcv)))
                continue
            obs = sch.record(sch.traces(windows(c_true), windows(q_true), src, rcv))
            tr = sch.record(sch.traces(cw, qw, src, rcv, store=True))
            resid = tr - obs
            out["phi"] += 0.5 * float(torch.sum(resid * resid))
            del obs
            gc, gq = sch.gradient(cw, qw, rcv, sch.record_transpose(resid))
            for (corner, _), gcb, gqb in zip(group, gc, gq):
                _window(out["grad"], corner, shape).add_(gcb)
                _window(out["gradq"], corner, shape).add_(gqb)
            out["traces"].append(tr)
        out["traces"] = torch.cat(out["traces"], 1).transpose(0, 1).float()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
