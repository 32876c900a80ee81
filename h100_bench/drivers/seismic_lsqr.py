"""The system under test for the linearized seismic flagship:
``jets_tpu_torch``'s ``seismic_operator_from_arrays`` (the fused operator
with its adjoint epilogue hook: K2 each iteration, K3 at a solve's start,
K1 for x and w) under ``jets_tpu_torch.solvers.lsqr``.

A unit is one ``lsqr(A, b_j, maxiter, tol)`` solve from zero, ending in
``torch.cuda.synchronize()``; ``b_j`` cycles over a pool of data vectors
made from the seed. The answers kept are every solve's residual history
and the ``x`` of the last solve of each data vector.
"""
from __future__ import annotations

import gc

import torch

from .. import inputs
from ..compare import rel_l2
from ..reference import seismic_lsqr as ref
from ..work.lsqr import solve_work


class System:
    def __init__(self, cfg: dict, traffic: dict, schedule, device, warm: bool = True):
        from jets_tpu_torch.models.seismic import seismic_operator_from_arrays
        from jets_tpu_torch.solvers import lsqr

        if traffic["unit"] != "solve":
            raise ValueError(f"seismic_lsqr runs 'solve' units, not {traffic['unit']!r}")
        self.cfg, self.traffic, self.device, self.schedule = cfg, traffic, device, schedule
        self.stages = {}
        self.maxiter, self.tol = int(traffic["maxiter"]), float(traffic["tol"])
        self.lsqr = lsqr
        shape = tuple(cfg["grid_shape"])
        self.wr = inputs.flagship_weights(cfg, schedule.seed, device)
        self.A_ref = ref.Seismic(shape, inputs.flagship_receivers(cfg), self.wr)
        self.bs = []
        for item in schedule.pool:  # b = A m + noise, made by the reference's A
            d = self.A_ref.forward(inputs.flagship_model(cfg, int(item[0]), device))
            g = inputs.generator(int(item[0]), device, 4)
            eps = torch.randn(d.shape, generator=g, device=device, dtype=d.dtype)
            self.bs.append((d + float(cfg["noise"]) * torch.std(d, correction=0) * eps)
                           .to(torch.float32).contiguous())
        self.A = seismic_operator_from_arrays(
            shape, int(cfg["nshots"]), int(cfg["nreceivers"]), wr=self.wr,
            impl=cfg["impl"], epilogue_hook=bool(cfg["epilogue_hook"]), device=device)
        if warm:
            self.lsqr(self.A, self.bs[0], maxiter=self.maxiter, tol=self.tol)
        self._sync()
        self.hists, self.xs = [], {}

    def _sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def counts(self) -> dict:
        return {"solves": 1, "iterations": self.maxiter}

    def work(self) -> dict:
        cfg = self.cfg
        return solve_work(cfg["grid_shape"], int(cfg["nshots"]), int(cfg["nreceivers"]),
                          self.maxiter)

    def run_unit(self, i: int) -> dict:
        j = self.schedule.item(i)
        res = self.lsqr(self.A, self.bs[j], maxiter=self.maxiter, tol=self.tol)
        self._sync()
        self.hists.append((j, res.history))
        self.xs[j] = res.x
        return {"solves": 1, "iterations": int(res.iterations)}

    def release(self):
        self.A = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, j: int, control=None):
        dtype = torch.bfloat16 if control == "bfloat16" else torch.float64
        A = ref.Seismic(self.cfg["grid_shape"], inputs.flagship_receivers(self.cfg),
                        self.wr, dtype=dtype)
        return ref.lsqr(A, self.bs[j], self.maxiter)

    def check(self, outputs=None) -> dict:
        """``x_rel``: the worst data vector's ``||x - x_ref|| / ||x_ref||``;
        ``hist_rel``: the worst ``|h - h_ref| / h_ref`` over every solve's
        residual history."""
        hists, xs = (self.hists, self.xs) if outputs is None else outputs
        want = {j: self.reference(j) for j in sorted(xs)}
        x_rel = max(rel_l2(x, want[j][0]) for j, x in xs.items())
        hist_rel = max(float(torch.max(torch.abs(h.double() - want[j][1])
                                       / torch.abs(want[j][1])))
                       for j, h in hists)
        return {"x_rel": x_rel, "hist_rel": hist_rel}

    def control(self, kind: str):
        """The control's answers: the reference at ``kind`` in the program's
        place, one solve of each data vector."""
        xs, hists = {}, []
        for j in range(len(self.bs)):
            x, h = self.reference(j, control=kind)
            xs[j] = x
            hists.append((j, h))
        return hists, xs


def positions(cfg: dict) -> int:
    return 0
