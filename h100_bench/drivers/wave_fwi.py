"""The system under test for windowed isotropic FWI in 2-D and 3-D:
``jets_tpu_torch``'s ``multishot_wave_operator`` (Ginsu windows, int8
stored-history adjoint, the configuration's ``shot_map``) under
``least_squares_objective``.

A unit is one batch of ``shots_per_unit`` shots: ``"gradient"`` evaluates
``least_squares_objective(F, d)(c0)``, as an L-BFGS iteration waits on it;
``"forward"`` evaluates ``F(c0)``, shot-record synthesis. Each unit ends in
``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import gc
import time

import torch

from .. import inputs
from ..compare import rel_l2
from ..reference import wave_fwi as ref
from ..work.wave import unit_work


def _program():
    from jets_tpu_torch.core.jet import Operator
    from jets_tpu_torch.ops.wave import multishot_wave_operator
    from jets_tpu_torch.solvers.nonlinear import least_squares_objective

    class Recording(Operator):
        """``F`` that keeps the traces of its last application."""

        __slots__ = ("seen",)

        def __init__(self, op):
            super().__init__(op.jet)
            object.__setattr__(self, "seen", [None])

        def __call__(self, m):
            out = super().__call__(m)
            self.seen[0] = out
            return out

    return multishot_wave_operator, least_squares_objective, Recording


class System:
    """The cell's program objects, made from the seed; ``warm=False`` (the
    calibration's readings, which time nothing) skips the warm-up."""

    def __init__(self, cfg: dict, traffic: dict, schedule, device, warm: bool = True):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.unit = traffic["unit"]
        if self.unit not in ("gradient", "forward"):
            raise ValueError(f"wave_fwi runs 'gradient' or 'forward' units, not {self.unit!r}")
        self.schedule = schedule
        self.stages = {}
        lap = self._stopwatch()
        self.c_true, self.c0 = inputs.models(cfg, schedule.seed, device)
        self.stages["inputs"] = lap()
        self.batches = [[inputs.shot_geometry(cfg, int(p)) for p in row]
                        for row in schedule.pool]
        self.rcv = inputs.receiver_flat(cfg)
        msw, lso, Recording = _program()

        def operator(shots):
            return msw(
                tuple(cfg["grid_shape"]), [s for _, s in shots], nt=int(cfg["nt"]),
                dt=float(cfg["dt_s"]), dx=float(cfg["spacing_m"]),
                freq=float(cfg["peak_frequency_hz"]), rcv_idx=self.rcv,
                sponge_width=int(cfg["sponge_width"]), space_order=int(cfg["space_order"]),
                window_corners=[c for c, _ in shots], window_shape=tuple(cfg["window_shape"]),
                dtrec=cfg.get("dtrec_s"), store_adjoint=cfg["history"],
                free_surface=bool(cfg["free_surface"]), shot_map=cfg["shot_map"],
                device=device)

        self.ops = [Recording(operator(b)) for b in self.batches]
        self.stages["operators"] = lap()
        self.fns = []
        for op in self.ops:
            if self.unit == "gradient":
                d_obs = op(self.c_true)  # the observed traces, modelled by the program
                self.fns.append(lso(op, d_obs))
            else:
                self.fns.append(op)
        self.stages["observed"] = lap()
        if warm:
            # at the unit's shapes: in "map" mode a shot runs alone, so one
            # shot of the first batch; in "vmap" mode the batch is one program
            op = operator(self.batches[0][:1] if cfg["shot_map"] == "map" else self.batches[0])
            if self.unit == "gradient":
                lso(op, torch.zeros(op.rng.shape, device=device))(self.c0)
            else:
                op(self.c0)
            del op
            self.stages["warm-up"] = lap()
        self.last = None
        self._want = {}

    def _sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def _stopwatch(self):
        """``lap()``: seconds since the last lap, the device synchronised."""
        last = [time.perf_counter()]

        def lap():
            self._sync()
            now = time.perf_counter()
            out, last[0] = now - last[0], now
            return out

        return lap

    def counts(self) -> dict:
        n = int(self.traffic["shots_per_unit"])
        return {"shots": n, "steps": n * int(self.cfg["nt"])}

    def work(self) -> dict:
        cfg = self.cfg
        return unit_work(self.unit, shots=int(self.traffic["shots_per_unit"]),
                         nt=int(cfg["nt"]), window_shape=cfg["window_shape"],
                         nreceivers=len(self.rcv), order=int(cfg["space_order"]))

    def run_unit(self, i: int) -> dict:
        b = self.schedule.item(i)
        self.last = None  # the previous unit's outputs are not needed any more
        for op in self.ops:
            op.seen[0] = None
        if self.unit == "gradient":
            phi, g = self.fns[b](self.c0)
            self._sync()
            self.last = {"batch": b, "phi": phi, "grad": g,
                         "traces": self.ops[b].seen[0]}
        else:
            traces = self.fns[b](self.c0)
            self._sync()
            self.last = {"batch": b, "traces": traces}
        return self.counts()

    def release(self):
        """Drop the program's state; keep the inputs and the last unit's
        outputs."""
        for op in self.ops:
            op.seen[0] = None
        self.ops = self.fns = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, b: int, control=None) -> dict:
        """The reference's outputs for batch ``b``: float32 with the
        configuration's history, or the control: ``"bfloat16"`` fields or an
        ``"int4"`` history."""
        kw = {"bfloat16": {"fields": "bfloat16"}, "int4": {"history": "int4"}}.get(control, {})
        if torch.device(self.device).type == "cuda":
            # a 3-D shot's history takes most of the card: hand back what an
            # earlier reference left cached, which later blocks have split
            gc.collect()
            torch.cuda.empty_cache()
        return ref.batch(self.cfg, self.batches[b], self.rcv, self.c0,
                         c_true=self.c_true if self.unit == "gradient" else None,
                         device=self.device, **kw)

    def check(self, outputs=None) -> dict:
        """``{name: value}`` of the numbers compared: the last unit's outputs
        (or ``outputs``, the control's) against the reference's."""
        out = self.last if outputs is None else outputs
        if out["batch"] not in self._want:
            self._want[out["batch"]] = self.reference(out["batch"])
        want = self._want[out["batch"]]
        vals = {"traces_rel": rel_l2(out["traces"], want["traces"])}
        if self.unit == "gradient":
            vals["phi_rel"] = abs(float(out["phi"]) - want["phi"]) / abs(want["phi"])
            vals["grad_rel"] = rel_l2(out["grad"], want["grad"])
        return vals

    def control(self, kind: str) -> dict:
        """The control's outputs for the batch the last unit ran (or batch
        0): the reference in the program's place, at ``kind``."""
        b = 0 if self.last is None else self.last["batch"]
        got = self.reference(b, control=kind)
        got["batch"] = b
        return got


def positions(cfg: dict) -> int:
    """How many source positions the schedule draws from."""
    return inputs.source_positions(cfg)

