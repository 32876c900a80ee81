"""The system under test for windowed visco-acoustic (constant-Q) FWI in
3-D: ``jets_tpu_torch``'s ``multishot_q_wave_operator`` (Ginsu windows of
both blocks, int8 stored-history adjoint, the configuration's
``shot_map``) under ``least_squares_objective``, on a ``(c, Q)`` model.

The velocity fields are ``inputs.models``'; the quality factors follow the
configuration's ``q_law`` of them, ``Q = coefficient * (c /
velocity_unit_m_s) ** exponent``, the true one of the true velocity and the
starting one of the starting velocity. The observed traces are modelled by
the program from ``(c_true, Q_true)`` in set-up.

A unit is one batch of ``shots_per_unit`` shots: ``"gradient"`` evaluates
``least_squares_objective(F, d)((c0, Q0))``, as an L-BFGS iteration waits
on it. It returns, beside the shots and shot-steps, the unit's increase of
the program's counters ``steps.reverse`` and ``launches.fused_q_step`` (K14
launches) and the least bytes and operations of those launches. Each unit
ends in ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import torch

from .. import inputs
from ..compare import rel_l2
from ..reference import wave_qfwi as ref
from ..work.wave_q import q_step_work, unit_work
from .wave_fwi import System as _IsoSystem
from .wave_fwi import positions  # noqa: F401  (the same source positions)

COUNTERS = ("steps.reverse", "launches.fused_q_step")
CONTROLS = {"bfloat16": {"fields": "bfloat16"}, "int4": {"history": "int4"},
            "bfloat16_friction": {"friction": "bfloat16"}}


def _program():
    from jets_tpu_torch.core.blockspace import BlockVector
    from jets_tpu_torch.ops.wave import multishot_q_wave_operator
    from jets_tpu_torch.utils.profiling import counters

    from .wave_fwi import _program as iso_program

    _, lso, Recording = iso_program()
    return multishot_q_wave_operator, lso, Recording, BlockVector, counters


def q_of(c, cfg: dict):
    """The quality factor of the velocity ``c`` by the configuration's
    ``q_law``, float32."""
    law = cfg["q_law"]
    v = c.double() / float(law["velocity_unit_m_s"])
    return (float(law["coefficient"]) * v ** float(law["exponent"])).float()


class System(_IsoSystem):
    """The cell's program objects, made from the seed; ``warm=False`` (the
    calibration's readings, which time nothing) skips the warm-up."""

    def __init__(self, cfg: dict, traffic: dict, schedule, device, warm: bool = True):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.unit = traffic["unit"]
        if self.unit != "gradient":
            raise ValueError(f"wave_qfwi runs 'gradient' units, not {self.unit!r}")
        self.schedule = schedule
        self.stages = {}
        lap = self._stopwatch()
        self.c_true, self.c0 = inputs.models(cfg, schedule.seed, device)
        self.q_true, self.q0 = q_of(self.c_true, cfg), q_of(self.c0, cfg)
        self.stages["inputs"] = lap()
        self.batches = [[inputs.shot_geometry(cfg, int(p)) for p in row]
                        for row in schedule.pool]
        self.rcv = inputs.receiver_flat(cfg)
        msq, lso, Recording, BlockVector, self._counters = _program()

        def operator(shots):
            return msq(
                tuple(cfg["grid_shape"]), [s for _, s in shots], nt=int(cfg["nt"]),
                dt=float(cfg["dt_s"]), dx=float(cfg["spacing_m"]),
                freq=float(cfg["peak_frequency_hz"]), f0=float(cfg["f0_hz"]),
                rcv_idx=self.rcv, sponge_width=int(cfg["sponge_width"]),
                space_order=int(cfg["space_order"]), window_corners=[c for c, _ in shots],
                window_shape=tuple(cfg["window_shape"]), dtrec=cfg.get("dtrec_s"),
                store_adjoint=cfg["history"], free_surface=bool(cfg["free_surface"]),
                shot_map=cfg["shot_map"], device=device)

        self.ops = [Recording(operator(b)) for b in self.batches]
        self.m0 = BlockVector((self.c0, self.q0), self.ops[0].dom)
        self.stages["operators"] = lap()
        m_true = BlockVector((self.c_true, self.q_true), self.ops[0].dom)
        # the observed traces, modelled by the program
        self.fns = [lso(op, op(m_true)) for op in self.ops]
        del m_true
        self.stages["observed"] = lap()
        if warm:
            # at the unit's shapes: in "map" mode a shot runs alone, so one
            # shot of the first batch; in "vmap" mode the batch is one program
            op = operator(self.batches[0][:1] if cfg["shot_map"] == "map" else self.batches[0])
            lso(op, torch.zeros(op.rng.shape, device=device))(self.m0)
            del op
            self.stages["warm-up"] = lap()
        self.last = None
        self._want = {}

    def work(self) -> dict:
        cfg = self.cfg
        return unit_work(self.unit, shots=int(self.traffic["shots_per_unit"]),
                         nt=int(cfg["nt"]), window_shape=cfg["window_shape"],
                         nreceivers=len(self.rcv), order=int(cfg["space_order"]))

    def run_unit(self, i: int) -> dict:
        before = self._counters(COUNTERS)
        b = self.schedule.item(i)
        self.last = None  # the previous unit's outputs are not needed any more
        for op in self.ops:
            op.seen[0] = None
        phi, g = self.fns[b](self.m0)
        self._sync()
        self.last = {"batch": b, "phi": phi, "grad": g[0], "gradq": g[1],
                     "traces": self.ops[b].seen[0]}
        after = self._counters(COUNTERS)
        out = dict(self.counts(), **{k: after[k] - before[k] for k in COUNTERS})
        k14 = q_step_work(self.cfg["window_shape"], int(self.cfg["space_order"]))
        out["q_step_bytes"] = out["launches.fused_q_step"] * k14["bytes"]
        out["q_step_flops"] = out["launches.fused_q_step"] * k14["flops"]
        return out

    def reference(self, b: int, control=None) -> dict:
        """The reference's outputs for batch ``b``: float32 with the
        configuration's history, or the control: ``"bfloat16"`` fields, an
        ``"int4"`` history or ``"bfloat16_friction"``."""
        if torch.device(self.device).type == "cuda":
            # a 3-D shot's history takes most of the card: hand back what an
            # earlier reference left cached, which later blocks have split
            import gc

            gc.collect()
            torch.cuda.empty_cache()
        return ref.batch(self.cfg, self.batches[b], self.rcv, self.c0, self.q0,
                         c_true=self.c_true, q_true=self.q_true, device=self.device,
                         **CONTROLS.get(control, {}))

    def check(self, outputs=None) -> dict:
        """``{name: value}`` of the numbers compared: the last unit's outputs
        (or ``outputs``, the control's) against the reference's; the
        gradient's velocity block (``grad_rel``) and Q block (``gradq_rel``)
        apart."""
        out = self.last if outputs is None else outputs
        if out["batch"] not in self._want:
            self._want[out["batch"]] = self.reference(out["batch"])
        want = self._want[out["batch"]]
        return {"traces_rel": rel_l2(out["traces"], want["traces"]),
                "phi_rel": abs(float(out["phi"]) - want["phi"]) / abs(want["phi"]),
                "grad_rel": rel_l2(out["grad"], want["grad"]),
                "gradq_rel": rel_l2(out["gradq"], want["gradq"])}
