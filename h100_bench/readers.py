"""What the wave cells' metric readers compute; each metric has a file of
its own under ``end_to_end/`` or ``layer_metrics/`` that names one of
these. A reader returns ``None`` where its run has nothing to read."""
from __future__ import annotations

__all__ = ["seconds_per_shot", "launches_per_step", "step_roofline", "idle_pct"]


def seconds_per_shot(ctx):
    """Wall seconds of the window per shot completed in it. The window runs
    whole units and closes when the last unit started ends."""
    shots = sum(u.get("shots", 0) for u in ctx["units"])
    return ctx["window_s"] / shots if shots else None


def _traced_steps(ctx):
    steps = ctx["counts"].get("steps")
    return steps if steps and ctx["trace"]["busy_s"] > 0 else None


def launches_per_step(ctx):
    """Device operations (kernels, copies, sets) per shot-step in the
    traced units: ``device_ops / (shots * nt)``."""
    steps = _traced_steps(ctx)
    return ctx["trace"]["device_ops"] / steps if steps else None


def step_roofline(ctx):
    """Share of the least time of the traced units' wave steps
    (``work/wave.py`` at the cell's order and number of dimensions: the
    larger of bytes over the HBM rate and operations over the float32
    peak, ``peaks.py``) in the device-busy time, in %."""
    return 100.0 * ctx["least_s"] / ctx["trace"]["busy_s"] if _traced_steps(ctx) else None


def idle_pct(ctx):
    """Share of the traced units' wall time in which no device operation
    ran, in %: ``1 - busy_s / window_s``."""
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if _traced_steps(ctx) else None
