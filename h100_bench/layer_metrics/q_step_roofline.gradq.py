"""``q_step_roofline.gradq`` of ``overthrust-visco-grad``: K14's share of its
roofline in the traced units, in %: the least time of the K14 launches the
program counted (``launches.fused_q_step`` times one launch's least bytes and
operations, ``work/wave_q.py``, which the driver hands over as ``q_step_bytes``
and ``q_step_flops``) over the device time of ``q_step_kernel`` in the trace's
table of device operations. ``None`` where either is absent."""
from h100_bench import peaks

KERNEL = "q_step_kernel"


def read(ctx):
    counts = ctx["counts"]
    if not counts.get("launches.fused_q_step"):
        return None
    device_s = sum(s for name, s in ctx["trace"]["top_device_ops"] if KERNEL in name)
    if device_s <= 0:
        return None
    least = peaks.least_seconds({"bytes": counts["q_step_bytes"],
                                 "flops": counts["q_step_flops"]})
    return 100.0 * least / device_s
