"""Share of the least time of the traced solves (``work/lsqr.py``: each
iteration's dense and data-space bytes, and each solve's start) in the
device-busy time, in %."""


def read(ctx):
    if not ctx["counts"].get("iterations") or ctx["trace"]["busy_s"] <= 0:
        return None
    return 100.0 * ctx["least_s"] / ctx["trace"]["busy_s"]
