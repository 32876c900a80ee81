"""Share of the traced solves' wall time in which no device operation ran,
in %: ``1 - busy_s / window_s``."""


def read(ctx):
    t = ctx["trace"]
    if not ctx["counts"].get("iterations") or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
