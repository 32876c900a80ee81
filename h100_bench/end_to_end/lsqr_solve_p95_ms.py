"""The 95th percentile of the wall milliseconds of every solve in the
window, each ending in a synchronize (``statistics.quantiles``, n=100,
inclusive)."""
import statistics


def read(ctx):
    walls = [1e3 * u["wall_s"] for u in ctx["units"] if u.get("solves")]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=100, method="inclusive")[94]
