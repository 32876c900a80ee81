"""Wall milliseconds of the window per LSQR iteration done in it, each
solve's start included."""


def read(ctx):
    its = sum(u.get("iterations", 0) for u in ctx["units"])
    return 1e3 * ctx["window_s"] / its if its else None
