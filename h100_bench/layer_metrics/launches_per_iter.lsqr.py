"""Device operations (kernels, copies, sets) per LSQR iteration in the
traced solves, their starts included: ``device_ops / iterations``."""


def read(ctx):
    its = ctx["counts"].get("iterations")
    if not its or ctx["trace"]["busy_s"] <= 0:
        return None
    return ctx["trace"]["device_ops"] / its
