"""Seconds from the start of the process to the start of the first timed
unit: imports, the device's start, inputs, the program's set-up and
warm-up (and, on a checkout's first run, the kernels' build)."""


def read(ctx):
    return ctx["setup_s"]
