"""Seconds from the start of the process to the first timed request:
imports, the kernels' build or load, weights, traffic, captures and the
warm requests."""


def read(ctx):
    return ctx["setup_s"]
