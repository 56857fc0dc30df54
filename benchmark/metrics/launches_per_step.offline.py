"""Kernel launches a lockstep step: kernels executed on the device in the
profiled stretch, over its steps."""


def read(ctx):
    return ctx["trace"]["launches_per_step"]
