"""Share of a step in which no operation runs on the device: 1 - the
profiled stretch's busy seconds a step over the plain window's seconds a
step (the profiler's overhead stays out of the step time)."""


def read(ctx):
    busy = ctx["trace"]["busy_s"] / ctx["trace"]["steps"]
    return 1.0 - busy / (ctx["window"]["wall_s"] / ctx["window"]["steps"])
