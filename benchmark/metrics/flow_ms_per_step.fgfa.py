"""Device ms launched inside FlowNetS a step (every window frame against the
key, every lane)."""


def read(ctx):
    return ctx["trace"]["range_ms_per_step"].get("flownet") or None
