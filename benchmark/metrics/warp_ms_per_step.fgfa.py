"""Device ms launched inside ``ops/warp.py:warp_by_flow`` a step (every
window frame's map and embedding to the key)."""


def read(ctx):
    return ctx["trace"]["range_ms_per_step"].get("warp_by_flow") or None
