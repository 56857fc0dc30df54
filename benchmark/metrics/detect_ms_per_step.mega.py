"""Device ms launched inside MEGA's ``detect_key`` a step: the global
enhancement, the three attention stages, the predictor and the per-class
NMS."""


def read(ctx):
    return ctx["trace"]["range_ms_per_step"].get("detect_key") or None
