"""Device ms launched inside RDN's ``detect_key`` a step: the base stages,
the distillation, the advanced stage, the last attention, the predictor
and the per-class NMS."""


def read(ctx):
    return ctx["trace"]["range_ms_per_step"].get("detect_key") or None
