"""Device ms launched inside ``ops/nms.py:nms`` a step: the RPN's and the
detections' per-class NMS."""


def read(ctx):
    return ctx["trace"]["range_ms_per_step"].get("nms") or None
