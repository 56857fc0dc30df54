"""The program's own spans and counters (``mega_pytorch_tpu_torch/utils/profiler.py``),
read after a traced stretch: the port records them while ``torch.profiler``
records, and ``recorded()`` sums up that stretch alone. A program without
the recorder (an older checkout), or one whose stretch holds no such span or
counter, gives ``None``, so the metric is left out of the result line."""

from __future__ import annotations


def recorded():
    """The program's summary of the traced stretch, or None."""
    try:
        from mega_pytorch_tpu_torch.utils import profiler

        summary = profiler.recorded()
    except (ImportError, AttributeError):
        return None
    return summary if summary.get("spans") or summary.get("counters") else None


def span_ms(name: str, clock: str = "device_ms"):
    """Total ms of the spans called ``name`` on ``clock`` ("device_ms" or
    "host_ms"), or None."""
    summary = recorded()
    span = summary["spans"].get(name) if summary else None
    return None if span is None else span.get(clock)


def counter(name: str):
    """Total of the counter ``name``, or None."""
    summary = recorded()
    return None if summary is None else summary["counters"].get(name)


def per_step(ctx: dict, value):
    return None if value is None else value / ctx["trace"]["steps"]
