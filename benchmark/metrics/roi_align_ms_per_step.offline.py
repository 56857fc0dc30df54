"""Device ms a step inside the program's ``roi_align`` spans
(``ops/roi_align.py:roi_align``), start event to end event."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.per_step(ctx, program_spans.span_ms("roi_align"))
