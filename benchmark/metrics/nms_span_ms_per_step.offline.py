"""Device ms a step inside the program's ``nms`` spans (``ops/nms.py:nms``),
start event to end event: NMS's kernels and the device's idle while the
host waits on NMS's rounds."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.per_step(ctx, program_spans.span_ms("nms"))
