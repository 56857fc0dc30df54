"""Device ms a step inside the program's ``carry`` spans: the lockstep step's
reset, push, global-update and emit selects over the carry
(``engine/batched_inference.py``), start event to end event."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.per_step(ctx, program_spans.span_ms("carry"))
