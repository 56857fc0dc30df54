"""Device ms a step inside the program's ``res5`` spans
(``ResNetRes5Head.forward``: MEGA over the 2L whole C4 maps, FGFA over the L
aggregated maps), start event to end event."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.per_step(ctx, program_spans.span_ms("res5"))
