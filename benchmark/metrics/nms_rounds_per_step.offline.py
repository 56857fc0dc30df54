"""NMS host rounds a lockstep step: the program's counter ``nms.rounds``
(``ops/nms.py``, one a peel round or chunk step, each a device
synchronisation) over the traced stretch's steps."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.per_step(ctx, program_spans.counter("nms.rounds"))
