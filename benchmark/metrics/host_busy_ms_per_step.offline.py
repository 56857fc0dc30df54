"""Host ms a step the lockstep step function keeps the host busy: the host
ms of the program's ``lockstep_step`` spans less the ms it waited on NMS's
host rounds (counter ``host_wait``), over the traced stretch's steps."""

from benchmark.harness import program_spans


def read(ctx):
    step = program_spans.span_ms("lockstep_step", "host_ms")
    if step is None:
        return None
    return program_spans.per_step(ctx, step - (program_spans.counter("host_wait") or 0.0))
