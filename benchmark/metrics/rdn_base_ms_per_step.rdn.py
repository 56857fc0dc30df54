"""Device ms a step inside the program's ``rdn_base`` spans (RDN's base
attention stages in ``RDNFeatureExtractor._stages``, inside ``detect_key``),
start event to end event."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.per_step(ctx, program_spans.span_ms("rdn_base"))
