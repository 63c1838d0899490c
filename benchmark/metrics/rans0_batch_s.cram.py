"""``cram.rans0.batch`` spans (each CRAM split's order-0 rANS streams
staged, decoded in one B3 launch and copied back) per million records
converted."""

from benchmark.metrics._shared import span_per_mrec


def read(m):
    return span_per_mrec(m, "cram.rans0.batch")
