"""``cram.rans1`` spans (each order-1 rANS stream, the qualities,
decoded on the host) summed over the executor workers, per million
records converted."""

from benchmark.metrics._shared import span_per_mrec


def read(m):
    return span_per_mrec(m, "cram.rans1")
