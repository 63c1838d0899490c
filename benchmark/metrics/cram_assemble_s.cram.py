"""``cram.records.assemble`` spans (each container's series to records:
the read features against the reference, the attached mates) summed
over the executor workers, per million records converted."""

from benchmark.metrics._shared import span_per_mrec


def read(m):
    return span_per_mrec(m, "cram.records.assemble")
