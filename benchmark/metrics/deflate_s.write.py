"""``bam.write.deflate`` spans (BGZF deflate, virtual offsets, index fragments) per million records written."""

from benchmark.metrics._shared import span_per_mrec


def read(m):
    return span_per_mrec(m, "bam.write.deflate")
