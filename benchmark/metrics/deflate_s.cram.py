"""``bam.write.deflate`` spans (BGZF deflate, virtual offsets, index
fragments) of each conversion's BAM write, per million records
converted."""

from benchmark.metrics._shared import span_per_mrec


def read(m):
    return span_per_mrec(m, "bam.write.deflate")
