"""``bam.write.encode`` spans (shard slice and record encode) per million records written."""

from benchmark.metrics._shared import span_per_mrec


def read(m):
    return span_per_mrec(m, "bam.write.encode")
