"""``bam.write.compress`` spans (each part's zlib-6 BGZF deflate and its
records' virtual offsets, inside ``bam.write.deflate``), summed over
the writers, per million records written."""

from benchmark.metrics._shared import span_per_mrec


def read(m):
    return span_per_mrec(m, "bam.write.compress")
