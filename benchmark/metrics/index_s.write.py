"""``bam.write.index`` spans (each part's BAI and SBI fragments, inside
``bam.write.deflate``), summed over the writers, per million records
written."""

from benchmark.metrics._shared import span_per_mrec


def read(m):
    return span_per_mrec(m, "bam.write.index")
