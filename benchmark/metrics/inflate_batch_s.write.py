"""``codec.inflate.batch`` spans of each job's read (staging, B1's
launch, the copy back, the CRC check) per million records written."""

from benchmark.metrics._shared import span_per_mrec


def read(m):
    return span_per_mrec(m, "codec.inflate.batch")
