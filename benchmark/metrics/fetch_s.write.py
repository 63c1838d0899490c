"""``executor.fetch`` spans of each job's read (split planning's range
read and BGZF block walk) per million records written."""

from benchmark.metrics._shared import span_per_mrec


def read(m):
    return span_per_mrec(m, "executor.fetch")
