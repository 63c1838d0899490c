"""``columnar.batch.materialize`` spans (the host parse of the records
of each job's device-backed batch: the blob's join, ``decode_records``
and the order's gather; B2 parsed the fixed columns on the card before)
per million records written."""

from benchmark.metrics._shared import span_per_mrec


def read(m):
    return span_per_mrec(m, "columnar.batch.materialize")
