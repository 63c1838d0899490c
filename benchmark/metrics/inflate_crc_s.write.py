"""``codec.inflate.crc`` spans (the host CRC check of each
device-inflated batch of a job's read, inside ``codec.inflate.batch``),
summed over the executor workers, per million records written."""

from benchmark.metrics._shared import span_per_mrec


def read(m):
    return span_per_mrec(m, "codec.inflate.crc")
