"""Percent of the traced window of CRAM-to-BAM jobs in which the device ran nothing."""

from benchmark.metrics._shared import idle_share


def read(m):
    return idle_share(m)
