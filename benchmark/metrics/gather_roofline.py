"""Share of its roofline that the record gather W1 reached: the least
time, each written record byte once plus 16 bytes of offsets per
record, per job, over 3.35 TB/s, divided by the device time of W1's
kernels in the profiler's trace. The kernels are found by name; their
count has to equal the program's launch counter, or the metric is left
out."""

from benchmark.metrics._roofline import roofline


def read(m):
    return roofline(m, "gather_roofline", "record_gather_kernel",
                    "record_gather", m.facts.get("gather_bytes"))
