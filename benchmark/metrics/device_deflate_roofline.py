"""Share of its roofline that the device deflate W2 reached: the least
time, the deflate payload and the decoded bytes of the written file's
blocks (the benchmark's own walk of the kept file), per job, over 3.35
TB/s, divided by the device time of W2's kernels in the profiler's
trace. The kernels are found by name; their count has to equal the
program's launch counter, or the metric is left out."""

from benchmark.metrics._roofline import roofline


def read(m):
    return roofline(m, "device_deflate_roofline", "deflate_kernel", "deflate",
                    m.facts.get("deflate_bytes"))
