"""Share of its roofline that the order-0 rANS kernel B3 reached: the
least time, the compressed plus decoded bytes of the input's order-0
rANS blocks (``reference/cram.py``'s walk, each byte once per job's
read) over 3.35 TB/s, divided by the device time of B3's kernels in the
profiler's trace. The kernels are found by name; their count has to
equal the program's launch counter, or the metric is left out."""

from benchmark.metrics._roofline import roofline


def read(m):
    return roofline(m, "rans_roofline", "rans_simd_kernel", "rans_simd",
                    m.facts.get("rans0_bytes"))
