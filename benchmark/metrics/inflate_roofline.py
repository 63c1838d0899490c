"""Share of its roofline that the inflate kernel B1 reached: the least
time, the deflate payload bytes plus the decoded bytes of the input's
blocks (the benchmark's own block walk, each byte once per job's read)
over
3.35 TB/s, divided by the device time of B1's kernels in the profiler's
trace. The kernels are found by name; their count has to equal the
program's launch counter, or the metric is left out."""

from benchmark.harness.core import HBM_BYTES_PER_S


def _is_b1(name: str) -> bool:
    return "inflate_kernel" in name and "legacy" not in name


def read(m):
    kernels = [e for e in m.events
               if e.get("cat") == "kernel" and _is_b1(str(e.get("name")))]
    booked = m.launches.get("inflate", 0)
    if len(kernels) != booked:
        m.note(f"inflate_roofline: {len(kernels)} kernel events in the "
               f"trace, {booked} launches booked; left out")
        return None
    if not kernels:
        return None
    device_s = sum(e["dur"] for e in kernels) / 1e6
    f = m.facts
    least_s = f["passes"] * (f["payload_bytes"] + f["decoded_bytes"]) \
        / HBM_BYTES_PER_S
    return 100.0 * least_s / device_s
