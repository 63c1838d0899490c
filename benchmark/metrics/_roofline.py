"""The arithmetic of a kernel's share of its roofline, which several
readers share."""

from benchmark.harness.core import HBM_BYTES_PER_S


def roofline(m, metric: str, kernel: str, launches: str, job_bytes):
    """Percent of the least time, ``job_bytes`` per job over 3.35 TB/s,
    in the device time of the kernels whose trace name holds ``kernel``;
    None (the metric left out) when their count differs from the
    program's ``launches`` counter, none ran, or no bytes were
    counted."""
    kernels = [e for e in m.events
               if e.get("cat") == "kernel" and kernel in str(e.get("name"))]
    booked = m.launches.get(launches, 0)
    if len(kernels) != booked:
        m.note(f"{metric}: {len(kernels)} kernel events in the trace, "
               f"{booked} launches booked; left out")
        return None
    if not kernels or not job_bytes:
        return None
    device_s = sum(e["dur"] for e in kernels) / 1e6
    least_s = m.facts["passes"] * job_bytes / HBM_BYTES_PER_S
    return 100.0 * least_s / device_s
