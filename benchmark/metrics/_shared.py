"""Arithmetic that several readers share."""

from benchmark.harness import trace as T


def span_per_mrec(m, name: str):
    """Seconds of the program's ``name`` spans in the window per million
    records the window handled."""
    spans = [s for s in m.spans if s["name"] == name]
    if not spans:
        return None
    return T.per_mrec(sum(s["dur"] for s in spans), m.facts.get("records", 0))


def idle_share(m):
    """Percent of the traced window in which no operation ran on the
    device (kernels, copies and sets, as a union of intervals)."""
    if m.window_s <= 0 or not m.events:
        return None
    return 100.0 * (1.0 - m.busy_s / m.window_s)
