"""Readings of a traced window: the device's busy intervals from a
``torch.profiler`` Chrome trace, the program's host spans, and the
arithmetic the per-layer readers share."""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(path: str) -> List[dict]:
    """Complete events of the device (kernels, copies, sets), each with
    ``ts`` and ``dur`` in microseconds, sorted by start."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    out = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    out.sort(key=lambda e: e["ts"])
    return out


def union(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted((max(lo, a), min(hi, b)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def event_intervals(events: Sequence[dict]) -> List[Tuple[float, float]]:
    return [(e["ts"], e["ts"] + e["dur"]) for e in events]


def device_ops(events: Sequence[dict], top: int = 10) -> List[list]:
    """The device operations that took most time: ``[name, seconds]``."""
    total: Dict[str, float] = {}
    for e in events:
        name = str(e.get("name", "?"))[:160]
        total[name] = total.get(name, 0.0) + e["dur"] / 1e6
    return [[k, v] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(busy_iv: Sequence[Tuple[float, float]], lo: float, hi: float,
              host_spans: Sequence[dict], offset_us: float,
              top: int = 10) -> List[list]:
    """The longest idle gaps of the device in [lo, hi] (microseconds on
    the trace's clock), each named by the innermost host span that holds
    its middle (host seconds + ``offset_us`` maps onto the trace's
    clock): ``[name, seconds]``."""
    gaps, prev = [], lo
    for a, b in busy_iv:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        holders = [s for s in host_spans
                   if s["ts"] * 1e6 + offset_us <= mid
                   <= (s["ts"] + s["dur"]) * 1e6 + offset_us]
        name = min(holders, key=lambda s: s["dur"])["name"] if holders \
            else "no host span"
        out.append([name, (b - a) / 1e6])
    return out


def span_sum(spans: Sequence[dict], name: str) -> float:
    return sum(s["dur"] for s in spans if s["name"] == name)


def nested_sum(spans: Sequence[dict], outer: str, inner: str) -> float:
    """Seconds of the ``inner`` spans that lie inside some ``outer``
    span's interval, each counted once."""
    outs = sorted((s["ts"], s["ts"] + s["dur"]) for s in spans
                  if s["name"] == outer)
    total = 0.0
    for s in spans:
        if s["name"] != inner:
            continue
        a, b = s["ts"], s["ts"] + s["dur"]
        if any(oa <= a and b <= ob for oa, ob in outs):
            total += s["dur"]
    return total


def per_mrec(seconds: float, records: int) -> Optional[float]:
    return seconds / (records / 1e6) if records else None

