"""``sort.coordinate`` spans (each job's coordinate sort: the
permutation, on the card for the read's device-backed batch, and the
gather of the sorted records) less the ``columnar.batch.materialize``
spans on the same thread that lie inside them (the host parse of the
records the gather needs, read by ``materialize_s.write``), per million
records written."""

from benchmark.harness import trace as T

# a span's start and length are each rounded to the microsecond, so an
# inner span's end may pass its outer span's by up to 1 us
SLACK_S = 2e-6


def nested_same_thread(spans, outer: str, inner: str) -> float:
    """Seconds of the ``inner`` spans that lie inside an ``outer`` span
    of the same thread (``tid``), each counted once."""
    outs = [(s.get("tid"), s["ts"], s["ts"] + s["dur"]) for s in spans
            if s["name"] == outer]
    total = 0.0
    for s in spans:
        if s["name"] != inner:
            continue
        a, b = s["ts"], s["ts"] + s["dur"]
        if any(tid == s.get("tid") and oa - SLACK_S <= a and b <= ob + SLACK_S
               for tid, oa, ob in outs):
            total += s["dur"]
    return total


def read(m):
    if not any(s["name"] == "sort.coordinate" for s in m.spans):
        return None
    outer = T.span_sum(m.spans, "sort.coordinate")
    inner = nested_same_thread(m.spans, "sort.coordinate",
                               "columnar.batch.materialize")
    return T.per_mrec(outer - inner, m.facts.get("records", 0))
