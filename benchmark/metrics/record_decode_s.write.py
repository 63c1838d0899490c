"""``bam.split.decode`` spans of each job's read less the
``codec.inflate.batch`` spans that lie inside them (the record scan,
B2's parse and the columns), per million records written. The spans carry no thread, so an inflate span is
taken as nested when it lies inside any decode span; each is counted
once."""

from benchmark.harness import trace as T


def read(m):
    outer = T.span_sum(m.spans, "bam.split.decode")
    if not outer:
        return None
    inner = T.nested_sum(m.spans, "bam.split.decode", "codec.inflate.batch")
    return T.per_mrec(outer - inner, m.facts.get("records", 0))
