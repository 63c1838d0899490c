"""OpPipeline: chains of operators over a dataset's shard batches
(decode → filter → sort → markdup → stats, as one composition).

Counterpart of ``disq_tpu/runtime/oppipe.py``. An ``OpPipeline`` is an
ordered list of operators applied shard by shard. Every transform takes
and returns a batch, so a chain over device-backed shards never
host-parses a record: ``filter`` masks with kernel F1 and compacts on
the device, ``sort`` returns a ``permuted()`` device-backed batch,
``markdup`` patches the flag bits on the device and in the record blob,
and the reductions (``pileup``, ``rgstats``) bring back only their
result rows. Host ``ReadBatch`` shards run the same operators' host
paths, with the same outputs.

Operators with cross-shard meaning finish after the per-shard pass:
``markdup`` runs the cross-shard seam merge
(``ops/markdup.py::merge_boundary_duplicates``).

A device-backed batch that a transform replaced inside the chain (not
one the caller passed in) is released at once, so the fixed columns it
never sent to the host book into ``device.d2h_avoided_bytes``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


class _Op:
    """One stage: ``apply`` maps a shard batch to a shard batch (the
    identity for reductions); ``finalize`` sees every shard once and
    returns the op's merged stats (or None)."""

    name = "op"

    def apply(self, batch, shard: int):
        return batch

    def finalize(self, batches: List) -> Optional[Dict]:
        return None


class FilterOp(_Op):
    """Predicate filter and seeded subsample (``ops/rfilter.py``)."""

    name = "filter"

    def __init__(self, spec):
        from disq_tpu_torch.ops.rfilter import ReadFilter, parse_read_filter

        self.rf = spec if isinstance(spec, ReadFilter) \
            else parse_read_filter(spec)

    def apply(self, batch, shard: int):
        from disq_tpu_torch.ops.rfilter import apply_read_filter

        return apply_read_filter(batch, self.rf)


class SortOp(_Op):
    """Coordinate sort within each shard, device-backed when the batch
    is (``permuted()`` keeps the device columns and the blob). A
    coordinate-sorted input's shards cover disjoint ranges, so sorting
    each keeps the global order."""

    name = "sort"

    def apply(self, batch, shard: int):
        from disq_tpu_torch.sort.coordinate import coordinate_sort_batch

        return coordinate_sort_batch(batch, keep_resident=True)


class MarkdupOp(_Op):
    """Duplicate marking and the cross-shard seam merge."""

    name = "markdup"

    def __init__(self, boundary_bp: Optional[int] = None):
        from disq_tpu_torch.ops.markdup import DEFAULT_BOUNDARY_BP

        self.boundary_bp = (DEFAULT_BOUNDARY_BP if boundary_bp is None
                            else int(boundary_bp))
        self._results: List = []

    def apply(self, batch, shard: int):
        from disq_tpu_torch.ops.markdup import markdup_batch

        batch, res = markdup_batch(batch, boundary_bp=self.boundary_bp)
        self._results.append((batch, res))
        return batch

    def finalize(self, batches: List) -> Dict:
        from disq_tpu_torch.ops.markdup import merge_boundary_duplicates

        merge_boundary_duplicates(self._results)
        out = {"examined": 0, "duplicates": 0, "boundary_flips": 0}
        for _b, res in self._results:
            for k, v in res.stats().items():
                out[k] += v
        self._results = []
        return out


class PileupOp(_Op):
    """Per-base coverage over one region, summed across shards
    (disjoint shards hold disjoint alignments). A host batch sums on
    the pipeline's ``device`` (``cuda`` unless it names another)."""

    name = "pileup"

    def __init__(self, refid: int, start: int, end: int):
        self.refid, self.start, self.end = int(refid), int(start), int(end)
        self.device = None
        self._cov: Optional[np.ndarray] = None

    def apply(self, batch, shard: int):
        from disq_tpu_torch.ops.pileup import region_pileup

        cov = region_pileup(batch, self.refid, self.start, self.end,
                            self.device)
        self._cov = cov if self._cov is None \
            else (self._cov + cov).astype(np.int32)
        return batch

    def finalize(self, batches: List) -> Dict:
        cov = self._cov if self._cov is not None else np.zeros(
            max(0, self.end - self.start), np.int32)
        self._cov = None
        return {"refid": self.refid, "start": self.start,
                "end": self.end, "coverage": cov}


class RgStatsOp(_Op):
    """Per-read-group reduction, histograms merged across shards."""

    name = "rgstats"

    def __init__(self):
        self._acc: Dict[str, Dict] = {}

    def apply(self, batch, shard: int):
        from disq_tpu_torch.ops.rgstats import read_group_stats

        for name, st in read_group_stats(batch).items():
            acc = self._acc.setdefault(name, {
                "reads": 0, "duplicates": 0,
                "mapq_hist": np.zeros(256, np.int64)})
            acc["reads"] += st["reads"]
            acc["duplicates"] += st["duplicates"]
            acc["mapq_hist"] += np.asarray(st["mapq_hist"])
        return batch

    def finalize(self, batches: List) -> Dict:
        from disq_tpu_torch.ops.rgstats import summarize

        names = list(self._acc)
        hist = [self._acc[k]["mapq_hist"] for k in names]
        dups = [self._acc[k]["duplicates"] for k in names]
        self._acc = {}
        return summarize(names, hist, dups)


_OP_BY_NAME = {
    "filter": FilterOp, "sort": SortOp, "markdup": MarkdupOp,
    "pileup": PileupOp, "rgstats": RgStatsOp,
}


@dataclass
class PipelineResult:
    """Per-shard output batches and each op's merged stats."""

    batches: List
    stats: Dict[str, object] = field(default_factory=dict)

    def concat(self):
        """One batch (consuming: device-backed shards fold into one
        device-backed batch, ``ColumnarBatch.concat``)."""
        from disq_tpu_torch.runtime.columnar import ColumnarBatch

        return ColumnarBatch.concat(self.batches)


def make_op(spec) -> _Op:
    """One op spec: an ``_Op`` passes through; a name (``"sort"``) or a
    ``(name, *args)`` tuple constructs one."""
    if isinstance(spec, _Op):
        return spec
    if isinstance(spec, str):
        name, args = spec, ()
    elif isinstance(spec, (tuple, list)) and spec:
        name, args = spec[0], tuple(spec[1:])
    else:
        raise TypeError(f"not an operator spec: {spec!r}")
    cls = _OP_BY_NAME.get(name)
    if cls is None:
        raise ValueError(
            f"unknown operator {name!r}; have {sorted(_OP_BY_NAME)}")
    return cls(*args)


class OpPipeline:
    """``OpPipeline(FilterOp("-q 30"), MarkdupOp(), RgStatsOp())``, or
    by spec: ``OpPipeline(("filter", "-q 30"), "sort", "markdup",
    "rgstats")``. ``run`` takes the decoded shard batches (one dataset
    batch counts as one shard), applies every op in order shard by
    shard, then finalizes. ``device`` is where an op that needs one
    (``pileup``) runs on a host batch."""

    def __init__(self, *ops, device=None):
        self.ops = [make_op(op) for op in ops]
        for op in self.ops:
            if isinstance(op, PileupOp):
                op.device = device

    def run(self, batches: Sequence) -> PipelineResult:
        from disq_tpu_torch.runtime.tracing import span

        batches = list(batches)
        given = {id(b) for b in batches}
        result = PipelineResult(batches=batches)
        with span("ops.pipeline.run",
                  ops=",".join(op.name for op in self.ops),
                  shards=len(batches)):
            for op in self.ops:
                out = [op.apply(b, i) for i, b in enumerate(batches)]
                for old, new in zip(batches, out):
                    if new is not old and id(old) not in given \
                            and getattr(old, "device_backed", False):
                        old.release()
                batches = out
                st = op.finalize(batches)
                if st is not None:
                    result.stats[op.name] = st
            result.batches = batches
        return result
