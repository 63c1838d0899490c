"""Duplicate marking on coordinate-sorted batches (the ``samtools
markdup`` family), with the group scan on the batch's device.

Counterpart of ``disq_tpu/ops/markdup.py``. Two records are duplicates
when they share the key **(refid, unclipped 5' position,
orientation)**: ``pos - leading clips`` for a forward read, ``alignment
end + trailing clips - 1`` for a reverse one. Within each key group the
record with the best score (the sum of its base qualities >= 15; ties to
the first, stable) stays; every other member gets flag ``0x400``.
Records flagged unmapped, secondary or supplementary (``0x904``) are
never examined and never marked.

A device-backed batch never host-parses: the key columns come from its
record bytes by vectorized numpy passes (``record_fields_from_blob``,
``cigar_arrays_from_blob``, ``qual_scores_from_blob``), go up once, and
the group scan runs as torch ops on its device: two stable sorts that
reproduce the reference's ``lexsort((negscore, orient, up, hi))``, a
shifted compare for the group starts and a scatter back to record
order; only the duplicate mask comes back. The bits are written back
with ``ColumnarBatch.or_flags`` (device column and blob bytes). A host
``ReadBatch`` runs the same key math over its columns with a numpy
lexsort; the marked sets are identical.

**Shard seams.** One shard's pass sees only its records.
``merge_boundary_duplicates`` pools every shard's surviving
representatives near its coordinate edges and re-elects one per
cross-shard group (best score, then earliest shard, then earliest
record), flipping the losers in place. Exact whenever every read's
clipped span is <= ``boundary_bp`` (default 512); longer spans can only
under-mark.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

MARKDUP_EXCLUDE = 0x4 | 0x100 | 0x800
DEFAULT_BOUNDARY_BP = 512
_SCORE_MIN_Q = 15


# -- key columns from the record bytes (no host record parse) -----------------


def _u16(blob: np.ndarray, off: np.ndarray) -> np.ndarray:
    return blob[off].astype(np.int64) | (blob[off + 1].astype(np.int64) << 8)


def _i32(blob: np.ndarray, off: np.ndarray) -> np.ndarray:
    v = (blob[off].astype(np.uint32)
         | (blob[off + 1].astype(np.uint32) << 8)
         | (blob[off + 2].astype(np.uint32) << 16)
         | (blob[off + 3].astype(np.uint32) << 24))
    return v.astype(np.int64) - ((v >> 31).astype(np.int64) << 32)


def _flat_segments(base: np.ndarray, lens: np.ndarray,
                   stride: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Flat element indices of N variable-length segments: segment i
    contributes ``base[i] + stride*j`` for j < lens[i]. Returns (flat
    source indices, (N+1,) segment offsets)."""
    seg_off = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=seg_off[1:])
    total = int(seg_off[-1])
    if total == 0:
        return np.zeros(0, np.int64), seg_off
    seg = np.repeat(np.arange(len(lens)), lens)
    within = np.arange(total, dtype=np.int64) - seg_off[seg]
    return base[seg] + stride * within, seg_off


def _segment_sums(contrib: np.ndarray, seg_off: np.ndarray) -> np.ndarray:
    """Per-segment sums of a flat contribution vector (``reduceat``
    with its empty-segment quirk masked)."""
    n = len(seg_off) - 1
    if n == 0:
        return np.zeros(0, np.int64)
    sums = np.add.reduceat(
        np.concatenate([contrib, [0]]),
        np.minimum(seg_off[:-1], len(contrib)))
    return np.where(np.diff(seg_off) == 0, 0, sums)


def record_fields_from_blob(blob: np.ndarray, offsets: np.ndarray,
                            order: Optional[np.ndarray] = None
                            ) -> Dict[str, np.ndarray]:
    """Fixed fields straight from the record bytes: no d2h of the
    resident columns, no host record parse. ``order`` maps logical
    record index to blob record index (``permuted()``)."""
    off = np.asarray(offsets[:-1], dtype=np.int64)
    if order is not None:
        off = off[np.asarray(order, dtype=np.int64)]
    return {
        "refid": _i32(blob, off + 4),
        "pos": _i32(blob, off + 8),
        "l_read_name": blob[off + 12].astype(np.int64),
        "n_cigar": _u16(blob, off + 16),
        "flag": _u16(blob, off + 18),
        "l_seq": _i32(blob, off + 20),
        "_off": off,
    }


def cigar_arrays_from_blob(blob: np.ndarray,
                           fields: Dict[str, np.ndarray]
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(flat u32 CIGAR op words, (N+1,) offsets) from the blob."""
    base = fields["_off"] + 36 + fields["l_read_name"]
    src, seg_off = _flat_segments(base, fields["n_cigar"], stride=4)
    words = (blob[src].astype(np.uint32)
             | (blob[src + 1].astype(np.uint32) << 8)
             | (blob[src + 2].astype(np.uint32) << 16)
             | (blob[src + 3].astype(np.uint32) << 24))
    return words, seg_off


def clip_and_span(cigars: np.ndarray, cigar_offsets: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(reference span, leading clip bases, trailing clip bases) per
    record from a flat CIGAR vector; clips (S=4 / H=5) legally appear
    only as the outermost one or two ops of each end."""
    cigars = np.asarray(cigars, dtype=np.uint32)
    seg_off = np.asarray(cigar_offsets, dtype=np.int64)
    op = (cigars & 0xF).astype(np.int64)
    ln = (cigars >> 4).astype(np.int64)
    span = _segment_sums(np.where(np.isin(op, (0, 2, 3, 7, 8)), ln, 0),
                         seg_off)
    n = len(seg_off) - 1
    ncig = np.diff(seg_off)
    lead = np.zeros(n, np.int64)
    trail = np.zeros(n, np.int64)
    if len(cigars):
        is_clip = np.isin(op, (4, 5))
        limit = len(cigars) - 1
        # leading: the first op, and the second when the first was a
        # clip (H then S); the same from the tail
        prev_clip = np.ones(n, bool)
        for k in (0, 1):
            at = np.minimum(seg_off[:-1] + k, limit)
            hit = (ncig > k) & is_clip[at] & prev_clip
            lead += np.where(hit, ln[at], 0)
            prev_clip = hit
        prev_clip = np.ones(n, bool)
        for k in (1, 2):
            at = np.clip(seg_off[1:] - k, 0, limit)
            hit = (ncig >= k) & is_clip[at] & prev_clip
            trail += np.where(hit, ln[at], 0)
            prev_clip = hit
    return span, lead, trail


def qual_scores_from_blob(blob: np.ndarray,
                          fields: Dict[str, np.ndarray]) -> np.ndarray:
    """Per-record duplicate score: the sum of base qualities >= 15 (the
    samtools convention; the 0xFF "no qualities" byte scores 0)."""
    lseq = fields["l_seq"]
    qbase = (fields["_off"] + 36 + fields["l_read_name"]
             + 4 * fields["n_cigar"] + (lseq + 1) // 2)
    src, seg_off = _flat_segments(qbase, lseq)
    q = blob[src].astype(np.int64)
    return qual_scores_from_flat(q, seg_off)


def qual_scores_from_flat(q: np.ndarray, seg_off: np.ndarray) -> np.ndarray:
    contrib = np.where((q >= _SCORE_MIN_Q) & (q != 0xFF), q, 0)
    return _segment_sums(contrib.astype(np.int64),
                         np.asarray(seg_off, dtype=np.int64))


# -- keys and the group scan --------------------------------------------------


def markdup_keys(flag: np.ndarray, refid: np.ndarray, pos: np.ndarray,
                 span: np.ndarray, lead: np.ndarray, trail: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(unclipped 5' position i64, orientation {0,1}, examined mask)."""
    f = np.asarray(flag, dtype=np.int64)
    reverse = (f & 0x10) != 0
    upos = np.where(reverse,
                    np.asarray(pos, np.int64) + np.maximum(span, 1) - 1
                    + trail,
                    np.asarray(pos, np.int64) - lead)
    valid = ((f & MARKDUP_EXCLUDE) == 0) & (np.asarray(refid) >= 0)
    return upos, reverse.astype(np.int8), valid


def _mark_dups_host(refid, upos, orient, score, valid) -> np.ndarray:
    """The group scan in numpy (host batches): stable lexsort by (key,
    score descending); every member but a group's first is a
    duplicate."""
    n = len(upos)
    if n == 0:
        return np.zeros(0, bool)
    idx = np.arange(n, dtype=np.int64)
    hi = np.where(valid, np.asarray(refid, np.int64), np.int64(1) << 40)
    up = np.where(valid, upos, idx)
    order = np.lexsort((-np.asarray(score, np.int64),
                        orient.astype(np.int64), up, hi))
    sh, su, so = hi[order], up[order], orient[order]
    new_grp = np.ones(n, bool)
    new_grp[1:] = (sh[1:] != sh[:-1]) | (su[1:] != su[:-1]) \
        | (so[1:] != so[:-1])
    dup = np.zeros(n, bool)
    dup[order] = ~new_grp & valid[order]
    return dup


# excluded records take hi = 2**31 (above every int32 refid) and up =
# their own index, so each is a group of its own; the primary sort key
# packs (hi, up) as (hi - 2**31) * 2**32 + (up + 2**31), monotone in both
# and inside int64 for hi <= 2**31 and any int32 up
_HI_EXCLUDED = 1 << 31


def group_scan(refid: torch.Tensor, upos: torch.Tensor, orient: torch.Tensor,
               score: torch.Tensor, valid: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The duplicate group scan as torch ops on the inputs' device:
    (bool duplicate mask in record order, examined count, duplicate
    count). ``refid``, ``upos``, ``orient``, ``score`` are int64,
    ``valid`` bool. Equal to ``_mark_dups_host``: the secondary key
    (orientation, then score descending) sorts first, then the primary
    (refid, upos) with a stable sort, so ties keep index order as the
    reference's ``lexsort`` does."""
    n = refid.numel()
    idx = torch.arange(n, dtype=torch.int64, device=refid.device)
    hi = torch.where(valid, refid, torch.full_like(refid, _HI_EXCLUDED))
    up = torch.where(valid, upos, idx)
    primary = (hi - _HI_EXCLUDED) * (1 << 32) + (up + (1 << 31))
    secondary = orient * (1 << 32) + ((1 << 31) - score)
    order = torch.sort(secondary, stable=True).indices
    order = order[torch.sort(primary[order], stable=True).indices]
    sp, so = primary[order], orient[order]
    new_grp = torch.ones(n, dtype=torch.bool, device=refid.device)
    new_grp[1:] = (sp[1:] != sp[:-1]) | (so[1:] != so[:-1])
    dup_sorted = ~new_grp & valid[order]
    dup = torch.zeros(n, dtype=torch.bool, device=refid.device)
    dup[order] = dup_sorted
    return dup, valid.sum(), dup_sorted.sum()


def _mark_dups_resident(refid, upos, orient, score, valid, device):
    """The group scan on ``device``: five key columns go up, the (n,)
    duplicate mask and two counts come back."""
    from disq_tpu_torch.runtime import counters
    from disq_tpu_torch.runtime.device_pipeline import upload
    from disq_tpu_torch.runtime.tracing import device_span

    cols = [upload(np.asarray(a, dtype=np.int64), device)
            for a in (refid, upos, orient, score)]
    ok = upload(np.asarray(valid, dtype=bool), device)
    n = len(valid)
    with device_span("device.kernel", kernel="markdup", records=n) as fence:
        dup, examined, dups = fence.sync(group_scan(*cols, ok))
    mask = dup.cpu().numpy()
    if dup.is_cuda:
        counters.book_transfer("d2h", mask.nbytes + 16)
    return mask, int(examined), int(dups)


# -- per-shard marking ---------------------------------------------------------


@dataclass
class MarkdupResult:
    """One shard's marking and the seam merge's inputs."""

    dup_mask: np.ndarray
    examined: int
    duplicates: int
    boundary_flips: int = 0
    # surviving representatives near the shard's coordinate edges:
    # parallel arrays (refid, upos, orient, score, record index)
    candidates: Dict[str, np.ndarray] = field(default_factory=dict)

    def stats(self) -> Dict[str, int]:
        return {"examined": int(self.examined),
                "duplicates": int(self.duplicates),
                "boundary_flips": int(self.boundary_flips)}


def _key_columns(batch) -> Tuple[Dict[str, np.ndarray], bool]:
    """(flag/refid/pos/span/clips/score, resident?) for any batch
    flavor: a device-backed batch derives them from its record blob, a
    host batch from its columns."""
    from disq_tpu_torch.runtime.columnar import ColumnarBatch

    if isinstance(batch, ColumnarBatch) and batch.device_backed:
        src = batch.encode_source()
        if src is not None:
            blob, offsets, order = src
            fields = record_fields_from_blob(blob, offsets, order)
            cig, cig_off = cigar_arrays_from_blob(blob, fields)
            span, lead, trail = clip_and_span(cig, cig_off)
            score = qual_scores_from_blob(blob, fields)
            return {"flag": fields["flag"], "refid": fields["refid"],
                    "pos": fields["pos"], "span": span, "lead": lead,
                    "trail": trail, "score": score}, True
    flag = np.asarray(batch.flag, np.int64)
    refid = np.asarray(batch.refid, np.int64)
    pos = np.asarray(batch.pos, np.int64)
    span, lead, trail = clip_and_span(batch.cigars, batch.cigar_offsets)
    seg_off = np.asarray(batch.seq_offsets, np.int64)
    score = qual_scores_from_flat(
        np.asarray(batch.quals, np.int64), seg_off)
    return {"flag": flag, "refid": refid, "pos": pos, "span": span,
            "lead": lead, "trail": trail, "score": score}, False


def _apply_mask(batch, dup_mask: np.ndarray):
    """Write 0x400 back: in place for a ColumnarBatch (device column and
    blob bytes), a new flag column for a host ReadBatch."""
    from disq_tpu_torch.runtime.columnar import ColumnarBatch

    if isinstance(batch, ColumnarBatch):
        batch.or_flags(dup_mask, 0x400)
        return batch
    batch.flag = np.where(dup_mask, batch.flag | np.uint16(0x400),
                          batch.flag).astype(batch.flag.dtype)
    return batch


def markdup_batch(batch, boundary_bp: int = DEFAULT_BOUNDARY_BP
                  ) -> Tuple[object, MarkdupResult]:
    """Mark duplicates within one coordinate-sorted batch. Returns the
    marked batch (the same object for a ColumnarBatch, patched in place)
    and a ``MarkdupResult`` with the seam merge's candidates."""
    from disq_tpu_torch.runtime.tracing import counter, span

    n = int(batch.count)
    with span("ops.markdup.apply", records=n):
        if n == 0:
            return batch, MarkdupResult(np.zeros(0, bool), 0, 0)
        cols, resident = _key_columns(batch)
        upos, orient, valid = markdup_keys(
            cols["flag"], cols["refid"], cols["pos"],
            cols["span"], cols["lead"], cols["trail"])
        if resident:
            dup, examined, dups = _mark_dups_resident(
                cols["refid"], upos, orient, cols["score"], valid,
                batch.device)
        else:
            dup = _mark_dups_host(cols["refid"], upos, orient,
                                  cols["score"], valid)
            examined, dups = int(valid.sum()), int(dup.sum())
        batch = _apply_mask(batch, dup)
        counter("ops.markdup.duplicates").inc(int(dups))
        res = MarkdupResult(dup, int(examined), int(dups))
        res.candidates = _boundary_candidates(
            cols, upos, orient, valid, dup, boundary_bp)
    return batch, res


def _boundary_candidates(cols, upos, orient, valid, dup,
                         boundary_bp: int) -> Dict[str, np.ndarray]:
    """Surviving representatives whose key position lies within
    ``boundary_bp`` of the shard's coordinate extremes: the only
    records a cross-shard group can reach."""
    live = valid & ~dup
    if not live.any() or boundary_bp <= 0:
        return {}
    pos = cols["pos"]
    refid = cols["refid"]
    sel = np.zeros(len(pos), bool)
    # a 2x margin: a member's upos can sit one clipped span past its
    # pos, and pos one span from the seam; over-inclusion only grows the
    # merge pool
    w = 2 * boundary_bp
    for rid in np.unique(refid[live]):
        on_ref = live & (refid == rid)
        lo, hi = pos[on_ref].min(), pos[on_ref].max()
        near = ((pos <= lo + w) | (pos >= hi - w)
                | (upos <= lo + w) | (upos >= hi - w))
        sel |= on_ref & near
    if not sel.any():
        return {}
    idx = np.nonzero(sel)[0]
    return {"refid": refid[idx].astype(np.int64),
            "upos": upos[idx].astype(np.int64),
            "orient": orient[idx].astype(np.int64),
            "score": np.asarray(cols["score"])[idx].astype(np.int64),
            "index": idx.astype(np.int64)}


def merge_boundary_duplicates(
    shards: Sequence[Tuple[object, MarkdupResult]],
) -> int:
    """The cross-shard seam pass: pool every shard's boundary
    candidates, group them by key, and demote all but the global best of
    each group that spans shards (best score, then earliest shard, then
    earliest record, the within-shard scan's order). The flips land in
    each shard's batch (``or_flags``) and ``MarkdupResult``. Returns the
    number of flips."""
    from disq_tpu_torch.runtime.tracing import counter, span

    with span("ops.markdup.boundary_merge", shards=len(shards)):
        pool = [(si, r.candidates) for si, (_b, r) in enumerate(shards)
                if r.candidates]
        if len(pool) < 2:
            return 0
        refid = np.concatenate([c["refid"] for _si, c in pool])
        upos = np.concatenate([c["upos"] for _si, c in pool])
        orient = np.concatenate([c["orient"] for _si, c in pool])
        score = np.concatenate([c["score"] for _si, c in pool])
        index = np.concatenate([c["index"] for _si, c in pool])
        shard = np.concatenate([
            np.full(len(c["index"]), si, np.int64) for si, c in pool])
        order = np.lexsort((index, shard, -score, orient, upos, refid))
        r_, u_, o_ = refid[order], upos[order], orient[order]
        new_grp = np.ones(len(order), bool)
        new_grp[1:] = (r_[1:] != r_[:-1]) | (u_[1:] != u_[:-1]) \
            | (o_[1:] != o_[:-1])
        # only groups that span shards flip: a group inside one shard
        # already elected this winner
        grp_id = np.cumsum(new_grp) - 1
        s_ = shard[order]
        multi = np.zeros(grp_id[-1] + 1, bool)
        firsts = s_[new_grp]
        np.logical_or.at(multi, grp_id, s_ != firsts[grp_id])
        lose = ~new_grp & multi[grp_id]
        flips = 0
        for si, (batch, res) in enumerate(shards):
            mine = lose & (s_ == si)
            if not mine.any():
                continue
            local = index[order][mine]
            mask = np.zeros(len(res.dup_mask), bool)
            mask[local] = True
            _apply_mask(batch, mask)
            res.dup_mask = res.dup_mask | mask
            res.duplicates += int(mask.sum())
            res.boundary_flips += int(mask.sum())
            flips += int(mask.sum())
        if flips:
            counter("ops.markdup.boundary_flips").inc(flips)
        return flips
