"""Indexed (interval) traversal — the BAI query read path.

Counterpart of ``disq_tpu/traversal/bai_query.py`` (disq's traversal
branch of ``BamSource``): resolve ``path + ".bai"``, map the intervals
to coalesced chunks of virtual-offset pairs, decode only those chunks,
then keep the records that overlap an interval (a vectorized mask over
the batch instead of htsjdk's per-record ``OverlapDetector``). With
``traverse_unplaced_unmapped`` the unplaced-unmapped records are read
from the tail chunk after the last mapped one.

Chunk bounds are virtual offsets, so a decode never sees a partial
record. Each chunk decodes as a split does (``BamSource._decode_range``):
on ``cuda`` through the inflate and parse kernels into a device-backed
batch, and the read filter applies inside it; the chunks' batches join
with ``ColumnarBatch.concat``, so a read on the card stays device-backed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from disq_tpu_torch.bam.header import SamHeader
from disq_tpu_torch.fsw.filesystem import FileSystemWrapper
from disq_tpu_torch.index.bai import BaiIndex
from disq_tpu_torch.runtime.columnar import ColumnarBatch


def _resolve_bai(fs: FileSystemWrapper, path: str) -> BaiIndex:
    for cand in (path + ".bai",
                 path[:-4] + ".bai" if path.endswith(".bam") else None):
        if cand and fs.exists(cand):
            return BaiIndex.from_bytes(fs.read_all(cand))
    raise FileNotFoundError(f"no .bai index found for {path}")


def chunks_for_intervals(header: SamHeader, bai: BaiIndex,
                         intervals) -> List[Tuple[int, int]]:
    """Intervals → coalesced (start, end) virtual-offset chunks."""
    chunks: List[Tuple[int, int]] = []
    for iv in intervals:
        refid = header.ref_index(iv.contig)
        # 1-based closed interval → 0-based half-open
        chunks += bai.chunks_for_interval(refid, iv.start - 1, iv.end)
    chunks.sort()
    merged: List[Tuple[int, int]] = []
    for cb, ce in chunks:
        if merged and cb <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
        else:
            merged.append((cb, ce))
    return merged


def overlap_mask(batch, header: SamHeader, intervals,
                 ends: np.ndarray = None) -> np.ndarray:
    """Which records overlap any interval (0-based half-open). ``ends``
    takes precomputed ``batch.alignment_ends()``: the CIGAR walk (a host
    parse of a device-backed batch's records) is the dominant cost, so a
    caller filtering one batch repeatedly pays it once."""
    mask = np.zeros(batch.count, dtype=bool)
    if batch.count == 0:
        return mask
    if ends is None:
        ends = batch.alignment_ends()
    for iv in intervals:
        refid = header.ref_index(iv.contig)
        beg0, end0 = iv.start - 1, iv.end  # half-open
        mask |= (batch.refid == refid) & (batch.pos < end0) & (ends > beg0)
    return mask


def read_with_traversal(fs: FileSystemWrapper, path: str, header: SamHeader,
                        traversal, source):
    """BAI → chunks → bounded decode → exact overlap filter; the batches
    of every chunk (and of the unplaced-unmapped tail) joined."""
    bai = _resolve_bai(fs, path)
    batches = []
    if traversal.intervals is not None:
        for cb, ce in chunks_for_intervals(header, bai, traversal.intervals):
            sub = source._decode_range(fs, path, header, cb, ce)
            batches.append(
                sub.filter(overlap_mask(sub, header, traversal.intervals)))
    if traversal.traverse_unplaced_unmapped:
        # the tail chunk: from the end of the last mapped chunk (the
        # largest ref_end; the first record without one) to the end of
        # the data
        last_mapped_end = max((r.ref_end for r in bai.refs if r.ref_end),
                              default=0)
        if last_mapped_end == 0:
            from disq_tpu_torch.bam.source import read_header

            _, last_mapped_end = read_header(fs, path)
        end_vo = source._data_end_voffset(fs, path)
        tail = source._decode_range(fs, path, header, last_mapped_end, end_vo)
        batches.append(tail.filter(tail.refid == -1))
    return ColumnarBatch.concat(batches)
