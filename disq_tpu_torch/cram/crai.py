"""CRAI index — gzip-compressed text, one line per slice.

Replaces htsjdk's ``CRAIIndex`` + ``CRAIIndexMerger`` (SURVEY.md §2.2):
``seqId \\t alignmentStart \\t alignmentSpan \\t containerStartByteOffset
\\t sliceByteOffset \\t sliceByteSize``. Merging part indexes shifts the
container offsets by each part's absolute start (byte offsets, no <<16:
CRAM has no BGZF virtual offsets).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import List, Sequence, Tuple


@dataclass(frozen=True)
class CraiEntry:
    seq_id: int
    start: int       # 1-based alignment start (0 for unmapped slices)
    span: int
    container_offset: int
    slice_offset: int  # from end of container header
    slice_size: int


class CraiIndex:
    def __init__(self, entries: List[CraiEntry]):
        self.entries = entries

    def to_bytes(self) -> bytes:
        text = "".join(
            f"{e.seq_id}\t{e.start}\t{e.span}\t{e.container_offset}\t"
            f"{e.slice_offset}\t{e.slice_size}\n"
            for e in self.entries
        )
        return gzip.compress(text.encode(), mtime=0)

    @classmethod
    def from_bytes(cls, data: bytes) -> "CraiIndex":
        try:
            text = gzip.decompress(data).decode()
        except Exception as e:   # gzip/zlib/unicode errors
            raise ValueError(f"corrupt .crai index: {e}") from e
        entries = []
        for line in text.splitlines():
            if not line.strip():
                continue
            f = line.split("\t")
            entries.append(
                CraiEntry(int(f[0]), int(f[1]), int(f[2]), int(f[3]),
                          int(f[4]), int(f[5]))
            )
        return cls(entries)

    def containers_for_interval(
        self, seq_id: int, beg1: int, end1: int
    ) -> List[int]:
        """Container offsets of slices possibly overlapping the 1-based
        closed interval."""
        out = []
        for e in self.entries:
            if e.seq_id != seq_id:
                continue
            e_end = e.start + max(e.span, 1) - 1
            if e.start <= end1 and e_end >= beg1:
                out.append(e.container_offset)
        return sorted(set(out))

    @classmethod
    def merge(
        cls, fragments: Sequence["CraiIndex"], part_starts: Sequence[int]
    ) -> "CraiIndex":
        entries: List[CraiEntry] = []
        for frag, start in zip(fragments, part_starts):
            for e in frag.entries:
                entries.append(
                    CraiEntry(
                        e.seq_id, e.start, e.span,
                        e.container_offset + start,
                        e.slice_offset, e.slice_size,
                    )
                )
        return cls(entries)
