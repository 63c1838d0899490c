"""SBI splitting index — read / write / merge.

The SBI format (htsjdk ``SBIIndex`` / ``SBIIndexWriter``; upstreamed from
the disq effort, SURVEY.md §2.2 ``IndexFileMerger``): little-endian

    magic "SBI\\1" · file_length u64 · md5[16] · uuid[16] ·
    total_records u64 · granularity u64 · n_offsets u64 ·
    offsets u64[n_offsets]

``offsets`` are the virtual file offsets of every ``granularity``-th
record start, plus a final offset just past the last record. BamSource
uses it as the exact-boundary fast path (no guessing); BamSink emits one
per write. Merging shifts each part's offsets into the merged file's
virtual-offset space — compressed offsets add, so the shift is
``part_start << 16``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Sequence

import numpy as np

SBI_MAGIC = b"SBI\x01"
_HEADER_FMT = "<4sQ16s16sQQQ"
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)


@dataclass(frozen=True)
class SbiIndex:
    file_length: int
    total_records: int
    granularity: int
    offsets: np.ndarray  # (n,) uint64 virtual offsets, final = end-of-data

    def to_bytes(self) -> bytes:
        header = struct.pack(
            _HEADER_FMT, SBI_MAGIC, self.file_length, b"\x00" * 16,
            b"\x00" * 16, self.total_records, self.granularity,
            len(self.offsets),
        )
        return header + self.offsets.astype("<u8").tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "SbiIndex":
        magic, flen, _md5, _uuid, total, gran, n = struct.unpack_from(
            _HEADER_FMT, data
        )
        if magic != SBI_MAGIC:
            raise ValueError(f"not an SBI index (magic {magic!r})")
        offsets = np.frombuffer(
            data, dtype="<u8", count=n, offset=_HEADER_SIZE
        ).copy()
        return cls(flen, total, gran, offsets)

    # -- queries (the BamSource fast path) ----------------------------------

    def first_offset_at_or_after(self, file_offset: int) -> int:
        """Smallest recorded virtual offset whose compressed-block part is
        ≥ ``file_offset`` — the split-boundary query disq runs against SBI."""
        target = file_offset << 16
        i = int(np.searchsorted(self.offsets, target, side="left"))
        if i >= len(self.offsets):
            return int(self.offsets[-1])
        return int(self.offsets[i])

    @property
    def end_voffset(self) -> int:
        return int(self.offsets[-1])

    # -- construction -------------------------------------------------------

    @classmethod
    def build(
        cls,
        record_voffsets: np.ndarray,
        end_voffset: int,
        file_length: int,
        granularity: int = 1,
    ) -> "SbiIndex":
        """From the virtual offsets of ALL records (subsampled here by
        ``granularity``) + the end-of-data virtual offset."""
        total = len(record_voffsets)
        sampled = np.asarray(record_voffsets, dtype=np.uint64)[::granularity]
        offsets = np.concatenate([sampled, [np.uint64(end_voffset)]])
        return cls(file_length, total, granularity, offsets)

    @classmethod
    def merge(
        cls,
        fragments: Sequence["SbiIndex"],
        part_starts: Sequence[int],
        file_length: int,
    ) -> "SbiIndex":
        """Offset-shift merge (ref: htsjdk ``SBIIndexMerger`` as used by
        ``IndexFileMerger``): fragment k's offsets are part-local; add
        ``part_starts[k] << 16`` to rebase, drop each fragment's trailing
        end-offset except the last."""
        if len(fragments) != len(part_starts):
            raise ValueError("fragments/part_starts length mismatch")
        out = []
        total = 0
        gran = fragments[0].granularity if fragments else 1
        for k, (frag, start) in enumerate(zip(fragments, part_starts)):
            shift = np.uint64(start << 16)
            offs = frag.offsets + shift
            if k != len(fragments) - 1:
                offs = offs[:-1]
            out.append(offs)
            total += frag.total_records
        return cls(
            file_length, total, gran,
            np.concatenate(out) if out else np.zeros(0, "<u8"),
        )
