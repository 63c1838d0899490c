"""Tabix (.tbi) index: build / serialize / parse / query / merge.

Replaces htsjdk's ``TabixIndex`` + ``TabixIndexMerger`` (SURVEY.md §2.2,
§2.7). Binning/linear structure is identical to BAI (reused from
``disq_tpu_torch.index.bai``); tabix adds a typed header (format preset,
column mapping, meta char, contig name table). VCF preset: format=2,
seq col 1, begin col 2, end col 0 (END derived from the record), meta
``#``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from disq_tpu_torch.index.bai import (
    LINEAR_SHIFT,
    METADATA_BIN,
    RefIndex,
    merge_bai_fragments,
    reg2bin,
    reg2bins,
    BaiIndex,
)

TBI_MAGIC = b"TBI\x01"
VCF_PRESET = dict(format=2, col_seq=1, col_beg=2, col_end=0, meta=ord("#"), skip=0)


@dataclass
class TbiIndex:
    names: List[str]
    refs: List[RefIndex]
    n_no_coor: int = 0
    format: int = 2
    col_seq: int = 1
    col_beg: int = 2
    col_end: int = 0
    meta: int = ord("#")
    skip: int = 0

    def to_bytes(self) -> bytes:
        out = bytearray()
        out += TBI_MAGIC
        names_blob = b"".join(n.encode() + b"\x00" for n in self.names)
        out += struct.pack(
            "<8i", len(self.refs), self.format, self.col_seq, self.col_beg,
            self.col_end, self.meta, self.skip, len(names_blob),
        )
        out += names_blob
        for r in self.refs:
            bin_ids = sorted(r.bins)
            has_meta = bool(r.n_mapped or r.n_unmapped)
            out += struct.pack("<i", len(bin_ids) + (1 if has_meta else 0))
            for b in bin_ids:
                chunks = r.bins[b]
                out += struct.pack("<Ii", b, len(chunks))
                for beg, end in chunks:
                    out += struct.pack("<QQ", beg, end)
            if has_meta:
                out += struct.pack("<Ii", METADATA_BIN, 2)
                out += struct.pack("<QQ", r.ref_beg, r.ref_end)
                out += struct.pack("<QQ", r.n_mapped, r.n_unmapped)
            out += struct.pack("<i", len(r.linear))
            out += r.linear.astype("<u8").tobytes()
        out += struct.pack("<Q", self.n_no_coor)
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "TbiIndex":
        if data[:4] != TBI_MAGIC:
            raise ValueError("not a tabix index")
        n_ref, fmt, cs, cb, ce, meta, skip, l_nm = struct.unpack_from("<8i", data, 4)
        p = 36
        names = data[p: p + l_nm].split(b"\x00")[:-1]
        names = [n.decode() for n in names]
        p += l_nm
        refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, p)
            p += 4
            r = RefIndex()
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", data, p)
                p += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, p)
                    p += 16
                    chunks.append((beg, end))
                if b == METADATA_BIN and n_chunk == 2:
                    r.ref_beg, r.ref_end = chunks[0]
                    r.n_mapped, r.n_unmapped = chunks[1]
                else:
                    r.bins[b] = chunks
            (n_intv,) = struct.unpack_from("<i", data, p)
            p += 4
            r.linear = np.frombuffer(data, "<u8", count=n_intv, offset=p).copy()
            p += 8 * n_intv
            refs.append(r)
        n_no_coor = 0
        if p + 8 <= len(data):
            (n_no_coor,) = struct.unpack_from("<Q", data, p)
        return cls(names, refs, n_no_coor, fmt, cs, cb, ce, meta, skip)

    def chunks_for_interval(self, contig: str, beg0: int, end0: int):
        """Coalesced chunks for 0-based half-open [beg0, end0)."""
        if contig not in self.names:
            return []
        return BaiIndex(self.refs).chunks_for_interval(
            self.names.index(contig), beg0, end0
        )


def build_tbi(
    contig_names: Sequence[str],
    chrom: np.ndarray,
    pos: np.ndarray,   # 1-based
    end: np.ndarray,   # 1-based inclusive
    voffsets: np.ndarray,
    end_voffsets: np.ndarray,
) -> TbiIndex:
    """Build from coordinate-sorted variant columns (same segmented-scan
    design as BAI; beg converted to 0-based half-open internally)."""
    from disq_tpu_torch.index.bai import build_bai

    n_ref = len(contig_names)
    beg0 = pos.astype(np.int64) - 1
    end0 = end.astype(np.int64)  # inclusive 1-based == exclusive 0-based
    bai = build_bai(
        refid=chrom.astype(np.int32),
        pos=beg0.astype(np.int32),
        end=end0.astype(np.int32),
        flag=np.zeros(len(chrom), np.uint16),
        voffsets=voffsets,
        end_voffsets=end_voffsets,
        n_ref=n_ref,
    )
    return TbiIndex(list(contig_names), bai.refs, bai.n_no_coor, **{
        "format": VCF_PRESET["format"], "col_seq": VCF_PRESET["col_seq"],
        "col_beg": VCF_PRESET["col_beg"], "col_end": VCF_PRESET["col_end"],
        "meta": VCF_PRESET["meta"], "skip": VCF_PRESET["skip"],
    })


def merge_tbi_fragments(
    fragments: Sequence[TbiIndex], part_starts: Sequence[int]
) -> TbiIndex:
    """Offset-shift merge (htsjdk ``TabixIndexMerger`` analogue): reuses
    the BAI fragment merger on the shared bin structure."""
    if not fragments:
        raise ValueError("no fragments")
    bai = merge_bai_fragments(
        [BaiIndex(f.refs, f.n_no_coor) for f in fragments], part_starts
    )
    first = fragments[0]
    return TbiIndex(
        first.names, bai.refs, bai.n_no_coor, first.format, first.col_seq,
        first.col_beg, first.col_end, first.meta, first.skip,
    )
