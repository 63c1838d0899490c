"""Columnar variant batch.

Replaces htsjdk's per-record ``VariantContext`` objects (SURVEY.md §2.8):
coordinate columns (chrom id, 1-based pos, end) as device-ready arrays
for vectorized interval filtering and sorting, plus the verbatim line
bytes as a ragged column so writes are lossless. Full per-field
decomposition (INFO/FORMAT columns) can layer on top without changing
this contract.

``end`` follows htsjdk semantics: ``POS + len(REF) − 1``, overridden by
an ``END=`` INFO key when present (symbolic alleles / structural
variants).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from disq_tpu_torch.bam.columnar import segment_gather


@dataclass
class VariantBatch:
    chrom: np.ndarray        # (N,) int32 — index into contig_names
    pos: np.ndarray          # (N,) int32, 1-based
    end: np.ndarray          # (N,) int32, 1-based inclusive
    line_offsets: np.ndarray  # (N+1,) int64
    lines: np.ndarray        # flat uint8 — verbatim body lines (no \n)
    contig_names: Tuple[str, ...] = ()

    @property
    def count(self) -> int:
        return len(self.chrom)

    def __len__(self) -> int:
        return self.count

    @classmethod
    def empty(cls, contig_names: Tuple[str, ...] = ()) -> "VariantBatch":
        return cls(
            chrom=np.zeros(0, np.int32), pos=np.zeros(0, np.int32),
            end=np.zeros(0, np.int32),
            line_offsets=np.zeros(1, np.int64), lines=np.zeros(0, np.uint8),
            contig_names=contig_names,
        )

    def line(self, i: int) -> str:
        s, e = self.line_offsets[i], self.line_offsets[i + 1]
        return self.lines[s:e].tobytes().decode()

    def take(self, indices: np.ndarray) -> "VariantBatch":
        indices = np.asarray(indices, dtype=np.int64)
        lines, off = segment_gather(self.lines, self.line_offsets, indices)
        return VariantBatch(
            chrom=self.chrom[indices], pos=self.pos[indices],
            end=self.end[indices], line_offsets=off, lines=lines,
            contig_names=self.contig_names,
        )

    def filter(self, mask: np.ndarray) -> "VariantBatch":
        return self.take(np.nonzero(np.asarray(mask))[0])

    def slice(self, start: int, stop: int) -> "VariantBatch":
        return self.take(np.arange(start, stop, dtype=np.int64))

    @classmethod
    def concat(cls, batches: Sequence["VariantBatch"]) -> "VariantBatch":
        batches = list(batches)
        if not batches:
            return cls.empty()
        if len(batches) == 1:
            return batches[0]
        names = batches[0].contig_names
        maps = []
        for b in batches:
            if b.contig_names == names:
                maps.append(None)
            else:
                # Remap chrom ids into a merged name list.
                merged = list(names)
                idx = {n: i for i, n in enumerate(merged)}
                m = np.empty(len(b.contig_names), dtype=np.int32)
                for j, n in enumerate(b.contig_names):
                    if n not in idx:
                        idx[n] = len(merged)
                        merged.append(n)
                    m[j] = idx[n]
                names = tuple(merged)
                maps.append(m)
        chroms = []
        for b, m in zip(batches, maps):
            chroms.append(b.chrom if m is None else m[b.chrom])
        lens = np.concatenate([np.diff(b.line_offsets) for b in batches])
        off = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=off[1:])
        return cls(
            chrom=np.concatenate(chroms),
            pos=np.concatenate([b.pos for b in batches]),
            end=np.concatenate([b.end for b in batches]),
            line_offsets=off,
            lines=np.concatenate([b.lines for b in batches]),
            contig_names=names,
        )

    def coordinate_sort(self) -> "VariantBatch":
        order = np.lexsort((self.pos, self.chrom))
        return self.take(order)


def parse_vcf_lines(
    raw_lines: List[bytes], contig_names: Sequence[str]
) -> VariantBatch:
    """Body lines → VariantBatch. Contigs not in ``contig_names`` are
    appended (lenient, like htsjdk's VCFCodec without a sequence dict)."""
    names = list(contig_names)
    idx = {n: i for i, n in enumerate(names)}
    n = len(raw_lines)
    chrom = np.empty(n, np.int32)
    pos = np.empty(n, np.int32)
    end = np.empty(n, np.int32)
    for i, ln in enumerate(raw_lines):
        f = ln.split(b"\t", 8)
        if len(f) < 8:
            raise ValueError(f"VCF line has {len(f)} fields (need >= 8): {ln[:60]!r}")
        cname = f[0].decode()
        ci = idx.get(cname)
        if ci is None:
            ci = idx[cname] = len(names)
            names.append(cname)
        chrom[i] = ci
        p = int(f[1])
        pos[i] = p
        e = p + len(f[3]) - 1
        info = f[7]
        if b"END=" in info:
            for kv in info.split(b";"):
                if kv.startswith(b"END="):
                    try:
                        e = int(kv[4:])
                    except ValueError:
                        pass
                    break
        end[i] = e
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(l) for l in raw_lines], out=off[1:])
    flat = (
        np.frombuffer(b"".join(raw_lines), dtype=np.uint8).copy()
        if n
        else np.zeros(0, np.uint8)
    )
    return VariantBatch(
        chrom=chrom, pos=pos, end=end, line_offsets=off, lines=flat,
        contig_names=tuple(names),
    )
