"""Columnar alignment-record batch (host form).

A batch of N records is a struct-of-arrays: fixed-width columns plus
ragged columns (name / CIGAR / seq / qual / tags) stored as flat arrays
with ``(N+1,)`` offset vectors. Sequence bases are unpacked, one 4-bit
code per byte (the BAM nibble alphabet ``=ACMGRSVTWYHKDBN``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
CIGAR_OPS = "MIDNSHP=X"
_NT16_CHARS = np.frombuffer(SEQ_NT16.encode(), dtype=np.uint8)

FIXED_COLUMNS = ("refid", "pos", "mapq", "bin", "flag",
                 "next_refid", "next_pos", "tlen")
RAGGED_COLUMNS = ("name_offsets", "names", "cigar_offsets", "cigars",
                  "seq_offsets", "seqs", "quals", "tag_offsets", "tags")


def segment_gather(flat: np.ndarray, offsets: np.ndarray,
                   indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Gather ragged segments ``indices`` from (flat, offsets) into a
    new (flat, offsets) pair: native per-segment memcpy when built,
    else vectorized numpy."""
    try:
        from disq_tpu_torch.native import segment_gather_native

        return segment_gather_native(flat, offsets, indices)
    except ImportError:
        pass
    offsets = offsets.astype(np.int64)
    lens = np.diff(offsets)[indices]
    new_off = np.zeros(len(indices) + 1, dtype=np.int64)
    np.cumsum(lens, out=new_off[1:])
    total = int(new_off[-1])
    if total == 0:
        return flat[:0].copy(), new_off
    seg_ids = np.repeat(np.arange(len(indices)), lens)
    within = np.arange(total, dtype=np.int64) - new_off[seg_ids]
    src = offsets[indices][seg_ids] + within
    return flat[src], new_off


def _concat_ragged(flats: Sequence[np.ndarray], offsets: Sequence[np.ndarray]):
    lens = [np.diff(o.astype(np.int64)) for o in offsets]
    all_lens = np.concatenate(lens) if lens else np.zeros(0, np.int64)
    new_off = np.zeros(len(all_lens) + 1, dtype=np.int64)
    np.cumsum(all_lens, out=new_off[1:])
    return (np.concatenate(list(flats)) if flats else np.zeros(0, np.uint8),
            new_off)


@dataclass
class ReadBatch:
    """N alignment records, struct-of-arrays.

    Fixed columns (shape ``(N,)``): ``refid`` i32, ``pos`` i32 (0-based),
    ``mapq`` u8, ``bin`` u16, ``flag`` u16, ``next_refid`` i32,
    ``next_pos`` i32, ``tlen`` i32. Ragged columns with ``(N+1,)`` i64
    offsets: ``names`` (no NUL), ``cigars`` (u32 op words), ``seqs``
    (u8 nibble codes), ``quals`` (sharing ``seq_offsets``), ``tags``.
    """

    refid: np.ndarray
    pos: np.ndarray
    mapq: np.ndarray
    bin: np.ndarray
    flag: np.ndarray
    next_refid: np.ndarray
    next_pos: np.ndarray
    tlen: np.ndarray
    name_offsets: np.ndarray
    names: np.ndarray
    cigar_offsets: np.ndarray
    cigars: np.ndarray
    seq_offsets: np.ndarray
    seqs: np.ndarray
    quals: np.ndarray
    tag_offsets: np.ndarray
    tags: np.ndarray

    @property
    def count(self) -> int:
        return len(self.refid)

    def __len__(self) -> int:
        return self.count

    @classmethod
    def empty(cls) -> "ReadBatch":
        z = lambda dt: np.zeros(0, dtype=dt)  # noqa: E731
        off = np.zeros(1, dtype=np.int64)
        return cls(
            refid=z(np.int32), pos=z(np.int32), mapq=z(np.uint8),
            bin=z(np.uint16), flag=z(np.uint16), next_refid=z(np.int32),
            next_pos=z(np.int32), tlen=z(np.int32),
            name_offsets=off.copy(), names=z(np.uint8),
            cigar_offsets=off.copy(), cigars=z(np.uint32),
            seq_offsets=off.copy(), seqs=z(np.uint8), quals=z(np.uint8),
            tag_offsets=off.copy(), tags=z(np.uint8),
        )

    def take(self, indices: np.ndarray) -> "ReadBatch":
        """Gather records by index — the primitive behind sort."""
        indices = np.asarray(indices, dtype=np.int64)
        names, name_off = segment_gather(self.names, self.name_offsets, indices)
        cigars, cigar_off = segment_gather(self.cigars, self.cigar_offsets, indices)
        seqs, seq_off = segment_gather(self.seqs, self.seq_offsets, indices)
        quals, _ = segment_gather(self.quals, self.seq_offsets, indices)
        tags, tag_off = segment_gather(self.tags, self.tag_offsets, indices)
        fixed = {c: getattr(self, c)[indices] for c in FIXED_COLUMNS}
        return ReadBatch(
            **fixed,
            name_offsets=name_off, names=names,
            cigar_offsets=cigar_off, cigars=cigars,
            seq_offsets=seq_off, seqs=seqs, quals=quals,
            tag_offsets=tag_off, tags=tags,
        )

    def filter(self, mask: np.ndarray) -> "ReadBatch":
        return self.take(np.nonzero(np.asarray(mask))[0])

    def slice(self, start: int, stop: int) -> "ReadBatch":
        return self.take(np.arange(start, stop, dtype=np.int64))

    @classmethod
    def concat(cls, batches: Sequence["ReadBatch"]) -> "ReadBatch":
        batches = list(batches)
        if not batches:
            return cls.empty()
        if len(batches) == 1:
            return batches[0]
        names, name_off = _concat_ragged(
            [b.names for b in batches], [b.name_offsets for b in batches])
        cigars, cigar_off = _concat_ragged(
            [b.cigars for b in batches], [b.cigar_offsets for b in batches])
        seqs, seq_off = _concat_ragged(
            [b.seqs for b in batches], [b.seq_offsets for b in batches])
        quals, _ = _concat_ragged(
            [b.quals for b in batches], [b.seq_offsets for b in batches])
        tags, tag_off = _concat_ragged(
            [b.tags for b in batches], [b.tag_offsets for b in batches])
        fixed = {c: np.concatenate([getattr(b, c) for b in batches])
                 for c in FIXED_COLUMNS}
        return cls(
            **fixed,
            name_offsets=name_off, names=names,
            cigar_offsets=cigar_off, cigars=cigars,
            seq_offsets=seq_off, seqs=seqs, quals=quals,
            tag_offsets=tag_off, tags=tags,
        )

    def name(self, i: int) -> str:
        s, e = self.name_offsets[i], self.name_offsets[i + 1]
        return self.names[s:e].tobytes().decode()

    def sequence(self, i: int) -> str:
        s, e = self.seq_offsets[i], self.seq_offsets[i + 1]
        return _NT16_CHARS[self.seqs[s:e]].tobytes().decode("ascii")

    def cigar_string(self, i: int) -> str:
        s, e = self.cigar_offsets[i], self.cigar_offsets[i + 1]
        ops = self.cigars[s:e]
        if len(ops) == 0:
            return "*"
        return "".join(f"{int(op) >> 4}{CIGAR_OPS[int(op) & 0xF]}" for op in ops)

    def qual_string(self, i: int) -> str:
        """Phred+33 qualities, or ``"*"`` when absent (a first quality
        byte of 0xFF)."""
        s, e = self.seq_offsets[i], self.seq_offsets[i + 1]
        q = self.quals[s:e]
        if len(q) == 0 or q[0] == 0xFF:
            return "*"
        return (q + 33).astype(np.uint8).tobytes().decode("latin-1")

    def reference_lengths(self) -> np.ndarray:
        """Reference-consumed length per record: ops M/D/N/=/X."""
        return reference_lengths(self.cigars, self.cigar_offsets)

    def alignment_ends(self) -> np.ndarray:
        """0-based exclusive end positions (pos + reflen, min 1)."""
        return alignment_ends(self.pos, self.reference_lengths())


def reference_lengths(cigars: np.ndarray,
                      cigar_offsets: np.ndarray) -> np.ndarray:
    """Reference-consumed length of each record whose CIGAR op words are
    ``cigars[cigar_offsets[i]:cigar_offsets[i + 1]]``: ops M/D/N/=/X."""
    op = (cigars & 0xF).astype(np.int64)
    ln = (cigars >> 4).astype(np.int64)
    contrib = np.where(np.isin(op, (0, 2, 3, 7, 8)), ln, 0)
    sums = np.add.reduceat(
        np.concatenate([contrib, [0]]),
        np.minimum(cigar_offsets[:-1], len(contrib)),
    ) if len(cigar_offsets) > 1 else np.zeros(0, np.int64)
    # reduceat gives the next element's value for an empty segment
    empty = np.diff(cigar_offsets) == 0
    return np.where(empty, 0, sums)


def alignment_ends(pos: np.ndarray, reflen: np.ndarray) -> np.ndarray:
    """0-based exclusive end positions (pos + reflen, min 1)."""
    return pos + np.maximum(reflen, 1).astype(np.int32)
