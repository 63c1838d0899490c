"""BAM record codec: record bytes ⇄ columnar ``ReadBatch``.

A two-pass vectorized design:

  pass 1 — walk the ``block_size`` chain to produce the record-offset
  vector (sequential by nature; lives on host, with a C++ fast path in
  ``disq_tpu_torch.native`` when built);

  pass 2 — all field extraction is vectorized numpy over the whole blob:
  fixed columns come from one strided gather, ragged columns (name /
  cigar / seq / qual / tags) from segment gathers whose index arithmetic
  is derived from the fixed columns. No per-record Python loop.

BAM record layout after the 4-byte ``block_size`` (SAM spec §4.2):
refID i32 · pos i32 · l_read_name u8 · mapq u8 · bin u16 · n_cigar_op u16
· flag u16 · l_seq i32 · next_refID i32 · next_pos i32 · tlen i32 (32 B
fixed) · read_name (l_read_name, NUL-terminated) · cigar (4·n_cigar_op) ·
seq ((l_seq+1)/2 packed nibbles) · qual (l_seq) · tags (to end).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from disq_tpu_torch.bam.columnar import ReadBatch

_FIXED = 32  # bytes after block_size


def scan_record_offsets(blob: bytes | np.ndarray, base: int = 0) -> np.ndarray:
    """Pass 1: offsets of every record's ``block_size`` field in ``blob``,
    starting at ``base``; returns ``(N+1,)`` int64 (last = end offset).

    Sequential chain walk; prefers the native C++ scanner when available.
    """
    buf = np.asarray(memoryview(blob), dtype=np.uint8) if not isinstance(blob, np.ndarray) else blob
    try:
        from disq_tpu_torch.native import scan_bam_offsets_native

        # Match the Python fallback's semantics exactly: scanning starts
        # AT `base` (bytes before it are not part of the record chain).
        return scan_bam_offsets_native(buf[base:] if base else buf, base)
    except ImportError:
        pass
    return np.asarray(_walk_record_chain(buf, base, strict=True),
                      dtype=np.int64)


def scan_record_offsets_tolerant(blob: bytes | np.ndarray) -> np.ndarray:
    """``scan_record_offsets`` for a buffer whose tail may be cut off (a
    run of good blocks before a skipped corrupt one): stops at the last
    complete record instead of raising. An impossible link (a
    ``block_size`` below the fixed section) stops the walk too: under
    skip/quarantine the caller keeps what decoded cleanly."""
    buf = (np.asarray(memoryview(blob), dtype=np.uint8)
           if not isinstance(blob, np.ndarray) else blob)
    return np.asarray(_walk_record_chain(buf, 0, strict=False),
                      dtype=np.int64)


def _walk_record_chain(buf: np.ndarray, base: int, strict: bool) -> list:
    """The sequential ``block_size`` chain walk: strict raises on an
    impossible link or trailing garbage, tolerant stops at the last
    complete record."""
    end = len(buf)
    offsets = [base]
    pos = base
    # int.from_bytes over a memoryview is the fastest pure-Python path.
    mv = memoryview(buf)
    while pos + 4 <= end:
        block_size = int.from_bytes(mv[pos: pos + 4], "little")
        nxt = pos + 4 + block_size
        if block_size < _FIXED or nxt > end:
            if strict:
                raise ValueError(
                    f"corrupt BAM record at offset {pos}: "
                    f"block_size={block_size}"
                )
            break
        offsets.append(nxt)
        pos = nxt
    if strict and pos != end:
        raise ValueError(f"trailing garbage after records: {end - pos} bytes")
    return offsets


def decode_records(
    blob: bytes | np.ndarray,
    offsets: Optional[np.ndarray] = None,
    n_ref: Optional[int] = None,
) -> ReadBatch:
    """Pass 2: vectorized field extraction into a ``ReadBatch``."""
    buf = (
        np.frombuffer(blob, dtype=np.uint8)
        if not isinstance(blob, np.ndarray)
        else blob
    )
    if offsets is None:
        offsets = scan_record_offsets(buf)
    offsets = offsets.astype(np.int64)
    n = len(offsets) - 1
    if n == 0:
        return ReadBatch.empty()

    try:
        from disq_tpu_torch.native import decode_records_native

        cols = decode_records_native(buf, offsets)
        _check_refids(cols["refid"], cols["next_refid"], n_ref)
        return ReadBatch(**cols)
    except ImportError:
        pass

    starts = offsets[:-1]
    # One strided gather pulls every record's 4+32-byte prefix as (N, 36).
    fixed = buf[starts[:, None] + np.arange(4 + _FIXED)]
    as_i32 = fixed.view("<i4")      # (N, 9)
    as_u16 = fixed.view("<u2")      # (N, 18)
    refid = as_i32[:, 1].copy()
    pos = as_i32[:, 2].copy()
    l_read_name = fixed[:, 12].astype(np.int64)
    mapq = fixed[:, 13].copy()
    bin_ = as_u16[:, 7].copy()
    n_cigar = as_u16[:, 8].astype(np.int64)
    flag = as_u16[:, 9].copy()
    l_seq = as_i32[:, 5].astype(np.int64)
    next_refid = as_i32[:, 6].copy()
    next_pos = as_i32[:, 7].copy()
    tlen = as_i32[:, 8].copy()

    _check_refids(refid, next_refid, n_ref)

    # Section start offsets, derived arithmetically from the fixed columns.
    name_start = starts + 4 + _FIXED
    cigar_start = name_start + l_read_name
    seq_start = cigar_start + 4 * n_cigar
    n_seq_bytes = (l_seq + 1) // 2
    qual_start = seq_start + n_seq_bytes
    tag_start = qual_start + l_seq
    rec_end = offsets[1:]
    if (tag_start > rec_end).any():
        i = int(np.nonzero(tag_start > rec_end)[0][0])
        raise ValueError(f"record {i}: sections exceed block_size")

    # Names (drop the NUL terminator).
    name_len = l_read_name - 1
    names, name_off = _ragged_gather(buf, name_start, name_len)

    # CIGAR: gather bytes then view as u32 op-words.
    cigar_bytes, _ = _ragged_gather(buf, cigar_start, 4 * n_cigar)
    cigars = cigar_bytes.view("<u4").copy() if len(cigar_bytes) else np.zeros(0, np.uint32)
    cigar_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(n_cigar, out=cigar_off[1:])

    # Seq: gather packed bytes, then unpack nibbles (hi first).
    packed, packed_off = _ragged_gather(buf, seq_start, n_seq_bytes)
    seq_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(l_seq, out=seq_off[1:])
    total_bases = int(seq_off[-1])
    seqs = np.zeros(total_bases, dtype=np.uint8)
    if total_bases:
        # For base k of record i: byte = packed[packed_off[i] + k//2],
        # hi nibble when k even.
        seg = np.repeat(np.arange(n), l_seq)
        within = np.arange(total_bases, dtype=np.int64) - seq_off[seg]
        byte_idx = packed_off[seg] + within // 2
        vals = packed[byte_idx]
        seqs = np.where(within % 2 == 0, vals >> 4, vals & 0xF).astype(np.uint8)

    quals, _ = _ragged_gather(buf, qual_start, l_seq)
    tags, tag_off = _ragged_gather(buf, tag_start, rec_end - tag_start)

    return ReadBatch(
        refid=refid, pos=pos, mapq=mapq, bin=bin_, flag=flag,
        next_refid=next_refid, next_pos=next_pos, tlen=tlen,
        name_offsets=name_off, names=names,
        cigar_offsets=cigar_off, cigars=cigars,
        seq_offsets=seq_off, seqs=seqs, quals=quals,
        tag_offsets=tag_off, tags=tags,
    )


def _check_refids(refid, next_refid, n_ref) -> None:
    if n_ref is None:
        return
    bad = (refid >= n_ref) | (refid < -1) | (next_refid >= n_ref) | (next_refid < -1)
    if bad.any():
        i = int(np.nonzero(bad)[0][0])
        raise ValueError(f"record {i}: refID out of range ({refid[i]})")


def _ragged_gather(
    buf: np.ndarray, starts: np.ndarray, lens: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Gather per-record byte ranges into (flat, offsets)."""
    lens = np.maximum(lens, 0)
    off = np.zeros(len(starts) + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    total = int(off[-1])
    if total == 0:
        return np.zeros(0, dtype=buf.dtype), off
    seg = np.repeat(np.arange(len(starts)), lens)
    within = np.arange(total, dtype=np.int64) - off[seg]
    return buf[starts[seg] + within], off


def encode_records(batch: ReadBatch) -> bytes:
    """Columnar batch → concatenated BAM record bytes (vectorized scatter).

    Byte-identical round trip with ``decode_records`` (the ``bin`` column
    is preserved verbatim; seq nibble padding is zero as per spec).
    """
    return encode_records_with_offsets(batch)[0]


def encode_records_with_offsets(batch: ReadBatch) -> tuple[bytes, np.ndarray]:
    """Like ``encode_records`` but also returns the ``(N+1,)`` record
    byte-offset vector — the input to virtual-offset / index computation
    (single source of truth for the record-size arithmetic)."""
    n = batch.count
    if n == 0:
        return b"", np.zeros(1, dtype=np.int64)
    try:
        from disq_tpu_torch.native import encode_records_native

        return encode_records_native(batch)
    except ImportError:
        pass
    name_len = np.diff(batch.name_offsets)
    if (name_len > 254).any():
        i = int(np.nonzero(name_len > 254)[0][0])
        raise ValueError(
            f"record {i}: read name of {int(name_len[i])} bytes exceeds the "
            "BAM limit of 254 (l_read_name is u8 incl. NUL)"
        )
    n_cigar_check = np.diff(batch.cigar_offsets)
    if (n_cigar_check > 0xFFFF).any():
        i = int(np.nonzero(n_cigar_check > 0xFFFF)[0][0])
        raise ValueError(
            f"record {i}: {int(n_cigar_check[i])} CIGAR ops exceeds the BAM "
            "field limit of 65535 (n_cigar_op is u16; the SAM-spec CG-tag "
            "spill is not implemented yet)"
        )
    n_cigar = np.diff(batch.cigar_offsets)
    l_seq = np.diff(batch.seq_offsets)
    tag_len = np.diff(batch.tag_offsets)
    n_seq_bytes = (l_seq + 1) // 2
    block_size = _FIXED + (name_len + 1) + 4 * n_cigar + n_seq_bytes + l_seq + tag_len
    rec_starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(4 + block_size, out=rec_starts[1:])
    out = np.zeros(int(rec_starts[-1]), dtype=np.uint8)

    fixed = np.zeros((n, 4 + _FIXED), dtype=np.uint8)
    fi32 = fixed.view("<i4")
    fu16 = fixed.view("<u2")
    fi32[:, 0] = block_size
    fi32[:, 1] = batch.refid
    fi32[:, 2] = batch.pos
    fixed[:, 12] = (name_len + 1).astype(np.uint8)
    fixed[:, 13] = batch.mapq
    fu16[:, 7] = batch.bin
    fu16[:, 8] = n_cigar.astype(np.uint16)
    fu16[:, 9] = batch.flag
    fi32[:, 5] = l_seq
    fi32[:, 6] = batch.next_refid
    fi32[:, 7] = batch.next_pos
    fi32[:, 8] = batch.tlen
    out[rec_starts[:-1, None] + np.arange(4 + _FIXED)] = fixed

    name_start = rec_starts[:-1] + 4 + _FIXED
    _ragged_scatter(out, name_start, batch.names, batch.name_offsets)
    # NUL terminators land one past each name.
    out[name_start + name_len] = 0

    cigar_start = name_start + name_len + 1
    cigar_bytes = batch.cigars.view(np.uint8) if len(batch.cigars) else np.zeros(0, np.uint8)
    _ragged_scatter(out, cigar_start, cigar_bytes, batch.cigar_offsets * 4)

    seq_start = cigar_start + 4 * n_cigar
    total_bases = int(batch.seq_offsets[-1])
    if total_bases:
        packed_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(n_seq_bytes, out=packed_off[1:])
        packed = np.zeros(int(packed_off[-1]), dtype=np.uint8)
        seg = np.repeat(np.arange(n), l_seq)
        within = np.arange(total_bases, dtype=np.int64) - batch.seq_offsets[seg]
        byte_idx = packed_off[seg] + within // 2
        hi = within % 2 == 0
        np.bitwise_or.at(
            packed, byte_idx,
            np.where(hi, batch.seqs << 4, batch.seqs & 0xF).astype(np.uint8),
        )
        _ragged_scatter(out, seq_start, packed, packed_off)

    qual_start = seq_start + n_seq_bytes
    _ragged_scatter(out, qual_start, batch.quals, batch.seq_offsets)

    tag_start = qual_start + l_seq
    _ragged_scatter(out, tag_start, batch.tags, batch.tag_offsets)
    return out.tobytes(), rec_starts


def _ragged_scatter(
    out: np.ndarray, dst_starts: np.ndarray, flat: np.ndarray, offsets: np.ndarray
) -> None:
    """Scatter ragged segments i (given by offsets) to ``dst_starts[i]``."""
    offsets = offsets.astype(np.int64)
    lens = np.diff(offsets)
    total = int(offsets[-1] - offsets[0])
    if total == 0:
        return
    n = len(lens)
    seg = np.repeat(np.arange(n), lens)
    within = np.arange(len(flat) - int(offsets[0]), dtype=np.int64)
    within = within - (offsets[seg] - offsets[0])
    out[dst_starts[seg] + within] = flat[int(offsets[0]):]
