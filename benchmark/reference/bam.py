"""BAM decode by a host walk: every BGZF block inflated with zlib (CRC
and ISIZE checked), the record chain followed from the end of the header,
and the records' fields read into columns. The block walk is a frozen
copy of ``chip_smoke.py``'s ``walk_blocks``."""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

THREADS = min(8, os.cpu_count() or 1)
PREFIX = np.dtype([
    ("bs", "<i4"), ("refid", "<i4"), ("pos", "<i4"), ("lrn", "u1"),
    ("mapq", "u1"), ("bin", "<u2"), ("ncig", "<u2"), ("flag", "<u2"),
    ("lseq", "<i4"), ("next_refid", "<i4"), ("next_pos", "<i4"),
    ("tlen", "<i4")])
FIXED = ("refid", "pos", "mapq", "bin", "flag", "next_refid", "next_pos",
         "tlen")
# CIGAR operations that consume the reference: M, D, N, =, X
NIBBLES = np.stack([np.arange(256) >> 4, np.arange(256) & 0xF],
                   1).astype(np.uint8)
REF_OPS = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0], np.int64)


def walk_blocks(data) -> List[Tuple[int, int, int]]:
    """(offset, total size, header size) of every BGZF block, by the
    BSIZE chain."""
    out, p, n = [], 0, len(data)
    while p < n:
        if bytes(data[p:p + 4]) != b"\x1f\x8b\x08\x04":
            raise ValueError(f"no BGZF block at {p}")
        xlen = struct.unpack_from("<H", data, p + 10)[0]
        q, bsize = p + 12, None
        while q < p + 12 + xlen:
            if bytes(data[q:q + 2]) == b"BC":
                bsize = struct.unpack_from("<H", data, q + 4)[0]
            q += 4 + struct.unpack_from("<H", data, q + 2)[0]
        if bsize is None:
            raise ValueError(f"no BC field at {p}")
        out.append((p, bsize + 1, 12 + xlen))
        p += bsize + 1
    return out


def _inflate(data, blk) -> bytes:
    p, total, hdr = blk
    raw = zlib.decompress(bytes(data[p + hdr: p + total - 8]), -15)
    crc, isize = struct.unpack_from("<II", data, p + total - 8)
    if zlib.crc32(raw) != crc or len(raw) != isize:
        raise ValueError(f"block at {p} fails its CRC or ISIZE")
    return raw


@dataclass
class Decoded:
    """A decoded BAM: its blocks, the decoded stream, the header and the
    records' extents and fixed fields."""

    cstart: np.ndarray       # compressed offset of every block (EOF too)
    ustart: np.ndarray       # decoded offset of every block
    usize: np.ndarray        # decoded size of every block
    payload_bytes: int       # deflate payload bytes of all blocks
    raw: bytes               # the decoded stream
    blob: np.ndarray         # the same, as uint8
    header_text: str
    refs: List[Tuple[str, int]]
    start: np.ndarray        # offset of each record in ``blob``
    end: np.ndarray          # one past each record's end
    fixed: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def count(self) -> int:
        return len(self.start)

    def ragged(self, lo: int, hi: int) -> Dict[str, np.ndarray]:
        """The ragged columns of records [lo, hi) as flat arrays with
        (n+1,) offsets, in the layout of a columnar read batch: names
        without their NUL, CIGAR words, one 4-bit base code per byte,
        qualities, raw tag bytes."""
        return ragged_columns(self.raw, self.start[lo:hi], self.end[lo:hi],
                              {k: v[lo:hi] for k, v in self.fixed.items()})

    def start_voffsets(self) -> np.ndarray:
        """Virtual offset of each record's start (a start on a block
        boundary belongs to the next block)."""
        b = np.searchsorted(self.ustart, self.start, side="right") - 1
        return (self.cstart[b].astype(np.uint64) << np.uint64(16)) | \
            (self.start - self.ustart[b]).astype(np.uint64)

    def end_voffsets(self) -> np.ndarray:
        """Virtual offset one past each record: in the block holding its
        last byte, or at the next block's start when that block is full."""
        b = np.searchsorted(self.ustart, self.end - 1, side="right") - 1
        off = self.end - self.ustart[b]
        full = (off == self.usize[b]) & (self.usize[b] == 0xFF00)
        b = np.where(full, b + 1, b)
        off = np.where(full, 0, off)
        return (self.cstart[b].astype(np.uint64) << np.uint64(16)) | \
            off.astype(np.uint64)

    def reference_spans(self) -> np.ndarray:
        """Bases of the reference each record's CIGAR covers."""
        n = self.count
        ncig = self.fixed["ncig"].astype(np.int64)
        at = self.start + 36 + self.fixed["lrn"].astype(np.int64)
        words = _flat(self.blob, at, 4 * ncig).view("<u4")
        seg = np.repeat(np.arange(n), ncig)
        span = np.zeros(n, np.int64)
        np.add.at(span, seg, REF_OPS[words & 0xF] * (words >> 4))
        return span

    def alignment_ends(self) -> np.ndarray:
        """0-based exclusive ends: position plus reference span, at least
        one base."""
        return self.fixed["pos"].astype(np.int64) + \
            np.maximum(self.reference_spans(), 1)


def _flat(blob: np.ndarray, at: np.ndarray, length: np.ndarray) -> np.ndarray:
    """The bytes ``blob[at[i]: at[i] + length[i]]`` of every i, joined."""
    length = np.asarray(length, np.int64)
    if len(length) and (length == length[0]).all():
        return blob[np.asarray(at, np.int64)[:, None]
                    + np.arange(int(length[0]), dtype=np.int64)].reshape(-1)
    total = int(length.sum())
    if total == 0:
        return np.zeros(0, np.uint8)
    off = np.zeros(len(length), np.int64)
    np.cumsum(length[:-1], out=off[1:])
    idx = np.repeat(np.asarray(at, np.int64) - off, length) + \
        np.arange(total, dtype=np.int64)
    return blob[idx]


def _offsets(length: np.ndarray) -> np.ndarray:
    out = np.zeros(len(length) + 1, np.int64)
    np.cumsum(length, out=out[1:])
    return out


def _gather(raw: bytes, blob: np.ndarray, at, length) -> np.ndarray:
    """``_flat`` by the fastest route: one 2-D gather when every length
    is the same, else a join of byte slices."""
    length = np.asarray(length, np.int64)
    if not len(length) or (length == length[0]).all():
        return _flat(blob, at, length)
    return np.frombuffer(b"".join([raw[a:a + n] for a, n in zip(
        np.asarray(at, np.int64).tolist(), length.tolist())]), np.uint8)


def ragged_columns(raw: bytes, start, end, fixed) -> Dict[str, np.ndarray]:
    blob = np.frombuffer(raw, np.uint8)
    lrn = fixed["lrn"].astype(np.int64)
    ncig = fixed["ncig"].astype(np.int64)
    lseq = fixed["lseq"].astype(np.int64)
    name_len = np.maximum(lrn - 1, 0)
    cig_at = start + 36 + lrn
    seq_at = cig_at + 4 * ncig
    qual_at = seq_at + (lseq + 1) // 2
    tag_at = qual_at + lseq
    tag_len = end - tag_at
    if (tag_len < 0).any():
        raise ValueError("a record's fields overrun its block size")
    # one 4-bit code per base: the high nibble of each byte first, the
    # low one second; an odd length's last low nibble is padding
    packed = _gather(raw, blob, seq_at, (lseq + 1) // 2)
    nib = NIBBLES[packed].reshape(-1)
    odd = lseq % 2 == 1
    if odd.any():
        nib = np.delete(nib, _offsets((lseq + 1) // 2 * 2)[1:][odd] - 1)
    return {
        "names": _gather(raw, blob, start + 36, name_len),
        "name_offsets": _offsets(name_len),
        "cigars": _gather(raw, blob, cig_at, 4 * ncig).view("<u4")
        .astype(np.uint32),
        "cigar_offsets": _offsets(ncig),
        "seqs": nib,
        "seq_offsets": _offsets(lseq),
        "quals": _gather(raw, blob, qual_at, lseq),
        "tags": _gather(raw, blob, tag_at, tag_len),
        "tag_offsets": _offsets(tag_len),
    }


def record_chain(buf: bytes, p: int) -> np.ndarray:
    """Start of every record from ``p`` on, following the block sizes."""
    unpack, end = struct.Struct("<i").unpack_from, len(buf)
    starts = []
    append = starts.append
    while p < end:
        append(p)
        size = unpack(buf, p)[0]
        if size < 32:
            raise ValueError(f"record at {p} has block size {size}")
        p += 4 + size
    if p != end:
        raise ValueError("the record chain overruns the data")
    return np.array(starts, np.int64)


def decode_file(data, threads: int = THREADS) -> Decoded:
    """Decode a whole BAM file's bytes."""
    blocks = walk_blocks(data)
    with ThreadPoolExecutor(threads) as pool:
        payloads = list(pool.map(lambda b: _inflate(data, b), blocks))
    usize = np.array([len(x) for x in payloads], np.int64)
    ustart = np.zeros(len(usize), np.int64)
    np.cumsum(usize[:-1], out=ustart[1:])
    cstart = np.array([b[0] for b in blocks], np.int64)
    payload = int(sum(t - h - 8 for _, t, h in blocks))
    raw = b"".join(payloads)
    del payloads
    blob = np.frombuffer(raw, np.uint8)
    if raw[:4] != b"BAM\x01":
        raise ValueError("no BAM magic")
    l_text = struct.unpack_from("<i", raw, 4)[0]
    text = raw[8:8 + l_text].split(b"\0", 1)[0].decode()
    p = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, p)[0]
    p += 4
    refs = []
    for _ in range(n_ref):
        ln = struct.unpack_from("<i", raw, p)[0]
        name = raw[p + 4: p + 4 + ln].rstrip(b"\0").decode()
        refs.append((name, struct.unpack_from("<i", raw, p + 4 + ln)[0]))
        p += 8 + ln
    start = record_chain(raw, p)
    ends = np.append(start[1:], len(blob)) if len(start) else start
    dec = Decoded(cstart=cstart, ustart=ustart, usize=usize,
                  payload_bytes=payload, raw=raw, blob=blob,
                  header_text=text,
                  refs=refs, start=start, end=ends)
    if len(start):
        pre = _flat(blob, start, np.full(len(start), 36)).view(PREFIX)
        for k in PREFIX.names:
            dec.fixed[k] = pre[k].copy()
        if (dec.fixed["bs"].astype(np.int64) + 4 != ends - start).any():
            raise ValueError("block sizes disagree with the record chain")
    return dec


def decode_path(path: str) -> Decoded:
    with open(path, "rb") as f:
        return decode_file(f.read())
