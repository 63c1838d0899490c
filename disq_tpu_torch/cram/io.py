"""CRAM low-level IO: ITF8 / LTF8 varints and byte cursors.

Replaces htsjdk's ``ITF8``/``LTF8``/``CramInt`` utilities (the CRAM 3.0
spec §2.3 integer encodings used throughout container/block headers).

ITF8: up to 5 bytes; the number of leading 1-bits in the first byte
(before the first 0) gives the count of additional bytes. LTF8: same
scheme for 64-bit values, up to 9 bytes.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np


def write_itf8(value: int) -> bytes:
    v = value & 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([
            0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF
        ])
    return bytes([
        0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
        (v >> 4) & 0xFF, v & 0x0F,
    ])


def write_itf8_array(vals) -> bytes:
    """Vectorized ITF8 encode of a whole value array — the encode-side
    mirror of the decode table (CRAM writers emit one varint per record
    per fixed series; per-value ``write_itf8`` was the hottest part of
    container encode). Byte-identical to ``write_itf8`` per value."""
    v = (np.asarray(vals, np.int64) & 0xFFFFFFFF).astype(np.uint32)
    n = len(v)
    if n == 0:
        return b""
    nb = np.full(n, 5, np.int64)
    nb[v < 0x10000000] = 4
    nb[v < 0x200000] = 3
    nb[v < 0x4000] = 2
    nb[v < 0x80] = 1
    off = np.zeros(n + 1, np.int64)
    np.cumsum(nb, out=off[1:])
    out = np.zeros(int(off[-1]), np.uint8)
    idx = off[:-1]
    m = nb == 1
    out[idx[m]] = v[m]
    m = nb == 2
    out[idx[m]] = 0x80 | (v[m] >> 8)
    out[idx[m] + 1] = v[m] & 0xFF
    m = nb == 3
    out[idx[m]] = 0xC0 | (v[m] >> 16)
    out[idx[m] + 1] = (v[m] >> 8) & 0xFF
    out[idx[m] + 2] = v[m] & 0xFF
    m = nb == 4
    out[idx[m]] = 0xE0 | (v[m] >> 24)
    out[idx[m] + 1] = (v[m] >> 16) & 0xFF
    out[idx[m] + 2] = (v[m] >> 8) & 0xFF
    out[idx[m] + 3] = v[m] & 0xFF
    m = nb == 5
    out[idx[m]] = 0xF0 | ((v[m] >> 28) & 0x0F)
    out[idx[m] + 1] = (v[m] >> 20) & 0xFF
    out[idx[m] + 2] = (v[m] >> 12) & 0xFF
    out[idx[m] + 3] = (v[m] >> 4) & 0xFF
    out[idx[m] + 4] = v[m] & 0x0F
    return out.tobytes()


def read_itf8(data, offset: int) -> Tuple[int, int]:
    """→ (value as signed int32, new offset)."""
    b0 = data[offset]
    if b0 < 0x80:
        v, off = b0, offset + 1
    elif b0 < 0xC0:
        v = ((b0 & 0x7F) << 8) | data[offset + 1]
        off = offset + 2
    elif b0 < 0xE0:
        v = ((b0 & 0x3F) << 16) | (data[offset + 1] << 8) | data[offset + 2]
        off = offset + 3
    elif b0 < 0xF0:
        v = (
            ((b0 & 0x1F) << 24) | (data[offset + 1] << 16)
            | (data[offset + 2] << 8) | data[offset + 3]
        )
        off = offset + 4
    else:
        v = (
            ((b0 & 0x0F) << 28) | (data[offset + 1] << 20)
            | (data[offset + 2] << 12) | (data[offset + 3] << 4)
            | (data[offset + 4] & 0x0F)
        )
        off = offset + 5
    if v >= 1 << 31:
        v -= 1 << 32
    return v, off


def write_ltf8(value: int) -> bytes:
    v = value & 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        return bytes([v])
    for extra in range(1, 8):
        # `extra` additional bytes carry 8*extra bits; the first byte
        # (extra leading ones, then 0) carries 7-extra more.
        if v < 1 << (7 + 7 * extra):
            lead = (0xFF << (8 - extra)) & 0xFF
            first = lead | (v >> (8 * extra))
            rest = [(v >> (8 * (extra - 1 - k))) & 0xFF for k in range(extra)]
            return bytes([first] + rest)
    return bytes([0xFF]) + struct.pack(">Q", v)


def read_ltf8(data, offset: int) -> Tuple[int, int]:
    b0 = data[offset]
    # count leading ones
    ones = 0
    while ones < 8 and (b0 << ones) & 0x80:
        ones += 1
    if ones == 0:
        v, off = b0, offset + 1
    elif ones == 8:
        (v,) = struct.unpack_from(">Q", bytes(data[offset + 1: offset + 9]), 0)
        off = offset + 9
    else:
        v = b0 & (0x7F >> ones)
        for k in range(ones):
            v = (v << 8) | data[offset + 1 + k]
        off = offset + 1 + ones
    if v >= 1 << 63:
        v -= 1 << 64
    return v, off


def itf8_table(data) -> Tuple[np.ndarray, np.ndarray]:
    """The ITF8 value (int32) and byte length (uint8) of a value that
    would start at each byte of ``data``."""
    # uint32 arithmetic wraps exactly like the scalar reader's masked
    # shifts; .view(int32) restores the signed contract
    a = np.frombuffer(data, np.uint8).astype(np.uint32)
    n = len(a)
    p = np.concatenate([a, np.zeros(4, np.uint32)])
    b0 = p[:n]
    b1, b2, b3, b4 = p[1:n + 1], p[2:n + 2], p[3:n + 3], p[4:n + 4]
    conds = [b0 < 0x80, b0 < 0xC0, b0 < 0xE0, b0 < 0xF0]
    v = np.select(conds, [
        b0,
        ((b0 & 0x7F) << 8) | b1,
        ((b0 & 0x3F) << 16) | (b1 << 8) | b2,
        ((b0 & 0x1F) << 24) | (b1 << 16) | (b2 << 8) | b3,
    ], ((b0 & 0x0F) << 28) | (b1 << 20) | (b2 << 12) | (b3 << 4)
       | (b4 & 0x0F))
    return v.view(np.int32), np.select(conds, [1, 2, 3, 4], 5).astype(
        np.uint8)


class Cursor:
    """Sequential reader over a bytes-like object.

    Streams that pull many ITF8 values (CRAM data-series external
    blocks read roughly one varint per record per series) opt in with
    ``itf8_table=True`` and switch to a vectorized
    decode-at-every-offset table after ``_ITF8_TABLE_AFTER`` scalar
    reads: one numpy pass precomputes (value, length) for all byte
    positions and each subsequent ``itf8()`` is two array indexes.
    Header cursors (a handful of varints over a whole-container buffer,
    where the O(len) build could never amortize) stay scalar."""

    _ITF8_TABLE_AFTER = 16

    def __init__(self, data, offset: int = 0, itf8_table: bool = False):
        self.data = data
        self.off = offset
        self._v = None
        self._nb = None
        self._ni = 0 if itf8_table else -(1 << 60)

    def _build_itf8_table(self) -> None:
        self._v, self._nb = itf8_table(self.data)

    def itf8(self) -> int:
        v = self._v
        if v is not None:
            o = self.off
            nb_arr = self._nb
            if o >= len(v):
                raise IndexError("ITF8 read past end of stream")
            nb = int(nb_arr[o])
            if o + nb > len(v):
                # varint truncated at the stream end: the table decoded
                # against zero padding — raise like the scalar reader
                raise IndexError("truncated ITF8 at end of stream")
            self.off = o + nb
            return int(v[o])
        self._ni += 1
        if self._ni >= self._ITF8_TABLE_AFTER:
            self._build_itf8_table()
        v, self.off = read_itf8(self.data, self.off)
        return v

    def itf8_bulk(self, count: int) -> List[int]:
        """``count`` sequential ITF8 values in one fused walk over the
        decode table (the CRAM columnar fast path pulls whole
        per-series value streams with this). Raises IndexError past the
        stream end, like ``itf8``."""
        if count <= 0:
            return []
        if self._v is None:
            self._build_itf8_table()
        # the walk touches most of the stream, so list conversion
        # amortizes and python-list indexing beats numpy scalar reads
        vl = self._v.tolist()
        nbl = self._nb.tolist()
        ln = len(vl)
        off = self.off
        out = []
        ap = out.append
        for _ in range(count):
            if off >= ln:
                raise IndexError("ITF8 read past end of stream")
            w = nbl[off]
            if off + w > ln:
                raise IndexError("truncated ITF8 at end of stream")
            ap(vl[off])
            off += w
        self.off = off
        return out

    def len_prefixed_bulk(self, count: int) -> List[bytes]:
        """``count`` (ITF8 length, payload bytes) items from an
        interleaved stream (the layout CRAM BYTE_ARRAY_LEN uses when
        length and value share one block — e.g. tag value series).
        Raises IndexError past the stream end."""
        if count <= 0:
            return []
        if self._v is None:
            self._build_itf8_table()
        vl, nbl = self._v, self._nb
        ln_total = len(vl)
        data = self.data
        off = self.off
        out = []
        ap = out.append
        for _ in range(count):
            if off >= ln_total:
                raise IndexError("read past end of stream")
            w = int(nbl[off])
            if off + w > ln_total:
                raise IndexError("truncated ITF8 at end of stream")
            ln = int(vl[off])
            off += w
            if ln < 0 or off + ln > ln_total:
                raise IndexError("length-prefixed item overruns stream")
            ap(bytes(data[off: off + ln]))
            off += ln
        self.off = off
        return out

    def ltf8(self) -> int:
        v, self.off = read_ltf8(self.data, self.off)
        return v

    def bytes(self, n: int) -> bytes:
        b = bytes(self.data[self.off: self.off + n])
        if len(b) != n:
            raise ValueError("truncated CRAM stream")
        self.off += n
        return b

    def u8(self) -> int:
        v = self.data[self.off]
        self.off += 1
        return v

    def i32(self) -> int:
        (v,) = struct.unpack_from("<i", self.data, self.off)
        self.off += 4
        return v

    def itf8_array(self) -> List[int]:
        n = self.itf8()
        return [self.itf8() for _ in range(n)]
