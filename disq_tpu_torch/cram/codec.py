"""CRAM 3.0 record codec: columnar ``ReadBatch`` ⇄ slice data series.

Replaces htsjdk's ``CramCompressionRecord`` + ``Cram(Record)Codec`` +
``CramNormalizer`` stack (SURVEY.md §2.5, §2.8). Profile implemented:

- write side emits every data series EXTERNAL (ITF8 ints / bytes in
  per-series blocks) by default — a legal CRAM 3.0 layout — or, with
  ``DISQ_TPU_TORCH_CRAM_CORE``, routes CF/MQ/FN through CORE-block bit codecs
  (canonical Huffman / BETA / GAMMA). The read side understands the
  CORE bit codecs foreign htsjdk/samtools CRAMs use — full canonical
  HUFFMAN, BETA, GAMMA and SUBEXP — plus BYTE_ARRAY_STOP and
  BYTE_ARRAY_LEN, and rejects anything else with a clear error;
- write side emits single-reference slices (ref runs split into
  slices), detached mate info, absolute AP; the READ side additionally
  handles foreign shapes: multi-reference slices (refid -2 with a
  per-record RI series) and AP-delta coding;
- sequence via read features: M-runs that match the reference are
  *omitted* (reference-based compression — requires the reference at
  read time, like the reference's ``CRAMReferenceSource``); mismatching
  or reference-less M-runs are embedded verbatim as 'b' (BB) features;
  I/S/D/N/H/P CIGAR ops map to their feature codes. ``=``/``X`` ops
  canonicalize to ``M`` (inherent to CRAM's feature model; htsjdk does
  the same);
- qualities always stored (CF quality-scores-stored), names preserved
  (RN preservation), tags via the TD tag-line dictionary with per-tag
  EXTERNAL value series.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from disq_tpu_torch.bam.columnar import _NT16_CHARS, ReadBatch, SEQ_NT16
from disq_tpu_torch.cram.io import Cursor, write_itf8, write_itf8_array
from disq_tpu_torch.index.bai import bins_from_cigars
from disq_tpu_torch.runtime.debug import env_flag
from disq_tpu_torch.runtime.errors import MissingReferenceError

# Encoding codec ids (CRAM 3.0 §12)
E_EXTERNAL = 1
E_HUFFMAN = 3
E_BYTE_ARRAY_LEN = 4
E_BYTE_ARRAY_STOP = 5
E_BETA = 6
E_SUBEXP = 7
E_GAMMA = 9

# CF compression bit flags
CF_QS_STORED = 0x1
CF_DETACHED = 0x2
CF_HAS_MATE_DOWNSTREAM = 0x4
CF_UNKNOWN_BASES = 0x8

# External block content ids, one per data series we emit.
SERIES = [
    "BF", "CF", "RL", "AP", "RG", "RN", "MF", "NS", "NP", "TS", "TL",
    "MQ", "QS", "FN", "FC", "FP", "BB_LEN", "BB_VAL", "IN", "SC", "DL",
    "RS", "HC", "PD",
    "RI",   # per-record reference id — multi-ref (refid -2) slices
]
CID = {name: i + 1 for i, name in enumerate(SERIES)}
TAG_CID_BASE = 0x10000  # tag series ids live above the fixed series

_CHAR_TO_NT16 = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(SEQ_NT16):
    _CHAR_TO_NT16[ord(_c)] = _i
    _CHAR_TO_NT16[ord(_c.lower())] = _i


def _tag_key(tag2: bytes, typ: int) -> int:
    return (tag2[0] << 16) | (tag2[1] << 8) | typ


def split_tags(tags: bytes) -> List[Tuple[int, bytes]]:
    """Binary BAM tag block → [(key3, value_bytes)] (key = tag chars +
    type byte; value = the BAM-serialized value without the prefix)."""
    out = []
    p, n = 0, len(tags)
    while p < n:
        key = _tag_key(tags[p:p + 2], tags[p + 2])
        typ = chr(tags[p + 2])
        p += 3
        start = p
        if typ == "A" or typ in "cC":
            p += 1
        elif typ in "sS":
            p += 2
        elif typ in "iIf":
            p += 4
        elif typ in "ZH":
            p = tags.index(b"\x00", p) + 1
        elif typ == "B":
            sub = chr(tags[p])
            (cnt,) = struct.unpack_from("<I", tags, p + 1)
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            p += 5 + cnt * size
        else:
            raise ValueError(f"unknown tag type {typ!r}")
        out.append((key, tags[start:p]))
    return out


def join_tags(entries: List[Tuple[int, bytes]]) -> bytes:
    out = bytearray()
    for key, val in entries:
        out += bytes([(key >> 16) & 0xFF, (key >> 8) & 0xFF, key & 0xFF])
        out += val
    return bytes(out)


# -- encodings in the compression header ------------------------------------

def _enc_external(cid: int) -> bytes:
    params = write_itf8(cid)
    return write_itf8(E_EXTERNAL) + write_itf8(len(params)) + params


def _enc_byte_array_stop(stop: int, cid: int) -> bytes:
    params = bytes([stop]) + write_itf8(cid)
    return write_itf8(E_BYTE_ARRAY_STOP) + write_itf8(len(params)) + params


def _enc_byte_array_len(len_cid: int, val_cid: int) -> bytes:
    len_enc = _enc_external(len_cid)
    val_enc = _enc_external(val_cid)
    params = len_enc + val_enc
    return write_itf8(E_BYTE_ARRAY_LEN) + write_itf8(len(params)) + params


@dataclass
class Encoding:
    codec: int
    # EXTERNAL: cid; BYTE_ARRAY_STOP: (stop, cid);
    # BYTE_ARRAY_LEN: (len Encoding, val Encoding)
    params: object

    @classmethod
    def parse(cls, cur: Cursor) -> "Encoding":
        codec = cur.itf8()
        plen = cur.itf8()
        sub = Cursor(cur.bytes(plen))
        if codec == E_EXTERNAL:
            return cls(codec, sub.itf8())
        if codec == E_BYTE_ARRAY_STOP:
            stop = sub.u8()
            return cls(codec, (stop, sub.itf8()))
        if codec == E_BYTE_ARRAY_LEN:
            len_enc = Encoding.parse(sub)
            val_enc = Encoding.parse(sub)
            return cls(codec, (len_enc, val_enc))
        if codec == E_HUFFMAN:
            n = sub.itf8()
            syms = [sub.itf8() for _ in range(n)]
            m = sub.itf8()
            lens = [sub.itf8() for _ in range(m)]
            return cls(codec, (syms, lens))
        if codec == E_BETA:
            return cls(codec, (sub.itf8(), sub.itf8()))  # offset, nbits
        if codec == E_SUBEXP:
            return cls(codec, (sub.itf8(), sub.itf8()))  # offset, k
        if codec == E_GAMMA:
            return cls(codec, sub.itf8())                # offset
        return cls(codec, None)


class BitCursor:
    """MSB-first bit reader over the CORE block (CRAM 3.0 §2:
    "bit stream ... packed MSB first")."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def bit(self) -> int:
        b = (self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v


class BitWriter:
    """MSB-first bit writer (encode-side core block)."""

    def __init__(self) -> None:
        self.out = bytearray()
        self._acc = 0
        self._nb = 0

    def write(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self._acc = (self._acc << 1) | ((value >> i) & 1)
            self._nb += 1
            if self._nb == 8:
                self.out.append(self._acc)
                self._acc = 0
                self._nb = 0

    def flush(self) -> bytes:
        if self._nb:
            self.out.append(self._acc << (8 - self._nb))
            self._acc = 0
            self._nb = 0
        return bytes(self.out)


def huffman_code_lengths(freqs: Dict[int, int]) -> Dict[int, int]:
    """Package-free Huffman code lengths (heap merge) for the observed
    symbols; single-symbol alphabets get the zero-bit constant code."""
    import heapq

    if len(freqs) == 1:
        return {next(iter(freqs)): 0}
    heap = [(f, i, (s,)) for i, (s, f) in enumerate(sorted(freqs.items()))]
    heapq.heapify(heap)
    depth: Dict[int, int] = {s: 0 for s in freqs}
    tick = len(heap)
    while len(heap) > 1:
        fa, _, sa = heapq.heappop(heap)
        fb, _, sb = heapq.heappop(heap)
        for s in sa + sb:
            depth[s] += 1
        heapq.heappush(heap, (fa + fb, tick, sa + sb))
        tick += 1
    return depth


def canonical_assign(syms, lens) -> Dict[int, Tuple[int, int]]:
    """Canonical code assignment ordered by (length, value) — the
    htsjdk CanonicalHuffmanIntegerCodec convention. Returns
    sym -> (code, len)."""
    pairs = sorted(zip(lens, syms))
    codes: Dict[int, Tuple[int, int]] = {}
    code = 0
    prev_len = 0
    for ln, s in pairs:
        code <<= (ln - prev_len)
        codes[s] = (code, ln)
        code += 1
        prev_len = ln
    return codes


def _gamma_write(bw: BitWriter, value: int, offset: int) -> None:
    v = value + offset
    assert v >= 1, "gamma codes require value + offset >= 1"
    nb = v.bit_length() - 1
    bw.write(0, nb)
    bw.write(v, nb + 1)


def _gamma_read(bc: BitCursor, offset: int) -> int:
    z = 0
    while bc.bit() == 0:
        z += 1
    v = (1 << z) | bc.bits(z)
    return v - offset


def _subexp_write(bw: BitWriter, value: int, offset: int, k: int) -> None:
    v = value + offset
    if v < (1 << k):
        bw.write(0, 1)
        bw.write(v, k)
    else:
        b = v.bit_length() - 1
        u = b - k + 1
        bw.write((1 << u) - 1, u)
        bw.write(0, 1)
        bw.write(v & ((1 << b) - 1), b)   # top bit implicit


def _subexp_read(bc: BitCursor, offset: int, k: int) -> int:
    u = 0
    while bc.bit() == 1:
        u += 1
    if u == 0:
        v = bc.bits(k)
    else:
        b = k + u - 1
        v = (1 << b) | bc.bits(b)
    return v - offset


def _enc_raw(codec: int, params: bytes) -> bytes:
    return write_itf8(codec) + write_itf8(len(params)) + params


def enc_bytes_beta(offset: int, nbits: int) -> bytes:
    return _enc_raw(E_BETA, write_itf8(offset) + write_itf8(nbits))


def enc_bytes_gamma(offset: int) -> bytes:
    return _enc_raw(E_GAMMA, write_itf8(offset))


def enc_bytes_subexp(offset: int, k: int) -> bytes:
    return _enc_raw(E_SUBEXP, write_itf8(offset) + write_itf8(k))


def enc_bytes_huffman(syms, lens) -> bytes:
    p = write_itf8(len(syms)) + b"".join(write_itf8(s) for s in syms)
    p += write_itf8(len(lens)) + b"".join(write_itf8(x) for x in lens)
    return _enc_raw(E_HUFFMAN, p)


@dataclass
class CompressionHeader:
    rn_preserved: bool = True
    ap_delta: bool = False
    ref_required: bool = True
    tag_lines: List[List[int]] = field(default_factory=list)  # TD
    series_enc: Dict[str, Encoding] = field(default_factory=dict)
    tag_enc: Dict[int, Encoding] = field(default_factory=dict)
    # encode-side: raw encoding bytes overriding the default EXTERNAL
    # wiring for a series (core bit codecs)
    enc_overrides: Dict[str, bytes] = field(default_factory=dict)

    def to_bytes(self) -> bytes:
        # preservation map
        td_blob = bytearray()
        for line in self.tag_lines:
            for key in line:
                td_blob += bytes([(key >> 16) & 0xFF, (key >> 8) & 0xFF, key & 0xFF])
            td_blob.append(0)
        pres_entries = [
            (b"RN", bytes([1 if self.rn_preserved else 0])),
            (b"AP", bytes([1 if self.ap_delta else 0])),
            (b"RR", bytes([1 if self.ref_required else 0])),
            (b"TD", write_itf8(len(td_blob)) + bytes(td_blob)),
        ]
        pres = write_itf8(len(pres_entries)) + b"".join(
            k + v for k, v in pres_entries
        )
        pres = write_itf8(len(pres)) + pres

        # data series encodings (all EXTERNAL except byte-array series)
        entries = []
        for name in SERIES:
            # BB_* fold into the BB byte-array encoding; RI is read-only
            # support (our writer emits single-ref slices, so declaring
            # an RI series with no backing block would be a dangling
            # ref) unless a multi-ref builder overrides it explicitly
            if name in ("BB_LEN", "BB_VAL") or (
                    name == "RI" and "RI" not in self.enc_overrides):
                continue
            if name in self.enc_overrides:
                enc = self.enc_overrides[name]
            elif name == "RN":
                enc = _enc_byte_array_stop(0, CID["RN"])
            elif name in ("IN", "SC"):
                enc = _enc_byte_array_stop(0, CID[name])
            else:
                enc = _enc_external(CID[name])
            entries.append((name.encode(), enc))
        entries.append((b"BB", _enc_byte_array_len(CID["BB_LEN"], CID["BB_VAL"])))
        dse = write_itf8(len(entries)) + b"".join(k + v for k, v in entries)
        dse = write_itf8(len(dse)) + dse

        # tag encodings
        tag_keys = sorted({k for line in self.tag_lines for k in line})
        tentries = []
        for key in tag_keys:
            cid = TAG_CID_BASE + key
            tentries.append(
                (write_itf8(key), _enc_byte_array_len(cid, cid))
            )
        tenc = write_itf8(len(tentries)) + b"".join(k + v for k, v in tentries)
        tenc = write_itf8(len(tenc)) + tenc
        return bytes(pres + dse + tenc)

    @classmethod
    def parse(cls, data: bytes) -> "CompressionHeader":
        cur = Cursor(data)
        out = cls(tag_lines=[])
        # preservation map
        cur.itf8()  # size in bytes
        n = cur.itf8()
        for _ in range(n):
            key = cur.bytes(2)
            if key in (b"RN", b"AP", b"RR"):
                v = cur.u8() != 0
                if key == b"RN":
                    out.rn_preserved = v
                elif key == b"AP":
                    out.ap_delta = v
                else:
                    out.ref_required = v
            elif key == b"SM":
                cur.bytes(5)
            elif key == b"TD":
                blob_len = cur.itf8()
                blob = cur.bytes(blob_len)
                for line in blob.split(b"\x00")[:-1]:
                    entries = [
                        _tag_key(line[i:i + 2], line[i + 2])
                        for i in range(0, len(line), 3)
                    ]
                    out.tag_lines.append(entries)
            else:
                raise ValueError(f"unknown preservation key {key!r}")
        if not out.tag_lines:
            out.tag_lines = [[]]
        # data series encodings
        cur.itf8()
        n = cur.itf8()
        for _ in range(n):
            key = cur.bytes(2).decode()
            out.series_enc[key] = Encoding.parse(cur)
        # tag encodings
        cur.itf8()
        n = cur.itf8()
        for _ in range(n):
            key = cur.itf8()
            out.tag_enc[key] = Encoding.parse(cur)
        return out


# -- stream helpers ---------------------------------------------------------

class _Streams:
    """Per-content-id byte streams being built (encode side)."""

    def __init__(self):
        self.data: Dict[int, bytearray] = {}

    def buf(self, cid: int) -> bytearray:
        return self.data.setdefault(cid, bytearray())

    def put_itf8(self, cid: int, v: int) -> None:
        self.buf(cid).extend(write_itf8(v))

    def put_bytes(self, cid: int, b: bytes) -> None:
        self.buf(cid).extend(b)


class _Readers:
    """Per-content-id cursors + CORE bit cursor (decode side)."""

    def __init__(self, blocks: Dict[int, bytes], core: bytes = b""):
        self.cur = {
            cid: Cursor(data, itf8_table=True)
            for cid, data in blocks.items()
        }
        self.core = BitCursor(core or b"")
        self._huff_cache: Dict[int, object] = {}

    def _huffman(self, enc: Encoding):
        key = id(enc)
        tbl = self._huff_cache.get(key)
        if tbl is None:
            syms, lens = enc.params
            codes = canonical_assign(syms, lens)
            # decode walk tables: (len -> first code, offset) + sorted syms
            by = sorted((ln, c, s) for s, (c, ln) in codes.items())
            tbl = by
            self._huff_cache[key] = tbl
        return tbl

    def _c(self, cid: int) -> Cursor:
        try:
            return self.cur[cid]
        except KeyError:
            raise ValueError(f"missing external block {cid}") from None

    def read_int(self, enc: Encoding) -> int:
        if enc.codec == E_EXTERNAL:
            return self._c(enc.params).itf8()
        if enc.codec == E_HUFFMAN:
            if len(enc.params[0]) == 1:
                return enc.params[0][0]  # zero-bit constant (htsjdk idiom)
            return self._read_huffman(enc)
        if enc.codec == E_BETA:
            offset, nbits = enc.params
            return self.core.bits(nbits) - offset
        if enc.codec == E_GAMMA:
            return _gamma_read(self.core, enc.params)
        if enc.codec == E_SUBEXP:
            offset, k = enc.params
            return _subexp_read(self.core, offset, k)
        raise ValueError(f"unsupported int encoding codec {enc.codec}")

    def _read_huffman(self, enc: Encoding) -> int:
        by = self._huffman(enc)   # sorted (len, code, sym)
        code = 0
        ln = 0
        i = 0
        while i < len(by):
            want_len = by[i][0]
            code = (code << (want_len - ln)) | self.core.bits(want_len - ln)
            ln = want_len
            while i < len(by) and by[i][0] == ln:
                if by[i][1] == code:
                    return by[i][2]
                i += 1
        raise ValueError("invalid canonical Huffman code in CORE stream")

    def read_byte(self, enc: Encoding) -> int:
        if enc.codec == E_EXTERNAL:
            return self._c(enc.params).u8()
        if enc.codec in (E_HUFFMAN, E_BETA, E_GAMMA, E_SUBEXP):
            return self.read_int(enc)
        raise ValueError(f"unsupported byte encoding codec {enc.codec}")

    def read_bytes_len(self, enc: Encoding, n: int) -> bytes:
        if enc.codec == E_EXTERNAL:
            return self._c(enc.params).bytes(n)
        raise ValueError(f"unsupported byte-array encoding codec {enc.codec}")

    def read_array(self, enc: Encoding) -> bytes:
        if enc.codec == E_BYTE_ARRAY_STOP:
            stop, cid = enc.params
            c = self._c(cid)
            data = c.data
            try:
                end = data.index(stop, c.off)   # C-speed scan
            except AttributeError:              # memoryview has no index
                end = c.off
                while data[end] != stop:
                    end += 1
            out = bytes(data[c.off:end])
            c.off = end + 1
            return out
        if enc.codec == E_BYTE_ARRAY_LEN:
            len_enc, val_enc = enc.params
            n = self.read_int(len_enc)
            return self.read_bytes_len(val_enc, n)
        raise ValueError(f"unsupported array encoding codec {enc.codec}")


# -- slice/container encode -------------------------------------------------

def _seq_chars(batch: ReadBatch, i: int) -> np.ndarray:
    s, e = batch.seq_offsets[i], batch.seq_offsets[i + 1]
    return _NT16_CHARS[batch.seqs[s:e]]


def _qs_order1() -> bool:
    # order-1 QS (the htslib default, typically 10-20% smaller) is the
    # default; the native encoder is byte-identical to the Python
    # fallback, so output bytes don't depend on whether the native
    # library is built. DISQ_TPU_TORCH_CRAM_RANS_O1=0 writes QS as
    # order-0 rANS instead.
    return env_flag("DISQ_TPU_TORCH_CRAM_RANS_O1", default="1")


def encode_container(
    batch: ReadBatch,
    refid: int,
    record_counter: int,
    ref_fetch=None,
    core_profile: Optional[bool] = None,
) -> Tuple[bytes, dict]:
    """Encode one single-ref slice (all records share ``refid``) into a
    complete container. ``ref_fetch(refid, start0, length) -> bytes``
    enables reference-based M-run omission. Returns (container bytes,
    crai entry info dict).

    ``core_profile`` (default: the ``DISQ_TPU_TORCH_CRAM_CORE`` env flag)
    routes CF through a canonical core Huffman code, MQ through
    BETA(0,8) and FN through GAMMA(1) — the CORE-block bit codecs
    foreign htsjdk/samtools CRAMs use, exercised end-to-end."""
    from disq_tpu_torch.cram.structure import (
        Block, COMPRESSION_HEADER, CORE, ContainerHeader, EXTERNAL,
        GZIP, MAPPED_SLICE, RANS, RAW, SliceHeader,
    )

    if core_profile is None:
        core_profile = env_flag("DISQ_TPU_TORCH_CRAM_CORE")
    n = batch.count
    # The bulk QS/RN encoders below trust the batch's flat arrays to be
    # exactly tiled by their offsets (QS copies ``batch.quals`` whole;
    # RN inserts NULs at ``name_offsets[1:]``). A batch whose flat
    # arrays carry slack — offsets not starting at 0, or ending before
    # the array does — would silently emit wrong bytes; fail loudly
    # instead.
    if n:
        so, no_ = batch.seq_offsets, batch.name_offsets
        if int(so[0]) != 0 or int(so[-1]) != len(batch.seqs) \
                or len(batch.quals) != len(batch.seqs):
            raise ValueError(
                "encode_container: seq_offsets must tile the flat "
                f"seq/qual arrays exactly (offsets [{int(so[0])}, "
                f"{int(so[-1])}], len(seqs)={len(batch.seqs)}, "
                f"len(quals)={len(batch.quals)})"
            )
        if int(no_[0]) != 0 or int(no_[-1]) != len(batch.names):
            raise ValueError(
                "encode_container: name_offsets must tile the flat "
                f"names array exactly (offsets [{int(no_[0])}, "
                f"{int(no_[-1])}], len(names)={len(batch.names)})"
            )
    streams = _Streams()
    bw = BitWriter()
    cf_codes = None
    # one CF formula for both the huffman pre-pass and the encode loop
    seq_lens = np.diff(batch.seq_offsets)
    cf_vals = (CF_QS_STORED | CF_DETACHED
               | np.where(seq_lens == 0, CF_UNKNOWN_BASES, 0)).astype(int)
    if core_profile:
        freq: Dict[int, int] = {}
        for v in cf_vals.tolist():
            freq[v] = freq.get(v, 0) + 1
        lens_map = huffman_code_lengths(freq) if freq else {}
        cf_syms = sorted(lens_map)
        cf_lens = [lens_map[s] for s in cf_syms]
        cf_codes = canonical_assign(cf_syms, cf_lens)
    tag_line_index: Dict[tuple, int] = {}
    tag_lines: List[List[int]] = []
    tl_vals: List[int] = []
    fn_vals: List[int] = []
    total_bases = 0
    any_ref_omitted = False

    ends = batch.alignment_ends()
    for i in range(n):
        l_seq = int(batch.seq_offsets[i + 1] - batch.seq_offsets[i])
        cig_s, cig_e = batch.cigar_offsets[i], batch.cigar_offsets[i + 1]
        cigar = batch.cigars[cig_s:cig_e]
        if l_seq == 0 and len(cigar) > 0:
            raise ValueError(
                "CRAM profile limitation: record with CIGAR but no "
                "sequence bases is not representable via read features"
            )
        cf = int(cf_vals[i])
        # fixed one-value-per-record series (BF/CF/RL/AP/RG/RN/MF/NS/
        # NP/TS/MQ/QS) are bulk-encoded after the loop — per-cid stream
        # order is record order either way, and the vectorized ITF8
        # array encoder replaces ~12 put_itf8 calls per record
        if cf_codes is not None:
            code, nb = cf_codes[cf]
            bw.write(code, nb)
        # tags
        entries = split_tags(
            batch.tags[batch.tag_offsets[i]:batch.tag_offsets[i + 1]].tobytes()
        )
        line = tuple(k for k, _ in entries)
        tl = tag_line_index.get(line)
        if tl is None:
            tl = tag_line_index[line] = len(tag_lines)
            tag_lines.append(list(line))
        tl_vals.append(tl)
        for key, val in entries:
            cid = TAG_CID_BASE + key
            streams.put_itf8(cid, len(val))
            streams.put_bytes(cid, val)
        total_bases += l_seq

        # read features from CIGAR + seq (vs reference)
        seq = _seq_chars(batch, i)
        features: List[Tuple[int, str, object]] = []  # (read_pos1, code, payload)
        rp = 1                      # 1-based read position
        ref_pos = int(batch.pos[i])  # 0-based ref position
        for op_word in cigar:
            op = int(op_word) & 0xF
            ln = int(op_word) >> 4
            code = "MIDNSHP=XB"[op] if op < 9 else "?"
            if code in ("M", "=", "X"):
                run = seq[rp - 1: rp - 1 + ln]
                omit = False
                if ref_fetch is not None and refid >= 0:
                    ref_run = ref_fetch(refid, ref_pos, ln)
                    if (
                        ref_run is not None
                        and len(ref_run) == ln
                        and np.array_equal(
                            np.frombuffer(ref_run.upper(), np.uint8), run
                        )
                    ):
                        omit = True
                if not omit:
                    features.append((rp, "b", run.tobytes()))
                else:
                    any_ref_omitted = True
                rp += ln
                ref_pos += ln
            elif code == "I":
                features.append((rp, "I", seq[rp - 1: rp - 1 + ln].tobytes()))
                rp += ln
            elif code == "S":
                features.append((rp, "S", seq[rp - 1: rp - 1 + ln].tobytes()))
                rp += ln
            elif code == "D":
                features.append((rp, "D", ln))
                ref_pos += ln
            elif code == "N":
                features.append((rp, "N", ln))
                ref_pos += ln
            elif code == "H":
                features.append((rp, "H", ln))
            elif code == "P":
                features.append((rp, "P", ln))
            else:
                raise ValueError(f"unsupported CIGAR op {code!r} for CRAM")
        if rp - 1 < l_seq:
            # Bases not covered by CIGAR (typically unmapped records with
            # no CIGAR at all): embed them verbatim.
            features.append((rp, "b", seq[rp - 1:].tobytes()))
        if core_profile:
            _gamma_write(bw, len(features), 1)   # GAMMA(offset=1)
        else:
            fn_vals.append(len(features))
        prev = 0
        for fpos, code, payload in features:
            streams.put_bytes(CID["FC"], code.encode())
            streams.put_itf8(CID["FP"], fpos - prev)
            prev = fpos
            if code == "b":
                streams.put_itf8(CID["BB_LEN"], len(payload))
                streams.put_bytes(CID["BB_VAL"], payload)
            elif code in ("I", "S"):
                streams.put_bytes(CID[{"I": "IN", "S": "SC"}[code]], payload + b"\x00")
            elif code == "D":
                streams.put_itf8(CID["DL"], payload)
            elif code == "N":
                streams.put_itf8(CID["RS"], payload)
            elif code == "H":
                streams.put_itf8(CID["HC"], payload)
            elif code == "P":
                streams.put_itf8(CID["PD"], payload)
        # MQ + QS come AFTER the read-feature list (CRAM 3.0 record
        # layout; htsjdk CramRecordReader) — load-bearing once any of
        # these series shares the CORE bit stream
        if core_profile:
            bw.write(int(batch.mapq[i]), 8)      # BETA(0, 8)

    if n:
        # bulk-encoded fixed series (see the loop comment): one
        # vectorized ITF8 pass per series instead of per-record varints
        flags64 = batch.flag.astype(np.int64)
        streams.put_bytes(CID["BF"], write_itf8_array(flags64))
        if cf_codes is None:
            streams.put_bytes(CID["CF"], write_itf8_array(cf_vals))
        streams.put_bytes(CID["RL"], write_itf8_array(seq_lens))
        streams.put_bytes(
            CID["AP"], write_itf8_array(batch.pos.astype(np.int64) + 1))
        streams.put_bytes(CID["RG"], write_itf8(-1) * n)  # constant series
        # RN: a NUL terminator after every name, in one insert
        rn = np.insert(
            batch.names,
            np.asarray(batch.name_offsets[1:], dtype=np.int64), 0)
        streams.put_bytes(CID["RN"], rn.tobytes())
        mf_vals = ((flags64 >> 5) & 1) | (((flags64 >> 3) & 1) << 1)
        streams.put_bytes(CID["MF"], write_itf8_array(mf_vals))
        streams.put_bytes(
            CID["NS"], write_itf8_array(batch.next_refid.astype(np.int64)))
        streams.put_bytes(
            CID["NP"],
            write_itf8_array(batch.next_pos.astype(np.int64) + 1))
        streams.put_bytes(
            CID["TS"], write_itf8_array(batch.tlen.astype(np.int64)))
        streams.put_bytes(CID["TL"], write_itf8_array(tl_vals))
        if not core_profile:
            streams.put_bytes(CID["FN"], write_itf8_array(fn_vals))
            streams.put_bytes(
                CID["MQ"], write_itf8_array(batch.mapq.astype(np.int64)))
        # QS: quals are contiguous in record order already
        streams.put_bytes(CID["QS"], np.ascontiguousarray(
            batch.quals).tobytes())

    comp_header = CompressionHeader(
        rn_preserved=True, ap_delta=False,
        ref_required=any_ref_omitted, tag_lines=tag_lines or [[]],
    )
    if core_profile:
        comp_header.enc_overrides["CF"] = enc_bytes_huffman(
            cf_syms, cf_lens)
        comp_header.enc_overrides["MQ"] = enc_bytes_beta(0, 8)
        comp_header.enc_overrides["FN"] = enc_bytes_gamma(1)
    ch_block = Block(COMPRESSION_HEADER, 0, comp_header.to_bytes(), GZIP)

    # slice bounds
    if refid >= 0 and n:
        starts = batch.pos.astype(np.int64)
        ref_start = int(starts.min()) + 1
        ref_span = int(ends.max()) - int(starts.min())
    else:
        ref_start, ref_span = 0, 0

    ext_blocks = []
    content_ids = []
    for cid in sorted(streams.data):
        payload = bytes(streams.data[cid])
        method = RANS if cid == CID["QS"] else GZIP
        # QS rides order-1 rANS by default (htslib's QS choice)
        order = 1 if (cid == CID["QS"] and _qs_order1()) else 0
        ext_blocks.append(Block(EXTERNAL, cid, payload, method, order))
        content_ids.append(cid)
    core_block = Block(CORE, 0, bw.flush() if core_profile else b"", RAW)
    slice_hdr = SliceHeader(
        ref_seq_id=refid, ref_start=ref_start, ref_span=ref_span,
        n_records=n, record_counter=record_counter,
        n_blocks=1 + len(ext_blocks), content_ids=content_ids,
    )
    slice_hdr_block = Block(MAPPED_SLICE, 0, slice_hdr.to_bytes(), RAW)

    ch_bytes = ch_block.to_bytes()
    slice_bytes = (
        slice_hdr_block.to_bytes()
        + core_block.to_bytes()
        + b"".join(b.to_bytes() for b in ext_blocks)
    )
    landmarks = [len(ch_bytes)]
    blocks_bytes = ch_bytes + slice_bytes
    hdr = ContainerHeader(
        length=len(blocks_bytes), ref_seq_id=refid, ref_start=ref_start,
        ref_span=ref_span, n_records=n, record_counter=record_counter,
        bases=total_bases, n_blocks=2 + 1 + len(ext_blocks),
        landmarks=landmarks,
    )
    container = hdr.to_bytes() + blocks_bytes
    crai_info = dict(
        ref_seq_id=refid, ref_start=ref_start, ref_span=ref_span,
        slice_offset=landmarks[0], slice_size=len(slice_bytes),
    )
    return container, crai_info


# -- container decode -------------------------------------------------------

def read_stored_blocks(container_blocks: bytes):
    """Parse and CRC-check every block of one data container's block
    section, in order (``StoredBlock`` list, nothing decompressed)."""
    from disq_tpu_torch.cram.structure import StoredBlock

    cur = Cursor(container_blocks)
    out = []
    while cur.off < len(container_blocks):
        out.append(StoredBlock.read(cur))
    return out


def decode_container_records(container_blocks: bytes,
                             ref_fetch=None) -> ReadBatch:
    """Decode the block section of one data container into a
    ``ReadBatch`` on the host: ``read_stored_blocks`` (CRC-checked),
    each block decompressed, then ``records_from_blocks``."""
    blocks = [b.decompress() for b in read_stored_blocks(container_blocks)]
    return records_from_blocks(blocks, ref_fetch)


def records_from_blocks(decoded_blocks: Sequence,
                        ref_fetch=None) -> ReadBatch:
    """Decoded blocks of one data container (compression header, then
    per slice its header and ``n_blocks`` blocks) → ReadBatch."""
    from disq_tpu_torch.cram.structure import (
        COMPRESSION_HEADER, CORE, EXTERNAL, MAPPED_SLICE, SliceHeader,
    )

    it = iter(decoded_blocks)
    ch_block = next(it)
    if ch_block.content_type != COMPRESSION_HEADER:
        raise ValueError("expected compression header block")
    comp = CompressionHeader.parse(ch_block.data)
    batches = []
    for sh_block in it:
        if sh_block.content_type != MAPPED_SLICE:
            raise ValueError("expected slice header block")
        slice_hdr = SliceHeader.parse(sh_block.data)
        blocks: Dict[int, bytes] = {}
        core = None
        for _ in range(slice_hdr.n_blocks):
            b = next(it, None)
            if b is None:
                raise ValueError("truncated CRAM stream")
            if b.content_type == EXTERNAL:
                blocks[b.content_id] = b.data
            elif b.content_type == CORE:
                core = b.data
        batches.append(_decode_slice(slice_hdr, comp, blocks, core, ref_fetch))
    return ReadBatch.concat(batches)


_FIXED_SERIES = ("BF", "CF", "RL", "AP", "RG", "MF", "NS", "NP", "TS",
                 "TL", "FN", "MQ")


def _enc_cids(e: Encoding) -> List[int]:
    """External block ids an encoding reads from (nested for LEN)."""
    if e.codec == E_EXTERNAL:
        return [e.params]
    if e.codec == E_BYTE_ARRAY_STOP:
        return [e.params[1]]
    if e.codec == E_BYTE_ARRAY_LEN:
        return _enc_cids(e.params[0]) + _enc_cids(e.params[1])
    return []


def _external_cids_excluding(comp, enc, exclude) -> List[int]:
    """External block ids consumed by every encoding EXCEPT the named
    series — the exclusivity scan both bulk fast paths share."""
    used: List[int] = []
    for k, e in enc.items():
        if k not in exclude:
            used += _enc_cids(e)
    for e in comp.tag_enc.values():
        used += _enc_cids(e)
    return used


def _bulk_fixed_series(rd, comp, enc, n, multi_ref):
    """Pre-decode the fixed one-value-per-record series into plain
    lists when each is EXTERNAL over its own block (shared or exotic
    layouts fall back to the per-record loop — returns None). A stream
    shorter than n values (e.g. a foreign file whose mate fields are
    not one-per-record) also falls back, so the loop path reports the
    real error."""
    fixed = _FIXED_SERIES + (("RI",) if multi_ref else ())
    if not all(s in enc and enc[s].codec == E_EXTERNAL for s in fixed):
        return None
    cids = [enc[s].params for s in fixed]
    if len(set(cids)) != len(cids):
        return None
    if set(cids) & set(_external_cids_excluding(comp, enc, set(fixed))):
        return None
    if not all(cid in rd.cur for cid in cids):
        return None
    # RG and MF are consumed-and-discarded by the loop; their blocks
    # are exclusive (checked above) and per-slice, so the fast path
    # need not walk them at all
    decoded = [s for s in fixed if s not in ("RG", "MF")]
    curs = [rd.cur[enc[s].params] for s in decoded]
    saved = [c.off for c in curs]
    try:
        return {s: c.itf8_bulk(n) for s, c in zip(decoded, curs)}
    except IndexError:
        # rewind every partially-consumed cursor so the loop path
        # re-reads from the true positions and reports the real error
        for c, o in zip(curs, saved):
            c.off = o
        return None


def _bulk_split_names(rd, comp, enc, n) -> Optional[List[bytes]]:
    """All n read names in one C-speed split when RN is a stop-byte
    array over a block no other encoding reads; None → per-record
    reads."""
    if not comp.rn_preserved:
        return None
    rne = enc.get("RN")
    if rne is None or rne.codec != E_BYTE_ARRAY_STOP:
        return None
    stop, cid = rne.params
    if cid in _external_cids_excluding(comp, enc, ("RN",)):
        return None
    c = rd.cur.get(cid)
    if c is None:
        return None
    segs = bytes(c.data[c.off:]).split(bytes([stop]))
    if len(segs) < n + 1:
        return None   # fewer names than records: loop path reports it
    segs = segs[:n]
    c.off += sum(len(s) for s in segs) + n
    return segs


def _bulk_feature_streams(rd, comp, enc, cols):
    """Pre-slice the FC byte stream and pre-decode the FP delta stream
    for all features of the slice (counts known from the bulk FN
    column), when both are EXTERNAL over exclusive blocks. Returns
    (fc_bytes, fp_deltas) or None → per-feature reads."""
    fce, fpe = enc.get("FC"), enc.get("FP")
    if (fce is None or fpe is None
            or fce.codec != E_EXTERNAL or fpe.codec != E_EXTERNAL
            or fce.params == fpe.params):
        return None
    used = _external_cids_excluding(comp, enc, ("FC", "FP"))
    if fce.params in used or fpe.params in used:
        return None
    cfc, cfp = rd.cur.get(fce.params), rd.cur.get(fpe.params)
    if cfc is None or cfp is None:
        return None
    total = int(sum(cols["FN"]))
    if len(cfc.data) - cfc.off < total:
        return None
    saved = cfp.off
    try:
        fp_all = cfp.itf8_bulk(total)
    except IndexError:
        cfp.off = saved
        return None
    fc_all = bytes(cfc.data[cfc.off: cfc.off + total])
    cfc.off += total
    return fc_all, fp_all


def _bulk_bb(rd, comp, enc, fstreams):
    """All 'b'-feature payloads of the slice (count known from the bulk
    FC stream) when BB is BYTE_ARRAY_LEN over two distinct exclusive
    EXTERNAL blocks — our writer's and the usual layout. Returns the
    payload list or None → per-feature reads."""
    if fstreams is None:
        return None
    bbe = enc.get("BB")
    if bbe is None or bbe.codec != E_BYTE_ARRAY_LEN:
        return None
    len_e, val_e = bbe.params
    if (len_e.codec != E_EXTERNAL or val_e.codec != E_EXTERNAL
            or len_e.params == val_e.params):
        return None
    used = _external_cids_excluding(comp, enc, ("BB",))
    if len_e.params in used or val_e.params in used:
        return None
    cl, cv = rd.cur.get(len_e.params), rd.cur.get(val_e.params)
    if cl is None or cv is None:
        return None
    count_b = fstreams[0].count(ord("b"))
    saved = cl.off
    try:
        lens = cl.itf8_bulk(count_b)
    except IndexError:
        cl.off = saved
        return None
    total = sum(lens)
    if any(ln < 0 for ln in lens) or len(cv.data) - cv.off < total:
        cl.off = saved
        return None
    data = cv.data
    off = cv.off
    out = []
    for ln in lens:
        out.append(bytes(data[off: off + ln]))
        off += ln
    cv.off = off
    return out


def _bulk_tags(rd, comp, enc, cols):
    """Per-tag-key value iterators for keys whose value series is the
    interleaved (length, bytes) layout over one exclusive EXTERNAL
    block — our writer's layout. Keys with any other layout simply stay
    on per-record reads."""
    from collections import Counter

    keys = {k for line in comp.tag_lines for k in line}
    if not keys:
        return {}
    counts: Dict[int, int] = {k: 0 for k in keys}
    lines = comp.tag_lines
    for tl, c_tl in Counter(cols["TL"]).items():
        for k in lines[tl]:
            counts[k] += c_tl
    # one cid-occurrence count across every encoding: a same-cid
    # BYTE_ARRAY_LEN tag contributes exactly its own 2 refs (len+val),
    # so any count above 2 means the block is shared with something
    cid_refs = Counter()
    for e2 in enc.values():
        cid_refs.update(_enc_cids(e2))
    for e2 in comp.tag_enc.values():
        cid_refs.update(_enc_cids(e2))
    out: Dict[int, object] = {}
    for k in keys:
        e = comp.tag_enc.get(k)
        if e is None or e.codec != E_BYTE_ARRAY_LEN:
            continue
        len_e, val_e = e.params
        if (len_e.codec != E_EXTERNAL or val_e.codec != E_EXTERNAL
                or len_e.params != val_e.params):
            continue
        cid = len_e.params
        if cid_refs[cid] != 2:
            continue
        c = rd.cur.get(cid)
        if c is None:
            continue
        try:
            # len_prefixed_bulk commits the cursor only on full success
            out[k] = iter(c.len_prefixed_bulk(counts[k]))
        except IndexError:
            pass
    return out


def _bulk_quals(rd, comp, enc, cols):
    """The slice's whole QS byte stream in one read when every record
    stores qualities and QS is EXTERNAL over an exclusive block.
    Returns the bytes or None → per-record reads."""
    qse = enc.get("QS")
    if qse is None or qse.codec != E_EXTERNAL:
        return None
    if any((cf & CF_QS_STORED) == 0 for cf in cols["CF"]):
        return None
    if qse.params in _external_cids_excluding(comp, enc, ("QS",)):
        return None
    c = rd.cur.get(qse.params)
    total_bases = int(sum(cols["RL"]))
    if c is None or len(c.data) - c.off < total_bases:
        return None
    blob = bytes(c.data[c.off: c.off + total_bases])
    c.off += total_bases
    return blob


def _decode_slice(
    slice_hdr, comp: CompressionHeader, blocks: Dict[int, bytes], core,
    ref_fetch,
) -> ReadBatch:
    rd = _Readers(blocks, core or b"")
    enc = comp.series_enc
    n = slice_hdr.n_records
    refid = slice_hdr.ref_seq_id
    multi_ref = refid == -2
    if multi_ref and "RI" not in enc:
        raise ValueError(
            "multi-reference CRAM slice without an RI series encoding")

    refid_l = np.full(n, refid, np.int32)
    prev_ap = slice_hdr.ref_start  # AP-delta seed (htsjdk convention)
    pos_l = np.empty(n, np.int32)
    mapq_l = np.empty(n, np.uint8)
    flag_l = np.empty(n, np.uint16)
    nref_l = np.empty(n, np.int32)
    npos_l = np.empty(n, np.int32)
    tlen_l = np.empty(n, np.int32)
    bin_l = np.zeros(n, np.uint16)
    # flat byte accumulators + per-record lengths (one frombuffer per
    # column at the end instead of n tiny arrays + concatenate)
    names, seqs_l, quals_l, tags_l = (
        bytearray(), bytearray(), bytearray(), bytearray())
    name_lens: List[int] = []
    cig_flat: List[int] = []
    cig_lens: List[int] = []
    seq_lens: List[int] = []
    tag_lens: List[int] = []

    # Columnar fast path: when every fixed per-record series is
    # EXTERNAL with its own block (the htslib/our-writer layout), pull
    # each series' whole value stream in one fused walk and index
    # arrays in the loop, instead of 12 read_int dispatches per record.
    # The value order within each block is identical to the loop's
    # consumption order because these series are one-value-per-record.
    cols = _bulk_fixed_series(rd, comp, enc, n, multi_ref)
    if cols is not None and comp.ap_delta:
        ap_cum = slice_hdr.ref_start + np.cumsum(
            np.asarray(cols["AP"], np.int64))
        cols["AP"] = ap_cum.tolist()
    rn_names = _bulk_split_names(rd, comp, enc, n) if cols is not None \
        else None
    fstreams = _bulk_feature_streams(rd, comp, enc, cols) \
        if cols is not None else None
    qs_blob = _bulk_quals(rd, comp, enc, cols) \
        if cols is not None else None
    bb_vals = _bulk_bb(rd, comp, enc, fstreams)
    tag_bulk = _bulk_tags(rd, comp, enc, cols) if cols is not None else {}
    fidx = 0
    bidx = 0
    qoff = 0

    for i in range(n):
        if cols is not None:
            flag = cols["BF"][i]
            cf = cols["CF"][i]
            rl = cols["RL"][i]
            if multi_ref:
                refid_l[i] = cols["RI"][i]
            ap = cols["AP"][i]
        else:
            flag = rd.read_int(enc["BF"])
            cf = rd.read_int(enc["CF"])
            rl = rd.read_int(enc["RL"])
            if multi_ref:
                refid_l[i] = rd.read_int(enc["RI"])
            ap = rd.read_int(enc["AP"])
            if comp.ap_delta:
                ap = prev_ap + ap
                prev_ap = ap
            rd.read_int(enc["RG"])
        if rn_names is not None:
            name = rn_names[i]
        else:
            name = rd.read_array(enc["RN"]) if comp.rn_preserved else b""
        if not (cf & CF_DETACHED):
            raise ValueError("only detached mate records supported")
        if cols is not None:
            ns, np_, ts = cols["NS"][i], cols["NP"][i], cols["TS"][i]
            tl = cols["TL"][i]
        else:
            rd.read_int(enc["MF"])
            ns = rd.read_int(enc["NS"])
            np_ = rd.read_int(enc["NP"])
            ts = rd.read_int(enc["TS"])
            tl = rd.read_int(enc["TL"])
        tag_entries = []
        for key in comp.tag_lines[tl]:
            it = tag_bulk.get(key)
            val = next(it) if it is not None \
                else rd.read_array(comp.tag_enc[key])
            tag_entries.append((key, val))
        # features (MQ follows them — CRAM 3.0 record layout)
        fn = cols["FN"][i] if cols is not None else rd.read_int(enc["FN"])
        # fast shape: exactly one whole-read 'b' feature at read
        # position 1 (the dominant reference-less record) — equivalent
        # to the generic reconstruction with no gap, no tail and a
        # single M run; unmapped flags clear the CIGAR as below
        if (fstreams is not None and bb_vals is not None and fn == 1
                and not (cf & CF_UNKNOWN_BASES)
                and fstreams[0][fidx] == 98          # ord('b')
                and fstreams[1][fidx] == 1
                and rl > 0 and len(bb_vals[bidx]) == rl):
            fidx += 1
            payload = bb_vals[bidx]
            bidx += 1
            pos0 = ap - 1
            seq = _CHAR_TO_NT16[np.frombuffer(payload, np.uint8)]
            cigar_ops = [] if flag & 0x4 else [rl << 4]
        else:
            features = []
            fpos = 0
            for _ in range(fn):
                if fstreams is not None:
                    code = chr(fstreams[0][fidx])
                    fpos += fstreams[1][fidx]
                    fidx += 1
                else:
                    code = chr(rd.read_byte(enc["FC"]))
                    fpos += rd.read_int(enc["FP"])
                if code == "b":
                    if bb_vals is not None:
                        payload = bb_vals[bidx]
                        bidx += 1
                    else:
                        payload = rd.read_array(enc["BB"])
                elif code == "I":
                    payload = rd.read_array(enc["IN"])
                elif code == "S":
                    payload = rd.read_array(enc["SC"])
                elif code == "D":
                    payload = rd.read_int(enc["DL"])
                elif code == "N":
                    payload = rd.read_int(enc["RS"])
                elif code == "H":
                    payload = rd.read_int(enc["HC"])
                elif code == "P":
                    payload = rd.read_int(enc["PD"])
                else:
                    raise ValueError(f"unsupported read feature {code!r}")
                features.append((fpos, code, payload))

            # reconstruct seq + cigar
            pos0 = ap - 1
            seq = np.zeros(rl, dtype=np.uint8)
            cigar_ops: List[int] = []

            def push(op_char: str, ln: int):
                if ln <= 0:
                    return
                op = "MIDNSHP=X".index(op_char)
                if cigar_ops and (cigar_ops[-1] & 0xF) == op:
                    cigar_ops[-1] += ln << 4
                else:
                    cigar_ops.append((ln << 4) | op)

            rp = 1
            ref_pos = pos0
            if cf & CF_UNKNOWN_BASES:
                features = []
            for fpos, code, payload in features:
                gap = fpos - rp
                if gap > 0:
                    # reference-matching M stretch
                    if ref_fetch is None:
                        raise MissingReferenceError(
                            "reference required to decode this CRAM slice "
                            "(set reference_source_path)"
                        )
                    rb = ref_fetch(int(refid_l[i]), ref_pos, gap)
                    if rb is None or len(rb) < gap:
                        raise MissingReferenceError(
                            f"reference contig for refid {int(refid_l[i])} is "
                            f"missing or too short in the configured FASTA"
                        )
                    seq[rp - 1: rp - 1 + gap] = _CHAR_TO_NT16[
                        np.frombuffer(rb.upper(), np.uint8)
                    ]
                    push("M", gap)
                    rp += gap
                    ref_pos += gap
                if code == "b":
                    ln = len(payload)
                    seq[rp - 1: rp - 1 + ln] = _CHAR_TO_NT16[
                        np.frombuffer(payload, np.uint8)
                    ]
                    push("M", ln)
                    rp += ln
                    ref_pos += ln
                elif code in ("I", "S"):
                    ln = len(payload)
                    seq[rp - 1: rp - 1 + ln] = _CHAR_TO_NT16[
                        np.frombuffer(payload, np.uint8)
                    ]
                    push(code, ln)
                    rp += ln
                elif code in ("D", "N"):
                    push(code, payload)
                    ref_pos += payload
                elif code in ("H", "P"):
                    push(code, payload)
            tail = rl - (rp - 1)
            if tail > 0 and not (cf & CF_UNKNOWN_BASES):
                if (flag & 0x4) == 0 and int(refid_l[i]) >= 0:
                    if ref_fetch is None:
                        raise MissingReferenceError(
                            "reference required to decode this CRAM slice "
                            "(set reference_source_path)"
                        )
                    rb = ref_fetch(int(refid_l[i]), ref_pos, tail)
                    if rb is None or len(rb) < tail:
                        raise MissingReferenceError(
                            f"reference contig for refid {int(refid_l[i])} is "
                            f"missing or too short in the configured FASTA"
                        )
                    seq[rp - 1:] = _CHAR_TO_NT16[np.frombuffer(rb.upper(), np.uint8)]
                    push("M", tail)
                else:
                    raise ValueError("unmapped record with missing base features")

            if flag & 0x4:
                # Unmapped records carry no CIGAR ('*'); any cover-all 'b'
                # feature existed only to transport the bases.
                cigar_ops = []
        mq = cols["MQ"][i] if cols is not None else rd.read_int(enc["MQ"])
        if qs_blob is not None:
            quals = qs_blob[qoff: qoff + rl]
            qoff += rl
        else:
            quals = (rd.read_bytes_len(enc["QS"], rl)
                     if cf & CF_QS_STORED else b"\xff" * rl)
        pos_l[i] = pos0
        mapq_l[i] = mq
        flag_l[i] = flag
        nref_l[i] = ns
        npos_l[i] = np_ - 1
        tlen_l[i] = ts
        names += name
        name_lens.append(len(name))
        cig_flat.extend(cigar_ops)
        cig_lens.append(len(cigar_ops))
        seqs_l += seq.data
        seq_lens.append(rl)
        quals_l += quals     # always length rl — seq_lens covers both
        tb = join_tags(tag_entries)
        tags_l += tb
        tag_lens.append(len(tb))

    def ragged(lens, buf, dtype):
        off = np.zeros(n + 1, dtype=np.int64)
        if lens:
            np.cumsum(lens, out=off[1:])
        # frombuffer over the bytearray directly: no second whole-column
        # copy; the accumulator is never mutated after this point
        flat = (np.frombuffer(buf, dtype) if len(buf)
                else np.zeros(0, dtype=dtype))
        return off, flat

    name_off, names_f = ragged(name_lens, names, np.uint8)
    seq_off, seqs_f = ragged(seq_lens, seqs_l, np.uint8)
    quals_f = (np.frombuffer(quals_l, np.uint8) if len(quals_l)
               else np.zeros(0, np.uint8))
    tag_off, tags_f = ragged(tag_lens, tags_l, np.uint8)
    cigar_off = np.zeros(n + 1, dtype=np.int64)
    if cig_lens:
        np.cumsum(cig_lens, out=cigar_off[1:])
    cigars_f = np.asarray(cig_flat, dtype=np.uint32)
    # bin: recompute (CRAM does not store it) — vectorized over the
    # whole slice, shared with the SAM text parser
    bin_l = bins_from_cigars(cigars_f, cigar_off, pos_l).astype(bin_l.dtype)
    return ReadBatch(
        refid=refid_l, pos=pos_l, mapq=mapq_l, bin=bin_l, flag=flag_l,
        next_refid=nref_l, next_pos=npos_l, tlen=tlen_l,
        name_offsets=name_off, names=names_f,
        cigar_offsets=cigar_off, cigars=cigars_f,
        seq_offsets=seq_off, seqs=seqs_f, quals=quals_f,
        tag_offsets=tag_off, tags=tags_f,
    )
