"""BCF 2.2: binary VCF, BGZF-wrapped.

Format contract: VCFv4.3 specification §6 ("BCF specification"). BCF
shares BAM's container, a BGZF stream, so its split read rides the same
block machinery (``bgzf``): on ``cuda`` (or with resident decode asked
for on the CPU) each split's blocks inflate on the device route (kernel
B1, or B4 under ``DISQ_TPU_TORCH_DEVICE_INFLATE=legacy``), once per
split, and the joined payload's records decode sequentially on the host
(record boundaries are not guessable mid-stream). Writes deflate
through ``deflate_blob_for`` (zlib-6, or kernel W2 under
``device_deflate``).

Records transcode to and from the verbatim-text ``VariantBatch``
contract (``vcf/columnar.py``): reading reconstructs canonical VCF text
per record; writing encodes text lines into typed binary. Float
formatting uses ``%.6g`` with integral collapse, so text → BCF → text
round-trips for ordinary values.
"""

from __future__ import annotations

import math
import re
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from disq_tpu_torch.vcf.columnar import VariantBatch, parse_vcf_lines
from disq_tpu_torch.vcf.header import VcfHeader

BCF_MAGIC = b"BCF\x02\x02"

# Typed-encoding atom codes (spec §6.3.3).
_T_MISSING, _T_INT8, _T_INT16, _T_INT32, _T_FLOAT, _T_CHAR = 0, 1, 2, 3, 5, 7

_INT_MISSING = {_T_INT8: -128, _T_INT16: -32768, _T_INT32: -2147483648}
_INT_EOV = {_T_INT8: -127, _T_INT16: -32767, _T_INT32: -2147483647}
_FLOAT_MISSING_BITS = 0x7F800001
_FLOAT_EOV_BITS = 0x7F800002


class BcfDictionaries:
    """The two BCF dictionaries (spec §6.2.1): the string dictionary
    (FILTER/INFO/FORMAT ids, ``IDX=`` aware, PASS implicitly 0) and the
    contig dictionary (``##contig`` order, or their ``IDX=``)."""

    def __init__(self, header: VcfHeader):
        strings: Dict[int, str] = {}
        index: Dict[str, int] = {}
        self.info_type: Dict[str, str] = {}
        self.info_number: Dict[str, str] = {}
        self.format_type: Dict[str, str] = {}
        self.format_number: Dict[str, str] = {}

        # Two-pass id assignment (htslib behavior for the spec-invalid
        # but seen-in-the-wild headers that mix ``IDX=``-annotated and
        # unannotated lines): explicit ``IDX=`` lines register first, then
        # implicit lines take sequential indices in declaration order,
        # skipping every explicitly claimed index — so a later explicit
        # line can never collide with an earlier implicit assignment.
        decls: List[Tuple[str, Optional[int]]] = []
        contigs: List[str] = []
        contig_idx: Dict[str, int] = {}
        for line in header.text.splitlines():
            m = re.match(r"##(FILTER|INFO|FORMAT|contig)=<(.*)>\s*$", line)
            if not m:
                continue
            kind, body = m.group(1), m.group(2)
            mid = re.search(r"(?:^|,)ID=([^,>]+)", body)
            if not mid:
                continue
            name = mid.group(1)
            midx = re.search(r"(?:^|,)IDX=(\d+)", body)
            idx = int(midx.group(1)) if midx else None
            if kind == "contig":
                if name not in contig_idx:
                    contig_idx[name] = idx if idx is not None else len(contigs)
                    contigs.append(name)
                continue
            decls.append((name, idx))
            mtype = re.search(r"(?:^|,)Type=([A-Za-z]+)", body)
            mnum = re.search(r"(?:^|,)Number=([^,>]+)", body)
            if kind == "INFO":
                if mtype:
                    self.info_type[name] = mtype.group(1)
                if mnum:
                    self.info_number[name] = mnum.group(1)
            elif kind == "FORMAT":
                if mtype:
                    self.format_type[name] = mtype.group(1)
                if mnum:
                    self.format_number[name] = mnum.group(1)
        # PASS holds index 0 unless the header carries its own explicit
        # ``##FILTER=<ID=PASS,...,IDX=N>`` line, which wins.
        if not any(n == "PASS" and i is not None for n, i in decls):
            decls.insert(0, ("PASS", 0))
        # Pass 1: explicit IDX= claims. Two lines claiming one index is a
        # broken dictionary — decoding through it would silently mislabel
        # fields, so reject.
        for name, idx in decls:
            if idx is None or name in index:
                continue
            if idx in strings:
                raise ValueError(
                    f"BCF header assigns IDX={idx} to both "
                    f"{strings[idx]!r} and {name!r}"
                )
            strings[idx] = name
            index[name] = idx
        # Pass 2: implicit lines, sequential in declaration order.
        next_implicit = 0
        for name, idx in decls:
            if idx is not None or name in index:
                continue
            while next_implicit in strings:
                next_implicit += 1
            strings[next_implicit] = name
            index[name] = next_implicit
        self.strings = strings          # idx -> name
        self.string_index = index       # name -> idx
        # Contig dictionary: position by IDX when given, else header order.
        n = (max(contig_idx.values()) + 1) if contig_idx else 0
        self.contigs: List[Optional[str]] = [None] * n
        for name, i in contig_idx.items():
            self.contigs[i] = name
        self.contig_index = dict(contig_idx)

    def string(self, idx: int) -> str:
        try:
            return self.strings[idx]
        except KeyError:
            raise ValueError(f"BCF string-dictionary index {idx} not in header")

    def contig(self, idx: int) -> str:
        if 0 <= idx < len(self.contigs) and self.contigs[idx] is not None:
            return self.contigs[idx]
        raise ValueError(f"BCF contig index {idx} not in header")


# ---------------------------------------------------------------------------
# typed-value primitives


class _Reader:
    __slots__ = ("buf", "p")

    def __init__(self, buf: bytes, p: int = 0):
        self.buf = buf
        self.p = p

    def u8(self) -> int:
        v = self.buf[self.p]
        self.p += 1
        return v

    def scalar(self, t: int):
        """One scalar; floats come back as raw uint32 bits (see
        ``typed_values``)."""
        if t == _T_INT8:
            (v,) = struct.unpack_from("<b", self.buf, self.p)
            self.p += 1
        elif t == _T_INT16:
            (v,) = struct.unpack_from("<h", self.buf, self.p)
            self.p += 2
        elif t == _T_INT32:
            (v,) = struct.unpack_from("<i", self.buf, self.p)
            self.p += 4
        elif t == _T_FLOAT:
            (v,) = struct.unpack_from("<I", self.buf, self.p)
            self.p += 4
        else:
            raise ValueError(f"bad BCF scalar type {t}")
        return v

    def typed_meta(self) -> Tuple[int, int]:
        """Descriptor byte (+ overflow length) → (atom type, count)."""
        d = self.u8()
        t, n = d & 0x0F, d >> 4
        if n == 15:
            nt, nn = self.typed_meta()
            if nn != 1 or nt not in (_T_INT8, _T_INT16, _T_INT32):
                raise ValueError("malformed BCF overflow length")
            n = int(self.scalar(nt))
        return t, n

    def typed_values(self):
        """One typed value → (atom type, list of raw scalars | bytes).

        Floats are returned as their raw uint32 BITS: the missing /
        end-of-vector sentinels are NaNs with specific payloads, and a
        float round-trip through Python canonicalizes NaN payloads —
        bit-level identity must be preserved to tell them apart."""
        t, n = self.typed_meta()
        if t == _T_MISSING:
            return t, []
        if t == _T_CHAR:
            s = self.buf[self.p: self.p + n]
            self.p += n
            return t, s
        p = self.p
        if n == 1 and t in (_T_INT8, _T_INT16, _T_INT32):
            # scalar fast path — the overwhelmingly common case
            # (INFO values, dictionary keys): skip format-string struct
            return t, [self._scalar_int(t)]
        if t == _T_FLOAT:
            vals = list(struct.unpack_from(f"<{n}I", self.buf, p))
            self.p = p + 4 * n
            return t, vals
        fmt = {_T_INT8: "b", _T_INT16: "h", _T_INT32: "i"}[t]
        vals = list(struct.unpack_from(f"<{n}{fmt}", self.buf, p))
        self.p = p + n * {_T_INT8: 1, _T_INT16: 2, _T_INT32: 4}[t]
        return t, vals

    def _scalar_int(self, t: int) -> int:
        """Bounds-checked scalar int at the cursor (shared by both fast
        paths — a truncated buffer must raise like struct did, not
        decode a short slice to garbage)."""
        p = self.p
        w = 1 if t == _T_INT8 else (2 if t == _T_INT16 else 4)
        if p + w > len(self.buf):
            raise ValueError("truncated BCF typed value")
        self.p = p + w
        if t == _T_INT8:
            v = self.buf[p]
            return v - 256 if v >= 128 else v
        return int.from_bytes(self.buf[p: p + w], "little", signed=True)

    def typed_int(self) -> int:
        """Descriptor + one scalar int, without the list round-trip
        (dictionary keys — the hottest typed read in record decode)."""
        d = self.u8()
        t, n = d & 0x0F, d >> 4
        if n != 1 or t not in (_T_INT8, _T_INT16, _T_INT32):
            self.p -= 1
            t, vals = self.typed_values()
            if t not in (_T_INT8, _T_INT16, _T_INT32) or len(vals) != 1:
                raise ValueError("expected typed scalar int")
            return int(vals[0])
        return self._scalar_int(t)


def _fmt_f32(v: float) -> str:
    if not math.isfinite(v):
        # Legal VCF floats (spec: ^[-+]?(Inf|Infinity|NaN)$, plus digits);
        # also reached by NaNs whose payload isn't a BCF sentinel.
        return "nan" if math.isnan(v) else ("inf" if v > 0 else "-inf")
    if v == int(v) and abs(v) < 1e7:
        return str(int(v))
    return f"{v:.6g}"


def _fmt_f32_bits(bits: int) -> str:
    return _fmt_f32(struct.unpack("<f", struct.pack("<I", bits))[0])


def _typed_header(t: int, n: int) -> bytes:
    if n < 15:
        return bytes([(n << 4) | t])
    if n <= 127:
        return bytes([0xF0 | t, 0x11, n])
    if n <= 32767:
        return bytes([0xF0 | t, 0x12]) + struct.pack("<h", n)
    return bytes([0xF0 | t, 0x13]) + struct.pack("<i", n)


def _int_width(rows: Sequence[Sequence[Optional[int]]]) -> int:
    """Smallest atom type fitting every present value AND the missing /
    end-of-vector sentinels of that width."""
    present = [x for r in rows for x in r if x is not None]
    lo, hi = min(present, default=0), max(present, default=0)
    if -120 <= lo and hi <= 127:
        return _T_INT8
    if -32000 <= lo and hi <= 32767:
        return _T_INT16
    return _T_INT32


_INT_FMT = {_T_INT8: "<b", _T_INT16: "<h", _T_INT32: "<i"}


def _enc_int_vectors(
    rows: Sequence[Sequence[Optional[int]]], width: int
) -> bytes:
    """One typed descriptor of per-row width ``width``, then each row's
    values (None → missing), EOV-padded — the FORMAT vector layout."""
    t = _int_width(rows)
    fmt = _INT_FMT[t]
    out = bytearray(_typed_header(t, width))
    for r in rows:
        for x in r:
            out += struct.pack(fmt, _INT_MISSING[t] if x is None else x)
        out += struct.pack(fmt, _INT_EOV[t]) * (width - len(r))
    return bytes(out)


def _enc_ints(vals: Sequence[Optional[int]]) -> bytes:
    """Typed int vector (the single-vector INFO/FILTER layout)."""
    vals = list(vals)
    return _enc_int_vectors([vals], len(vals))


def _enc_floats(vals: Sequence[Optional[float]], pad_to: int = 0) -> bytes:
    n = max(len(vals), pad_to)
    out = bytearray(_typed_header(_T_FLOAT, n))
    for v in vals:
        if v is None:
            out += struct.pack("<I", _FLOAT_MISSING_BITS)
        else:
            out += struct.pack("<f", v)
    for _ in range(n - len(vals)):
        out += struct.pack("<I", _FLOAT_EOV_BITS)
    return bytes(out)


def _enc_chars(s: bytes) -> bytes:
    return _typed_header(_T_CHAR, len(s)) + s


def _enc_typed_int_scalar(v: int) -> bytes:
    return _enc_ints([v])


# ---------------------------------------------------------------------------
# decode: binary records → VCF text lines


def _ints_to_text(vals: Sequence[int], t: int) -> str:
    out = []
    for v in vals:
        if v == _INT_EOV[t]:
            break
        out.append("." if v == _INT_MISSING[t] else str(v))
    return ",".join(out) if out else "."

def _floats_to_text(bits_vals: Sequence[int]) -> str:
    out = []
    for b in bits_vals:
        if b == _FLOAT_EOV_BITS:
            break
        out.append("." if b == _FLOAT_MISSING_BITS else _fmt_f32_bits(b))
    return ",".join(out) if out else "."


def _gt_to_text(vals: Sequence[int], t: int) -> str:
    parts: List[str] = []
    for k, v in enumerate(vals):
        if v == _INT_EOV[t]:
            break
        # The int MISSING sentinel inside a GT vector (written by some
        # foreign encoders instead of the spec's encoded no-call 0)
        # renders as '.', same as allele value 0.
        if v == _INT_MISSING[t]:
            v = 0
        allele = "." if (v >> 1) == 0 else str((v >> 1) - 1)
        if k == 0:
            parts.append(allele)
        else:
            parts.append(("|" if v & 1 else "/") + allele)
    return "".join(parts) if parts else "."


def decode_bcf_records(
    payload: bytes, header: VcfHeader, start: int
) -> VariantBatch:
    """Decode BCF records from decompressed ``payload[start:]`` into a
    ``VariantBatch`` of reconstructed VCF text lines."""
    dicts = BcfDictionaries(header)
    lines: List[bytes] = []
    p = start
    end = len(payload)
    while p < end:
        if p + 8 > end:
            raise ValueError(f"truncated BCF record header at {p}")
        l_shared, l_indiv = struct.unpack_from("<II", payload, p)
        rec_end = p + 8 + l_shared + l_indiv
        if rec_end > end:
            raise ValueError(f"truncated BCF record at {p}")
        r = _Reader(payload, p + 8)
        chrom_i, pos0, _rlen = struct.unpack_from("<iii", payload, r.p)
        r.p += 12
        (qual_bits,) = struct.unpack_from("<I", payload, r.p)
        r.p += 4
        n_allele_info, n_fmt_sample = struct.unpack_from("<II", payload, r.p)
        r.p += 8
        n_allele, n_info = n_allele_info >> 16, n_allele_info & 0xFFFF
        n_fmt, n_sample = n_fmt_sample >> 24, n_fmt_sample & 0xFFFFFF

        t, idv = r.typed_values()
        vid = idv.decode() if t == _T_CHAR and idv else "."
        alleles = []
        for _ in range(n_allele):
            t, a = r.typed_values()
            alleles.append(a.decode() if t == _T_CHAR else ".")
        ref = alleles[0] if alleles else "."
        alt = ",".join(alleles[1:]) if len(alleles) > 1 else "."
        t, filt = r.typed_values()
        if t == _T_MISSING or not len(filt):
            filt_s = "."
        else:
            filt_s = ";".join(dicts.string(int(v)) for v in filt)
        info_parts = []
        for _ in range(n_info):
            key = dicts.string(r.typed_int())
            t, vals = r.typed_values()
            if t == _T_MISSING:
                info_parts.append(key)  # Flag
            elif t == _T_CHAR:
                info_parts.append(f"{key}={vals.decode()}")
            elif t == _T_FLOAT:
                info_parts.append(f"{key}={_floats_to_text(vals)}")
            else:
                info_parts.append(f"{key}={_ints_to_text(vals, t)}")
        info_s = ";".join(info_parts) if info_parts else "."

        cols = [
            dicts.contig(chrom_i), str(pos0 + 1), vid, ref, alt,
            "." if qual_bits == _FLOAT_MISSING_BITS else _fmt_f32_bits(qual_bits),
            filt_s, info_s,
        ]
        if n_fmt:
            r.p = p + 8 + l_shared
            keys: List[str] = []
            per_sample: List[List[str]] = [[] for _ in range(n_sample)]
            for _ in range(n_fmt):
                key = dicts.string(r.typed_int())
                keys.append(key)
                t, width = r.typed_meta()
                for s in range(n_sample):
                    if t == _T_CHAR:
                        raw = payload[r.p: r.p + width]
                        r.p += width
                        txt = raw.split(b"\x00")[0].decode() or "."
                        per_sample[s].append(txt)
                        continue
                    vals = [r.scalar(t) for _ in range(width)]
                    if key == "GT" and t in _INT_EOV:
                        per_sample[s].append(_gt_to_text(vals, t))
                    elif t == _T_FLOAT:
                        per_sample[s].append(_floats_to_text(vals))
                    else:
                        per_sample[s].append(_ints_to_text(vals, t))
            cols.append(":".join(keys))
            cols += [":".join(sv) for sv in per_sample]
        lines.append("\t".join(cols).encode())
        p = rec_end
    return parse_vcf_lines(lines, header.contig_names)


# ---------------------------------------------------------------------------
# encode: VCF text lines → binary records


def _enc_info_value(key: str, val: Optional[str], dicts: BcfDictionaries) -> bytes:
    typ = dicts.info_type.get(key, "String")
    if val is None:
        return b"\x00"  # Flag: typed MISSING, presence implies true
    if typ == "Integer":
        return _enc_ints(
            [None if x == "." else int(x) for x in val.split(",")]
        )
    if typ == "Float":
        return _enc_floats(
            [None if x == "." else float(x) for x in val.split(",")]
        )
    if typ == "Flag":
        return b"\x00"
    return _enc_chars(val.encode())


def _parse_gt(txt: str) -> List[int]:
    """``0/1`` → [(allele+1)<<1 | phased, …]; ``.`` alleles encode as 0.
    The first allele carries no separator, so its phase bit is 0."""
    sep_phased = [False]
    for ch in txt:
        if ch in "|/":
            sep_phased.append(ch == "|")
    out = []
    for tok, ph in zip(re.split(r"[|/]", txt), sep_phased):
        allele = 0 if tok in (".", "") else int(tok) + 1
        out.append((allele << 1) | (1 if ph else 0))
    return out


def encode_bcf_records(batch: VariantBatch, header: VcfHeader) -> bytes:
    """Encode a ``VariantBatch``'s text lines as BCF binary records."""
    dicts = BcfDictionaries(header)
    n_sample_hdr = len(header.samples)
    out = bytearray()
    for i in range(batch.count):
        line = batch.line(i)
        f = line.rstrip("\n").split("\t")
        if len(f) < 8:
            raise ValueError(f"VCF line has {len(f)} fields: {line[:60]!r}")
        chrom, pos_s, vid, ref, alt, qual_s, filt_s, info_s = f[:8]
        if chrom not in dicts.contig_index:
            raise ValueError(
                f"contig {chrom!r} not declared in header (BCF requires "
                "##contig lines)"
            )
        pos0 = int(pos_s) - 1
        alleles = [ref] + ([] if alt == "." else alt.split(","))
        rlen = int(batch.end[i]) - int(batch.pos[i]) + 1

        shared = bytearray()
        shared += struct.pack("<iii", dicts.contig_index[chrom], pos0, rlen)
        if qual_s == ".":
            shared += struct.pack("<I", _FLOAT_MISSING_BITS)
        else:
            shared += struct.pack("<f", float(qual_s))
        info_items: List[Tuple[str, Optional[str]]] = []
        if info_s != ".":
            for kv in info_s.split(";"):
                if not kv:
                    continue
                k, _, v = kv.partition("=")
                info_items.append((k, v if _ else None))
        fmt_keys = f[8].split(":") if len(f) > 8 else []
        samples = f[9:] if len(f) > 9 else []
        if len(samples) != n_sample_hdr:
            raise ValueError(
                f"line has {len(samples)} sample columns, header declares "
                f"{n_sample_hdr}"
            )
        shared += struct.pack(
            "<II",
            (len(alleles) << 16) | len(info_items),
            (len(fmt_keys) << 24) | len(samples),
        )
        shared += _enc_chars(vid.encode()) if vid != "." else b"\x07"
        for a in alleles:
            shared += _enc_chars(a.encode())
        if filt_s == ".":
            shared += b"\x00"
        else:
            fids = []
            for name in filt_s.split(";"):
                if name not in dicts.string_index:
                    raise ValueError(f"FILTER {name!r} not declared in header")
                fids.append(dicts.string_index[name])
            shared += _enc_ints(fids)
        for k, v in info_items:
            if k not in dicts.string_index:
                raise ValueError(f"INFO key {k!r} not declared in header")
            shared += _enc_typed_int_scalar(dicts.string_index[k])
            shared += _enc_info_value(k, v, dicts)

        indiv = bytearray()
        sample_fields = [s.split(":") for s in samples]
        for fi, key in enumerate(fmt_keys):
            if key not in dicts.string_index:
                raise ValueError(f"FORMAT key {key!r} not declared in header")
            indiv += _enc_typed_int_scalar(dicts.string_index[key])
            col = [sf[fi] if fi < len(sf) else "." for sf in sample_fields]
            typ = dicts.format_type.get(key, "String")
            if key == "GT":
                gts = [_parse_gt(c) for c in col]
                width = max((len(g) for g in gts), default=1) or 1
                indiv += _enc_int_vectors(gts, width)
            elif typ == "Integer":
                vals = [
                    [None if x in (".", "") else int(x) for x in c.split(",")]
                    if c != "." else [None]
                    for c in col
                ]
                indiv += _enc_int_vectors(vals, max(len(v) for v in vals))
            elif typ == "Float":
                vals = [
                    [None if x in (".", "") else float(x) for x in c.split(",")]
                    if c != "." else [None]
                    for c in col
                ]
                width = max(len(v) for v in vals)
                body = bytearray(_typed_header(_T_FLOAT, width))
                for v in vals:
                    for x in v:
                        body += struct.pack(
                            "<I", _FLOAT_MISSING_BITS
                        ) if x is None else struct.pack("<f", x)
                    for _ in range(width - len(v)):
                        body += struct.pack("<I", _FLOAT_EOV_BITS)
                indiv += body
            else:  # String / Character: NUL-padded fixed-width char vectors
                raw = [c.encode() for c in col]
                width = max((len(x) for x in raw), default=1) or 1
                body = bytearray(_typed_header(_T_CHAR, width))
                for x in raw:
                    body += x + b"\x00" * (width - len(x))
                indiv += body

        out += struct.pack("<II", len(shared), len(indiv))
        out += shared
        out += indiv
    return bytes(out)


# ---------------------------------------------------------------------------
# header block


def read_bcf_header_block(payload: bytes) -> Tuple[VcfHeader, int]:
    """Parse magic + header text block; returns (header, records offset)."""
    if payload[:5] != BCF_MAGIC:
        raise ValueError(
            f"not a BCF 2.2 stream (magic {payload[:5]!r})"
        )
    if len(payload) < 9:
        raise ValueError("truncated BCF header block")
    (l_text,) = struct.unpack_from("<I", payload, 5)
    if 9 + l_text > len(payload):
        raise ValueError(
            f"truncated BCF header: l_text={l_text} but only "
            f"{len(payload) - 9} bytes follow"
        )
    text = payload[9: 9 + l_text].split(b"\x00")[0].decode()
    if text and not text.endswith("\n"):
        text += "\n"
    return VcfHeader.from_text(text), 9 + l_text


def build_bcf_header_block(header: VcfHeader) -> bytes:
    text = header.text
    if not text.endswith("\n"):
        text += "\n"
    raw = text.encode() + b"\x00"
    return BCF_MAGIC + struct.pack("<I", len(raw)) + raw


# ---------------------------------------------------------------------------
# source / sink


class BcfSource:
    """BCF read path. Record boundaries are not guessable mid-stream (no
    BCF analogue of ``BamRecordGuesser`` exists), so every split's blocks
    inflate through the shard executor and the joined payload's records
    decode sequentially."""

    def __init__(self, storage=None):
        self._storage = storage

    def get_header(self, path: str) -> VcfHeader:
        from disq_tpu_torch.bgzf.codec import BgzfReader
        from disq_tpu_torch.fsw.filesystem import resolve_path

        fs, path = resolve_path(path)
        with fs.open(path) as raw:
            r = BgzfReader(raw)
            head = r.read(1 << 20)
            if len(head) >= 9:
                (l_text,) = struct.unpack_from("<I", head, 5)
                while len(head) < 9 + l_text:
                    more = r.read(9 + l_text - len(head))
                    if not more:
                        break
                    head += more
        return read_bcf_header_block(head)[0]

    def get_variants(self, path: str, intervals=None):
        import functools

        from disq_tpu_torch.api import VariantsDataset
        from disq_tpu_torch.fsw.filesystem import compute_path_splits, resolve_path
        from disq_tpu_torch.runtime.columnar import device_route
        from disq_tpu_torch.runtime.counters import ShardCounters, reduce_counters
        from disq_tpu_torch.runtime.errors import context_for_storage
        from disq_tpu_torch.runtime.executor import (
            ShardTask,
            executor_for_storage,
            map_ordered_resumable,
            read_ledger_for_storage,
        )
        from disq_tpu_torch.runtime.introspect import note_shard_counters
        from disq_tpu_torch.runtime.tracing import wrap_span

        fs, path = resolve_path(path)
        ctx = context_for_storage(self._storage, path)
        length = fs.get_file_length(path)
        device = device_route(self._storage)
        # Stage the whole-file BGZF payload through the shard executor:
        # stage A walks and collects each byte-range split's blocks (the
        # "block starts in [start, end)" first-owner rule, the VCF and
        # BAM split tiling), stage B inflates them, stage C joins the
        # payloads in split order. Record decode stays sequential, but
        # with workers > 1 the range reads and the inflate overlap across
        # splits.
        split_size = getattr(self._storage, "_split_size",
                             128 * 1024 * 1024)
        tasks, shard_ctxs = [], []
        for i, s in enumerate(compute_path_splits(fs, path, split_size)):
            shard_ctx = ctx.for_shard(i)
            shard_ctxs.append(shard_ctx)
            tasks.append(ShardTask(
                shard_id=i,
                # per-split timeline spans carrying shard id and byte range
                fetch=wrap_span(
                    "bcf.split.fetch",
                    functools.partial(
                        self._fetch_split_blocks, fs, path, s.start, s.end,
                        length),
                    shard=i, start=s.start, end=s.end),
                decode=wrap_span(
                    "bcf.split.inflate",
                    functools.partial(self._inflate_fetched, device=device),
                    shard=i),
                retrier=shard_ctx.retrier,
                what=f"bcf-split{i}",
            ))
        parts = []
        shard_counters = []
        # the whole file decodes as one BGZF stream, so a split cannot be
        # replaced by an empty stand-in: a shard deadline keeps the strict
        # abort; hedging, the budget, the breaker and the ledger apply.
        # No shard scheduler either: every process needs the whole
        # stream to parse it, so leased splits make no partition
        ledger = read_ledger_for_storage(self._storage, path, len(tasks),
                                         device is not None)
        for res in map_ordered_resumable(
                executor_for_storage(self._storage), tasks, ledger):
            part, n_blocks, c_bytes = res.value
            parts.append(part)
            c = ShardCounters(
                shard_id=res.shard_id,
                blocks=n_blocks,
                bytes_compressed=c_bytes,
                bytes_uncompressed=len(part),
                wall_seconds=res.wall_seconds,
                retried_reads=shard_ctxs[res.shard_id].retrier.retried,
            )
            shard_counters.append(c)
            note_shard_counters("read", c)  # the live /progress feed
        payload = b"".join(parts)
        header, rec_off = read_bcf_header_block(payload)
        batch = decode_bcf_records(payload, header, rec_off)
        if intervals is not None:
            from disq_tpu_torch.vcf.source import VcfSource

            batch = batch.filter(VcfSource._overlap_mask(batch, intervals))
        counters = reduce_counters(shard_counters)
        counters.records = int(batch.count)
        counters.retried_reads += ctx.retrier.retried
        return VariantsDataset(header=header, variants=batch,
                               counters=counters)

    @staticmethod
    def _fetch_split_blocks(fs, path: str, start: int, end: int,
                            length: int):
        """Stage A: collect the compressed blocks whose start lies in
        [start, end), block-aligned through the guesser for mid-file
        split starts (offset 0 is always a block start in a valid BCF)."""
        from disq_tpu_torch.bgzf.guesser import (
            BgzfBlockGuesser,
            walk_blocks_collect,
        )

        if start == 0:
            first = 0
        else:
            first = BgzfBlockGuesser(fs, path).guess_block_start(start)
            if first is None or first >= end:
                return None
        blocks, data = walk_blocks_collect(fs, path, first, end, length)
        return blocks, data, first

    @staticmethod
    def _inflate_fetched(fetched, device=None):
        """Stage B: one batched inflate of a split's staged blocks, on
        ``device``'s route when given (a corrupt block raises). Returns
        (payload bytes, block count, compressed bytes)."""
        from disq_tpu_torch.bgzf.codec import (
            inflate_blocks,
            inflate_blocks_device,
        )

        if fetched is None:
            return b"", 0, 0
        blocks, data, first = fetched
        if not blocks:
            return b"", 0, 0
        if device is not None:
            payload = inflate_blocks_device(data, blocks, first, device)[0]
        else:
            payload = inflate_blocks(data, blocks, base=first)
        return payload.tobytes(), len(blocks), sum(b.csize for b in blocks)


def _header_with_contig_lines(header: VcfHeader, names: Sequence[str]) -> VcfHeader:
    """Append ``##contig=<ID=…>`` lines (before ``#CHROM``) for contigs
    present in the data but missing from the header text — BCF's contig
    dictionary lives in the text, so ``with_contigs`` alone (which only
    patches the parsed tuple) is not enough for encoding."""
    declared = set(BcfDictionaries(header).contig_index)
    extra = [n for n in names if n not in declared]
    if not extra:
        return header
    lines = header.text.splitlines()
    insert_at = next(
        (i for i, ln in enumerate(lines) if ln.startswith("#CHROM")), len(lines)
    )
    lines[insert_at:insert_at] = [f"##contig=<ID={n}>" for n in extra]
    return VcfHeader.from_text("\n".join(lines) + "\n")


class BcfSink:
    """Single-file BCF write: per-shard encoded+deflated record parts
    behind a header-block prefix, BGZF terminator appended.

    Shards run through the write pipeline's encode/deflate stages
    (overlapped across shards at ``writer_workers>1``); the single
    output stream is written at the ordered emit, so bytes are
    identical at any worker count."""

    def __init__(self, storage=None):
        self._storage = storage

    def save(self, dataset, path: str, options: Sequence = ()) -> None:
        from disq_tpu_torch.bgzf.block import BGZF_EOF_MARKER
        from disq_tpu_torch.bgzf.codec import deflate_blob_for
        from disq_tpu_torch.fsw.filesystem import resolve_path
        from disq_tpu_torch.runtime.executor import (
            WriteShardTask,
            write_retrier_for_storage,
            writer_for_storage,
        )
        from disq_tpu_torch.runtime.tracing import span, wrap_span
        from disq_tpu_torch.util import shard_bounds

        fs, path = resolve_path(path)
        batch: VariantBatch = dataset.variants
        header = _header_with_contig_lines(
            dataset.header, list(batch.contig_names)
        )
        n_shards, bounds = shard_bounds(self._storage, batch.count)

        def make_task(k):
            def encode():
                part = batch.slice(int(bounds[k]), int(bounds[k + 1]))
                return encode_bcf_records(part, header)

            def deflate(body):
                # routed by the storage's device_deflate knob, as every
                # other sink's deflate
                return (deflate_blob_for(self._storage, body)[0]
                        if body else b"")

            return WriteShardTask(
                shard_id=k,
                encode=wrap_span("bcf.write.encode", encode, shard=k),
                deflate=wrap_span("bcf.write.deflate", deflate, shard=k),
                what="bcf.part",
            )

        pipeline = writer_for_storage(self._storage)
        tasks = [make_task(k) for k in range(n_shards)]
        # The stream open is the only faultable write-side call here
        # (stream writes land in the atomic staging file directly).
        with write_retrier_for_storage(self._storage, path).call(
                fs.create, path, what="bcf.create") as out:
            out.write(deflate_blob_for(
                self._storage, build_bcf_header_block(header))[0])
            for res in pipeline.map_ordered(tasks):
                if res.value:
                    with span("bcf.write.stage", shard=res.shard_id):
                        out.write(res.value)
            out.write(BGZF_EOF_MARKER)


class BcfSinkMultiple:
    """Directory of complete per-shard BCFs (``MULTIPLE`` cardinality)."""

    def __init__(self, storage=None):
        self._storage = storage

    def save(self, dataset, path: str, options: Sequence = ()) -> None:
        from disq_tpu_torch.fsw.filesystem import resolve_path
        from disq_tpu_torch.util import shard_bounds

        fs, path = resolve_path(path)
        batch: VariantBatch = dataset.variants
        n_shards, bounds = shard_bounds(self._storage, batch.count)
        fs.mkdirs(path)
        single = BcfSink(self._storage)
        from disq_tpu_torch.api import VariantsDataset

        for k in range(n_shards):
            part = batch.slice(int(bounds[k]), int(bounds[k + 1]))
            single.save(
                VariantsDataset(header=dataset.header, variants=part),
                f"{path}/part-r-{k:05d}.bcf",
                options,
            )
