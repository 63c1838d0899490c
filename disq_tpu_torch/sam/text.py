"""SAM text ⇄ columnar batch conversion.

Replaces htsjdk's ``SAMLineParser`` / ``SAMTextWriter`` (used by the
reference's ``SamSource``/``SamSink``, SURVEY.md §2.6). Binary BAM tag
bytes convert to/from the ``TAG:TYPE:VALUE`` text forms per the SAM spec
§1.5 (types A i f Z H B; binary subtypes c C s S i I canonicalize to
text ``i``, as htsjdk does).
"""

from __future__ import annotations

import re
import struct
from typing import Iterable, List, Tuple

import numpy as np

from disq_tpu_torch.bam.columnar import CIGAR_OPS, SEQ_NT16, ReadBatch
from disq_tpu_torch.bam.header import SamHeader
from disq_tpu_torch.index.bai import bins_from_cigars

_NT16_IDX = {c: i for i, c in enumerate(SEQ_NT16)}
_NT16_IDX.update({c.lower(): i for c, i in list(_NT16_IDX.items())})
_CIG_IDX = {c: i for i, c in enumerate(CIGAR_OPS)}

_B_SUBTYPES = {
    "c": ("b", 1), "C": ("B", 1), "s": ("h", 2), "S": ("H", 2),
    "i": ("i", 4), "I": ("I", 4), "f": ("f", 4),
}


def tags_to_text(tags: bytes) -> List[str]:
    """Binary tag block → list of ``TAG:TYPE:VALUE`` strings."""
    out = []
    p = 0
    n = len(tags)
    while p < n:
        if p + 3 > n:
            raise ValueError("truncated tag block")
        tag = tags[p:p + 2].decode()
        typ = chr(tags[p + 2])
        p += 3
        if typ == "A":
            out.append(f"{tag}:A:{chr(tags[p])}")
            p += 1
        elif typ in "cCsSiI":
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I"}[typ]
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4}[typ]
            (v,) = struct.unpack_from("<" + fmt, tags, p)
            out.append(f"{tag}:i:{v}")
            p += size
        elif typ == "f":
            (v,) = struct.unpack_from("<f", tags, p)
            # shortest float32 round-trip formatting (no %g truncation)
            out.append(f"{tag}:f:{np.float32(v)}")
            p += 4
        elif typ in "ZH":
            end = tags.index(b"\x00", p)
            out.append(f"{tag}:{typ}:{tags[p:end].decode()}")
            p = end + 1
        elif typ == "B":
            sub = chr(tags[p])
            (cnt,) = struct.unpack_from("<I", tags, p + 1)
            fmt, size = _B_SUBTYPES[sub]
            vals = struct.unpack_from(f"<{cnt}{fmt}", tags, p + 5)
            body = ",".join(
                str(np.float32(v)) if sub == "f" else str(v) for v in vals
            )
            out.append(f"{tag}:B:{sub}{',' + body if cnt else ''}")
            p += 5 + cnt * size
        else:
            raise ValueError(f"unknown tag type {typ!r}")
    return out


def text_to_tags(fields: Iterable[str]) -> bytes:
    """``TAG:TYPE:VALUE`` strings → binary tag block."""
    out = bytearray()
    for f in fields:
        tag, typ, val = f.split(":", 2)
        out += tag.encode()
        if typ == "A":
            out += b"A" + val.encode()
        elif typ == "i":
            v = int(val)
            if -(1 << 31) <= v < (1 << 31):
                out += b"i" + struct.pack("<i", v)
            elif v < (1 << 32):
                out += b"I" + struct.pack("<I", v)
            else:
                raise ValueError(f"integer tag value out of range: {v}")
        elif typ == "f":
            out += b"f" + struct.pack("<f", float(val))
        elif typ in ("Z", "H"):
            out += typ.encode() + val.encode() + b"\x00"
        elif typ == "B":
            sub = val[0]
            parts = val[1:].lstrip(",")
            vals = [p for p in parts.split(",") if p] if parts else []
            fmt, _ = _B_SUBTYPES[sub]
            out += b"B" + sub.encode() + struct.pack("<I", len(vals))
            conv = float if sub == "f" else int
            out += struct.pack(f"<{len(vals)}{fmt}", *[conv(v) for v in vals])
        else:
            raise ValueError(f"unknown tag type {typ!r}")
    return bytes(out)


def parse_cigar(s: str) -> List[int]:
    if s == "*":
        return []
    # Full-string anchor: partial matches must raise, not silently drop
    # unparseable segments.
    if not re.fullmatch(r"(?:\d+[MIDNSHP=X])+", s):
        raise ValueError(f"bad CIGAR {s!r}")
    return [
        (int(m.group(1)) << 4) | _CIG_IDX[m.group(2)]
        for m in re.finditer(r"(\d+)([MIDNSHP=X])", s)
    ]


def batch_to_sam_lines(batch: ReadBatch, header: SamHeader) -> List[str]:
    lines = []
    for i in range(batch.count):
        refid = int(batch.refid[i])
        nref = int(batch.next_refid[i])
        rname = header.ref_name(refid)
        if nref == -1:
            rnext = "*"
        elif nref == refid:
            rnext = "="
        else:
            rnext = header.ref_name(nref)
        ts, te = batch.tag_offsets[i], batch.tag_offsets[i + 1]
        tag_fields = tags_to_text(batch.tags[ts:te].tobytes())
        seq = batch.sequence(i) or "*"
        fields = [
            batch.name(i) or "*",
            str(int(batch.flag[i])),
            rname,
            str(int(batch.pos[i]) + 1),
            str(int(batch.mapq[i])),
            batch.cigar_string(i),
            rnext,
            str(int(batch.next_pos[i]) + 1),
            str(int(batch.tlen[i])),
            seq,
            batch.qual_string(i),
        ] + tag_fields
        lines.append("\t".join(fields))
    return lines


def sam_lines_to_batch(lines: Iterable[str], header: SamHeader) -> ReadBatch:
    refid_l, pos_l, mapq_l, flag_l = [], [], [], []
    nref_l, npos_l, tlen_l = [], [], []
    names, cigars, seqs, quals, tags = [], [], [], [], []
    for line in lines:
        line = line.rstrip("\n")
        if not line or line.startswith("@"):
            continue
        f = line.split("\t")
        if len(f) < 11:
            raise ValueError(f"SAM line has {len(f)} fields (need 11): {line[:60]!r}")
        names.append(f[0].encode() if f[0] != "*" else b"")
        flag = int(f[1])
        flag_l.append(flag)
        refid = -1 if f[2] == "*" else header.ref_index(f[2])
        refid_l.append(refid)
        pos = int(f[3]) - 1
        pos_l.append(pos)
        mapq_l.append(int(f[4]))
        ops = parse_cigar(f[5])
        cigars.append(ops)
        if f[6] == "=":
            nref_l.append(refid)
        elif f[6] == "*":
            nref_l.append(-1)
        else:
            nref_l.append(header.ref_index(f[6]))
        npos_l.append(int(f[7]) - 1)
        tlen_l.append(int(f[8]))
        seq = "" if f[9] == "*" else f[9]
        seqs.append(np.array([_NT16_IDX[c] for c in seq], dtype=np.uint8))
        if f[10] == "*":
            quals.append(np.full(len(seq), 0xFF, dtype=np.uint8))
        else:
            if len(f[10]) != len(seq):
                raise ValueError("QUAL length != SEQ length")
            quals.append(
                np.frombuffer(f[10].encode(), dtype=np.uint8) - 33
            )
        tags.append(text_to_tags(f[11:]))

    n = len(names)

    def ragged(items, dtype):
        off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(x) for x in items], out=off[1:])
        flat = (
            np.concatenate([np.asarray(x, dtype=dtype) for x in items])
            if n and off[-1]
            else np.zeros(0, dtype=dtype)
        )
        return off, flat

    name_off, names_f = ragged([np.frombuffer(x, np.uint8) for x in names], np.uint8)
    cigar_off, cigars_f = ragged([np.asarray(c, np.uint32) for c in cigars], np.uint32)
    seq_off, seqs_f = ragged(seqs, np.uint8)
    _, quals_f = ragged(quals, np.uint8)
    tag_off, tags_f = ragged([np.frombuffer(t, np.uint8) for t in tags], np.uint8)
    # bin: vectorized over the whole batch (per-record scalar reg2bin
    # was the hottest line of SAM parse, exactly as for CRAM decode)
    bin_arr = bins_from_cigars(cigars_f, cigar_off, pos_l)
    return ReadBatch(
        refid=np.asarray(refid_l, np.int32), pos=np.asarray(pos_l, np.int32),
        mapq=np.asarray(mapq_l, np.uint8),
        bin=bin_arr.astype(np.uint16),
        flag=np.asarray(flag_l, np.uint16),
        next_refid=np.asarray(nref_l, np.int32),
        next_pos=np.asarray(npos_l, np.int32),
        tlen=np.asarray(tlen_l, np.int32),
        name_offsets=name_off, names=names_f,
        cigar_offsets=cigar_off, cigars=cigars_f,
        seq_offsets=seq_off, seqs=seqs_f, quals=quals_f,
        tag_offsets=tag_off, tags=tags_f,
    )
