"""A plain CRAM 3.0 decoder: pure Python and ``zlib``, record by record,
as the specification reads.

``walk(path)`` lists the containers and their blocks (method, rANS
order, compressed and raw size) without decoding a record;
``decode(path, ref)`` gives the records as BAM record bytes, with the
header and the reference names. It reads what ``generators/
cram_htslib.py`` writes: rANS 4x8 order 0 and order 1, gzip and raw
blocks; EXTERNAL, single-symbol HUFFMAN, BYTE_ARRAY_LEN and
BYTE_ARRAY_STOP encodings; every read feature (b B X I i D N S H P q Q);
attached mates (CF 0x4, NF) and detached ones (CF 0x2); unmapped reads
as BA bases. It is slow (a pure-Python rANS): the tests use it at small
sizes.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

ORDER = "ACGTN"
REF_CONSUMING = set("MDN=X")


# -- primitive reads ---------------------------------------------------------

class Reader:
    def __init__(self, data: bytes, off: int = 0) -> None:
        self.data, self.off = data, off

    def u8(self) -> int:
        v = self.data[self.off]
        self.off += 1
        return v

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise ValueError("read past the end of a stream")
        v = self.data[self.off:self.off + n]
        self.off += n
        return bytes(v)

    def itf8(self) -> int:
        b0 = self.u8()
        if b0 < 0x80:
            v = b0
        elif b0 < 0xC0:
            v = ((b0 & 0x3F) << 8) | self.u8()
        elif b0 < 0xE0:
            v = ((b0 & 0x1F) << 16) | (self.u8() << 8) | self.u8()
        elif b0 < 0xF0:
            v = ((b0 & 0x0F) << 24) | (self.u8() << 16) | (self.u8() << 8) \
                | self.u8()
        else:
            v = ((b0 & 0x0F) << 28) | (self.u8() << 20) | (self.u8() << 12) \
                | (self.u8() << 4) | (self.u8() & 0x0F)
        return v - (1 << 32) if v >= 1 << 31 else v

    def ltf8(self) -> int:
        b0 = self.u8()
        extra = 0
        while extra < 8 and b0 & (0x80 >> extra):
            extra += 1
        v = b0 & (0xFF >> (extra + 1)) if extra < 7 else 0
        for _ in range(extra):
            v = (v << 8) | self.u8()
        return v


# -- rANS 4x8 ---------------------------------------------------------------

def _table(r: Reader) -> List[int]:
    freq = [0] * 256
    sym = r.u8()
    last, run = -1, 0
    while True:
        f = r.u8()
        if f >= 0x80:
            f = ((f & 0x7F) << 8) | r.u8()
        freq[sym] = f
        if run:
            run -= 1
            last, sym = sym, sym + 1
            continue
        last = sym
        nxt = r.u8()
        if nxt == 0:
            break
        if nxt == last + 1:
            run = r.u8()
        sym = nxt
    if sum(freq) != 4096:
        raise ValueError("a rANS frequency table does not sum to 4096")
    return freq


def _contexts(r: Reader) -> Dict[int, List[int]]:
    out = {}
    ctx = r.u8()
    run = 0
    while True:
        out[ctx] = _table(r)
        if run:
            run -= 1
            ctx += 1
            continue
        last = ctx
        nxt = r.u8()
        if nxt == 0:
            break
        if nxt == last + 1:
            run = r.u8()
        ctx = nxt
    return out


def rans(data: bytes) -> bytes:
    order, clen, n = struct.unpack_from("<BII", data, 0)
    r = Reader(data, 9)
    if n == 0:
        return b""
    tables = {0: _table(r)} if order == 0 else _contexts(r)
    lookup = {}
    for c, f in tables.items():
        cum, slots = [0] * 257, []
        for s in range(256):
            cum[s + 1] = cum[s] + f[s]
            slots += [s] * f[s]
        lookup[c] = (f, cum, slots)
    x = list(struct.unpack_from("<4I", data, r.off))
    r.off += 16
    out = bytearray(n)

    def step(j, ctx):
        f, cum, slots = lookup[ctx]
        m = x[j] & 0xFFF
        s = slots[m]
        v = f[s] * (x[j] >> 12) + m - cum[s]
        while v < (1 << 23):
            v = (v << 8) | r.u8()
        x[j] = v
        return s

    if order == 0:
        for i in range(n):
            out[i] = step(i & 3, 0)
    else:
        q = n // 4
        ends = [q, 2 * q, 3 * q, n]
        at = [0, q, 2 * q, 3 * q]
        ctx = [0, 0, 0, 0]
        while any(at[j] < ends[j] for j in range(4)):
            for j in range(4):
                if at[j] < ends[j]:
                    s = step(j, ctx[j])
                    out[at[j]] = s
                    ctx[j] = s
                    at[j] += 1
    return bytes(out)


# -- structure ---------------------------------------------------------------

def _block(r: Reader) -> dict:
    start = r.off
    method, ctype = r.u8(), r.u8()
    cid, clen, rlen = r.itf8(), r.itf8(), r.itf8()
    comp = r.take(clen)
    (crc,) = struct.unpack("<I", r.take(4))
    if zlib.crc32(r.data[start:r.off - 4]) != crc:
        raise ValueError("block CRC mismatch")
    return {"method": method, "type": ctype, "cid": cid, "comp": comp,
            "raw_size": rlen,
            "order": comp[0] if method == 4 and clen else None}


def _unpack(b: dict) -> bytes:
    m = b["method"]
    data = b["comp"] if m == 0 else zlib.decompress(b["comp"], 31) \
        if m == 1 else rans(b["comp"]) if m == 4 else None
    if data is None or len(data) != b["raw_size"]:
        raise ValueError(f"cannot unpack a block of method {m}")
    return data


def _containers(data: bytes):
    if data[:4] != b"CRAM" or data[4] != 3:
        raise ValueError("not a CRAM 3 file")
    r = Reader(data, 26)
    while r.off < len(data):
        at = r.off
        (length,) = struct.unpack("<i", r.take(4))
        h = {"offset": at, "ref": r.itf8(), "start": r.itf8(),
             "span": r.itf8(), "records": r.itf8(), "counter": r.ltf8(),
             "bases": r.ltf8(), "blocks": r.itf8()}
        h["landmarks"] = [r.itf8() for _ in range(r.itf8())]
        (crc,) = struct.unpack("<I", r.take(4))
        if zlib.crc32(data[at:r.off - 4]) != crc:
            raise ValueError("container header CRC mismatch")
        end = r.off + length
        blocks = []
        while r.off < end:
            blocks.append(_block(r))
        h["block_list"] = blocks
        yield h


def walk(path: str) -> List[dict]:
    """Every container (EOF included) with its blocks' method, rANS
    order, compressed size (the stored bytes, rANS header included) and
    raw size."""
    with open(path, "rb") as f:
        data = f.read()
    out = []
    for h in _containers(data):
        blocks = [{"method": b["method"], "type": b["type"], "cid": b["cid"],
                   "order": b["order"], "comp_size": len(b["comp"]),
                   "raw_size": b["raw_size"]} for b in h.pop("block_list")]
        out.append(dict(h, block_list=blocks))
    return out


# -- the compression header --------------------------------------------------

def _encoding(r: Reader):
    codec, n = r.itf8(), r.itf8()
    p = Reader(r.take(n))
    if codec == 1:
        return ("ext", p.itf8())
    if codec == 3:
        syms = [p.itf8() for _ in range(p.itf8())]
        lens = [p.itf8() for _ in range(p.itf8())]
        if len(syms) != 1 or lens != [0]:
            raise ValueError("only single-symbol HUFFMAN is read here")
        return ("const", syms[0])
    if codec == 4:
        return ("len", _encoding(p), _encoding(p))
    if codec == 5:
        return ("stop", p.u8(), p.itf8())
    raise ValueError(f"encoding {codec} is not read here")


def _header(data: bytes) -> dict:
    r = Reader(data)
    h = {"RN": True, "AP": True, "RR": True, "TD": [[]], "SM": None}
    r.itf8()
    for _ in range(r.itf8()):
        key = r.take(2).decode()
        if key in ("RN", "AP", "RR"):
            h[key] = r.u8() != 0
        elif key == "SM":
            h["SM"] = r.take(5)
        elif key == "TD":
            blob = r.take(r.itf8())
            h["TD"] = [[line[i:i + 3] for i in range(0, len(line), 3)]
                       for line in blob.split(b"\x00")[:-1]]
    r.itf8()
    h["series"] = {r.take(2).decode(): _encoding(r)
                   for _ in range(r.itf8())}
    r.itf8()
    h["tags"] = {}
    for _ in range(r.itf8()):
        key = r.itf8()
        h["tags"][key] = _encoding(r)
    return h


def substitutions(sm: bytes) -> Dict[Tuple[str, int], str]:
    """(reference base, code) -> read base, from the SM bytes."""
    out = {}
    for i, ref in enumerate(ORDER):
        others = [b for b in ORDER if b != ref]
        for k, b in enumerate(others):
            out[(ref, (sm[i] >> (6 - 2 * k)) & 3)] = b
    return out


class Series:
    """The slice's external blocks, read through the header's
    encodings."""

    def __init__(self, blocks: Dict[int, bytes], head: dict) -> None:
        self.r = {cid: Reader(b) for cid, b in blocks.items()}
        self.head = head

    def _int(self, e) -> int:
        if e[0] == "const":
            return e[1]
        return self.r[e[1]].itf8()

    def _byte(self, e) -> int:
        if e[0] == "const":
            return e[1]
        return self.r[e[1]].u8()

    def _array(self, e) -> bytes:
        if e[0] == "stop":
            rd = self.r[e[2]]
            end = rd.data.index(bytes([e[1]]), rd.off)
            v = rd.data[rd.off:end]
            rd.off = end + 1
            return bytes(v)
        n = self._int(e[1])
        return self.r[e[2][1]].take(n)

    def int(self, key):
        return self._int(self.head["series"][key])

    def byte(self, key):
        return self._byte(self.head["series"][key])

    def array(self, key):
        return self._array(self.head["series"][key])

    def tag(self, key):
        return self._array(self.head["tags"][key])


# -- records -----------------------------------------------------------------

def reg2bin(beg: int, end: int) -> int:
    end -= 1
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return offset + (beg >> shift)
    return 0


def _slice(head, sh, blocks, ref: Dict[int, bytes]) -> List[dict]:
    s = Series(blocks, head)
    subst = substitutions(head["SM"]) if head["SM"] else {}
    has_ba = "BA" in head["series"]
    recs = []
    prev = sh["start"]
    for i in range(sh["records"]):
        bf, cf = s.int("BF"), s.int("CF")
        refid = s.int("RI") if sh["ref"] == -2 else sh["ref"]
        rl = s.int("RL")
        ap = s.int("AP")
        if head["AP"]:
            ap += prev
            prev = ap
        s.int("RG")
        name = s.array("RN") if head["RN"] else b""
        rec = {"flag": bf, "refid": refid, "pos": ap - 1, "name": name,
               "mate": None, "next_refid": -1, "next_pos": -1, "tlen": 0}
        if cf & 2:
            mf = s.int("MF")
            rec["next_refid"] = s.int("NS")
            rec["next_pos"] = s.int("NP") - 1
            rec["tlen"] = s.int("TS")
            rec["flag"] |= (0x20 if mf & 1 else 0) | (0x8 if mf & 2 else 0)
        elif cf & 4:
            rec["mate"] = i + s.int("NF") + 1
        tags = b""
        for key in head["TD"][s.int("TL")]:
            k = (key[0] << 16) | (key[1] << 8) | key[2]
            tags += key + s.tag(k)
        rec["tags"] = tags
        seq = ["?"] * rl
        qual = [255] * rl
        cigar = []
        unmapped = bf & 4
        if unmapped and has_ba:
            if not cf & 8:
                seq = [chr(s.byte("BA")) for _ in range(rl)]
            mq = 0
        else:
            rp, rpos = 1, ap - 1
            bases = ref.get(refid, b"")

            def put(op, n):
                if n <= 0:
                    return
                if cigar and cigar[-1][0] == op:
                    cigar[-1][1] += n
                else:
                    cigar.append([op, n])

            def match(upto):
                nonlocal rp, rpos
                while rp < upto:
                    seq[rp - 1] = chr(bases[rpos]).upper()
                    put("M", 1)
                    rp += 1
                    rpos += 1

            fpos = 0
            for _ in range(s.int("FN")):
                code = chr(s.byte("FC"))
                fpos += s.int("FP")
                match(fpos)
                if code == "b":
                    for c in s.array("BB"):
                        seq[rp - 1] = chr(c)
                        put("M", 1)
                        rp += 1
                        rpos += 1
                elif code == "X":
                    base = chr(bases[rpos]).upper()
                    base = base if base in ORDER else "N"
                    seq[rp - 1] = subst[(base, s.byte("BS"))]
                    put("M", 1)
                    rp += 1
                    rpos += 1
                elif code == "B":
                    seq[rp - 1] = chr(s.byte("BA"))
                    qual[rp - 1] = s.byte("QS")
                    put("M", 1)
                    rp += 1
                    rpos += 1
                elif code in "IS":
                    for c in s.array("IN" if code == "I" else "SC"):
                        seq[rp - 1] = chr(c)
                        put(code, 1)
                        rp += 1
                elif code == "i":
                    seq[rp - 1] = chr(s.byte("BA"))
                    put("I", 1)
                    rp += 1
                elif code in "DN":
                    n = s.int("DL" if code == "D" else "RS")
                    put(code, n)
                    rpos += n
                elif code in "HP":
                    put(code, s.int("HC" if code == "H" else "PD"))
                elif code == "q":
                    qual[fpos - 1] = s.byte("QS")
                elif code == "Q":
                    for k, c in enumerate(s.array("QQ")):
                        qual[fpos - 1 + k] = c
                else:
                    raise ValueError(f"unknown read feature {code!r}")
            if unmapped:
                if rp <= rl:
                    raise ValueError("an unmapped read lacks bases")
            else:
                match(rl + 1)
            mq = s.int("MQ")
            if unmapped:
                cigar = []
        if cf & 1:
            qual = [s.byte("QS") for _ in range(rl)]
        rec.update(seq="".join(seq) if not cf & 8 else "", qual=qual,
                   cigar=cigar, mapq=mq, rl=rl)
        recs.append(rec)
    # attached mates
    for i, rec in enumerate(recs):
        j = rec["mate"]
        if j is None:
            continue
        if j >= len(recs):
            raise ValueError("a mate lies past the slice")
        m = recs[j]
        for a, b in ((rec, m), (m, rec)):
            a["next_refid"], a["next_pos"] = b["refid"], b["pos"]
            a["flag"] |= (0x20 if b["flag"] & 0x10 else 0) | \
                (0x8 if b["flag"] & 0x4 else 0)
        if not (rec["flag"] & 4) and not (m["flag"] & 4) and \
                rec["refid"] == m["refid"] and rec["refid"] >= 0:
            lo = min(rec["pos"], m["pos"])
            hi = max(_end(rec), _end(m))
            t = hi - lo
            up = rec["pos"] <= m["pos"]
            rec["tlen"], m["tlen"] = (t, -t) if up else (-t, t)
        else:
            rec["tlen"] = m["tlen"] = 0
    return recs


def _end(rec) -> int:
    span = sum(n for op, n in rec["cigar"] if op in REF_CONSUMING)
    return rec["pos"] + max(span, 1)


def _bam(rec) -> bytes:
    ops = "MIDNSHP=X"
    cig = b"".join(struct.pack("<I", (n << 4) | ops.index(op))
                   for op, n in rec["cigar"])
    codes = "=ACMGRSVTWYHKDBN"
    nib = [codes.index(c) if c in codes else 15 for c in rec["seq"]]
    if len(nib) % 2:
        nib.append(0)
    seq = bytes((nib[k] << 4) | nib[k + 1] for k in range(0, len(nib), 2))
    if rec["flag"] & 4:
        # unplaced: the bin of [0, 1), as the port derives it from CRAM
        b = reg2bin(max(rec["pos"], 0), max(rec["pos"], 0) + 1)
    else:
        b = reg2bin(rec["pos"], _end(rec))
    body = struct.pack(
        "<iiBBHHHiiii", rec["refid"], rec["pos"], len(rec["name"]) + 1,
        rec["mapq"], b, len(rec["cigar"]), rec["flag"], len(rec["seq"]),
        rec["next_refid"], rec["next_pos"], rec["tlen"]) + rec["name"] + \
        b"\x00" + cig + seq + bytes(rec["qual"] if rec["seq"] else []) + \
        rec["tags"]
    return struct.pack("<i", len(body)) + body


def decode(path: str, fasta: Dict[str, bytes]) -> dict:
    """The file's SAM header text, reference names and every record as
    BAM record bytes (``records``, in file order); ``fasta`` maps a
    reference name to its bases."""
    with open(path, "rb") as f:
        data = f.read()
    conts = _containers(data)
    first = next(conts)
    raw = _unpack(first["block_list"][0])
    (ln,) = struct.unpack_from("<i", raw, 0)
    text = raw[4:4 + ln].decode()
    names = [dict(x.split(":", 1) for x in line.split("\t")[1:])["SN"]
             for line in text.splitlines() if line.startswith("@SQ")]
    ref = {k: fasta[n].upper() for k, n in enumerate(names) if n in fasta}
    records = []
    for c in conts:
        blocks = c["block_list"]
        if not blocks or c["records"] == 0 and c["ref"] == -1 and \
                len(blocks) == 1:
            continue
        head = _header(_unpack(blocks[0]))
        k = 1
        for _ in c["landmarks"]:
            sr = Reader(_unpack(blocks[k]))
            sh = {"ref": sr.itf8(), "start": sr.itf8(), "span": sr.itf8(),
                  "records": sr.itf8(), "counter": sr.ltf8(),
                  "blocks": sr.itf8()}
            ext = {}
            for b in blocks[k + 1:k + 1 + sh["blocks"]]:
                if b["type"] == 4:
                    ext[b["cid"]] = _unpack(b)
            k += 1 + sh["blocks"]
            records += [_bam(r) for r in _slice(head, sh, ext, ref)]
    return {"header_text": text, "refs": names, "records": records}
