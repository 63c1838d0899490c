"""One CRAM 3.0 slice's records assembled column by column.

``assemble_slice`` decodes a slice whose data series are each EXTERNAL
over a block of their own (or a single-symbol HUFFMAN constant), with
byte arrays as BYTE_ARRAY_LEN or BYTE_ARRAY_STOP over such blocks: the
layout htslib, htsjdk and the port's own writer use. Each series'
values come out of its block in one pass, since a block that only one
series reads holds that series' values in record order; the counts
follow from the flags (mate series for detached records, NF for
records with a mate downstream, FN, the features and MQ for mapped
records, BA for unmapped ones). Sequences, CIGARs and qualities are
then rebuilt from the read features and the reference with array
operations, and attached mates resolved. A slice in any other layout
(CORE bit codecs, shared blocks, names not kept) returns None, and
``codec._decode_slice`` reads it record by record.

The rebuild follows htslib's decoder: bases between features match the
reference, a feature's position is where its read bases start, and a
feature behind the bases already placed (a ``q`` or ``Q`` inside a soft
clip) adds none. ``X`` takes the reference base's row of the
substitution matrix (A, C, G, T, and N for any other base). An attached
pair's mate reference and position, mate-reverse and mate-unmapped
flags and TLEN follow from the pair: TLEN spans both alignments when
both are mapped to one reference (the first record at the leftmost
position positive, the others negative) and is 0 otherwise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from disq_tpu_torch.bam.columnar import ReadBatch
from disq_tpu_torch.cram.codec import (
    _CHAR_TO_NT16, _SM_ROW, CF_DETACHED, CF_HAS_MATE_DOWNSTREAM,
    CF_QS_STORED, CF_UNKNOWN_BASES, E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP,
    E_EXTERNAL, E_HUFFMAN,
)
from disq_tpu_torch.cram.io import Cursor, itf8_table
from disq_tpu_torch.index.bai import bins_from_cigars
from disq_tpu_torch.runtime.errors import MissingReferenceError

# read feature code -> (CIGAR op or -1, bases it places: 0 none, 1 one,
# 2 its byte array's length, 3 its integer's length)
_FEATURES = {
    ord("b"): (0, 2), ord("X"): (0, 1), ord("B"): (0, 1), ord("I"): (1, 2),
    ord("i"): (1, 1), ord("S"): (4, 2), ord("D"): (2, 0), ord("N"): (3, 0),
    ord("H"): (5, 0), ord("P"): (6, 0), ord("q"): (-1, 0), ord("Q"): (-1, 0),
}
_OP = np.full(256, -2, np.int64)
_READS = np.zeros(256, np.int64)
for _c, (_op, _rd) in _FEATURES.items():
    _OP[_c] = _op
    _READS[_c] = _rd
_REF_OP = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], bool)   # M D N = X
# features that move a read's bases off a plain run of the reference
_SHIFTING = np.array([ord(c) for c in "IiSDNHP"])


class _Decline(Exception):
    """The slice is not in the columnar layout: read it record by
    record."""


def _offsets(lengths) -> np.ndarray:
    out = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=out[1:])
    return out


def _ragged_index(starts, lengths) -> np.ndarray:
    lengths = np.asarray(lengths, np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    return np.repeat(np.asarray(starts, np.int64) - _offsets(lengths)[:-1],
                     lengths) + np.arange(total, dtype=np.int64)


def _rank(group: np.ndarray) -> np.ndarray:
    """0, 1, ... within each run of equal values of ``group``."""
    if not len(group):
        return np.zeros(0, np.int64)
    idx = np.arange(len(group))
    first = np.r_[True, group[1:] != group[:-1]]
    return idx - np.maximum.accumulate(np.where(first, idx, 0))


def itf8_values(data, count: int) -> np.ndarray:
    """Exactly ``count`` ITF8 values that fill ``data`` (a block only one
    series reads); raises ``_Decline`` when they do not."""
    a = np.frombuffer(data, np.uint8)
    if count == 0:
        if len(a):
            raise _Decline
        return np.zeros(0, np.int64)
    if len(a) == count and (a < 0x80).all():
        return a.astype(np.int64)
    v, nb = itf8_table(data)
    n = len(a)
    nb = nb.astype(np.int64)
    # the k-th value starts where k jumps from 0 lead (jumps doubled)
    jump = np.append(np.minimum(np.arange(n) + nb, n), n)
    at = np.zeros(count, np.int64)
    k = np.arange(count)
    bit = 0
    while (1 << bit) < count:
        m = ((k >> bit) & 1) == 1
        at[m] = jump[at[m]]
        jump = jump[jump]
        bit += 1
    if at[-1] >= n or at[-1] + nb[at[-1]] != n:
        raise _Decline
    return v[at].astype(np.int64)


class _Series:
    """The slice's blocks read through the compression header's
    encodings, one series (block) at a time."""

    def __init__(self, comp, blocks: Dict[int, bytes]) -> None:
        self.enc = comp.series_enc
        self.tag_enc = comp.tag_enc
        self.blocks = blocks
        readers: Dict[int, int] = {}
        for e in list(self.enc.values()) + list(self.tag_enc.values()):
            for cid in _cids(e):
                readers[cid] = readers.get(cid, 0) + 1
        self.readers = readers

    def _block(self, cid: int) -> bytes:
        if self.readers.get(cid) != 1 or cid not in self.blocks:
            raise _Decline
        return self.blocks[cid]

    def _ints(self, e, count: int) -> np.ndarray:
        if count == 0:
            return np.zeros(0, np.int64)
        if e is None:
            raise _Decline
        if e.codec == E_HUFFMAN and len(e.params[0]) == 1:
            return np.full(count, e.params[0][0], np.int64)
        if e.codec != E_EXTERNAL:
            raise _Decline
        return itf8_values(self._block(e.params), count)

    def ints(self, key: str, count: int) -> np.ndarray:
        return self._ints(self.enc.get(key), count)

    def bytes_(self, key: str, count: int) -> np.ndarray:
        e = self.enc.get(key)
        if count == 0:
            return np.zeros(0, np.uint8)
        if e is None:
            raise _Decline
        if e.codec == E_HUFFMAN and len(e.params[0]) == 1:
            return np.full(count, e.params[0][0], np.uint8)
        if e.codec != E_EXTERNAL:
            raise _Decline
        data = np.frombuffer(self._block(e.params), np.uint8)
        if len(data) != count:
            raise _Decline
        return data

    def arrays(self, e, count: int) -> Tuple[np.ndarray, np.ndarray]:
        """``count`` byte arrays: (flat bytes, offsets)."""
        if count == 0:
            return np.zeros(0, np.uint8), np.zeros(1, np.int64)
        if e is None:
            raise _Decline
        if e.codec == E_BYTE_ARRAY_STOP:
            stop, cid = e.params
            data = np.frombuffer(self._block(cid), np.uint8)
            ends = np.flatnonzero(data == stop)
            if len(ends) != count or ends[-1] != len(data) - 1:
                raise _Decline
            starts = np.r_[0, ends[:-1] + 1]
            keep = np.ones(len(data), bool)
            keep[ends] = False
            return data[keep], _offsets(ends - starts)
        if e.codec != E_BYTE_ARRAY_LEN:
            raise _Decline
        len_e, val_e = e.params
        if len_e.codec == E_EXTERNAL and val_e.codec == E_EXTERNAL \
                and len_e.params == val_e.params:
            return self._interleaved(len_e.params, count)
        if val_e.codec != E_EXTERNAL:
            raise _Decline
        lens = self._ints(len_e, count)
        data = np.frombuffer(self._block(val_e.params), np.uint8)
        if (lens < 0).any() or int(lens.sum()) != len(data):
            raise _Decline
        return data, _offsets(lens)

    def _interleaved(self, cid: int, count: int):
        """(ITF8 length, bytes) pairs in one block (BYTE_ARRAY_LEN with
        both parts on one block, as the port writes tag values)."""
        if self.readers.get(cid) != 2 or cid not in self.blocks:
            raise _Decline
        data = self.blocks[cid]
        cur = Cursor(data, itf8_table=True)
        try:
            items = cur.len_prefixed_bulk(count)
        except IndexError:
            raise _Decline from None
        if cur.off != len(data):
            raise _Decline
        lens = np.array([len(x) for x in items], np.int64)
        return np.frombuffer(b"".join(items), np.uint8), _offsets(lens)


def _cids(e) -> List[int]:
    if e.codec == E_EXTERNAL:
        return [e.params]
    if e.codec == E_BYTE_ARRAY_STOP:
        return [e.params[1]]
    if e.codec == E_BYTE_ARRAY_LEN:
        return _cids(e.params[0]) + _cids(e.params[1])
    return []


def _tags(sr: _Series, lines, tl: np.ndarray):
    """Each record's tag bytes (key and value of each tag of its TD
    line, in line order): (flat, offsets)."""
    n = len(tl)
    if n and (tl.min() < 0 or tl.max() >= len(lines)):
        raise ValueError(f"tag line index out of range (TL max {tl.max()})")
    keys = sorted({k for line in lines for k in line})
    has = {k: np.zeros(n, bool) for k in keys}
    for li, line in enumerate(lines):
        on = tl == li
        for k in line:
            has[k] |= on
    pieces_src: List[np.ndarray] = []
    base = 0
    key_at, val = {}, {}
    for k in keys:
        kb = np.array([(k >> 16) & 0xFF, (k >> 8) & 0xFF, k & 0xFF], np.uint8)
        flat, off = sr.arrays(sr.tag_enc.get(k), int(has[k].sum()))
        key_at[k] = base
        pieces_src.append(kb)
        base += 3
        val[k] = (base, off, np.cumsum(has[k]) - 1)
        pieces_src.append(flat)
        base += len(flat)
    src = np.concatenate(pieces_src) if pieces_src else np.zeros(0, np.uint8)
    rec, slot, start, length = [], [], [], []
    for li, line in enumerate(lines):
        recs = np.flatnonzero(tl == li)
        for j, k in enumerate(line):
            vbase, off, rank = val[k]
            r = rank[recs]
            for part, (st, ln) in enumerate((
                    (np.full(len(recs), key_at[k]), np.full(len(recs), 3)),
                    (vbase + off[r], off[r + 1] - off[r]))):
                rec.append(recs)
                slot.append(np.full(len(recs), 2 * j + part))
                start.append(st)
                length.append(ln)
    if not rec:
        return np.zeros(0, np.uint8), np.zeros(n + 1, np.int64)
    rec, slot, start, length = (np.concatenate(x) for x in
                                (rec, slot, start, length))
    order = np.lexsort((slot, rec))
    flat = src[_ragged_index(start[order], length[order])]
    per = np.bincount(rec, weights=length, minlength=n).astype(np.int64)
    return flat, _offsets(per)


def _reference(ref_fetch, refid: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """One reference buffer covering [lo, hi) of each listed reference:
    (bytes as uint8, offset of each position's reference in it)."""
    if ref_fetch is None:
        raise MissingReferenceError(
            "reference required to decode this CRAM slice "
            "(set reference_source_path)")
    parts, base = [], {}
    at = 0
    for rid in np.unique(refid).tolist():
        on = refid == rid
        a, b = int(lo[on].min()), int(hi[on].max())
        rb = ref_fetch(int(rid), a, b - a)
        if rb is None or len(rb) < b - a:
            raise MissingReferenceError(
                f"reference contig for refid {int(rid)} is missing or too "
                f"short in the configured FASTA")
        parts.append(np.frombuffer(rb, np.uint8)[:b - a])
        base[rid] = at - a
        at += b - a
    return np.concatenate(parts), base


def assemble_slice(slice_hdr, comp, blocks: Dict[int, bytes], core,
                   ref_fetch) -> Optional[Tuple[ReadBatch, dict]]:
    """The slice's records, or None when its layout is not columnar.
    Also returns the books: feature counts by code and mate counts."""
    if core or not comp.rn_preserved:
        return None
    try:
        return _assemble(slice_hdr, comp, blocks, ref_fetch)
    except _Decline:
        return None


def _assemble(slice_hdr, comp, blocks, ref_fetch):
    sr = _Series(comp, blocks)
    n = slice_hdr.n_records
    multi = slice_hdr.ref_seq_id == -2
    bf = sr.ints("BF", n)
    cf = sr.ints("CF", n)
    refid = sr.ints("RI", n) if multi else \
        np.full(n, slice_hdr.ref_seq_id, np.int64)
    rl = sr.ints("RL", n)
    ap = sr.ints("AP", n)
    if comp.ap_delta:
        ap = slice_hdr.ref_start + np.cumsum(ap)
    sr.ints("RG", n)
    names, name_off = sr.arrays(sr.enc.get("RN"), n)
    det = (cf & CF_DETACHED) != 0
    down = ~det & ((cf & CF_HAS_MATE_DOWNSTREAM) != 0)
    nd = int(det.sum())
    sr.ints("MF", nd)
    ns, npos, ts = (sr.ints(k, nd) for k in ("NS", "NP", "TS"))
    nf = sr.ints("NF", int(down.sum()))
    tl = sr.ints("TL", n)
    tags, tag_off = _tags(sr, comp.tag_lines, tl)
    unmapped = (bf & 4) != 0
    spec_unmapped = unmapped & ("BA" in sr.enc)
    carries = ~spec_unmapped                 # FN, features and MQ
    fn = sr.ints("FN", int(carries.sum()))
    if (fn < 0).any():
        raise _Decline
    fn_all = np.zeros(n, np.int64)
    fn_all[carries] = fn
    F = int(fn.sum())
    fc = sr.bytes_("FC", F).astype(np.int64)
    fp = sr.ints("FP", F)
    if (_OP[fc] == -2).any():
        bad = int(fc[_OP[fc] == -2][0])
        raise ValueError(f"unsupported read feature {chr(bad)!r}")
    frec = np.repeat(np.arange(n), fn_all)
    code_n = {c: int((fc == c).sum()) for c in _FEATURES}

    def sel(c):
        return np.flatnonzero(fc == c)

    # per-feature integers and byte arrays
    fint = np.zeros(F, np.int64)
    for c, key in ((ord("D"), "DL"), (ord("N"), "RS"), (ord("H"), "HC"),
                   (ord("P"), "PD")):
        fint[sel(c)] = sr.ints(key, code_n[c])
    bs = sr.bytes_("BS", code_n[ord("X")])
    arr_at = np.zeros(F, np.int64)
    arr_len = np.zeros(F, np.int64)
    arr_src = []
    src_base = 0
    for c, key in ((ord("b"), "BB"), (ord("I"), "IN"), (ord("S"), "SC"),
                   (ord("Q"), "QQ")):
        flat, off = sr.arrays(sr.enc.get(key), code_n[c])
        k = sel(c)
        arr_at[k] = src_base + off[:-1]
        arr_len[k] = np.diff(off)
        arr_src.append(flat)
        src_base += len(flat)
    arr = np.concatenate(arr_src) if arr_src else np.zeros(0, np.uint8)
    mq = sr.ints("MQ", int(carries.sum()))
    # BA: per record its B and i features' bases, or an unmapped read's
    # bases; QS: its B and q features' qualities, then its qualities
    uses_ba = (fc == ord("B")) | (fc == ord("i"))
    uses_qs = (fc == ord("B")) | (fc == ord("q"))
    nba_f = np.bincount(frec[uses_ba], minlength=n)
    nqs_f = np.bincount(frec[uses_qs], minlength=n)
    unknown = (cf & CF_UNKNOWN_BASES) != 0
    if ((unknown & (rl > 0)) | (unknown & (fn_all > 0))).any():
        raise _Decline
    ba_len = nba_f + np.where(spec_unmapped & ~unknown, rl, 0)
    stored = (cf & CF_QS_STORED) != 0
    qs_len = nqs_f + np.where(stored, rl, 0)
    ba = sr.bytes_("BA", int(ba_len.sum()))
    qs = sr.bytes_("QS", int(qs_len.sum()))
    ba_off, qs_off = _offsets(ba_len), _offsets(qs_len)
    fbyte = np.zeros(F, np.int64)          # a B or i base, a B or q quality
    k = np.flatnonzero(uses_ba)
    fbase = np.zeros(F, np.int64)
    fbase[k] = ba[ba_off[frec[k]] + _rank(frec[k])]
    k = np.flatnonzero(uses_qs)
    fbyte[k] = qs[qs_off[frec[k]] + _rank(frec[k])]

    # where each feature lies: read position, bases placed before it
    pos0 = ap - 1
    fpos = np.cumsum(fp)
    fstart = _offsets(fn_all)
    if F:
        fpos -= np.repeat(np.r_[0, fpos][fstart[:-1]], fn_all)
    kind = _READS[fc]
    places = np.where(kind == 1, 1, np.where(kind == 2, arr_len, 0))
    end = fpos + places
    # bases placed before each feature: the running maximum of the ends
    # before it in its record (at least 1)
    big = np.int64(1) << 40
    keyed = frec * big + np.maximum(end, 1)
    before = np.maximum.accumulate(np.r_[np.int64(-1), keyed[:-1]]) - \
        frec * big
    first_f = np.zeros(F, bool)
    first_f[fstart[:-1][fn_all > 0]] = True
    rp = np.where(first_f, 1, np.maximum(before, 1))
    gap = np.maximum(fpos - rp, 0)
    at = rp + gap                            # where its bases go (1-based)
    op = _OP[fc]
    clen = np.where(kind == 0, np.where(op >= 0, fint, 0), places)
    refc = np.where((op >= 0) & _REF_OP[np.maximum(op, 0)], clen, 0)
    fref = np.zeros(F, np.int64)             # reference consumed before it
    if F:
        cr = np.cumsum(gap + refc) - (gap + refc) + gap
        fref = cr - np.repeat(np.r_[0, np.cumsum(gap + refc)][fstart[:-1]],
                              fn_all)
    last_end = np.ones(n, np.int64)
    ref_used = np.zeros(n, np.int64)
    if F:
        has = fn_all > 0
        lastf = fstart[1:][has] - 1
        last_end[has] = np.maximum(at[lastf] + places[lastf],
                                   np.maximum.reduceat(
                                       np.maximum(end, 1), fstart[:-1][has]))
        ref_used[has] = fref[lastf] + refc[lastf]
    tail = np.where(unmapped, 0, np.maximum(rl - (last_end - 1), 0))
    if (unmapped & ~spec_unmapped & ~unknown & (rl - (last_end - 1) > 0)).any():
        raise ValueError("unmapped record with missing base features")
    if (unmapped[frec] & (gap > 0)).any():
        raise _Decline
    # bases: runs that match the reference, then the features' own. In
    # a slice of one read length, a record whose features keep its
    # alignment whole (none of I i S D N H P) takes one reference row
    seq_off = _offsets(np.where(unknown, 0, rl))
    seqs = np.zeros(int(seq_off[-1]), np.uint8)
    rows = np.zeros(n, bool)
    if n and not unknown.any() and (rl == rl[0]).all() and rl[0] > 0:
        shifting = np.isin(fc, _SHIFTING)
        rows = ~unmapped & (np.bincount(frec[shifting], minlength=n) == 0) \
            & ((np.bincount(frec[gap > 0], minlength=n) > 0) | (tail > 0))
    run = (gap > 0) & ~rows[frec]
    tails = (tail > 0) & ~rows
    m_rec = np.r_[frec[run], np.flatnonzero(tails)]
    m_read = np.r_[rp[run], last_end[tails]]
    m_ref = np.r_[pos0[frec[run]] + fref[run] - gap[run],
                  pos0[tails] + ref_used[tails]]
    m_len = np.r_[gap[run], tail[tails]]
    x = np.flatnonzero(fc == ord("X"))
    ri = np.flatnonzero(rows)
    need_rec = np.r_[m_rec, frec[x], ri]
    if len(need_rec):
        need_lo = np.r_[m_ref, pos0[frec[x]] + fref[x], pos0[ri]]
        need_hi = need_lo + np.r_[m_len, np.ones(len(x), np.int64),
                                  rl[ri]]
        ref, rbase = _reference(ref_fetch, refid[need_rec], need_lo, need_hi)
        off_of = np.array([rbase[r] for r in refid[need_rec].tolist()],
                          np.int64)
        idx = _ragged_index(off_of[:len(m_rec)] + m_ref, m_len)
        seqs[_ragged_index(seq_off[m_rec] + m_read - 1, m_len)] = \
            _CHAR_TO_NT16[ref[idx]]
        if len(ri):
            win = np.lib.stride_tricks.sliding_window_view(ref, int(rl[0]))
            seqs.reshape(n, -1)[ri] = _CHAR_TO_NT16[
                win[off_of[len(m_rec) + len(x):] + pos0[ri]]]
        if len(x):
            if comp.substitutions is None:
                raise ValueError("X read feature without a substitution "
                                 "matrix")
            xo = off_of[len(m_rec):len(m_rec) + len(x)]
            rbases = ref[xo + pos0[frec[x]] + fref[x]]
            sub = comp.substitutions[_SM_ROW[rbases], bs.astype(np.int64)]
            seqs[seq_off[frec[x]] + at[x] - 1] = _CHAR_TO_NT16[sub]
    k = np.flatnonzero((fc == ord("b")) | (fc == ord("I")) |
                       (fc == ord("S")))
    seqs[_ragged_index(seq_off[frec[k]] + at[k] - 1, arr_len[k])] = \
        _CHAR_TO_NT16[arr[_ragged_index(arr_at[k], arr_len[k])]]
    k = np.flatnonzero(uses_ba)
    seqs[seq_off[frec[k]] + at[k] - 1] = _CHAR_TO_NT16[fbase[k].astype(
        np.uint8)]
    su = np.flatnonzero(spec_unmapped & ~unknown)
    seqs[_ragged_index(seq_off[su], rl[su])] = _CHAR_TO_NT16[ba[
        _ragged_index(ba_off[su] + nba_f[su], rl[su])]]
    # qualities: stored, or 255 with the features' qualities
    qual_off = seq_off
    st = stored & ~unknown
    if st.all() and not uses_qs.any() and len(qs) == len(seqs):
        quals = qs
    else:
        quals = np.full(len(seqs), 255, np.uint8)
        lossy = ~stored[frec]
        k = np.flatnonzero(lossy & uses_qs)
        quals[qual_off[frec[k]] + fpos[k] - 1] = fbyte[k]
        k = np.flatnonzero(lossy & (fc == ord("Q")))
        quals[_ragged_index(qual_off[frec[k]] + fpos[k] - 1, arr_len[k])] = \
            arr[_ragged_index(arr_at[k], arr_len[k])]
        k = np.flatnonzero(st)
        quals[_ragged_index(qual_off[k], rl[k])] = qs[
            _ragged_index(qs_off[k] + nqs_f[k], rl[k])]
    # CIGAR: per feature a matching run before it and its own op, then
    # each record's tail; runs of one op merged; none when unmapped
    c_rec = np.r_[np.repeat(frec, 2), np.flatnonzero(tail > 0)]
    c_op = np.r_[np.stack([np.zeros(F, np.int64), op], 1).reshape(-1),
                 np.zeros(int((tail > 0).sum()), np.int64)]
    c_len = np.r_[np.stack([gap, clen], 1).reshape(-1), tail[tail > 0]]
    order = np.argsort(c_rec, kind="stable")
    c_rec, c_op, c_len = c_rec[order], c_op[order], c_len[order]
    keep = (c_op >= 0) & (c_len > 0) & ~unmapped[c_rec]
    c_rec, c_op, c_len = c_rec[keep], c_op[keep], c_len[keep]
    if len(c_rec):
        head = np.r_[True, (c_rec[1:] != c_rec[:-1]) | (c_op[1:] != c_op[:-1])]
        starts = np.flatnonzero(head)
        c_len = np.add.reduceat(c_len, starts)
        c_rec, c_op = c_rec[starts], c_op[starts]
    cigars = ((c_len << 4) | c_op).astype(np.uint32)
    cigar_off = _offsets(np.bincount(c_rec, minlength=n))
    # mates
    flag = bf.copy()
    next_refid = np.full(n, -1, np.int64)
    next_pos = np.full(n, -1, np.int64)
    tlen = np.zeros(n, np.int64)
    di = np.flatnonzero(det)
    next_refid[di], next_pos[di], tlen[di] = ns, npos - 1, ts
    attached = 0
    ui = np.flatnonzero(down)
    if len(ui):
        span = np.zeros(n, np.int64)
        np.add.at(span, c_rec, np.where(_REF_OP[c_op], c_len, 0))
        attached = _mates(ui, ui + nf + 1, n, refid, pos0, pos0 + np.maximum(
            span, 1), flag, next_refid, next_pos, tlen)
    pos_l = pos0.astype(np.int32)
    bins = bins_from_cigars(cigars, cigar_off, pos_l).astype(np.uint16)
    batch = ReadBatch(
        refid=refid.astype(np.int32), pos=pos_l,
        mapq=np.where(spec_unmapped, 0, _scatter(mq, carries)).astype(
            np.uint8),
        bin=bins, flag=flag.astype(np.uint16),
        next_refid=next_refid.astype(np.int32),
        next_pos=next_pos.astype(np.int32), tlen=tlen.astype(np.int32),
        name_offsets=name_off, names=names,
        cigar_offsets=cigar_off, cigars=cigars,
        seq_offsets=seq_off, seqs=seqs, quals=quals,
        tag_offsets=tag_off, tags=tags,
    )
    books = {"features": {chr(c): v for c, v in code_n.items() if v},
             "attached": attached, "detached": nd}
    return batch, books


def _scatter(values: np.ndarray, where: np.ndarray) -> np.ndarray:
    out = np.zeros(len(where), np.int64)
    out[where] = values
    return out


def _mates(ups, downs, n, refid, pos, end, flag, next_refid, next_pos,
           tlen) -> int:
    """Resolve attached mates in place: each record with a mate
    downstream takes its mate's reference, position and strand and
    unmapped flags, the last of a chain those of the first; TLEN spans a
    chain whose records all map to one reference. Returns the records
    in attached chains."""
    if (downs >= n).any():
        raise ValueError("a CRAM mate record lies past the end of its slice")
    nxt = np.full(n, -1, np.int64)
    nxt[ups] = downs
    prv = np.full(n, -1, np.int64)
    prv[downs] = ups
    members = np.unique(np.r_[ups, downs])
    head = members.copy()
    while True:
        p = prv[head]
        more = p >= 0
        if not more.any():
            break
        head[more] = p[more]
    mate = nxt[members]
    last = mate < 0
    mate[last] = head[last]
    next_refid[members] = refid[mate]
    next_pos[members] = pos[mate]
    flag[members] |= np.where(flag[mate] & 0x10, 0x20, 0) | \
        np.where(flag[mate] & 0x4, 0x8, 0)
    # TLEN over each chain
    chain = np.searchsorted(np.unique(head), head)
    k = chain.max() + 1
    lo = np.full(k, np.iinfo(np.int64).max)
    hi = np.full(k, np.iinfo(np.int64).min)
    np.minimum.at(lo, chain, pos[members])
    np.maximum.at(hi, chain, end[members])
    ok = np.ones(k, bool)
    np.logical_and.at(ok, chain, (flag[members] & 4) == 0)
    rid = refid[members]
    r0 = np.full(k, -1, np.int64)
    r0[chain] = rid
    np.logical_and.at(ok, chain, (rid == r0[chain]) & (rid >= 0))
    t = hi - lo
    at_left = pos[members] == lo[chain]
    first_left = np.zeros(len(members), bool)
    cand = np.flatnonzero(at_left)
    _, firsts = np.unique(chain[cand], return_index=True)
    first_left[cand[firsts]] = True
    tlen[members] = np.where(ok[chain], np.where(first_left, 1, -1) *
                             t[chain], 0)
    return len(members)
