"""BAI (SAM spec §5.2, with the samtools/htsjdk metadata pseudo-bin
37450) of a coordinate-sorted BAM, from its decoded records and their
virtual offsets: the canonical build of a whole file, and the check of
an index by what it means.

``build(dec)`` indexes the whole file at once, by the canonical
encoder's rules:

- bins in ascending id order, the metadata bin last (for a reference
  that holds records);
- a (reference, bin) run of consecutive records makes one chunk, merged
  into the bin's previous chunk when it begins in the block where that
  chunk ends;
- the linear index holds, for each 16 KiB window a record overlaps, the
  least start offset of such a record; holes take the previous window's
  value and leading holes 0.

``violations(dec, data)`` judges an index of the same file however it
was laid out (in how many parts it was built, how its chunks were
merged, which of the two virtual offsets of a block boundary it wrote),
by what a reader relies on: every placed record lies inside a chunk of
its own bin; every chunk starts at a record of that bin and ends at the
end of one; every 16 KiB window that a record overlaps has a linear
entry no later than the first such record (0, "from the start", is the
entry a part's first record leaves in an index merged from parts, and
is no fault); the metadata pseudo-bin holds the reference's
first and last offsets and its mapped and unmapped counts; and the
unplaced count is the file's. ``record_counts(data)`` reads an index's
per-reference record counts and unplaced count alone.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

METADATA_BIN = 37450
LINEAR_SHIFT = 14
U64_MAX = np.iinfo(np.uint64).max


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = offset + (beg[hit] >> shift)
        done |= hit
    return out


class _Ref:
    def __init__(self) -> None:
        self.bins: Dict[int, List[Tuple[int, int]]] = {}
        self.meta = None          # (beg, end, mapped, unmapped)
        self.linear = np.zeros(0, np.uint64)   # 0 = no entry


def _add_chunk(chunks, beg: int, end: int) -> None:
    if chunks and beg >> 16 <= chunks[-1][1] >> 16:
        chunks[-1] = (chunks[-1][0], max(chunks[-1][1], end))
    else:
        chunks.append((beg, end))


def _index(refid, pos, aend, flag, vo, evo, n_ref):
    """The index of sorted records: per reference its bins' chunks, its
    metadata and its linear index; and the unplaced count."""
    refs = [_Ref() for _ in range(n_ref)]
    placed = refid >= 0
    no_coor = int((~placed).sum())
    rid = refid[placed].astype(np.int64)
    if not len(rid):
        return refs, no_coor
    if (np.diff(rid) < 0).any():
        raise ValueError("the records are not coordinate-sorted")
    rpos = pos[placed].astype(np.int64)
    rend = np.maximum(aend[placed], rpos + 1)
    rbin = reg2bin(rpos, rend)
    rvo, revo = vo[placed], evo[placed]
    unmapped = (flag[placed].astype(np.int64) & 0x4) != 0
    change = np.ones(len(rid), bool)
    change[1:] = (np.diff(rid) != 0) | (np.diff(rbin) != 0)
    first = np.nonzero(change)[0]
    last = np.append(first[1:], len(rid)) - 1
    for a, b in zip(first.tolist(), last.tolist()):
        _add_chunk(refs[int(rid[a])].bins.setdefault(int(rbin[a]), []),
                   int(rvo[a]), int(revo[b]))
    for r in np.unique(rid).tolist():
        sel = rid == r
        ref = refs[r]
        ref.meta = (int(rvo[sel].min()), int(revo[sel].max()),
                    int((~unmapped[sel]).sum()), int(unmapped[sel].sum()))
        lo = rpos[sel] >> LINEAR_SHIFT
        hi = (rend[sel] - 1) >> LINEAR_SHIFT
        lin = np.full(int(hi.max()) + 1, U64_MAX, np.uint64)
        v = rvo[sel]
        for w in range(int((hi - lo).max()) + 1):
            m = hi - lo >= w
            np.minimum.at(lin, lo[m] + w, v[m])
        hole = lin == U64_MAX
        # forward-fill holes; leading holes are 0
        idx = np.where(hole, -1, np.arange(len(lin)))
        np.maximum.accumulate(idx, out=idx)
        ref.linear = np.where(idx >= 0, lin[np.maximum(idx, 0)],
                              0).astype(np.uint64)
    return refs, no_coor


def _to_bytes(refs, no_coor: int) -> bytes:
    out = bytearray(b"BAI\x01" + struct.pack("<i", len(refs)))
    for r in refs:
        meta = r.meta is not None and (r.meta[2] or r.meta[3])
        out += struct.pack("<i", len(r.bins) + (1 if meta else 0))
        for b in sorted(r.bins):
            out += struct.pack("<Ii", b, len(r.bins[b]))
            for beg, end in r.bins[b]:
                out += struct.pack("<QQ", beg, end)
        if meta:
            out += struct.pack("<IiQQQQ", METADATA_BIN, 2, *r.meta)
        out += struct.pack("<i", len(r.linear))
        out += r.linear.astype("<u8").tobytes()
    out += struct.pack("<Q", no_coor)
    return bytes(out)


def build(dec) -> bytes:
    """The BAI of the whole decoded sorted BAM ``dec``."""
    return _to_bytes(*_index(dec.fixed["refid"], dec.fixed["pos"],
                             dec.alignment_ends(), dec.fixed["flag"],
                             dec.start_voffsets(), dec.end_voffsets(),
                             len(dec.refs)))


def parse(data: bytes):
    """``(refs, n_no_coor)``: per reference a dict of bin id to its
    (n, 2) uint64 chunks, the metadata pseudo-bin's 4 numbers or None,
    and the linear index; ``n_no_coor`` None when the file ends before
    it. Raises ValueError on a malformed index."""
    try:
        if data[:4] != b"BAI\x01":
            raise ValueError("no BAI magic")
        n_ref = struct.unpack_from("<i", data, 4)[0]
        p, refs = 8, []
        for _ in range(n_ref):
            n_bin = struct.unpack_from("<i", data, p)[0]
            p += 4
            bins, meta = {}, None
            for _ in range(n_bin):
                b, n = struct.unpack_from("<Ii", data, p)
                p += 8
                chunks = np.frombuffer(data, "<u8", 2 * n, p).reshape(n, 2)
                p += 16 * n
                if b == METADATA_BIN:
                    meta = tuple(int(x) for x in chunks.reshape(-1)[:4])
                elif b in bins:
                    raise ValueError(f"bin {b} listed twice")
                else:
                    bins[b] = chunks.astype(np.uint64)
            n_intv = struct.unpack_from("<i", data, p)[0]
            linear = np.frombuffer(data, "<u8", n_intv, p + 4)
            p += 4 + 8 * n_intv
            refs.append((bins, meta, linear.astype(np.uint64)))
        no_coor = struct.unpack_from("<Q", data, p)[0] \
            if len(data) >= p + 8 else None
    except struct.error as e:
        raise ValueError(f"truncated index: {e}") from None
    return refs, no_coor


def record_counts(data: bytes):
    """``(per-reference mapped + unmapped counts, n_no_coor)`` of an
    index, from its metadata pseudo-bins (0 where a reference has
    none)."""
    refs, no_coor = parse(data)
    return [meta[2] + meta[3] if meta else 0 for _, meta, _ in refs], no_coor


def _decoded_positions(dec, voff: np.ndarray) -> np.ndarray:
    """Virtual offsets as positions in the decoded stream; -1 where one
    names no block start or lies past its block's end."""
    voff = np.asarray(voff, np.uint64)
    c = (voff >> np.uint64(16)).astype(np.int64)
    off = (voff & np.uint64(0xFFFF)).astype(np.int64)
    i = np.minimum(np.searchsorted(dec.cstart, c), len(dec.cstart) - 1)
    ok = (dec.cstart[i] == c) & (off <= dec.usize[i])
    return np.where(ok, dec.ustart[i] + off, -1)


def _windows(pos: np.ndarray, end: np.ndarray, start: np.ndarray):
    """Per 16 KiB window that a record overlaps, the least record start
    (the decoded stream's position), -1 for windows no record overlaps."""
    lo = pos >> LINEAR_SHIFT
    hi = (end - 1) >> LINEAR_SHIFT
    least = np.full(int(hi.max()) + 1, np.iinfo(np.int64).max, np.int64)
    for w in range(int((hi - lo).max()) + 1):
        m = hi - lo >= w
        np.minimum.at(least, lo[m] + w, start[m])
    return np.where(least == np.iinfo(np.int64).max, -1, least)


def violations(dec, data: bytes) -> int:
    """Faults of ``data`` as the index of the decoded sorted BAM ``dec``
    (see the module's docstring): records outside their bin's chunks,
    chunks that do not start and end at records of their bin, windows
    whose linear entry is missing, names no offset or is later than
    their first record, wrong metadata numbers, a wrong reference or
    unplaced count. An index that cannot be parsed counts every record."""
    try:
        refs, no_coor = parse(data)
    except ValueError:
        return max(dec.count, 1)
    f = dec.fixed
    refid = f["refid"].astype(np.int64)
    bad = int(len(refs) != len(dec.refs))
    bad += int(no_coor != int((refid < 0).sum()))
    pos = f["pos"].astype(np.int64)
    aend = np.maximum(dec.alignment_ends(), pos + 1)
    unmapped = (f["flag"].astype(np.int64) & 0x4) != 0
    for r, (bins, meta, linear) in enumerate(refs):
        rows = np.nonzero(refid == r)[0]
        if not len(rows):
            bad += sum(len(c) for c in bins.values())
            bad += int(meta is not None and (meta[2] or meta[3]))
            continue
        s, e = dec.start[rows], dec.end[rows]
        rbin = reg2bin(pos[rows], aend[rows])
        # chunks, keyed by (bin, decoded position)
        cb = np.concatenate([np.full(len(c), b, np.int64)
                             for b, c in bins.items()] + [np.zeros(0, np.int64)])
        ch = np.concatenate([c for c in bins.values()]
                            + [np.zeros((0, 2), np.uint64)])
        beg = _decoded_positions(dec, ch[:, 0])
        end = _decoded_positions(dec, ch[:, 1])
        rec_s, rec_e = (rbin << 40) | s, (rbin << 40) | e
        good = (beg >= 0) & (end > beg) & np.isin((cb << 40) | beg, rec_s) \
            & np.isin((cb << 40) | end, rec_e)
        bad += int((~good).sum())
        # every record inside a chunk of its bin
        key = (cb << 40) | np.maximum(beg, 0)
        order = np.argsort(key, kind="stable")
        key, reach = key[order], np.maximum.accumulate(
            (cb[order] << 40) | np.maximum(end[order], 0))
        covered = np.zeros(len(rows), bool)
        if len(key):
            at = np.searchsorted(key, rec_s, side="right") - 1
            a = np.maximum(at, 0)
            covered = (at >= 0) & (cb[order][a] == rbin) & (reach[a] >= rec_e)
        bad += int((~covered).sum())
        # the linear index: a lower bound of each window's first record
        least = _windows(pos[rows], aend[rows], s)
        used = np.nonzero(least >= 0)[0]
        have = used[used < len(linear)]
        bad += len(used) - len(have)
        lin = _decoded_positions(dec, linear[have])
        bad += int(((lin < 0) | (lin > least[have])).sum())
        # the metadata pseudo-bin
        if meta is None:
            bad += 1
        else:
            mb, me = _decoded_positions(dec, np.array(meta[:2], np.uint64))
            bad += int(mb != s.min()) + int(me != e.max())
            bad += int(meta[2] != int((~unmapped[rows]).sum()))
            bad += int(meta[3] != int(unmapped[rows].sum()))
    return bad
