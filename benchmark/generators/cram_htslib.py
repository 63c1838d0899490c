"""CRAM 3.0 files in htslib's layout, made from a seed, with the BAM
records they stand for (the truth).

A coordinate-sorted 30x genome's paired 2x150 bp reads over one contig
region (``reads_bam.synthesize``'s flags, positions and CIGARs; TLEN
and the unmapped mate's mate-reverse bit made consistent with the
mates, as an aligner sets them), read from a seeded random reference
(with short N gaps) through a seeded diploid variant set (SNVs, and
indels on reads whose CIGAR is one M), with per-base substitution
errors, NovaSeq's four binned quality values and an N at some quality-2
bases. The CRAM holds them as htslib writes them:

- 10,000 records per slice, one slice per container (a new one where
  the reference changes), AP as a delta, read names kept, qualities
  stored, one ``RG:Z`` tag through the TD dictionary;
- mates attached (CF 0x4, NF) where both primary reads of a pair lie
  in one slice and TLEN, the mate's reference and position and the
  mate flags follow from the pair (BF then leaves out 0x8 and 0x20);
  every other record detached (CF 0x2: MF, NS, NP, TS);
- a mapped read as read features: ``S``, ``I``/``i``, ``D``, ``N``,
  ``H``, ``P`` from its CIGAR, ``X`` for a substitution (the base by its
  code in the container's substitution matrix, SM, codes by frequency),
  ``B`` (BA and QS) where neither base is A, C, G or T; an unmapped one
  as BA bases; ``b``, ``q`` and ``Q`` where a record asks for them
  (``write_cram``'s ``style``);
- integer series EXTERNAL, one block each, or single-symbol HUFFMAN
  where a container's values are all one; RN BYTE_ARRAY_STOP; BB, IN, SC
  and QQ BYTE_ARRAY_LEN; the tag BYTE_ARRAY_STOP on a tab;
- QS blocks rANS order-1, RN gzip, every other external block rANS
  order-0 (4x8, 12-bit frequencies), encoded in NumPy across all of a
  file's streams at once.

``make`` also writes the reference FASTA and ``.fai`` and the ``.crai``.
Nothing here imports the program; ``reference/cram.py`` decodes the
files independently.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from benchmark.generators import reads_bam
from benchmark.reference.bai import reg2bin
from benchmark.reference.sort import stable_order

SLICE_RECORDS = 10_000
QUALS = np.array([2, 12, 23, 37], np.uint8)
QUAL_P = np.array([0.02, 0.05, 0.08, 0.85])
QUAL_TABLE = np.repeat(QUALS, (QUAL_P * 200).astype(int))   # 200 slots
READ_LEN = reads_bam.READ_LEN
N_SHARE_AT_Q2 = 0.1          # of quality-2 bases, called N
BASES = np.frombuffer(b"ACGT", np.uint8)
RG_NAME = b"NA12878.1"
EOF_CONTAINER = bytes.fromhex(
    "0f000000ffffffff0fe0454f4600000000010005bdd94f0001000606010001"
    "000100ee63014b")

# content ids of the data series' external blocks
CID = {k: i + 1 for i, k in enumerate(
    ["BF", "CF", "RL", "AP", "RG", "RN", "MF", "NS", "NP", "TS", "NF", "TL",
     "FN", "FC", "FP", "BS", "IN_LEN", "IN", "SC_LEN", "SC", "DL", "RS", "HC",
     "PD", "BA", "QS", "MQ", "BB_LEN", "BB", "QQ_LEN", "QQ"])}
RG_KEY = (ord("R") << 16) | (ord("G") << 8) | ord("Z")

# CIGAR ops M I D N S H P = X: which consume the read, the reference
READ_OPS = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], bool)
REF_OPS = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], bool)


# -- ITF8, LTF8 --------------------------------------------------------------

def itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    return bytes([0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
                  (v >> 4) & 0xFF, v & 0x0F])


def itf8_bytes(values):
    """(bytes, per-value byte offsets with a final end) of the ITF8
    encoding of ``values``."""
    v = np.asarray(values, np.int64).astype(np.uint32).astype(np.uint64)
    ln = np.select([v < 0x80, v < 0x4000, v < 0x200000, v < 0x10000000],
                   [1, 2, 3, 4], 5).astype(np.int64)
    off = np.zeros(len(v) + 1, np.int64)
    np.cumsum(ln, out=off[1:])
    out = np.zeros(int(off[-1]), np.uint8)
    at = off[:-1]
    for n, first, shifts in (
            (1, 0x00, [0]), (2, 0x80, [8, 0]), (3, 0xC0, [16, 8, 0]),
            (4, 0xE0, [24, 16, 8, 0])):
        m = ln == n
        for k, s in enumerate(shifts):
            byte = (v[m] >> np.uint64(s)) & np.uint64(0xFF)
            if k == 0:
                byte |= np.uint64(first)
            out[at[m] + k] = byte
    m = ln == 5
    for k, s in enumerate([28, 20, 12, 4]):
        byte = (v[m] >> np.uint64(s)) & np.uint64(0xFF)
        if k == 0:
            byte = (byte & np.uint64(0x0F)) | np.uint64(0xF0)
        out[at[m] + k] = byte
    out[at[m] + 4] = v[m] & np.uint64(0x0F)
    return out, off


def ltf8(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    return bytes([0xF0]) + v.to_bytes(8, "big")[4:] if v < 1 << 32 else \
        bytes([0xFF]) + v.to_bytes(8, "big")


# -- rANS 4x8, order 0 and order 1 ------------------------------------------

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT
RANS_LOW = 1 << 23


def normalize(counts: np.ndarray) -> np.ndarray:
    """Counts scaled to sum 4096, each present symbol at least 1; the
    largest absorbs the rounding."""
    counts = np.asarray(counts, np.int64)
    total = counts.sum()
    f = counts * TOTFREQ // max(total, 1)
    f[(counts > 0) & (f == 0)] = 1
    f[int(np.argmax(f))] += TOTFREQ - f.sum()
    return f


def _freqs0(freqs: np.ndarray) -> bytes:
    """An order-0 frequency table: each present symbol, a run count after
    a symbol that follows its predecessor, the frequency in one byte or
    two (high bit set), then 0."""
    out = bytearray()
    syms = np.flatnonzero(freqs).tolist()
    rle = 0
    for k, s in enumerate(syms):
        if rle:
            rle -= 1
        else:
            out.append(s)
            if k and syms[k - 1] == s - 1:
                run = 0
                while k + run + 1 < len(syms) and syms[k + run + 1] == s + run + 1:
                    run += 1
                out.append(run)
                rle = run
        f = int(freqs[s])
        out += bytes([f]) if f < 128 else bytes([0x80 | (f >> 8), f & 0xFF])
    out.append(0)
    return bytes(out)


def _freqs1(freqs: np.ndarray) -> bytes:
    """An order-1 table: the contexts as ``_freqs0`` lists symbols, each
    followed by its order-0 table, then 0."""
    out = bytearray()
    ctxs = np.flatnonzero(freqs.sum(axis=1)).tolist()
    rle = 0
    for k, c in enumerate(ctxs):
        if rle:
            rle -= 1
        else:
            out.append(c)
            if k and ctxs[k - 1] == c - 1:
                run = 0
                while k + run + 1 < len(ctxs) and ctxs[k + run + 1] == c + run + 1:
                    run += 1
                out.append(run)
                rle = run
        out += _freqs0(freqs[c])
    out.append(0)
    return bytes(out)


def _lanes(data: List[np.ndarray], order: int):
    """Per stream and state: where its symbols start in the joined data,
    how many it has, and the step each symbol is coded in."""
    n = np.array([len(d) for d in data], np.int64)
    base = np.zeros(len(data), np.int64)
    np.cumsum(n[:-1], out=base[1:])
    if order == 0:
        # symbol p of a stream belongs to state p & 3, step p >> 2
        length = np.stack([(n - j + 3) // 4 for j in range(4)], 1)
        start = base[:, None] + np.arange(4)[None, :]
        stride = 4
    else:
        q = n // 4
        length = np.stack([q, q, q, n - 3 * q], 1)
        start = base[:, None] + np.arange(4)[None, :] * q[:, None]
        stride = 1
    return start, length, stride


POOL_BYTES = 4 << 20        # below this, streams are coded in-process
LONG = 1 << 16               # a stream this long is a task's worth alone


def rans_encode(streams: Sequence[bytes], order) -> List[bytes]:
    """Each stream rANS 4x8 coded at its ``order`` (one for all, or one
    per stream): header, table, the four final states, the
    renormalisation bytes. Streams of one order and like length are
    stepped together (``_rans_group``). The step loop's cost is in its
    steps, not its lanes, so with much to code the groups run in forked
    worker processes, a group of long streams split over all of them."""
    return rans_collect(rans_start(streams, order))


def rans_start(streams: Sequence[bytes], order):
    """``rans_encode`` begun: in forked processes when there is much to
    code (their results are waited for in ``rans_collect``), else at
    once."""
    orders = [order] * len(streams) if isinstance(order, int) else order
    lens = np.array([len(x) for x in streams], np.int64)
    group = np.floor(np.log2(lens + 1)).astype(np.int64) * 2 + \
        np.array(orders, np.int64)
    workers = os.cpu_count() or 1
    big = int(lens.sum()) >= POOL_BYTES and workers > 1
    tasks = []
    for g in np.unique(group):
        idx = np.flatnonzero(group == g)
        parts = min(len(idx), workers) if big and lens[idx].max() >= LONG \
            else 1
        tasks += [t for t in np.array_split(idx, parts) if len(t)]
    if not big:
        return len(streams), tasks, [_rans_group(*_task(streams, orders, t))
                                     for t in tasks]
    cost = [int(lens[t].max()) for t in tasks]
    return len(streams), tasks, _fork_start(
        lambda k: _rans_group(*_task(streams, orders, tasks[k])), cost,
        workers)


def rans_collect(started) -> List[bytes]:
    n, tasks, coded = started
    if not isinstance(coded, list):
        coded = _fork_collect(coded)
    out: List[Optional[bytes]] = [None] * n
    for t, enc in zip(tasks, coded):
        for i, e in zip(t, enc):
            out[i] = e
    return out


def _rans_group(streams: Sequence[bytes], order: int) -> List[bytes]:
    """All streams stepped together: step t codes each state's t-th
    symbol, from the last step down to the first, as the decoder reads
    them backwards."""
    data = [np.frombuffer(bytes(s), np.uint8) for s in streams]
    if not data:
        return []
    flat = np.concatenate(data)
    start, length, stride = _lanes(data, order)
    S = len(data)
    # tables: [stream, ctx, sym] (order 0: ctx 0 only)
    nctx = 256 if order else 1
    counts = np.zeros((S, nctx, 256), np.int64)
    for s, d in enumerate(data):
        if order == 0:
            counts[s, 0] = np.bincount(d, minlength=256)
        else:
            prev = np.concatenate([[0], d[:-1]]).astype(np.int64)
            prev[start[s] - start[s, 0]] = 0      # each quarter's start
            counts[s] = np.bincount(prev * 256 + d, minlength=65536
                                    ).reshape(256, 256)
    freqs = np.zeros_like(counts)
    tables = []
    for s in range(S):
        for c in np.flatnonzero(counts[s].sum(axis=1)):
            freqs[s, c] = normalize(counts[s, c])
        tables.append(_freqs0(freqs[s, 0]) if order == 0
                      else _freqs1(freqs[s]))
    cum = np.zeros_like(freqs)
    np.cumsum(freqs[:, :, :-1], axis=2, out=cum[:, :, 1:])
    freqs = freqs.reshape(-1)
    cum = cum.reshape(-1)
    T = int(length.max()) if length.size else 0
    x = np.full(S * 4, RANS_LOW, np.uint32)
    lanes_start = start.reshape(-1)
    lanes_len = length.reshape(-1)
    row = (np.arange(S * 4) // 4) * nctx * 256
    chunks = []                      # (states before renorm, bytes shed)
    chunk = int(min(4096, max(16, (1 << 22) // (S * 4))))
    for t1 in range(T, 0, -chunk):
        t0 = max(0, t1 - chunk)
        t = np.arange(t0, t1)[:, None]
        act = t < lanes_len[None, :]
        p = np.where(act, lanes_start[None, :] + t * stride, 0)
        sym = flat[p].astype(np.int64)
        ctx = np.where(t > 0, flat[np.maximum(p - 1, 0)], 0).astype(
            np.int64) if order else 0
        k = row[None, :] + ctx * 256 + sym
        # an idle lane codes with frequency 4096 at 0: its state stays
        F = np.where(act, freqs[k], TOTFREQ).astype(np.uint32)
        C = np.where(act, cum[k], 0).astype(np.uint32)
        # a state at or above F << 19 sheds a byte, at or above F << 27
        # two (the second bound capped: a state stays below 2^31)
        XM = F << np.uint32(19)
        XM8 = np.minimum(F.astype(np.uint64) << np.uint64(27),
                         0xFFFFFFFF).astype(np.uint32)
        X = np.empty(F.shape, np.uint32)
        N = np.empty(F.shape, np.uint8)
        E2 = np.empty(F.shape[1], bool)
        qq = np.empty_like(x)
        rr = np.empty_like(x)
        for i in range(t1 - t0 - 1, -1, -1):
            X[i] = x
            n = N[i]
            np.greater_equal(x, XM[i], out=n.view(bool))
            np.greater_equal(x, XM8[i], out=E2)
            n += E2.view(np.uint8)
            x >>= n << 3
            np.divmod(x, F[i], out=(qq, rr))
            qq <<= TF_SHIFT
            np.add(qq, rr, out=x)
            x += C[i]
        chunks.append((X, N))
    # the renorm bytes forward: step ascending, state ascending, the
    # second byte a state shed before its first
    parts = []
    for X, N in reversed(chunks):
        by = np.stack([(X >> 8).astype(np.uint8), X.astype(np.uint8)],
                      2).reshape(X.shape[0], S, 4, 2)
        mk = np.stack([N == 2, N >= 1], 2).reshape(X.shape[0], S, 4, 2)
        parts.append((by.transpose(1, 0, 2, 3).reshape(S, -1),
                      mk.transpose(1, 0, 2, 3).reshape(S, -1)))
    final = x.reshape(S, 4)
    out = []
    for s in range(S):
        ren = b"".join(by[s][mk[s]].tobytes() for by, mk in parts)
        body = tables[s] + final[s].astype("<u4").tobytes() + ren
        out.append(struct.pack("<BII", order, len(body), len(data[s])) + body)
    return out


def _task(streams, orders, idx):
    return [streams[i] for i in idx], orders[idx[0]]


def _fork_start(work, cost: Sequence[int], workers: int):
    """``work(k)`` for every task k in forked processes that read their
    inputs from this process's memory; each process takes a share of the
    tasks, the costliest first to the least loaded, and sends its results
    back through a pipe (``_fork_collect``)."""
    import multiprocessing

    ctx = multiprocessing.get_context("fork")
    share = [[] for _ in range(min(workers, len(cost)))]
    load = [0] * len(share)
    for k in sorted(range(len(cost)), key=lambda k: -cost[k]):
        w = load.index(min(load))
        share[w].append(k)
        load[w] += cost[k]

    def run(mine, conn):
        try:
            conn.send({k: work(k) for k in mine})
        finally:
            conn.close()

    procs, pipes = [], []
    for mine in share:
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=run, args=(mine, send), daemon=True)
        p.start()
        send.close()
        procs.append(p)
        pipes.append(recv)
    return len(cost), procs, pipes


def _fork_collect(handle) -> list:
    n, procs, pipes = handle
    done = {}
    try:
        for recv in pipes:
            try:
                done.update(recv.recv())
            except EOFError:
                raise RuntimeError("a rANS worker process failed") from None
    finally:
        for p in procs:
            p.join()
    return [done[k] for k in range(n)]


# -- blocks and containers ---------------------------------------------------

RAW, GZIP, RANS = 0, 1, 4
FILE_HEADER, COMPRESSION_HEADER, MAPPED_SLICE, EXTERNAL, CORE = 0, 1, 2, 4, 5


def block(method: int, ctype: int, cid: int, comp: bytes, raw_size: int
          ) -> bytes:
    body = bytes([method, ctype]) + itf8(cid) + itf8(len(comp)) + \
        itf8(raw_size) + comp
    return body + struct.pack("<I", zlib.crc32(body))


def container_header(length, ref_id, start, span, n, counter, bases,
                     n_blocks, landmarks) -> bytes:
    body = struct.pack("<i", length) + itf8(ref_id) + itf8(start) + \
        itf8(span) + itf8(n) + ltf8(counter) + ltf8(bases) + \
        itf8(n_blocks) + itf8(len(landmarks)) + \
        b"".join(itf8(x) for x in landmarks)
    return body + struct.pack("<I", zlib.crc32(body))


def _enc(codec: int, params: bytes) -> bytes:
    return itf8(codec) + itf8(len(params)) + params


def enc_external(cid: int) -> bytes:
    return _enc(1, itf8(cid))


def enc_constant(value: int) -> bytes:
    """Single-symbol HUFFMAN: the value, code length 0."""
    return _enc(3, itf8(1) + itf8(value) + itf8(1) + itf8(0))


def enc_stop(stop: int, cid: int) -> bytes:
    return _enc(5, bytes([stop]) + itf8(cid))


def enc_len(len_cid: int, val_cid: int) -> bytes:
    return _enc(4, enc_external(len_cid) + enc_external(val_cid))


def _map(entries: List[tuple]) -> bytes:
    body = itf8(len(entries)) + b"".join(k + v for k, v in entries)
    return itf8(len(body)) + body


def sm_bytes(sm: np.ndarray) -> bytes:
    """The 5 SM bytes from ``sm[ref, read]`` = the 2-bit code of each
    substitution (ref and read in A C G T N order): for each reference
    base, the codes of the other four bases in that order, the first in
    the top two bits."""
    out = bytearray()
    for r in range(5):
        b = 0
        for s in (s for s in range(5) if s != r):
            b = (b << 2) | int(sm[r, s])
        out.append(b)
    return bytes(out)


def sm_by_frequency(counts: np.ndarray) -> np.ndarray:
    """Codes 0-3 for each reference base's four substitutions, the most
    frequent first (ties in base order), as htslib picks them."""
    sm = np.zeros((5, 5), np.int64)
    for r in range(5):
        others = [s for s in range(5) if s != r]
        rank = sorted(others, key=lambda s: (-counts[r, s], s))
        for code, s in enumerate(rank):
            sm[r, s] = code
    return sm


def compression_header(sm, encodings: Dict[str, bytes], tag_enc: bytes
                       ) -> bytes:
    td = b"RGZ\x00"
    pres = [(b"RN", b"\x01"), (b"AP", b"\x01"), (b"RR", b"\x01"),
            (b"SM", sm_bytes(sm)), (b"TD", itf8(len(td)) + td)]
    series = [(k.encode(), v) for k, v in encodings.items()]
    return _map(pres) + _map(series) + _map([(itf8(RG_KEY), tag_enc)])


# -- ragged helpers ----------------------------------------------------------

def offsets(lengths) -> np.ndarray:
    out = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=out[1:])
    return out


def ragged_index(starts, lengths) -> np.ndarray:
    """Indices ``starts[i] + 0..lengths[i]-1`` of every i, joined."""
    lengths = np.asarray(lengths, np.int64)
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    off = offsets(lengths)[:-1]
    return np.repeat(np.asarray(starts, np.int64) - off, lengths) + \
        np.arange(total, dtype=np.int64)


# -- the truth: BAM records ---------------------------------------------------

def record_sizes(r: dict) -> np.ndarray:
    """Bytes of each record of ``r`` as a BAM record."""
    ls = np.diff(r["seq_off"])
    return 36 + np.diff(r["name_off"]) + 1 + 4 * np.diff(r["cig_off"]) + \
        (ls + 1) // 2 + ls + np.diff(r["tag_off"])


def take(r: dict, lo: int, hi: int) -> dict:
    """Records [lo, hi) of ``r``, their ragged columns rebased."""
    out = {}
    for k, v in r.items():
        if k.endswith("_off"):
            continue
        out[k] = v[lo:hi]
    for col, off in (("names", "name_off"), ("cigars", "cig_off"),
                     ("seqs", "seq_off"), ("quals", "seq_off"),
                     ("tags", "tag_off")):
        o = r[off]
        out[col] = r[col][o[lo]:o[hi]]
        out[off] = o[lo:hi + 1] - o[lo]
    return out


def bam_records(r: dict) -> tuple:
    """BAM record bytes of every record of ``r`` (fixed columns, ragged
    names, CIGAR words, ASCII bases, qualities, tag bytes) and their
    offsets."""
    n = len(r["refid"])
    nl = np.diff(r["name_off"])
    nc = np.diff(r["cig_off"])
    ls = np.diff(r["seq_off"])
    nt = np.diff(r["tag_off"])
    size = record_sizes(r)
    start = offsets(size)
    buf = np.zeros(int(start[-1]), np.uint8)
    fixed = np.zeros(n, dtype=[
        ("bs", "<i4"), ("refid", "<i4"), ("pos", "<i4"), ("lrn", "u1"),
        ("mapq", "u1"), ("bin", "<u2"), ("ncig", "<u2"), ("flag", "<u2"),
        ("lseq", "<i4"), ("nref", "<i4"), ("npos", "<i4"), ("tlen", "<i4")])
    fixed["bs"] = size - 4
    for k, src in (("refid", "refid"), ("pos", "pos"), ("mapq", "mapq"),
                   ("bin", "bin"), ("flag", "flag"), ("nref", "next_refid"),
                   ("npos", "next_pos"), ("tlen", "tlen")):
        fixed[k] = r[src]
    fixed["lrn"] = nl + 1
    fixed["ncig"] = nc
    fixed["lseq"] = ls
    at = start[:-1]
    buf[ragged_index(at, np.full(n, 36))] = fixed.view(np.uint8)
    buf[ragged_index(at + 36, nl)] = r["names"]
    at = at + 36 + nl + 1
    buf[ragged_index(at, 4 * nc)] = r["cigars"].astype("<u4").view(np.uint8)
    at = at + 4 * nc
    code = np.zeros(256, np.uint8)
    for i, c in enumerate(b"=ACMGRSVTWYHKDBN"):
        code[c] = i
    nib = code[r["seqs"]]
    odd = ls % 2 == 1
    nib = np.insert(nib, offsets(ls)[1:][odd], 0) if odd.any() else nib
    packed = (nib[0::2] << 4) | nib[1::2]
    buf[ragged_index(at, (ls + 1) // 2)] = packed
    at = at + (ls + 1) // 2
    buf[ragged_index(at, ls)] = r["quals"]
    buf[ragged_index(at + ls, nt)] = r["tags"]
    return buf, start


def ref_spans(cigars, cig_off) -> np.ndarray:
    ops = (cigars & 0xF).astype(np.int64)
    ln = (cigars >> 4).astype(np.int64)
    contrib = np.where(REF_OPS[np.minimum(ops, 8)], ln, 0)
    c = offsets(contrib)
    return c[cig_off[1:]] - c[cig_off[:-1]]


# -- read synthesis ----------------------------------------------------------

def reference_seq(length: int, region_end: int, seed: int) -> np.ndarray:
    """Seeded random A/C/G/T bases, with 20 gaps of 100 N inside the
    region."""
    rng = np.random.default_rng([seed, 0x5EF])
    ref = BASES[rng.integers(0, 4, length, dtype=np.uint8)]
    for g in rng.integers(10_000, max(region_end - 10_000, 10_001), 20):
        ref[g:g + 100] = ord("N")
    return ref


def _variants(ref, region_end, seed, snv_rate, indel_rate):
    """Per haplotype (0, 1): sorted SNV positions and their alt bases;
    indels as (position, length, inserted bases or None) per haplotype."""
    rng = np.random.default_rng([seed, 0x7A7])
    hi = min(len(ref), region_end)
    ns = rng.binomial(hi, snv_rate)
    pos = np.unique(rng.integers(0, hi, ns))
    pos = pos[ref[pos] != ord("N")]
    alt = BASES[(np.searchsorted(BASES, ref[pos]) +
                 rng.integers(1, 4, len(pos))) % 4]
    gt = rng.choice(3, len(pos), p=[1 / 3, 1 / 3, 1 / 3])  # 0/1 het, hom
    snv = [(pos[(gt == h) | (gt == 2)], alt[(gt == h) | (gt == 2)])
           for h in (0, 1)]
    ni = rng.binomial(hi, indel_rate)
    ipos = np.unique(rng.integers(200, hi - 200, ni))
    ilen = np.minimum(rng.geometric(0.5, len(ipos)), 10)
    ins = rng.random(len(ipos)) < 0.5
    igt = rng.choice(3, len(ipos), p=[1 / 3, 1 / 3, 1 / 3])
    ibases = BASES[rng.integers(0, 4, int(ilen.sum()))]
    ioff = offsets(ilen)
    indel = [[(int(p), int(n), ibases[ioff[k]:ioff[k + 1]] if i else None)
              for k, (p, n, i, g) in enumerate(zip(ipos, ilen, ins, igt))
              if g == h or g == 2] for h in (0, 1)]
    return snv, indel


CHUNK = 200_000


def _aligned(ref, pos, cigars, cig_off, rows):
    """(read index, reference index) of every base of ``rows`` (records
    of one chunk) that an M op aligns: whole rows for a one-M CIGAR of
    the full read, a ragged walk for the rest."""
    L = READ_LEN
    ncig = np.diff(cig_off)
    ops = (cigars & 0xF).astype(np.int64)
    ln = (cigars >> 4).astype(np.int64)
    simple = rows & (ncig == 1)
    simple[simple] = (ops[cig_off[:-1][simple]] == 0) & \
        (ln[cig_off[:-1][simple]] == L)
    rest = rows & ~simple
    rec = np.repeat(np.arange(len(pos)), ncig)
    rd = np.where(READ_OPS[ops], ln, 0)
    rf = np.where(REF_OPS[ops], ln, 0)
    read_at = offsets(rd)[:-1] - offsets(rd)[cig_off[rec]]
    ref_at = pos[rec] + offsets(rf)[:-1] - offsets(rf)[cig_off[rec]]
    m = (ops == 0) & rest[rec]
    dst = ragged_index(rec[m] * L + read_at[m], ln[m])
    src = ragged_index(ref_at[m], ln[m])
    return np.flatnonzero(simple), dst, src


def _draw(rng, seq, qual, hapref, pos, mapped, hap, cigars, cig_off,
          error_rate) -> None:
    """One chunk of records' bases and qualities: the pair's haplotype
    on aligned bases (random over N gaps, in soft clips and insertions
    and on unmapped reads), then NovaSeq's binned qualities,
    substitution errors and N at some quality-2 bases."""
    n, L = seq.shape
    seq[:] = BASES[rng.integers(0, 4, (n, L), dtype=np.uint8)]
    flat = seq.reshape(-1)
    for h in (0, 1):
        rows, dst, src = _aligned(hapref[h], pos, cigars, cig_off,
                                  mapped & (hap == h))
        win = np.lib.stride_tricks.sliding_window_view(hapref[h], L)
        got = win[pos[rows]]
        keep = got != ord("N")
        seq[rows] = np.where(keep, got, seq[rows])
        b = hapref[h][src]
        k = b != ord("N")
        flat[dst[k]] = b[k]
    qual.reshape(-1)[:] = QUAL_TABLE[rng.integers(0, len(QUAL_TABLE), n * L,
                                                  dtype=np.uint8)]
    err = np.unique(rng.integers(0, n * L, rng.binomial(n * L, error_rate)))
    cur = np.searchsorted(BASES, flat[err])
    flat[err] = BASES[(cur + rng.integers(1, 4, len(err))) % 4]
    q2 = np.flatnonzero(qual.reshape(-1) == 2)
    flat[q2[rng.random(len(q2)) < N_SHARE_AT_Q2]] = ord("N")


def synthesize(config: dict, seed: int, ref: np.ndarray) -> dict:
    """The truth's records, coordinate-sorted, with each record's mate
    index (``mate``) and the read bases from the reference."""
    ((name, length),) = [tuple(x) for x in config["references"]]
    region_end = int(config["region_end"])
    n = int(config["reads"])
    g = reads_bam.synthesize(n, seed, [(name, length)], region_end,
                             tuple(config.get("insert", (350, 60))))
    perm = stable_order(g["refid"], g["pos"])
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    g = {k: v[perm] for k, v in g.items()}
    mate = inv[perm ^ 1]
    L = reads_bam.READ_LEN
    flag = g["flag"].astype(np.int64)
    refid = g["refid"].astype(np.int64)
    pos = g["pos"].astype(np.int64)
    mapped = (flag & 0x4) == 0
    # the unmapped mate's mate-reverse bit is its mate's reverse bit
    flag = np.where(flag & 0x4, (flag & ~0x20) | np.where(
        flag[mate] & 0x10, 0x20, 0), flag)
    # CIGARs: reads_bam's, then an indel variant on reads whose CIGAR is
    # one M and that span it with 10 bases to spare
    hap = (perm // 2) % 2                  # each pair's haplotype
    snv, indel = _variants(ref, region_end, seed,
                           float(config["snv_rate"]),
                           float(config["indel_rate"]))
    ncig = g["ncig"].astype(np.int64)
    cig = g["cig"].astype(np.int64).copy()
    for h in (0, 1):
        if not indel[h]:
            continue
        ip = np.array([v[0] for v in indel[h]], np.int64)
        on = mapped & (ncig == 1) & (hap == h)
        idx = np.flatnonzero(on)
        k = np.searchsorted(ip, pos[idx] + 10)
        k_ok = k < len(ip)
        idx, k = idx[k_ok], k[k_ok]
        a = ip[k] - pos[idx]                   # M bases before the site
        ln = np.array([v[1] for v in indel[h]], np.int64)[k]
        is_ins = np.array([v[2] is not None for v in indel[h]])[k]
        fits = np.where(is_ins, a + ln <= L - 10, a <= L - 10)
        idx, k, a, ln, is_ins = (x[fits] for x in (idx, k, a, ln, is_ins))
        ncig[idx] = 3
        cig[idx, 0] = a << 4
        cig[idx, 1] = np.where(is_ins, (ln << 4) | 1, (ln << 4) | 2)
        cig[idx, 2] = np.where(is_ins, (L - a - ln) << 4, (L - a) << 4)
        g.setdefault("_ins", []).append((idx, k, h))
    cig_keep = np.arange(3)[None, :] < ncig[:, None]
    cigars = cig[cig_keep].astype(np.uint32)
    cig_off = offsets(ncig)
    span = ref_spans(cigars, cig_off)
    end = pos + np.maximum(span, 1)
    tlen = np.zeros(n, np.int64)
    both = mapped & mapped[mate] & (refid == refid[mate]) & (refid >= 0)
    left = np.minimum(pos, pos[mate])
    right = np.maximum(end, end[mate])
    first = (pos < pos[mate]) | ((pos == pos[mate]) & (np.arange(n) < mate))
    tlen[both] = np.where(first, 1, -1)[both] * (right - left)[both]
    # an unplaced record takes the bin the port derives for CRAM, that of
    # [0, 1): 4681 (the SAM spec's reg2bin(-1, 0) would give 4680)
    binv = np.where(mapped, reg2bin(np.maximum(pos, 0), end), 4681)
    placed = ~mapped & (refid >= 0)
    binv[placed] = reg2bin(pos[placed], pos[placed] + 1)
    hapref = []
    for h in (0, 1):
        hr = ref.copy()
        hr[snv[h][0]] = snv[h][1]
        hapref.append(hr)
    seq = np.empty((n, L), np.uint8)
    qual = np.empty((n, L), np.uint8)
    los = list(range(0, n, CHUNK))
    seeds = np.random.SeedSequence([seed, 0xBA5]).spawn(len(los))

    def draw(k):
        lo = los[k]
        hi = min(n, lo + CHUNK)
        _draw(np.random.default_rng(seeds[k]), seq[lo:hi], qual[lo:hi],
              hapref, pos[lo:hi], mapped[lo:hi], hap[lo:hi],
              cigars[cig_off[lo]:cig_off[hi]], cig_off[lo:hi + 1] - cig_off[lo],
              float(config["error_rate"]))

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(draw, range(len(los))))
    del hapref
    for idx, k, h in g.pop("_ins", []):
        for j, i in enumerate(idx.tolist()):
            a = int(cig[i, 0] >> 4)
            b = indel[h][int(k[j])][2]
            if b is not None:
                seq[i, a:a + len(b)] = b
    names = g["names"]
    tag = b"RGZ" + RG_NAME + b"\x00"
    return {
        "refid": refid.astype(np.int32), "pos": pos.astype(np.int32),
        "mapq": g["mapq"], "bin": binv.astype(np.uint16),
        "flag": flag.astype(np.uint16),
        "next_refid": refid[mate].astype(np.int32),
        "next_pos": pos[mate].astype(np.int32),
        "tlen": tlen.astype(np.int32), "mate": mate,
        "names": names.reshape(-1),
        "name_off": offsets(np.full(n, names.shape[1])),
        "cigars": cigars, "cig_off": cig_off,
        "seqs": seq.reshape(-1), "seq_off": offsets(np.full(n, L)),
        "quals": qual.reshape(-1),
        "tags": np.tile(np.frombuffer(tag, np.uint8), n),
        "tag_off": offsets(np.full(n, len(tag))),
        "style": np.zeros(n, np.uint8),
    }


# -- records to CRAM ---------------------------------------------------------

STYLE_B = 1          # the aligned bases as one 'b' feature per M run
STYLE_LOSSY = 2      # qualities not stored: 'q' and 'Q' features instead


def _base_index(b: np.ndarray) -> np.ndarray:
    """A C G T -> 0-3, anything else -> 4 (N), as the SM rows."""
    t = np.full(256, 4, np.int64)
    for i, c in enumerate(b"ACGT"):
        t[c] = i
        t[c + 32] = i
    return t[b]


def features(r: dict, ref: np.ndarray) -> dict:
    """Every mapped record's read features in read order: code, read
    position (1-based), an integer (length, base, quality or ref/read
    base pair) and a byte payload (ragged)."""
    n = len(r["refid"])
    flag = r["flag"].astype(np.int64)
    mapped = (flag & 0x4) == 0
    ncig = np.diff(r["cig_off"])
    ops = (r["cigars"] & 0xF).astype(np.int64)
    ln = (r["cigars"] >> 4).astype(np.int64)
    rec = np.repeat(np.arange(n), ncig)
    keep = mapped[rec]
    ops, ln, rec = ops[keep], ln[keep], rec[keep]
    first = np.r_[True, rec[1:] != rec[:-1]] if len(rec) else np.zeros(0, bool)
    rd = np.where(READ_OPS[ops], ln, 0)
    rf = np.where(REF_OPS[ops], ln, 0)
    seg = np.cumsum(first) - 1
    base_rd = offsets(rd)[:-1]
    base_rf = offsets(rf)[:-1]
    read_at = base_rd - base_rd[first][seg]
    ref_at = r["pos"][rec].astype(np.int64) + base_rf - base_rf[first][seg]
    seq_at = r["seq_off"][rec] + read_at
    style = r["style"][rec]
    out = []      # (rec, read pos, order, code, int, payload start, len)
    order = np.arange(len(ops)) * 2
    # M runs: 'b' runs, or per-base X / B where the bases differ
    m = ((ops == 0) | (ops == 7) | (ops == 8))
    mb = m & ((style & STYLE_B) != 0)
    out.append((rec[mb], read_at[mb] + 1, order[mb], np.full(mb.sum(), ord("b")),
                np.zeros(mb.sum(), np.int64), seq_at[mb], ln[mb]))
    mx = m & ~mb
    parts = []
    # a record whose one op is an M over the whole read: row against
    # the reference window
    whole = mx & first & (np.r_[first[1:], True]) & (ln == READ_LEN) & \
        (np.diff(r["seq_off"])[rec] == READ_LEN)
    if whole.any():
        win = np.lib.stride_tricks.sliding_window_view(ref, READ_LEN)
        wk = np.flatnonzero(whole)
        for a in range(0, len(wk), 1 << 17):
            sel = wk[a:a + (1 << 17)]
            if (np.diff(r["seq_off"]) == READ_LEN).all():
                got = r["seqs"].reshape(-1, READ_LEN)[rec[sel]]
            else:
                got = r["seqs"][ragged_index(seq_at[sel], np.full(
                    len(sel), READ_LEN))]
            want = win[ref_at[sel]]
            up = np.where((want >= 97) & (want <= 122), want - 32, want)
            ii, jj = np.nonzero(got.reshape(-1, READ_LEN) != up)
            parts.append((sel[ii], jj, got.reshape(-1, READ_LEN)[ii, jj],
                          up[ii, jj]))
    mx = np.flatnonzero(mx & ~whole)
    bounds = np.searchsorted(np.cumsum(ln[mx]), np.arange(
        0, int(ln[mx].sum()) + (1 << 24), 1 << 24), side="right")
    for a, b in zip(bounds[:-1], bounds[1:]):
        sel = mx[a:b]
        if not len(sel):
            continue
        k = np.repeat(sel, ln[sel])
        within = ragged_index(np.zeros(len(sel), np.int64), ln[sel])
        rb = r["seqs"][seq_at[k] + within]
        fb = ref[ref_at[k] + within]
        up = np.where((fb >= 97) & (fb <= 122), fb - 32, fb)
        d = np.flatnonzero(rb != up)
        parts.append((k[d], within[d], rb[d], up[d]))
    k, within, rb, up = (np.concatenate([p[i] for p in parts]) if parts
                         else np.zeros(0, np.int64) for i in range(4))
    rb, up = rb.astype(np.uint8), up.astype(np.uint8)
    ri, si = _base_index(up), _base_index(rb)
    # X where the read base is A, C, G or T, or an N over A, C, G or T;
    # B for the rest (an N over an N, any other code)
    is_x = (si < 4) | ((rb == ord("N")) & (ri < 4))
    code = np.where(is_x, ord("X"), ord("B"))
    out.append((rec[k], read_at[k] + within + 1, order[k] + 1, code,
                ri * 256 + rb.astype(np.int64), seq_at[k] + within,
                np.ones(len(k), np.int64)))
    for op, ch in ((4, "S"), (1, "I")):
        s = ops == op
        c = np.full(s.sum(), ord(ch))
        if ch == "I":
            c = np.where(ln[s] == 1, ord("i"), c)
        out.append((rec[s], read_at[s] + 1, order[s], c, ln[s], seq_at[s],
                    ln[s]))
    for op, ch in ((2, "D"), (3, "N"), (5, "H"), (6, "P")):
        s = ops == op
        out.append((rec[s], read_at[s] + 1, order[s],
                    np.full(s.sum(), ord(ch)), ln[s],
                    np.zeros(s.sum(), np.int64), np.zeros(s.sum(), np.int64)))
    # lossy qualities: runs of 3 set bases as 'Q', single ones as 'q'
    lossy = np.flatnonzero(mapped & ((r["style"] & STYLE_LOSSY) != 0))
    if len(lossy):
        ls = np.diff(r["seq_off"])[lossy]
        q_at = r["seq_off"][lossy]
        out.append((lossy, np.ones(len(lossy), np.int64),
                    np.full(len(lossy), -1), np.full(len(lossy), ord("q")),
                    r["quals"][q_at].astype(np.int64), q_at,
                    np.ones(len(lossy), np.int64)))
        big = ls >= 8
        out.append((lossy[big], np.full(big.sum(), 4), np.full(big.sum(), -1),
                    np.full(big.sum(), ord("Q")), np.zeros(big.sum(), np.int64),
                    q_at[big] + 3, np.full(big.sum(), 3)))
    cols = [np.concatenate([np.asarray(o[i], np.int64) for o in out])
            for i in range(7)]
    srt = np.lexsort((cols[2], cols[1], cols[0]))
    f = dict(zip(("rec", "pos", "order", "code", "val", "at", "len"),
                 (c[srt] for c in cols)))
    return f


def features_chunked(r: dict, ref: np.ndarray, chunk: int = CHUNK) -> dict:
    """``features`` of blocks of records, in threads, joined."""
    n = len(r["refid"])
    bounds = list(range(0, n, chunk)) + [n]
    if len(bounds) <= 2:
        return features(r, ref)

    def one(k):
        lo = bounds[k]
        f = features(take(r, lo, bounds[k + 1]), ref)
        f["rec"] += lo
        f["at"] += r["seq_off"][lo]
        return f

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        parts = list(pool.map(one, range(len(bounds) - 1)))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _lossy_quals(r: dict, f: dict, lossy: np.ndarray) -> np.ndarray:
    """The BAM qualities: a record whose qualities are not stored reads
    255 but where its 'q', 'Q' and 'B' features set them."""
    q = r["quals"].copy()
    ls = np.diff(r["seq_off"])
    rows = np.flatnonzero(lossy)
    keep = np.zeros(len(q), bool)
    w = np.isin(f["code"], [ord("q"), ord("Q"), ord("B")]) & lossy[f["rec"]]
    keep[ragged_index(f["at"][w], f["len"][w])] = True
    at = ragged_index(r["seq_off"][rows], ls[rows])
    q[at[~keep[at]]] = 255
    return q


def mate_layout(r: dict, slice_of: np.ndarray) -> dict:
    """Which records are attached (their NF) and which detached."""
    n = len(r["refid"])
    mate = r["mate"]
    flag = r["flag"].astype(np.int64)
    ok = (mate >= 0)
    m = np.where(ok, mate, 0)
    prim = (flag & 0x900) == 0
    pos = r["pos"].astype(np.int64)
    mapped = (flag & 4) == 0
    span = ref_spans(r["cigars"], r["cig_off"])
    end = pos + np.maximum(span, 1)
    both = mapped & mapped[m] & (r["refid"] == r["refid"][m]) & (r["refid"] >= 0)
    left = np.minimum(pos, pos[m])
    right = np.maximum(end, end[m])
    up = np.arange(n) < m
    want = np.where(both, np.where(up, 1, -1) * (right - left), 0)
    consistent = (
        ok & (m != np.arange(n)) & (mate[m] == np.arange(n)) & prim & prim[m]
        & ((flag & 1) != 0) & (slice_of == slice_of[m])
        & (r["next_refid"] == r["refid"][m]) & (r["next_pos"] == pos[m])
        & (((flag & 0x20) != 0) == ((flag[m] & 0x10) != 0))
        & (((flag & 0x8) != 0) == ((flag[m] & 0x4) != 0))
        & (r["tlen"] == want))
    pair_ok = consistent & consistent[m]
    attached = pair_ok
    down = attached & up
    return {"attached": attached, "down": down,
            "nf": np.where(down, m - np.arange(n) - 1, 0)}


def slice_cuts(refid: np.ndarray, slice_records: int) -> np.ndarray:
    """Where slices start (and the end): every ``slice_records``
    records, and where the reference changes."""
    n = len(refid)
    change = np.flatnonzero(np.diff(refid) != 0) + 1
    cuts = []
    for a, b in zip(np.r_[0, change], np.r_[change, n]):
        cuts += list(range(int(a), int(b), slice_records))
    return np.array(cuts + [n], np.int64)


def quality_streams(r: dict, cuts: np.ndarray) -> list:
    """Each slice's stored qualities, in record order: its QS block
    where no record has ``B`` or ``q`` features or unstored qualities."""
    at = r["seq_off"][cuts]
    return [r["quals"][a:b] for a, b in zip(at[:-1], at[1:])]


def write_cram(path: str, refs, ref_seqs: Dict[str, np.ndarray], r: dict,
               slice_records: int = SLICE_RECORDS, sm=None,
               qs_started=None) -> dict:
    """``r``'s records (coordinate-sorted) as a CRAM 3.0 file in
    htslib's layout at ``path`` with its ``.crai``; ``sm`` forces the
    substitution matrix (``sm[ref, read]`` codes), else each container's
    codes go by frequency. Returns the truth and the file's facts."""
    n = len(r["refid"])
    flag = r["flag"].astype(np.int64)
    mapped = (flag & 4) == 0
    refid = r["refid"].astype(np.int64)
    cuts = slice_cuts(refid, slice_records)
    slice_of = np.searchsorted(cuts, np.arange(n), side="right") - 1
    mates = mate_layout(r, slice_of)
    ref_by_id = [ref_seqs[name] for name, _ in refs]
    concat = np.concatenate(ref_by_id) if ref_by_id else np.zeros(0, np.uint8)
    ref_base = offsets([len(x) for x in ref_by_id])
    # features over one concatenated reference
    rr = dict(r)
    rr["pos"] = np.where(refid >= 0, r["pos"].astype(np.int64) +
                         ref_base[np.maximum(refid, 0)], 0)
    f = features_chunked(rr, concat)
    f_slice = slice_of[f["rec"]] if len(f["rec"]) else np.zeros(0, np.int64)
    ls = np.diff(r["seq_off"])
    lossy = ((r["style"] & STYLE_LOSSY) != 0) & mapped
    cf = np.where(lossy, 0, 1) | np.where(mates["attached"], 0, 2) | \
        np.where(mates["down"], 4, 0)
    bf = np.where(mates["attached"], flag & ~0x28, flag)
    pos1 = r["pos"].astype(np.int64) + 1
    slice_start = np.zeros(len(cuts) - 1, np.int64)
    slice_span = np.zeros(len(cuts) - 1, np.int64)
    span = ref_spans(r["cigars"], r["cig_off"])
    end = r["pos"].astype(np.int64) + np.maximum(span, 1)
    for s in range(len(cuts) - 1):
        a, b = cuts[s], cuts[s + 1]
        if b > a and refid[a] >= 0:
            slice_start[s] = pos1[a:b].min()
            slice_span[s] = end[a:b].max() - (slice_start[s] - 1)
    prev = np.r_[0, pos1[:-1]]
    firsts = cuts[:-1][cuts[:-1] < n]
    prev[firsts] = slice_start[slice_of[firsts]]
    ap = pos1 - prev
    fcode = f["code"]
    # per-record BA and QS streams (feature parts first, then bases /
    # qualities), in record order
    ba_feat = (fcode == ord("B")) | (fcode == ord("i"))
    qs_feat = (fcode == ord("B")) | (fcode == ord("q"))
    rb_ba = np.bincount(f["rec"][ba_feat], minlength=n)
    rb_qs = np.bincount(f["rec"][qs_feat], minlength=n)
    ba_len = np.where(mapped, rb_ba, ls)
    qs_len = rb_qs + np.where(cf & 1, ls, 0)
    fr = f["rec"]
    ba_off, qs_off = offsets(ba_len), offsets(qs_len)
    # BA: unmapped reads' bases, the B and i features' bases inserted
    # before each record's place
    um = np.flatnonzero(~mapped)
    ba = r["seqs"][ragged_index(r["seq_off"][um], ls[um])]
    um_off = offsets(ls[um])
    at = um_off[np.searchsorted(um, fr[ba_feat])]
    ba = np.insert(ba, at, r["seqs"][f["at"][ba_feat]])
    # QS: stored qualities, the B and q features' qualities before them
    st = (cf & 1) != 0
    qs = r["quals"] if st.all() else r["quals"][ragged_index(
        r["seq_off"][:-1][st], ls[st])]
    st_off = offsets(np.where(st, ls, 0))
    qs = np.insert(qs, st_off[fr[qs_feat]], r["quals"][f["at"][qs_feat]])
    # SM codes per slice, BS values
    x = fcode == ord("X")
    xr, xs = f["val"][x] // 256, _base_index(
        (f["val"][x] % 256).astype(np.uint8))
    x_slice = f_slice[x]
    nsl = len(cuts) - 1
    sms = []
    for s in range(nsl):
        if sm is not None:
            sms.append(np.asarray(sm))
            continue
        cnt = np.zeros((5, 5), np.int64)
        w = x_slice == s
        np.add.at(cnt, (xr[w], xs[w]), 1)
        sms.append(sm_by_frequency(cnt))
    bs = np.zeros(int(x.sum()), np.int64)
    for s in range(nsl):
        w = x_slice == s
        bs[w] = sms[s][xr[w], xs[w]]
    # feature positions as deltas within each record
    fp = f["pos"].copy()
    if len(fp):
        later = np.flatnonzero(np.r_[False, fr[1:] == fr[:-1]])
        fp[later] -= f["pos"][later - 1]
    fn = np.bincount(fr, minlength=n)
    names_nul = np.insert(r["names"], r["name_off"][1:], 0)
    name_len1 = np.diff(r["name_off"]) + 1
    tag_val = np.frombuffer(RG_NAME + b"\x00\t", np.uint8)
    streams = {}                  # (slice, cid) -> bytes

    def put_ints(key, cid_key, values, owner):
        """An integer series: per slice its values' ITF8 bytes, or a
        constant."""
        vals = np.asarray(values, np.int64)
        buf, off = itf8_bytes(vals)
        bounds = np.searchsorted(owner, np.arange(nsl + 1))
        for s in range(nsl):
            a, b = bounds[s], bounds[s + 1]
            if b > a:
                v = vals[a:b]
                if (v == v[0]).all():
                    encs[s][key] = enc_constant(int(v[0]))
                else:
                    encs[s][key] = enc_external(CID[cid_key])
                    streams[(s, CID[cid_key])] = buf[off[a]:off[b]].tobytes()

    def put_bytes(key, cid_key, values, owner, constant_ok=True):
        vals = np.asarray(values, np.uint8)
        bounds = np.searchsorted(owner, np.arange(nsl + 1))
        for s in range(nsl):
            a, b = bounds[s], bounds[s + 1]
            if b > a:
                v = vals[a:b]
                if constant_ok and (v == v[0]).all():
                    encs[s][key] = enc_constant(int(v[0]))
                else:
                    encs[s][key] = enc_external(CID[cid_key])
                    streams[(s, CID[cid_key])] = v.tobytes()

    def put_arrays(key, owner, flat_at, lens):
        lk, vk = key + "_LEN", key
        lbuf, loff = itf8_bytes(lens)
        vals = r["seqs"] if key != "QQ" else r["quals"]
        data = vals[ragged_index(flat_at, lens)]
        doff = offsets(lens)
        bounds = np.searchsorted(owner, np.arange(nsl + 1))
        for s in range(nsl):
            a, b = bounds[s], bounds[s + 1]
            if b > a:
                encs[s][key] = enc_len(CID[lk], CID[vk])
                streams[(s, CID[lk])] = lbuf[loff[a]:loff[b]].tobytes()
                streams[(s, CID[vk])] = data[doff[a]:doff[b]].tobytes()

    encs: List[Dict[str, bytes]] = [dict() for _ in range(nsl)]
    allr = slice_of
    put_ints("BF", "BF", bf, allr)
    put_ints("CF", "CF", cf, allr)
    put_ints("RL", "RL", ls, allr)
    put_ints("AP", "AP", ap, allr)
    put_ints("RG", "RG", np.full(n, -1), allr)
    nb = np.searchsorted(allr, np.arange(nsl + 1))
    noff = offsets(name_len1)
    for s in range(nsl):
        a, b = nb[s], nb[s + 1]
        if b > a:
            encs[s]["RN"] = enc_stop(0, CID["RN"])
            streams[(s, CID["RN"])] = names_nul[noff[a]:noff[b]].tobytes()
    det = ~mates["attached"]
    mf = np.where(flag & 0x20, 1, 0) | np.where(flag & 0x8, 2, 0)
    put_ints("MF", "MF", mf[det], allr[det])
    put_ints("NS", "NS", r["next_refid"][det], allr[det])
    put_ints("NP", "NP", r["next_pos"].astype(np.int64)[det] + 1, allr[det])
    put_ints("TS", "TS", r["tlen"][det], allr[det])
    dn = mates["down"]
    put_ints("NF", "NF", mates["nf"][dn], allr[dn])
    put_ints("TL", "TL", np.zeros(n), allr)
    for s in range(nsl):
        if nb[s + 1] > nb[s]:
            streams[(s, RG_KEY)] = np.tile(tag_val, int(nb[s + 1] - nb[s])).tobytes()
    put_ints("FN", "FN", fn[mapped], allr[mapped])
    put_bytes("FC", "FC", fcode, f_slice)
    put_ints("FP", "FP", fp, f_slice)
    put_bytes("BS", "BS", bs, f_slice[x])
    for ch, key in ((ord("I"), "IN"), (ord("S"), "SC"), (ord("b"), "BB"),
                    (ord("Q"), "QQ")):
        w = fcode == ch
        put_arrays(key, f_slice[w], f["at"][w], f["len"][w])
    for ch, key in ((ord("D"), "DL"), (ord("N"), "RS"), (ord("H"), "HC"),
                    (ord("P"), "PD")):
        w = fcode == ch
        put_ints(key, key, f["val"][w], f_slice[w])
    for key, data, off in (("BA", ba, ba_off), ("QS", qs, qs_off)):
        for sl in range(nsl):
            a, b = off[cuts[sl]], off[cuts[sl + 1]]
            if b > a:
                encs[sl][key] = enc_external(CID[key])
                streams[(sl, CID[key])] = data[a:b].tobytes()
    put_ints("MQ", "MQ", r["mapq"].astype(np.int64)[mapped], allr[mapped])
    # every block's bytes, compressed together
    keys = sorted(streams)
    early = {}
    if qs_started is not None:
        # QS blocks coded while the rest was made, where they are the
        # stored qualities alone
        raw, started = qs_started
        early = {(sl, CID["QS"]): c for sl, c in
                 enumerate(rans_collect(started))
                 if streams.get((sl, CID["QS"])) == raw[sl].tobytes()}
    coded = [k for k in keys if k[1] != CID["RN"] and k not in early]
    comp = dict(zip(coded, rans_encode(
        [streams[k] for k in coded],
        [1 if k[1] == CID["QS"] else 0 for k in coded])))
    comp.update(early)
    names = [k for k in keys if k[1] == CID["RN"]]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        comp.update(zip(names, pool.map(
            lambda k: gzip.compress(streams[k], 6, mtime=0), names)))
    # the file
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{name}\tLN:{ln}\tM5:{hashlib.md5(ref_seqs[name].tobytes()).hexdigest()}\n"
        for name, ln in refs) + f"@RG\tID:{RG_NAME.decode()}\tSM:NA12878\tPL:ILLUMINA\n"
    tb = text.encode()
    hblock = block(RAW, FILE_HEADER, 0, struct.pack("<i", len(tb)) + tb,
                   len(tb) + 4)
    out = bytearray(b"CRAM\x03\x00" + b"disq-bench-cram-3.0\x00")
    out += container_header(len(hblock), 0, 0, 0, 0, 0, 0, 1, []) + hblock
    crai = []
    for s in range(nsl):
        a, b = int(cuts[s]), int(cuts[s + 1])
        rid = int(refid[a])
        sm_s = sms[s] if s < len(sms) else np.zeros((5, 5), np.int64)
        ch = compression_header(sm_s, encs[s], enc_stop(ord("\t"), RG_KEY))
        chb = block(RAW, COMPRESSION_HEADER, 0, ch, len(ch))
        cids = sorted(c for (ss, c) in keys if ss == s)
        blocks = [block(RAW, CORE, 0, b"", 0)]
        for c in cids:
            method = GZIP if c == CID["RN"] else RANS
            blocks.append(block(method, EXTERNAL, c, comp[(s, c)],
                                len(streams[(s, c)])))
        md5 = hashlib.md5(ref_seqs[refs[rid][0]][
            slice_start[s] - 1:slice_start[s] - 1 + slice_span[s]].tobytes()
        ).digest() if rid >= 0 else b"\x00" * 16
        sh = itf8(rid) + itf8(int(slice_start[s])) + itf8(int(slice_span[s])) \
            + itf8(b - a) + ltf8(a) + itf8(len(blocks)) + itf8(len(cids) + 1) \
            + itf8(0) + b"".join(itf8(c) for c in cids) + itf8(-1) + md5
        shb = block(RAW, MAPPED_SLICE, 0, sh, len(sh))
        body = chb + shb + b"".join(blocks)
        hdr = container_header(len(body), rid, int(slice_start[s]),
                               int(slice_span[s]), b - a, a,
                               int(ls[a:b].sum()), 2 + len(blocks), [len(chb)])
        crai.append(f"{rid}\t{int(slice_start[s])}\t{int(slice_span[s])}\t"
                    f"{len(out)}\t{len(chb)}\t{len(shb) + sum(map(len, blocks))}\n")
        out += hdr + body
    out += EOF_CONTAINER
    with open(path, "wb") as fh:
        fh.write(out)
    with open(path + ".crai", "wb") as fh:
        fh.write(gzip.compress("".join(crai).encode(), 6, mtime=0))
    truth = dict(r)
    truth["quals"] = _lossy_quals(r, f, lossy) if lossy.any() else r["quals"]
    per_ref = np.bincount(refid[refid >= 0], minlength=len(refs))
    return {"path": path, "records": n, "file_bytes": len(out),
            "containers": nsl, "slices": cuts, "truth": truth,
            "record_bytes": int(record_sizes(truth).sum()),
            "header_text": text,
            "refs": [tuple(x) for x in refs],
            "index_counts": ([int(c) for c in per_ref],
                             int((refid < 0).sum())),
            "attached": int(mates["attached"].sum()),
            "features": {chr(c): int((fcode == c).sum())
                         for c in np.unique(fcode)}}


def write_fasta(path: str, name: str, seq: np.ndarray, width: int = 60
                ) -> None:
    n = len(seq)
    lines = -(-n // width)
    pad = np.full(lines * (width + 1), ord("\n"), np.uint8)
    body = pad.reshape(lines, width + 1)
    full = n // width
    body[:full, :width] = seq[:full * width].reshape(full, width)
    tail = n - full * width
    if tail:
        body[full, :tail] = seq[full * width:]
        body[full, tail] = ord("\n")
        data = body.reshape(-1)[:full * (width + 1) + tail + 1]
    else:
        data = body.reshape(-1)
    head = f">{name}\n".encode()
    with open(path, "wb") as fh:
        fh.write(head)
        fh.write(data.tobytes())
    with open(path + ".fai", "w") as fh:
        fh.write(f"{name}\t{n}\t{len(head)}\t{width}\t{width + 1}\n")


def make(config: dict, seed: int, work: str) -> dict:
    """The configuration's reference, CRAM and CRAI under ``work`` from
    ``seed``; returns their paths, the truth and the sizes."""
    ((name, length),) = [tuple(x) for x in config["references"]]
    ref = reference_seq(int(length), int(config["region_end"]), seed)
    fa = os.path.join(work, "ref.fa")
    write_fasta(fa, name, ref)
    r = synthesize(config, seed, ref)
    per = int(config.get("slice_records", SLICE_RECORDS))
    # the quality blocks, the longest to code, begin at once
    raw = quality_streams(r, slice_cuts(r["refid"].astype(np.int64), per))
    info = write_cram(os.path.join(work, "input.cram"), [(name, int(length))],
                      {name: ref}, r, per, qs_started=(raw, rans_start(raw, 1)))
    info["reference"] = fa
    return info
