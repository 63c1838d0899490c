"""Paired-end BAM files made from a seed: frozen copies of
``chip_smoke.py``'s ``synthesize``, ``encode_chunk``, ``bgzf_block`` and
``write_bam`` (their ``reg2bin`` and coordinate order are the
reference's), with the references and the placed region taken from the
configuration, an optional coordinate sort, and the bases and
qualities drawn in threads (``draw_bases``).

The records: 150 bp paired reads with 28-byte names, RG and NM tags, a
mix of proper pairs, pairs with one mate unmapped, unplaced pairs, soft
clips and deletions, duplicate, QC-fail, secondary and supplementary
flags, insert sizes from N(350, 60); uniform random bases and qualities
from N(34, 6). Payloads are deflated at zlib level 6 in 65,280-byte BGZF
blocks.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.reference.bai import reg2bin
from benchmark.reference.sort import stable_order

READ_LEN = 150
NAME_LEN = 28          # "SIM:1:FC0:1:1101:00000:00000"
TAG_BYTES = 12         # RG:Z:grpK + NUL, NM:C:n
MAX_PAYLOAD = 0xFF00
EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
THREADS = min(8, os.cpu_count() or 1)


def digits(values: np.ndarray, width: int) -> np.ndarray:
    """(n, width) ASCII digits of non-negative ints, zero padded."""
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((values[:, None] // p) % 10 + 48).astype(np.uint8)


def synthesize(n: int, seed: int, refs, region_end=None,
               insert=(350, 60)) -> dict:
    """Columns of ``n`` paired 150 bp reads in pair order over ``refs``
    (``(name, length)`` pairs), all but the bases and qualities
    (``draw_bases``); with ``region_end`` every pair is placed before
    that position."""
    rng = np.random.default_rng(seed)
    pairs = n // 2
    ref_len = np.array([ln for _, ln in refs], np.int64)
    if region_end is not None:
        ref_len = np.minimum(ref_len, int(region_end))
    rid_p = rng.integers(0, len(refs), pairs)
    pos1 = (rng.random(pairs) * (ref_len[rid_p] - 2000)).astype(np.int64)
    insert = np.clip(rng.normal(insert[0], insert[1], pairs), 160,
                     900).astype(np.int64)
    pos2 = pos1 + insert - READ_LEN
    kind = rng.random(pairs)
    half = kind < 0.03            # read2 unmapped, placed at its mate
    gone = kind > 0.99            # both unmapped, unplaced

    refid = np.repeat(rid_p, 2)
    pos = np.stack([pos1, pos2], 1).ravel()
    flag = np.tile(np.array([0x1 | 0x2 | 0x20 | 0x40, 0x1 | 0x2 | 0x10 | 0x80],
                            np.int64), pairs)
    r1, r2 = np.arange(0, n, 2), np.arange(1, n, 2)
    # read2 unmapped: placed at read1, no proper pair
    flag[r2[half]] = 0x1 | 0x4 | 0x20 | 0x80
    flag[r1[half]] = 0x1 | 0x8 | 0x40
    pos[r2[half]] = pos1[half]
    both = np.concatenate([r1[gone], r2[gone]])
    flag[r1[gone]] = 0x1 | 0x4 | 0x8 | 0x40
    flag[r2[gone]] = 0x1 | 0x4 | 0x8 | 0x80
    refid[both] = -1
    pos[both] = -1
    mapped = (flag & 0x4) == 0
    for bit, frac in ((0x400, 0.06), (0x200, 0.004), (0x100, 0.01),
                      (0x800, 0.005)):
        flag[mapped & (rng.random(n) < frac)] |= bit
    mate = np.arange(n) ^ 1
    next_refid, next_pos = refid[mate], pos[mate]
    proper = (flag & 0x2) != 0
    tlen = np.where(proper, np.where((flag & 0x40) != 0, 1, -1)
                    * np.repeat(insert, 2), 0)
    mapq = np.where(mapped, rng.integers(0, 61, n), 0)

    # CIGAR: 150M, soft clip at either end, or a short deletion
    ck = rng.random(n)
    clip = rng.integers(1, 40, n)
    dl = rng.integers(1, 6, n)
    at = rng.integers(20, 130, n)
    ncig = np.where(ck < 0.8, 1, np.where(ck < 0.92, 2, 3))
    ncig[~mapped] = 0
    op = np.zeros((n, 3), np.int64)  # (len << 4) | code; M=0 D=2 S=4
    op[:, 0] = READ_LEN << 4
    lead = rng.random(n) < 0.5
    c2 = ncig == 2
    op[c2 & lead, 0] = (clip[c2 & lead] << 4) | 4
    op[c2 & lead, 1] = (READ_LEN - clip[c2 & lead]) << 4
    op[c2 & ~lead, 0] = (READ_LEN - clip[c2 & ~lead]) << 4
    op[c2 & ~lead, 1] = (clip[c2 & ~lead] << 4) | 4
    c3 = ncig == 3
    op[c3, 0] = at[c3] << 4
    op[c3, 1] = (dl[c3] << 4) | 2
    op[c3, 2] = (READ_LEN - at[c3]) << 4
    span = np.where(c2, READ_LEN - clip, np.where(c3, READ_LEN + dl, READ_LEN))
    bin_ = np.where(mapped, reg2bin(np.maximum(pos, 0),
                                    np.maximum(pos, 0) + span), 4680)
    half_placed = ~mapped & (refid >= 0)
    bin_[half_placed] = reg2bin(pos[half_placed], pos[half_placed] + 1)

    pair_id = np.arange(n) // 2
    names = np.concatenate([
        np.frombuffer(b"SIM:1:FC0:", np.uint8)[None].repeat(n, 0),
        digits(1 + pair_id % 4, 1), np.full((n, 1), ord(":"), np.uint8),
        digits(1101 + (pair_id // 4) % 16, 4), np.full((n, 1), ord(":"), np.uint8),
        digits((pair_id // 64) % 100000, 5), np.full((n, 1), ord(":"), np.uint8),
        digits((pair_id * 7919) % 100000, 5),
    ], axis=1)
    tags = np.zeros((n, TAG_BYTES), np.uint8)
    tags[:, 0:3] = np.frombuffer(b"RGZ", np.uint8)
    tags[:, 3:6] = np.frombuffer(b"grp", np.uint8)
    tags[:, 6] = 48 + pair_id % 4
    tags[:, 8:11] = np.frombuffer(b"NMC", np.uint8)
    tags[:, 11] = np.where(c3, dl, 0) + rng.integers(0, 4, n)
    return dict(refid=refid.astype(np.int32), pos=pos.astype(np.int32),
                mapq=mapq.astype(np.uint8), bin=bin_.astype(np.uint16),
                flag=flag.astype(np.uint16),
                next_refid=next_refid.astype(np.int32),
                next_pos=next_pos.astype(np.int32), tlen=tlen.astype(np.int32),
                ncig=ncig, cig=op.astype(np.uint32), names=names, tags=tags)


BASES_CHUNK = 250_000


def draw_bases(g: dict, seed: int) -> dict:
    """Add each record's bases (uniform over A, C, G, T as 4-bit codes)
    and qualities (N(34, 6) clipped to 2-41, the last 10 at most 20),
    drawn in chunks of records from child seeds of ``seed``, in threads.
    They are independent of every other column, so they are drawn after
    a sort."""
    n = len(g["refid"])
    seq = np.empty((n, READ_LEN), np.uint8)
    qual = np.empty((n, READ_LEN), np.uint8)
    codes = np.array([1, 2, 4, 8], np.uint8)
    los = list(range(0, n, BASES_CHUNK))
    seeds = np.random.SeedSequence([seed, 0xBA5E]).spawn(len(los))

    def one(k):
        lo = los[k]
        hi = min(n, lo + BASES_CHUNK)
        rng = np.random.default_rng(seeds[k])
        seq[lo:hi] = codes[rng.integers(0, 4, (hi - lo, READ_LEN),
                                        dtype=np.uint8)]
        q = rng.normal(34, 6, (hi - lo, READ_LEN))
        np.clip(q, 2, 41, out=q)
        qual[lo:hi] = q
        np.minimum(qual[lo:hi, -10:], 20, out=qual[lo:hi, -10:])

    with ThreadPoolExecutor(THREADS) as pool:
        list(pool.map(one, range(len(los))))
    g["seq"], g["qual"] = seq, qual
    return g


def coordinate_sorted(g: dict) -> dict:
    """The records of ``g`` in coordinate order (a stable sort)."""
    perm = stable_order(g["refid"], g["pos"])
    return {k: v[perm] for k, v in g.items()}


def encode_chunk(g: dict, lo: int, hi: int) -> bytes:
    """BAM record bytes of records [lo, hi), by vectorized scatter."""
    c = hi - lo
    ncig = g["ncig"][lo:hi]
    size = 36 + (NAME_LEN + 1) + 4 * ncig + (READ_LEN + 1) // 2 + READ_LEN + TAG_BYTES
    start = np.zeros(c, np.int64)
    np.cumsum(size[:-1], out=start[1:])
    buf = np.zeros(int(size.sum()), np.uint8)
    fixed = np.zeros(c, dtype=[
        ("bs", "<i4"), ("refid", "<i4"), ("pos", "<i4"), ("lrn", "u1"),
        ("mapq", "u1"), ("bin", "<u2"), ("ncig", "<u2"), ("flag", "<u2"),
        ("lseq", "<i4"), ("nref", "<i4"), ("npos", "<i4"), ("tlen", "<i4")])
    fixed["bs"] = size - 4
    for k, src in (("refid", "refid"), ("pos", "pos"), ("mapq", "mapq"),
                   ("bin", "bin"), ("flag", "flag"), ("nref", "next_refid"),
                   ("npos", "next_pos"), ("tlen", "tlen")):
        fixed[k] = g[src][lo:hi]
    fixed["lrn"] = NAME_LEN + 1
    fixed["ncig"] = ncig
    fixed["lseq"] = READ_LEN

    def put(at, cols):
        buf[at[:, None] + np.arange(cols.shape[1])] = cols

    put(start, fixed.view(np.uint8).reshape(c, 36))
    put(start + 36, g["names"][lo:hi])
    at = start + 36 + NAME_LEN + 1
    cig = g["cig"][lo:hi]
    for k in range(3):
        m = ncig > k
        put(at[m] + 4 * k, cig[m, k:k + 1].copy().view(np.uint8))
    at = at + 4 * ncig
    seq = g["seq"][lo:hi]
    put(at, (seq[:, 0::2] << 4) | seq[:, 1::2])
    at = at + READ_LEN // 2
    put(at, g["qual"][lo:hi])
    put(at + READ_LEN, g["tags"][lo:hi])
    return buf.tobytes()


def bam_header(refs, sort_order: str = "unsorted") -> bytes:
    text = f"@HD\tVN:1.6\tSO:{sort_order}\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in refs) + \
        "".join(f"@RG\tID:grp{k}\tSM:sim\n" for k in range(4))
    tb = text.encode()
    out = b"BAM\x01" + struct.pack("<i", len(tb)) + tb + struct.pack("<i", len(refs))
    for n, ln in refs:
        nb = n.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    return out


def bgzf_block(payload, level: int = 6) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8)
    comp = c.compress(payload) + c.flush()
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
            + struct.pack("<H", len(comp) + 25) + comp
            + struct.pack("<II", zlib.crc32(payload), len(payload)))


def write_bam(path: str, g: dict, n: int, refs, sort_order: str = "unsorted",
              level: int = 6) -> dict:
    """Encode and BGZF-compress the records (thread pool)."""
    with ThreadPoolExecutor(THREADS) as pool:
        step = 100_000
        parts = list(pool.map(lambda lo: encode_chunk(g, lo, min(lo + step, n)),
                              range(0, n, step)))
        payload = bam_header(refs, sort_order) + b"".join(parts)
        del parts
        mv = memoryview(payload)
        blocks = list(pool.map(
            lambda o: bgzf_block(mv[o: o + MAX_PAYLOAD], level),
            range(0, len(payload), MAX_PAYLOAD)))
    with open(path, "wb") as f:
        for b in blocks:
            f.write(b)
        f.write(EOF_BLOCK)
    return {"decoded_bytes": len(payload), "blocks": len(blocks),
            "file_bytes": os.path.getsize(path)}


def make(config: dict, seed: int, work: str) -> dict:
    """The configuration's BAM under ``work`` from ``seed``; returns its
    path and sizes."""
    refs = [tuple(r) for r in config["references"]]
    n = int(config["reads"])
    g = synthesize(n, seed, refs, config.get("region_end"),
                   tuple(config.get("insert", (350, 60))))
    order = config.get("sort_order", "unsorted")
    if order == "coordinate":
        g = coordinate_sorted(g)
    g = draw_bases(g, seed)
    path = os.path.join(work, "input.bam")
    info = write_bam(path, g, n, refs, order, int(config.get("zlib_level", 6)))
    header_len = len(bam_header(refs, order))
    info.update(path=path, records=n, n_ref=len(refs),
                record_bytes=info["decoded_bytes"] - header_len)
    return info
