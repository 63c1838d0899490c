#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``disq_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--seed 0] [--records 2000000]

It builds the eight CUDA kernels from ``disq_tpu_torch/csrc`` (one
``nvcc`` each, all started together), synthesizes an unsorted paired-end
BAM from the seed (150 bp reads over 3 references, compressed with
stdlib zlib into standard BGZF blocks), and drives the port's paths
through their public entry points on ``cuda``:

    storage = ReadsStorage.make_default().split_size(64 << 20)
    ds = storage.read(path); ds.count(); ds.flagstat()
    storage.write(ds, out, BaiWriteOption.ENABLE, sort=True)       # BAM
    # DISQ_TPU_TORCH_DEVICE_INFLATE=legacy: the same read through B4
    storage.executor_workers(4).read(path)                         # executor
    storage.error_policy("skip" | "quarantine").read(flipped)      # policies
    storage.num_shards(8).writer_workers(4).write(ds, out, ..., sort=True)
    storage.write(ds.coordinate_sorted(), out_cram, CraiWriteOption.ENABLE)
    cr = storage.read(out_cram); cr.count(); cr.flagstat()         # CRAM
    storage.executor_workers(4).read(head_cram)                    # executor
    storage.error_policy("skip" | "quarantine").read(flipped_head) # policies
    storage.num_shards(8).write(sorted_ds, out, BaiWriteOption.ENABLE,
                                SbiWriteOption.ENABLE)             # SBI
    storage.num_shards(8).write(ds, out_dir, FileCardinalityWriteOption
                                .MULTIPLE, ReadsFormatWriteOption.BAM)
    storage.num_shards(4).write(head_200k, out_dir, ..MULTIPLE, ..CRAM)
    storage.num_shards(8).write(sorted_ds, out, StageManifestWriteOption(m),
                                BaiWriteOption.ENABLE, SbiWriteOption.ENABLE)
    storage.read_ledger(dir).read("fault://" + path)               # resume
    ds.depth(1024); ds.reads.filter(mapq >= 20); ds.reads.permuted(order)
    ds.device_columns()
    storage.device_deflate().write(ds, out, BaiWriteOption.ENABLE,
                                   sort=True)                      # W1, W2
    storage.num_shards(8).writer_workers(4).device_deflate().write(
        ds, out, BaiWriteOption.ENABLE, SbiWriteOption.ENABLE, sort=True)
    # DISQ_TPU_TORCH_DEVICE_SERVICE=1: B1, B3 and W2 fed by the service
    storage.executor_workers(1 | 4).read(path)
    storage.executor_workers(4).read(head_cram)    # service flush 5 s
    storage.num_shards(8).writer_workers(4).device_deflate().write(
        sorted_host, out, BaiWriteOption.ENABLE, SbiWriteOption.ENABLE)
    tracing.start_trace(dir); storage.read(path); tracing.stop_trace()
    storage.read_filter("-F 0x904 -q 20 -s 7.5").read(dups)        # F1
    ds.pipeline(("filter", "-F 0x400"), "sort", "markdup", "rgstats",
                ("pileup", 0, 1_000_000, 5_194_304))               # resident
    host_ds.pipeline(...); storage.write(result, out)              # host

The CRAM is written with ``DISQ_TPU_TORCH_CRAM_RANS_O1=0``, so its
quality scores are order-0 rANS streams (one per 10,000-record
container), which the read decodes on the card: kernel B3, and B5 on a
second read under ``DISQ_TPU_TORCH_DEVICE_RANS=legacy``.

It checks each path's results against the generator (counts, flagstat,
sort permutation, the sorted BAM re-read record for record, every output
block inflating with zlib, the CRAM read column for column), the legacy
and the 4-worker reads against the default read, the skip and quarantine
reads of a copy with one flipped bit against the generator's records
outside that block (and the quarantine sidecar against the corrupt
bytes), the 4-worker write against the 1-worker write byte for byte,
the same for CRAM on the file's first 3 splits (the 4-worker read against
the default one; the strict, skip and quarantine reads of a copy with one
byte flipped in a container of split 2, the sidecar against that
container's bytes), every
CRAM read's ``ds.counters`` against the file's containers; then the
rest of the configured read and write: the 8-shard BAM + BAI with the
SBI byte-identical to the write without it, every SBI offset on a record
start found by a host walk of the output, and the re-read planned by the
SBI alone; the directory of 8 BAMs and of 4 CRAMs (the first 200,000
sorted records: a cut of depth), each part re-read equal to its slice;
a manifest-resumed write (shard 3 fails in a wrapper of the sink's
per-shard step; the resume runs shards 3-7 and writes the uninterrupted
write's BAM, BAI and SBI byte for byte); ledger-resumed BAM and CRAM
reads (split 4 of the BAM and split 2 of the CRAM head copy fail their
fetch through the fault-injecting filesystem; the resume launches B1 for
the unfinished splits only, B2 once more for each spilled split, B3
once, and its records and counters equal the uninterrupted read's);
depth against a numpy difference array of the generator; filter and
permuted device-backed and equal to the host batch's; device_columns
with no transfer; the device write path (records gathered by W1 and
literal-Huffman coded by W2) at the main path's one shard and at 8
shards with 4 writer workers, each output inflating with zlib to the
zlib-6 write's stream, its BAI and SBI mapping (virtual offset to
uncompressed offset) to the zlib-6 write's, its re-read equal to the
generator, W1 and W2 held against their plain versions on the whole shard
(W2 also on edge lanes under 15-bit codes, an incompressible one taking
the host route), and the write's stages replayed one by one. It shows from
the launch counts (zeroed just before each path, read just after) that
each path went through its kernels, holds each kernel against its plain
version on the inputs of split 0 (the inflate kernels' pure-Python plain
versions in one spawned process per core) and on a sample of corrupt,
truncated and edge-case inputs (B3 also against the native host decoder
on every stream of the file), and times them: through the wrapper with
CUDA events, and on the device alone as a CUDA graph of their launches
replayed between events (``graph_ms``), B1, B3, B4 and B5 also on one
payload or stream alone, beside their launch geometry. The default writes
do no device deflate work. Through the device service: the BAM read at
1 and 4 executor workers equal to the default read, every submitted lane
decoded on the card (``device_lanes == submitted``, no lane decoded
again on the host), one B1 launch per flush; the CRAM read (4 workers)
of the 3-split head equal to the generator, its splits' order-0 streams
sharing B3 launches (fewer launches than splits, under a 5 s flush
window) and none decoded on the host; the device write of the sorted
host batch through the service's deflate engine inflating to the zlib-6
write's stream, no lane but an expanded one on host zlib, and
re-reading to the generator; and, on the chunk of each engine that
coalesced the most owners, what the dispatcher itself fetched for that
launch: B1's blob against zlib on every lane and its plain version on a
sample, B3's against the native decoder on every stream and its plain
version on a sample, W2's against its plain version on every lane. The ``spans`` line sums the span ring per stage for the default
BAM read, the zlib-6 sort+write and the CRAM read; the ``hbm`` line sets
the ``device.hbm_bytes`` gauge's peak over the read beside
``torch.cuda.max_memory_allocated``; the ``trace`` line counts B1 and B2
kernel events in a ``torch.profiler`` trace of one BAM read against
their launches and, when they agree, gives the device's busy share of
the read. The operators phase writes ``dups.bam`` (the same generator,
a seeded 5 % of pairs copying another pair's refid, pos, CIGAR and
flags under their own names and qualities) and checks the filtered read
against a numpy mask of this script's own (FNV-1a names, the subsample
mix), F1 once per split; F1 against its plain version on every record;
the chain on the device-backed dataset and on a host ``ReadBatch`` copy:
equal stats, duplicates equal to a numpy group oracle over the
generator's columns, per-RG counts and coverage equal to the generator's,
no host record parse on the resident chain, both results written with
zlib-6 byte for byte and their 0x400 count equal to the stats; and
times the markdup scan and the RG reduction (torch ops) alone. Any
failed phase exits non-zero.
The last lines of standard output are the card's name and power limit,
one JSON line of per-kernel numbers, and ``{"ok": true, "device": ...}``.

It imports neither ``jax`` nor the JAX package, and writes only under
``.smoke/`` in the checkout, which it removes at the end.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import struct
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

REFS = (("chr1", 248956422), ("chr2", 242193529), ("chr3", 198295559))
READ_LEN = 150
NAME_LEN = 28          # "SIM:1:FC0:1:1101:00000:00000"
TAG_BYTES = 12         # RG:Z:grpK + NUL, NM:C:n
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12    # H100 SXM float32 rate outside the tensor cores
MAX_PAYLOAD = 0xFF00
INFLATE_OPS_PER_BYTE = 10   # per decoded byte: bit reads, table walk, store
WRITE_SHARDS = 8            # write shards of the parallel-write leg


class PhaseError(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- input synthesis (independent of the read path) -------------------------


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """SAM spec §5.3 reg2bin over 0-based half-open [beg, end)."""
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = offset + (beg[hit] >> shift)
        done |= hit
    return out


def digits(values: np.ndarray, width: int) -> np.ndarray:
    """(n, width) ASCII digits of non-negative ints, zero padded."""
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((values[:, None] // p) % 10 + 48).astype(np.uint8)


def synthesize(n: int, seed: int) -> dict:
    """Columns of ``n`` paired 150 bp reads in unsorted (pair) order:
    mapped proper pairs, pairs with one mate unmapped, fully unmapped
    pairs, soft clips and deletions, duplicates, secondary,
    supplementary and QC-failed reads, RG and NM tags."""
    rng = np.random.default_rng(seed)
    pairs = n // 2
    ref_len = np.array([ln for _, ln in REFS], np.int64)
    rid_p = rng.integers(0, len(REFS), pairs)
    pos1 = (rng.random(pairs) * (ref_len[rid_p] - 2000)).astype(np.int64)
    insert = np.clip(rng.normal(350, 60, pairs), 160, 900).astype(np.int64)
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
    seq = np.array([1, 2, 4, 8], np.uint8)[rng.integers(0, 4, (n, READ_LEN))]
    qual = np.clip(rng.normal(34, 6, (n, READ_LEN)), 2, 41).astype(np.uint8)
    qual[:, -10:] = np.minimum(qual[:, -10:], 20)
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
                ncig=ncig, cig=op.astype(np.uint32), names=names, seq=seq,
                qual=qual, tags=tags)


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


def bam_header(sort_order: str = "unsorted") -> bytes:
    text = f"@HD\tVN:1.6\tSO:{sort_order}\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in REFS) + \
        "".join(f"@RG\tID:grp{k}\tSM:sim\n" for k in range(4))
    tb = text.encode()
    out = b"BAM\x01" + struct.pack("<i", len(tb)) + tb + struct.pack("<i", len(REFS))
    for n, ln in REFS:
        nb = n.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    return out


EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")


def bgzf_block(payload: bytes) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 8)
    comp = c.compress(payload) + c.flush()
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
            + struct.pack("<H", len(comp) + 25) + comp
            + struct.pack("<II", zlib.crc32(payload), len(payload)))


def write_bam(path: str, g: dict, n: int) -> dict:
    """Encode and BGZF-compress the synthesized records (thread pool)."""
    with ThreadPoolExecutor(8) as pool:
        step = 100_000
        parts = list(pool.map(lambda lo: encode_chunk(g, lo, min(lo + step, n)),
                              range(0, n, step)))
        payload = bam_header() + b"".join(parts)
        del parts
        mv = memoryview(payload)
        blocks = list(pool.map(
            lambda o: bgzf_block(mv[o: o + MAX_PAYLOAD]),
            range(0, len(payload), MAX_PAYLOAD)))
    with open(path, "wb") as f:
        for b in blocks:
            f.write(b)
        f.write(EOF_BLOCK)
    return {"decoded_bytes": len(payload), "blocks": len(blocks),
            "file_bytes": os.path.getsize(path)}


def walk_blocks(data: bytes):
    """(offset, total size) of every BGZF block, by the BSIZE chain."""
    out, p = [], 0
    while p < len(data):
        check(data[p:p + 4] == b"\x1f\x8b\x08\x04", f"no BGZF block at {p}")
        xlen = struct.unpack_from("<H", data, p + 10)[0]
        q, bsize = p + 12, None
        while q < p + 12 + xlen:
            if data[q:q + 2] == b"BC":
                bsize = struct.unpack_from("<H", data, q + 4)[0]
            q += 4 + struct.unpack_from("<H", data, q + 2)[0]
        check(bsize is not None, f"no BC field at {p}")
        out.append((p, bsize + 1, 12 + xlen))
        p += bsize + 1
    return out


def zlib_check_all(data: bytes) -> int:
    """Inflate every block with zlib, checking CRC and ISIZE; returns
    the decoded byte count."""
    def one(blk):
        p, total, hdr = blk
        raw = zlib.decompress(data[p + hdr: p + total - 8], -15)
        crc, isize = struct.unpack_from("<II", data, p + total - 8)
        check(zlib.crc32(raw) == crc and len(raw) == isize,
              f"block at {p} fails CRC/ISIZE")
        return len(raw)

    with ThreadPoolExecutor(8) as pool:
        return sum(pool.map(one, walk_blocks(data)))


def numpy_flagstat(flag: np.ndarray) -> dict:
    f = flag.astype(np.int64)
    primary = (f & 0x900) == 0
    paired = primary & ((f & 1) != 0)
    mapped = (f & 4) == 0
    mate_unmapped = (f & 8) != 0
    return {
        "total": int(len(f)), "secondary": int(((f & 0x100) != 0).sum()),
        "supplementary": int(((f & 0x800) != 0).sum()),
        "duplicates": int(((f & 0x400) != 0).sum()),
        "mapped": int(mapped.sum()), "paired": int(paired.sum()),
        "read1": int((paired & ((f & 0x40) != 0)).sum()),
        "read2": int((paired & ((f & 0x80) != 0)).sum()),
        "proper_pair": int((paired & ((f & 2) != 0) & mapped).sum()),
        "with_mate_mapped": int((paired & mapped & ~mate_unmapped).sum()),
        "singletons": int((paired & mapped & mate_unmapped).sum()),
        "qc_fail": int(((f & 0x200) != 0).sum()),
    }


def coordinate_keys(refid, pos):
    rid = np.where(refid < 0, 0x7FFFFFFF, refid.astype(np.int64))
    return (rid.astype(np.uint64) << np.uint64(32)) | \
        ((pos.astype(np.int64) + 1).astype(np.uint64) & np.uint64(0xFFFFFFFF))


# -- timing ------------------------------------------------------------------


def cuda_ms(torch, fn, warmup: int = 2, iters: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(torch, fn, iters: int = 20, reps: int = 10) -> float:
    """Device time per call of ``fn`` with the host taken out: ``iters``
    calls captured in one CUDA graph (after a warm-up call on a side
    stream), the graph replayed ``reps`` times between two CUDA events.
    A wrapper's launch count goes up by ``iters`` at the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * iters)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phases ------------------------------------------------------------------


def inflate_inputs(torch, data: bytes, blocks, dev):
    """Kernel inputs for decoding ``blocks`` of ``data``."""
    pay_off = np.array([p + h for p, _, h in blocks], np.int64)
    pay_len = np.array([t - h - 8 for _, t, h in blocks], np.int64)
    usize = np.array([struct.unpack_from("<I", data, p + t - 4)[0]
                      for p, t, _ in blocks], np.int64)
    out_off = np.concatenate([[0], np.cumsum(usize)]).astype(np.int64)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    comp = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    return (comp, t(pay_off), t(pay_len), t(out_off)), int(out_off[-1]), \
        int(pay_len.sum()), int(out_off[-1])


# -- the CRAM path -----------------------------------------------------------


def crai_container_offsets(path: str) -> list:
    """Container offsets a ``.crai`` lists (gzip text, one line per
    slice, the container's byte offset in field 4)."""
    text = gzip.decompress(open(path, "rb").read()).decode()
    return [int(line.split("\t")[3]) for line in text.splitlines() if line]


def itf8(data, p: int):
    """(value, next position) of the ITF-8 integer at ``p`` (CRAM 3.0
    §2.3), as unsigned 32 bits."""
    b = data[p]
    if b < 0x80:
        return b, p + 1
    if b < 0xC0:
        return ((b & 0x7F) << 8) | data[p + 1], p + 2
    if b < 0xE0:
        return ((b & 0x3F) << 16) | (data[p + 1] << 8) | data[p + 2], p + 3
    if b < 0xF0:
        return (((b & 0x1F) << 24) | (data[p + 1] << 16) | (data[p + 2] << 8)
                | data[p + 3]), p + 4
    return (((b & 0x0F) << 28) | (data[p + 1] << 20) | (data[p + 2] << 12)
            | (data[p + 3] << 4) | (data[p + 4] & 0x0F)), p + 5


def container_fields(data, off: int):
    """(block bytes, record count) of the container at ``off``: its int32
    length, then reference id, start and span, then the record count,
    each ITF-8 (CRAM 3.0 §7.1)."""
    length = struct.unpack_from("<i", data, off)[0]
    p = off + 4
    for _ in range(3):
        _, p = itf8(data, p)
    return length, itf8(data, p)[0]


def qs_streams(path: str, offsets: list) -> list:
    """The QS block's compressed bytes (a full rANS stream) of each data
    container at ``offsets``, parsed with the port's block reader."""
    from disq_tpu_torch.cram.codec import CID, read_stored_blocks
    from disq_tpu_torch.cram.structure import read_container_header_at
    from disq_tpu_torch.fsw.filesystem import PosixFileSystemWrapper

    fs = PosixFileSystemWrapper()
    length = fs.get_file_length(path)
    out = []
    for off in offsets:
        hdr, hdr_size = read_container_header_at(fs, path, off, length)
        blocks = read_stored_blocks(fs.read_range(path, off + hdr_size,
                                                  hdr.length))
        qs = [b for b in blocks if b.content_id == CID["QS"]]
        check(len(qs) == 1 and qs[0].is_rans0,
              f"container at {off}: QS is not one order-0 rANS block")
        out.append(qs[0].comp)
    return out


def rans_sample(g: dict, seed: int):
    """Streams for the kernel-vs-plain check: tiny, empty and
    single-symbol streams, 64 KiB slices of the generator's quality bytes
    (native order-0 encoder), the edge streams of ``ops/rans_cases.py``
    (raw sizes 1-7, one symbol, all 256 symbols, a superstep with 8
    renorm bytes), and truncated copies that must flag status 6, one of
    them only in its last superstep. Returns (raws, valid streams,
    truncated streams)."""
    from disq_tpu_torch.native import rans_encode0_native
    from disq_tpu_torch.ops import rans_cases

    rng = np.random.default_rng(seed)
    raws = [b"", b"x", b"ab", bytes(range(5)), b"A" * 4096, b"\x00" * 3]
    q = g["qual"].reshape(-1)
    for start in rng.integers(0, len(q) - 65536, 8):
        raws.append(q[start: start + 65536].tobytes())
    streams = [rans_encode0_native(r) for r in raws]
    truncated = [rans_cases.truncated(streams[k], cut)
                 for k, cut in ((6, 1), (7, 40), (8, 5000), (9, 1))]
    _names, e_raws, e_streams, e_cut = rans_cases.edge_streams(
        rans_encode0_native)
    check(max(rans_cases.superstep_renorms(e_streams[-1])) == 8,
          "no superstep of the sample takes 8 renorm bytes")
    return raws + e_raws, streams + e_streams, truncated + e_cut


RANS_OPS_PER_SYMBOL = 10   # mask, 3 table reads, shift, mul, add, sub, renorm


def rans_bound(ren_off: np.ndarray, out_off: np.ndarray):
    """(bound ms, "bytes" or "operations") of a rANS decode: the bytes it
    must move (each renorm byte and table read once: offsets 16, states
    16, freqs 1024 per stream; each output byte, ``used`` and ``status``
    written once) over the memory rate, against its 32-bit scalar
    operations (``RANS_OPS_PER_SYMBOL`` per output byte) over the
    card's scalar rate."""
    n = len(ren_off) - 1
    nbytes = int(ren_off[-1] + out_off[-1]) + n * (16 + 16 + 1024 + 12)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = int(out_off[-1]) * RANS_OPS_PER_SYMBOL / SCALAR_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def _import_plain() -> None:
    """Pool initializer: the plain versions' modules, before timing."""
    sys.path.insert(0, HERE)
    import disq_tpu_torch.ops.inflate  # noqa: F401
    import disq_tpu_torch.ops.inflate_simd  # noqa: F401
    import disq_tpu_torch.ops.rans  # noqa: F401


def _plain_chunk(job):
    """One process's share of a kernel's plain version: ``(kind,
    payloads, usizes)`` → its outputs on those payloads as numpy arrays;
    ``kind`` is ``inflate`` (B1: blob, lengths, statuses),
    ``inflate_legacy`` (B4: rows, meta), or ``rans_simd`` / ``rans`` (B3
    / B5 on rANS streams, ``usizes`` unused: out, used, statuses)."""
    import torch

    kind, payloads, usizes = job
    if kind in ("rans_simd", "rans"):
        from disq_tpu_torch.ops import rans as B5
        from disq_tpu_torch.ops import rans_simd as B3

        _live, staged, _offs = B3.stage_streams(payloads, "cpu")
        plain = B3 if kind == "rans_simd" else B5
        return [t.numpy() for t in plain.rans0_decode_plain(*staged)]
    lens = np.array([len(p) for p in payloads], np.int64)
    off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    comp = torch.frombuffer(bytearray(b"".join(payloads)), dtype=torch.uint8)
    if kind == "inflate":
        from disq_tpu_torch.ops import inflate_simd as B1

        out_off = np.concatenate([[0], np.cumsum(usizes)]).astype(np.int64)
        res = B1.inflate_plain(comp, torch.from_numpy(off),
                               torch.from_numpy(lens),
                               torch.from_numpy(out_off), int(out_off[-1]))
    else:
        from disq_tpu_torch.ops import inflate as B4

        res = B4.inflate_stacked_plain(
            comp, torch.from_numpy(off), torch.from_numpy(lens.astype(np.int32)),
            torch.tensor(usizes, dtype=torch.int32))
    return [t.numpy() for t in res]


def plain_on_payloads(kind: str, payloads, usizes, jobs_per_proc: int = 4):
    """``kind``'s plain version on every payload (or stream), in
    contiguous chunks over one spawned process per CPU core, up to 8,
    ``jobs_per_proc`` chunks each; the pool starts and imports before the
    clock does. Returns (the outputs, each joined in payload order; wall
    ms; processes)."""
    return plain_async(kind, payloads, usizes, jobs_per_proc)()


def plain_async(kind: str, payloads, usizes, jobs_per_proc: int = 4):
    """``plain_on_payloads`` started in the background: returns the call
    that waits for it and returns its result (the wall ms end when the
    last chunk is done, not when the caller waits)."""
    import multiprocessing

    procs = max(1, min(8, os.cpu_count() or 1))
    step = -(-len(payloads) // (jobs_per_proc * procs))
    jobs = [(kind, payloads[i: i + step], list(usizes[i: i + step]))
            for i in range(0, len(payloads), step)]
    pool = multiprocessing.get_context("spawn").Pool(
        procs, initializer=_import_plain)
    pool.map(time.sleep, [0.5] * procs, chunksize=1)
    done = {}
    t0 = time.perf_counter()
    res = pool.map_async(_plain_chunk, jobs, chunksize=1,
                         callback=lambda _: done.setdefault(
                             "t", time.perf_counter()))

    def wait():
        try:
            parts = res.get()
        finally:
            pool.close()
            pool.join()
        ms = (done.get("t", time.perf_counter()) - t0) * 1e3
        return [np.concatenate(col) for col in zip(*parts)], ms, procs

    return wait


def rans_errors(k, p, n_truncated: int):
    """(max abs error, mismatches) of a rANS kernel's outputs ``k``
    against its plain version's ``p`` (numpy ``out``, ``used``,
    ``status``); the last ``n_truncated`` streams must flag status 6,
    the others 0."""
    err = max(int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max(
        initial=0)) for a, b in zip(k, p))
    mismatches = sum(int((a != b).sum()) for a, b in zip(k, p))
    st = k[2]
    want = np.zeros(len(st), dtype=st.dtype)
    want[len(st) - n_truncated:] = 6
    check(np.array_equal(st, want), f"statuses: {st.tolist()}")
    return err, mismatches


def check_against_plain(torch, kernel, plain, staged, total: int,
                        n_truncated: int):
    """Kernel and plain version on the same staged streams, on the card:
    returns (max abs error, mismatches, the plain version's ms)."""
    k = [t.cpu().numpy() for t in kernel(*staged, total)]
    t0 = time.perf_counter()
    p = [t.cpu().numpy() for t in plain(*staged)]
    plain_ms = (time.perf_counter() - t0) * 1e3
    return (*rans_errors(k, p, n_truncated), plain_ms)


def cram_phases(torch, port, args, g, perm_want, ds, storage, work, dev):
    """Write the sorted dataset as CRAM, read it back on the card through
    B3 and (legacy knob) B5, and hold both kernels against their plain
    versions and B3 against the native decoder; returns (kernel entries,
    e2e fields, the 3-split head copy of ``cram_policy_legs``)."""
    from disq_tpu_torch.native import rans_decode_native
    from disq_tpu_torch.ops import cuda_build
    from disq_tpu_torch.ops import rans as B5
    from disq_tpu_torch.ops import rans_simd as B3
    from disq_tpu_torch.runtime import counters, tracing

    n = args.records
    cram = os.path.join(work, "sorted.cram")
    # quality scores as order-0 rANS: the streams the device decodes
    os.environ["DISQ_TPU_TORCH_CRAM_RANS_O1"] = "0"
    sorted_ds = ds.coordinate_sorted()
    t0 = time.perf_counter()
    storage.write(sorted_ds, cram, port.CraiWriteOption.ENABLE)
    cram_write_s = time.perf_counter() - t0
    del sorted_ds
    offsets = crai_container_offsets(cram + ".crai")
    file_bytes = os.path.getsize(cram)
    splits_with_streams = len({off // args.split_size for off in offsets})
    log(f"cram write: {cram_write_s:.3f}s ({n / cram_write_s:.0f} rec/s), "
        f"{len(offsets)} containers, {file_bytes} file bytes, "
        f"{splits_with_streams} splits hold order-0 streams")

    # -- the CRAM read on cuda (B3) -----------------------------------------
    counters.reset()
    B3.last_stats.update(device_lanes=0, host_big=0, host_fallback=0)
    tracing.reset_spans()
    t0 = time.perf_counter()
    cr = storage.read(cram)
    torch.cuda.synchronize()
    cram_read_s = time.perf_counter() - t0
    cram_spans = span_sums(tracing)
    count, fstat = cr.count(), cr.flagstat()
    main = counters.snapshot()
    stats = dict(B3.last_stats)
    data = open(cram, "rb").read()
    fields = [container_fields(data, off) for off in offsets]
    check(sum(r for _, r in fields) == n, "container record counts")
    cram_counters_ok(cr, n, fields, args, file_bytes, "cram read")
    log(f"cram read: {cram_read_s:.3f}s ({n / cram_read_s:.0f} rec/s), "
        f"counters {json.dumps(main)}, rans_simd stats {json.dumps(stats)}")
    check(count == n, f"cram count {count} != {n}")
    check(fstat == numpy_flagstat(g["flag"]), f"cram flagstat {fstat}")
    rb = cr.reads
    refid = g["refid"][perm_want]
    for col in ("refid", "pos", "mapq", "bin", "flag", "next_refid",
                "next_pos", "tlen"):
        want = g[col][perm_want]
        if col == "bin":
            # CRAM stores no bin: the reader recomputes it from the CIGAR
            # at max(pos, 0), as the reference does, so unplaced reads
            # get reg2bin(0, 1)
            want = np.where(refid < 0, reg2bin(np.zeros(1, np.int64),
                                               np.ones(1, np.int64))[0], want)
        check(np.array_equal(getattr(rb, col), want.astype(g[col].dtype)),
              f"cram column {col}")
    check(np.array_equal(rb.names.reshape(n, NAME_LEN), g["names"][perm_want]),
          "cram names")
    ncig = g["ncig"][perm_want]
    cig_want = g["cig"][perm_want][np.arange(3)[None, :] < ncig[:, None]]
    check(np.array_equal(rb.cigars, cig_want), "cram cigars")
    check(np.array_equal(rb.seqs.reshape(n, READ_LEN), g["seq"][perm_want]),
          "cram seqs")
    check(np.array_equal(rb.quals.reshape(n, READ_LEN), g["qual"][perm_want]),
          "cram quals")
    check(np.array_equal(rb.tags.reshape(n, TAG_BYTES), g["tags"][perm_want]),
          "cram tags")
    launches = main["launches"]
    check(splits_with_streams > 0, "no split holds an order-0 stream")
    check(launches.get("rans_simd", 0) == splits_with_streams,
          f"rans_simd launches {launches.get('rans_simd', 0)} != "
          f"{splits_with_streams} splits holding order-0 streams")
    check(stats["host_big"] == 0 and stats["host_fallback"] == 0,
          f"host streams on the CRAM path: {stats}")
    check(stats["device_lanes"] == len(offsets),
          "not every QS stream was decoded on the device")
    check(main["host_rans_streams"].get("rans0", 0) == 0,
          "an order-0 stream reached the host decoder")
    log("cram results: count, flagstat and every column exact")

    # -- B3 against the native decoder on every QS stream -------------------
    streams = qs_streams(cram, offsets)
    got = B3.rans0_decode_simd(streams, dev)
    bad = sum(a != rans_decode_native(s) for a, s in zip(got, streams))
    check(bad == 0, f"B3 differs from the native decoder on {bad} streams")
    del got
    log(f"rans_simd vs native: all {len(streams)} QS streams exact "
        f"({sum(len(s) for s in streams)} stream bytes)")

    # -- both kernels against their plain versions on a sample -------------
    raws, sample, truncated = rans_sample(g, args.seed + 2)
    check(B3.rans0_decode_simd(sample, dev) == raws, "B3 on the sample")
    check(B5.rans0_decode_device(sample, dev) == raws, "B5 on the sample")
    for t in truncated:
        for fn in (B3.rans0_decode_simd, B5.rans0_decode_device):
            try:
                fn([t], dev)
            except ValueError as e:
                check("overran stream 0" in str(e), f"truncated: {e}")
            else:
                raise PhaseError(f"{fn.__name__} accepted a truncated stream")
    _live, s_args, (s_ren, s_out) = B3.stage_streams(sample + truncated, dev)
    s_total = int(s_out[-1])
    b3_s_err, b3_s_mism, b3_s_plain_ms = check_against_plain(
        torch, B3.rans0_decode, B3.rans0_decode_plain, s_args, s_total,
        len(truncated))
    b5_s_err, b5_s_mism, b5_s_plain_ms = check_against_plain(
        torch, B5.rans0_decode_legacy, B5.rans0_decode_plain, s_args, s_total,
        len(truncated))
    check(b3_s_err == 0 and b3_s_mism == 0,
          "rans_simd kernel != plain version on the sample")
    check(b5_s_err == 0 and b5_s_mism == 0,
          "rans kernel != plain version on the sample")
    b3_sample_ms = cuda_ms(torch, lambda: B3.rans0_decode(*s_args, s_total), 1, 3)
    b5_sample_ms = cuda_ms(
        torch, lambda: B5.rans0_decode_legacy(*s_args, s_total), 1, 3)
    del s_args

    # -- the kernels at the main path's shape: split 0's streams -----------
    first = [s for off, s in zip(offsets, streams) if off < args.split_size]
    _live, m_args, (m_ren, m_out) = B3.stage_streams(first, dev)
    m_total = int(m_out[-1])
    # the plain versions on host copies, one spawned process per core
    # (their few small torch ops per 4 output bytes cost less there than
    # their launches on the card)
    b3_k = [t.cpu().numpy() for t in B3.rans0_decode(*m_args, m_total)]
    b3_p, b3_plain_ms, procs = plain_on_payloads("rans_simd", first,
                                                 [0] * len(first), 1)
    b3_err, b3_mism = rans_errors(b3_k, b3_p, 0)
    b5_k = [t.cpu().numpy() for t in B5.rans0_decode_legacy(*m_args, m_total)]
    b5_p, b5_plain_ms, _ = plain_on_payloads("rans", first, [0] * len(first),
                                             1)
    b5_err, b5_mism = rans_errors(b5_k, b5_p, 0)
    del b3_k, b3_p, b5_k, b5_p
    check(b3_err == 0 and b3_mism == 0,
          "rans_simd kernel != plain version on split 0")
    check(b5_err == 0 and b5_mism == 0,
          "rans kernel != plain version on split 0")
    b3_ms = cuda_ms(torch, lambda: B3.rans0_decode(*m_args, m_total), 1, 3)
    b5_ms = cuda_ms(torch, lambda: B5.rans0_decode_legacy(*m_args, m_total),
                    1, 3)
    b3_dev_ms = graph_ms(torch, lambda: B3.rans0_decode(*m_args, m_total),
                         3, 2)
    b5_dev_ms = graph_ms(
        torch, lambda: B5.rans0_decode_legacy(*m_args, m_total), 3, 2)
    bound_ms, bound_by = rans_bound(m_ren, m_out)
    b3_geom = cuda_build.geometry("rans_simd", len(m_ren) - 1)
    b5_geom = cuda_build.geometry("rans", len(m_ren) - 1)
    # one stream alone: the latency of one warp's decode
    one = (m_args[0], m_args[1][:2].contiguous(), m_args[2][:2].contiguous(),
           m_args[3][:1].contiguous(), m_args[4][:1].contiguous())
    one_out = int(m_out[1])
    b3_one_ms = cuda_ms(torch, lambda: B3.rans0_decode(*one, one_out), 1, 3)
    b5_one_ms = cuda_ms(torch, lambda: B5.rans0_decode_legacy(*one, one_out),
                        1, 3)
    log(f"rans: sample of {len(sample) + len(truncated)} streams "
        f"({len(truncated)} truncated), kernels {b3_sample_ms:.3f} / "
        f"{b5_sample_ms:.3f} ms vs plain {b3_s_plain_ms:.1f} / "
        f"{b5_s_plain_ms:.1f} ms; split 0: "
        f"{len(first)} streams {int(m_ren[-1])} -> {m_total} bytes, "
        f"rans_simd {b3_ms:.3f} ms, rans {b5_ms:.3f} ms vs plain "
        f"{b3_plain_ms:.1f} / {b5_plain_ms:.1f} ms, 0 mismatches; geometry "
        f"{json.dumps(b3_geom)} / {json.dumps(b5_geom)}; one stream "
        f"({one_out} bytes) {b3_one_ms:.4f} / {b5_one_ms:.4f} ms")
    del streams, first, m_args

    # -- the CRAM read under the legacy knob (B5) ---------------------------
    os.environ["DISQ_TPU_TORCH_DEVICE_RANS"] = "legacy"
    try:
        counters.reset()
        B5.last_stats.update(device_lanes=0, host_big=0, host_fallback=0)
        t0 = time.perf_counter()
        cr5 = storage.read(cram)
        torch.cuda.synchronize()
        legacy_read_s = time.perf_counter() - t0
        legacy = counters.snapshot()
    finally:
        del os.environ["DISQ_TPU_TORCH_DEVICE_RANS"]
    l_launches = legacy["launches"]
    log(f"cram read (legacy): {legacy_read_s:.3f}s, counters "
        f"{json.dumps(legacy)}, rans stats {json.dumps(B5.last_stats)}")
    check(l_launches.get("rans", 0) == splits_with_streams
          and l_launches.get("rans_simd", 0) == 0,
          f"legacy read launches {l_launches}")
    check(legacy["host_rans_streams"].get("rans0", 0) == 0,
          "an order-0 stream reached the host decoder (legacy)")
    for col in ("refid", "pos", "flag", "seqs", "quals", "names", "tags",
                "cigars"):
        check(np.array_equal(getattr(cr5.reads, col), getattr(rb, col)),
              f"legacy cram column {col}")
    cram_counters_ok(cr5, n, fields, args, file_bytes, "legacy cram read")
    del cr5
    policy_e2e, head = cram_policy_legs(torch, port, args, g, perm_want, cram,
                                        data, offsets, fields, cr.reads)
    del cr, rb, data
    os.environ.pop("DISQ_TPU_TORCH_CRAM_RANS_O1")

    shape = {"streams": len(m_ren) - 1, "bytes_in": int(m_ren[-1]),
             "bytes_out": m_total}
    common = {"route": "cuda", "library_ms": None,
              "bound_by": bound_by, "tolerance": 0, "shape": shape,
              "bound_ms": round(bound_ms, 6),
              "plain_on": f"the same inputs (split 0's streams), host, "
                          f"{procs} processes",
              "sample": f"{len(sample) + len(truncated)} streams, "
                        f"{len(truncated)} truncated"}
    kernels = [
        {"name": "rans_simd", **common,
         "source": "disq_tpu_torch/csrc/rans_simd.cu",
         "replaces": "disq_tpu/ops/rans_simd.py:91",
         "launches": launches.get("rans_simd", 0), "max_abs_err": b3_err,
         "ms": round(b3_ms, 4), "plain_ms": round(b3_plain_ms, 4),
         "ms_device": round(b3_dev_ms, 4),
         "mismatches": b3_mism, "sample_mismatches": b3_s_mism,
         "ms_on_sample": round(b3_sample_ms, 4),
         "plain_ms_on_sample": round(b3_s_plain_ms, 4),
         "geometry": b3_geom,
         "single_stream": {"bytes_out": one_out, "ms": round(b3_one_ms, 4),
                           "ns_per_byte": round(b3_one_ms * 1e6 / one_out, 3)}},
        {"name": "rans", **common,
         "source": "disq_tpu_torch/csrc/rans.cu",
         "replaces": "disq_tpu/ops/rans.py:50",
         "launches": l_launches.get("rans", 0), "max_abs_err": b5_err,
         "ms": round(b5_ms, 4), "plain_ms": round(b5_plain_ms, 4),
         "ms_device": round(b5_dev_ms, 4),
         "mismatches": b5_mism, "sample_mismatches": b5_s_mism,
         "ms_on_sample": round(b5_sample_ms, 4),
         "plain_ms_on_sample": round(b5_s_plain_ms, 4),
         "geometry": b5_geom,
         "single_stream": {"bytes_out": one_out, "ms": round(b5_one_ms, 4),
                           "ns_per_byte": round(b5_one_ms * 1e6 / one_out, 3)}},
    ]
    e2e = {"cram_write_s": round(cram_write_s, 4),
           "cram_write_records_per_s": round(n / cram_write_s, 1),
           "cram_read_s": round(cram_read_s, 4),
           "cram_read_records_per_s": round(n / cram_read_s, 1),
           "cram_legacy_read_s": round(legacy_read_s, 4), **policy_e2e,
           "cram_containers": len(offsets), "cram_file_bytes": file_bytes,
           "cram_splits": -(-file_bytes // args.split_size),
           "spans": cram_spans}
    return kernels, e2e, head


def cram_counters_ok(ds, records: int, fields, args, file_bytes: int,
                     what: str, **lost) -> None:
    """A CRAM read's ``ds.counters`` against the file: its records (after
    skip), one block per data container, the containers' block bytes,
    one shard per split, and the corrupt containers counted."""
    c = ds.counters
    want = (-(-file_bytes // args.split_size), records, len(fields),
            sum(length for length, _ in fields),
            lost.get("skipped", 0), lost.get("quarantined", 0))
    got = (c.shards, c.records, c.blocks, c.bytes_compressed,
           c.skipped_blocks, c.quarantined_blocks)
    check(got == want, f"{what}: counters {got}, want {want}")


def flip_cram_container(cram: str, data: bytes, offsets, fields,
                        split: int):
    """A copy of the CRAM ``data`` with one byte flipped mid-payload in
    the middle container of split 2 (one with a successor, so its bytes
    end where the next container starts). Returns (container index, its
    offset, its end, the flipped bytes, the copy's path, the mask of the
    sorted records outside that container)."""
    in_split = [k for k, off in enumerate(offsets[:-1])
                if 2 * split <= off < 3 * split]
    check(len(in_split) > 0, "no container of split 2 has a successor")
    c = in_split[len(in_split) // 2]
    off, end = offsets[c], offsets[c + 1]
    bad = bytearray(data)
    bad[(off + end) // 2] ^= 0x5A
    flipped = os.path.splitext(cram)[0] + "_flipped.cram"
    with open(flipped, "wb") as f:
        f.write(bad)
    shutil.rmtree(flipped + ".quarantine", ignore_errors=True)
    first = sum(r for _, r in fields[:c])
    keep = np.ones(sum(r for _, r in fields), bool)
    keep[first: first + fields[c][1]] = False
    return c, off, end, bad, flipped, keep


RAGGED = (("name_offsets", ("names",)), ("cigar_offsets", ("cigars",)),
          ("seq_offsets", ("seqs", "quals")), ("tag_offsets", ("tags",)))
FIXED = ("refid", "pos", "mapq", "bin", "flag", "next_refid", "next_pos",
         "tlen")
CRAM_EOF = 38   # bytes of the CRAM 3.0 end-of-file container


def head_equal(got, want, m: int, what: str) -> None:
    """``got`` (a read batch of ``m`` records) equals the first ``m``
    records of ``want``, column by column."""
    check(got.count == m, f"{what}: {got.count} records, want {m}")
    for col in FIXED:
        check(np.array_equal(getattr(got, col), getattr(want, col)[:m]),
              f"{what}: column {col}")
    for off_col, cols in RAGGED:
        off = getattr(want, off_col)
        check(np.array_equal(getattr(got, off_col), off[: m + 1]),
              f"{what}: column {off_col}")
        for col in cols:
            check(np.array_equal(getattr(got, col),
                                 getattr(want, col)[: off[m]]),
                  f"{what}: column {col}")


def cram_policy_legs(torch, port, args, g, perm_want, cram, data, offsets,
                     fields, default) -> dict:
    """The CRAM read with the knobs users set, on the file's first 3
    splits (the containers that start there, then the EOF container: a
    cut of depth): the shard executor at 4 workers against the default
    read ``default`` of the whole file, and strict, skip and quarantine
    on a copy with one byte flipped mid-payload in a container of split
    2. Returns the e2e fields and the head copy (path, container offsets,
    records, the 4-worker read's batch and counters)."""
    from disq_tpu_torch.runtime import counters
    from disq_tpu_torch.runtime.errors import CorruptBlockError

    split = args.split_size
    cut = sum(1 for off in offsets if off < 3 * split)
    check(data[-CRAM_EOF:][:4] == struct.pack("<i", 15),
          "no CRAM 3.0 EOF container at the end of the file")
    if cut < len(offsets):
        data = data[: offsets[cut]] + data[-CRAM_EOF:]
        offsets, fields = offsets[:cut], fields[:cut]
    cram = os.path.splitext(cram)[0] + "_head.cram"
    with open(cram, "wb") as f:
        f.write(data)
    file_bytes = len(data)
    n = sum(r for _, r in fields)
    splits_with_streams = len({off // split for off in offsets})
    log(f"cram head: {len(offsets)} containers, {n} records, {file_bytes} "
        f"bytes, {splits_with_streams} splits")

    def storage():
        return port.ReadsStorage.make_default().split_size(split)

    # -- the shard executor at 4 workers --------------------------------------
    counters.reset()
    t0 = time.perf_counter()
    ex = storage().executor_workers(4).read(cram)
    torch.cuda.synchronize()
    executor_s = time.perf_counter() - t0
    snap = counters.snapshot()
    log(f"cram executor read (4 workers): {executor_s:.3f}s, counters "
        f"{ex.counters.as_dict()}, {json.dumps(snap)}")
    check(snap["launches"].get("rans_simd", 0) == splits_with_streams,
          f"cram executor read launches {snap['launches']}")
    cram_counters_ok(ex, n, fields, args, file_bytes, "cram executor read")
    head_equal(ex.reads, default, n, "cram executor read")
    head = {"path": cram, "offsets": offsets, "records": n,
            "reads": ex.reads, "counters": ex.counters.as_dict()}
    del ex

    # -- the error policies on one flipped byte -------------------------------
    c, off, end, bad, flipped, keep = flip_cram_container(
        cram, data, offsets, fields, split)
    try:
        storage().read(flipped)
    except CorruptBlockError as e:
        check(e.block_offset == off and e.shard_id == off // split,
              f"cram strict: {e}")
        log(f"cram strict read: raises {e}")
    else:
        raise PhaseError("cram strict read of the flipped copy did not raise")
    perm = perm_want[:n][keep]
    sorted_cols = {col: g[col][perm]
                   for col in ("refid", "pos", "flag", "mapq", "tlen",
                               "next_pos")}
    policy = {}
    for name in ("skip", "quarantine"):
        counters.reset()
        t0 = time.perf_counter()
        pd = storage().error_policy(name).read(flipped)
        torch.cuda.synchronize()
        policy[name] = time.perf_counter() - t0
        snap = counters.snapshot()
        log(f"cram {name} read: {policy[name]:.3f}s, {pd.count()} records "
            f"({n - pd.count()} lost), counters {pd.counters.as_dict()}, "
            f"{json.dumps(snap)}")
        cram_counters_ok(pd, int(keep.sum()), fields, args, file_bytes,
                         f"cram {name} read", **{
                             "skipped" if name == "skip" else "quarantined": 1})
        for col, want in sorted_cols.items():
            check(np.array_equal(getattr(pd.reads, col), want),
                  f"cram {name}: column {col}")
        check(np.array_equal(pd.reads.names.reshape(-1, NAME_LEN),
                             g["names"][perm]), f"cram {name}: names")
        check(np.array_equal(pd.reads.quals.reshape(-1, READ_LEN),
                             g["qual"][perm]), f"cram {name}: quals")
        check(snap["launches"].get("rans_simd", 0) == splits_with_streams,
              f"cram {name}: launches {snap['launches']}")
        del pd
    with open(flipped + ".quarantine/MANIFEST.jsonl") as f:
        lines = [json.loads(ln) for ln in f.read().splitlines()]
    check(lines[0] == {"version": 1} and len(lines) == 2,
          f"cram quarantine manifest: {lines}")
    entry = lines[1]
    check(entry["block_offset"] == off and entry["kind"] == "CRAM container"
          and entry["length"] == end - off, f"cram quarantine entry {entry}")
    with open(entry["sidecar"], "rb") as f:
        check(f.read() == bytes(bad[off:end]), "cram quarantine sidecar bytes")
    del bad
    log(f"cram policies: container {c} at {off} (split {off // split}), "
        f"{fields[c][1]} records lost, manifest and sidecar ok")
    return {"cram_executor4_read_s": round(executor_s, 4),
            "cram_skip_read_s": round(policy["skip"], 4),
            "cram_quarantine_read_s": round(policy["quarantine"], 4)}, head


# -- the BAM read and write as users configure them -------------------------


def same_reads(torch, a, b, what: str) -> None:
    """Two datasets hold the same records: every fixed column on the
    device, every ragged one from the host parse."""
    check(a.count() == b.count(), f"{what}: count {a.count()} != {b.count()}")
    check(a.reads.device_backed and b.reads.device_backed,
          f"{what}: not device-backed")
    da, db = a.reads.device_columns(), b.reads.device_columns()
    for col in da:
        check(torch.equal(da[col], db[col]), f"{what}: column {col}")
    ra, rb = a.reads.to_read_batch(), b.reads.to_read_batch()
    for col in ("name_offsets", "names", "cigar_offsets", "cigars",
                "seq_offsets", "seqs", "quals", "tag_offsets", "tags"):
        check(np.array_equal(getattr(ra, col), getattr(rb, col)),
              f"{what}: column {col}")


def legacy_sample(data: bytes, blocks, seed: int):
    """Payloads for B4 against its plain version, with B4's expected
    status or None: every case of ``ops/inflate_cases.py`` (the edge
    cases of B1's design with None: B4's rules decide them), 8 of the
    file's blocks, and a truncated and a bit-flipped copy of two of
    them (the flipped ones may decode to any status)."""
    from disq_tpu_torch.ops import inflate_cases

    cases = [(p, u, None) for _, p, u, _ in inflate_cases.status_cases()]
    cases += [(p, len(d), 0) for _, p, d in inflate_cases.good_cases(seed)]
    cases += [(p, u, s) for _, p, u, s in inflate_cases.legacy_cases()]
    cases += [(p, u, None) for _, p, u, _ in inflate_cases.edge_cases()]
    cases += [(p, u, s) for _, p, u, s in inflate_cases.legacy_edge_cases()]
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(blocks), 8, replace=False)
    for k, i in enumerate(picks):
        p, t, h = blocks[i]
        payload = data[p + h: p + t - 8]
        isize = struct.unpack_from("<I", data, p + t - 4)[0]
        cases.append((payload, isize, 0))
        if k < 2:
            cases.append((payload[: len(payload) // 2], isize, 6))
            flipped = bytearray(payload)
            flipped[len(payload) // 3] ^= 0x10
            cases.append((bytes(flipped), isize, None))
    return cases


def stage_legacy(torch, payloads, usizes, dev):
    from disq_tpu_torch.ops import inflate as B4

    lens = np.array([len(p) for p in payloads], np.int64)
    off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    blob = np.frombuffer(b"".join(payloads), np.uint8)
    return B4.stage_payloads(blob, off, lens, usizes, dev), int(lens.sum())


def bam_legs(torch, port, args, g, info, ds, src, work, dev, host_blob,
             main_lanes: int):
    """The BAM read and write with the knobs users set: the legacy
    inflate route (B4), the shard executor at 4 workers, the skip and
    quarantine policies on a copy with one flipped bit, and the write
    pipeline at 4 workers. Returns (B4's kernel entry, e2e fields)."""
    from disq_tpu_torch.bgzf.codec import row_prefixes
    from disq_tpu_torch.ops import cuda_build
    from disq_tpu_torch.ops import inflate as B4
    from disq_tpu_torch.ops import inflate_simd as B1
    from disq_tpu_torch.runtime import counters
    from disq_tpu_torch.runtime.errors import CorruptBlockError

    n, split = args.records, args.split_size
    n_splits = -(-info["file_bytes"] // split)

    def storage():
        return port.ReadsStorage.make_default().split_size(split)

    # -- leg 1: the legacy read (B4) ----------------------------------------
    os.environ["DISQ_TPU_TORCH_DEVICE_INFLATE"] = "legacy"
    try:
        counters.reset()
        t0 = time.perf_counter()
        lg = storage().read(src)
        torch.cuda.synchronize()
        legacy_s = time.perf_counter() - t0
        lg_counts = counters.snapshot()
    finally:
        del os.environ["DISQ_TPU_TORCH_DEVICE_INFLATE"]
    l_launch = lg_counts["launches"]
    log(f"legacy read: {legacy_s:.3f}s ({n / legacy_s:.0f} rec/s), counters "
        f"{json.dumps(lg_counts)}")
    check(l_launch.get("inflate_legacy", 0) == n_splits
          and l_launch.get("inflate", 0) == 0
          and l_launch.get("parse", 0) == n_splits,
          f"legacy read launches {l_launch}")
    check(sum(lg_counts["host_fallback_blocks"].values()) == 0,
          "legacy read: host fallback")
    check(lg.flagstat() == ds.flagstat(), "legacy read: flagstat")
    same_reads(torch, lg, ds, "legacy read")
    del lg
    log("legacy read: count, flagstat and every column equal the default "
        "route's")

    # B4 against its plain version on a sample: every status code, and
    # truncated and bit-flipped file blocks
    data = open(src, "rb").read()
    blocks = walk_blocks(data)[:-1]
    cases = legacy_sample(data, blocks, args.seed + 3)
    s_args, _ = stage_legacy(torch, [c[0] for c in cases],
                             [c[1] for c in cases], dev)
    k_out, k_meta = B4.inflate_stacked(*s_args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_out, p_meta = B4.inflate_stacked_plain(*s_args)
    b4_s_plain_ms = (time.perf_counter() - t0) * 1e3
    b4_s_err = max(int((k_out.int() - p_out.int()).abs().max()),
                   int((k_meta - p_meta).abs().max()))
    b4_s_mism = int((k_out != p_out).sum() + (k_meta != p_meta).sum())
    check(b4_s_err == 0 and b4_s_mism == 0,
          f"B4 kernel != plain version on the sample ({b4_s_mism} mismatches)")
    st = k_meta[:, 1].cpu().numpy()
    for i, (_, _, want) in enumerate(cases):
        check(want is None or st[i] == want,
              f"B4 sample case {i}: status {st[i]}, want {want}")
    b4_codes = sorted(set(st.tolist()))
    b4_sample_ms = cuda_ms(torch, lambda: B4.inflate_stacked(*s_args), 1, 3)
    del k_out, p_out, s_args

    # B4 at the main path's shape: split 0's blocks in one launch, held
    # against its plain version on the same payloads and against B1
    first = [b for b in blocks if b[0] < split]
    m_payloads = [data[p + h: p + t - 8] for p, t, h in first]
    m_us = [struct.unpack_from("<I", data, p + t - 4)[0] for p, t, _ in first]
    m_args, m_in = stage_legacy(torch, m_payloads, m_us, dev)
    out_h, meta_h = (t.cpu().numpy() for t in B4.inflate_stacked(*m_args))
    check(not meta_h[:, 1].any(), "B4 flagged a block of split 0")
    (p_rows, p_meta), b4_plain_ms, procs = plain_on_payloads(
        "inflate_legacy", m_payloads, m_us)
    b4_err = max(int(np.abs(out_h.astype(np.int16) - p_rows).max()),
                 int(np.abs(meta_h - p_meta).max()))
    b4_mism = int((out_h != p_rows).sum() + (meta_h != p_meta).sum())
    check(b4_err == 0 and b4_mism == 0,
          f"B4 kernel != plain version on split 0 ({b4_mism} mismatches)")
    del p_rows, m_payloads
    joined, _ = row_prefixes(out_h, meta_h[:, 0])
    check(np.array_equal(joined, host_blob[: len(joined)]),
          "B4 differs from B1 on split 0")
    del out_h, joined
    b4_ms = cuda_ms(torch, lambda: B4.inflate_stacked(*m_args), 1, 3)
    # the wrapper reads the largest payload size on the host, which a CUDA
    # graph cannot capture: the graph holds the kernel's C entry alone
    lib, (comp, pay_off, csizes, usizes) = B4._lib(), m_args
    rows = torch.empty((len(first), B4.UMAX), dtype=torch.uint8, device=dev)
    meta = torch.empty((len(first), 2), dtype=torch.int32, device=dev)
    b4_dev_ms = graph_ms(torch, lambda: lib.disq_inflate_legacy_launch(
        comp.data_ptr(), pay_off.data_ptr(), csizes.data_ptr(),
        usizes.data_ptr(), rows.data_ptr(), meta.data_ptr(), len(first),
        torch.cuda.current_stream().cuda_stream), 3, 2)
    del rows, meta, comp, pay_off, csizes, usizes
    m_out = int(sum(m_us))
    b4_bytes = m_in + len(first) * (B4.UMAX + 8 + 8 + 4 + 4)
    bytes_ms = b4_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = m_out * INFLATE_OPS_PER_BYTE / SCALAR_OPS_PER_S * 1e3
    b4_bound, b4_by = ((bytes_ms, "bytes") if bytes_ms >= ops_ms
                       else (ops_ms, "operations"))
    b4_geom = cuda_build.geometry("inflate_legacy", len(first))
    # one payload alone: the latency of one warp's decode
    one = (m_args[0], *(t[:1].contiguous() for t in m_args[1:]))
    one_out = m_us[0]
    b4_one_ms = cuda_ms(torch, lambda: B4.inflate_stacked(*one), 2, 10)
    del m_args, one
    log(f"inflate_legacy: sample of {len(cases)} payloads, codes {b4_codes}, "
        f"kernel {b4_sample_ms:.3f} ms vs plain {b4_s_plain_ms:.1f} ms, 0 "
        f"mismatches; split 0: {len(first)} blocks {m_in} -> {m_out} bytes "
        f"in {b4_ms:.3f} ms vs plain {b4_plain_ms:.1f} ms ({procs} "
        f"processes), 0 mismatches (bound {b4_bound:.6f} ms, {b4_by}); "
        f"geometry {json.dumps(b4_geom)}; one payload ({one_out} bytes) "
        f"{b4_one_ms:.4f} ms")

    # -- leg 2: the shard executor at 4 workers -----------------------------
    counters.reset()
    B1.last_stats.update(device_lanes=0, host_big=0, host_fallback=0)
    t0 = time.perf_counter()
    ex = storage().executor_workers(4).read(src)
    torch.cuda.synchronize()
    executor_s = time.perf_counter() - t0
    ex_counts = counters.snapshot()
    lanes = B1.last_stats["device_lanes"]
    log(f"executor read (4 workers): {executor_s:.3f}s "
        f"({n / executor_s:.0f} rec/s), counters {json.dumps(ex_counts)}, "
        f"inflate lanes {lanes}")
    check(ex_counts["launches"].get("inflate", 0) == n_splits
          and ex_counts["launches"].get("parse", 0) == n_splits,
          f"executor read launches {ex_counts['launches']}")
    check(lanes == main_lanes, f"executor read: {lanes} lanes booked, "
          f"{main_lanes} on the 1-worker read")
    check(ex.counters.records == n and ex.counters.shards == n_splits,
          f"executor read counters {ex.counters}")
    same_reads(torch, ex, ds, "executor read")
    del ex

    # -- leg 3: the error policies on one flipped bit -----------------------
    blk_i = len(blocks) // 2
    pos, total, _ = blocks[blk_i]
    bad = bytearray(data)
    bad[pos + 20] ^= 1 << 3
    flipped = os.path.join(work, "flipped.bam")
    with open(flipped, "wb") as f:
        f.write(bad)
    del data
    size = (36 + NAME_LEN + 1 + 4 * g["ncig"] + (READ_LEN + 1) // 2
            + READ_LEN + TAG_BYTES)
    start = len(bam_header()) + np.concatenate([[0], np.cumsum(size)[:-1]])
    ulo, uhi = blk_i * MAX_PAYLOAD, (blk_i + 1) * MAX_PAYLOAD
    keep = (start + size <= ulo) | (start >= uhi)
    try:
        storage().read(flipped)
    except CorruptBlockError as e:
        check(e.block_offset == pos and e.shard_id == pos // split,
              f"strict: {e}")
        log(f"strict read: raises {e}")
    else:
        raise PhaseError("strict read of the flipped copy did not raise")
    policy = {}
    for name in ("skip", "quarantine"):
        counters.reset()
        t0 = time.perf_counter()
        pd = storage().error_policy(name).read(flipped)
        torch.cuda.synchronize()
        policy[name] = time.perf_counter() - t0
        snap = counters.snapshot()
        c = pd.counters
        log(f"{name} read: {policy[name]:.3f}s, {pd.count()} records "
            f"({n - pd.count()} lost), counters {c.as_dict()}, "
            f"{json.dumps(snap)}")
        check((c.skipped_blocks, c.quarantined_blocks)
              == ((1, 0) if name == "skip" else (0, 1)),
              f"{name}: counters {c}")
        check(pd.count() == int(keep.sum()), f"{name}: {pd.count()} records, "
              f"want {int(keep.sum())}")
        check(pd.reads.device_backed, f"{name}: not device-backed")
        for col in ("refid", "pos", "flag", "mapq", "tlen", "next_pos"):
            check(np.array_equal(getattr(pd.reads, col), g[col][keep]),
                  f"{name}: column {col}")
        check(np.array_equal(pd.reads.to_read_batch().names.reshape(-1, NAME_LEN),
                             g["names"][keep]), f"{name}: names")
        check(snap["launches"].get("inflate", 0) == n_splits,
              f"{name}: inflate launches {snap['launches']}")
        del pd
    qdir = flipped + ".quarantine"
    with open(os.path.join(qdir, "MANIFEST.jsonl")) as f:
        lines = [json.loads(ln) for ln in f.read().splitlines()]
    check(lines[0] == {"version": 1} and len(lines) == 2,
          f"quarantine manifest: {lines}")
    entry = lines[1]
    check(entry["block_offset"] == pos and entry["kind"] == "BGZF block"
          and entry["length"] == total, f"quarantine entry {entry}")
    with open(entry["sidecar"], "rb") as f:
        check(f.read() == bytes(bad[pos: pos + total]),
              "quarantine sidecar bytes")
    del bad
    log(f"policies: block at {pos} (split {pos // split}), "
        f"{n - int(keep.sum())} records lost, manifest and sidecar ok")

    # -- leg 4: the write pipeline at 1 and 4 workers ------------------------
    outs, write_s = {}, {}
    for workers in (1, 4):
        out_path = os.path.join(work, f"sorted_w{workers}.bam")
        t0 = time.perf_counter()
        (storage().num_shards(WRITE_SHARDS).writer_workers(workers)
         .write(ds, out_path, port.BaiWriteOption.ENABLE, sort=True))
        write_s[workers] = time.perf_counter() - t0
        with open(out_path, "rb") as f, open(out_path + ".bai", "rb") as fb:
            outs[workers] = (f.read(), fb.read())
    check(outs[1] == outs[4], "writer_workers 4 output differs from 1")
    log(f"parallel write ({WRITE_SHARDS} shards): 1 worker {write_s[1]:.3f}s, "
        f"4 workers {write_s[4]:.3f}s, BAM and BAI byte-identical")
    del outs

    entry = {"name": "inflate_legacy", "route": "cuda",
             "source": "disq_tpu_torch/csrc/inflate_legacy.cu",
             "replaces": "disq_tpu/ops/inflate.py:80",
             "launches": l_launch.get("inflate_legacy", 0),
             "max_abs_err": b4_err, "ms": round(b4_ms, 4),
             "ms_device": round(b4_dev_ms, 4),
             "plain_ms": round(b4_plain_ms, 4),
             "bound_ms": round(b4_bound, 6), "bound_by": b4_by,
             "library_ms": None, "mismatches": b4_mism, "tolerance": 0,
             "shape": {"blocks": len(first), "bytes_in": m_in,
                       "bytes_out": m_out},
             "plain_on": f"the same inputs (split 0's payloads), host, "
                         f"{procs} processes",
             "sample": f"{len(cases)} payloads",
             "sample_mismatches": b4_s_mism,
             "ms_on_sample": round(b4_sample_ms, 4),
             "plain_ms_on_sample": round(b4_s_plain_ms, 4),
             "codes_on_sample": b4_codes, "geometry": b4_geom,
             "single_payload": {
                 "bytes_out": one_out, "ms": round(b4_one_ms, 4),
                 "ns_per_byte": round(b4_one_ms * 1e6 / one_out, 3)}}
    e2e = {"legacy_read_s": round(legacy_s, 4),
           "executor4_read_s": round(executor_s, 4),
           "skip_read_s": round(policy["skip"], 4),
           "quarantine_read_s": round(policy["quarantine"], 4),
           "write_w1_s": round(write_s[1], 4),
           "write_w4_s": round(write_s[4], 4)}
    return entry, e2e


# -- the rest of the configured read and write -------------------------------


def record_voffsets(data: bytes):
    """(virtual offset of every record start, end-of-data virtual offset)
    of a BAM, by a host walk: zlib inflates every block and the record
    chain is followed from the end of the header."""
    blocks = walk_blocks(data)
    with ThreadPoolExecutor(8) as pool:
        payloads = list(pool.map(
            lambda b: zlib.decompress(data[b[0] + b[2]: b[0] + b[1] - 8], -15),
            blocks))
    usize = np.array([len(p) for p in payloads], np.int64)
    ustart = np.concatenate([[0], np.cumsum(usize)[:-1]])
    cstart = np.array([b[0] for b in blocks], np.int64)
    blob = b"".join(payloads)
    del payloads
    l_text = struct.unpack_from("<i", blob, 4)[0]
    p = 8 + l_text
    n_ref = struct.unpack_from("<i", blob, p)[0]
    p += 4
    for _ in range(n_ref):
        p += 8 + struct.unpack_from("<i", blob, p)[0]
    starts, unpack, end = [], struct.Struct("<i").unpack_from, len(blob)
    while p < end:
        starts.append(p)
        p += 4 + unpack(blob, p)[0]
    check(p == end, "record chain overruns the data")

    def voffset(u):
        # a start on a block boundary belongs to the next block
        b = np.searchsorted(ustart, u, side="right") - 1
        return (cstart[b].astype(np.uint64) << np.uint64(16)) | \
            (u - ustart[b]).astype(np.uint64)

    # the end of data as the writer's canonical blocking names it: past a
    # full last block, the next block's start; else within the last block
    last = len(blocks) - 2  # the block before the EOF block
    end_vo = (int(cstart[last + 1]) << 16 if usize[last] == MAX_PAYLOAD
              else int(cstart[last]) << 16 | int(usize[last]))
    return voffset(np.array(starts, np.int64)), end_vo


def read_sbi(path: str):
    with open(path, "rb") as f:
        raw = f.read()
    magic, _flen, _md5, _uuid, total, gran, n = struct.unpack_from(
        "<4sQ16s16sQQQ", raw)
    check(magic == b"SBI\x01", "SBI magic")
    offsets = np.frombuffer(raw, "<u8", n, struct.calcsize("<4sQ16s16sQQQ"))
    return total, gran, offsets


def generator_columns(g: dict, rows) -> dict:
    return {col: g[col][rows] for col in FIXED}


def equal_to_generator(torch, got, g: dict, rows, what: str) -> None:
    """A device-backed read equals the generator's records ``rows``: the
    fixed columns on the device, names and qualities from the host."""
    check(got.count() == len(rows), f"{what}: {got.count()} records, "
          f"want {len(rows)}")
    check(got.reads.device_backed, f"{what}: not device-backed")
    cols = got.reads.device_columns()
    for col, want in generator_columns(g, rows).items():
        check(np.array_equal(cols[col].cpu().numpy(), want.astype(np.int32)),
              f"{what}: column {col}")
    rb = got.reads.to_read_batch()
    check(np.array_equal(rb.names.reshape(-1, NAME_LEN), g["names"][rows]),
          f"{what}: names")
    check(np.array_equal(rb.quals.reshape(-1, READ_LEN), g["qual"][rows]),
          f"{what}: quals")


def numpy_depth(g: dict, window: int) -> dict:
    """Windowed depth of the generator's mapped records by a numpy
    difference array."""
    code, length = g["cig"] & 0xF, (g["cig"] >> 4).astype(np.int64)
    used = np.arange(3)[None, :] < g["ncig"][:, None]
    reflen = (length * (used & np.isin(code, (0, 2, 3, 7, 8)))).sum(1)
    ends = g["pos"].astype(np.int64) + np.maximum(reflen, 1)
    mapped = ((g["flag"] & 4) == 0) & (g["refid"] >= 0)
    out = {}
    for r, (_name, ln) in enumerate(REFS):
        nw = max(1, -(-ln // window))
        sel = mapped & (g["refid"] == r)
        lo = np.clip(g["pos"][sel].astype(np.int64) // window, 0, nw - 1)
        hi = np.clip((ends[sel] - 1) // window, 0, nw - 1)
        diff = np.zeros(nw + 1, np.int64)
        np.add.at(diff, lo, 1)
        np.add.at(diff, hi + 1, -1)
        out[r] = np.cumsum(diff)[:-1].astype(np.int32)
    return out


def configured_write_legs(torch, port, args, g, perm_want, info, ds, work):
    """The BAM write with the options users set: the SBI beside the BAI,
    a directory of per-shard BAMs and CRAMs, and a write that resumes
    from its stage manifest. Returns the e2e fields and the phases'
    launches."""
    from disq_tpu_torch.bam import source as bam_source
    from disq_tpu_torch.bam.sink import BamSink
    from disq_tpu_torch.runtime import counters

    n, split = args.records, args.split_size
    n_splits = -(-info["file_bytes"] // split)
    sorted_ds = ds.coordinate_sorted()

    def storage():
        return port.ReadsStorage.make_default().split_size(split)

    e2e, launches = {}, {}

    # -- sbi write ----------------------------------------------------------
    t0 = time.perf_counter()
    sbi_out = os.path.join(work, "sorted_sbi.bam")
    (storage().num_shards(WRITE_SHARDS).writer_workers(4)
     .write(sorted_ds, sbi_out, port.BaiWriteOption.ENABLE,
            port.SbiWriteOption.ENABLE))
    write_s = time.perf_counter() - t0
    plain_out = os.path.join(work, "sorted_w1.bam")  # leg 4's, without SBI
    for ext in ("", ".bai"):
        with open(sbi_out + ext, "rb") as a, open(plain_out + ext, "rb") as b:
            check(a.read() == b.read(),
                  f"sbi write: {ext or '.bam'} differs from the write "
                  f"without SBI")
    with open(sbi_out, "rb") as f:
        starts, end_vo = record_voffsets(f.read())
    total, gran, offsets = read_sbi(sbi_out + ".sbi")
    check(total == n and len(starts) == n, f"sbi write: {total} records")
    check(gran == 4096, f"sbi granularity {gran}")
    check(bool(np.isin(offsets[:-1], starts).all()),
          "sbi write: an SBI offset is not the start of a record")
    check(bool((np.diff(offsets.astype(np.int64)) > 0).all()),
          "sbi write: SBI offsets not increasing")
    check(int(offsets[-1]) == end_vo, "sbi write: end-of-data offset")
    # per-part sampling: every 4096th record of each of the 8 parts
    bounds = np.linspace(0, n, WRITE_SHARDS + 1).astype(np.int64)
    want = np.concatenate([starts[lo:hi:4096]
                           for lo, hi in zip(bounds[:-1], bounds[1:])])
    check(np.array_equal(offsets[:-1], want),
          "sbi write: offsets are not every 4096th record of each part")

    def no_guess(*_a, **_k):
        raise PhaseError("the re-read guessed a boundary: the SBI was not used")

    guess = bam_source.BamSource._guess_record_voffset
    bam_source.BamSource._guess_record_voffset = no_guess
    try:
        counters.reset()
        t0 = time.perf_counter()
        back = storage().read(sbi_out)
        torch.cuda.synchronize()
        reread_s = time.perf_counter() - t0
        snap = counters.snapshot()
    finally:
        bam_source.BamSource._guess_record_voffset = guess
    equal_to_generator(torch, back, g, perm_want, "sbi re-read")
    check(snap["launches"].get("inflate", 0) == n_splits
          and snap["launches"].get("parse", 0) == n_splits,
          f"sbi re-read launches {snap['launches']}")
    del back
    log(f"sbi write: {write_s:.3f}s (8 shards, BAI + SBI), {len(offsets)} "
        f"SBI offsets on record starts, BAM and BAI byte-identical to the "
        f"write without SBI; re-read on the SBI's splits {reread_s:.3f}s, "
        f"launches {json.dumps(snap['launches'])}")
    e2e.update(sbi_write_s=round(write_s, 4), sbi_reread_s=round(reread_s, 4))

    # -- multi write --------------------------------------------------------
    t0 = time.perf_counter()
    bam_dir = os.path.join(work, "parts_bam")
    (storage().num_shards(WRITE_SHARDS).writer_workers(4)
     .write(ds, bam_dir, port.FileCardinalityWriteOption.MULTIPLE,
            port.ReadsFormatWriteOption.BAM))
    multi_s = time.perf_counter() - t0
    names = sorted(os.listdir(bam_dir))
    check(names == [f"part-r-{k:05d}.bam" for k in range(WRITE_SHARDS)],
          f"multi write: parts {names}")
    counters.reset()
    t0 = time.perf_counter()
    for k, name in enumerate(names):
        part = os.path.join(bam_dir, name)
        with open(part, "rb") as f:
            data = f.read()
        check(data.endswith(EOF_BLOCK), f"{name}: no terminator")
        zlib_check_all(data)
        equal_to_generator(torch, storage().read(part), g,
                           np.arange(bounds[k], bounds[k + 1]), name)
    torch.cuda.synchronize()
    multi_read_s = time.perf_counter() - t0
    snap = counters.snapshot()
    check(snap["launches"].get("inflate", 0) >= WRITE_SHARDS
          and snap["launches"].get("parse", 0) >= WRITE_SHARDS,
          f"multi re-read launches {snap['launches']}")
    launches["multi_bam_reads"] = snap["launches"]

    m = min(200_000, n)
    os.environ["DISQ_TPU_TORCH_CRAM_RANS_O1"] = "0"
    try:
        head = port.ReadsDataset(sorted_ds.header,
                                 sorted_ds.reads.slice(0, m))
        cram_dir = os.path.join(work, "parts_cram")
        t0 = time.perf_counter()
        storage().num_shards(4).write(
            head, cram_dir, port.FileCardinalityWriteOption.MULTIPLE,
            port.ReadsFormatWriteOption.CRAM)
        cram_multi_s = time.perf_counter() - t0
    finally:
        os.environ.pop("DISQ_TPU_TORCH_CRAM_RANS_O1")
    del head
    names = sorted(os.listdir(cram_dir))
    check(names == [f"part-r-{k:05d}.cram" for k in range(4)],
          f"cram multi write: parts {names}")
    cb = np.linspace(0, m, 5).astype(np.int64)
    counters.reset()
    for k, name in enumerate(names):
        part = storage().read(os.path.join(cram_dir, name))
        rows = perm_want[cb[k]: cb[k + 1]]
        check(part.count() == len(rows), f"{name}: {part.count()} records")
        for col in ("refid", "pos", "flag", "mapq", "tlen", "next_pos"):
            check(np.array_equal(getattr(part.reads, col), g[col][rows]),
                  f"{name}: column {col}")
        check(np.array_equal(part.reads.names.reshape(-1, NAME_LEN),
                             g["names"][rows]), f"{name}: names")
        check(np.array_equal(part.reads.quals.reshape(-1, READ_LEN),
                             g["qual"][rows]), f"{name}: quals")
    snap = counters.snapshot()
    check(snap["launches"].get("rans_simd", 0) == 4,
          f"cram part reads launches {snap['launches']}")
    launches["multi_cram_reads"] = snap["launches"]
    log(f"multi write: BAM {WRITE_SHARDS} parts {multi_s:.3f}s, each "
        f"re-read equal to its slice and every block inflating with zlib "
        f"({multi_read_s:.3f}s); CRAM 4 parts of the first {m} sorted "
        f"records {cram_multi_s:.3f}s, each re-read equal to its slice")
    e2e.update(multi_bam_write_s=round(multi_s, 4),
               multi_cram_write_s=round(cram_multi_s, 4))

    # -- write resume -------------------------------------------------------
    out = os.path.join(work, "resumed.bam")
    manifest = os.path.join(work, "write.manifest")
    opts = (port.StageManifestWriteOption(manifest),
            port.BaiWriteOption.ENABLE, port.SbiWriteOption.ENABLE)
    encode_shard = BamSink._encode_shard
    ran = []

    def failing(self, batch, bounds, k):
        ran.append(k)
        if k == 3 and fail[0]:
            raise OSError("injected: shard 3 lost its disk")
        return encode_shard(self, batch, bounds, k)

    fail = [True]
    BamSink._encode_shard = failing
    try:
        t0 = time.perf_counter()
        try:
            storage().num_shards(WRITE_SHARDS).write(sorted_ds, out, *opts)
        except RuntimeError as e:
            check("shard 3" in str(e), f"write resume: {e}")
        else:
            raise PhaseError("write resume: the failing write did not raise")
        crash_s = time.perf_counter() - t0
        check(os.path.exists(manifest), "write resume: manifest gone")
        staged = sorted(os.listdir(out + ".parts"))
        check(staged == sorted(f"part-{k:05d}{x}" for k in range(3)
                               for x in ("", ".bai-frag", ".sbi-frag")),
              f"write resume: staged {staged}")
        fail[0] = False
        ran.clear()
        t0 = time.perf_counter()
        storage().num_shards(WRITE_SHARDS).write(sorted_ds, out, *opts)
        resume_s = time.perf_counter() - t0
    finally:
        BamSink._encode_shard = encode_shard
    check(ran == list(range(3, WRITE_SHARDS)), f"write resume: ran {ran}")
    check(not os.path.exists(manifest) and not os.path.exists(out + ".parts"),
          "write resume: manifest or staging left behind")
    for ext in ("", ".bai", ".sbi"):
        with open(out + ext, "rb") as a, open(sbi_out + ext, "rb") as b:
            check(a.read() == b.read(),
                  f"write resume: {ext or '.bam'} differs from the "
                  f"uninterrupted write")
    log(f"write resume: shard 3 failed after {crash_s:.3f}s (manifest and "
        f"3 staged parts kept); the resume ran shards {ran} in "
        f"{resume_s:.3f}s; BAM, BAI and SBI byte-identical to the "
        f"uninterrupted write")
    e2e.update(write_crash_s=round(crash_s, 4),
               write_resume_s=round(resume_s, 4))
    return e2e, launches


def read_resume_legs(torch, port, args, g, info, ds, src, work, head):
    """The BAM read of the file and the CRAM read of its 3-split head
    copy with a read ledger, each crashed at one split's fetch by the
    fault-injecting filesystem and run again. Returns the e2e fields and
    the resumed reads' launches."""
    from disq_tpu_torch.fsw.faultfs import (
        FaultInjectingFileSystemWrapper,
        FaultSpec,
    )
    from disq_tpu_torch.fsw.filesystem import (
        PosixFileSystemWrapper,
        register_filesystem,
    )
    from disq_tpu_torch.runtime import counters
    from disq_tpu_torch.runtime.errors import DisqOptions, TransientIOError
    from disq_tpu_torch.runtime.manifest import ReadLedger

    split = args.split_size
    n_splits = -(-info["file_bytes"] // split)

    def leg(path, crash, ledger):
        """(crash seconds, resumed dataset, its seconds, its books)."""
        opts = DisqOptions(max_retries=0).with_read_ledger(ledger)
        storage = port.ReadsStorage.make_default().split_size(split) \
            .options(opts)
        register_filesystem("fault", FaultInjectingFileSystemWrapper(
            PosixFileSystemWrapper(),
            [FaultSpec(kind="transient", path_substr=os.path.basename(path),
                       offset=crash, times=-1)]))
        t0 = time.perf_counter()
        try:
            storage.read("fault://" + path)
        except TransientIOError:
            pass
        else:
            raise PhaseError(f"read resume: the read of {path} did not fail")
        crash_s = time.perf_counter() - t0
        register_filesystem("fault", FaultInjectingFileSystemWrapper(
            PosixFileSystemWrapper(), []))
        done = ReadLedger(ledger).completed_shards()
        counters.reset()
        t0 = time.perf_counter()
        got = storage.read("fault://" + path)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        snap = counters.snapshot()
        check(not os.path.exists(os.path.join(ledger, "MANIFEST.json"))
              and not ReadLedger(ledger).completed_shards(),
              "read resume: the ledger outlived the read")
        return crash_s, done, got, resume_s, snap

    # -- BAM: split 4's fetch fails (at a byte that no header or boundary
    # read covers) ---------------------------------------------------------
    crash_at = 4 * split + split * 3 // 4
    crash_s, done, got, resume_s, snap = leg(
        src, crash_at, os.path.join(work, "ledger_bam"))
    check(done == [0, 1, 2, 3], f"read resume: ledger holds {done}")
    same_reads(torch, got, ds, "resumed read")
    fresh = n_splits - len(done)
    bam_l = snap["launches"]
    check(bam_l.get("inflate", 0) == fresh,
          f"resumed read: inflate launches {bam_l} for {fresh} splits")
    rebuilds = bam_l.get("parse", 0) - fresh
    check(rebuilds == len(done),
          f"resumed read: parse launches {bam_l}, {len(done)} spills")
    keys = ("records", "blocks", "bytes_compressed", "bytes_uncompressed",
            "skipped_blocks", "quarantined_blocks", "retried_reads",
            "shards")
    check(all(getattr(got.counters, k) == getattr(ds.counters, k)
              for k in keys),
          f"resumed read counters {got.counters} != {ds.counters}")
    del got
    log(f"read resume: BAM crashed at split 4 after {crash_s:.3f}s, ledger "
        f"held splits {done}; the resume took {resume_s:.3f}s: "
        f"{bam_l.get('inflate', 0)} inflate launches for {fresh} fresh "
        f"splits, {bam_l.get('parse', 0)} parse launches ("
        f"{rebuilds} rebuilding spills), counters and every column equal "
        f"the uninterrupted read, device-backed")

    # -- CRAM: split 2 of the head copy fails -------------------------------
    offs = [o for o in head["offsets"] if 2 * split <= o < 3 * split]
    check(len(offs) > 1, "no container of split 2 to fail")
    c = len(offs) // 2
    os.environ["DISQ_TPU_TORCH_CRAM_RANS_O1"] = "0"
    try:
        c_crash_s, c_done, cr, c_resume_s, c_snap = leg(
            head["path"], (offs[c] + offs[c + 1]) // 2,
            os.path.join(work, "ledger_cram"))
    finally:
        os.environ.pop("DISQ_TPU_TORCH_CRAM_RANS_O1")
    check(c_done == [0, 1], f"cram read resume: ledger holds {c_done}")
    check(c_snap["launches"].get("rans_simd", 0) == 1,
          f"cram resumed read launches {c_snap['launches']}")
    got_c = {k: getattr(cr.counters, k) for k in keys}
    check(got_c == {k: head["counters"][k] for k in keys},
          f"cram resumed read counters {got_c} != {head['counters']}")
    head_equal(cr.reads, head["reads"], head["records"], "cram resumed read")
    del cr
    log(f"read resume: CRAM head crashed at split 2 after {c_crash_s:.3f}s, "
        f"ledger held splits {c_done}; the resume took {c_resume_s:.3f}s, "
        f"{c_snap['launches'].get('rans_simd', 0)} rans_simd launch(es), "
        f"counters and records equal the uninterrupted read")
    return ({"read_crash_s": round(crash_s, 4),
             "read_resume_s": round(resume_s, 4),
             "cram_read_crash_s": round(c_crash_s, 4),
             "cram_read_resume_s": round(c_resume_s, 4)},
            {"inflate": bam_l.get("inflate", 0),
             "parse": bam_l.get("parse", 0), "parse_rebuilds": rebuilds,
             "rans_simd": c_snap["launches"].get("rans_simd", 0)})


def device_op_legs(torch, g, perm_want, ds) -> dict:
    """depth, filter, permuted and device_columns on the resident
    dataset. Returns the e2e fields."""
    from disq_tpu_torch.runtime import counters

    t0 = time.perf_counter()
    depth = ds.depth(1024)
    torch.cuda.synchronize()
    depth_s = time.perf_counter() - t0
    want = numpy_depth(g, 1024)
    check(sorted(depth) == sorted(want), "depth: references")
    for r in want:
        check(np.array_equal(depth[r], want[r]), f"depth: reference {r}")

    host = ds.reads.to_read_batch()
    t0 = time.perf_counter()
    mask = ds.reads.mapq >= 20
    kept = ds.reads.filter(mask)
    perm = ds.reads.permuted(perm_want)
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    for what, got, rb in (("filter", kept, host.filter(mask)),
                          ("permuted", perm, host.take(perm_want))):
        check(got.device_backed and got.device.type == "cuda",
              f"{what}: not device-backed")
        cols = got.device_columns()
        for col in FIXED:
            check(np.array_equal(cols[col].cpu().numpy(),
                                 getattr(rb, col).astype(np.int32)),
                  f"{what}: device column {col}")
        mat = got.to_read_batch()
        for col in FIXED + ("name_offsets", "names", "cigar_offsets",
                            "cigars", "seq_offsets", "seqs", "quals",
                            "tag_offsets", "tags"):
            check(np.array_equal(getattr(mat, col), getattr(rb, col)),
                  f"{what}: record column {col}")
        del mat, rb
    check(np.array_equal(perm.sort_permutation(), np.arange(ds.count())),
          "permuted: not in coordinate order")
    check(kept.count == int(mask.sum()), "filter: count")
    del kept, perm, host

    counters.reset()
    cols = ds.device_columns()
    books = counters.snapshot()["transfer_bytes"]
    own = ds.reads.device_columns()
    check(books == {}, f"device_columns moved bytes: {books}")
    check(all(cols[k].data_ptr() == own[k].data_ptr() for k in FIXED),
          "device_columns: not the resident tensors")
    log(f"device ops: depth(1024) {depth_s:.3f}s equal to a numpy "
        f"difference array; filter (mapq >= 20, {int(mask.sum())} kept) and "
        f"permuted (coordinate order) {transform_s:.3f}s, device-backed, "
        f"columns and records equal the host ReadBatch's; device_columns "
        f"with no transfer")
    return {"depth_s": round(depth_s, 4),
            "filter_permuted_s": round(transform_s, 4)}


# -- the device write path ---------------------------------------------------


def bgzf_layout(data: bytes):
    """(uncompressed stream, block compressed starts, block uncompressed
    starts) of a BGZF file, every block inflated by zlib with its CRC and
    ISIZE checked; the starts include the EOF block's."""
    blocks = walk_blocks(data)

    def one(blk):
        p, total, hdr = blk
        raw = zlib.decompress(data[p + hdr: p + total - 8], -15)
        crc, isize = struct.unpack_from("<II", data, p + total - 8)
        check(zlib.crc32(raw) == crc and len(raw) == isize,
              f"block at {p} fails CRC/ISIZE")
        return raw

    with ThreadPoolExecutor(8) as pool:
        payloads = list(pool.map(one, blocks))
    usize = np.array([len(p) for p in payloads], np.int64)
    ustart = np.concatenate([[0], np.cumsum(usize)[:-1]])
    cstart = np.array([b[0] for b in blocks], np.int64)
    return b"".join(payloads), cstart, ustart


def uncompressed_offsets(values, cstart, ustart) -> np.ndarray:
    """Virtual offsets → offsets in the uncompressed stream."""
    v = np.asarray(values, np.uint64)
    coff = (v >> np.uint64(16)).astype(np.int64)
    b = np.clip(np.searchsorted(cstart, coff), 0, len(cstart) - 1)
    check(bool((cstart[b] == coff).all()),
          "a virtual offset names no block start")
    return ustart[b] + (v & np.uint64(0xFFFF)).astype(np.int64)


def bai_mapped(raw: bytes, cstart, ustart) -> np.ndarray:
    """A BAI (independent parse) as one int64 vector: bin ids and chunk
    counts as they are, every virtual offset as its uncompressed offset,
    the metadata pseudo-bin's record counts as they are."""
    check(raw[:4] == b"BAI\x01", "BAI magic")
    out = []
    n_ref = struct.unpack_from("<i", raw, 4)[0]
    p = 8
    for _ in range(n_ref):
        n_bin = struct.unpack_from("<i", raw, p)[0]
        p += 4
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", raw, p)
            p += 8
            pairs = np.frombuffer(raw, "<u8", 2 * n_chunk, p)
            p += 16 * n_chunk
            out.append(np.array([b, n_chunk], np.int64))
            if b == 37450:  # ref_beg, ref_end, n_mapped, n_unmapped
                out.append(uncompressed_offsets(pairs[:2], cstart, ustart))
                out.append(pairs[2:].astype(np.int64))
            else:
                out.append(uncompressed_offsets(pairs, cstart, ustart))
        n_intv = struct.unpack_from("<i", raw, p)[0]
        p += 4
        out.append(uncompressed_offsets(
            np.frombuffer(raw, "<u8", n_intv, p), cstart, ustart))
        p += 8 * n_intv
    out.append(np.frombuffer(raw, "<u8", (len(raw) - p) // 8, p)
               .astype(np.int64))
    return np.concatenate(out)


def w2_against_plain(torch, dev, payload, off, ln, tab):
    """W2 and its plain version on the same lanes under ``tab``: (kernel
    rows, end bits, plain rows, end bits, mismatches, max abs error,
    plain ms), rows compared up to each lane's occupied end."""
    from disq_tpu_torch.ops import deflate as DF

    lt = tab.luts(dev)
    kb, ke = DF.encode(payload, off, ln, *lt, tab.header_bits, tab.out_bytes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pb, pe = DF.encode_plain(payload, off, ln, *lt, tab.header_bits,
                             tab.out_bytes)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    occ = torch.from_numpy(DF.occupied_bytes(
        pe.cpu().numpy(), tab.out_bytes)).to(dev)
    cols = torch.arange(tab.out_bytes, device=dev)
    mism = int((ke != pe).sum())
    err = int((ke.long() - pe.long()).abs().max()) if ke.numel() else 0
    for lo in range(0, kb.shape[0], 512):
        hi = min(lo + 512, kb.shape[0])
        m = cols[None, :] < occ[lo:hi, None]
        mism += int(((kb[lo:hi] != pb[lo:hi]) & m).sum())
        d = (kb[lo:hi].int() - pb[lo:hi].int()).abs()
        err = max(err, int(torch.where(m, d, 0).max()))
    return kb, ke, pb, pe, mism, err, plain_ms


def w2_fetched_against_plain(torch, dev, payload, off, ln, tab, body_h,
                             end_h):
    """What a caller fetched for one W2 launch (``DF.fetch``: the rows'
    occupied prefix ``body_h`` and the end bits ``end_h``) against the
    plain version on the same lanes under the same table: (mismatches,
    max abs error, plain ms), rows compared up to each lane's occupied
    end."""
    from disq_tpu_torch.ops import deflate as DF

    lt = tab.luts(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pb, pe = DF.encode_plain(payload, off, ln, *lt, tab.header_bits,
                             tab.out_bytes)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    pe = pe.cpu().numpy()
    mism = int((end_h != pe).sum())
    err = int(np.abs(end_h.astype(np.int64) - pe.astype(np.int64)).max(
        initial=0))
    need = body_h.shape[1]
    occ = np.minimum(DF.occupied_bytes(pe, tab.out_bytes), need)
    cols = np.arange(need)
    for lo in range(0, len(pe), 512):
        hi = min(lo + 512, len(pe))
        p = pb[lo:hi, :need].cpu().numpy()
        m = cols[None, :] < occ[lo:hi, None]
        mism += int(((body_h[lo:hi] != p) & m).sum())
        d = np.abs(body_h[lo:hi].astype(np.int16) - p.astype(np.int16))
        err = max(err, int(np.where(m, d, 0).max(initial=0)))
    return mism, err, plain_ms


def device_write_legs(torch, port, args, g, perm_want, ds, work, dev):
    """The device write path (``.device_deflate()``) on the resident
    dataset: (a) the main path's sorted write (1 shard, BAI), (b) the
    same at 8 shards, 4 writer workers, BAI + SBI. Each output decompresses
    to the default zlib-6 write's stream, its BAI (and SBI) map to the
    default write's, and it re-reads to the generator's sorted records.
    Then W1 and W2 at (a)'s shapes against their plain versions, and (a)'s
    stages replayed one by one. Returns (W1 and W2 kernel entries, e2e
    fields)."""
    from disq_tpu_torch.bam.sink import (
        _batch_digest,
        _LazySlice,
        voffsets_from_csizes,
    )
    from disq_tpu_torch.bgzf.codec import compress_to_bgzf
    from disq_tpu_torch.index.bai import build_bai
    from disq_tpu_torch.ops import cuda_build
    from disq_tpu_torch.ops import deflate as DF
    from disq_tpu_torch.ops import record_gather as W1
    from disq_tpu_torch.runtime import counters
    from disq_tpu_torch.runtime.device_pipeline import upload
    from disq_tpu_torch.runtime.device_write import ResidentShardEncoder

    n, split = args.records, args.split_size
    check(all(v == 0 for v in DF.device_stats.values()),
          f"a default write ran device deflate work: {DF.device_stats}")

    def storage():
        return port.ReadsStorage.make_default().split_size(split)

    legs = {"a": (1, 1, os.path.join(work, "sorted.bam"), False),
            "b": (WRITE_SHARDS, 4, os.path.join(work, "sorted_sbi.bam"),
                  True)}
    seconds, sizes, books = {}, {}, {}
    for leg, (shards, workers, default_path, sbi) in legs.items():
        out = os.path.join(work, f"device_{leg}.bam")
        opts = [port.BaiWriteOption.ENABLE]
        if sbi:
            opts.append(port.SbiWriteOption.ENABLE)
        st = (storage().num_shards(shards).writer_workers(workers)
              .device_deflate())
        counters.reset()
        t0 = time.perf_counter()
        st.write(ds, out, *opts, sort=True)
        seconds[leg] = time.perf_counter() - t0
        books[leg] = counters.snapshot()
        launches = books[leg]["launches"]
        # one W2 launch per shard and one for the header block
        check(launches.get("record_gather", 0) == shards
              and launches.get("deflate", 0) == shards + 1,
              f"device write ({leg}): launches {launches}")
        with open(out, "rb") as f:
            got = f.read()
        with open(default_path, "rb") as f:
            want = f.read()
        sizes[leg] = (len(got), len(want))
        got_u, got_c, got_s = bgzf_layout(got)
        want_u, want_c, want_s = bgzf_layout(want)
        check(got_u == want_u, f"device write ({leg}): uncompressed stream "
              f"differs from the zlib-6 write's")
        del got, want, got_u, want_u
        exts = (".bai", ".sbi") if sbi else (".bai",)
        for ext in exts:
            with open(out + ext, "rb") as f:
                got_i = f.read()
            with open(default_path + ext, "rb") as f:
                want_i = f.read()
            if ext == ".bai":
                same = np.array_equal(bai_mapped(got_i, got_c, got_s),
                                      bai_mapped(want_i, want_c, want_s))
            else:
                gt, gg, go = read_sbi(out + ext)
                wt, wg, wo = read_sbi(default_path + ext)
                same = (gt, gg) == (wt, wg) and np.array_equal(
                    uncompressed_offsets(go, got_c, got_s),
                    uncompressed_offsets(wo, want_c, want_s))
            check(same, f"device write ({leg}): {ext} does not map to the "
                  f"zlib-6 write's")
        back = storage().read(out)
        equal_to_generator(torch, back, g, perm_want, f"device write ({leg})")
        del back
        log(f"device write ({leg}): {shards} shards, {workers} writer "
            f"workers, {seconds[leg]:.3f}s, {sizes[leg][0]} bytes against "
            f"{sizes[leg][1]} for zlib-6; stream, "
            f"{' and '.join(e[1:].upper() for e in exts)} map to the zlib-6 "
            f"write's; re-read equal to the generator; counters "
            f"{json.dumps(books[leg])}")

    # -- (a)'s stages, one by one, on the same inputs -------------------------
    stages = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        stages[name] = round(time.perf_counter() - t0, 4)
        return res

    sorted_ds = stage("sort", lambda: ds.coordinate_sorted(keep_resident=True))
    check(sorted_ds.reads.device_backed, "keep_resident: not device-backed")
    enc = stage("upload", lambda: ResidentShardEncoder(sorted_ds.reads, dev))
    shard = stage("W1", lambda: enc.encode_shard(0, n))
    host = stage("host gather", shard.host_payload)
    table = stage("histogram + table", shard.table)
    bodies, end = stage("W2", shard.encode)
    body_h, end_h = stage("d2h", lambda: DF.fetch(bodies, end, table))
    n_blocks = shard.n_blocks

    def finalize():
        payloads = [host[b * MAX_PAYLOAD: (b + 1) * MAX_PAYLOAD]
                    for b in range(n_blocks)]
        blocks = [b""] * n_blocks

        def host_route(flagged):
            for j in flagged:
                blocks[j] = DF.host_block(payloads[j])

        flagged = DF.finalize_chunk(body_h, end_h, table, payloads,
                                    blocks.__setitem__, host_route)
        return DF.join_blocks(blocks) + (flagged,)

    comp, csizes, flagged = stage("host finalize", finalize)
    del body_h

    def index():
        voffs, end_voffs = voffsets_from_csizes(csizes, shard.record_offsets)
        part = _LazySlice(sorted_ds.reads, 0, n)
        return build_bai(part.refid, part.pos, part.alignment_ends(),
                         part.flag, voffs, end_voffs, len(REFS))

    stage("index build", index)
    staged = os.path.join(work, "device_stages.bam")

    def stage_out():
        header = compress_to_bgzf(sorted_ds.header.to_bam_bytes(),
                                  with_terminator=False, device=dev)
        with open(staged, "wb") as f:
            f.write(header)
            f.write(comp)
            f.write(EOF_BLOCK)
            f.flush()
            os.fsync(f.fileno())

    stage("stage", stage_out)
    with open(os.path.join(work, "device_a.bam"), "rb") as f:
        check(f.read() == open(staged, "rb").read(),
              "the replayed stages differ from the device write (a)")
    log(f"device write stages (a): {json.dumps(stages)}, sum "
        f"{sum(stages.values()):.4f}s against the write's "
        f"{seconds['a']:.4f}s")
    # what a StageManifestWriteOption adds: the digest of a permuted
    # batch materializes its ragged columns (the reference does the same)
    fresh = ds.reads.permuted(sorted_ds.reads._order)
    t0 = time.perf_counter()
    _batch_digest(fresh)
    digest_s = time.perf_counter() - t0
    del fresh
    log(f"device write: the manifest digest of the sorted batch "
        f"{digest_s:.4f}s")

    # -- W1 against its plain version on the whole shard ---------------------
    blob, nbytes = enc._blob, shard.nbytes
    src = upload(enc._src_starts, dev)
    dst = upload(enc._perm_off, dev)
    w1 = lambda: W1.gather_records(blob, src, dst, nbytes)  # noqa: E731
    k_pay = w1()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_pay = W1.gather_plain(blob, src, dst, nbytes)
    torch.cuda.synchronize()
    w1_plain_ms = (time.perf_counter() - t0) * 1e3
    w1_mism = int((k_pay != p_pay).sum())
    w1_err = int((k_pay.int() - p_pay.int()).abs().max()) if nbytes else 0
    check(w1_mism == 0, f"record_gather != plain version ({w1_mism} bytes)")
    check(np.array_equal(k_pay.cpu().numpy(), host),
          "record_gather != the host gather")
    del p_pay
    w1_ms = cuda_ms(torch, w1, 2, 10)
    w1_dev_ms = graph_ms(torch, w1, 5, 4)
    w1_geom = cuda_build.geometry("record_gather", n)
    w1_bytes = 2 * nbytes + 8 * n + 8 * (n + 1)

    # -- W2 against its plain version on the whole shard ---------------------
    pay_off = upload(np.arange(n_blocks, dtype=np.int64) * MAX_PAYLOAD, dev)
    pay_len = upload(np.minimum(nbytes - np.arange(n_blocks, dtype=np.int64)
                                * MAX_PAYLOAD, MAX_PAYLOAD).astype(np.int32),
                     dev)
    luts = table.luts(dev)
    w2 = lambda: DF.encode(k_pay, pay_off, pay_len, *luts,  # noqa: E731
                           table.header_bits, table.out_bytes)

    kb, ke, pb, pe, w2_mism, w2_err, w2_plain_ms = w2_against_plain(
        torch, dev, k_pay, pay_off, pay_len, table)
    check(w2_mism == 0, f"deflate != plain version on the shard ({w2_mism})")
    check(np.array_equal(ke.cpu().numpy(), end_h),
          "deflate end bits differ from the write's")
    plain_h, plain_end = DF.fetch(pb, pe, table)
    plain_flagged = [
        j for j in range(n_blocks)
        if DF.expanded(DF.finalize_stream(plain_h[j], int(plain_end[j]),
                                          table),
                       host[j * MAX_PAYLOAD: (j + 1) * MAX_PAYLOAD])]
    expanded_a = books["a"]["host_fallback_blocks"].get("expanded", 0)
    check(len(plain_flagged) == len(flagged) == expanded_a,
          f"expanded lanes: plain {len(plain_flagged)}, kernel "
          f"{len(flagged)}, write (a) {expanded_a}")
    body_bytes = int(((ke.long() + 7) // 8).sum())
    del kb, pb, plain_h
    w2_ms = cuda_ms(torch, w2, 1, 5)
    w2_dev_ms = graph_ms(torch, w2, 2, 3)
    w2_geom = cuda_build.geometry("deflate", n_blocks)
    w2_bytes = nbytes + body_bytes + 4 * n_blocks + 12 * n_blocks + 2048

    # W2 edge cases: 1, 255 and 65,280 bytes and an incompressible lane,
    # at odd offsets, under a table with 15-bit codes
    rng = np.random.default_rng(args.seed + 8)
    edge = [np.minimum(rng.geometric(0.5, size) - 1, 255).astype(np.uint8)
            for size in (1, 255, MAX_PAYLOAD)]
    edge.append(rng.integers(0, 256, MAX_PAYLOAD, np.uint8))
    # symbol i is 2^-i as common as symbol 0: code lengths 1, 2, 3, ...
    # up to 15, where the limit binds
    freq = np.array([1 << max(0, 40 - i) for i in range(256)], np.int64)
    e_tab = DF.DeflateTable(freq, len(edge))
    check(e_tab.max_code == 15, f"edge table max_code {e_tab.max_code}")
    offs, buf = [], bytearray()
    for p in edge:
        buf += b"\0" * (3 + len(buf) % 2)
        offs.append(len(buf))
        buf += p.tobytes()
    e_pay = torch.frombuffer(buf, dtype=torch.uint8).to(dev)
    e_off = torch.tensor(offs, dtype=torch.int64, device=dev)
    e_len = torch.tensor([len(p) for p in edge], dtype=torch.int32,
                         device=dev)
    ekb, eke, epb, epe, e_mism, e_err, _ = w2_against_plain(
        torch, dev, e_pay, e_off, e_len, e_tab)
    check(e_mism == 0, f"deflate != plain version on the edge lanes "
          f"({e_mism})")
    ep_body, ep_end = DF.fetch(epb, epe, e_tab)
    e_plain_flagged = [
        j for j, p in enumerate(edge)
        if DF.expanded(DF.finalize_stream(ep_body[j], int(ep_end[j]), e_tab),
                       p.tobytes())]
    e_body, e_end = DF.fetch(ekb, eke, e_tab)
    e_blocks = [None] * len(edge)

    def e_route(fl):
        for j in fl:
            e_blocks[j] = DF.host_block(edge[j].tobytes())

    e_flagged = DF.finalize_chunk(e_body, e_end, e_tab,
                                  [p.tobytes() for p in edge],
                                  e_blocks.__setitem__, e_route)
    check(e_flagged == e_plain_flagged and 3 in e_flagged
          and 2 not in e_flagged,
          f"edge lanes taking the host route: {e_flagged}, plain "
          f"{e_plain_flagged}")
    for p, blk in zip(edge, e_blocks):
        check(zlib.decompress(blk[18:-8], -15) == p.tobytes(),
              "an edge lane's block does not inflate to its payload")
    log(f"record_gather: {n} records, {nbytes} bytes, 0 mismatches against "
        f"the plain version and the host gather; {w1_ms:.4f} ms through the "
        f"wrapper, {w1_dev_ms:.4f} ms on the device, plain "
        f"{w1_plain_ms:.2f} ms; geometry {json.dumps(w1_geom)}")
    log(f"deflate: {n_blocks} payloads, max_code {table.max_code}, "
        f"header {table.header_bits} bits, rows of {table.out_bytes} bytes, "
        f"{body_bytes} body bytes, 0 mismatches against the plain version "
        f"(bodies to each lane's occupied end, end bits), expanded lanes "
        f"{len(flagged)} (plain {len(plain_flagged)}); edge lanes (1, 255, "
        f"65,280 bytes, incompressible; 15-bit codes) exact, lanes "
        f"{e_flagged} (plain {e_plain_flagged}) on the host route; "
        f"{w2_ms:.4f} ms through the "
        f"wrapper, {w2_dev_ms:.4f} ms on the device, plain "
        f"{w2_plain_ms:.2f} ms; geometry {json.dumps(w2_geom)}")
    la = books["a"]["launches"]
    kernels = [
        {"name": "record_gather", "route": "cuda",
         "source": "disq_tpu_torch/csrc/record_gather.cu",
         "replaces": "disq_tpu/runtime/device_write.py:64 (XLA, not Pallas)",
         "launches": la.get("record_gather", 0),
         "launches_w4": books["b"]["launches"].get("record_gather", 0),
         "max_abs_err": w1_err, "ms": round(w1_ms, 4),
         "ms_device": round(w1_dev_ms, 4), "plain_ms": round(w1_plain_ms, 4),
         "bound_ms": round(w1_bytes / HBM_BYTES_PER_S * 1e3, 6),
         "bound_by": "bytes", "library_ms": None, "mismatches": w1_mism,
         "tolerance": 0, "shape": {"records": n, "bytes": nbytes},
         "plain_on": "the same inputs (the whole shard), on the card",
         "geometry": w1_geom},
        {"name": "deflate", "route": "cuda",
         "source": "disq_tpu_torch/csrc/deflate.cu",
         "replaces": "disq_tpu/ops/deflate.py:261 (XLA, not Pallas)",
         "launches": la.get("deflate", 0),
         "launches_w4": books["b"]["launches"].get("deflate", 0),
         "max_abs_err": max(w2_err, e_err), "ms": round(w2_ms, 4),
         "ms_device": round(w2_dev_ms, 4), "plain_ms": round(w2_plain_ms, 4),
         "bound_ms": round(w2_bytes / HBM_BYTES_PER_S * 1e3, 6),
         "bound_by": "bytes", "library_ms": None, "mismatches": w2_mism,
         "tolerance": 0,
         "shape": {"payloads": n_blocks, "bytes_in": nbytes,
                   "body_bytes": body_bytes, "max_code": table.max_code,
                   "row_bytes": table.out_bytes},
         "plain_on": "the same inputs (every payload of the shard), on the "
                     "card",
         "sample": "4 edge lanes (1, 255, 65,280 bytes, incompressible) "
                   "under 15-bit codes",
         "sample_mismatches": e_mism, "sample_host_route": e_flagged,
         "expanded_lanes": len(flagged),
         "expanded_lanes_plain": len(plain_flagged), "geometry": w2_geom},
    ]
    del k_pay, enc, shard, sorted_ds
    e2e = {"device_write_s": round(seconds["a"], 4),
           "device_write_w4_s": round(seconds["b"], 4),
           "device_write_bytes": sizes["a"][0],
           "zlib6_write_bytes": sizes["a"][1],
           "device_write_w4_bytes": sizes["b"][0],
           "zlib6_write_w4_bytes": sizes["b"][1],
           "device_write_stages_s": stages,
           "device_write_digest_s": round(digest_s, 4)}
    return kernels, e2e


# -- device tracing and the device service -----------------------------------

SERVICE_KNOB = "DISQ_TPU_TORCH_DEVICE_SERVICE"
FLUSH_KNOB = "DISQ_TPU_TORCH_SERVICE_FLUSH_MS"
# the service CRAM leg's flush window: the head's splits submit their
# streams within a second of each other, so they share a launch
SERVICE_CRAM_FLUSH_MS = 5000
PLAIN_SAMPLE_LANES = 64          # B1 lanes of a coalesced chunk held
PLAIN_SAMPLE_STREAMS = 8         # against the plain version (B3 streams)


def span_sums(tracing) -> dict:
    """Seconds and calls per span name in the span ring, summed over
    threads; ``device.kernel`` split by its kernel label."""
    out = {}
    for s in tracing.spans():
        name = s["name"]
        if name == "device.kernel":
            name += f"[{s['labels'].get('kernel')}]"
        t, c = out.get(name, (0.0, 0))
        out[name] = (t + s["dur"], c + 1)
    return {k: {"s": round(t, 4), "n": c} for k, (t, c) in sorted(out.items())}


class ChunkCapture:
    """Around the service's engines: keeps, per codec, the launched chunk
    with the most owners (then the most lanes) as (payload, expected
    size, owner) per lane, with what the dispatcher's own fetch of that
    launch returned; counts the inflate lanes submitted."""

    FETCH = {"inflate": ("inflate_simd", "fetch_payloads"),
             "rans": ("rans_simd", "fetch_streams"),
             "deflate": ("deflate", "fetch")}

    def __init__(self, DS) -> None:
        self.DS = DS
        self.best = {}      # kind -> (key, lanes, launch handle)
        self.fetched = {}   # kind -> the dispatcher's fetch of that launch
        self.submitted = 0
        self._saved = []

    def __enter__(self):
        import importlib

        DS = self.DS
        for cls in (DS._InflateEngine, DS._RansEngine, DS._DeflateEngine):
            self._saved.append((cls, "launch", cls.launch))

            def launch(engine, lanes, _orig=cls.launch, _kind=cls.kind):
                handle = _orig(engine, lanes)
                key = (len({id(l.sub) for l in lanes}), len(lanes))
                if key > self.best.get(_kind, ((0, 0), None, None))[0]:
                    self.best[_kind] = (key, [(l.payload, l.expect,
                                               id(l.sub)) for l in lanes],
                                        handle)
                    self.fetched.pop(_kind, None)
                return handle

            cls.launch = launch
        for kind, (mod, name) in self.FETCH.items():
            m = importlib.import_module(f"disq_tpu_torch.ops.{mod}")
            self._saved.append((m, name, getattr(m, name)))

            def fetch(handle, *rest, _orig=getattr(m, name), _kind=kind):
                out = _orig(handle, *rest)
                best = self.best.get(_kind)
                # the deflate engine's handle is (bodies, end, table)
                if best is not None and handle is (
                        best[2][0] if _kind == "deflate" else best[2]):
                    self.fetched[_kind] = out
                return out

            setattr(m, name, fetch)
        svc = DS.DeviceDecodeService
        self._saved.append((svc, "submit_inflate", svc.submit_inflate))

        def submit_inflate(service, payloads, usizes,
                           _orig=svc.submit_inflate):
            self.submitted += len(payloads)
            return _orig(service, payloads, usizes)

        svc.submit_inflate = submit_inflate
        return self

    def __exit__(self, *exc) -> None:
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)

    def chunk(self, kind: str):
        """(owners, lanes) of the kept chunk, its lanes, its launch handle
        and the dispatcher's fetch of it."""
        key, lanes, handle = self.best[kind]
        check(kind in self.fetched,
              f"service chunk: the dispatcher's {kind} fetch was not seen")
        return key, lanes, handle, self.fetched[kind]


def _flushes(tracing) -> dict:
    return dict(tracing.REGISTRY.counter("device.batch.flush")._snapshot())


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _spread(owners, k: int) -> list:
    """Up to ``k`` lane indices spread over a chunk, every owner's first
    lane among them."""
    pick = set({o: j for j, o in reversed(list(enumerate(owners)))}.values())
    for j in np.linspace(0, len(owners) - 1, max(1, k)).astype(int):
        if len(pick) >= k:
            break
        pick.add(int(j))
    return sorted(pick)


def service_legs(torch, port, args, g, perm_want, info, ds, src, work, dev,
                 head):
    """The device service (``DISQ_TPU_TORCH_DEVICE_SERVICE=1``): the BAM
    read at 1 and 4 executor workers against the default read, every lane
    decoded on the card; the CRAM read with 4 workers of the 3-split
    ``head`` (``cram_policy_legs``) against the generator, its splits
    sharing B3 launches under a ``SERVICE_CRAM_FLUSH_MS`` flush window;
    the device write (8 shards, 4 writer workers, BAI + SBI) of the
    sorted host batch through the service's deflate engine against the
    zlib-6 write's stream and the generator. Then, on the most-coalesced
    chunk each engine launched, what the dispatcher fetched for it:
    B1 and B3 against zlib / the native decoder on every lane and all
    three against their plain versions. Returns (per-kernel service
    entries, e2e fields)."""
    from disq_tpu_torch.api import ReadsDataset
    from disq_tpu_torch.native import rans_decode_native
    from disq_tpu_torch.ops import deflate as DF
    from disq_tpu_torch.ops import inflate_simd as B1
    from disq_tpu_torch.ops import rans_simd as B3
    from disq_tpu_torch.runtime import counters, tracing
    from disq_tpu_torch.runtime import device_service as DS

    split = args.split_size
    e2e, books = {}, {}
    os.environ[SERVICE_KNOB] = "1"
    os.environ["DISQ_TPU_TORCH_CRAM_RANS_O1"] = "0"
    try:
        with ChunkCapture(DS) as cap:
            # -- the BAM read ---------------------------------------------
            for workers in (1, 4):
                counters.reset()
                tracing.reset_gauges()
                f0, s0, sub0 = _flushes(tracing), dict(B1.last_stats), \
                    cap.submitted
                t0 = time.perf_counter()
                got = (port.ReadsStorage.make_default().split_size(split)
                       .executor_workers(workers).read(src))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                snap = counters.snapshot()
                lanes = {k: B1.last_stats[k] - s0[k] for k in s0}
                submitted = cap.submitted - sub0
                flush = _delta(f0, _flushes(tracing))
                fill = tracing.REGISTRY.gauge("device.lane_fill").state()
                check(DS.service_if_running() is not None,
                      "the service read started no service")
                check(lanes["device_lanes"] == submitted >= info["blocks"]
                      and lanes["host_fallback"] == lanes["host_big"] == 0
                      and not snap["host_fallback_blocks"],
                      f"service read ({workers}): lanes {lanes}, "
                      f"submitted {submitted}, host fallback "
                      f"{snap['host_fallback_blocks']}")
                b1 = snap["launches"].get("inflate", 0)
                check(b1 == sum(flush.values()) > 0,
                      f"service read ({workers}): B1 launches {b1}, "
                      f"flushes {flush}")
                same_reads(torch, got, ds, f"service read ({workers})")
                del got
                books[f"read_w{workers}"] = {
                    "inflate_launches": b1, "flush": flush,
                    "lanes": lanes, "submitted": submitted,
                    "lane_fill": fill}
                e2e[f"service_read_w{workers}_s"] = round(secs, 4)
                log(f"service read ({workers} workers): {secs:.4f}s, equal "
                    f"to the default read; B1 launches {b1}, flushes "
                    f"{json.dumps(flush)}, lanes {json.dumps(lanes)} of "
                    f"{submitted} submitted, lane_fill "
                    f"{json.dumps(fill)}")

            # -- the CRAM read ----------------------------------------------
            # a service whose flush window lets the splits meet
            DS.shutdown_service()
            os.environ[FLUSH_KNOB] = str(SERVICE_CRAM_FLUSH_MS)
            sorted_rb = ds.coordinate_sorted().reads
            m = head["records"]
            n_splits = len({off // split for off in head["offsets"]})
            counters.reset()
            tracing.reset_gauges()
            f0, r0 = _flushes(tracing), dict(B3.last_stats)
            t0 = time.perf_counter()
            cr = (port.ReadsStorage.make_default().split_size(split)
                  .executor_workers(4).read(head["path"]))
            secs = time.perf_counter() - t0
            snap = counters.snapshot()
            b3 = snap["launches"].get("rans_simd", 0)
            streams = {k: B3.last_stats[k] - r0[k] for k in r0}
            flush = _delta(f0, _flushes(tracing))
            fill = tracing.REGISTRY.gauge("device.lane_fill").state()
            DS.shutdown_service()
            os.environ.pop(FLUSH_KNOB)
            head_equal(cr.reads, sorted_rb, m, "service cram read")
            check(cr.counters.shards == head["counters"]["shards"],
                  f"service cram read: {cr.counters.shards} splits")
            check(0 < b3 < n_splits,
                  f"service cram read: B3 launches {b3} for {n_splits} "
                  f"splits with streams (flushes {flush})")
            check(streams["device_lanes"] > 0
                  and streams["host_fallback"] == streams["host_big"] == 0
                  and not snap["host_fallback_blocks"]
                  and not snap["host_rans_streams"],
                  f"service cram read: streams {streams}, host fallback "
                  f"{snap['host_fallback_blocks']}, host rANS "
                  f"{snap['host_rans_streams']}")
            del cr
            # B3's plain version on a sample of the most-coalesced chunk
            # (~40 s for 1.5 MB streams) runs beside the legs below
            _, r_lanes, _, _ = cap.chunk("rans")
            r_pick = _spread([o for _, _, o in r_lanes],
                             PLAIN_SAMPLE_STREAMS)
            r_sample = [r_lanes[j][0][0] for j in r_pick]
            b3_plain = plain_async("rans_simd", r_sample,
                                   [0] * len(r_sample), 1)
            books["cram"] = {"rans_launches": b3, "splits": n_splits,
                             "streams": streams, "flush": flush,
                             "lane_fill": fill}
            e2e["service_cram_read_w4_s"] = round(secs, 4)
            log(f"service cram read (the {m}-record head, {n_splits} "
                f"splits with streams, 4 workers, flush window "
                f"{SERVICE_CRAM_FLUSH_MS} ms): {secs:.4f}s, equal to the "
                f"generator; B3 launches {b3}, streams {json.dumps(streams)}, "
                f"flushes {json.dumps(flush)}, lane_fill {json.dumps(fill)}")

            # -- the device write ---------------------------------------------
            out = os.path.join(work, "device_service.bam")
            sorted_ds = ReadsDataset(
                header=ds.header.with_sort_order("coordinate"),
                reads=sorted_rb)
            counters.reset()
            tracing.reset_gauges()
            f0 = _flushes(tracing)
            t0 = time.perf_counter()
            (port.ReadsStorage.make_default().split_size(split)
             .num_shards(WRITE_SHARDS).writer_workers(4).device_deflate()
             .write(sorted_ds, out, port.BaiWriteOption.ENABLE,
                    port.SbiWriteOption.ENABLE))
            write_s = time.perf_counter() - t0
            del sorted_ds
            snap = counters.snapshot()
            w2 = snap["launches"].get("deflate", 0)
            flush = _delta(f0, _flushes(tracing))
            fill = tracing.REGISTRY.gauge("device.lane_fill").state()
            host = {k: v for k, v in snap["host_fallback_blocks"].items()
                    if k != "expanded"}
            check(w2 == sum(flush.values()) > 0
                  and "record_gather" not in snap["launches"] and not host,
                  f"service write: launches {snap['launches']}, flushes "
                  f"{flush}, host fallback {snap['host_fallback_blocks']}")
            with open(out, "rb") as f:
                got = f.read()
            with open(os.path.join(work, "sorted_sbi.bam"), "rb") as f:
                want = f.read()
            # every block inflates with zlib (CRC and ISIZE checked)
            check(bgzf_layout(got)[0] == bgzf_layout(want)[0],
                  "service write: the uncompressed stream differs from the "
                  "zlib-6 write's")
            sizes = (len(got), len(want))
            del got, want
            back = port.ReadsStorage.make_default().split_size(split).read(out)
            for col in FIXED:
                check(np.array_equal(getattr(back.reads, col),
                                     g[col][perm_want]),
                      f"service write re-read: column {col}")
            del back
            books["write"] = {"deflate_launches": w2, "flush": flush,
                              "lane_fill": fill,
                              "expanded": snap["host_fallback_blocks"].get(
                                  "expanded", 0)}
            e2e["service_device_write_w4_s"] = round(write_s, 4)
            e2e["service_device_write_bytes"] = sizes[0]
            log(f"service device write (8 shards, 4 writer workers, BAI + "
                f"SBI): {write_s:.4f}s, {sizes[0]} bytes (zlib-6 "
                f"{sizes[1]}), inflates to the zlib-6 write's stream, "
                f"re-read equal to the generator; W2 launches {w2}, flushes "
                f"{json.dumps(flush)}, lane_fill {json.dumps(fill)}")
    finally:
        os.environ.pop(SERVICE_KNOB, None)
        os.environ.pop(FLUSH_KNOB, None)
        DS.shutdown_service()
    check(DS.service_if_running() is None, "the service outlived its legs")

    # -- B1 on the most-coalesced inflate chunk -------------------------------
    (owners, n_lanes), lanes, _, (blob, ln, st, oo) = cap.chunk("inflate")
    pls = [bytes(p) for p, _, _ in lanes]
    exp = [e for _, e, _ in lanes]
    check(not st.any() and np.array_equal(ln, exp),
          "service chunk: the dispatcher's B1 flagged a lane")
    for j, p in enumerate(pls):
        check(blob[oo[j]: oo[j + 1]].tobytes() == zlib.decompress(p, -15),
              f"service chunk: B1 lane {j} differs from zlib")
    pick = _spread([o for _, _, o in lanes], PLAIN_SAMPLE_LANES)
    (p_blob, p_len, p_st), b1_plain_ms, _procs = plain_on_payloads(
        "inflate", [pls[j] for j in pick], [exp[j] for j in pick])
    k_blob = np.concatenate([blob[oo[j]: oo[j + 1]] for j in pick])
    b1_mism = int((k_blob != p_blob).sum() + (ln[pick] != p_len).sum()
                  + (st[pick] != p_st).sum())
    check(b1_mism == 0, f"service chunk: B1 != plain version ({b1_mism})")
    staged = B1.Staged("inflate", [pls, np.concatenate(
        [[0], np.cumsum([len(p) for p in pls])[:-1]]).astype(np.int64),
        np.array([len(p) for p in pls], np.int64), oo], dev)
    total = int(oo[-1])
    b1_ms = cuda_ms(torch, lambda: B1.inflate(*staged.tensors, total), 1, 5)
    torch.cuda.synchronize()
    staged.release()
    b1_bytes = sum(len(p) for p in pls) + total + 8 * (3 * n_lanes + 1)
    entries = {"inflate": {
        "launches": books["read_w4"]["inflate_launches"],
        "launches_w1": books["read_w1"]["inflate_launches"],
        "flush_w4": books["read_w4"]["flush"],
        "lane_fill_w4": books["read_w4"]["lane_fill"],
        "chunk": {"lanes": n_lanes, "owners": owners, "bytes_out": total},
        "ms": round(b1_ms, 4),
        "bound_ms": round(b1_bytes / HBM_BYTES_PER_S * 1e3, 6),
        "lanes_against_zlib": n_lanes, "plain_sample_lanes": len(pick),
        "plain_ms_on_sample": round(b1_plain_ms, 4), "mismatches": b1_mism}}
    del blob, pls, lanes

    # -- B3 on the most-coalesced rANS chunk ---------------------------------
    streams = [p[0] for p, _, _ in r_lanes]
    out, used, st, ren_off, out_off = cap.chunk("rans")[3]
    check(not st.any(), "service chunk: the dispatcher's B3 flagged a stream")
    for j, s in enumerate(streams):
        check(out[out_off[j]: out_off[j + 1]].tobytes()
              == rans_decode_native(s),
              f"service chunk: B3 stream {j} differs from the native codec")
    k = [np.concatenate([out[out_off[j]: out_off[j + 1]] for j in r_pick]),
         used[r_pick], st[r_pick]]
    p, b3_plain_ms, _procs = b3_plain()
    b3_err, b3_mism = rans_errors(k, p, 0)
    check(b3_mism == 0, f"service chunk: B3 != plain version ({b3_mism})")
    _live, c_args, _ = B3.stage_streams(streams, dev)
    c_total = int(out_off[-1])
    b3_ms = cuda_ms(torch, lambda: B3.rans0_decode(*c_args, c_total), 1, 3)
    b3_bound, b3_by = rans_bound(ren_off, out_off)
    entries["rans_simd"] = {
        "launches": books["cram"]["rans_launches"],
        "flush": books["cram"]["flush"],
        "lane_fill": books["cram"]["lane_fill"],
        "chunk": {"streams": len(streams), "owners": len(
            {o for _, _, o in r_lanes}), "bytes_out": c_total},
        "ms": round(b3_ms, 4),
        "bound_ms": round(b3_bound, 6), "bound_by": b3_by,
        "splits": books["cram"]["splits"],
        "streams_against_native": len(streams),
        "plain_sample_streams": len(r_sample),
        "plain_ms_on_sample": round(b3_plain_ms, 4), "mismatches": b3_mism,
        "max_abs_err": b3_err}
    del out, streams, r_lanes, c_args

    # -- W2 on the most-coalesced deflate chunk ------------------------------
    (owners, n_lanes), lanes, handle, (body_h, end_h) = cap.chunk("deflate")
    table = handle[2]
    pls = [bytes(p) for p, _, _ in lanes]
    lens = np.array([len(p) for p in pls], np.int32)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    payload = torch.frombuffer(bytearray(b"".join(pls)),
                               dtype=torch.uint8).to(dev)
    d_off = torch.from_numpy(offs).to(dev)
    d_len = torch.from_numpy(lens).to(dev)
    check(np.array_equal(table.lit_lens, DF.DeflateTable(
        DF.histogram(payload), n_lanes).lit_lens),
          "service chunk: W2's table is not the chunk's histogram's")
    w2_mism, w2_err, w2_plain_ms = w2_fetched_against_plain(
        torch, dev, payload, d_off, d_len, table, body_h, end_h)
    check(w2_mism == 0, f"service chunk: W2 != plain version ({w2_mism})")
    body_bytes = int(((end_h.astype(np.int64) + 7) // 8).sum())
    del body_h, handle
    luts = table.luts(dev)
    w2_ms = cuda_ms(torch, lambda: DF.encode(
        payload, d_off, d_len, *luts, table.header_bits, table.out_bytes),
        1, 5)
    w2_bytes = int(lens.sum()) + body_bytes + 12 * n_lanes + 2048
    entries["deflate"] = {
        "launches": books["write"]["deflate_launches"],
        "flush": books["write"]["flush"],
        "lane_fill": books["write"]["lane_fill"],
        "expanded_lanes": books["write"]["expanded"],
        "chunk": {"payloads": n_lanes, "owners": owners,
                  "bytes_in": int(lens.sum()), "body_bytes": body_bytes},
        "ms": round(w2_ms, 4), "plain_ms": round(w2_plain_ms, 4),
        "bound_ms": round(w2_bytes / HBM_BYTES_PER_S * 1e3, 6),
        "mismatches": w2_mism, "max_abs_err": w2_err}
    del payload, lanes, pls
    log(f"service kernels on coalesced chunks: {json.dumps(entries)}")
    return entries, e2e


def trace_leg(torch, port, args, src, work) -> dict:
    """One BAM read under ``tracing.start_trace``: B1 and B2 kernel events
    in the exported Chrome trace against their launch counts, and, when
    they agree, the device's busy share (union of kernel and copy
    intervals) of the read's ``bam.read.splits`` window."""
    from disq_tpu_torch.runtime import counters, tracing

    counters.reset()
    tdir = os.path.join(work, "trace")
    tracing.start_trace(tdir)
    t0 = time.perf_counter()
    got = port.ReadsStorage.make_default().split_size(args.split_size) \
        .read(src)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    path = tracing.stop_trace()
    check(got.count() == args.records, "traced read count")
    del got
    launches = counters.snapshot()["launches"]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    seen = {"inflate": sum("inflate_kernel" in e["name"]
                           and "legacy" not in e["name"] for e in kern),
            "parse": sum("parse_kernel" in e["name"] for e in kern)}
    booked = {k: launches.get(k, 0) for k in seen}
    res = {"read_s": round(read_s, 4), "trace_kernels": seen,
           "launches": booked, "trace_bytes": os.path.getsize(path)}
    if seen != booked:
        res["mismatch"] = True
        log(f"trace: kernel events {seen} != launches {booked}; no busy "
            f"share ({json.dumps(res)})")
        return res
    win = [e for e in events if e.get("name") == "disq_tpu.bam.read.splits"
           and e.get("ph") == "X"]
    lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    spans = sorted((max(lo, e["ts"]), min(hi, e["ts"] + e["dur"]))
                   for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and e.get("ph") == "X")
    busy, end = 0.0, lo
    for a, b in spans:
        if b <= a:
            continue
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    res["window_ms"] = round((hi - lo) / 1e3, 4)
    res["busy_ms"] = round(busy / 1e3, 4)
    res["busy_share"] = round(busy / (hi - lo), 6)
    log(f"trace: {json.dumps(res)}")
    return res


# -- operators (A12): the read filter in the decode, and a resident chain ----

DUP_PAIR_FRACTION = 0.05     # pairs that copy another pair's alignment
OPS_FILTER = "-F 0x904 -q 20 -s 7.5"
OPS_CHAIN = (("filter", "-F 0x400"), "sort", "markdup", "rgstats",
             ("pileup", 0, 1_000_000, 5_194_304))
F1_BYTES_PER_RECORD = 13     # flag, mapq and name hash in; one byte out


def synthesize_dups(n: int, seed: int) -> dict:
    """``synthesize(n, seed)`` in which a seeded 5 % of pairs copy another
    pair's refid, pos, CIGAR and flags (and what follows from them: bin,
    mate fields, tlen) under their own names, sequences, qualities and
    tags. Sources are drawn with replacement from the other pairs, so
    duplicate groups of 2 and more exist."""
    g = synthesize(n, seed)
    rng = np.random.default_rng([seed, 5])
    pairs = n // 2
    k = int(pairs * DUP_PAIR_FRACTION)
    pick = rng.permutation(pairs)
    dst = pick[:k]
    src = pick[k:][rng.integers(0, pairs - k, k)]
    for col in ("refid", "pos", "bin", "flag", "next_refid", "next_pos",
                "tlen", "ncig", "cig"):
        for mate in (0, 1):
            g[col][2 * dst + mate] = g[col][2 * src + mate]
    return g


def fnv1a_rows(names: np.ndarray) -> np.ndarray:
    """u32 FNV-1a of each row of an (n, L) byte array."""
    h = np.full(len(names), 0x811C9DC5, np.uint32)
    for j in range(names.shape[1]):
        h = (h ^ names[:, j]) * np.uint32(0x01000193)
    return h


def subsample_keep(h: np.ndarray, seed: int, frac: float) -> np.ndarray:
    """samtools-style ``-s SEED.FRAC`` on u32 name hashes: a splitmix32
    finalizer of hash ^ seed mix against FRAC * 2**32."""
    x = h ^ np.uint32((seed * 0x9E3779B9) & 0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x < np.uint32(min(0xFFFFFFFF, round(frac * 2 ** 32)))


def cigar_extents(g: dict):
    """(reference span, leading clip, trailing clip) of every generator
    record from its op table (clips are soft, at either end)."""
    code, length = g["cig"] & 0xF, (g["cig"] >> 4).astype(np.int64)
    used = np.arange(3)[None, :] < g["ncig"][:, None]
    span = (length * (used & np.isin(code, (0, 2, 3, 7, 8)))).sum(1)
    clip = used & (code == 4)
    lead = np.where(clip[:, 0], length[:, 0], 0)
    last = np.maximum(g["ncig"] - 1, 0)
    rows = np.arange(len(last))
    trail = np.where(clip[rows, last] & (g["ncig"] > 1),
                     length[rows, last], 0)
    return span, lead, trail


def numpy_markdup(g: dict, rows: np.ndarray):
    """Duplicate flags of the generator's records ``rows`` (coordinate
    order): key (refid, unclipped 5' position, strand) among records not
    unmapped, secondary or supplementary; in each key group all but the
    best sum of qualities >= 15 (the first on ties) are duplicates.
    Returns the flags and the key columns (refid, upos, strand, score,
    examined)."""
    span, lead, trail = (a[rows] for a in cigar_extents(g))
    flag = g["flag"][rows].astype(np.int64)
    refid = g["refid"][rows].astype(np.int64)
    pos = g["pos"][rows].astype(np.int64)
    rev = (flag & 0x10) != 0
    upos = np.where(rev, pos + np.maximum(span, 1) - 1 + trail, pos - lead)
    q = g["qual"][rows].astype(np.int64)
    score = (q * (q >= 15)).sum(1)
    valid = ((flag & 0x904) == 0) & (refid >= 0)
    idx = np.arange(len(rows))
    hi = np.where(valid, refid, 1 << 40)
    up = np.where(valid, upos, idx)
    order = np.lexsort((-score, rev, up, hi))
    first = np.ones(len(rows), bool)
    first[1:] = ((hi[order][1:] != hi[order][:-1])
                 | (up[order][1:] != up[order][:-1])
                 | (rev[order][1:] != rev[order][:-1]))
    dup = np.zeros(len(rows), bool)
    dup[order] = ~first & valid[order]
    return dup, (refid, upos, rev.astype(np.int64), score, valid)


def timed_ops(pipe, seconds: dict, torch) -> None:
    """Wrap each op's ``apply`` to add its seconds (to the end of its
    device work) into ``seconds[op name]``."""
    for op in pipe.ops:
        def apply(batch, shard, _orig=op.apply, _name=op.name):
            t0 = time.perf_counter()
            out = _orig(batch, shard)
            torch.cuda.synchronize()
            seconds[_name] = round(seconds.get(_name, 0.0)
                                   + time.perf_counter() - t0, 4)
            return out

        op.apply = apply


def graph_ms_or_none(torch, fn, what: str):
    """``graph_ms`` of a chain of torch ops, or None (logged) when the
    chain cannot be captured in a CUDA graph."""
    try:
        return round(graph_ms(torch, fn, 5, 3), 4)
    except RuntimeError as e:
        torch.cuda.synchronize()
        log(f"{what}: no CUDA graph ({e}); device time not measured")
        return None


def operator_legs(torch, port, args, work, dev):
    """The operator suite on ``dups.bam``: (a) a read with
    ``.read_filter(OPS_FILTER)`` equal to the generator's records under a
    numpy mask of this script's own, F1 once per split; (b) F1 against
    its plain version on every record; (c) ``OPS_CHAIN`` on the resident
    dataset and on a host copy, equal to each other and to numpy oracles
    of the generator (duplicates, per-RG stats, coverage), both written
    with zlib-6 byte-identical. Returns F1's ``kernels`` entry and the
    phase's end-to-end numbers."""
    from disq_tpu_torch.ops import cuda_build
    from disq_tpu_torch.ops import markdup as MD
    from disq_tpu_torch.ops import rfilter as RF
    from disq_tpu_torch.ops import rgstats as RG
    from disq_tpu_torch.runtime import counters, tracing
    from disq_tpu_torch.runtime.oppipe import OpPipeline

    n = args.records
    t0 = time.perf_counter()
    g = synthesize_dups(n, args.seed)
    dups = os.path.join(work, "dups.bam")
    info = write_bam(dups, g, n)
    synth_s = time.perf_counter() - t0
    n_splits = -(-info["file_bytes"] // args.split_size)
    name_hash = fnv1a_rows(g["names"])
    # OPS_FILTER's terms: -F 0x904, -q 20, -s 7.5 (seed 7, keep 0.5)
    keep = (((g["flag"] & 0x904) == 0) & (g["mapq"] >= 20)
            & subsample_keep(name_hash, 7, 0.5))
    log(f"operators: dups.bam {n} reads ({int(n // 2 * DUP_PAIR_FRACTION)} "
        f"copied pairs), {info['file_bytes']} bytes, {n_splits} splits, "
        f"{synth_s:.1f}s")

    # (a) the read filter inside the decode
    tracing.reset_telemetry()
    counters.reset()
    t0 = time.perf_counter()
    fds = port.ReadsStorage.make_default().split_size(args.split_size) \
        .read_filter(OPS_FILTER).read(dups)
    torch.cuda.synchronize()
    filt_s = time.perf_counter() - t0
    la = counters.snapshot()["launches"]
    kept_in = tracing.REGISTRY.counter("ops.filter.records_in").total()
    kept_out = tracing.REGISTRY.counter("ops.filter.records_kept").total()
    rows = np.nonzero(keep)[0]
    equal_to_generator(torch, fds, g, rows, "filtered read")
    check(la.get("read_filter", 0) == n_splits,
          f"F1 launches {la.get('read_filter', 0)}, want one per split "
          f"({n_splits})")
    check(la.get("inflate", 0) == n_splits and la.get("parse", 0) == n_splits,
          f"B1/B2 launches on the filtered read: {la}")
    check((kept_in, kept_out) == (n, len(rows)),
          f"ops.filter counters {kept_in} -> {kept_out}")
    log(f"operators (a) filtered read: {filt_s:.3f}s, {len(rows)} of {n} "
        f"kept, equal to the numpy mask; launches {json.dumps(la)}")
    del fds

    # (b) F1 against its plain version on every record
    rf = RF.parse_read_filter(OPS_FILTER)
    flag_d = torch.from_numpy(g["flag"].astype(np.int32)).to(dev)
    mapq_d = torch.from_numpy(g["mapq"].astype(np.int32)).to(dev)
    nh_d = torch.from_numpy(name_hash.view(np.int32)).to(dev)
    ops_ = (rf.require_flags, rf.exclude_flags, rf.min_mapq, rf.seed_mix,
            rf.threshold)
    k_mask = RF.build_mask(flag_d, mapq_d, nh_d, *ops_)
    p_mask = RF.mask_plain(flag_d, mapq_d, nh_d, *ops_)
    torch.cuda.synchronize()
    f1_err = int((k_mask.int() - p_mask.int()).abs().max())
    f1_mism = int((k_mask != p_mask).sum())
    check(f1_err == 0 and f1_mism == 0,
          f"read_filter kernel != plain version on {f1_mism} records")
    check(np.array_equal(k_mask.cpu().numpy().astype(bool), keep),
          "read_filter kernel != the numpy mask")
    per = -(-n // n_splits)
    sl = (flag_d[:per], mapq_d[:per], nh_d[:per])
    f1_ms = cuda_ms(torch, lambda: RF.build_mask(*sl, *ops_), 3, 20)
    f1_dev = graph_ms(torch, lambda: RF.build_mask(*sl, *ops_))
    f1_plain = cuda_ms(torch, lambda: RF.mask_plain(*sl, *ops_), 2, 10)
    full = (flag_d, mapq_d, nh_d)
    f1_all_ms = cuda_ms(torch, lambda: RF.build_mask(*full, *ops_), 3, 20)
    f1_all_dev = graph_ms(torch, lambda: RF.build_mask(*full, *ops_))
    f1_all_plain = cuda_ms(torch, lambda: RF.mask_plain(*full, *ops_), 2, 10)
    f1_geom = cuda_build.geometry("read_filter", per)
    log(f"read_filter: all {n} records exact against the plain version and "
        f"the numpy mask; {per} records: kernel {f1_ms:.4f} ms through the "
        f"wrapper, {f1_dev:.4f} ms on the device alone, plain "
        f"{f1_plain:.4f} ms; {n} records: {f1_all_ms:.4f} / {f1_all_dev:.4f}"
        f" / plain {f1_all_plain:.4f} ms; geometry {json.dumps(f1_geom)}")
    del k_mask, p_mask, flag_d, mapq_d, nh_d, sl, full

    # (c) the chain, resident and on a host copy
    storage = port.ReadsStorage.make_default().split_size(args.split_size)
    ds = storage.read(dups)
    mat = tracing.REGISTRY.counter("columnar.batch.materializations")
    avoided = tracing.REGISTRY.counter("device.d2h_avoided_bytes")
    names = ("ops.filter.records_in", "ops.filter.records_kept",
             "ops.markdup.duplicates", "ops.markdup.boundary_flips",
             "ops.pileup.records")
    runs = {}
    for leg in ("resident", "host"):
        if leg == "host":
            t0 = time.perf_counter()
            ds = port.ReadsDataset(header=ds.header,
                                   reads=ds.reads.to_read_batch(), device=dev)
            host_copy_s = time.perf_counter() - t0
        tracing.reset_spans()
        counters.reset()
        c0 = {k: tracing.REGISTRY.counter(k).total() for k in names}
        m0, a0 = mat.total(), avoided.total()
        pipe = OpPipeline(*OPS_CHAIN, device=dev)
        per_op = {}
        timed_ops(pipe, per_op, torch)
        t0 = time.perf_counter()
        out, stats = ds.pipeline(pipe)
        torch.cuda.synchronize()
        runs[leg] = {
            "ds": out, "stats": stats, "s": round(time.perf_counter() - t0, 4),
            "per_op_s": per_op,
            "spans": {k: v for k, v in span_sums(tracing).items()
                      if k.startswith(("ops.", "device.kernel["))},
            "counters": {k: tracing.REGISTRY.counter(k).total() - c0[k]
                         for k in names},
            "launches": counters.snapshot()["launches"],
            "materializations": mat.total() - m0,
            "d2h_avoided": avoided.total() - a0}
    res, host = runs["resident"], runs["host"]
    check(res["ds"].reads.device_backed, "the resident chain left the card")
    check(res["materializations"] == 0,
          f"the resident chain parsed records on the host "
          f"({res['materializations']})")
    check(res["d2h_avoided"] > 0, "the resident chain avoided no d2h")
    check(res["launches"].get("read_filter", 0) == 1,
          f"F1 launches on the chain: {res['launches']}")
    rs, hs = res["stats"], host["stats"]
    check(rs["markdup"] == hs["markdup"] and rs["rgstats"] == hs["rgstats"]
          and np.array_equal(rs["pileup"]["coverage"],
                             hs["pileup"]["coverage"]),
          "resident and host chains disagree")
    check(res["counters"] == host["counters"],
          f"ops counters: {res['counters']} vs {host['counters']}")

    # the generator's truth: filter, stable coordinate sort, markdup
    rows = np.nonzero((g["flag"] & 0x400) == 0)[0]
    rows = rows[np.argsort(coordinate_keys(g["refid"][rows], g["pos"][rows]),
                           kind="stable")]
    t0 = time.perf_counter()
    dup_want, keys = numpy_markdup(g, rows)
    oracle_s = time.perf_counter() - t0
    got_flag = res["ds"].reads.flag
    check(np.array_equal((got_flag & 0x400) != 0, dup_want),
          "duplicates differ from the numpy group oracle")
    check(np.array_equal(host["ds"].reads.flag, got_flag),
          "host chain flags differ")
    check(rs["markdup"]["duplicates"] == int(dup_want.sum()) > 0,
          f"markdup stats {rs['markdup']}, oracle {int(dup_want.sum())}")
    rg = (rows // 2) % 4
    for name in rs["rgstats"]:
        sel = rg == int(name[3:])
        hist = np.bincount(g["mapq"][rows][sel], minlength=256)
        want = {"reads": int(sel.sum()), "duplicates": int(dup_want[sel].sum()),
                "mapq_hist": hist.tolist()}
        got = {key: rs["rgstats"][name][key] for key in want}
        check(got == want, f"rgstats {name} differs from the generator")
    check(sum(v["reads"] for v in rs["rgstats"].values()) == len(rows),
          "rgstats reads")
    _refid, start, end = OPS_CHAIN[-1][1:]
    span = cigar_extents(g)[0][rows]
    pos = g["pos"][rows].astype(np.int64)
    ends = pos + np.maximum(span, 1)
    sel = (((g["flag"][rows] & 4) == 0) & (g["refid"][rows] == _refid)
           & (pos < end) & (ends > start))
    diff = np.zeros(end - start + 1, np.int64)
    np.add.at(diff, np.clip(pos[sel] - start, 0, end - start - 1), 1)
    np.add.at(diff, np.clip(ends[sel] - 1 - start, 0, end - start - 1) + 1,
              -1)
    check(np.array_equal(rs["pileup"]["coverage"], np.cumsum(diff)[:-1]),
          "pileup differs from the numpy difference array")

    # both results written with zlib-6: byte-identical
    outs, write_s = {}, {}
    for leg in ("resident", "host"):
        outs[leg] = os.path.join(work, f"ops_{leg}.bam")
        t0 = time.perf_counter()
        storage.write(runs[leg]["ds"], outs[leg])
        write_s[leg] = round(time.perf_counter() - t0, 4)
    with open(outs["resident"], "rb") as a, open(outs["host"], "rb") as b:
        check(a.read() == b.read(),
              "resident and host chains wrote different BAMs")
    back = storage.read(outs["resident"])
    check(back.count() == len(rows), "written chain: record count")
    check(int(((back.reads.flag & 0x400) != 0).sum())
          == rs["markdup"]["duplicates"], "written chain: 0x400 count")
    del back

    # the scan and the reduction alone, on the chain's inputs
    refid, upos, orient, score, valid = keys
    cols = [torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)
            for a in (refid, upos, orient, score)]
    ok = torch.from_numpy(valid).to(dev)
    scan = MD.group_scan(*cols, ok)
    check(np.array_equal(scan[0].cpu().numpy(), dup_want),
          "group scan on the card != the numpy oracle")
    scan_ms = cuda_ms(torch, lambda: MD.group_scan(*cols, ok), 1, 5)
    scan_dev = graph_ms_or_none(torch, lambda: MD.group_scan(*cols, ok),
                                "markdup scan")
    t0 = time.perf_counter()
    MD._mark_dups_host(refid, upos, orient, score, valid)
    scan_plain = (time.perf_counter() - t0) * 1e3
    m = len(rows)
    rg_ids, rg_names = RG.read_group_ids(res["ds"].reads)
    rg_d = torch.from_numpy(rg_ids.astype(np.int64)).to(dev)
    resident_cols = res["ds"].reads.device_columns()
    red = lambda: RG.rg_reduce(rg_d, resident_cols["mapq"],  # noqa: E731
                               resident_cols["flag"], len(rg_names))
    red_ms = cuda_ms(torch, red, 1, 5)
    red_dev = graph_ms_or_none(torch, red, "rgstats reduction")
    mq, fl = g["mapq"][rows].astype(np.int64), got_flag.astype(np.int64)
    t0 = time.perf_counter()
    np.bincount(rg_ids * 256 + mq, minlength=len(rg_names) * 256)
    np.bincount(rg_ids, weights=(fl >> 10) & 1, minlength=len(rg_names))
    red_plain = (time.perf_counter() - t0) * 1e3
    torch_ops = {
        "markdup_scan": {"records": m, "ms": round(scan_ms, 4),
                         "ms_device": scan_dev,
                         "bound_ms": round(34 * m / HBM_BYTES_PER_S * 1e3, 6),
                         "plain_ms_host_numpy": round(scan_plain, 4)},
        "rgstats_reduction": {"records": m, "ms": round(red_ms, 4),
                              "ms_device": red_dev,
                              "bound_ms": round(16 * m / HBM_BYTES_PER_S
                                                * 1e3, 6),
                              "plain_ms_host_numpy": round(red_plain, 4)}}
    log(f"operators (c) chain {json.dumps(OPS_CHAIN)}: "
        f"resident {res['s']}s (per op {json.dumps(res['per_op_s'])}), host "
        f"{host['s']}s (per op {json.dumps(host['per_op_s'])}; host copy "
        f"{host_copy_s:.3f}s); {m} records after the filter, "
        f"{rs['markdup']['duplicates']} duplicates = the numpy oracle "
        f"({oracle_s:.3f}s), rgstats and coverage = the generator's; "
        f"writes {json.dumps(write_s)} byte-identical; resident "
        f"materializations 0, d2h avoided {res['d2h_avoided']} bytes; "
        f"ops counters {json.dumps(res['counters'])}")
    log(f"operators spans: resident {json.dumps(res['spans'])}; host "
        f"{json.dumps(host['spans'])}")
    log(f"operators torch ops: {json.dumps(torch_ops)}")
    entry = {
        "name": "read_filter", "route": "cuda",
        "source": "disq_tpu_torch/csrc/read_filter.cu",
        "replaces": "disq_tpu/ops/rfilter.py:201",
        "launches": la.get("read_filter", 0), "max_abs_err": f1_err,
        "ms": round(f1_ms, 4), "plain_ms": round(f1_plain, 4),
        "ms_device": round(f1_dev, 4),
        "bound_ms": round(F1_BYTES_PER_RECORD * per / HBM_BYTES_PER_S * 1e3,
                          6),
        "bound_by": "bytes", "library_ms": None,
        "mismatches": f1_mism, "tolerance": 0, "shape": {"records": per},
        "plain_on": "the same inputs, on the card",
        "all_records": {
            "records": n, "ms": round(f1_all_ms, 4),
            "ms_device": round(f1_all_dev, 4),
            "plain_ms": round(f1_all_plain, 4),
            "bound_ms": round(F1_BYTES_PER_RECORD * n / HBM_BYTES_PER_S
                              * 1e3, 6)},
        "launches_on_chain": res["launches"].get("read_filter", 0),
        "geometry": f1_geom}
    e2e = {"ops_synth_s": round(synth_s, 3), "ops_filtered_read_s":
           round(filt_s, 4), "ops_chain_resident_s": res["s"],
           "ops_chain_host_s": host["s"], "ops_host_copy_s":
           round(host_copy_s, 4), "ops_write_s": write_s,
           "ops_per_op_s": {"resident": res["per_op_s"],
                            "host": host["per_op_s"]},
           "ops_torch_ops": torch_ops}
    return entry, e2e


def run(args) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise PhaseError("CUDA is not available")
    sys.path.insert(0, HERE)
    try:
        import disq_tpu_torch as port
    except ImportError as e:
        raise PhaseError(f"the disq_tpu_torch package is missing: {e}")
    from disq_tpu_torch.ops import cuda_build, inflate_cases
    from disq_tpu_torch.ops import inflate_simd as B1
    from disq_tpu_torch.ops import parse as B2
    from disq_tpu_torch.runtime import counters, tracing

    from disq_tpu_torch.native import _load as load_host_library

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)  # the CUDA context, outside every timing
    load_host_library()  # the host codec library, built from native/
    log(f"setup: CUDA context and host library {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    build_s = cuda_build.build(["inflate", "parse", "rans_simd", "rans",
                                "inflate_legacy", "record_gather", "deflate",
                                "read_filter"])
    log(f"build: {json.dumps({k: round(v, 3) for k, v in build_s.items()})} "
        f"wall {time.perf_counter() - t0:.3f}s")

    work = os.path.join(HERE, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    src, dst = os.path.join(work, "in.bam"), os.path.join(work, "sorted.bam")
    n = args.records
    t0 = time.perf_counter()
    g = synthesize(n, args.seed)
    info = write_bam(src, g, n)
    log(f"synth: {n} reads, {info['decoded_bytes']} decoded bytes, "
        f"{info['blocks']} BGZF blocks, {info['file_bytes']} file bytes, "
        f"{time.perf_counter() - t0:.1f}s")

    # -- the main path ------------------------------------------------------
    tracing.reset_telemetry()
    counters.reset()
    B1.last_stats.update(device_lanes=0, host_big=0, host_fallback=0)
    storage = port.ReadsStorage.make_default().split_size(args.split_size)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ds = storage.read(src)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    hbm = {"hbm_bytes_peak": (tracing.REGISTRY.gauge(
               "device.hbm_bytes").state() or {}).get("max", 0),
           "hbm_bytes_after_read": tracing.hbm_live_bytes(),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    spans = {"bam_read": span_sums(tracing)}
    count = ds.count()
    fstat = ds.flagstat()
    tracing.reset_spans()
    t1 = time.perf_counter()
    storage.write(ds, dst, port.BaiWriteOption.ENABLE, sort=True)
    write_s = time.perf_counter() - t1
    spans["sort_write"] = span_sums(tracing)
    main = counters.snapshot()
    stats = dict(B1.last_stats)
    n_splits = -(-info["file_bytes"] // args.split_size)
    log(f"main path: read {read_s:.3f}s ({n / read_s:.0f} rec/s, "
        f"{info['decoded_bytes'] / read_s / 1e6:.1f} MB/s decoded), "
        f"sort+write {write_s:.3f}s ({n / write_s:.0f} rec/s), "
        f"{n_splits} splits, counters {json.dumps(main)}, "
        f"inflate stats {json.dumps(stats)}")

    # -- results against the generator -------------------------------------
    check(type(ds.reads).__name__ == "ColumnarBatch" and ds.reads.device_backed,
          "the read did not stay on the device")
    check(count == n, f"count {count} != {n}")
    check(fstat == numpy_flagstat(g["flag"]), f"flagstat {fstat}")
    perm_want = np.argsort(coordinate_keys(g["refid"], g["pos"]), kind="stable")
    perm = ds.reads.sort_permutation()
    check(np.array_equal(perm, perm_want), "sort permutation differs")
    launches = main["launches"]
    check(launches.get("inflate", 0) > 0, "inflate kernel never launched")
    check(launches.get("parse", 0) > 0, "parse kernel never launched")
    check(stats["host_big"] == 0 and stats["host_fallback"] == 0,
          f"host blocks on the main path: {stats}")
    check(stats["device_lanes"] >= info["blocks"],
          "not every block was inflated (and CRC-checked) on the device")
    check(sum(main["host_fallback_blocks"].values()) == 0, "host fallback")

    out_data = open(dst, "rb").read()
    decoded = zlib_check_all(out_data)
    want = (info["decoded_bytes"] - len(bam_header())
            + len(bam_header("coordinate")))
    check(decoded == want, f"sorted BAM decodes to {decoded} bytes, want {want}")
    bai = open(dst + ".bai", "rb").read()
    check(bai[:4] == b"BAI\x01" and struct.unpack_from("<i", bai, 4)[0] == len(REFS),
          "BAI header")
    back = storage.read(dst)
    check(back.header.sort_order == "coordinate", "sorted header")
    check(back.count() == n, "re-read count")
    rb = back.reads.to_read_batch()
    for col in ("refid", "pos", "mapq", "bin", "flag", "next_refid",
                "next_pos", "tlen"):
        check(np.array_equal(getattr(back.reads, col), g[col][perm_want]),
              f"re-read column {col}")
        check(np.array_equal(getattr(rb, col), g[col][perm_want]),
              f"re-read host column {col}")
    check(np.array_equal(rb.names.reshape(n, NAME_LEN), g["names"][perm_want]),
          "names")
    ncig = g["ncig"][perm_want]
    cig_want = g["cig"][perm_want][np.arange(3)[None, :] < ncig[:, None]]
    check(np.array_equal(rb.cigars, cig_want), "cigars")
    check(np.array_equal(rb.seqs.reshape(n, READ_LEN), g["seq"][perm_want]), "seqs")
    check(np.array_equal(rb.quals.reshape(n, READ_LEN), g["qual"][perm_want]),
          "quals")
    check(np.array_equal(rb.tags.reshape(n, TAG_BYTES), g["tags"][perm_want]),
          "tags")
    del rb, back
    log("results: count, flagstat, sort permutation, sorted BAM + BAI: ok")

    # -- kernels against their plain versions ------------------------------
    data = open(src, "rb").read()
    blocks = walk_blocks(data)[:-1]  # drop the EOF block
    # the whole file in one launch: the blob for B2, checked against zlib
    ins, total, _, _ = inflate_inputs(torch, data, blocks, dev)
    blob, out_len, status = B1.inflate(*ins, total)
    torch.cuda.synchronize()
    check(int(status.abs().max()) == 0, "whole-file inflate flagged a block")
    host_blob = blob.cpu().numpy()
    with ThreadPoolExecutor(8) as pool:
        zl = b"".join(pool.map(
            lambda b: zlib.decompress(data[b[0] + b[2]: b[0] + b[1] - 8], -15),
            blocks))
    check(host_blob.tobytes() == zl, "whole-file inflate differs from zlib")
    del zl

    # B1 sample: status cases, the new design's edge cases, well-formed
    # cases, and file blocks
    rng = np.random.default_rng(args.seed + 1)
    cases = [(p, u) for _, p, u, _ in inflate_cases.status_cases()]
    edge = inflate_cases.edge_cases()
    cases += [(p, u) for _, p, u, _ in edge]
    cases += [(p, len(d)) for _, p, d in inflate_cases.good_cases(args.seed)]
    for i in rng.choice(len(blocks), 10, replace=False):
        p, t, h = blocks[i]
        cases.append((data[p + h: p + t - 8],
                       struct.unpack_from("<I", data, p + t - 4)[0]))
    for level in (1, 9, 0):
        raw = host_blob[1_000_000 + level * MAX_PAYLOAD:][:MAX_PAYLOAD].tobytes()
        c = zlib.compressobj(level, zlib.DEFLATED, -15, 8)
        cases.append((c.compress(raw) + c.flush(), len(raw)))
    sample = b"".join(p for p, _ in cases)
    s_blocks, at = [], 0
    for p, u in cases:
        s_blocks.append((at, len(p), 0, u))
        at += len(p)
    s_args = (torch.frombuffer(bytearray(sample), dtype=torch.uint8).to(dev),
              *(torch.tensor(v, dtype=torch.int64, device=dev) for v in (
                  [b[0] for b in s_blocks], [b[1] for b in s_blocks],
                  np.concatenate([[0], np.cumsum([b[3] for b in s_blocks])]).tolist())))
    s_total = sum(b[3] for b in s_blocks)
    k_out, k_len, k_st = B1.inflate(*s_args, s_total)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_out, p_len, p_st = B1.inflate_plain(*s_args, s_total)
    b1_s_plain_ms = (time.perf_counter() - t0) * 1e3
    b1_sample_ms = cuda_ms(torch, lambda: B1.inflate(*s_args, s_total), 1, 3)
    # every payload's written bytes, flagged payloads' included: the
    # kernel leaves the rest of a flagged block's row unwritten
    oo = s_args[3].cpu().numpy()
    written = np.minimum(k_len.cpu().numpy(), p_len.cpu().numpy())
    within = np.arange(s_total) - np.repeat(oo[:-1], np.diff(oo))
    byte_mask = torch.from_numpy(
        within < np.repeat(written, np.diff(oo))).to(dev)
    b1_s_err = max(
        int((k_out.int() - p_out.int()).abs()[byte_mask].max()) if byte_mask.any() else 0,
        int((k_st - p_st).abs().max()), int((k_len - p_len).abs().max()))
    b1_s_mism = int((k_st != p_st).sum() + (k_len != p_len).sum()
                    + (k_out != p_out)[byte_mask].sum())
    codes = sorted(set(p_st.tolist()))
    check(b1_s_err == 0 and b1_s_mism == 0, "inflate kernel != plain version")
    check(set(range(9)) <= set(codes), f"status codes covered: {codes}")
    e_st = k_st.cpu().numpy()[len(inflate_cases.status_cases()):][:len(edge)]
    check(e_st.tolist() == [w for _, _, _, w in edge],
          f"inflate edge cases: statuses {e_st.tolist()}")

    # B1 at the main path's shape: the first split's blocks, held against
    # its plain version on the same payloads
    first = [b for b in blocks if b[0] < args.split_size]
    lo, hi = first[0][0], first[-1][0] + first[-1][1]
    shifted = [(p - lo, t, h) for p, t, h in first]
    m_ins, m_total, m_in, m_out = inflate_inputs(
        torch, data[lo:hi], shifted, dev)
    k_blob, k_len, k_st = (t.cpu().numpy() for t in B1.inflate(*m_ins, m_total))
    (p_blob, p_len, p_st), b1_plain_ms, procs = plain_on_payloads(
        "inflate", [data[p + h: p + t - 8] for p, t, h in first],
        [struct.unpack_from("<I", data, p + t - 4)[0] for p, t, _ in first])
    check(len(p_blob) == len(k_blob), "B1 plain blob size on split 0")
    b1_err = max(int(np.abs(k_blob.astype(np.int16) - p_blob).max()),
                 int(np.abs(k_len - p_len).max()),
                 int(np.abs(k_st - p_st).max()))
    b1_mismatch = int((k_blob != p_blob).sum() + (k_len != p_len).sum()
                      + (k_st != p_st).sum())
    check(b1_err == 0 and b1_mismatch == 0,
          f"inflate kernel != plain version on split 0 ({b1_mismatch})")
    del k_blob, p_blob
    b1_ms = cuda_ms(torch, lambda: B1.inflate(*m_ins, m_total), 1, 5)
    b1_dev_ms = graph_ms(torch, lambda: B1.inflate(*m_ins, m_total), 3, 2)
    b1_geom = cuda_build.geometry("inflate", len(first))
    # one payload alone: the latency of one warp's decode
    one = (m_ins[0], m_ins[1][:1].contiguous(), m_ins[2][:1].contiguous(),
           m_ins[3][:2].contiguous())
    one_out = int(m_ins[3][1])
    b1_one_ms = cuda_ms(torch, lambda: B1.inflate(*one, one_out), 2, 10)
    b1_bytes = m_in + m_out + 8 * (3 * len(first) + 1) + 8 * len(first)
    log(f"inflate: sample of {len(cases)} payloads, codes {codes}, kernel "
        f"{b1_sample_ms:.3f} ms vs plain {b1_s_plain_ms:.1f} ms; split 0: "
        f"{len(first)} blocks {m_in} -> {m_out} bytes in {b1_ms:.3f} ms vs "
        f"plain {b1_plain_ms:.1f} ms ({procs} processes), 0 mismatches; "
        f"geometry {json.dumps(b1_geom)}; one payload ({one_out} bytes) "
        f"{b1_one_ms:.4f} ms")

    # B2 on every record of the file
    header_len = len(bam_header())
    from disq_tpu_torch.bam.codec import scan_record_offsets

    offs = scan_record_offsets(host_blob[header_len:]) + header_len
    check(len(offs) - 1 == n, "record scan of the whole file")
    starts = torch.from_numpy(offs[:-1].copy()).to(dev)
    k_cols = B2.parse_records(blob, starts)
    p_cols = B2.parse_records_plain(blob, starts)
    torch.cuda.synchronize()
    b2_err = int((k_cols.long() - p_cols.long()).abs().max())
    b2_mismatch = int((k_cols != p_cols).any(0).sum())
    check(b2_err == 0 and b2_mismatch == 0, "parse kernel != plain version")
    k = dict(zip(B2._FIELD_ORDER, k_cols.cpu().numpy()))
    for col in ("refid", "pos", "mapq", "bin", "flag", "next_refid",
                "next_pos", "tlen"):
        check(np.array_equal(k[col].astype(g[col].dtype), g[col]),
              f"parse column {col} vs generator")
    # the edge cases (ops/parse.py::edge_starts), each in a blob that is a
    # view at an odd byte offset of the file's blob: every residue mod 16,
    # prefixes ending at, within 40 bytes of and past the blob's end
    b2_sample = b2_s_mism = 0
    for view in (0, 1, 2, 3, 5, 13):
        e_blob = blob[view: view + 100_003]
        e_starts = torch.from_numpy(B2.edge_starts(e_blob.numel())).to(dev)
        e_k = B2.parse_records(e_blob, e_starts)
        e_p = B2.parse_records_plain(e_blob, e_starts)
        b2_s_mism += int((e_k != e_p).any(0).sum())
        b2_sample += e_starts.numel()
    check(b2_s_mism == 0, f"parse kernel != plain version on {b2_s_mism} "
          f"of {b2_sample} edge-case records")
    # main-path shape: one split's records. The device-only time (a CUDA
    # graph of 20 launches replayed between events) and the time through
    # the wrapper (20 Python calls between events), which counts the
    # host's issue cost
    per = -(-n // n_splits)
    s_starts = starts[:per].contiguous()
    b2_call = lambda: B2.parse_records(blob, s_starts)  # noqa: E731
    b2_wrapper_ms = cuda_ms(torch, b2_call, 3, 20)
    b2_ms = graph_ms(torch, b2_call)
    b2_plain_ms = cuda_ms(torch, lambda: B2.parse_records_plain(blob, s_starts), 1, 3)
    b2_bytes = per * (8 + 36 + 12 * 4)
    b2_geom = cuda_build.geometry("parse", per)
    log(f"parse: all {n} records exact, {b2_sample} edge-case records exact; "
        f"{per} records: kernel {b2_ms:.4f} ms on the device alone, "
        f"{b2_wrapper_ms:.4f} ms through the wrapper, plain "
        f"{b2_plain_ms:.3f} ms; geometry {json.dumps(b2_geom)}")

    kernels = [
        {"name": "inflate", "route": "cuda",
         "source": "disq_tpu_torch/csrc/inflate.cu",
         "replaces": "disq_tpu/ops/inflate_simd.py:325",
         "launches": launches.get("inflate", 0), "max_abs_err": b1_err,
         "ms": round(b1_ms, 4), "plain_ms": round(b1_plain_ms, 4),
         "ms_device": round(b1_dev_ms, 4),
         "bound_ms": round(b1_bytes / HBM_BYTES_PER_S * 1e3, 6),
         "bound_by": "bytes", "library_ms": None,
         "mismatches": b1_mismatch, "tolerance": 0,
         "shape": {"blocks": len(first), "bytes_in": m_in, "bytes_out": m_out},
         "plain_on": f"the same inputs (split 0's payloads), host, "
                     f"{procs} processes",
         "sample": f"{len(cases)} payloads", "sample_mismatches": b1_s_mism,
         "ms_on_sample": round(b1_sample_ms, 4),
         "plain_ms_on_sample": round(b1_s_plain_ms, 4),
         "geometry": b1_geom,
         "single_payload": {"bytes_out": one_out, "ms": round(b1_one_ms, 4),
                            "ns_per_byte": round(b1_one_ms * 1e6 / one_out, 3)}},
        {"name": "parse", "route": "cuda",
         "source": "disq_tpu_torch/csrc/parse.cu",
         "replaces": "disq_tpu/ops/parse.py:70",
         "launches": launches.get("parse", 0), "max_abs_err": b2_err,
         "ms": round(b2_ms, 4), "plain_ms": round(b2_plain_ms, 4),
         "bound_ms": round(b2_bytes / HBM_BYTES_PER_S * 1e3, 6),
         "bound_by": "bytes", "library_ms": None,
         "mismatches": b2_mismatch, "tolerance": 0, "shape": {"records": per},
         "plain_on": "the same inputs",
         "ms_device": round(b2_ms, 4),
         "ms_through_wrapper": round(b2_wrapper_ms, 4),
         "sample": f"{b2_sample} edge-case records in 6 blob views",
         "sample_mismatches": b2_s_mism, "geometry": b2_geom},
    ]
    b4_entry, legs_e2e = bam_legs(torch, port, args, g, info, ds, src, work,
                                  dev, host_blob, stats["device_lanes"])
    del host_blob, blob
    cram_kernels, cram_e2e, head = cram_phases(
        torch, port, args, g, perm_want, ds, storage, work, dev)
    kernels += cram_kernels + [b4_entry]

    # -- the rest of the configured read and write ---------------------------
    t0 = time.perf_counter()
    write_e2e, write_launches = configured_write_legs(
        torch, port, args, g, perm_want, info, ds, work)
    log(f"phase write options: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    resume_e2e, resumed = read_resume_legs(torch, port, args, g, info, ds,
                                           src, work, head)
    head = {k: head[k] for k in ("path", "offsets", "records", "counters")}
    log(f"phase read resume: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    ops_e2e = device_op_legs(torch, g, perm_want, ds)
    log(f"phase device ops: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    write_kernels, dw_e2e = device_write_legs(torch, port, args, g, perm_want,
                                              ds, work, dev)
    kernels += write_kernels
    log(f"phase device write: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    service, svc_e2e = service_legs(torch, port, args, g, perm_want, info,
                                    ds, src, work, dev, head)
    log(f"phase device service: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    traced = trace_leg(torch, port, args, src, work)
    log(f"phase trace: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    f1_entry, operators_e2e = operator_legs(torch, port, args, work, dev)
    kernels.append(f1_entry)
    log(f"phase operators: {time.perf_counter() - t0:.3f}s")
    spans["cram_read"] = cram_e2e.pop("spans")
    log(f"spans: {json.dumps(spans)}")
    log(f"hbm: {json.dumps(hbm)}")
    by_name = {k["name"]: k for k in kernels}
    for name, entry in service.items():
        by_name[name]["service"] = entry
    by_name["inflate"]["launches_on_resumed_read"] = resumed["inflate"]
    by_name["parse"]["launches_on_resumed_read"] = resumed["parse"]
    by_name["parse"]["spill_rebuilds_on_resumed_read"] = \
        resumed["parse_rebuilds"]
    by_name["rans_simd"]["launches_on_resumed_cram_read"] = \
        resumed["rans_simd"]
    by_name["rans_simd"]["launches_on_cram_part_reads"] = \
        write_launches["multi_cram_reads"].get("rans_simd", 0)
    e2e = {"records": n, "decoded_bytes": info["decoded_bytes"],
           "read_s": round(read_s, 4), "sort_write_s": round(write_s, 4),
           "read_records_per_s": round(n / read_s, 1),
           "sort_write_records_per_s": round(n / write_s, 1),
           "splits": n_splits, **legs_e2e, **cram_e2e, **write_e2e,
           **resume_e2e, **ops_e2e, **dw_e2e, **svc_e2e, **operators_e2e,
           "traced_read": traced, **hbm,
           "build_s": {k: round(v, 3) for k, v in build_s.items()}}
    log(f"e2e: {json.dumps(e2e)}")
    shutil.rmtree(work, ignore_errors=True)
    return {"card": card, "kernels": kernels,
            "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                       "count": torch.cuda.device_count()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--records", type=int, default=2_000_000)
    ap.add_argument("--split-size", type=int, default=64 << 20)
    args = ap.parse_args(argv)
    try:
        res = run(args)
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(res["card"])
    print(json.dumps({"kernels": res["kernels"]}))
    print(json.dumps({"ok": True, "device": res["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
