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
    storage.write(sorted_head, out_cram, CraiWriteOption.ENABLE)  # CRAM_CUT
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
    tp = TraversalParameters([Interval("chr1", 50_000_001, 200_000_000),
                              ...], traverse_unplaced_unmapped=True)
    storage.read(sorted_bam, traversal=tp)                         # BAI
    storage.read_filter("-F 0x904 -q 20").read(sorted_bam, traversal=tp)
    storage.read(sorted_cram, traversal=tp_cram)                   # CRAI
    storage.read("http://127.0.0.1:<port>/sorted.bam"[, traversal=tp])
    vst = VariantsStorage.make_default().split_size(8 << 20)
    vst.write(vds, "v.vcf.bgz", TabixIndexWriteOption.ENABLE)     # VCF
    vst.read("v.vcf.bgz"); vst.executor_workers(4).read(...)       # B1
    # DISQ_TPU_TORCH_DEVICE_INFLATE=legacy: the same read through B4
    vst.error_policy("skip").read(flipped)
    vst.read("v.vcf.bgz", intervals=[Interval(...), ...])          # TBI
    vst.device_deflate().write(vds, out, TabixIndexWriteOption.ENABLE)
    bst.write(head_100k, "v.bcf"); bst.device_deflate().write(...) # BCF
    bst.read("v.bcf")
    storage.write(sorted_head_200k, "head.sam"); storage.read(...)  # SAM
    storage.executor_workers(4).hedged_fetches(0.9, 0.75)          # planes
        .read("fault://" + path)               # a seeded slow split 3
    storage.error_policy("skip").shard_deadline(3.5).read(...)     # stall 4
    storage.circuit_breaker(3, 30).retry_budget(8).postmortem_dir(d)
        .read("fault://" + path)               # every range read fails
    storage.executor_workers(4).introspect_port(0).watchdog(30)
        .progress_log(p).profile_hz(99).read(path)   # /healthz, /progress
    vst.introspect_port(0).read("v.vcf.bgz")
    storage.num_shards(8).writer_workers(4).circuit_breaker(3, 30)
        .write(ds, out, BaiWriteOption.ENABLE, sort=True)
    storage.scheduler("serve", lease_n=2).read(path)               # sched
    # a second process on the card joins (DISQ_TPU_TORCH_SCHED=host:port);
    # a victim process is killed holding a lease, the survivor reads on
    storage.read_ledger(d).scheduler(addr, lease_s=2, steal=False)
        .read("fault://" + path)
    storage.num_shards(8).writer_workers(4).scheduler("serve").write(
        ds, out, BaiWriteOption.ENABLE, SbiWriteOption.ENABLE,
        StageManifestWriteOption(m), sort=True)
    storage.scheduler("serve").read(head_cram); vst.scheduler("serve")...
    handle = serve({"bam": sorted_bam, "vcf": vcf_bgz}, port=0)   # serve
    # POST /query/reads from 1, 8, 32 closed-loop clients, cold and hot;
    # DISQ_TPU_TORCH_DEVICE_SERVICE=1; legacy; variants, stats, markdup,
    # pileup, filtered-count; then through a router over two replica
    # processes on the card (this script with --serve-replica)
    fleet = serve_fleet([replica1, replica2], datasets={"bam": ...})
    torch_chaos_soak.main(["--iterations", "8", "--records", "5000",
                           "--seed", "23", "--executor-workers", "4",
                           "--writer-workers", "4", "--watchdog",
                           "--hedge", "--breaker",
                           "--resident", "--ops", "--device-write",
                           "--kill", "--serve"])                  # chaos

The CRAM holds the sorted reads before chr1:230,000,000 (``CRAM_CUT``,
a cut of depth) and is written with ``DISQ_TPU_TORCH_CRAM_RANS_O1=0``, so its
quality scores are order-0 rANS streams (one per 10,000-record
container), which the read decodes on the card: kernel B3, and B5 on a
read of the file's first 2 splits under
``DISQ_TPU_TORCH_DEVICE_RANS=legacy``.

It checks each path's results against the generator (counts, flagstat,
sort permutation, the sorted BAM re-read record for record, every output
block inflating with zlib, the CRAM read column for column), the legacy
and the 4-worker reads against the default read, the skip and quarantine
reads of a copy with one flipped bit against the generator's records
outside that block (and the quarantine sidecar against the corrupt
bytes), the 4-worker write against the 1-worker write byte for byte,
the same for CRAM on the file's first 2 splits (the 4-worker read against
the default one; the strict, skip and quarantine reads of a copy with one
byte flipped in a container of split 1, the sidecar against that
container's bytes), every
CRAM read's ``ds.counters`` against the file's containers; then the
rest of the configured read and write: the 8-shard BAM + BAI with the
SBI byte-identical to the write without it, every SBI offset on a record
start found by a host walk of the output, and the re-read planned by the
SBI alone; the directory of 8 BAMs (the first 500,000 reads) and of 4
CRAMs (the first 50,000 sorted records: cuts of depth), each part
re-read equal to its slice; a manifest-resumed write of the first
500,000 sorted records (shard 3 fails in a wrapper of the sink's
per-shard step; the resume runs shards 3-7 and writes the uninterrupted
write's BAM, BAI and SBI byte for byte); ledger-resumed BAM and CRAM
reads (split 4 of the BAM and split 1 of the CRAM head copy fail their
fetch through the fault-injecting filesystem; the resume launches B1 for
the unfinished splits only, B2 once more for each spilled split, B3
once, and its records and counters equal the uninterrupted read's);
depth against a numpy difference array of the generator; filter and
permuted device-backed and equal to the host batch's; device_columns
with no transfer; the device write path (records gathered by W1 and
literal-Huffman coded by W2) of the main path's first 500,000 reads (a
cut of depth) at one shard and at 8 shards with 4 writer workers, each
output inflating with zlib to the zlib-6 write's stream of those reads,
its BAI and SBI mapping (virtual offset to uncompressed offset) to the
zlib-6 write's, its re-read equal to the generator, W1 and W2 held against their plain versions on the whole shard
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
of the head's first 2 splits equal to the generator, its splits'
order-0 streams sharing B3 launches (fewer launches than splits, under a
5 s flush window) and none decoded on the host; the device write of the sorted
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
the read. The operators phase writes ``dups.bam`` (the same generator
at ``OPS_RECORDS`` reads, a seeded 5 % of pairs copying another pair's
refid, pos, CIGAR and flags under their own names and qualities) and
checks the filtered read
against a numpy mask of this script's own (FNV-1a names, the subsample
mix), F1 once per split; F1 against its plain version on every record;
the chain on the device-backed dataset and on a host ``ReadBatch`` copy:
equal stats, duplicates equal to a numpy group oracle over the
generator's columns, per-RG counts and coverage equal to the generator's,
no host record parse on the resident chain, both results written with
zlib-6 byte for byte and their 0x400 count equal to the stats; and
times the markdup scan and the RG reduction (torch ops) alone. The
traversal phase reads ``sorted.bam`` through its BAI (three intervals
across chr1-3, chr1's holding more records than one split, each alone
and together; the unplaced-unmapped tail alone and with them; the same
under ``-F 0x904 -q 20``) and ``sorted.cram`` through its CRAI (one
interval), each equal to a numpy oracle over the generator (refid, pos
and the CIGAR's reference span), with B1 and B2 launched once per BAI
chunk decoded (F1 too under the filter), no block inflated on the host,
and B3 once for the CRAM interval; then the whole ``sorted.bam``, the
interval read and the CRAM interval over ``http://`` from a local
``ThreadingHTTPServer``, equal to the local reads. The variants phase synthesizes a cohort VCF of 1,000,000
coordinate-sorted sites over chr1-3 (4 samples of GT:DP:GQ, INFO DP,
AC, AN and AF, 1 % symbolic deletions with END=), writes it as BGZF with
its TBI and checks every block against zlib and the TBI's chunks against
the lines of each contig; reads it at 8 MiB splits (B1 once per split
and once per neighbor block that completes a straddling line), under
``legacy`` (B4), at 4 executor workers, under ``skip`` on a copy with
one flipped bit (the lines touching that block lost, one block skipped)
and through the TBI for three intervals (B1 once per merged chunk), each
equal to the generator's lines and columns, no block inflated on the
host; writes it with W2 (inflating to the zlib-6 write's stream, its TBI
mapping to the same uncompressed offsets); writes the first 50,000
sites as BCF with zlib-6 and with W2 and reads it back (B1 once per
split) equal to the VCF lines; and writes the first 100,000 sorted reads
of the main path's device-backed dataset as SAM text, reads them back
equal to the generator (names, sequences, qualities, CIGARs, tags with
NM as an int32) and writes and re-reads them as BAM. The planes phase
drives the resilience and observability planes on the main path's BAM:
a 4-worker hedged read whose split 3 fetch draws a seeded slow fault
(at least one hedge launched, every launch booked won, B1 and B2 once
per split, the records equal to the default read); a read whose split 4
stalls past its shard deadline, under ``skip`` (``deadline.exceeded`` 1,
one skipped unit, B1 on the other splits only, the records equal to the
generator's outside split 4) and under ``strict`` (it raises
``DeadlineExceededError`` for split 4); two reads under the breaker, the
retry budget and the flight recorder from a store whose every range read
fails (the first opens the breaker after its window of calls and raises
``BreakerOpenError`` with one postmortem bundle holding the breaker's
transition and the abort, the second fails fast with no store call; no
kernel launches); a 4-worker read with the endpoint, the watchdog, the
progress log and the profiler on (``/healthz`` ok, ``/progress`` with
every split and record, ``/metrics``' kernel-launch delta of B1 and B2
under the reference's series names, ``/debug/profile`` taken during the
read with ``fetch`` and ``decode`` samples and no pipeline frame under
``other``, the log's last line with every record, the records equal to
the default read) and the variants phase's VCF.bgz under the endpoint
(its ``/progress`` holding every line); and the 8-shard sorted write at
4 writer workers with the breaker armed, byte-identical to the unarmed
write. The sched phase drives the shard scheduler on the same inputs: a
read under ``.scheduler("serve")`` alone (every split leased and a
locality miss, B1 = B2 = 6, the columns equal the default read's in its
order); a read while a second process on the card (this script run with
``--sched-worker``) joins the same queue (each split won once, each
side's records equal the default read's records of its splits, B1 and B2
summing to 6); a victim process that leases splits 0 and 1, finishes and
spills split 0 to a shared read ledger, hangs in split 1's fetch (a
fault-store stall) and is killed, then this process's read of the rest
(split 1 after its 2 s lease expired, B1 = 5) joined with split 0 loaded
from the spill (B2 once more) equal to the default read; the 8-shard
sorted write at 4 writer workers leased with a stage manifest,
byte-identical (BAM, BAI, SBI) to the unscheduled write; and the CRAM
head (B3 = 2) and the VCF.bgz (B1 = 7) read scheduled, equal to their
default reads. The serve phase serves the
sorted BAM and the VCF.bgz from a daemon on the card to closed-loop HTTP
clients with the config 13 traffic (64 regions of 20,000 bp, weight
1/rank) at 1, 8 and 32 clients, cold then hot, cold through the device
service at 1 and 32, cold under ``legacy``, and variants, stats,
markdup, pileup and filtered-count queries, then through the fleet
router over two replica processes (cold, hot, one replica stalling 80 ms
per query, then killed): every answer's count and digest equal the
traversal read of its interval and a numpy oracle over the generator,
variants the tabix read, flagstat, depth, pileup and the filtered count
numpy's; B1 once per request that missed the decoded tier (0 hot),
fewer B1 launches than such requests through the service at 32 clients,
B4 under ``legacy``, F1 once per filtered count, no block inflated on
the host, most hot fleet routes by locality, a hedge launched against
the stalling replica, every request answered after the kill; and the
service's most-coalesced launch held against zlib and the plain
version. The mesh phase runs the port's mesh (``runtime/mesh.py``) at 8
shards on the one card (``DISQ_TPU_TORCH_FORCE_DEVICE_COUNT=8``, the
counterpart of XLA's forced device count): (a) a ``.mesh(8)`` read of
the main BAM, its columns equal to the generator's and the unmeshed
read's, B1 once per split and B2 once per shard of each split; (b) its
flagstat through ``psum``, depth and region pileup through
``_depth_psum``, each equal to the unmeshed result; (c) its
``resident_coordinate_sort`` permutation equal to ``torch.sort
(stable=True)`` of the unmeshed keys; (d) the sorted BAM + BAI written
from it byte-identical to the main path's; (e) ``sharded_coordinate_sort``
and ``hierarchical_coordinate_sort`` (2 x 4) on 2,000,000 u64 keys,
uniform and 90 % one key, equal to a stable sort; (f) markdup on
``dups.bam`` through the mesh equal to it off the mesh; (g)
``global_mesh()`` of shape (1, 8) with ``psum`` over both axes. The
cross-process ``dcn`` leg needs two cards, and this phase says so.
The chaos phase imports ``scripts/torch_chaos_soak.py`` and runs it in
this process on the card (``chaos_legs``): 8 seeded fault schedules
(transient, truncated, stalled and slow range reads, and in 4 policy
iterations one flipped bit in a random BGZF block) over a 5,000-record
BAM at 4 executor and 4 writer workers with the watchdog and hedged
fetches, each read through B1 and B2 on every split: strict raises
``CorruptBlockError`` at the flipped block, skip and quarantine lose
that block alone (at most 20 records), recover equals the host route's
read, B2's columns equal the host parse, every write-back equals a host
zlib-6 write byte for byte, the watchdog flags the injected write
stall, and every hedge launched is booked won; then the breaker, the
resident read, the operator chain (F1), the device write (W1, W2), the
crash-resume with its postmortem bundle, and the serving storm (B1 and
F1), each against the host route on the CPU. It checks that all four
policies were drawn and that B1, B2, F1, W1 and W2 launched in this
process.
Any failed phase exits non-zero.
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
# cuts of depth of the write options phase: the directory of BAM parts
# holds the main path's first reads, the CRAM parts and the
# manifest-resumed write the first sorted ones
MULTI_RECORDS = 500_000
CRAM_PARTS_RECORDS = 50_000
RESUME_RECORDS = 500_000
# the device write phase's cut of depth: its two writes hold the main
# path's first reads, each held against zlib-6 writes of the same reads
DEVICE_WRITE_RECORDS = 500_000


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
    B3 (and its ``HEAD_SPLITS``-split head through B5 under the legacy
    knob), and hold both kernels against their plain versions and B3
    against the native decoder; returns (kernel entries, e2e fields, the
    head copy of ``cram_policy_legs``)."""
    from disq_tpu_torch.native import rans_decode_native
    from disq_tpu_torch.ops import cuda_build
    from disq_tpu_torch.ops import rans as B5
    from disq_tpu_torch.ops import rans_simd as B3
    from disq_tpu_torch.runtime import counters, tracing

    cram = os.path.join(work, "sorted.cram")
    # quality scores as order-0 rANS: the streams the device decodes
    os.environ["DISQ_TPU_TORCH_CRAM_RANS_O1"] = "0"
    # a cut of depth: the sorted reads before CRAM_CUT, which hold the
    # head's splits, CRAM_INTERVAL and the service's splits
    cut_refid = [name for name, _ in REFS].index(CRAM_CUT[0])
    n = int(np.sum((g["refid"] >= 0) & ((g["refid"] < cut_refid) | (
        (g["refid"] == cut_refid) & (g["pos"] < CRAM_CUT[1])))))
    perm_want = perm_want[:n]
    last = g["refid"][perm_want] == cut_refid
    check(g["refid"][perm_want].min() >= 0
          and g["refid"][perm_want].max() == cut_refid
          and g["pos"][perm_want][last].max() < CRAM_CUT[1],
          "the CRAM cut is not a prefix of the sorted reads")
    sorted_ds = ds.coordinate_sorted()
    cut_ds = port.ReadsDataset(header=sorted_ds.header,
                               reads=sorted_ds.reads.slice(0, n))
    del sorted_ds
    t0 = time.perf_counter()
    storage.write(cut_ds, cram, port.CraiWriteOption.ENABLE)
    cram_write_s = time.perf_counter() - t0
    del cut_ds
    offsets = crai_container_offsets(cram + ".crai")
    file_bytes = os.path.getsize(cram)
    splits_with_streams = len({off // args.split_size for off in offsets})
    log(f"cram write: {n} sorted records (before {CRAM_CUT[0]}:"
        f"{CRAM_CUT[1]}), {cram_write_s:.3f}s ({n / cram_write_s:.0f} "
        f"rec/s), {len(offsets)} containers, {file_bytes} file bytes, "
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
    check(fstat == numpy_flagstat(g["flag"][perm_want]),
          f"cram flagstat {fstat}")
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

    policy_e2e, head = cram_policy_legs(torch, port, args, g, perm_want, cram,
                                        data, offsets, fields, cr.reads)
    del cr, rb, data
    os.environ.pop("DISQ_TPU_TORCH_CRAM_RANS_O1")

    # -- the CRAM head read under the legacy knob (B5) ------------------------
    head_streams = len({off // args.split_size for off in head["offsets"]})
    os.environ["DISQ_TPU_TORCH_DEVICE_RANS"] = "legacy"
    try:
        counters.reset()
        B5.last_stats.update(device_lanes=0, host_big=0, host_fallback=0)
        t0 = time.perf_counter()
        cr5 = storage.read(head["path"])
        torch.cuda.synchronize()
        legacy_read_s = time.perf_counter() - t0
        legacy = counters.snapshot()
    finally:
        del os.environ["DISQ_TPU_TORCH_DEVICE_RANS"]
    l_launches = legacy["launches"]
    log(f"cram read (legacy, the {HEAD_SPLITS}-split head): "
        f"{legacy_read_s:.3f}s, counters {json.dumps(legacy)}, rans stats "
        f"{json.dumps(B5.last_stats)}")
    check(l_launches.get("rans", 0) == head_streams
          and l_launches.get("rans_simd", 0) == 0,
          f"legacy read launches {l_launches}")
    check(legacy["host_rans_streams"].get("rans0", 0) == 0,
          "an order-0 stream reached the host decoder (legacy)")
    head_equal(cr5.reads, head["reads"], head["records"], "legacy cram read")
    got_c = {k: getattr(cr5.counters, k) for k in CRAM_COUNTER_KEYS}
    check(got_c == {k: head["counters"][k] for k in CRAM_COUNTER_KEYS},
          f"legacy cram read counters {got_c} != {head['counters']}")
    del cr5

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
    e2e = {"cram_records": n, "cram_write_s": round(cram_write_s, 4),
           "cram_write_records_per_s": round(n / cram_write_s, 1),
           "cram_read_s": round(cram_read_s, 4),
           "cram_read_records_per_s": round(n / cram_read_s, 1),
           "cram_head_legacy_read_s": round(legacy_read_s, 4), **policy_e2e,
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
    the middle container of the head's last split (``HEAD_SPLITS - 1``;
    one with a successor, so its bytes end where the next container
    starts). Returns (container index, its offset, its end, the flipped
    bytes, the copy's path, the mask of the sorted records outside that
    container)."""
    last = HEAD_SPLITS - 1
    in_split = [k for k, off in enumerate(offsets[:-1])
                if last * split <= off < (last + 1) * split]
    check(len(in_split) > 0, f"no container of split {last} has a successor")
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
CRAM_COUNTER_KEYS = ("records", "blocks", "bytes_compressed",
                     "bytes_uncompressed", "skipped_blocks",
                     "quarantined_blocks", "retried_reads", "shards")
HEAD_SPLITS = 2  # the CRAM head's depth: a cut of the file's splits
# the CRAM's depth: the sorted reads before this position, which fill
# the head's 2 splits (the second one in part), CRAM_INTERVAL and the
# service's splits (a cut of the 2,000,000 sorted reads' CRAM: its write
# took ~100 s, and each of its ~8 reads 16-35 s)
CRAM_CUT = ("chr1", 230_000_000)


def cram_head_copy(path: str, offsets, split: int, splits: int):
    """A copy of the CRAM at ``path`` cut to the containers that start in
    its first ``splits`` splits, then the EOF container: (its path, its
    records, its container offsets, its split count)."""
    with open(path, "rb") as f:
        data = f.read()
    cut = sum(1 for off in offsets if off < splits * split)
    records = sum(container_fields(data, off)[1] for off in offsets[:cut])
    if cut < len(offsets):
        data = data[: offsets[cut]] + data[-CRAM_EOF:]
    out = os.path.splitext(path)[0] + f"_{splits}.cram"
    with open(out, "wb") as f:
        f.write(data)
    return out, records, offsets[:cut], -(-len(data) // split)


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
    """The CRAM read with the knobs users set, on the file's first
    ``HEAD_SPLITS`` splits (the containers that start there, then the EOF
    container: a cut of depth): the shard executor at 4 workers against
    the default read ``default`` of the whole file, and strict, skip and
    quarantine on a copy with one byte flipped mid-payload in a container
    of the head's last split. Returns the e2e fields and the head copy
    (path, container offsets, records, the 4-worker read's batch and
    counters)."""
    from disq_tpu_torch.runtime import counters
    from disq_tpu_torch.runtime.errors import CorruptBlockError

    split = args.split_size
    cut = sum(1 for off in offsets if off < HEAD_SPLITS * split)
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
    mb = min(MULTI_RECORDS, n)
    bounds = np.linspace(0, mb, WRITE_SHARDS + 1).astype(np.int64)
    multi_head = port.ReadsDataset(ds.header, ds.reads.slice(0, mb))
    t0 = time.perf_counter()
    bam_dir = os.path.join(work, "parts_bam")
    (storage().num_shards(WRITE_SHARDS).writer_workers(4)
     .write(multi_head, bam_dir, port.FileCardinalityWriteOption.MULTIPLE,
            port.ReadsFormatWriteOption.BAM))
    multi_s = time.perf_counter() - t0
    del multi_head
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

    m = min(CRAM_PARTS_RECORDS, n)
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
    log(f"multi write: BAM {WRITE_SHARDS} parts of the first {mb} "
        f"records {multi_s:.3f}s, each "
        f"re-read equal to its slice and every block inflating with zlib "
        f"({multi_read_s:.3f}s); CRAM 4 parts of the first {m} sorted "
        f"records {cram_multi_s:.3f}s, each re-read equal to its slice")
    e2e.update(multi_bam_write_s=round(multi_s, 4),
               multi_cram_write_s=round(cram_multi_s, 4))

    # -- write resume -------------------------------------------------------
    # the first RESUME_RECORDS sorted records, written once uninterrupted
    # with the same options but the manifest
    mr = min(RESUME_RECORDS, n)
    resume_head = port.ReadsDataset(sorted_ds.header,
                                    sorted_ds.reads.slice(0, mr))
    uninterrupted = os.path.join(work, "resume_ref.bam")
    storage().num_shards(WRITE_SHARDS).write(
        resume_head, uninterrupted, port.BaiWriteOption.ENABLE,
        port.SbiWriteOption.ENABLE)
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
            storage().num_shards(WRITE_SHARDS).write(resume_head, out, *opts)
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
        storage().num_shards(WRITE_SHARDS).write(resume_head, out, *opts)
        resume_s = time.perf_counter() - t0
    finally:
        BamSink._encode_shard = encode_shard
    check(ran == list(range(3, WRITE_SHARDS)), f"write resume: ran {ran}")
    check(not os.path.exists(manifest) and not os.path.exists(out + ".parts"),
          "write resume: manifest or staging left behind")
    del resume_head
    for ext in ("", ".bai", ".sbi"):
        with open(out + ext, "rb") as a, \
                open(uninterrupted + ext, "rb") as b:
            check(a.read() == b.read(),
                  f"write resume: {ext or '.bam'} differs from the "
                  f"uninterrupted write")
    log(f"write resume: the first {mr} sorted records; shard 3 failed "
        f"after {crash_s:.3f}s (manifest and "
        f"3 staged parts kept); the resume ran shards {ran} in "
        f"{resume_s:.3f}s; BAM, BAI and SBI byte-identical to the "
        f"uninterrupted write")
    e2e.update(write_crash_s=round(crash_s, 4),
               write_resume_s=round(resume_s, 4))
    return e2e, launches


def read_resume_legs(torch, port, args, g, info, ds, src, work, head):
    """The BAM read of the file and the CRAM read of its head copy
    (``HEAD_SPLITS`` splits) with a read ledger, each crashed at one
    split's fetch (the head's last split) by the fault-injecting
    filesystem and run again. Returns the e2e fields and
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

    # -- CRAM: the head copy's last split fails -----------------------------
    last = HEAD_SPLITS - 1
    offs = [o for o in head["offsets"] if last * split <= o < (last + 1) * split]
    check(len(offs) > 1, f"no container of split {last} to fail")
    c = len(offs) // 2
    os.environ["DISQ_TPU_TORCH_CRAM_RANS_O1"] = "0"
    try:
        c_crash_s, c_done, cr, c_resume_s, c_snap = leg(
            head["path"], (offs[c] + offs[c + 1]) // 2,
            os.path.join(work, "ledger_cram"))
    finally:
        os.environ.pop("DISQ_TPU_TORCH_CRAM_RANS_O1")
    check(c_done == list(range(last)),
          f"cram read resume: ledger holds {c_done}")
    check(c_snap["launches"].get("rans_simd", 0) == 1,
          f"cram resumed read launches {c_snap['launches']}")
    got_c = {k: getattr(cr.counters, k) for k in keys}
    check(got_c == {k: head["counters"][k] for k in keys},
          f"cram resumed read counters {got_c} != {head['counters']}")
    head_equal(cr.reads, head["reads"], head["records"], "cram resumed read")
    del cr
    log(f"read resume: CRAM head crashed at split {last} after "
        f"{c_crash_s:.3f}s, "
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
    dataset's first ``DEVICE_WRITE_RECORDS`` reads: (a) the sorted write
    (1 shard, BAI), (b) the same at 8 shards, 4 writer workers, BAI + SBI.
    Each output decompresses to the zlib-6 write's stream of the same
    reads, its BAI (and SBI) map to that write's, and it re-reads to the
    generator's sorted records.
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

    split = args.split_size
    check(all(v == 0 for v in DF.device_stats.values()),
          f"a default write ran device deflate work: {DF.device_stats}")

    def storage():
        return port.ReadsStorage.make_default().split_size(split)

    legs = {"a": (1, 1, os.path.join(work, "sorted.bam"), False),
            "b": (WRITE_SHARDS, 4, os.path.join(work, "sorted_sbi.bam"),
                  True)}
    n = min(DEVICE_WRITE_RECORDS, args.records)
    if n < args.records:
        # the first n reads, still device-backed, and the zlib-6 writes
        # of them that the device writes are held against
        ds = port.ReadsDataset(ds.header, ds.reads.filter(
            np.arange(args.records) < n))
        check(ds.reads.device_backed, "the head is not device-backed")
        perm_want = np.argsort(coordinate_keys(g["refid"][:n], g["pos"][:n]),
                               kind="stable")
        for leg, (shards, workers, _, sbi) in list(legs.items()):
            default_path = os.path.join(work, f"zlib6_{leg}.bam")
            storage().num_shards(shards).writer_workers(workers).write(
                ds, default_path, port.BaiWriteOption.ENABLE,
                *([port.SbiWriteOption.ENABLE] if sbi else []), sort=True)
            legs[leg] = (shards, workers, default_path, sbi)
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
        log(f"device write ({leg}): the first {n} reads, {shards} shards, "
            f"{workers} writer workers, {seconds[leg]:.3f}s, "
            f"{sizes[leg][0]} bytes against "
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
    e2e = {"device_write_records": n,
           "device_write_s": round(seconds["a"], 4),
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
SERVICE_CRAM_SPLITS = 2          # the service CRAM leg's depth: 2 splits
PLAIN_SAMPLE_LANES = 64          # B1 lanes of a coalesced chunk held
PLAIN_SAMPLE_STREAMS = 4         # against the plain version (B3 streams)


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

        def submit_inflate(service, payloads, usizes, *rest,
                           _orig=svc.submit_inflate, **kw):
            self.submitted += len(payloads)
            return _orig(service, payloads, usizes, *rest, **kw)

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
    decoded on the card; the CRAM read with 4 workers of the first
    ``SERVICE_CRAM_SPLITS`` splits of ``head`` (``cram_policy_legs``'
    3-split copy) against the generator, its splits
    sharing B3 launches under a ``SERVICE_CRAM_FLUSH_MS`` flush window;
    the device write (8 shards, 4 writer workers, BAI + SBI) of the
    sorted host batch through the service's deflate engine against the
    zlib-6 write's stream and the generator. Then, on the most-coalesced
    chunk each engine launched, what the dispatcher fetched for it:
    B1 and B3 against zlib / the native decoder on every lane and all
    three against their plain versions. Returns (per-kernel service
    entries, e2e fields, the call that joins B3's plain sample and
    completes its entry, which the run makes after its last phase)."""
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
            # a service whose flush window lets the splits meet, on the
            # head's first SERVICE_CRAM_SPLITS splits (a cut of depth)
            DS.shutdown_service()
            os.environ[FLUSH_KNOB] = str(SERVICE_CRAM_FLUSH_MS)
            sorted_rb = ds.coordinate_sorted().reads
            cram, m, offs, shards = cram_head_copy(
                head["path"], head["offsets"], split, SERVICE_CRAM_SPLITS)
            n_splits = len({off // split for off in offs})
            counters.reset()
            tracing.reset_gauges()
            f0, r0 = _flushes(tracing), dict(B3.last_stats)
            t0 = time.perf_counter()
            cr = (port.ReadsStorage.make_default().split_size(split)
                  .executor_workers(4).read(cram))
            secs = time.perf_counter() - t0
            snap = counters.snapshot()
            b3 = snap["launches"].get("rans_simd", 0)
            streams = {k: B3.last_stats[k] - r0[k] for k in r0}
            flush = _delta(f0, _flushes(tracing))
            fill = tracing.REGISTRY.gauge("device.lane_fill").state()
            DS.shutdown_service()
            os.environ.pop(FLUSH_KNOB)
            head_equal(cr.reads, sorted_rb, m, "service cram read")
            check(cr.counters.shards == shards,
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
            # B3's plain version on the most-coalesced chunk's smallest
            # streams (the plain version takes one loop turn per 4 output
            # bytes: ~45 s for a 1.5 MB stream), beside the legs below
            _, r_lanes, _, _ = cap.chunk("rans")
            r_pick = sorted(np.argsort([e for _, e, _ in r_lanes],
                                       kind="stable")
                            [:PLAIN_SAMPLE_STREAMS].tolist())
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
        "plain_sample_streams": len(r_sample)}
    del out, streams, r_lanes, c_args

    def b3_against_plain() -> None:
        """The sample's plain decode (one process per stream, ~45 s for
        a 1.5 MB stream) runs beside the next phases; the run joins it
        before it reports."""
        p, b3_plain_ms, _procs = b3_plain()
        b3_err, b3_mism = rans_errors(k, p, 0)
        check(b3_mism == 0, f"service chunk: B3 != plain version "
              f"({b3_mism})")
        entries["rans_simd"].update(
            plain_ms_on_sample=round(b3_plain_ms, 4), mismatches=b3_mism,
            max_abs_err=b3_err)
        log(f"service chunk: B3 against its plain version on "
            f"{len(r_sample)} streams, {b3_plain_ms:.1f} ms, 0 mismatches")

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
    return entries, e2e, b3_against_plain


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
OPS_RECORDS = 1_000_000      # dups.bam's reads: a cut of depth (3 splits)
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

    n = min(args.records, OPS_RECORDS)
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


# -- indexed traversal and remote reads (A11) ----------------------------------

# 1-based closed intervals; chr1's holds more records than one 64 MiB split
TRAVERSAL_INTERVALS = (("chr1", 50_000_001, 200_000_000),
                       ("chr2", 100_000_001, 100_500_000),
                       ("chr3", 150_000_001, 160_000_000))
CRAM_INTERVAL = ("chr1", 100_000_001, 103_000_000)
TRAVERSAL_FILTER = "-F 0x904 -q 20"


def range_server(root: str):
    """A ``ThreadingHTTPServer`` on 127.0.0.1 serving the files of
    ``root`` by name, with HEAD and ``Range`` GETs, on its own thread."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    import threading

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _path(self):
            path = os.path.join(root, os.path.basename(self.path))
            return path if os.path.isfile(path) else None

        def do_HEAD(self):
            path = self._path()
            if path is None:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(os.path.getsize(path)))
            self.send_header("Accept-Ranges", "bytes")
            self.end_headers()

        def do_GET(self):
            path = self._path()
            if path is None:
                self.send_error(404)
                return
            size = os.path.getsize(path)
            lo, hi, status = 0, size - 1, 200
            rng = self.headers.get("Range")
            if rng and rng.startswith("bytes="):
                a, b = rng[len("bytes="):].split("-")
                lo, hi, status = int(a), min(int(b), size - 1), 206
            with open(path, "rb") as f:
                f.seek(lo)
                body = f.read(hi - lo + 1)
            self.send_response(status)
            if status == 206:
                self.send_header("Content-Range", f"bytes {lo}-{hi}/{size}")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def traversal_legs(torch, port, args, g, perm_want, work) -> dict:
    """Indexed reads of the main path's ``sorted.bam`` (BAI) and of the
    CRAM phase's ``sorted.cram`` (CRAI) on the card: (a) each of
    ``TRAVERSAL_INTERVALS`` alone and all three together, the
    unplaced-unmapped traversal alone and with them; (b) the same with
    ``TRAVERSAL_FILTER``; (c) the full read and (a)'s last read over
    ``http://`` from a local server, against the local reads; (d)
    ``CRAM_INTERVAL`` through the CRAI, locally and over ``http://``.
    Each result against a numpy oracle over the generator (refid,
    ``pos < end0``, ``pos + max(ref span, 1) > beg0``); every BAI chunk
    decoded (one ``bam.split.decode`` span each) launches B1 and B2 once
    (and F1 under the filter), and no block inflates on the host; the
    CRAM interval launches B3 once. Returns (launches per leg, e2e)."""
    from disq_tpu_torch.bam.source import read_header
    from disq_tpu_torch.fsw.filesystem import (
        PosixFileSystemWrapper,
        resolve_path,
    )
    from disq_tpu_torch.index.bai import BaiIndex
    from disq_tpu_torch.ops import inflate_simd as B1
    from disq_tpu_torch.ops import rans_simd as B3
    from disq_tpu_torch.runtime import counters, tracing
    from disq_tpu_torch.traversal.bai_query import chunks_for_intervals

    split = args.split_size
    bam = os.path.join(work, "sorted.bam")
    cram = os.path.join(work, "sorted.cram")
    contigs = [name for name, _ in REFS]
    cols = {c: g[c][perm_want] for c in FIXED}
    ends = cols["pos"].astype(np.int64) + np.maximum(
        cigar_extents(g)[0][perm_want], 1)
    header, _ = read_header(PosixFileSystemWrapper(), bam)
    with open(bam + ".bai", "rb") as f:
        bai = BaiIndex.from_bytes(f.read())

    def oracle(ivs, unmapped, spec=False):
        m = np.zeros(len(ends), bool)
        for contig, start, end in ivs:
            m |= ((cols["refid"] == contigs.index(contig))
                  & (cols["pos"] < end) & (ends > start - 1))
        if unmapped:
            m |= cols["refid"] == -1
        if spec:
            m &= ((cols["flag"] & 0x904) == 0) & (cols["mapq"] >= 20)
        return np.nonzero(m)[0]

    def equal_rows(reads, rows, what, skip=()):
        check(reads.count == len(rows),
              f"{what}: {reads.count} records, want {len(rows)}")
        for col in FIXED:
            if col not in skip:
                check(np.array_equal(getattr(reads, col), cols[col][rows]),
                      f"{what}: column {col}")
        rb = getattr(reads, "to_read_batch", lambda: reads)()
        src = perm_want[rows]
        check(np.array_equal(rb.names.reshape(-1, NAME_LEN), g["names"][src]),
              f"{what}: names")
        check(np.array_equal(rb.quals.reshape(-1, READ_LEN), g["qual"][src]),
              f"{what}: quals")

    def params(ivs, unmapped):
        return port.TraversalParameters(
            [port.Interval(*iv) for iv in ivs],
            traverse_unplaced_unmapped=unmapped)

    def timed(st, path, tp):
        counters.reset()
        tracing.reset_spans()
        b1 = dict(B1.last_stats)
        t0 = time.perf_counter()
        got = st.read(path, traversal=tp)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        snap = counters.snapshot()
        host = {k: B1.last_stats[k] - b1[k]
                for k in ("host_big", "host_fallback")}
        decoded = sum(1 for sp in tracing.spans()
                      if sp["name"] == "bam.split.decode")
        return got, secs, snap, host, decoded

    def storage():
        return port.ReadsStorage.make_default().split_size(split)

    launches, e2e = {}, {}

    def bam_leg(name, ivs, unmapped, spec=None, path=bam):
        st = storage().read_filter(spec) if spec else storage()
        tp = params(ivs, unmapped)
        got, secs, snap, host, decoded = timed(st, path, tp)
        chunks = len(chunks_for_intervals(header, bai, tp.intervals)) \
            + int(unmapped)
        la = snap["launches"]
        check(decoded == chunks,
              f"traversal {name}: {decoded} chunk decodes, {chunks} chunks")
        check(la.get("inflate", 0) == la.get("parse", 0) == chunks,
              f"traversal {name}: launches {la} for {chunks} chunks")
        check(la.get("read_filter", 0) == (chunks if spec else 0),
              f"traversal {name}: read_filter launches {la}")
        check(not any(host.values())
              and not sum(snap["host_fallback_blocks"].values()),
              f"traversal {name}: host inflate {host}, "
              f"{snap['host_fallback_blocks']}")
        check(got.count() > 0 and got.reads.device_backed,
              f"traversal {name}: not device-backed")
        equal_rows(got.reads, oracle(ivs, unmapped, bool(spec)),
                   f"traversal {name}")
        launches[name] = {k: la.get(k, 0)
                          for k in ("inflate", "parse", "read_filter")}
        e2e[f"traversal_{name}_s"] = round(secs, 4)
        log(f"traversal {name}: {got.count()} records, {chunks} chunks, "
            f"launches B1 {la.get('inflate', 0)} B2 {la.get('parse', 0)} "
            f"F1 {la.get('read_filter', 0)}, {secs:.4f}s, equal to the "
            f"oracle")
        return got

    # -- (a) BAM interval reads, (b) the filtered one ---------------------------
    for iv in TRAVERSAL_INTERVALS:
        bam_leg(iv[0], [iv], False)
    bam_leg("intervals", TRAVERSAL_INTERVALS, False)
    bam_leg("unmapped", [], True)
    local = bam_leg("intervals_unmapped", TRAVERSAL_INTERVALS, True)
    bam_leg("filtered", TRAVERSAL_INTERVALS, True, spec=TRAVERSAL_FILTER)

    # -- (d) the CRAM interval through the CRAI ---------------------------------
    tp = params([CRAM_INTERVAL], False)
    cr, secs, snap, _, _ = timed(storage(), cram, tp)
    b3 = snap["launches"].get("rans_simd", 0)
    check(b3 == 1, f"cram traversal: B3 launches {snap['launches']}")
    check(not snap["host_rans_streams"].get("rans0", 0),
          "cram traversal: an order-0 stream reached the host decoder")
    # CRAM stores no bin: the reader derives it from the CIGAR
    equal_rows(cr.reads, oracle([CRAM_INTERVAL], False), "cram traversal",
               skip=("bin",))
    launches["cram"] = {"rans_simd": b3}
    e2e["traversal_cram_s"] = round(secs, 4)
    log(f"traversal cram {CRAM_INTERVAL}: {cr.count()} records, B3 launches "
        f"{b3}, {secs:.4f}s, equal to the oracle")

    # -- (c) over http:// from a local server -----------------------------------
    srv = range_server(work)
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}/"
        t0 = time.perf_counter()
        whole = storage().read(bam)
        torch.cuda.synchronize()
        local_s = time.perf_counter() - t0
        fs = resolve_path(base + "sorted.bam")[0]
        counters.reset()
        t0 = time.perf_counter()
        remote = storage().read(base + "sorted.bam")
        torch.cuda.synchronize()
        remote_s = time.perf_counter() - t0
        la = counters.snapshot()["launches"]
        full = {k: getattr(fs.stats, k) for k in (
            "range_requests", "bytes_fetched", "cache_hits", "cache_misses",
            "prefetch_issued", "prefetch_hits")}
        same_reads(torch, remote, whole, "remote read")
        del remote, whole
        tp = params(TRAVERSAL_INTERVALS, True)
        got, iv_s, _, _, _ = timed(storage(), base + "sorted.bam", tp)
        same_reads(torch, got, local, "remote traversal")
        cr_remote = storage().read(base + "sorted.cram",
                                   traversal=params([CRAM_INTERVAL], False))
        for col in FIXED:
            check(np.array_equal(getattr(cr_remote.reads, col),
                                 getattr(cr.reads, col)),
                  f"remote cram traversal: column {col}")
        stats = {k: getattr(fs.stats, k) for k in full}
    finally:
        srv.shutdown()
        srv.server_close()
    launches["remote_read"] = {k: la.get(k, 0) for k in ("inflate", "parse")}
    e2e.update(remote_read_s=round(remote_s, 4),
               remote_local_read_s=round(local_s, 4),
               remote_traversal_s=round(iv_s, 4), remote_cache_full=full,
               remote_cache=stats)
    log(f"remote read (http://, the whole sorted.bam): {remote_s:.4f}s "
        f"(local {local_s:.4f}s), equal to the local read; launches "
        f"{json.dumps(launches['remote_read'])}; cache {json.dumps(full)}")
    log(f"remote traversal (intervals and unmapped): {iv_s:.4f}s, equal to "
        f"the local one; cram interval over http equal; cache after "
        f"{json.dumps(stats)}")
    return launches, e2e


# -- variants and SAM text ----------------------------------------------------

VCF_SITES = 1_000_000        # a cohort VCF slice over chr1-3
VCF_SPLIT = 8 << 20          # the VCF reads' split size
VCF_SAMPLES = 4
SV_FRACTION = 0.01           # symbolic <DEL> alleles with END=
VCF_INTERVALS = (("chr1", 20_000_001, 20_400_000),
                 ("chr2", 100_000_001, 100_300_000),
                 ("chr3", 150_000_001, 150_200_000))
BCF_SITES = 50_000           # the BCF legs' cut: the first sites
BCF_SPLIT = 1 << 20          # small enough for several BCF splits
SAM_RECORDS = 100_000        # the SAM legs' cut: the first sorted reads
AF_TEXT = ("0", "0.125", "0.25", "0.375", "0.5", "0.625", "0.75", "0.875",
           "1")                   # AC/8, as the BCF codec prints a float
GT_TEXT = ("0/0", "0/1", "1/1", "0|1")


def vcf_header_text() -> str:
    return ("##fileformat=VCFv4.3\n"
            + "".join(f"##contig=<ID={c},length={n}>\n" for c, n in REFS)
            + '##ALT=<ID=DEL,Description="Deletion">\n'
            '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="SV type">\n'
            '##INFO=<ID=END,Number=1,Type=Integer,Description="End">\n'
            '##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">\n'
            '##INFO=<ID=AC,Number=A,Type=Integer,Description="Allele count">\n'
            '##INFO=<ID=AN,Number=1,Type=Integer,Description="Allele number">\n'
            '##INFO=<ID=AF,Number=A,Type=Float,Description="Allele freq">\n'
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
            '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">\n'
            '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="GQ">\n'
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + "\t".join(f"S{k + 1}" for k in range(VCF_SAMPLES)) + "\n")


def synthesize_vcf(n: int, seed: int) -> dict:
    """``n`` coordinate-sorted sites over ``REFS`` in proportion to their
    lengths: SNVs with INFO DP, AC, AN and AF, ``SV_FRACTION`` symbolic
    deletions with SVTYPE and END, and ``VCF_SAMPLES`` samples of
    GT:DP:GQ. Returns the header, the body lines' bytes (no newlines)
    with their offsets, and the chrom / pos / end columns (1-based,
    END-aware)."""
    rng = np.random.default_rng(seed)
    ref_len = np.array([ln for _, ln in REFS], np.int64)
    per = (n * ref_len // ref_len.sum()).astype(np.int64)
    per[-1] = n - per[:-1].sum()
    chrom = np.repeat(np.arange(len(REFS)), per).astype(np.int32)
    pos = np.concatenate([np.sort(rng.integers(1, ln - 20_000, c))
                          for c, ln in zip(per, ref_len)])
    sv = rng.random(n) < SV_FRACTION
    end = np.where(sv, pos + rng.integers(50, 10_000, n), pos)
    ref_i = rng.integers(0, 4, n)
    alt_i = (ref_i + rng.integers(1, 4, n)) % 4
    qual = rng.integers(10, 100, n)
    dp = rng.integers(5, 200, n)
    ac = rng.integers(0, 9, n)
    # the fields' text by lookup: sample columns (GT:DP:GQ) and the
    # SNV / deletion ALT and INFO prefix
    table = [f"{GT_TEXT[k // 9801]}:{(k // 99) % 99}:{k % 99}"
             for k in range(4 * 99 * 99)]
    samples = ["\t".join(table[x] for x in row) for row in
               rng.integers(0, len(table), (n, VCF_SAMPLES)).tolist()]
    alt = np.where(sv, "<DEL>", np.array(list("ACGT"))[alt_i]).tolist()
    sv_info = [f"SVTYPE=DEL;END={e};" if s else ""
               for s, e in zip(sv.tolist(), end.tolist())]
    names = [c for c, _ in REFS]
    lines = [
        f"{names[c]}\t{p}\trs{i}\t{'ACGT'[r]}\t{a}\t{q}\tPASS\t{si}DP={d};"
        f"AC={k};AN=8;AF={AF_TEXT[k]}\tGT:DP:GQ\t{smp}"
        for i, c, p, r, a, q, si, d, k, smp in zip(
            range(1, n + 1), chrom.tolist(), pos.tolist(), ref_i.tolist(),
            alt, qual.tolist(), sv_info, dp.tolist(), ac.tolist(), samples)]
    lens = np.fromiter((len(ln) for ln in lines), np.int64, n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return {"header": vcf_header_text(), "chrom": chrom,
            "pos": pos.astype(np.int32), "end": end.astype(np.int32),
            "line_offsets": offsets,
            "lines": np.frombuffer("".join(lines).encode(), np.uint8),
            "contig_names": tuple(names)}


def vcf_body(v: dict) -> bytes:
    """The body text: every line and its newline."""
    return np.insert(v["lines"], v["line_offsets"][1:], ord("\n")).tobytes()


def variants_equal(got, v: dict, rows, what: str) -> None:
    """A ``VariantBatch`` equals the generator's sites ``rows`` (sorted
    indices): chrom, pos, END-aware end and every line's bytes."""
    check(got.count == len(rows), f"{what}: {got.count} sites, want "
          f"{len(rows)}")
    check(got.contig_names == v["contig_names"], f"{what}: contigs")
    for col in ("chrom", "pos", "end"):
        check(np.array_equal(getattr(got, col), v[col][rows]),
              f"{what}: column {col}")
    lens = np.diff(v["line_offsets"])
    check(np.array_equal(np.diff(got.line_offsets), lens[rows]),
          f"{what}: line lengths")
    keep = np.zeros(len(lens), bool)
    keep[rows] = True
    check(np.array_equal(got.lines, v["lines"][np.repeat(keep, lens)]),
          f"{what}: line bytes")


def tbi_parts(raw: bytes):
    """An independent parse of a tabix index: (the VCF preset's header
    fields, contig names, per contig (chunks as an (m, 2) uint64 array,
    the metadata pseudo-bin's four values), the BAI-shaped body)."""
    check(raw[:4] == b"TBI\x01", "TBI magic")
    n_ref, *preset, l_nm = struct.unpack_from("<8i", raw, 4)
    names = tuple(n.decode() for n in raw[36:36 + l_nm].split(b"\0")[:-1])
    p = 36 + l_nm
    body = raw[p:]
    refs = []
    for _ in range(n_ref):
        n_bin = struct.unpack_from("<i", raw, p)[0]
        p += 4
        chunks, meta = [], None
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", raw, p)
            pairs = np.frombuffer(raw, "<u8", 2 * n_chunk, p + 8)
            p += 8 + 16 * n_chunk
            if b == 37450:
                meta = pairs.astype(np.int64)
            else:
                chunks.append(pairs.reshape(-1, 2))
        n_intv = struct.unpack_from("<i", raw, p)[0]
        p += 4 + 8 * n_intv
        refs.append((np.concatenate(chunks) if chunks
                     else np.zeros((0, 2), np.uint64), meta))
    return preset, names, refs, b"BAI\x01" + struct.pack("<i", n_ref) + body


def tbi_check(raw: bytes, v: dict, hdr_len: int, cstart, ustart,
              what: str) -> None:
    """The TBI of a VCF.bgz with one line per generator site: the VCF
    preset, the contig names, and per contig the chunks (every bin's,
    mapped to uncompressed offsets) holding exactly that contig's lines,
    the metadata pseudo-bin spanning its first line's start to its last
    line's end with its line count."""
    preset, names, refs, _ = tbi_parts(raw)
    check(preset == [2, 1, 2, 0, ord("#"), 0], f"{what}: preset {preset}")
    check(names == v["contig_names"], f"{what}: names {names}")
    n = len(v["chrom"])
    starts = hdr_len + v["line_offsets"][:-1] + np.arange(n)
    ends = hdr_len + v["line_offsets"][1:] + np.arange(1, n + 1)
    for r, (chunks, meta) in enumerate(refs):
        beg = uncompressed_offsets(chunks[:, 0], cstart, ustart)
        fin = uncompressed_offsets(chunks[:, 1], cstart, ustart)
        cover = np.zeros(n + 1, np.int64)
        np.add.at(cover, np.searchsorted(starts, beg), 1)
        np.add.at(cover, np.searchsorted(starts, fin), -1)
        covered = np.cumsum(cover)[:-1] > 0
        mine = v["chrom"] == r
        check(np.array_equal(covered, mine),
              f"{what}: contig {r}'s chunks hold {int(covered.sum())} "
              f"lines, {int((covered & ~mine).sum())} of other contigs; "
              f"want {int(mine.sum())}")
        rows = np.nonzero(mine)[0]
        span = uncompressed_offsets(meta[:2], cstart, ustart)
        check(span[0] == starts[rows[0]] and span[1] == ends[rows[-1]]
              and meta[2] == len(rows) and meta[3] == 0,
              f"{what}: contig {r}'s metadata bin {meta.tolist()}")


def b1_split_launches(data: bytes, split: int) -> int:
    """B1 launches of a VCF.bgz split read of ``data``: one for each
    split's own blocks, one more for the neighbor block that completes
    its straddling line (every data block holds a newline; the last
    split's neighbor is the EOF block)."""
    blocks = walk_blocks(data)
    n = 0
    for s in range(0, len(data), split):
        owned = [(p, t) for p, t, _ in blocks if s <= p < s + split]
        if owned:
            n += 1 + (owned[-1][0] + owned[-1][1] < len(data))
    return n


def split_block_launches(data: bytes, split: int) -> int:
    """B1 launches of a BCF split read: one per split owning a block."""
    return len({p // split for p, _, _ in walk_blocks(data)})


def variants_legs(torch, port, args, g, perm_want, ds, work):
    """The variants and SAM text paths on the card. VCF: the generator's
    ``VCF_SITES`` sites written as ``v.vcf.bgz`` with its TBI (zlib-6),
    read at ``VCF_SPLIT`` (B1 once per split and once per neighbor
    extension), under ``legacy`` (B4), at 4 executor workers, under
    ``skip`` on a copy with one flipped bit in a block of split 1, through
    the TBI for ``VCF_INTERVALS`` (B1 once per merged chunk), and written
    again with ``device_deflate`` (W2 once per shard and once for the
    header block). BCF: the first ``BCF_SITES`` sites written with zlib-6
    and with W2, and read at ``BCF_SPLIT`` (B1 once per split). SAM: the
    first ``SAM_RECORDS`` sorted reads of the main path's device-backed
    dataset written as text, read back (a host ``ReadBatch``) and
    written as BAM, re-read on the device. Every result against the
    generators. Returns (launches per leg, e2e)."""
    from disq_tpu_torch import interop
    from disq_tpu_torch.index.tbi import TbiIndex
    from disq_tpu_torch.ops import inflate_simd as B1
    from disq_tpu_torch.runtime import counters
    from disq_tpu_torch.util import resolve_num_shards

    t0 = time.perf_counter()
    v = synthesize_vcf(VCF_SITES, args.seed + 12)
    header = v["header"].encode()
    stream_want = header + vcf_body(v)
    vds = interop.variants_dataset_from_state(v["header"], v)
    synth_s = time.perf_counter() - t0
    names = v["contig_names"]
    launches, e2e, legs = {}, {"vcf_synth_s": round(synth_s, 4)}, {}

    def leg(name, fn, rows=None):
        """Run one leg with the counts set to 0 just before it and read
        just after; book its seconds, launches and records."""
        counters.reset()
        b1 = dict(B1.last_stats)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        snap = counters.snapshot()
        la = {k: c for k, c in snap["launches"].items() if c}
        host = sum(snap["host_fallback_blocks"].values())
        b1_host = {k: B1.last_stats[k] - b1[k]
                   for k in ("host_big", "host_fallback")}
        launches[name] = la
        e2e[f"{name}_s"] = round(secs, 4)
        legs[name] = {"s": round(secs, 4), "launches": la,
                      "records": rows, "host_fallback_blocks": host}
        log(f"variants {name}: {rows} records, {secs:.4f}s, launches "
            f"{json.dumps(la)}, host-inflated blocks {host}")
        return out, la, host, b1_host

    # -- the zlib-6 write with the TBI ----------------------------------------
    vbgz = os.path.join(work, "v.vcf.bgz")
    st = port.VariantsStorage.make_default().split_size(VCF_SPLIT)
    _, la, _, _ = leg("vcf_write", lambda: st.write(
        vds, vbgz, port.TabixIndexWriteOption.ENABLE), VCF_SITES)
    check(not la, f"vcf write: a zlib-6 write launched {la}")
    data = open(vbgz, "rb").read()
    stream, cstart, ustart = bgzf_layout(data)
    check(stream == stream_want,
          "vcf write: the blocks do not inflate to the header and lines")
    tbi_raw = open(vbgz + ".tbi", "rb").read()
    tbi_check(tbi_raw, v, len(header), cstart, ustart, "vcf write")
    splits = -(-len(data) // VCF_SPLIT)
    check(splits >= 4, f"vcf: {splits} splits")
    want_b1 = b1_split_launches(data, VCF_SPLIT)
    all_rows = np.arange(VCF_SITES)

    # -- the reads ----------------------------------------------------------------
    def read_leg(name, storage, path, rows, b1_want, **kw):
        got, la, host, b1_host = leg(
            name, lambda: storage.read(path, **kw), len(rows))
        variants_equal(got.variants, v, rows, name)
        check(got.header.text == v["header"], f"{name}: header")
        key = "inflate_legacy" if name == "vcf_legacy_read" else "inflate"
        check(la.get(key, 0) == b1_want and set(la) == {key},
              f"{name}: launches {la}, want {key} {b1_want}")
        return got, host, b1_host

    got, host, b1_host = read_leg("vcf_read", st, vbgz, all_rows, want_b1)
    check(host == 0 and not any(b1_host.values()),
          f"vcf read: blocks inflated on the host {host} {b1_host}")
    check(got.counters.shards == splits and got.counters.records == VCF_SITES,
          f"vcf read: counters {got.counters}")
    os.environ["DISQ_TPU_TORCH_DEVICE_INFLATE"] = "legacy"
    try:
        _, host, _ = read_leg("vcf_legacy_read", st, vbgz, all_rows,
                              want_b1)
    finally:
        os.environ.pop("DISQ_TPU_TORCH_DEVICE_INFLATE")
    check(host == 0, f"vcf legacy read: {host} blocks on the host")
    _, host, b1_host = read_leg(
        "vcf_executor4_read", port.VariantsStorage.make_default()
        .split_size(VCF_SPLIT).executor_workers(4), vbgz, all_rows, want_b1)
    check(host == 0 and not any(b1_host.values()),
          f"vcf 4-worker read: blocks on the host {host} {b1_host}")

    # skip: one flipped bit in a block in the middle of split 1
    k = int(np.searchsorted(cstart, VCF_SPLIT + VCF_SPLIT // 2))
    p, total, _ = walk_blocks(data)[k]
    flipped = bytearray(data)
    flipped[p + total // 2] ^= 0x10
    vflip = os.path.join(work, "vflip.vcf.bgz")
    with open(vflip, "wb") as f:
        f.write(bytes(flipped))
    del flipped
    ulo, uhi = int(ustart[k]), int(ustart[k + 1])
    n = VCF_SITES
    starts = len(header) + v["line_offsets"][:-1] + np.arange(n)
    ends = len(header) + v["line_offsets"][1:] + np.arange(1, n + 1)
    kept = np.nonzero((ends <= ulo) | (starts >= uhi))[0]
    got, host, _ = read_leg(
        "vcf_skip_read", port.VariantsStorage.make_default()
        .split_size(VCF_SPLIT).error_policy("skip"), vflip, kept, want_b1)
    check(got.counters.skipped_blocks == 1,
          f"vcf skip read: {got.counters.skipped_blocks} blocks skipped")
    check(host <= 1, f"vcf skip read: {host} blocks on the host")
    legs["vcf_skip_read"]["lost_sites"] = n - len(kept)

    # tabix: three intervals, B1 once per merged chunk
    tbi = TbiIndex.from_bytes(tbi_raw)
    chunks = sorted(c for contig, s, e in VCF_INTERVALS
                    for c in tbi.chunks_for_interval(contig, s - 1, e))
    merged = []
    for cb, ce in chunks:
        if merged and cb <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
        else:
            merged.append((cb, ce))
    mask = np.zeros(n, bool)
    for contig, s, e in VCF_INTERVALS:
        mask |= ((v["chrom"] == names.index(contig)) & (v["pos"] <= e)
                 & (v["end"] >= s))
    read_leg("vcf_tabix_read", st, vbgz, np.nonzero(mask)[0], len(merged),
             intervals=[port.Interval(*iv) for iv in VCF_INTERVALS])

    # -- the device-deflate write ---------------------------------------------------
    vdev = os.path.join(work, "vdev.vcf.bgz")
    shards = resolve_num_shards(st)
    _, la, _, _ = leg("vcf_device_write", lambda: st.device_deflate().write(
        vds, vdev, port.TabixIndexWriteOption.ENABLE), VCF_SITES)
    check(la == {"deflate": shards + 1},
          f"vcf device write: launches {la}, want deflate {shards + 1}")
    dev_data = open(vdev, "rb").read()
    d_stream, d_cstart, d_ustart = bgzf_layout(dev_data)
    check(d_stream == stream and dev_data != data,
          "vcf device write: does not inflate to the zlib-6 write's stream")
    d_tbi = open(vdev + ".tbi", "rb").read()
    check(bai_mapped(tbi_parts(d_tbi)[3], d_cstart, d_ustart).tolist()
          == bai_mapped(tbi_parts(tbi_raw)[3], cstart, ustart).tolist(),
          "vcf device write: its TBI maps to other uncompressed offsets")
    e2e["vcf_bytes"] = {"file": len(data), "decoded": len(stream),
                        "device_file": len(dev_data), "splits": splits}
    del data, stream, dev_data, d_stream

    # -- BCF on the first BCF_SITES sites ----------------------------------------
    bds = port.VariantsDataset(header=vds.header,
                               variants=vds.variants.slice(0, BCF_SITES))
    bst = port.VariantsStorage.make_default().split_size(BCF_SPLIT)
    bcf, bdev = os.path.join(work, "v.bcf"), os.path.join(work, "vdev.bcf")
    _, la, _, _ = leg("bcf_write", lambda: bst.write(bds, bcf), BCF_SITES)
    check(not la, f"bcf write: a zlib-6 write launched {la}")
    _, la, _, _ = leg("bcf_device_write",
                      lambda: bst.device_deflate().write(bds, bdev),
                      BCF_SITES)
    check(la == {"deflate": shards + 1}, f"bcf device write: launches {la}")
    b_data, b_dev = open(bcf, "rb").read(), open(bdev, "rb").read()
    b_stream = bgzf_layout(b_data)[0]
    check(b_stream[:5] == b"BCF\x02\x02", "bcf write: magic")
    check(bgzf_layout(b_dev)[0] == b_stream and b_dev != b_data,
          "bcf device write: does not inflate to the zlib-6 write's stream")
    got, la, host, b1_host = leg("bcf_read", lambda: bst.read(bcf),
                                 BCF_SITES)
    want = split_block_launches(b_data, BCF_SPLIT)
    check(la == {"inflate": want} and want >= 2,
          f"bcf read: launches {la}, want inflate {want}")
    check(host == 0 and not any(b1_host.values()),
          f"bcf read: blocks on the host {host} {b1_host}")
    variants_equal(got.variants, v, np.arange(BCF_SITES), "bcf read")
    e2e["bcf_bytes"] = {"file": len(b_data), "decoded": len(b_stream),
                        "device_file": len(b_dev)}
    del b_data, b_dev, b_stream, got

    # -- SAM text on the first SAM_RECORDS sorted reads ----------------------------
    rows = perm_want[:SAM_RECORDS]
    nreads = len(perm_want)
    sub = ds.reads.permuted(perm_want).filter(np.arange(nreads) < SAM_RECORDS)
    check(sub.device_backed, "sam: the sorted head is not device-backed")
    sam_ds = port.ReadsDataset(header=ds.header.with_sort_order("coordinate"),
                               reads=sub)
    rst = port.ReadsStorage.make_default()
    sam = os.path.join(work, "head.sam")
    _, la, _, _ = leg("sam_write", lambda: rst.write(sam_ds, sam),
                      SAM_RECORDS)
    check(not la, f"sam write: launches {la}")
    back, la, _, _ = leg("sam_read", lambda: rst.read(sam), SAM_RECORDS)
    check(not la, f"sam read: launches {la}")
    rb = back.reads
    check(type(rb).__name__ == "ReadBatch" and back.count() == SAM_RECORDS,
          f"sam read: {type(rb).__name__} of {back.count()} records")
    check(back.flagstat() == numpy_flagstat(g["flag"][rows]),
          "sam read: flagstat")
    # SAM carries no bin: the parse derives it from POS and the CIGAR,
    # which gives an unplaced read 4681 (the reference's), not 4680
    placed = g["refid"][rows] >= 0
    for col in FIXED:
        got_col, want_col = getattr(rb, col), g[col][rows]
        if col == "bin":
            got_col, want_col = got_col[placed], want_col[placed]
        check(np.array_equal(got_col, want_col), f"sam read: column {col}")
    check(np.array_equal(rb.names.reshape(-1, NAME_LEN), g["names"][rows]),
          "sam read: names")
    check(np.array_equal(rb.seqs.reshape(-1, READ_LEN), g["seq"][rows]),
          "sam read: sequences")
    check(np.array_equal(rb.quals.reshape(-1, READ_LEN), g["qual"][rows]),
          "sam read: qualities")
    ncig = g["ncig"][rows]
    check(np.array_equal(rb.cigars, g["cig"][rows][
        np.arange(3)[None, :] < ncig[:, None]]), "sam read: cigars")
    # SAM text prints NM:C:n as NM:i:n, which reads back as an int32
    t = g["tags"][rows]
    tags_want = np.concatenate([
        t[:, :8], np.frombuffer(b"NMi", np.uint8)[None].repeat(len(rows), 0),
        t[:, 11:12].astype("<i4").view(np.uint8)], 1)
    check(np.array_equal(rb.tags.reshape(len(rows), -1), tags_want),
          "sam read: tags")
    sam_bam = os.path.join(work, "head.bam")
    _, la, _, _ = leg("sam_bam_write", lambda: rst.write(back, sam_bam),
                      SAM_RECORDS)
    again = rst.read(sam_bam)
    check(again.reads.device_backed, "sam → bam: the re-read is on the host")
    for col in FIXED:
        check(np.array_equal(getattr(again.reads, col), getattr(rb, col)),
              f"sam → bam re-read: column {col}")
    check(np.array_equal(again.reads.to_read_batch().tags, rb.tags),
          "sam → bam re-read: tags")
    e2e["sam_bytes"] = os.path.getsize(sam)
    log(f"variants: {json.dumps(legs)}")
    return launches, e2e

PLANES_HEDGE_MIN_S = 0.75    # the hedge delay floor of the hedged read
PLANES_SLOW_S = 4.0          # the seeded slow fault's upper bound
PLANES_DEADLINE_S = 3.5      # the shard deadline of the deadline reads:
                             # ~2.5x a whole 4-worker read on an H100
PLANES_STALL_S = 5.0         # the stall on split 4, past the deadline
PLANES_BREAKER = (3, 30.0)   # the breaker's window and cooldown


def _fault_store(specs, seed: int = 0):
    """A seeded ``FaultInjectingFileSystemWrapper`` over the posix
    filesystem, registered under ``fault://``."""
    from disq_tpu_torch.fsw.faultfs import (
        FaultInjectingFileSystemWrapper,
        FaultSpec,
    )
    from disq_tpu_torch.fsw.filesystem import (
        PosixFileSystemWrapper,
        register_filesystem,
    )

    fsw = FaultInjectingFileSystemWrapper(
        PosixFileSystemWrapper(), [FaultSpec(**s) for s in specs], seed=seed)
    register_filesystem("fault", fsw)
    return fsw


def _drain(prefix, timeout: float = 30.0) -> None:
    """Wait for the threads whose names start with ``prefix`` (a string
    or a tuple of them) to end: a lost hedge's fetch, or an aborted
    run's last stage jobs, run on to their end."""
    import threading

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if not [t for t in threading.enumerate()
                if t.name.startswith(prefix)]:
            return
        time.sleep(0.05)
    raise PhaseError(f"threads {prefix}* still alive after {timeout}s")


def _get(addr: str, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://{addr}{path}", timeout=60) as r:
        return r.read()


def plane_legs(torch, port, args, g, info, ds, src, work) -> tuple:
    """The resilience and observability planes on the main path's BAM:
    (a) a hedged 4-worker read with a seeded slow fault on split 3's
    fetch, (b) a read whose split 4 stalls past its shard deadline, under
    ``skip`` and under ``strict``, (c) a read under the circuit breaker,
    the retry budget and the flight recorder from a store whose every
    range read fails, (d) a 4-worker read with the endpoint, the
    watchdog, the progress log and the profiler on (and the variants
    phase's VCF.bgz under the endpoint), (e) the 8-shard sorted write at
    4 writer workers with the breaker armed on its output. Returns the
    launches of each read and the e2e fields."""
    import random

    from disq_tpu_torch.runtime import (
        counters,
        flightrec,
        introspect,
        profiler,
        resilience,
        tracing,
    )
    from disq_tpu_torch.runtime.cluster import parse_metrics_text
    from disq_tpu_torch.runtime.errors import (
        BreakerOpenError,
        DeadlineExceededError,
    )

    n, split = args.records, args.split_size
    n_splits = -(-info["file_bytes"] // split)
    name = os.path.basename(src)
    launches, e2e = {}, {}

    def storage():
        return port.ReadsStorage.make_default().split_size(split)

    def count(what: str) -> float:
        return tracing.counter(what).total()

    # -- (a) hedged fetches -----------------------------------------------
    seed = args.seed
    while random.Random(seed).uniform(0.0, PLANES_SLOW_S) < \
            PLANES_SLOW_S * 0.6:
        seed += 1  # the first seed whose slow draw outlives the hedge
    slow_at = 3 * split + split * 3 // 4  # no header or boundary read
    fsw = _fault_store([dict(kind="slow", path_substr=name, offset=slow_at,
                             slow_s=PLANES_SLOW_S, times=1)], seed)
    launched0, won0 = count("hedge.launched"), count("hedge.won")
    counters.reset()
    t0 = time.perf_counter()
    hedged = storage().executor_workers(4) \
        .hedged_fetches(0.9, PLANES_HEDGE_MIN_S).read("fault://" + src)
    torch.cuda.synchronize()
    hedge_s = time.perf_counter() - t0
    snap = counters.snapshot()["launches"]
    launched = count("hedge.launched") - launched0
    won = count("hedge.won") - won0
    check([i.kind for i in fsw.injected] == ["slow"],
          f"planes hedge: injected {fsw.injected}")
    check(launched >= 1 and won == launched,
          f"planes hedge: {launched} launched, {won} won")
    check(snap.get("inflate", 0) == n_splits and
          snap.get("parse", 0) == n_splits,
          f"planes hedge: launches {snap} for {n_splits} splits")
    same_reads(torch, hedged, ds, "planes hedged read")
    del hedged
    _drain("disq-hedge")
    launches["hedge"] = snap
    e2e["planes_hedge_read_s"] = round(hedge_s, 4)
    winners = {w: tracing.counter("hedge.won").value(winner=w)
               for w in ("primary", "hedge", "neither")}
    log(f"planes hedge: {hedge_s:.3f}s, slow fault seed {seed} on split 3, "
        f"{launched:.0f} launched, {won:.0f} won "
        f"({winners}), launches "
        f"{snap}, records equal the default read")

    # -- (b) shard deadlines ----------------------------------------------
    stall_at = 4 * split + split * 3 // 4
    stall = [dict(kind="stall", path_substr=name, offset=stall_at,
                  stall_s=PLANES_STALL_S, times=1)]
    starts = split_starts(g, src, split)
    rows = np.r_[0:starts[4], starts[5]:n]
    check(len(rows) < n, "planes deadline: split 4 holds no record")
    _fault_store(stall)
    exceeded0 = count("deadline.exceeded")
    counters.reset()
    t0 = time.perf_counter()
    skipped = storage().executor_workers(4).error_policy("skip") \
        .shard_deadline(PLANES_DEADLINE_S).read("fault://" + src)
    torch.cuda.synchronize()
    deadline_s = time.perf_counter() - t0
    snap = counters.snapshot()["launches"]
    check(count("deadline.exceeded") - exceeded0 == 1,
          "planes deadline: deadline.exceeded != 1")
    check(skipped.counters.skipped_blocks == 1,
          f"planes deadline: counters {skipped.counters.as_dict()}")
    check(snap.get("inflate", 0) == n_splits - 1,
          f"planes deadline: launches {snap}")
    equal_to_generator(torch, skipped, g, rows, "planes deadline read")
    del skipped
    _fault_store(stall)
    t0 = time.perf_counter()
    try:
        storage().executor_workers(4).shard_deadline(PLANES_DEADLINE_S) \
            .read("fault://" + src)
    except DeadlineExceededError as e:
        check(e.shard_id == 4, f"planes deadline strict: {e}")
        strict_err = str(e)
    else:
        raise PhaseError("planes deadline: the strict read did not raise")
    strict_s = time.perf_counter() - t0
    # the aborted run's last fetches and decodes end
    _drain(("disq-torch-fetch", "disq-torch-decode"))
    launches["deadline"] = snap
    e2e.update(planes_deadline_skip_read_s=round(deadline_s, 4),
               planes_deadline_strict_read_s=round(strict_s, 4))
    log(f"planes deadline: skip {deadline_s:.3f}s ({n - len(rows)} records "
        f"of split 4 set aside, the rest equal the generator, launches "
        f"{snap}); strict {strict_s:.3f}s raises {strict_err}")

    # -- (c) breaker, budget and flight recorder --------------------------
    pm = os.path.join(work, "postmortem")
    shutil.rmtree(pm, ignore_errors=True)
    resilience.reset_resilience()
    fsw = _fault_store([dict(kind="transient", path_substr=name,
                             probability=1.0)])
    window, cooldown = PLANES_BREAKER
    broken = storage().circuit_breaker(window, cooldown).retry_budget(8) \
        .postmortem_dir(pm)
    counters.reset()
    t0 = time.perf_counter()
    for attempt in range(2):
        try:
            broken.read("fault://" + src)
        except BreakerOpenError as e:
            err = str(e)
        else:
            raise PhaseError("planes breaker: the read did not raise")
        if attempt == 0:
            # the read that opened the breaker: one bundle
            calls = len(fsw.injected)
            bundles = sorted(d for d in os.listdir(pm)
                             if d.startswith("bundle-"))
    breaker_s = time.perf_counter() - t0
    snap = counters.snapshot()["launches"]
    check(calls == window and len(fsw.injected) == window,
          f"planes breaker: {len(fsw.injected)} store calls, want {window}")
    check(sum(snap.values()) == 0, f"planes breaker: launches {snap}")
    check(resilience.breakers_snapshot()["fault"]["state"] == "open",
          "planes breaker: not open")
    check(len(bundles) == 1, f"planes breaker: bundles {bundles}")
    with open(os.path.join(pm, bundles[0], "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    kinds = [e["kind"] for e in events]
    check("breaker_transition" in kinds and kinds[-1] == "abort"
          and events[-1]["reason"] == "breaker_open",
          f"planes breaker: events {kinds}")
    with open(os.path.join(pm, bundles[0], "MANIFEST.json")) as f:
        manifest = json.load(f)
    check(manifest["reason"] == "breaker_open",
          f"planes breaker: bundle {manifest}")
    flightrec.reset_flightrec()
    resilience.reset_resilience()
    launches["breaker"] = snap
    e2e["planes_breaker_reads_s"] = round(breaker_s, 4)
    log(f"planes breaker: two reads {breaker_s:.3f}s, {window} store calls "
        f"then none (the second fails fast), no launch, raises {err}; "
        f"bundle {bundles[0]} ({len(events)} events: {kinds})")

    # -- (d) live introspection -------------------------------------------
    import threading

    introspect.reset_introspection()
    plog = os.path.join(work, "progress.jsonl")
    live = storage().executor_workers(4).introspect_port(0) \
        .watchdog(30.0).progress_log(plog).profile_hz(99)
    counters.reset()
    got = {}

    def profile_it():
        # the profile window opens as the main thread starts the read
        got["profile"] = _get(addr, "/debug/profile?seconds=1&hz=200")

    introspect.start_introspect_server(0)
    addr = introspect.introspect_address()
    _kinds, before = parse_metrics_text(_get(addr, "/metrics").decode())
    t0 = time.perf_counter()
    client = threading.Thread(target=profile_it, name="planes-profile")
    client.start()
    got["ds"] = live.read(src)
    torch.cuda.synchronize()
    live_s = time.perf_counter() - t0
    client.join()
    prof = got["profile"].decode()
    snap = counters.snapshot()["launches"]
    health = json.loads(_get(addr, "/healthz"))
    prog = json.loads(_get(addr, "/progress"))["directions"]["read"]
    _kinds, after = parse_metrics_text(_get(addr, "/metrics").decode())

    def kernel_series(samples):
        return {dict(labels)["kernel"]: v for name_, labels, v in samples
                if name_ == "disq_tpu_device_kernel_launches"}

    delta = {k: v - kernel_series(before).get(k, 0.0)
             for k, v in kernel_series(after).items()}
    roles = {}
    for line in prof.splitlines():
        stack, _, k = line.rpartition(" ")
        roles[stack.split(";", 1)[0]] = roles.get(
            stack.split(";", 1)[0], 0) + int(k)
    pipeline_other = [ln for ln in prof.splitlines()
                      if ln.startswith("other;") and "executor.py" in ln]
    with open(plog) as f:
        last = [json.loads(line) for line in f if '"direction"' in line][-1]
    profiler.stop_profiler()
    check(health["status"] == "ok", f"planes live: healthz {health}")
    check(prog["shards_total"] == prog["shards_done"] == n_splits
          and prog["records"] == n, f"planes live: progress {prog}")
    check(delta.get("inflate_simd") == n_splits
          and delta.get("parse") == n_splits,
          f"planes live: /metrics launches delta {delta}")
    check(roles.get("fetch", 0) > 0 and roles.get("decode", 0) > 0
          and not pipeline_other, f"planes live: profile roles {roles}")
    check(last["records"] == n, f"planes live: progress log {last}")
    same_reads(torch, got["ds"], ds, "planes live read")
    del got
    launches["live"] = snap
    introspect.reset_introspection()
    vcf = os.path.join(work, "v.vcf.bgz")
    vst = port.VariantsStorage.make_default().split_size(VCF_SPLIT) \
        .introspect_port(0)
    t0 = time.perf_counter()
    vds = vst.read(vcf)
    vcf_s = time.perf_counter() - t0
    vprog = json.loads(_get(vds.introspect_address(),
                            "/progress"))["directions"]["read"]
    check(vprog["records"] == vds.count() == VCF_SITES,
          f"planes live: VCF progress {vprog}")
    del vds
    introspect.reset_introspection()
    e2e.update(planes_live_read_s=round(live_s, 4),
               planes_live_vcf_read_s=round(vcf_s, 4))
    log(f"planes live: {live_s:.3f}s at 4 workers, healthz ok, progress "
        f"{prog['shards_done']} shards {prog['records']} records, /metrics "
        f"launch delta {delta}, profile roles {roles}, progress log "
        f"{last['records']} records; VCF.bgz {vcf_s:.3f}s, progress "
        f"{vprog['records']} lines")

    # -- (e) the armed write ----------------------------------------------
    out = os.path.join(work, "sorted_w4_breaker.bam")
    resilience.reset_resilience()
    t0 = time.perf_counter()
    (storage().num_shards(WRITE_SHARDS).writer_workers(4)
     .circuit_breaker(*PLANES_BREAKER)
     .write(ds, out, port.BaiWriteOption.ENABLE, sort=True))
    armed_s = time.perf_counter() - t0
    for ext in ("", ".bai"):
        with open(out + ext, "rb") as a, \
                open(os.path.join(work, "sorted_w4.bam") + ext, "rb") as b:
            check(a.read() == b.read(),
                  f"planes write: {ext or '.bam'} differs from the unarmed "
                  f"write")
    state = resilience.breakers_snapshot()["local"]["state"]
    check(state == "closed", f"planes write: breaker {state}")
    resilience.reset_resilience()
    e2e["planes_armed_write_s"] = round(armed_s, 4)
    log(f"planes write: {WRITE_SHARDS} shards at 4 writer workers with the "
        f"breaker armed {armed_s:.3f}s, BAM and BAI byte-identical to the "
        f"unarmed write, breaker {state}")
    return launches, e2e


SCHED_LEASE_N = 2            # splits per lease in every sched leg
SCHED_LEASE_S = 2.0          # the handoff leg's lease: its crash detection
SCHED_STALL_S = 300.0        # the victim's stall, which its kill cuts short
SCHED_WAIT_S = 180.0         # the bound of every wait on a worker process
SCHED_COUNTERS = ("sched.leases", "sched.steals", "sched.lease_expired",
                  "sched.dup_done")
DIGEST_COLUMNS = FIXED + ("names", "cigars", "seqs", "quals", "tags")
SCHED_SPANS = ("executor.fetch", "executor.decode", "bam.split.decode",
               "codec.inflate.batch", "sched.rpc", "sched.wait")


def split_starts(g: dict, src: str, split: int) -> np.ndarray:
    """The first record of each split of ``src`` (and ``n`` last): a
    record belongs to the split its BGZF block starts in, found from its
    start in the decoded stream (the generator's record sizes)."""
    size = (36 + NAME_LEN + 1 + 4 * g["ncig"].astype(np.int64)
            + (READ_LEN + 1) // 2 + READ_LEN + TAG_BYTES)
    ustart = len(bam_header()) + np.concatenate([[0], np.cumsum(size[:-1])])
    with open(src, "rb") as f:
        cpos = np.array([b[0] for b in walk_blocks(f.read())], np.int64)
    owner = cpos[ustart // MAX_PAYLOAD] // split
    return np.searchsorted(owner, np.arange(owner[-1] + 2))


def batch_digest(batch) -> str:
    """A digest of every column of a read batch (device-backed or host)."""
    import hashlib

    rb = batch.to_read_batch() if hasattr(batch, "to_read_batch") else batch
    h = hashlib.sha1()
    for col in DIGEST_COLUMNS:
        h.update(np.ascontiguousarray(getattr(rb, col)).tobytes())
    return h.hexdigest()


def sched_worker(spec: dict) -> int:
    """A second process of the sched phase on the same card: once the
    file ``spec["go"]`` names the coordinator (``{"addr": "host:port"}``),
    one BAM read of ``spec["path"]`` at ``spec["split"]`` leased from it
    (the host name and lease size come from ``DISQ_TPU_TORCH_SCHED_*`` in
    its environment), with the read ledger ``spec["ledger"]`` and through
    a stall at byte ``spec["stall_at"]`` when given. Prints one JSON
    line: records, their digest, seconds and the kernel launches of the
    read."""
    import torch

    if not torch.cuda.is_available():
        print("FAILED: CUDA is not available", file=sys.stderr, flush=True)
        return 1
    sys.path.insert(0, HERE)
    import disq_tpu_torch as port
    from disq_tpu_torch.runtime import counters

    path = spec["path"]
    storage = port.ReadsStorage.make_default().split_size(spec["split"])
    if spec.get("ledger"):
        storage = storage.read_ledger(spec["ledger"])
    if spec.get("stall_at") is not None:
        _fault_store([dict(kind="stall", path_substr=os.path.basename(path),
                           offset=spec["stall_at"], stall_s=SCHED_STALL_S,
                           times=1)])
        path = "fault://" + path
    torch.zeros(1, device="cuda")  # the CUDA context, before the wait
    t0 = time.perf_counter()
    while not os.path.exists(spec["go"]):
        if time.perf_counter() - t0 > SCHED_WAIT_S:
            print("FAILED: no coordinator", file=sys.stderr, flush=True)
            return 1
        time.sleep(0.02)
    with open(spec["go"]) as f:
        os.environ["DISQ_TPU_TORCH_SCHED"] = json.load(f)["addr"]
    counters.reset()
    t0 = time.perf_counter()
    ds = storage.read(path)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(json.dumps({
        "records": ds.count(), "digest": batch_digest(ds.reads),
        "device_backed": bool(ds.count() == 0 or ds.reads.device_backed),
        "seconds": round(seconds, 4),
        "launches": counters.snapshot()["launches"]}), flush=True)
    return 0


class _Worker:
    """A ``sched_worker`` process on this card, started early so that it
    reaches the card while other legs run, and sent to work by ``go``;
    its output in files under ``work``; killed on ``close`` if it still
    runs."""

    def __init__(self, work: str, name: str, spec: dict) -> None:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DISQ_TPU_TORCH_SCHED")}
        env.update(DISQ_TPU_TORCH_SCHED_HOST=name,
                   DISQ_TPU_TORCH_SCHED_LEASE_N=str(SCHED_LEASE_N))
        self.out = os.path.join(work, f"sched_{name}.out")
        self.err = os.path.join(work, f"sched_{name}.err")
        self.go_path = os.path.join(work, f"sched_{name}.go")
        with open(self.out, "w") as out, open(self.err, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--sched-worker", json.dumps({**spec, "go": self.go_path})],
                stdout=out, stderr=err, env=env, cwd=HERE)

    def go(self, addr: str) -> None:
        """Name the coordinator: the worker's read starts."""
        tmp = self.go_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"addr": addr}, f)
        os.replace(tmp, self.go_path)

    def tail(self) -> str:
        with open(self.err) as f:
            return f.read()[-2000:]

    def wait_for(self, cond, what: str):
        """Poll ``cond()`` until it is true (and return it); fails when
        the worker exits first or ``SCHED_WAIT_S`` passes."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < SCHED_WAIT_S:
            if self.proc.poll() is not None:
                raise PhaseError(f"{what}: the worker exited "
                                 f"{self.proc.returncode}: {self.tail()}")
            got = cond()
            if got:
                return got
            time.sleep(0.05)
        raise PhaseError(f"{what}: not reached in {SCHED_WAIT_S}s")

    def result(self) -> dict:
        try:
            rc = self.proc.wait(timeout=SCHED_WAIT_S)
        except subprocess.TimeoutExpired:
            raise PhaseError(f"a sched worker ran past {SCHED_WAIT_S}s")
        with open(self.out) as f:
            lines = f.read().splitlines()
        if rc != 0 or not lines:
            raise PhaseError(f"a sched worker exited {rc}: {self.tail()}")
        return json.loads(lines[-1])

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def sched_legs(torch, port, args, g, info, ds, src, work, head) -> tuple:
    """The shard scheduler on the main path's BAM, the CRAM head copy and
    the variants phase's VCF.bgz: (a) one worker serving and leasing
    every split, (b) this process serving and a second process on the
    same card joining, (c) a victim process killed while it holds a lease
    (the survivor reads the rest, the victim's spill loaded from the
    shared ledger), (d) the 8-shard sorted write leased at 4 writer
    workers with a manifest, (e) the CRAM head and the VCF.bgz scheduled
    at 1 worker. Returns the launches of each leg and the e2e fields."""
    from disq_tpu_torch.bam.columnar import ReadBatch
    from disq_tpu_torch.runtime import counters, introspect, scheduler, tracing
    from disq_tpu_torch.runtime.columnar import ColumnarBatch
    from disq_tpu_torch.runtime.manifest import ReadLedger

    n, split = args.records, args.split_size
    n_splits = -(-info["file_bytes"] // split)
    starts = split_starts(g, src, split)
    check(len(starts) == n_splits + 1 and starts[-1] == n,
          f"sched: split starts {starts.tolist()}")
    default = ds.reads.to_read_batch()

    def rows_digest(splits) -> str:
        return batch_digest(ReadBatch.concat(
            [default.slice(int(starts[k]), int(starts[k + 1]))
             for k in splits]))

    def rows(splits) -> int:
        return int(sum(starts[k + 1] - starts[k] for k in splits))

    def storage():
        return port.ReadsStorage.make_default().split_size(split)

    def books() -> dict:
        out = {name: tracing.counter(name).total() for name in SCHED_COUNTERS}
        for r in ("hit", "miss"):
            out[f"sched.locality{{result={r}}}"] = \
                tracing.counter("sched.locality").value(result=r)
        return out

    def run_of(path: str, shards: int, direction: str = "read") -> dict:
        key = scheduler.run_key_for(path, shards, direction)
        return scheduler.active_coordinator().stats()["runs"][key]

    def reset() -> None:
        scheduler.stop_coordinator()
        introspect.reset_introspection()

    def stage_sums() -> dict:
        sums = span_sums(tracing)
        return {k: sums[k]["s"] for k in SCHED_SPANS if k in sums}

    launches, e2e = {}, {}
    # the second processes start now and reach the card during leg (a):
    # p1 joins leg (b); the victim of leg (c) leases splits 0 and 1,
    # finishes and spills 0, and hangs in split 1's fetch, past every
    # header and boundary read
    ledger = os.path.join(work, "ledger_sched")
    shutil.rmtree(ledger, ignore_errors=True)
    worker = _Worker(work, "p1", {"path": src, "split": split})
    victim = _Worker(work, "victim", {
        "path": src, "split": split, "ledger": ledger,
        "stall_at": split + split * 3 // 4})
    try:
        # -- (a) one worker -----------------------------------------------------
        reset()
        tracing.reset_spans()
        t0 = time.perf_counter()
        base = storage().read(src)
        torch.cuda.synchronize()
        base_s = time.perf_counter() - t0
        base_spans = stage_sums()
        del base
        b0 = books()
        counters.reset()
        tracing.reset_spans()
        t0 = time.perf_counter()
        got = storage().scheduler("serve", lease_n=SCHED_LEASE_N).read(src)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        one_spans = stage_sums()
        snap = counters.snapshot()["launches"]
        sched = _delta(b0, books())
        run = run_of(src, n_splits)
        check(snap.get("inflate", 0) == n_splits
              and snap.get("parse", 0) == n_splits,
              f"sched one worker: launches {snap} for {n_splits} splits")
        check(sched.get("sched.locality{result=miss}") == n_splits
              and not sched.get("sched.locality{result=hit}"),
              f"sched one worker: {sched}")
        check(run["finished"] and set(run["done"].values()) == {"p0"},
              f"sched one worker: run {run}")
        same_reads(torch, got, ds, "sched one worker")
        del got
        launches["one_worker"] = snap
        e2e.update(sched_default_read_s=round(base_s, 4),
                   sched_one_worker_read_s=round(one_s, 4))
        log(f"sched one_worker: {n} records, {one_s:.3f}s (default read "
            f"{base_s:.3f}s in this leg), launches {snap}, {sched}; span "
            f"seconds {one_spans} (default read {base_spans}); the columns "
            f"equal the default read's in its order")

        # -- (b) two processes on one card --------------------------------------
        reset()
        addr = scheduler.serve_coordinator(lease_s=30.0)
        b0 = books()
        worker.go(addr)
        # join as soon as the worker has: both then lease from one queue
        t_join = time.perf_counter()
        worker.wait_for(lambda: "p1" in scheduler.active_coordinator()
                        .stats()["members"], "sched two processes: join")
        join_s = time.perf_counter() - t_join
        counters.reset()
        t0 = time.perf_counter()
        mine = storage().scheduler("serve", lease_n=SCHED_LEASE_N).read(src)
        torch.cuda.synchronize()
        mine_s = time.perf_counter() - t0
        snap = counters.snapshot()["launches"]
        theirs = worker.result()
        sched = _delta(b0, books())
        run = run_of(src, n_splits)
        done = {int(k): h for k, h in run["done"].items()}
        check(run["finished"] and sorted(done) == list(range(n_splits))
              and set(done.values()) <= {"p0", "p1"},
              f"sched two processes: run {run}")
        by = {h: sorted(k for k, w in done.items() if w == h)
              for h in ("p0", "p1")}
        check(mine.count() == rows(by["p0"])
              and batch_digest(mine.reads) == rows_digest(by["p0"]),
              f"sched two processes: this process's {mine.count()} records "
              f"differ from the default read's splits {by['p0']}")
        check(mine.count() == 0 or mine.reads.device_backed,
              "sched two processes: not device-backed")
        check(theirs["records"] == rows(by["p1"])
              and theirs["digest"] == rows_digest(by["p1"])
              and theirs["device_backed"],
              f"sched two processes: the worker's {theirs} differ from the "
              f"default read's splits {by['p1']}")
        for kernel in ("inflate", "parse"):
            total = snap.get(kernel, 0) + theirs["launches"].get(kernel, 0)
            check(total == n_splits, f"sched two processes: {kernel} launches "
                  f"{snap} + {theirs['launches']} for {n_splits} splits")
        del mine
        launches["two_processes"] = {k: snap.get(k, 0)
                                     + theirs["launches"].get(k, 0)
                                     for k in ("inflate", "parse")}
        e2e.update(sched_two_process_read_s=round(mine_s, 4),
                   sched_worker_read_s=theirs["seconds"])
        log(f"sched two_processes: splits {by} (each once), this process "
            f"{rows(by['p0'])} records {mine_s:.3f}s launches {snap}, the "
            f"worker {theirs['records']} records {theirs['seconds']:.3f}s "
            f"launches {theirs['launches']} (joined {join_s:.3f}s after its "
            f"go), {sched}; both equal the default read's splits")

        # -- (c) crash handoff ----------------------------------------------------
        reset()
        addr = scheduler.serve_coordinator(lease_s=SCHED_LEASE_S)
        fpath = "fault://" + src
        b0 = books()
        victim.go(addr)
        since = []

        def wedged():
            # split 0 done, and a second on: the victim hangs in split 1's
            # fetch (its lease of split 1 may expire meanwhile)
            runs = scheduler.active_coordinator().stats()["runs"]
            r = runs.get(scheduler.run_key_for(fpath, n_splits))
            if not r or "0" not in r["done"]:
                return None
            since.append(time.perf_counter())
            return r if since[-1] - since[0] >= 1.0 else None

        run = victim.wait_for(wedged, "sched handoff: the victim wedged")
        victim.close()  # SIGKILL while it holds split 1
        victim_done = sorted(int(k) for k in run["done"])
        spilled = ReadLedger(ledger).completed_shards()
        check(victim_done == [0] and spilled == [0]
              and run["leases"].get("1", {}).get("host", "victim") == "victim",
              f"sched handoff: the victim did {victim_done}, spilled "
              f"{spilled}, run {run}")
        _fault_store([])  # the same path, no fault
        counters.reset()
        t0 = time.perf_counter()
        survivor = storage().read_ledger(ledger).scheduler(
            addr, lease_n=SCHED_LEASE_N, lease_s=SCHED_LEASE_S,
            steal=False).read(fpath)
        torch.cuda.synchronize()
        survivor_s = time.perf_counter() - t0
        # the victim's finished split from its spill: the parse kernel again
        spills = [ReadLedger(ledger).load(k)[0] for k in spilled]
        whole = port.ReadsDataset(header=survivor.header,
                                  reads=ColumnarBatch.concat(
                                      spills + [survivor.reads]))
        same_reads(torch, whole, ds, "sched handoff")
        snap = counters.snapshot()["launches"]
        sched = _delta(b0, books())
        run = run_of(fpath, n_splits)
        fresh = n_splits - len(spilled)
        check(survivor.count() == rows(range(1, n_splits)),
              f"sched handoff: the survivor read {survivor.count()} records")
        check(snap.get("inflate", 0) == fresh
              and snap.get("parse", 0) == fresh + len(spilled),
              f"sched handoff: launches {snap}, {fresh} fresh splits, "
              f"{len(spilled)} spills")
        check(sched.get("sched.lease_expired", 0) >= 1
              and 1 in run["requeued"], f"sched handoff: {sched}, run {run}")
        check(run["finished"] and run["done"]["0"] == "victim"
              and all(run["done"][str(k)] == "p0" for k in range(1, n_splits)),
              f"sched handoff: run {run}")
        del survivor, whole, spills
        ReadLedger(ledger).finish()
        launches["handoff"] = snap
        e2e["sched_handoff_read_s"] = round(survivor_s, 4)
        log(f"sched handoff: the victim finished {victim_done} and was killed "
            f"holding split 1; the survivor read {n - rows([0])} records "
            f"in {survivor_s:.3f}s, launches {snap} (inflate for the {fresh} "
            f"splits not spilled, parse also for {len(spilled)} spill), "
            f"{sched}; with the spill, equal to the default read")

        # -- (d) write leases -----------------------------------------------------
        reset()
        out = os.path.join(work, "sorted_sbi_sched.bam")
        manifest = os.path.join(work, "sched.manifest")
        b0 = books()
        counters.reset()
        t0 = time.perf_counter()
        (storage().num_shards(WRITE_SHARDS).writer_workers(4)
         .scheduler("serve", lease_n=SCHED_LEASE_N)
         .write(ds, out, port.BaiWriteOption.ENABLE, port.SbiWriteOption.ENABLE,
                port.StageManifestWriteOption(manifest), sort=True))
        write_s = time.perf_counter() - t0
        snap = counters.snapshot()["launches"]
        sched = _delta(b0, books())
        for ext in ("", ".bai", ".sbi"):
            with open(out + ext, "rb") as a, \
                    open(os.path.join(work, "sorted_sbi.bam") + ext, "rb") as b:
                check(a.read() == b.read(),
                      f"sched write: {ext or '.bam'} differs from the "
                      f"unscheduled write")
        run = run_of(out, WRITE_SHARDS, "write")
        check(run["finished"] and run["dir"] == "write"
              and len(run["done"]) == WRITE_SHARDS
              and not os.path.exists(manifest), f"sched write: run {run}")
        launches["write"] = snap
        e2e["sched_leased_write_s"] = round(write_s, 4)
        log(f"sched write: {WRITE_SHARDS} shards at 4 writer workers leased "
            f"with a manifest, {write_s:.3f}s, launches {snap}, {sched}; BAM, "
            f"BAI and SBI byte-identical to the unscheduled write")

        # -- (e) the CRAM head and the VCF.bgz ----------------------------------
        reset()
        keys = CRAM_COUNTER_KEYS
        streams = len({off // split for off in head["offsets"]})
        b0 = books()
        counters.reset()
        t0 = time.perf_counter()
        cr = storage().scheduler("serve", lease_n=SCHED_LEASE_N).read(
            head["path"])
        cram_s = time.perf_counter() - t0
        snap = counters.snapshot()["launches"]
        sched = _delta(b0, books())
        check(snap.get("rans_simd", 0) == streams,
              f"sched cram: launches {snap} for {streams} splits with streams")
        got_c = {k: getattr(cr.counters, k) for k in keys}
        check(got_c == {k: head["counters"][k] for k in keys},
              f"sched cram: counters {got_c} != {head['counters']}")
        head_equal(cr.reads, head["reads"], head["records"], "sched cram")
        del cr
        launches["cram"] = snap
        log(f"sched cram: {head['records']} records, {cram_s:.3f}s, launches "
            f"{snap}, {sched}; equal to the head's default read")

        reset()
        vbgz = os.path.join(work, "v.vcf.bgz")
        with open(vbgz, "rb") as f:
            want_b1 = b1_split_launches(f.read(), VCF_SPLIT)
        vst = port.VariantsStorage.make_default().split_size(VCF_SPLIT)
        counters.reset()
        want = vst.read(vbgz)
        base_snap = counters.snapshot()["launches"]
        b0 = books()
        counters.reset()
        t0 = time.perf_counter()
        vgot = vst.scheduler("serve", lease_n=SCHED_LEASE_N).read(vbgz)
        vcf_s = time.perf_counter() - t0
        snap = counters.snapshot()["launches"]
        sched = _delta(b0, books())
        check(snap.get("inflate", 0) == want_b1 == base_snap.get("inflate", 0),
              f"sched vcf: launches {snap} (default {base_snap}), want {want_b1}")
        check(vgot.count() == want.count() == VCF_SITES,
              f"sched vcf: {vgot.count()} sites")
        for col in ("chrom", "pos", "end", "line_offsets", "lines"):
            check(np.array_equal(getattr(vgot.variants, col),
                                 getattr(want.variants, col)),
                  f"sched vcf: column {col}")
        del vgot, want
        launches["vcf"] = snap
        e2e.update(sched_cram_head_read_s=round(cram_s, 4),
                   sched_vcf_read_s=round(vcf_s, 4))
        log(f"sched vcf: {VCF_SITES} sites, {vcf_s:.3f}s, launches {snap}, "
            f"{sched}; equal to the default read")
    finally:
        worker.close()
        victim.close()
        reset()
    return launches, e2e


# -- the serving edge and the fleet ------------------------------------------

SERVE_REGIONS = 64           # the config 13 workload: 64 regions of
SERVE_SPAN = 20_000          # 20,000 bp, weight 1/rank (random.Random(13))
SERVE_LEVELS = (1, 8, 32)    # closed-loop clients per level
SERVE_LEGACY_REQUESTS = 16   # the cold pass under ``legacy`` (B4)
SERVE_FLUSH_MS = 10          # the service legs' flush window
SERVE_STALL_S = 0.08         # replica 2's stall on every query (stall leg)
SERVE_FLEET_CLIENTS = 8
SERVE_WAIT_S = 180.0         # the bound of every wait on a replica
SERVE_STATS = ("chr2", 100_000_001, 100_500_000)   # stats, markdup, filter
SERVE_PILEUP = ("chr1", 50_000_001, 50_016_384)    # the coverage vector
TRACE_KNOB = "DISQ_TPU_TORCH_TRACE_REQUESTS"


def serve_regions():
    """The config 13 regions ``(contig, 0-based start)`` over ``REFS``
    and their weights (1/rank: a few hot regions dominate)."""
    import random

    rng = random.Random(13)
    regions = []
    for _ in range(SERVE_REGIONS):
        name, length = REFS[rng.randrange(len(REFS))]
        regions.append((name, rng.randrange(0, length - SERVE_SPAN)))
    return regions, [1.0 / (i + 1) for i in range(len(regions))]


def closed_loop(addr: str, path: str, c: int, n_req: int, seed: int,
                dataset: str = "bam"):
    """``c`` closed-loop clients, each on one keep-alive connection with
    Nagle off, each sending ``n_req`` ``/query/reads``-shaped requests
    for weighted random config 13 regions (``random.Random(seed * 1000 +
    k)``). Returns (sorted latencies in s, wall s, [(region, status,
    body)], errors)."""
    import http.client
    import random
    import socket
    import threading

    regions, weights = serve_regions()
    lat = [[] for _ in range(c)]
    answers = [[] for _ in range(c)]
    errors = []

    def client(k):
        crng = random.Random(seed * 1000 + k)
        host, _, p = addr.partition(":")
        conn = http.client.HTTPConnection(host, int(p), timeout=SERVE_WAIT_S)
        try:
            conn.connect()
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            for _ in range(n_req):
                i = crng.choices(range(len(regions)), weights)[0]
                contig, start = regions[i]
                body = json.dumps({
                    "dataset": dataset, "tenant": f"t{k % 4}", "limit": 0,
                    "digest": True, "intervals": [{
                        "contig": contig, "start": start + 1,
                        "end": start + SERVE_SPAN}]})
                t0 = time.perf_counter()
                conn.request("POST", path, body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                payload = resp.read()
                lat[k].append(time.perf_counter() - t0)
                answers[k].append((i, resp.status, json.loads(payload)))
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(f"client {k}: {type(e).__name__}: {e}")
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,)) for k in range(c)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    return (sorted(x for lst in lat for x in lst), wall,
            [a for lst in answers for a in lst], errors)


def latency_row(lats, wall) -> dict:
    def pc(p):
        return lats[min(len(lats) - 1, int(p / 100 * len(lats)))] * 1e3

    return {"requests": len(lats), "p50_ms": round(pc(50), 4),
            "p99_ms": round(pc(99), 4), "qps": round(len(lats) / wall, 1)}


def post(addr: str, path: str, doc: dict):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://{addr}{path}", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=SERVE_WAIT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def serve_replica(spec: dict) -> int:
    """A fleet replica of the serve phase on the same card: a port daemon
    on ``cuda`` serving ``spec["bam"]`` as ``bam``; while the file
    ``spec["slow"]`` exists, every query first stalls ``SERVE_STALL_S``.
    Prints ``ADDR host:port``, serves until its standard input closes,
    then prints one JSON line of its kernel launches and host-inflated
    blocks."""
    import torch

    if not torch.cuda.is_available():
        print("FAILED: CUDA is not available", file=sys.stderr, flush=True)
        return 1
    sys.path.insert(0, HERE)
    import disq_tpu_torch as port
    from disq_tpu_torch.runtime import counters

    torch.zeros(1, device="cuda")  # the CUDA context, before the address
    handle = port.serve({"bam": spec["bam"]}, port=0, tenant_slots=64,
                        tenant_queue=256)
    daemon = handle.daemon
    orig = daemon.handle

    def handle_maybe_slow(method, path, doc):
        if path.startswith("/query/") and os.path.exists(spec["slow"]):
            time.sleep(SERVE_STALL_S)
        return orig(method, path, doc)

    daemon.handle = handle_maybe_slow
    print(f"ADDR {handle.address}", flush=True)
    sys.stdin.readline()
    snap = counters.snapshot()
    print(json.dumps({"launches": snap["launches"],
                      "host_fallback_blocks": snap["host_fallback_blocks"],
                      "device": str(daemon.device)}), flush=True)
    handle.close()
    return 0


class _Replica:
    """A ``serve_replica`` process on this card, started early so that it
    reaches the card while other legs run; its output in files under
    ``work``; stopped (or killed) on ``close``."""

    def __init__(self, work: str, name: str, spec: dict) -> None:
        self.out = os.path.join(work, f"serve_{name}.out")
        self.err = os.path.join(work, f"serve_{name}.err")
        self.slow = os.path.join(work, f"serve_{name}.slow")
        with open(self.out, "w") as out, open(self.err, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--serve-replica", json.dumps({**spec, "slow": self.slow})],
                stdin=subprocess.PIPE, stdout=out, stderr=err, cwd=HERE)

    def _lines(self) -> list:
        with open(self.out) as f:
            return f.read().splitlines()

    def address(self) -> str:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < SERVE_WAIT_S:
            for line in self._lines():
                if line.startswith("ADDR "):
                    return line.split()[1]
            if self.proc.poll() is not None:
                with open(self.err) as f:
                    raise PhaseError(f"a serve replica exited "
                                     f"{self.proc.returncode}: "
                                     f"{f.read()[-2000:]}")
            time.sleep(0.05)
        raise PhaseError(f"a serve replica named no address in "
                         f"{SERVE_WAIT_S}s")

    def result(self) -> dict:
        try:
            self.proc.stdin.close()
            rc = self.proc.wait(timeout=SERVE_WAIT_S)
        except subprocess.TimeoutExpired:
            raise PhaseError("a serve replica ran past its stop")
        lines = self._lines()
        if rc != 0 or not lines:
            raise PhaseError(f"a serve replica exited {rc}")
        return json.loads(lines[-1])

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def serve_legs(torch, port, args, g, perm_want, work) -> tuple:
    """The serving edge on the traversal phase's ``sorted.bam`` (BAI) and
    the variants phase's ``v.vcf.bgz`` (TBI). (a) One daemon in this
    process on ``cuda``: the config 13 traffic (``SERVE_REGIONS``
    regions of ``SERVE_SPAN`` bp, weight 1/rank) from closed-loop HTTP
    clients at each of ``SERVE_LEVELS``, cold then hot; cold again
    through the device service at 1 and 32 clients (traced requests, a
    ``SERVE_FLUSH_MS`` flush window); a cold pass under ``legacy``; then
    ``/query/variants`` over ``VCF_INTERVALS``, ``/query/stats``
    (flagstat, depth), ``/query/markdup-stats`` with ``rgstats`` and
    ``/query/filtered-count`` over ``SERVE_STATS`` and ``/query/pileup``
    over ``SERVE_PILEUP``. (b) A fleet of two replica processes on the
    card (this script with ``--serve-replica``) behind the router in this
    process: the config 13 traffic at ``SERVE_FLEET_CLIENTS`` clients,
    cold then hot; a leg while replica 2 stalls every query; a leg after
    replica 2 is killed. (c) Every answer against the port's traversal
    read of the same interval and a numpy oracle over the generator; B1
    once per request that missed the decoded tier (0 hot), fewer
    launches than such requests through the service at 32 clients, B4
    instead under ``legacy``, F1 once per filtered count, no block
    inflated on the host; the most-coalesced service launch against zlib
    and the plain version. Returns (per-kernel entries, e2e)."""
    import hashlib

    from disq_tpu_torch.bam.columnar import ReadBatch
    from disq_tpu_torch.ops import inflate_simd as B1
    from disq_tpu_torch.ops.markdup import markdup_batch
    from disq_tpu_torch.ops.rgstats import read_group_stats
    from disq_tpu_torch.runtime import counters, introspect, tracing
    from disq_tpu_torch.runtime import device_service as DS
    from disq_tpu_torch.runtime import serve as S

    split = args.split_size
    bam = os.path.join(work, "sorted.bam")
    vbgz = os.path.join(work, "v.vcf.bgz")
    regions, _ = serve_regions()
    contigs = [name for name, _ in REFS]
    # the replicas start now and reach the card during (a)
    replicas = [_Replica(work, name, {"bam": bam}) for name in ("r1", "r2")]
    handle = fleet = None
    entries, e2e, books = {}, {}, {}
    try:
        cols = {c: g[c][perm_want] for c in FIXED}
        span = cigar_extents(g)[0][perm_want]
        ends = cols["pos"].astype(np.int64) + np.maximum(span, 1)

        def oracle(contig, start, end):
            """Sorted rows overlapping 1-based ``[start, end]``."""
            return np.nonzero((cols["refid"] == contigs.index(contig))
                              & (cols["pos"] < end)
                              & (ends > start - 1))[0]

        def traversal(*intervals):
            """The port's indexed read of ``intervals`` (1-based, closed)
            as a host batch, and each interval's records in it, against
            the oracle."""
            got = port.ReadsStorage.make_default().split_size(split).read(
                bam, traversal=port.TraversalParameters(
                    [port.Interval(*iv) for iv in intervals]))
            rb = (getattr(got.reads, "to_read_batch", lambda: got.reads)()
                  if got.count() else ReadBatch.empty())
            rb_ends = rb.alignment_ends() if rb.count else np.zeros(0)
            out = []
            for contig, start, end in intervals:
                sub = rb.filter((rb.refid == contigs.index(contig))
                                & (rb.pos < end) & (rb_ends > start - 1))
                rows = oracle(contig, start, end)
                check(sub.count == len(rows)
                      and np.array_equal(sub.refid, cols["refid"][rows])
                      and np.array_equal(sub.pos, cols["pos"][rows]),
                      f"serve truth {contig}:{start}-{end}: {sub.count} "
                      f"records, oracle {len(rows)}")
                out.append((sub, rows))
            return out

        # one traversal read of the 64 regions, split per region
        t0 = time.perf_counter()
        truth = [(int(sub.count), S.ServeDaemon._batch_digest(sub))
                 for sub, _ in traversal(*[(c, s0 + 1, s0 + SERVE_SPAN)
                                           for c, s0 in regions])]
        truth_s = time.perf_counter() - t0

        def answers_ok(answers, errors, what):
            check(not errors, f"{what}: {errors[:3]}")
            for i, status, body in answers:
                check(status == 200, f"{what}: region {i} {status} {body}")
                check((body["count"], body["digest"]) == truth[i],
                      f"{what}: region {i} {regions[i]} answered "
                      f"{body['count']} {body['digest']}, want {truth[i]}")

        # -- (a) one daemon on cuda ------------------------------------------
        handle = port.serve({"bam": bam, "vcf": vbgz}, port=0,
                            tenant_slots=64, tenant_queue=256)
        daemon = handle.daemon
        addr = handle.address
        check(daemon.device.type == "cuda" and daemon.device_route,
              f"serve: the daemon runs on {daemon.device}")
        missed = []
        pending_orig = daemon._inflate_pending

        def pending_counted(ds_, pending, *rest):
            missed.append(len(pending))
            return pending_orig(ds_, pending, *rest)

        daemon._inflate_pending = pending_counted
        host0 = dict(B1.last_stats)
        host_blocks = 0
        levels, launches = {}, {}

        def leg(name, c, n_req, seed):
            nonlocal host_blocks
            counters.reset()
            missed.clear()
            lats, wall, answers, errors = closed_loop(
                addr, "/query/reads", c, n_req, seed)
            answers_ok(answers, errors, f"serve {name}")
            snap = counters.snapshot()
            host_blocks += sum(snap["host_fallback_blocks"].values())
            la = {k: v for k, v in snap["launches"].items() if v}
            row = {**latency_row(lats, wall), "missed": len(missed),
                   "missed_blocks": sum(missed), "launches": la}
            levels[name] = row
            launches[name] = la
            e2e[f"serve_{name}_s"] = round(wall, 4)
            log(f"serve {name}: {c} clients x {n_req}, {json.dumps(row)}")
            return row

        for c in SERVE_LEVELS:
            daemon.cache.clear()
            n_req = max(96, 24 * c) // c
            cold = leg(f"cold_c{c}", c, n_req, c)
            check(cold["missed"] > 0 and cold["launches"].get("inflate")
                  == cold["missed"] and "inflate_legacy" not in
                  cold["launches"],
                  f"serve cold_c{c}: launches {cold['launches']} for "
                  f"{cold['missed']} requests that missed")
            hot = leg(f"hot_c{c}", c, n_req, c)
            check(hot["missed"] == 0 and not hot["launches"],
                  f"serve hot_c{c}: launches {hot['launches']}, "
                  f"{hot['missed']} missed")

        # the device service: lanes of concurrent requests share launches
        os.environ[SERVICE_KNOB] = "1"
        os.environ[FLUSH_KNOB] = str(SERVE_FLUSH_MS)
        os.environ[TRACE_KNOB] = "1"
        tracing.reset_trace_state()
        service = {}
        try:
            with ChunkCapture(DS) as cap:
                for c in (1, 32):
                    DS.shutdown_service()
                    daemon.cache.clear()
                    tracing.reset_gauges()
                    f0 = _flushes(tracing)
                    r0 = dict(tracing.REGISTRY.counter(
                        "device.batch.requests")._snapshot())
                    row = leg(f"service_c{c}", c, max(96, 24 * c) // c,
                              99 + c)
                    row["flush"] = _delta(f0, _flushes(tracing))
                    row["lane_fill"] = tracing.REGISTRY.gauge(
                        "device.lane_fill").state()
                    row["batch_requests"] = _delta(r0, dict(
                        tracing.REGISTRY.counter(
                            "device.batch.requests")._snapshot()))
                    service[c] = row
                    b1 = row["launches"].get("inflate", 0)
                    check(row["missed"] > 0 and 0 < b1 <= row["missed"],
                          f"serve service_c{c}: B1 {b1} for "
                          f"{row['missed']} requests that missed")
                    log(f"serve service_c{c}: flushes "
                        f"{json.dumps(row['flush'])}, lane_fill "
                        f"{json.dumps(row['lane_fill'])}, requests per "
                        f"launch {json.dumps(row['batch_requests'])}")
        finally:
            os.environ.pop(SERVICE_KNOB, None)
            os.environ.pop(FLUSH_KNOB, None)
            os.environ.pop(TRACE_KNOB, None)
            tracing.reset_trace_state()
            DS.shutdown_service()
        c32 = service[32]
        shared = [int(k.split("=")[1].rstrip("}")) for k in
                  c32["batch_requests"]]
        check(c32["launches"]["inflate"] < c32["missed"]
              and max(shared, default=0) > 1,
              f"serve service_c32: {c32['launches']} launches for "
              f"{c32['missed']} requests that missed, requests per launch "
              f"{c32['batch_requests']}")
        check(service[1]["launches"]["inflate"] == service[1]["missed"],
              f"serve service_c1: {service[1]['launches']} for "
              f"{service[1]['missed']} requests")
        (owners, n_lanes), lanes, _, (blob, ln, st, oo) = cap.chunk("inflate")
        pls = [bytes(p) for p, _, _ in lanes]
        exp = [e for _, e, _ in lanes]
        check(not st.any() and np.array_equal(ln, exp),
              "serve service chunk: the dispatcher's B1 flagged a lane")
        for j, p in enumerate(pls):
            check(blob[oo[j]: oo[j + 1]].tobytes() == zlib.decompress(p, -15),
                  f"serve service chunk: B1 lane {j} differs from zlib")
        pick = _spread([o for _, _, o in lanes], PLAIN_SAMPLE_LANES)
        # the plain version's processes start and run beside the legs
        # below (their start alone takes seconds)
        import threading

        plain_box = []
        plain_thread = threading.Thread(target=lambda: plain_box.append(
            plain_async("inflate", [pls[j] for j in pick],
                        [exp[j] for j in pick])))
        plain_thread.start()
        k_sample = (np.concatenate([blob[oo[j]: oo[j + 1]] for j in pick]),
                    ln[pick], st[pick])
        staged = B1.Staged("inflate", [pls, np.concatenate(
            [[0], np.cumsum([len(p) for p in pls])[:-1]]).astype(np.int64),
            np.array([len(p) for p in pls], np.int64), oo], daemon.device)
        total = int(oo[-1])
        b1_ms = cuda_ms(torch, lambda: B1.inflate(*staged.tensors, total),
                        1, 5)
        torch.cuda.synchronize()
        staged.release()
        b1_bytes = sum(len(p) for p in pls) + total + 8 * (3 * n_lanes + 1)
        del blob, lanes

        # B4 under legacy
        os.environ["DISQ_TPU_TORCH_DEVICE_INFLATE"] = "legacy"
        try:
            daemon.cache.clear()
            row = leg("legacy", 1, SERVE_LEGACY_REQUESTS, 7)
        finally:
            os.environ.pop("DISQ_TPU_TORCH_DEVICE_INFLATE")
        check(row["launches"].get("inflate_legacy") == row["missed"] > 0
              and "inflate" not in row["launches"],
              f"serve legacy: launches {row['launches']} for "
              f"{row['missed']} requests that missed")

        # the other query paths
        def query(name, path, doc):
            counters.reset()
            missed.clear()
            t = time.perf_counter()
            status, body = post(addr, path, doc)
            secs = time.perf_counter() - t
            check(status == 200, f"serve {name}: {status} {body}")
            snap = counters.snapshot()
            la = {k: v for k, v in snap["launches"].items() if v}
            check(la.get("inflate", 0) == len(missed) and not sum(
                snap["host_fallback_blocks"].values()),
                  f"serve {name}: launches {la} for {len(missed)} "
                  f"requests that missed")
            launches[name] = la
            e2e[f"serve_{name}_s"] = round(secs, 4)
            return body, la

        def ivs(*intervals):
            return [{"contig": c, "start": s, "end": e}
                    for c, s, e in intervals]

        vst = port.VariantsStorage.make_default().split_size(VCF_SPLIT)
        for name, sel in [(f"variants_{iv[0]}", [iv]) for iv in VCF_INTERVALS] \
                + [("variants_all", list(VCF_INTERVALS))]:
            body, _ = query(name, "/query/variants",
                            {"dataset": "vcf", "limit": 0,
                             "intervals": ivs(*sel)})
            want = vst.read(vbgz, intervals=[port.Interval(*iv)
                                             for iv in sel]).variants
            h = hashlib.sha1()
            for col in (want.chrom, want.pos, want.lines):
                h.update(col.tobytes())
            check(body["count"] == int(want.count) > 0
                  and body["digest"] == h.hexdigest(),
                  f"serve {name}: {body['count']} sites, want "
                  f"{int(want.count)} (the tabix read)")
        (rb, rows), = traversal(SERVE_STATS)
        body, _ = query("flagstat", "/query/stats",
                        {"dataset": "bam", "stat": "flagstat",
                         "intervals": ivs(SERVE_STATS)})
        check(body["flagstat"] == numpy_flagstat(cols["flag"][rows]),
              f"serve flagstat: {body['flagstat']}")
        body, _ = query("depth", "/query/stats",
                        {"dataset": "bam", "stat": "depth", "window": 1024,
                         "intervals": ivs(SERVE_STATS)})
        src_rows = perm_want[rows]
        want_depth = numpy_depth({k: g[k][src_rows] for k in (
            "cig", "ncig", "pos", "flag", "refid")}, 1024)
        check(body["depth"]["refs"] == {
            REFS[r][0]: {"windows": len(a), "max": int(a.max()),
                         "total": int(a.sum())}
            for r, a in want_depth.items()},
              f"serve depth: {body['depth']}")
        body, _ = query("markdup", "/query/markdup-stats",
                        {"dataset": "bam", "rgstats": True,
                         "intervals": ivs(SERVE_STATS)})
        marked, res = markdup_batch(rb)
        want = json.loads(json.dumps({"markdup": res.stats(),
                                      "rgstats": read_group_stats(marked)},
                                     default=str))
        check(body["count"] == len(rows)
              and {k: body[k] for k in want} == want,
              f"serve markdup: {body['markdup']} != {want['markdup']}")
        body, la = query("filtered_count", "/query/filtered-count",
                         {"dataset": "bam", "filter": OPS_FILTER,
                          "intervals": ivs(SERVE_STATS)})
        names = g["names"][src_rows]
        keep = (((cols["flag"][rows] & 0x904) == 0)
                & (cols["mapq"][rows] >= 20)
                & subsample_keep(fnv1a_rows(names), 7, 0.5))
        check(body["matched"] == int(keep.sum()) > 0
              and la.get("read_filter") == 1,
              f"serve filtered count: {body['matched']} matched, numpy "
              f"{int(keep.sum())}; launches {la}")
        p_rows = oracle(*SERVE_PILEUP)
        body, _ = query("pileup", "/query/pileup",
                        {"dataset": "bam", "intervals": ivs(SERVE_PILEUP)})
        lo0, hi0 = SERVE_PILEUP[1] - 1, SERVE_PILEUP[2]
        sel = p_rows[(cols["flag"][p_rows] & 4) == 0]
        b_lo = np.clip(cols["pos"][sel] - lo0, 0, hi0 - lo0 - 1)
        b_hi = np.clip(ends[sel] - 1 - lo0, 0, hi0 - lo0 - 1)
        diff = np.zeros(hi0 - lo0 + 1, np.int64)
        np.add.at(diff, b_lo, 1)
        np.add.at(diff, b_hi + 1, -1)
        cov = np.cumsum(diff)[:-1]
        check(body["coverage"] == cov.tolist() and cov.max() > 0,
              "serve pileup: coverage differs from the numpy difference "
              "array")
        host_blocks += sum(counters.snapshot()["host_fallback_blocks"]
                           .values())
        host_lanes = {k: B1.last_stats[k] - host0[k]
                      for k in ("host_big", "host_fallback")}
        check(host_blocks == 0 and not any(host_lanes.values()),
              f"serve: blocks inflated on the host: {host_blocks}, "
              f"{host_lanes}")
        card = card_line()
        log(f"serve levels ({card}): " + json.dumps({
            k: {m: v[m] for m in ("p50_ms", "p99_ms", "qps")}
            for k, v in levels.items()}))

        # -- (b) the fleet -----------------------------------------------------
        t0 = time.perf_counter()
        addrs = [r.address() for r in replicas]
        log(f"serve: truth read {truth_s:.3f}s; the replicas' addresses "
            f"after {time.perf_counter() - t0:.3f}s more")
        fleet = port.serve_fleet(addrs, datasets={"bam": bam},
                                 refresh_s=0.25)
        check(fleet.address == addr, "the router is not on this endpoint")
        fleet_rows = {}

        def fleet_leg(name, seed):
            h0 = {k: tracing.counter(k).total()
                  for k in ("hedge.launched", "fleet.hedge.launched")}
            r0 = {r: tracing.counter("fleet.route").value(result=r)
                  for r in ("hit", "miss")}
            lats, wall, answers, errors = closed_loop(
                addr, "/fleet/query/reads", SERVE_FLEET_CLIENTS,
                max(96, 24 * SERVE_FLEET_CLIENTS) // SERVE_FLEET_CLIENTS,
                seed)
            answers_ok(answers, errors, f"fleet {name}")
            row = latency_row(lats, wall)
            row["routes"] = {r: tracing.counter("fleet.route").value(
                result=r) - r0[r] for r in r0}
            row.update({k: tracing.counter(k).total() - v
                        for k, v in h0.items()})
            row["routed"] = {r["endpoint"]: r["routed"]
                             for r in fleet.stats()["replicas"]}
            fleet_rows[name] = row
            e2e[f"fleet_{name}_s"] = round(wall, 4)
            log(f"fleet {name}: {json.dumps(row)}")
            return row

        fleet_leg("cold", SERVE_FLEET_CLIENTS)
        hot = fleet_leg("hot", SERVE_FLEET_CLIENTS)
        check(hot["routes"]["hit"] > hot["routes"]["miss"],
              f"fleet hot: routes {hot['routes']}: most not by locality")
        with open(replicas[1].slow, "w"):
            pass
        try:
            stall = fleet_leg("stall", 80)
        finally:
            os.remove(replicas[1].slow)
        check(stall["hedge.launched"] >= 1
              and stall["fleet.hedge.launched"] >= 1,
              f"fleet stall: no hedge launched ({stall})")
        replicas[1].close()  # SIGKILL
        kill = fleet_leg("kill", 81)
        st = fleet.stats()
        dead = [r for r in st["replicas"] if r["endpoint"] == addrs[1]]
        check(st["live"] == 1 and dead and not dead[0]["alive"]
              and kill["routed"][addrs[1]] == stall["routed"][addrs[1]],
              f"fleet kill: {st}")
        fleet.close()
        fleet = None
        survivor = replicas[0].result()
        check(survivor["launches"].get("inflate", 0) > 0
              and not sum(survivor["host_fallback_blocks"].values())
              and survivor["device"].startswith("cuda"),
              f"fleet: the surviving replica {survivor}")
        plain_thread.join()
        (p_blob, p_len, p_st), b1_plain_ms, _procs = plain_box[0]()
        mism = int((k_sample[0] != p_blob).sum()
                   + (k_sample[1] != p_len).sum()
                   + (k_sample[2] != p_st).sum())
        check(mism == 0, f"serve service chunk: B1 != plain version ({mism})")
        entries = {
            "inflate": {
                "launches_on_serve": {k: v.get("inflate", 0)
                                      for k, v in launches.items()},
                "launches_on_serve_replica": survivor["launches"].get(
                    "inflate", 0),
                "serve_chunk": {
                    "lanes": n_lanes, "owners": owners, "bytes_out": total,
                    "ms": round(b1_ms, 4),
                    "bound_ms": round(b1_bytes / HBM_BYTES_PER_S * 1e3, 6),
                    "lanes_against_zlib": n_lanes,
                    "plain_sample_lanes": len(pick),
                    "plain_ms_on_sample": round(b1_plain_ms, 4),
                    "mismatches": mism}},
            "inflate_legacy": {"launches_on_serve": {
                "legacy": launches["legacy"].get("inflate_legacy", 0)}},
            "read_filter": {"launches_on_serve": {
                "filtered_count": launches["filtered_count"].get(
                    "read_filter", 0)}},
        }
        e2e.update(serve_truth_s=round(truth_s, 4), serve_levels=levels,
                   fleet=fleet_rows)
        routes = {k: v["routes"] for k, v in fleet_rows.items()}
        log(f"serve: {SERVE_REGIONS} regions, every answer equal to the "
            f"traversal read and the oracle; fleet routes "
            f"{json.dumps(routes)}; kernels {json.dumps(entries)}")
    finally:
        if fleet is not None:
            fleet.close()
        for r in replicas:
            r.close()
        if handle is not None:
            handle.close()
        introspect.reset_introspection()
    return entries, e2e


MESH_SHARDS = 8               # the mesh phase's shards on the one card
MESH_PILEUP = (0, 1_000_000, 1_250_000)   # refid, start, end
MESH_KEYS = 2_000_000            # u64 keys of the sharded sorts


def mesh_legs(torch, port, args, g, perm_want, fstat, ds, src, dst, work,
              n_splits) -> tuple:
    """The mesh phase (module docstring), with the forced device count
    set only inside it. Returns the launches of the meshed read and the
    phase's end-to-end numbers."""
    from disq_tpu_torch.ops.pileup import region_pileup
    from disq_tpu_torch.runtime import counters, tracing
    from disq_tpu_torch.runtime import mesh as M
    from disq_tpu_torch.runtime.columnar import coordinate_key
    from disq_tpu_torch.runtime.multihost import global_mesh
    from disq_tpu_torch.sort import sharded as SS

    e2e = {}
    os.environ[M.FORCE_ENV] = str(MESH_SHARDS)
    try:
        # (a) the meshed read
        st = port.ReadsStorage.make_default().split_size(args.split_size) \
            .mesh(MESH_SHARDS)
        tracing.reset_telemetry()
        counters.reset()
        t0 = time.perf_counter()
        mds = st.read(src)
        torch.cuda.synchronize()
        e2e["mesh_read_s"] = round(time.perf_counter() - t0, 4)
        books = counters.snapshot()["launches"]
        mb = mds.reads
        check(mb.device_backed and mb.mesh is not None
              and M.shard_count(mb.mesh) == MESH_SHARDS,
              f"mesh (a): the read is not on an {MESH_SHARDS}-shard mesh")
        shards = mb.shard_columns()["pos"]
        check([int(t.numel()) for t in shards]
              == [hi - lo for lo, hi in M.shard_bounds(mb.count,
                                                       MESH_SHARDS)],
              "mesh (a): shard sizes")
        batches = tracing.REGISTRY.counter("device.mesh.batches").total()
        check(books.get("inflate", 0) == n_splits
              and books.get("parse", 0) == MESH_SHARDS * n_splits
              and batches == n_splits,
              f"mesh (a): launches {books}, mesh batches {batches}, want B1 "
              f"= {n_splits}, B2 = {MESH_SHARDS} x {n_splits}")
        for col in FIXED:
            got = getattr(mb, col)
            check(np.array_equal(got, g[col]), f"mesh (a): column {col}")
            check(np.array_equal(got, getattr(ds.reads, col)),
                  f"mesh (a): column {col} vs the unmeshed read")
        log(f"mesh (a) read: {e2e['mesh_read_s']}s, {mb.count} reads on "
            f"{MESH_SHARDS} shards, columns equal the unmeshed read's; "
            f"launches {json.dumps(books)}")

        # (b) the reductions
        t0 = time.perf_counter()
        m_fs = mds.flagstat()
        m_depth = mds.depth(1024)
        m_pile = region_pileup(mb, *MESH_PILEUP)
        torch.cuda.synchronize()
        e2e["mesh_reductions_s"] = round(time.perf_counter() - t0, 4)
        check(m_fs == fstat, f"mesh (b): flagstat {m_fs}")
        u_depth = ds.depth(1024)
        check(sorted(m_depth) == sorted(u_depth) and all(
            np.array_equal(m_depth[r], u_depth[r]) for r in u_depth),
            "mesh (b): depth")
        check(np.array_equal(m_pile, region_pileup(ds.reads, *MESH_PILEUP)),
              "mesh (b): region pileup")
        log(f"mesh (b) flagstat, depth(1024), pileup {MESH_PILEUP}: "
            f"{e2e['mesh_reductions_s']}s, each equal to the unmeshed "
            f"result")

        # (c) the resident sort
        t0 = time.perf_counter()
        m_perm = mb.sort_permutation()
        e2e["mesh_sort_permutation_s"] = round(time.perf_counter() - t0, 4)
        cols = ds.reads.device_columns()
        want = torch.sort(coordinate_key(cols["refid"], cols["pos"]),
                          stable=True).indices.cpu().numpy()
        check(np.array_equal(m_perm, want) and np.array_equal(m_perm,
                                                              perm_want),
              "mesh (c): the resident sort's permutation")
        exch = tracing.REGISTRY.counter("device.mesh.exchange_bytes").total()
        check(exch > 0, "mesh (c): no exchange booked")
        log(f"mesh (c) resident_coordinate_sort: "
            f"{e2e['mesh_sort_permutation_s']}s, equal to torch.sort"
            f"(stable=True) of the unmeshed keys; exchange {exch} bytes")

        # (d) the sorted write from the meshed batch
        out = os.path.join(work, "mesh_sorted.bam")
        t0 = time.perf_counter()
        st.write(mds, out, port.BaiWriteOption.ENABLE, sort=True)
        e2e["mesh_sort_write_s"] = round(time.perf_counter() - t0, 4)
        for ext in ("", ".bai"):
            with open(out + ext, "rb") as a, open(dst + ext, "rb") as b:
                check(a.read() == b.read(),
                      f"mesh (d): sorted BAM{ext} differs from the main "
                      "path's")
        log(f"mesh (d) sorted BAM + BAI: {e2e['mesh_sort_write_s']}s, "
            f"byte-identical to the main path's")
        del mds, mb, cols, shards

        # (e) the sharded sorts of u64 keys
        rng = np.random.default_rng(args.seed + 16)
        keysets = {
            "uniform": rng.integers(0, 1 << 62, MESH_KEYS, dtype=np.uint64),
            "skewed": np.where(
                rng.random(MESH_KEYS) < 0.9, np.uint64(42),
                rng.integers(0, 1 << 60, MESH_KEYS, dtype=np.uint64))}
        flat = SS.make_mesh(MESH_SHARDS)
        grid = np.empty((2, MESH_SHARDS // 2), dtype=object)
        for i, d in enumerate(flat.devices.flat):
            grid.flat[i] = d
        grid = M.Mesh(grid, ("dcn", "shards"))
        for kind, keys in keysets.items():
            want = np.argsort(keys, kind="stable")
            for how, fn in (
                    ("flat", lambda k: SS.sharded_coordinate_sort(k, flat)),
                    ("2x4", lambda k: SS.hierarchical_coordinate_sort(
                        k, grid))):
                before = tracing.REGISTRY.counter(
                    "device.mesh.exchange_bytes").total()
                t0 = time.perf_counter()
                got_keys, got = fn(keys)
                secs = time.perf_counter() - t0
                moved = tracing.REGISTRY.counter(
                    "device.mesh.exchange_bytes").total() - before
                check(np.array_equal(got, want)
                      and np.array_equal(got_keys, keys[want]),
                      f"mesh (e): {how} sort of {kind} keys")
                check(moved > 0, f"mesh (e): {how} {kind}: no exchange")
                e2e[f"mesh_sort_{how}_{kind}_s"] = round(secs, 4)
        log(f"mesh (e) sharded sorts of {MESH_KEYS} u64 keys: " + ", ".join(
            f"{k[10:-2]} {v}s" for k, v in e2e.items()
            if k.startswith("mesh_sort_") and "permutation" not in k
            and "write" not in k) + "; each equal to a stable sort")

        # (f) markdup on dups.bam, on and off the mesh
        dups = os.path.join(work, "dups.bam")
        marked = {}
        for leg, storage in (("mesh", port.ReadsStorage.make_default()
                              .split_size(args.split_size)
                              .mesh(MESH_SHARDS)),
                             ("single", port.ReadsStorage.make_default()
                              .split_size(args.split_size))):
            t0 = time.perf_counter()
            d = storage.read(dups)
            check((d.reads.mesh is not None) == (leg == "mesh"),
                  f"mesh (f): the {leg} read's mesh")
            d2, stats = d.pipeline("sort", "markdup")
            e2e[f"mesh_markdup_{leg}_s"] = round(time.perf_counter() - t0, 4)
            marked[leg] = (np.asarray(d2.reads.flag),
                           stats["markdup"]["duplicates"])
            del d, d2
        check(np.array_equal(marked["mesh"][0], marked["single"][0])
              and marked["mesh"][1] == marked["single"][1] > 0,
              "mesh (f): markdup on the mesh differs from it off the mesh")
        log(f"mesh (f) markdup on dups.bam: {marked['mesh'][1]} duplicates "
            f"on and off the mesh, flags equal; read + sort + markdup "
            f"{e2e['mesh_markdup_mesh_s']}s on the mesh, "
            f"{e2e['mesh_markdup_single_s']}s off it")

        # (g) the global mesh of this one process
        gm = global_mesh()
        check(gm.shape == {"dcn": 1, "shards": MESH_SHARDS},
              f"mesh (g): global_mesh shape {gm.shape}")
        parts = [torch.full((4,), float(i + 1), device=d)
                 for i, d in enumerate(gm.local_devices)]
        total = float(MESH_SHARDS * (MESH_SHARDS + 1) // 2)
        layered = M.psum(M.psum(parts, gm, "shards"), gm, "dcn")
        both = M.psum(parts, gm, ("dcn", "shards"))
        check(all(bool((t == total).all()) for t in layered + both),
              "mesh (g): psum over both axes")
        log(f"mesh (g) global_mesh: shape {gm.shape}, psum over both axes "
            f"{total}")
        log("mesh dcn: not run: the cross-process dcn axis needs one "
            "process per card (NCCL puts no two ranks on one GPU), and this "
            "machine has one card")
    finally:
        os.environ.pop(M.FORCE_ENV, None)
        M.reset_mesh()
    return {"inflate": books.get("inflate", 0),
            "parse": books.get("parse", 0)}, e2e


# -- the chaos soak ----------------------------------------------------------

# The master seed: the lowest whose first 8 iterations draw all four
# policies, flip the DEFLATE payload (+20) under skip and quarantine, and
# the block header (+1) and the payload under strict. A header flip under
# skip or quarantine sends the boundary guesses of the splits around it
# through the salvage walk, whose ~400 small reads a walk each draw the
# hedge's slow tail: 30-230 s of injected sleep an iteration at 5,000
# records, in the reference's soak as in this one (tier-1 runs such
# seeds on the CPU at 200 records).
CHAOS_SEED = 23
CHAOS_ITERATIONS = 8
CHAOS_RECORDS = 5_000
# The steal, coordinator-failover and fleet legs run on the CPU in tier-1
# only: their child processes take 46 s on the card at this size (the
# steal leg's straggler, slowed 0.6 s a read, does not even plan its
# splits within the leg's 120 s), more than the phase can hold.
CHAOS_LEGS = ("breaker", "resident", "ops", "device-write", "kill", "serve")
# the kernels the phase must launch in this process, and the leg that
# launches each for sure
CHAOS_KERNELS = {"inflate": "main", "parse": "main",
                 "read_filter": "ops", "record_gather": "device-write",
                 "deflate": "device-write"}


def chaos_legs(torch, work) -> tuple:
    """The port's chaos soak (``scripts/torch_chaos_soak.py``) imported
    and run in this process on the card: ``CHAOS_ITERATIONS`` seeded
    fault schedules at 4 executor and 4 writer workers with the watchdog
    and hedged fetches (strict raises at the flipped block, skip and
    quarantine lose one block, recover equals the host route's read,
    every write-back byte-identical to a host-route write), then every
    leg in ``CHAOS_LEGS``, each held against the host route on the CPU.
    Returns the kernel launches of the phase (in all and per leg) and
    the e2e fields."""
    import importlib.util

    from disq_tpu_torch.runtime import counters

    spec = importlib.util.spec_from_file_location(
        "torch_chaos_soak", os.path.join(HERE, "scripts",
                                         "torch_chaos_soak.py"))
    soak = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(soak)
    chaos_dir = os.path.join(work, "chaos")
    os.makedirs(chaos_dir, exist_ok=True)
    argv = ["--iterations", str(CHAOS_ITERATIONS),
            "--records", str(CHAOS_RECORDS), "--seed", str(CHAOS_SEED),
            "--work-dir", chaos_dir, "--executor-workers", "4",
            "--writer-workers", "4", "--watchdog", "--hedge"]
    argv += [f"--{leg}" for leg in CHAOS_LEGS]
    counters.reset()
    t0 = time.perf_counter()
    rc = soak.main(argv)
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t0
    total = counters.snapshot()["launches"]
    res = soak.RESULTS
    legs_s = {k: round(v, 4) for k, v in res["legs"].items()}
    log(f"chaos: {CHAOS_ITERATIONS} iterations of {CHAOS_RECORDS} records "
        f"at seed {CHAOS_SEED}, {len(res['failures'])} mismatches, "
        f"{phase_s:.3f}s, legs {json.dumps(legs_s)}, launches "
        f"{json.dumps(res['launches'])}, in all {json.dumps(total)}")
    check(rc == 0, f"chaos: {len(res['failures'])} mismatches: "
          f"{res['failures'][:3]}")
    check(res["device"] == "cuda", f"chaos ran on {res['device']}")
    policies = res["policies"]
    log(f"chaos seeds: {json.dumps({str(k): v for k, v in policies.items()})}")
    check(set(policies.values()) == {"strict", "skip", "quarantine",
                                     "recover"},
          f"chaos: policies drawn {sorted(set(policies.values()))}")
    for name, leg in CHAOS_KERNELS.items():
        check(total.get(name, 0) > 0 and
              res["launches"].get(leg, {}).get(name, 0) > 0,
              f"chaos: {name} not launched on the {leg} leg "
              f"({json.dumps(res['launches'])})")
    launches = {name: {"total": total.get(name, 0),
                       **{leg: books[name]
                          for leg, books in res["launches"].items()
                          if name in books}}
                for name in CHAOS_KERNELS}
    return launches, {"chaos_s": round(phase_s, 4), "chaos_legs_s": legs_s}


def run_phase() -> int:
    """``--phase chaos``: one phase alone on the card, a probe (the
    kernels built, the host library loaded, the phase's lines printed,
    no result line)."""
    import torch

    if not torch.cuda.is_available():
        print("FAILED: CUDA is not available", file=sys.stderr, flush=True)
        return 1
    sys.path.insert(0, HERE)
    from disq_tpu_torch.native import _load as load_host_library
    from disq_tpu_torch.ops import cuda_build

    log(f"card: {card_line()}")
    torch.zeros(1, device="cuda")
    load_host_library()
    cuda_build.build(list(CHAOS_KERNELS))
    work = os.path.join(HERE, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        t0 = time.perf_counter()
        launches, e2e = chaos_legs(torch, work)
        log(f"phase chaos: {time.perf_counter() - t0:.3f}s; launches "
            f"{json.dumps(launches)}; {json.dumps(e2e)}")
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


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
    t_run = time.perf_counter()
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
    head = {k: head[k] for k in ("path", "offsets", "records", "counters",
                                 "reads")}
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
    service, svc_e2e, b3_service_plain = service_legs(
        torch, port, args, g, perm_want, info, ds, src, work, dev, head)
    log(f"phase device service: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    traced = trace_leg(torch, port, args, src, work)
    log(f"phase trace: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    f1_entry, operators_e2e = operator_legs(torch, port, args, work, dev)
    kernels.append(f1_entry)
    log(f"phase operators: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    traversal, traversal_e2e = traversal_legs(torch, port, args, g,
                                              perm_want, work)
    log(f"phase traversal: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    variants, variants_e2e = variants_legs(torch, port, args, g, perm_want,
                                           ds, work)
    log(f"phase variants: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    planes, planes_e2e = plane_legs(torch, port, args, g, info, ds, src, work)
    log(f"phase planes: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    sched, sched_e2e = sched_legs(torch, port, args, g, info, ds, src, work,
                                  head)
    log(f"phase sched: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    served, serve_e2e = serve_legs(torch, port, args, g, perm_want, work)
    log(f"phase serve: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    meshed, mesh_e2e = mesh_legs(torch, port, args, g, perm_want, fstat, ds,
                                 src, dst, work, n_splits)
    log(f"phase mesh: {time.perf_counter() - t0:.3f}s")
    t0 = time.perf_counter()
    chaos, chaos_e2e = chaos_legs(torch, work)
    log(f"phase chaos: {time.perf_counter() - t0:.3f}s")
    spans["cram_read"] = cram_e2e.pop("spans")
    log(f"spans: {json.dumps(spans)}")
    log(f"hbm: {json.dumps(hbm)}")
    by_name = {k["name"]: k for k in kernels}
    t0 = time.perf_counter()
    b3_service_plain()
    log(f"joined the service chunk's B3 plain sample: waited "
        f"{time.perf_counter() - t0:.3f}s")
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
    for name, key in (("inflate", "inflate"), ("parse", "parse"),
                      ("read_filter", "read_filter")):
        by_name[name]["launches_on_traversal"] = {
            leg: books[key] for leg, books in traversal.items()
            if key in books}
    by_name["rans_simd"]["launches_on_traversal"] = traversal["cram"]
    for name in ("inflate", "inflate_legacy", "deflate"):
        by_name[name]["launches_on_variants"] = {
            leg: books[name] for leg, books in variants.items()
            if name in books}
    for name in ("inflate", "parse"):
        by_name[name]["launches_on_planes"] = {
            leg: books.get(name, 0) for leg, books in planes.items()}
    for name in ("inflate", "parse", "rans_simd"):
        by_name[name]["launches_on_sched"] = {
            leg: books.get(name, 0) for leg, books in sched.items()}
    for name, entry in served.items():
        by_name[name].update(entry)
    for name in ("inflate", "parse"):
        by_name[name]["launches_on_mesh"] = meshed[name]
    for name, books in chaos.items():
        by_name[name]["launches_on_chaos"] = books
    e2e = {"records": n, "decoded_bytes": info["decoded_bytes"],
           "read_s": round(read_s, 4), "sort_write_s": round(write_s, 4),
           "read_records_per_s": round(n / read_s, 1),
           "sort_write_records_per_s": round(n / write_s, 1),
           "splits": n_splits, **legs_e2e, **cram_e2e, **write_e2e,
           **resume_e2e, **ops_e2e, **dw_e2e, **svc_e2e, **operators_e2e,
           **traversal_e2e, **variants_e2e, **planes_e2e, **sched_e2e,
           **serve_e2e, **mesh_e2e, **chaos_e2e,
           "traced_read": traced, **hbm,
           "build_s": {k: round(v, 3) for k, v in build_s.items()}}
    log(f"e2e: {json.dumps(e2e)}")
    shutil.rmtree(work, ignore_errors=True)
    log(f"whole run: {time.perf_counter() - t_run:.1f}s from the CUDA "
        "context, kernel builds included")
    return {"card": card, "kernels": kernels,
            "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                       "count": torch.cuda.device_count()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--records", type=int, default=2_000_000)
    ap.add_argument("--split-size", type=int, default=64 << 20)
    # the sched phase's second process (a JSON spec): see sched_worker
    ap.add_argument("--sched-worker", help=argparse.SUPPRESS)
    # a fleet replica of the serve phase (a JSON spec): see serve_replica
    ap.add_argument("--serve-replica", help=argparse.SUPPRESS)
    ap.add_argument("--phase", choices=("chaos",),
                    help="run only this phase, as a probe (no result line)")
    args = ap.parse_args(argv)
    if args.sched_worker:
        return sched_worker(json.loads(args.sched_worker))
    if args.serve_replica:
        return serve_replica(json.loads(args.serve_replica))
    if args.phase:
        return run_phase()
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
