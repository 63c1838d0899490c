"""Whole CRAM-to-BAM conversion jobs, one at a time in a closed loop:
read the coordinate-sorted CRAM with its reference and write it as BAM
with its BAI, ``st.write(st.read(cram), out, BaiWriteOption.ENABLE)``
(no sort), with the configuration's split size, executor workers, write
shards and writer workers. ``write_rate`` is all records of all jobs
over the time from the first job's start to the last job's end;
``write_size_ratio`` the written file's and index's bytes per byte of
the truth's BAM records. Each job's index has to count the truth's
records per reference and unplaced; the file of a job drawn from the
seed is set aside and judged whole: its records byte for byte against
the truth's (the generator's, which the program never reads), its
index by what the index means (``reference/bai.py``'s ``violations``).

Each job's read features and attached mates, from the program's
``cram.features{code}`` and ``cram.mates{kind}`` counters, are logged
and kept in the window's facts.

``control(ctx)`` is the cell's control: the truth written as BAM with
every base an ``X`` feature substitutes put back to the reference base,
as a decoder that ignored ``X`` would write it."""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.generators import cram_htslib, reads_bam
from benchmark.harness.core import log
from benchmark.jobs import common
from benchmark.reference import bai, bam
from benchmark.reference import cram as ref_cram

WARM_RECORDS = 20_000
COMPARE_BLOCK = 200_000


def _storage(ctx):
    return common.storage(ctx).reference_source_path(
        ctx.inputs["reference"])


def _host(ds):
    reads = ds.reads
    return reads.to_read_batch() if hasattr(reads, "to_read_batch") else reads


def _books():
    """The program's CRAM books: X features and attached records (0
    where the program has no such counter)."""
    from disq_tpu_torch.runtime.tracing import REGISTRY

    return (REGISTRY.counter("cram.features").value(code="X"),
            REGISTRY.counter("cram.mates").value(kind="attached"))


def setup(ctx):
    """Warm up one full read, then a write of its first 20,000 records:
    the write builds no kernel, so its full-size deflate would only
    lengthen set-up."""
    st = _storage(ctx)
    out = os.path.join(ctx.work, "out.bam")
    ds = st.read(ctx.inputs["path"])
    n = ds.count()
    head = type(ds)(header=ds.header,
                    reads=_host(ds).take(np.arange(min(WARM_RECORDS, n))),
                    device=ds.device)
    st.write(head, out, ctx.port.BaiWriteOption.ENABLE)
    ctx.sync()
    del ds, head
    state = {"storage": st, "out": out, "bytes": {}}
    if ctx.trace:
        # the order-0 rANS blocks B3 decodes, each byte once per read
        blocks = [b for c in ref_cram.walk(ctx.inputs["path"])
                  for b in c["block_list"] if b["method"] == 4
                  and b["order"] == 0 and b["raw_size"] > 0]
        state["bytes"] = {"rans0_bytes": sum(b["comp_size"] + b["raw_size"]
                                             for b in blocks),
                          "rans0_streams": len(blocks)}
    return state


def window(ctx, state, seconds):
    st, src, out = state["storage"], ctx.inputs["path"], state["out"]
    kept = os.path.join(ctx.work, "kept.bam")
    sample = common.Sample(ctx.seed)
    sizes, indexes, books = [], [], []

    def one_pass(i):
        x0, a0 = _books()
        ds = st.read(src)
        n = ds.count()
        st.write(ds, out, ctx.port.BaiWriteOption.ENABLE)
        del ds
        ctx.sync()
        x1, a1 = _books()
        books.append((x1 - x0, a1 - a0))
        with open(out + ".bai", "rb") as f:
            indexes.append(f.read())
        sizes.append(os.path.getsize(out) + len(indexes[-1]))
        if sample.offer(i, None):
            os.replace(out, kept)
            os.replace(out + ".bai", kept + ".bai")
        return n

    loop = common.timed_loop(ctx, seconds, one_pass)
    total = sum(loop["records"])
    for (x, a), n in zip(books, loop["records"]):
        log(f"job: {n} records, cram.features{{code=X}} {x:.0f}, "
            f"cram.mates{{kind=attached}} {a:.0f} ({100 * a / max(n, 1):.2f} %)")
    state["judged"] = [kept]
    return {"attempted": loop["passes"], "failed": 0,
            "e2e": {"write_rate": total / loop["elapsed"],
                    "write_size_ratio": sum(sizes) / (
                        ctx.inputs["record_bytes"] * loop["passes"])},
            "counts": loop["records"], "indexes": indexes,
            "facts": {"records": total, "passes": loop["passes"],
                      "x_features": [b[0] for b in books],
                      "attached": [b[1] for b in books],
                      **state["bytes"]}}


def release(state):
    state.pop("storage", None)


def mismatched(truth: dict, out) -> int:
    """Records of the decoded BAM ``out`` whose bytes differ from the
    truth's records in order, the truth encoded a block of records at
    a time; a record one side lacks counts."""
    n = len(truth["refid"])
    bad = abs(n - out.count)
    for lo in range(0, min(n, out.count), COMPARE_BLOCK):
        hi = min(n, out.count, lo + COMPARE_BLOCK)
        want, off = cram_htslib.bam_records(cram_htslib.take(truth, lo, hi))
        got = out.raw[int(out.start[lo]):int(out.end[hi - 1])]
        if got == want.tobytes():
            continue
        for i in range(hi - lo):
            a = out.raw[int(out.start[lo + i]):int(out.end[lo + i])]
            bad += int(a != want[off[i]:off[i + 1]].tobytes())
    return bad


def verify(ctx, state, win):
    truth = ctx.inputs["truth"]
    wrong = sum(1 for n in win["counts"] if n != ctx.inputs["records"])
    want = ctx.inputs["index_counts"]
    counted = 0
    for data in win.get("indexes", []):
        try:
            counted += int(bai.record_counts(data) != want)
        except ValueError:
            counted += 1
    bad = header = index = 0
    for path in state["judged"]:
        out = bam.decode_path(path)
        header += int(out.header_text != ctx.inputs["header_text"]
                      or out.refs != ctx.inputs["refs"])
        bad += mismatched(truth, out)
        with open(path + ".bai", "rb") as f:
            index += bai.violations(out, f.read())
        del out
    return {"jobs_wrong_count": {"value": wrong, "limit": 0},
            "indexes_wrong_count": {"value": counted, "limit": 0},
            "headers_wrong": {"value": header, "limit": 0},
            "records_mismatched": {"value": bad, "limit": 0},
            "bai_faults": {"value": index, "limit": 0}}


def _bam_header(text: str, refs) -> bytes:
    tb = text.encode()
    out = b"BAM\x01" + struct.pack("<i", len(tb)) + tb + \
        struct.pack("<i", len(refs))
    for name, ln in refs:
        nb = name.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
    return out


def write_bam(path: str, header: bytes, records: np.ndarray) -> None:
    """A BAM of the header and the record bytes in 65,280-byte zlib-6
    blocks, with the reference's BAI beside it."""
    step = reads_bam.MAX_PAYLOAD
    data = memoryview(records.tobytes())
    with open(path, "wb") as f, ThreadPoolExecutor(reads_bam.THREADS) as pool:
        f.write(reads_bam.bgzf_block(header))
        for block in pool.map(lambda o: reads_bam.bgzf_block(
                data[o:o + step]), range(0, len(data), step)):
            f.write(block)
        f.write(reads_bam.EOF_BLOCK)
    with open(path + ".bai", "wb") as f:
        f.write(bai.build(bam.decode_path(path)))


def control(ctx) -> dict:
    """What the control hands to ``verify`` in the window's place: the
    truth with every ``X``-substituted base read from the reference."""
    truth = ctx.inputs["truth"]
    with open(ctx.inputs["reference"], "rb") as f:
        f.readline()
        ref = np.frombuffer(f.read().replace(b"\n", b""), np.uint8)
    ((_, length),) = ctx.inputs["refs"]
    ref = ref[:length]
    r = dict(truth)
    r["pos"] = np.where(truth["refid"] >= 0, truth["pos"], 0)
    f = cram_htslib.features(r, ref)
    x = f["code"] == ord("X")
    seqs = truth["seqs"].copy()
    seqs[f["at"][x]] = np.frombuffer(b"ACGTN", np.uint8)[f["val"][x] // 256]
    recs, _ = cram_htslib.bam_records(dict(truth, seqs=seqs))
    out = os.path.join(ctx.work, "control.bam")
    write_bam(out, _bam_header(ctx.inputs["header_text"], ctx.inputs["refs"]),
              recs)
    with open(out + ".bai", "rb") as fh:
        index = fh.read()
    return {"state": {"judged": [out]},
            "win": {"counts": [ctx.inputs["records"]], "indexes": [index]}}
