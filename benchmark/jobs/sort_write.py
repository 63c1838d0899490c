"""Whole sort-and-index jobs, one at a time in a closed loop: read the
file, coordinate-sort it and write it with its BAI,
``st.write(st.read(path), out, BaiWriteOption.ENABLE, sort=True)`` with
the configuration's split size, executor workers, write shards and
writer workers. ``write_rate`` is all records of all jobs over the time
from the first job's start to the last job's end; ``write_size_ratio``
the written file's and index's bytes per decoded byte of the records
written. Each job overwrites the last one's file, but keeps its index's
bytes: every job's index has to count the input's records per
reference and unplaced. The file of a job drawn from the seed is set
aside and judged whole: its records against the reference's stable
sort of the input, its index by what the index means
(``reference/bai.py``'s ``violations``).

``control(ctx)`` is the cell's control: the reference in the program's
place with its sort made unstable (NumPy's introsort of the coordinate
keys, so reads at one position may swap), written in the
configuration's shards with the reference's BAI of the written file."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.generators import reads_bam
from benchmark.jobs import common
from benchmark.reference import bai, bam, compare, sort


def _paths(ctx, name):
    p = os.path.join(ctx.work, name)
    return p, p + ".bai"


def _job(ctx, st, src, out):
    ds = st.read(src)
    n = ds.count()
    st.write(ds, out, ctx.port.BaiWriteOption.ENABLE, sort=True)
    del ds
    return n


WARM_RECORDS = 20_000


def setup(ctx):
    """Warm up the read and the coordinate sort at full size, and the
    write path (its pools, deflate and BAI) on the sorted file's first
    records: the write builds no kernel, so its full-size deflate would
    only lengthen set-up."""
    st = common.storage(ctx)
    out, _ = _paths(ctx, "out.bam")
    ds = st.read(ctx.inputs["path"])
    ds.count()
    srt = ds.coordinate_sorted()
    head = type(ds)(header=srt.header,
                    reads=srt.reads.take(np.arange(min(WARM_RECORDS,
                                                       srt.count()))),
                    device=ds.device)
    st.write(head, out, ctx.port.BaiWriteOption.ENABLE, sort=True)
    ctx.sync()
    del ds, srt, head
    # the input's block bytes, for the roofline of a traced run
    return {"storage": st, "out": out,
            "bytes": common.block_bytes(ctx.inputs["path"]) if ctx.trace
            else {}}


def window(ctx, state, seconds):
    st, src, out = state["storage"], ctx.inputs["path"], state["out"]
    kept, _ = _paths(ctx, "kept.bam")
    sample = common.Sample(ctx.seed)
    sizes, indexes = [], []

    def one_pass(i):
        n = _job(ctx, st, src, out)
        ctx.sync()
        with open(out + ".bai", "rb") as f:
            indexes.append(f.read())
        sizes.append(os.path.getsize(out) + len(indexes[-1]))
        if sample.offer(i, None):
            os.replace(out, kept)
            os.replace(out + ".bai", kept + ".bai")
        return n

    loop = common.timed_loop(ctx, seconds, one_pass)
    total = sum(loop["records"])
    record_bytes = ctx.inputs["record_bytes"] * loop["passes"]
    state["judged"] = [kept]
    return {"attempted": loop["passes"], "failed": 0,
            "e2e": {"write_rate": total / loop["elapsed"],
                    "write_size_ratio": sum(sizes) / record_bytes},
            "counts": loop["records"], "indexes": indexes,
            "facts": {"records": total, "passes": loop["passes"],
                      **state["bytes"]}}


def release(state):
    state.pop("storage", None)


def _index_counts(dec):
    """Records per reference and unplaced, as an index counts them."""
    refid = dec.fixed["refid"].astype(np.int64)
    per_ref = np.bincount(refid[refid >= 0], minlength=len(dec.refs))
    return [int(x) for x in per_ref], int((refid < 0).sum())


def verify(ctx, state, win):
    src = bam.decode_path(ctx.inputs["path"])
    order = sort.stable_order(src.fixed["refid"], src.fixed["pos"])
    wrong = sum(1 for n in win["counts"] if n != src.count)
    want = _index_counts(src)
    counted = 0
    for data in win.get("indexes", []):
        try:
            counted += int(bai.record_counts(data) != want)
        except ValueError:
            counted += 1
    bad = header = index = 0
    for path in state["judged"]:
        out = bam.decode_path(path)
        header += int("SO:coordinate" not in out.header_text.split("\n")[0]
                      or out.refs != src.refs)
        bad += compare.mismatched_sorted(src, order, out)
        with open(path + ".bai", "rb") as f:
            index += bai.violations(out, f.read())
        del out
    return {"jobs_wrong_count": {"value": wrong, "limit": 0},
            "indexes_wrong_count": {"value": counted, "limit": 0},
            "headers_wrong": {"value": header, "limit": 0},
            "records_mismatched": {"value": bad, "limit": 0},
            "bai_faults": {"value": index, "limit": 0}}


def write_parts(path: str, dec, order, shards: int) -> None:
    """``dec``'s records in ``order`` as a sorted BAM written in
    ``shards`` parts (a header block, each part's own 65,280-byte
    blocks, the terminator) with its BAI beside it."""
    head = reads_bam.bam_header(dec.refs, "coordinate")
    raw = dec.raw
    bounds = np.linspace(0, len(order), shards + 1).astype(np.int64)
    step = reads_bam.MAX_PAYLOAD
    with open(path, "wb") as f, ThreadPoolExecutor(reads_bam.THREADS) as pool:
        f.write(reads_bam.bgzf_block(head))
        for k in range(shards):
            rows = order[bounds[k]:bounds[k + 1]]
            part = b"".join([raw[a:b] for a, b in zip(
                dec.start[rows].tolist(), dec.end[rows].tolist())])
            for block in pool.map(lambda o: reads_bam.bgzf_block(
                    part[o:o + step]), range(0, len(part), step)):
                f.write(block)
        f.write(reads_bam.EOF_BLOCK)
    with open(path + ".bai", "wb") as f:
        f.write(bai.build(bam.decode_path(path)))


def control(ctx) -> dict:
    """What the control hands to ``verify`` in the window's place."""
    dec = bam.decode_path(ctx.inputs["path"])
    keys = sort.coordinate_keys(dec.fixed["refid"], dec.fixed["pos"])
    order = np.argsort(keys, kind="quicksort")
    out = os.path.join(ctx.work, "control.bam")
    write_parts(out, dec, order, int(ctx.config["write_shards"]))
    return {"state": {"judged": [out]}, "win": {"counts": [dec.count]}}
