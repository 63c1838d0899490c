#!/usr/bin/env python3
"""Check that ``tracing.stop_trace()`` puts the program's spans on the
profiler's clock, with a marker launched inside a ``trace_phase``.

    python3 scripts/torch_trace_capture.py [--device cuda] [--bam PATH]
        [--jobs N] [--workers W] [--shards S] [--work DIR]

It starts ``tracing.start_trace``, fills a marker tensor inside a
``trace_phase``, runs ``--jobs`` sort-and-write jobs of ``--bam``
(``write(read(bam), out, BaiWriteOption.ENABLE, sort=True)`` by
``--workers`` executor and writer workers into ``--shards`` parts,
after one job outside the capture; none without ``--bam``), and stops
the capture. It prints one JSON line: the marker's device operation (on
``cuda`` the kernel launched in the phase's ``record_function`` range,
matched by correlation id; on the CPU its ``aten::fill_``) against the
phase's span in the exported file (``inside``); ``spans_merged``,
``file_bytes`` and ``stop_trace_s``; and ``merge_s``,
``tracing.merge_spans`` timed over a copy of the exported file. The
exit code is 1 when the marker is outside its span.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE = "capture.marker"


def _marker_op(events, cuda):
    (rf,) = [e for e in events if e.get("name") == "disq_tpu." + PHASE
             and e.get("cat") == "user_annotation"]

    def within(e):
        return (e.get("tid") == rf["tid"]
                and rf["ts"] <= e["ts"] <= rf["ts"] + rf["dur"])

    if not cuda:
        return next(e for e in events if e.get("cat") == "cpu_op"
                    and e.get("name") == "aten::fill_" and within(e)), rf
    ids = {e["args"]["correlation"] for e in events
           if e.get("cat") == "cuda_runtime"
           and "LaunchKernel" in e.get("name", "") and within(e)}
    return next(e for e in events if e.get("cat") == "kernel"
                and e.get("args", {}).get("correlation") in ids), rf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bam", default=None)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--work", default=os.path.join(REPO, ".bench_work",
                                                   "capture"))
    a = ap.parse_args(argv)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import torch

    import disq_tpu_torch as port
    from disq_tpu_torch.runtime import tracing

    dev = torch.device(a.device)
    cuda = dev.type == "cuda"
    shutil.rmtree(a.work, ignore_errors=True)
    os.makedirs(a.work)
    st = (port.ReadsStorage.make_default(device=dev)
          .executor_workers(a.workers).writer_workers(a.workers)
          .num_shards(a.shards))

    def job():
        st.write(st.read(a.bam), os.path.join(a.work, "out.bam"),
                 port.BaiWriteOption.ENABLE, sort=True)
        if cuda:
            torch.cuda.synchronize(dev)

    jobs = a.jobs if a.bam else 0
    if jobs:
        job()
    marker = torch.zeros(1, device=dev)
    tracing.start_trace(os.path.join(a.work, "trace"))
    anchor = (time.perf_counter(), time.time_ns())
    with tracing.trace_phase(PHASE):
        marker.fill_(1.0)
        if cuda:
            torch.cuda.synchronize(dev)
    for _ in range(jobs):
        job()
    end = time.perf_counter()
    t = time.perf_counter()
    path = tracing.stop_trace()
    stop_s = time.perf_counter() - t
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    copy = path + ".copy"
    shutil.copyfile(path, copy)
    t = time.perf_counter()
    merged = tracing.merge_spans(copy, anchor, end)
    merge_s = time.perf_counter() - t
    op, rf = _marker_op(events, cuda)
    (sp,) = [e for e in events if e.get("cat") == "host_span"
             and e["name"] == PHASE]
    inside = sp["ts"] <= op["ts"] <= sp["ts"] + sp["dur"]
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "jobs": jobs, "window_s": end - anchor[0],
        "marker": {"op": str(op["name"])[:80], "op_ts": op["ts"],
                   "span_ts": sp["ts"], "span_end": sp["ts"] + sp["dur"],
                   "record_function_ts": rf["ts"], "inside": inside},
        "spans_merged": merged, "file_bytes": os.path.getsize(path),
        "stop_trace_s": stop_s, "merge_s": merge_s}), flush=True)
    return 0 if inside else 1


if __name__ == "__main__":
    sys.exit(main())
