"""The sort-and-write job's spans inside the port, on the CPU: a
device-route read (``resident_decode()``, the plain versions of the
card's kernels) sorted and written with its BAI.

- one ``sort.coordinate`` per ``write(..., sort=True)``, on the caller's
  thread, with its ``records`` and ``route``;
- the sorted BAM write parses no record on the host (its sink gathers
  the records' bytes): no ``columnar.batch.materialize`` span and no
  ``columnar.batch.materializations`` increment; a sorted SAM write,
  which still takes the records on the host, emits one
  ``columnar.batch.materialize`` per increment, inside the sort;
- one ``bam.write.compress`` and one ``bam.write.index`` per shard,
  inside that shard's ``bam.write.deflate`` on the same thread;
- one ``codec.inflate.crc`` inside each device-route
  ``codec.inflate.batch``, on the same thread;
- every span carries the emitting thread's native id (``tid``):
  executor and writer workers' spans carry the workers' ids;
- ``stop_trace()``'s file holds the spans on the profiler's clock;
- the benchmark's readers of the new spans, over hand-made windows;
- ``scripts/torch_trace_capture.py`` over one tiny sort-and-write job.
"""

import collections
import json
import os
import sys
import threading

import pytest

from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
import disq_tpu_torch as P
from disq_tpu_torch.bgzf import codec
from disq_tpu_torch.runtime import tracing as PT
from disq_tpu_torch.util import shutdown_shared_host_pool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = 3000
SHARDS = 4
# a span's start and length are each rounded to the microsecond
SLACK = 2e-6


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    yield
    shutdown_shared_host_pool()


def _run_job(d, out_name, *options):
    """One read, coordinate sort and write of 3,000 unsorted oracle
    records (12 splits, 4 executor workers, 4 shards, 2 writers) to
    ``out_name`` in ``d``: the spans it emitted, the materializations it
    counted, the caller's thread id."""
    src = d / "in.bam"
    src.write_bytes(make_bam_bytes(
        DEFAULT_REFS, synth_records(RECORDS, seed=3), blocksize=20000))
    st = (P.ReadsStorage.make_default(device="cpu").split_size(30000)
          .executor_workers(4).resident_decode().num_shards(SHARDS)
          .writer_workers(2))
    mat = PT.REGISTRY.counter("columnar.batch.materializations")
    device_route = []    # the thread of each device-route inflate batch
    inflate = codec._inflate_blocks_device

    def counted(*args, **kwargs):
        device_route.append(threading.get_native_id())
        return inflate(*args, **kwargs)

    mp = pytest.MonkeyPatch()
    mp.setattr(codec, "_inflate_blocks_device", counted)
    try:
        PT.reset_spans()
        base = mat.total()
        ds = st.read(str(src))
        assert ds.reads.device_backed
        st.write(ds, str(d / out_name), *options, sort=True)
        spans = PT.spans()
    finally:
        mp.undo()
    back = P.ReadsStorage.make_default(device="cpu").read(str(d / out_name))
    assert back.count() == RECORDS
    return {"spans": spans, "materializations": mat.total() - base,
            "caller": threading.get_native_id(),
            "device_route": device_route}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The sorted BAM write with its BAI (``_run_job``)."""
    return _run_job(tmp_path_factory.mktemp("sortwrite"), "out.bam",
                    P.BaiWriteOption.ENABLE)


@pytest.fixture(scope="module")
def sam_job(tmp_path_factory):
    """The same job written as SAM, whose sort takes the records on the
    host."""
    return _run_job(tmp_path_factory.mktemp("sortwrite_sam"), "out.sam")


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def _inside(inner, outer):
    end = outer["ts"] + outer["dur"] + SLACK
    return (inner["tid"] == outer["tid"]
            and outer["ts"] - SLACK <= inner["ts"]
            and inner["ts"] + inner["dur"] <= end)


def test_every_span_carries_a_thread_id(job):
    assert job["spans"]
    assert all(isinstance(s["tid"], int) and s["tid"] > 0
               for s in job["spans"])


def test_one_sort_span_per_sorted_write(job):
    (srt,) = _named(job["spans"], "sort.coordinate")
    assert srt["labels"] == {"records": RECORDS, "route": "device"}
    assert srt["tid"] == job["caller"]


def test_sorted_bam_write_materializes_nothing(job):
    assert job["materializations"] == 0
    assert _named(job["spans"], "columnar.batch.materialize") == []


def test_one_materialize_span_per_materialization(sam_job):
    mats = _named(sam_job["spans"], "columnar.batch.materialize")
    assert sam_job["materializations"] >= 1
    assert len(mats) == sam_job["materializations"]
    (srt,) = _named(sam_job["spans"], "sort.coordinate")
    assert all(_inside(m, srt) for m in mats)
    assert [m["labels"] for m in mats] == [{"records": RECORDS}] * len(mats)


@pytest.mark.parametrize("name", ["bam.write.compress", "bam.write.index"])
def test_deflate_parts_inside_their_shards_deflate(job, name):
    deflate = {s["labels"]["shard"]: s
               for s in _named(job["spans"], "bam.write.deflate")}
    assert sorted(deflate) == list(range(SHARDS))
    parts = _named(job["spans"], name)
    assert sorted(s["labels"]["shard"] for s in parts) == list(range(SHARDS))
    for s in parts:
        assert _inside(s, deflate[s["labels"]["shard"]]), s
    # the two parts of one deflate do not overlap
    if name == "bam.write.index":
        comp = {s["labels"]["shard"]: s
                for s in _named(job["spans"], "bam.write.compress")}
        for s in parts:
            c = comp[s["labels"]["shard"]]
            assert c["ts"] + c["dur"] <= s["ts"] + SLACK


def test_one_crc_span_inside_each_device_inflate_batch(job):
    # the split planning's inflates take the host route (its native
    # inflater checks the CRC, under no span of its own)
    batches = _named(job["spans"], "codec.inflate.batch")
    crcs = _named(job["spans"], "codec.inflate.crc")
    assert len(job["device_route"]) >= 12
    assert len(crcs) == len(job["device_route"])
    assert sorted(c["tid"] for c in crcs) == sorted(job["device_route"])
    for c in crcs:
        holders = [b for b in batches if _inside(c, b)]
        assert len(holders) == 1, c
        assert holders[0]["labels"] == c["labels"]


def test_worker_spans_carry_the_workers_ids(job):
    by = collections.defaultdict(set)
    for s in job["spans"]:
        by[s["name"]].add(s["tid"])
    for name in ("executor.fetch", "bam.split.decode", "bam.write.encode",
                 "bam.write.deflate", "bam.write.compress"):
        assert by[name] and job["caller"] not in by[name], name
    for name in ("bam.read.splits", "sort.coordinate", "bam.write.parts",
                 "bam.write.merge"):
        assert by[name] == {job["caller"]}, name


def test_stop_trace_puts_spans_on_the_profilers_clock(tmp_path):
    import torch

    PT.start_trace(str(tmp_path))
    with PT.trace_phase("bam.read.header"):
        torch.ones(256).cumsum(0)
    path = PT.stop_trace()
    events = json.load(open(path))["traceEvents"]
    (rf,) = [e for e in events if e.get("name") == "disq_tpu.bam.read.header"]
    (sp,) = [e for e in events if e.get("cat") == "host_span"
             and e["name"] == "bam.read.header"]
    assert sp["pid"] == PT._SPAN_ROW_PID and sp["tid"] == rf["tid"]
    assert abs(sp["ts"] - rf["ts"]) < 1000.0          # microseconds
    assert sp["ts"] + sp["dur"] >= rf["ts"] + rf["dur"] - 1000.0
    names = {(e["name"], e["args"].get("name")) for e in events
             if e.get("ph") == "M" and e.get("pid") == PT._SPAN_ROW_PID}
    assert ("process_name", "disq_tpu_torch spans") in names


def test_merge_keeps_only_the_captures_spans(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [],
                                "baseTimeNanoseconds": 5_000_000_000}))
    spans = [{"ts": 9.0, "dur": 0.5, "name": "sort.coordinate", "tid": 7,
              "labels": {"records": 3}},
             {"ts": 10.0, "dur": 0.5, "name": "bam.write.merge", "tid": 7,
              "labels": {}},
             {"ts": 10.25, "dur": 0.125, "name": "bam.write.index",
              "tid": 8, "labels": {"shard": 1}},
             {"ts": 10.75, "dur": 0.5, "name": "bam.write.parts", "tid": 7,
              "labels": {}}]
    mp = pytest.MonkeyPatch()
    mp.setattr(PT, "spans", lambda: spans)
    try:
        # the capture starts at perf 10.0 = epoch 6.0 s, ends at perf 11.0
        assert PT.merge_spans(str(path), (10.0, 6_000_000_000), 11.0) == 2
    finally:
        mp.undo()
    events = json.load(open(path))["traceEvents"]
    xs = sorted((e["name"], e["ts"], e["dur"], e["tid"]) for e in events
                if e["ph"] == "X")
    # 1.0 s after the file's base time, in microseconds
    assert xs == [("bam.write.index", 1_250_000.0, 125_000.0, 8),
                  ("bam.write.merge", 1_000_000.0, 500_000.0, 7)]
    threads = sorted(e["tid"] for e in events if e["name"] == "thread_name")
    assert threads == [7, 8]


# -- the benchmark's readers of the new spans -------------------------------


def _reader(name):
    from benchmark.harness import core

    return core.Manifest(REPO).reader(name)


def _measure(spans):
    from benchmark.harness.core import Measure

    return Measure(spans=spans, facts={"records": 2_000_000})


def _s(name, ts, dur, tid=1):
    return {"name": name, "ts": ts, "dur": dur, "tid": tid, "labels": {}}


def test_sort_reader_subtracts_materialize_on_its_own_thread():
    spans = [_s("sort.coordinate", 0.0, 10.0, tid=1),
             _s("sort.coordinate", 20.0, 6.0, tid=1),
             _s("columnar.batch.materialize", 1.0, 4.0, tid=1),   # inside
             _s("columnar.batch.materialize", 2.0, 3.0, tid=2),   # other tid
             _s("columnar.batch.materialize", 12.0, 2.0, tid=1),  # outside
             # ends within the rounding slack of the second sort's end
             _s("columnar.batch.materialize", 22.0, 4.000001, tid=1)]
    got = _reader("sort_s.write").read(_measure(spans))
    assert got == pytest.approx((16.0 - 4.0 - 4.000001) / 2)
    assert _reader("sort_s.write").read(_measure(spans[2:])) is None
    assert _reader("materialize_s.write").read(_measure(spans)) == \
        pytest.approx((4.0 + 3.0 + 2.0 + 4.000001) / 2)


@pytest.mark.parametrize("metric,span", [
    ("compress_s.write", "bam.write.compress"),
    ("index_s.write", "bam.write.index"),
    ("inflate_crc_s.write", "codec.inflate.crc"),
    ("materialize_s.write", "columnar.batch.materialize")])
def test_span_readers_sum_over_threads(metric, span):
    spans = [_s(span, 0.0, 3.0, tid=1), _s(span, 1.0, 5.0, tid=2),
             _s("bam.write.deflate", 0.0, 9.0, tid=1)]
    assert _reader(metric).read(_measure(spans)) == pytest.approx(4.0)
    # a window without the span (the parent's program) reads nothing
    assert _reader(metric).read(_measure(spans[2:])) is None


def test_new_readers_are_declared_for_the_sort_write_cell():
    from benchmark.harness import core

    man = core.Manifest(REPO)
    names = {m["name"] for m in man.per_layer("bam-sort-write")}
    assert {"sort_s.write", "materialize_s.write", "compress_s.write",
            "index_s.write", "inflate_crc_s.write"} <= names


# -- the capture script -----------------------------------------------------


def test_capture_script_on_the_cpu(tmp_path, capsys):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import torch_trace_capture as cap
    finally:
        sys.path.pop(0)
    src = tmp_path / "in.bam"
    src.write_bytes(make_bam_bytes(
        DEFAULT_REFS, synth_records(2000, seed=5), blocksize=20000))
    assert cap.main(["--device", "cpu", "--bam", str(src), "--workers", "2",
                     "--shards", "2", "--work", str(tmp_path / "w")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["marker"]["inside"] and out["jobs"] == 1, out
    # the job's spans and the marker's, merged again into the copy
    assert out["spans_merged"] > 10 and out["file_bytes"] > 0
    assert abs(out["marker"]["span_ts"]
               - out["marker"]["record_function_ts"]) < 1000.0
