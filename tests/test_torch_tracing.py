"""The port's telemetry plane (``disq_tpu_torch/runtime/tracing.py`` and
its call sites) against the reference's, on the same inputs.

- the same registry calls give the same Prometheus text, snapshot,
  summary, percentiles and Chrome trace events;
- a BAM read (oracle fixture, several splits) emits the reference's
  non-device span names, as many of each, with the same shard and
  virtual-offset labels, at 1 and 4 executor workers;
- a resident read booked as the reference books it:
  ``device.d2h_avoided_bytes`` after flagstat and release, ``track_hbm``
  back where it started once the batch is released;
- the CRAM read's per-split ``cram.split.fetch`` / ``decode`` spans;
- every name the port emits is in the README's metric table with the
  same kind (``scripts/check_metrics.py``'s own scan, pointed at the
  port), and ``scripts/trace_report.py`` renders a port span log;
- ``telemetry_report()`` has the reference's keys; the counters module
  books into the registry; a ``torch.profiler`` capture is exported.
"""

import collections
import json
import os
import subprocess
import sys

import pytest

from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
import disq_tpu.api as R
from disq_tpu.runtime import tracing as RT
import disq_tpu_torch as P
from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime import tracing as PT
from disq_tpu_torch.util import shutdown_shared_host_pool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    yield
    shutdown_shared_host_pool()


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """3,000 oracle records in 20,000-byte blocks: 12 splits at 30,000."""
    path = tmp_path_factory.mktemp("tracing") / "in.bam"
    path.write_bytes(make_bam_bytes(DEFAULT_REFS, synth_records(3000, seed=1),
                                    blocksize=20000))
    return str(path)


def _drive(T):
    reg = T.MetricsRegistry()
    launches = reg.counter("device.kernel_launches")
    launches.inc(kernel="parse")
    launches.inc(2, kernel="inflate_simd")
    reg.counter("device.bytes_to_device").inc(4096)
    g = reg.gauge("executor.in_flight")
    for v in (3, 1, 4):
        g.observe(v)
    h = reg.histogram("executor.fetch")
    for v, shard in ((0.003, 1), (12.0, 2), (0.0004, 1), (75.0, 3)):
        h.observe(v, shard=shard)
    reg.histogram("device.kernel").observe(0.02, kernel='a"b\\c')
    return (reg.metrics_text(), reg.snapshot(), reg.summary(),
            [h.percentile(p) for p in (0, 50, 90, 99, 100)])


def test_registry_exports_equal_reference():
    assert _drive(PT) == _drive(RT)
    with pytest.raises(ValueError):
        reg = PT.MetricsRegistry()
        reg.counter("executor.fetch")
        reg.histogram("executor.fetch")


def test_chrome_trace_events_equal_reference():
    spans = [
        {"ts": 1.25, "dur": 0.5, "name": "bam.split.fetch", "run": "x",
         "labels": {"shard": 3, "lo": 10, "hi": 20}},
        {"ts": 1.5, "dur": 0.001, "name": "device.kernel", "run": "x",
         "labels": {"kernel": "inflate_simd", "lanes": 7}},
        {"ts": 2.0, "dur": 0.25, "name": "bam.read.header", "run": "x",
         "labels": {}},
    ]
    assert PT.chrome_trace_events(spans) == RT.chrome_trace_events(spans)
    assert PT.chrome_trace_events(spans[2:]) == RT.chrome_trace_events(
        spans[2:])


def test_emitted_spans_equal_reference_but_run_ids():
    def emit(T):
        T.reset_spans()
        T.record_span("executor.emit.stall", 0.125, shard=2)
        with T.span("bam.split.decode", shard=5):
            pass
        out = []
        for s in T.spans():
            s = dict(s)
            assert s.pop("run") == T.RUN_ID
            s.pop("ts")
            s.pop("dur") if s["name"] == "bam.split.decode" else None
            out.append(s)
        return out

    assert emit(PT) == emit(RT)


def _span_names(T):
    return collections.Counter(s["name"] for s in T.spans()
                               if not s["name"].startswith("device."))


def _fetch_labels(T):
    return sorted((s["labels"]["shard"], s["labels"]["lo"], s["labels"]["hi"])
                  for s in T.spans() if s["name"] == "bam.split.fetch")


@pytest.mark.parametrize("workers", [1, 4])
def test_bam_read_spans_equal_reference(bam, workers):
    RT.reset_spans()
    PT.reset_spans()
    ref = (R.ReadsStorage.make_default().split_size(30000)
           .executor_workers(workers).read(bam))
    got = (P.ReadsStorage.make_default(device="cpu").split_size(30000)
           .executor_workers(workers).read(bam))
    assert got.count() == ref.count()
    want, have = _span_names(RT), _span_names(PT)
    # emit stalls depend on thread timing, not on the code
    want.pop("executor.emit.stall", None)
    have.pop("executor.emit.stall", None)
    assert have == want
    assert have["bam.split.fetch"] == 12 and have["codec.inflate.batch"] > 12
    assert _fetch_labels(PT) == _fetch_labels(RT)
    decode = sorted(s["labels"]["shard"] for s in PT.spans()
                    if s["name"] == "bam.split.decode")
    assert decode == list(range(12))


@pytest.fixture(scope="module")
def resident_books(tmp_path_factory):
    """flagstat then release of a resident read in each package: the
    d2h-avoided bytes each booked, and the port's live-HBM estimate
    before, during and after."""
    path = tmp_path_factory.mktemp("resident") / "tiny.bam"
    path.write_bytes(make_bam_bytes(DEFAULT_REFS, synth_records(110, seed=9),
                                    blocksize=320))
    mp = pytest.MonkeyPatch()
    mp.setenv("DISQ_TPU_DEVICE_INFLATE", "1")
    try:
        avoided = RT.REGISTRY.counter("device.d2h_avoided_bytes")
        base = avoided.total()
        ref = (R.ReadsStorage.make_default().split_size(16000)
               .resident_decode().read(str(path)))
        ref.flagstat()
        ref.reads.release()
        ref_avoided = avoided.total() - base
    finally:
        mp.undo()
    avoided = PT.REGISTRY.counter("device.d2h_avoided_bytes")
    base, hbm0 = avoided.total(), PT.hbm_live_bytes()
    got = (P.ReadsStorage.make_default(device="cpu").split_size(16000)
           .resident_decode().read(str(path)))
    hbm1 = PT.hbm_live_bytes()
    got.flagstat()
    got.reads.release()
    return {"ref": ref_avoided, "port": avoided.total() - base,
            "n": got.count(), "hbm": (hbm0, hbm1, PT.hbm_live_bytes())}


def test_d2h_avoided_bytes_equal_reference(resident_books):
    assert resident_books["port"] == resident_books["ref"] > 0
    # 8 fixed int32 columns never fetched (flag consumed on the device)
    assert resident_books["port"] == 8 * 4 * resident_books["n"]


def test_track_hbm_returns_to_start_after_release(resident_books):
    before, during, after = resident_books["hbm"]
    assert during - before == 8 * 4 * resident_books["n"]
    assert after == before
    state = PT.REGISTRY.gauge("device.hbm_bytes").state()
    assert state is not None and state["max"] >= during


def test_cram_read_emits_split_spans(bam, tmp_path):
    storage = P.ReadsStorage.make_default(device="cpu")
    ds = storage.read(bam)
    cram = str(tmp_path / "out.cram")
    storage.write(ds.coordinate_sorted(), cram)
    PT.reset_spans()
    back = storage.split_size(40000).executor_workers(2).read(cram)
    assert back.count() == ds.count()
    by = collections.defaultdict(list)
    for s in PT.spans():
        if s["name"].startswith("cram.split."):
            by[s["name"]].append(s["labels"])
    fetch, decode = by["cram.split.fetch"], by["cram.split.decode"]
    n = back.counters.shards
    assert n > 1
    assert sorted(l["shard"] for l in fetch) == list(range(n))
    assert sorted(l["shard"] for l in decode) == list(range(n))
    assert all({"start", "end", "containers"} <= set(l) for l in fetch)
    assert sum(l["containers"] for l in fetch) == back.counters.blocks


def test_port_metric_names_are_documented(monkeypatch):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import check_metrics as cm
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(cm, "CODE_ROOT", os.path.join(REPO, "disq_tpu_torch"))
    kinds, sites = cm.scan_code()
    documented = cm.scan_readme_kinds()
    assert len(kinds) > 40
    for name, k in kinds.items():
        assert len(k) == 1, (name, k, sites[name])
        assert name in documented, (name, sites[name])
        assert cm._DOC_KIND[documented[name].lower()] == next(iter(k)), name
    # the reference emits every one of them too
    monkeypatch.setattr(cm, "CODE_ROOT", os.path.join(REPO, "disq_tpu"))
    ref_kinds, _ = cm.scan_code()
    assert set(kinds) <= set(ref_kinds)


def test_trace_report_renders_a_port_span_log(bam, tmp_path):
    log = str(tmp_path / "spans.jsonl")
    try:
        ds = (P.ReadsStorage.make_default(device="cpu").split_size(30000)
              .span_log(log).read(bam))
    finally:
        PT.stop_span_log()
    assert ds.count() == 3000
    lines = [json.loads(x) for x in open(log)]
    assert lines[0]["meta"] == 1 and lines[0]["run_id"] == PT.RUN_ID
    assert sum(1 for x in lines if x.get("name") == "bam.split.fetch") == 12
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "trace_report.py"),
         log, "--analyze"], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n_spans = sum(1 for x in lines if "name" in x)
    assert f"run {PT.RUN_ID}  ({n_spans} spans" in res.stdout
    assert "wall-clock attribution" in res.stdout
    assert "verdict:" in res.stdout


def test_telemetry_report_has_the_reference_keys(bam):
    ref = R.ReadsStorage.make_default().split_size(30000).read(bam)
    got = P.ReadsStorage.make_default(device="cpu").split_size(30000).read(bam)
    want, have = ref.telemetry_report(), got.telemetry_report()
    assert set(have) == set(want)
    assert set(have["counters"]) == set(want["counters"])
    assert have["run_id"] == PT.RUN_ID
    assert have["phases"]["bam.split.fetch"]["calls"] >= 12


def test_counters_book_into_the_registry():
    counters.reset()
    counters.book_launch("inflate")
    counters.book_launch("record_gather")
    counters.book_launch("inflate_legacy")
    counters.book_transfer("h2d", 10)
    counters.book_host_fallback("flagged", 3)
    launches = PT.REGISTRY.counter("device.kernel_launches")
    assert launches.value(kernel="inflate_simd") == 1
    assert launches.value(kernel="encode_resident") == 1
    assert launches.value(kernel="inflate") == 1
    assert PT.REGISTRY.counter("device.bytes_to_device").total() == 10
    assert counters.snapshot() == {
        "launches": {"inflate": 1, "record_gather": 1, "inflate_legacy": 1},
        "host_fallback_blocks": {"flagged": 3},
        "transfer_bytes": {"h2d": 10}, "host_rans_streams": {}}
    counters.reset()
    assert counters.snapshot()["launches"] == {}


def test_device_span_fences_and_times_cpu_work():
    import torch

    PT.reset_spans()
    with PT.device_span("device.kernel", kernel="flagstat") as fence:
        out = fence.sync(torch.arange(10).sum(), [torch.zeros(2)])
    assert int(out[0]) == 45

    @PT.synced_timer("device.kernel", kernel="depth")
    def f():
        return torch.ones(3)

    assert f().sum() == 3
    assert [s["labels"]["kernel"] for s in PT.spans()] == ["flagstat", "depth"]


def test_start_trace_exports_a_chrome_trace(tmp_path):
    import torch

    PT.start_trace(str(tmp_path))
    with PT.trace_phase("bam.read.header"):
        torch.ones(64).cumsum(0)
    path = PT.stop_trace()
    assert PT.stop_trace() is None
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "disq_tpu.bam.read.header" for e in events)
