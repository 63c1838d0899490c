"""The port's live introspection (``disq_tpu_torch/runtime/introspect.py``)
against ``disq_tpu``'s, on the CPU.

The cases of ``tests/test_introspect.py``: the watchdog on both pipeline
directions (warn and abort, pipelined and inline), the disabled path
(no thread, no socket, no board traffic), the endpoint in a fresh
interpreter armed by ``DISQ_TPU_TORCH_INTROSPECT_PORT``, the 503 of a
degraded ``/healthz``, the progress log and its replay by
``scripts/trace_report.py --progress``, the ``progress.*`` counters, and
the run id the ledgers carry. Held against the reference exactly: the
health board driven through the same runs, beats and injected sweep
clock gives the same stall events and views, and the planes that are
not ported (``/sched/*``, ``/serve/*``, ``/query/*``, ``/fleet/*``)
answer with the reference's status codes. The watchdog's end-to-end
cases keep wide margins between the stall and the watchdog window.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
from disq_tpu.runtime import introspect as ref_introspect
import disq_tpu_torch as P
from disq_tpu_torch.api import SbiWriteOption
from disq_tpu_torch.fsw.faultfs import FaultInjectingFileSystemWrapper, FaultSpec
from disq_tpu_torch.fsw.filesystem import PosixFileSystemWrapper, register_filesystem
from disq_tpu_torch.runtime import introspect
from disq_tpu_torch.runtime.counters import ShardCounters
from disq_tpu_torch.runtime.errors import WatchdogStallError, is_transient
from disq_tpu_torch.runtime.introspect import (
    HEALTH,
    introspect_address,
    reset_introspection,
    start_introspect_server,
)
from disq_tpu_torch.runtime.tracing import RUN_ID, counter, spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER_READAHEAD = 256 * 1024


@pytest.fixture(autouse=True)
def _clean_introspection():
    reset_introspection()
    ref_introspect.reset_introspection()
    yield
    reset_introspection()
    ref_introspect.reset_introspection()


@pytest.fixture(scope="module")
def big_bam(tmp_path_factory):
    """Written by the port with its ``.sbi``: no boundary read covers the
    stall target, so the stall fires inside a split's fetch."""
    tmp = tmp_path_factory.mktemp("introspect")
    raw = tmp / "raw.bam"
    raw.write_bytes(make_bam_bytes(DEFAULT_REFS,
                                   synth_records(5000, seed=11)))
    storage = P.ReadsStorage.make_default(device="cpu")
    ds = storage.read(str(raw))
    path = tmp / "stall.bam"
    storage.num_shards(6).write(ds, str(path), SbiWriteOption.ENABLE)
    size = os.path.getsize(path)
    assert size > HEADER_READAHEAD + 64 * 1024, size
    return str(path), size, 5000


@pytest.fixture(scope="module")
def small_bam(tmp_path_factory):
    path = tmp_path_factory.mktemp("introspect-small") / "small.bam"
    path.write_bytes(make_bam_bytes(DEFAULT_REFS,
                                    synth_records(800, seed=3)))
    return str(path), 800


def _stall_storage(size, workers=4, policy="warn", stall_s=3.0,
                   watchdog_s=1.0, scheme="stallfault"):
    target = max(size * 3 // 5, HEADER_READAHEAD + 32 * 1024)
    fsw = FaultInjectingFileSystemWrapper(
        PosixFileSystemWrapper(),
        [FaultSpec(kind="stall", offset=target, stall_s=stall_s, times=1)],
        scheme=scheme)
    register_filesystem(scheme, fsw)
    storage = (P.ReadsStorage.make_default(device="cpu")
               .split_size(96 * 1024).executor_workers(workers)
               .watchdog(watchdog_s, policy))
    return storage, fsw


# -- the board against the reference's ---------------------------------------------


def _board_trace(mod):
    """One read run and one write run on a fresh board, beats at known
    times, sweeps at injected times: the stall events and the views."""
    board = mod.PipelineHealth()
    t0 = time.perf_counter()
    r = board.register_run("read", 4, stall_s=1.0, policy="warn")
    w = board.register_run("write", 2, stall_s=None)
    board.beat(r, "fetch", 0)
    board.beat(r, "decode", 1)
    board.beat(w, "encode", 0)
    out = [board.check(now=t0 + 0.5)]
    out.append(board.check(now=t0 + 5.0))      # both read shards stall
    out.append(board.check(now=t0 + 6.0))      # flagged once
    h = board.healthz()
    out.append((h["status"], h["stall_events"], h["active_runs"],
                sorted((s["shard"], s["stage"], s["direction"])
                       for s in h["stalls"])))
    board.clear(r, "fetch", 0)
    board.shard_done(r, 1)
    board.note_counters("read", records=7, bytes_compressed=11,
                        bytes_uncompressed=13)
    out.append(board.healthz()["status"])
    p = board.progress()["directions"]["read"]
    out.append({k: p[k] for k in ("shards_total", "shards_done",
                                  "in_flight", "records",
                                  "bytes_compressed", "bytes_uncompressed",
                                  "active")})
    board.finish_run(r)
    board.finish_run(w)
    out.append(board.has_active_runs())
    return out


def test_health_board_equals_reference():
    got = _board_trace(introspect)
    assert got == _board_trace(ref_introspect)
    assert got[:3] == [0, 2, 0]
    assert got[3][0] == "degraded"


def test_suggested_tick_equals_reference():
    for stalls in ([], [0.05], [0.2, 4.0], [10.0]):
        a, b = introspect.PipelineHealth(), ref_introspect.PipelineHealth()
        for s in stalls:
            a.register_run("read", 1, stall_s=s)
            b.register_run("read", 1, stall_s=s)
        assert a.suggested_tick() == b.suggested_tick()


# -- the watchdog ---------------------------------------------------------------------


def test_read_stall_flagged_and_healthz_degrades(big_bam):
    path, size, n = big_bam
    storage, fsw = _stall_storage(size, workers=4)
    before = counter("watchdog.stalled_shards").total()
    results, errors = [], []

    def run():
        try:
            results.append(storage.read("stallfault://" + path))
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    degraded, deadline = None, time.time() + 30
    while time.time() < deadline and degraded is None:
        h = HEALTH.healthz()
        if h["status"] == "degraded":
            degraded = h
        time.sleep(0.01)
    t.join(timeout=60)
    assert not errors, errors
    assert degraded is not None and degraded["stalls"], degraded
    [stall] = [s for s in degraded["stalls"] if s["stage"] == "fetch"]
    assert stall["direction"] == "read"
    assert stall["age_s"] < 3.0 + 1.0
    assert [k for k, _ in fsw.fired_counts() if k == "stall"]
    assert results and results[0].count() == n
    assert counter("watchdog.stalled_shards").total() > before
    assert counter("watchdog.stalled_shards").value(stage="fetch") >= 1
    assert HEALTH.healthz()["status"] == "ok"
    stall_spans = [s for s in spans() if s["name"] == "watchdog.stall"]
    assert stall_spans and stall_spans[-1]["labels"]["stage"] == "fetch"


def test_read_stall_abort_policy_raises(big_bam):
    path, size, _ = big_bam
    storage, _ = _stall_storage(size, workers=4, policy="abort",
                                stall_s=10.0)
    t0 = time.perf_counter()
    with pytest.raises(WatchdogStallError) as ei:
        storage.read("stallfault://" + path)
    assert time.perf_counter() - t0 < 8.0
    assert ei.value.stage == "fetch" and ei.value.shard_id >= 0


def test_inline_abort_delivered_at_stage_boundary(big_bam):
    path, size, _ = big_bam
    storage, _ = _stall_storage(size, workers=1, policy="abort",
                                stall_s=3.0)
    with pytest.raises(WatchdogStallError) as ei:
        storage.read("stallfault://" + path)
    assert ei.value.stage == "fetch"


def test_inline_write_abort_delivered(small_bam, tmp_path):
    path, _ = small_bam
    ds = P.ReadsStorage.make_default(device="cpu").read(path)
    register_filesystem("wstall1", FaultInjectingFileSystemWrapper(
        PosixFileSystemWrapper(),
        [FaultSpec(kind="stall", op="write", probability=1.0, times=1,
                   stall_s=1.5)], scheme="wstall1"))
    with pytest.raises(WatchdogStallError):
        P.ReadsStorage.make_default(device="cpu").num_shards(6) \
            .watchdog(0.2, "abort") \
            .write(ds, "wstall1://" + str(tmp_path / "out.bam"))


def test_write_stall_flagged_at_four_workers(small_bam, tmp_path):
    path, n = small_bam
    ds = P.ReadsStorage.make_default(device="cpu").read(path)
    register_filesystem("wstall", FaultInjectingFileSystemWrapper(
        PosixFileSystemWrapper(),
        [FaultSpec(kind="stall", op="write", probability=1.0, times=1,
                   stall_s=2.0)], scheme="wstall"))
    out = str(tmp_path / "out.bam")
    before = counter("watchdog.stalled_shards").total()
    P.ReadsStorage.make_default(device="cpu").num_shards(6) \
        .writer_workers(4).watchdog(0.2, "warn").write(ds, "wstall://" + out)
    assert counter("watchdog.stalled_shards").total() > before
    assert counter("watchdog.stalled_shards").value(stage="stage") >= 1
    assert P.ReadsStorage.make_default(device="cpu").read(out).count() == n


def test_watchdog_error_is_permanent():
    assert not is_transient(WatchdogStallError("x"))


# -- disabled ---------------------------------------------------------------------------


def test_disabled_read_starts_no_thread_and_feeds_no_board(small_bam,
                                                           monkeypatch):
    monkeypatch.delenv("DISQ_TPU_TORCH_INTROSPECT_PORT", raising=False)
    path, n = small_bam
    before = set(threading.enumerate())
    ds = P.ReadsStorage.make_default(device="cpu").split_size(64 * 1024) \
        .executor_workers(4).read(path)
    assert ds.count() == n
    new = {t.name for t in set(threading.enumerate()) - before}
    assert not any(nm.startswith(("disq-introspect", "disq-watchdog"))
                   for nm in new), new
    assert ds.introspect_address() is None and introspect_address() is None
    assert not HEALTH.has_active_runs()
    assert HEALTH.progress()["directions"] == {}
    assert ds.telemetry_report()["introspect"] is None


def test_default_executor_has_no_health_and_stays_inline(monkeypatch):
    from disq_tpu_torch.runtime.executor import ShardTask, executor_for_storage

    monkeypatch.delenv("DISQ_TPU_TORCH_INTROSPECT_PORT", raising=False)
    ex = executor_for_storage(P.ReadsStorage.make_default(device="cpu"))
    assert ex._health is None and ex._resilience is None
    it = ex.map_ordered([ShardTask(shard_id=0, fetch=lambda: 1,
                                   decode=lambda v: v)])
    assert it.__name__ == "_run_sequential"
    assert [r.value for r in it] == [1]


def test_note_shard_counters_noop_when_dark():
    introspect.note_shard_counters(
        "read", ShardCounters(records=10, bytes_compressed=5))
    assert HEALTH.progress()["directions"] == {}


# -- the endpoint ------------------------------------------------------------------------


def test_endpoints_serve_a_run_armed_by_the_env_knob(small_bam):
    path, n = small_bam
    code = f"""
import json, sys, urllib.error, urllib.request
sys.path.insert(0, {REPO!r})
from disq_tpu_torch import ReadsStorage, introspect_address

ds = (ReadsStorage.make_default(device="cpu").split_size(64 * 1024)
      .executor_workers(2).watchdog(5.0).read({path!r}))
assert ds.count() == {n}
addr = ds.introspect_address()
assert addr and addr == introspect_address(), addr
text = urllib.request.urlopen(f"http://{{addr}}/metrics", timeout=10).read().decode()
assert "disq_tpu_process_info" in text, text[:400]
assert "disq_tpu_executor_fetch_seconds" in text, text[:400]
assert "disq_tpu_progress_shards" in text, text[:400]
h = json.load(urllib.request.urlopen(f"http://{{addr}}/healthz", timeout=10))
assert h["status"] == "ok" and h["run_id"] and h["stall_events"] == 0, h
assert h["process_id"] == 3, h
p = json.load(urllib.request.urlopen(f"http://{{addr}}/progress", timeout=10))
read = p["directions"]["read"]
assert read["shards_done"] == read["shards_total"] > 0, p
assert read["records"] == {n} and read["bytes_compressed"] > 0, p
s = json.load(urllib.request.urlopen(f"http://{{addr}}/spans?n=7", timeout=10))
assert len(s["spans"]) == 7 and s["dropped_spans"] == 0
slo = json.load(urllib.request.urlopen(f"http://{{addr}}/slo", timeout=10))
assert slo["enabled"] is False and slo["process_id"] == 3, slo
try:
    urllib.request.urlopen(f"http://{{addr}}/nope", timeout=10)
except urllib.error.HTTPError as e:
    assert e.code == 404
else:
    raise AssertionError("404 expected")
print("ENDPOINTS-OK")
"""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DISQ_TPU")}
    env.update(DISQ_TPU_TORCH_INTROSPECT_PORT="0",
               DISQ_TPU_TORCH_PROCESS_ID="3")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ENDPOINTS-OK" in proc.stdout


def _status(addr, path, body=None):
    req = urllib.request.Request(f"http://{addr}{path}", data=body,
                                 method="POST" if body is not None
                                 else "GET")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def test_unported_planes_answer_like_reference():
    got_addr = start_introspect_server(0)
    want_addr = ref_introspect.start_introspect_server(0)
    probes = [("/sched/stats", None), ("/serve/stats", None),
              ("/serve/cachemap", None), ("/fleet/stats", None),
              ("/sched/lease", b'{"host": "a"}'),
              ("/query/reads", b'{"dataset": "d"}'),
              ("/fleet/query/reads", b"{}"), ("/serve/register", b"{}"),
              ("/query/reads", b"[1]"), ("/metrics", b"{}"),
              ("/unknown", None)]
    got = [_status(got_addr, p, b) for p, b in probes]
    want = [_status(want_addr, p, b) for p, b in probes]
    assert got == want
    assert got[:4] == [409, 503, 503, 503]


def test_healthz_degraded_is_http_503(big_bam):
    path, size, _ = big_bam
    addr = start_introspect_server(0)
    storage, _ = _stall_storage(size, workers=4)
    got = {}
    t = threading.Thread(
        target=lambda: got.setdefault("ds",
                                      storage.read("stallfault://" + path)))
    t.start()
    code, deadline = None, time.time() + 30
    while time.time() < deadline and code is None:
        try:
            urllib.request.urlopen(f"http://{addr}/healthz", timeout=5)
        except urllib.error.HTTPError as e:
            if e.code == 503:
                code = 503
                assert json.load(e)["status"] == "degraded"
        time.sleep(0.01)
    t.join(timeout=60)
    assert code == 503
    assert "ds" in got


def test_server_idempotent_and_stoppable():
    a = start_introspect_server(0)
    assert start_introspect_server(0) == a
    assert introspect_address() == a
    reset_introspection()
    assert introspect_address() is None


# -- progress -------------------------------------------------------------------------


def test_progress_log_written_and_replayable(small_bam, tmp_path):
    path, n = small_bam
    plog = str(tmp_path / "progress.jsonl")
    ds = P.ReadsStorage.make_default(device="cpu").split_size(32 * 1024) \
        .executor_workers(2).progress_log(plog).read(path)
    assert ds.count() == n
    recs = [json.loads(ln) for ln in open(plog).read().splitlines()]
    metas = [r for r in recs if r.get("meta")]
    assert metas and metas[0]["kind"] == "progress"
    last = [r for r in recs if r.get("direction") == "read"][-1]
    assert last["shards_done"] == last["shards_total"] > 0
    assert last["records"] == n
    assert {"in_flight", "records_per_sec", "elapsed_s", "eta_s"} <= set(last)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "trace_report.py"),
         plog, "--progress"], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "progress replay" in proc.stdout and "[read]" in proc.stdout
    assert f"{n:,} records" in proc.stdout


@pytest.mark.parametrize("fmt", ["bam", "cram", "vcf.bgz", "bcf"])
def test_every_source_feeds_progress(small_bam, tmp_path, fmt):
    """Each source books its splits through ``note_shard_counters``:
    the progress view's records equal the dataset's."""
    path, n = small_bam
    plog = str(tmp_path / "p.jsonl")
    if fmt in ("bam", "cram"):
        storage = P.ReadsStorage.make_default(device="cpu")
        if fmt == "cram":
            ds = storage.read(path)
            path = str(tmp_path / "x.cram")
            storage.write(ds, path)
        want = n
    else:
        storage = P.VariantsStorage.make_default(device="cpu")
        src = str(tmp_path / "in.vcf")
        lines = ["##fileformat=VCFv4.2", "##contig=<ID=chr1,length=1000000>",
                 '##INFO=<ID=DP,Number=1,Type=Integer,Description="depth">',
                 '##FILTER=<ID=PASS,Description="passed">',
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
        lines += [f"chr1\t{100 + 7 * i}\t.\tA\tC\t50\tPASS\tDP={i}"
                  for i in range(3000)]
        open(src, "w").write("\n".join(lines) + "\n")
        path = str(tmp_path / f"x.{fmt}")
        storage.num_shards(3).write(storage.read(src), path)
        want = 3000
    before = counter("progress.records").total()
    ds = storage.split_size(16 * 1024).progress_log(plog).read(path)
    assert ds.count() == want
    view = HEALTH.progress()["directions"]["read"]
    assert view["shards_done"] == view["shards_total"] > 0
    if fmt == "bcf":
        # as in the reference, a BCF split books blocks and bytes: its
        # records decode after the splits, from the joined stream
        want = 0
        assert view["bytes_compressed"] > 0
    assert counter("progress.records").total() - before == want
    assert view["records"] == want


def test_progress_counters_booked(small_bam, tmp_path):
    path, n = small_bam
    before = counter("progress.records").total()
    P.ReadsStorage.make_default(device="cpu").split_size(64 * 1024) \
        .progress_log(str(tmp_path / "p.jsonl")).read(path)
    assert counter("progress.records").total() - before == n
    assert counter("progress.shards").value(direction="read") > 0


# -- the ledgers' run id ------------------------------------------------------------------


def test_ledgers_carry_the_run_id(tmp_path):
    from disq_tpu_torch.runtime.manifest import QuarantineManifest, StageManifest

    q = QuarantineManifest(str(tmp_path / "q"))
    q.quarantine("a.bam", 100, b"AAA")
    [entry] = q.entries
    assert entry["run_id"] == RUN_ID
    lines = [json.loads(ln) for ln in open(q.path).read().splitlines()]
    assert lines[0] == {"version": 1} and lines[1]["run_id"] == RUN_ID
    path = str(tmp_path / "m.json")
    m = StageManifest(path, params={"x": 1})
    m.mark_done("write.parts", 0, {"part": "p0"})
    r = StageManifest(path, params={"x": 1})
    assert r.shard_info("write.parts", 0) == {"part": "p0"}
    assert r.shard_run_id("write.parts", 0) == RUN_ID
    assert json.load(open(path))["run_id"] == RUN_ID
