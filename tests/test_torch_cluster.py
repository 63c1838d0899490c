"""The port's cluster rollup (``disq_tpu_torch/runtime/cluster.py``) and
process identity (``runtime/multihost.py``) against ``disq_tpu``'s, on
the CPU.

The cases of ``tests/test_cluster.py``: exposition parsing, the merged
metrics / progress / health / SLO / serve views over hand-built workers
(each view equal to the reference aggregator's over the same workers,
exactly), and the end to end over subprocess workers that import only
``disq_tpu_torch`` and take their ids from ``DISQ_TPU_TORCH_PROCESS_ID``:
distinct ``process`` labels, rollups equal to per-process sums, the
served rollup endpoint, a dead worker, workers that claim one id, and
the reference's ``scripts/metrics_aggregate.py`` over the port's
endpoints. Also ``plan_axes`` and the ``process_id`` / ``process_count``
resolution against the reference's.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

from disq_tpu.runtime import cluster as ref_cluster
from disq_tpu.runtime import multihost as ref_multihost
from disq_tpu_torch.runtime import cluster, multihost
from disq_tpu_torch.runtime.cluster import ClusterAggregator, parse_metrics_text
from disq_tpu_torch.runtime.tracing import reset_telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODS = (cluster, ref_cluster)

EXPO = """\
# TYPE disq_tpu_process_info gauge
disq_tpu_process_info{process_id="2",run_id="r2"} 1
# TYPE disq_tpu_progress_records counter
disq_tpu_progress_records 1200
# TYPE disq_tpu_retry_attempts counter
disq_tpu_retry_attempts{what="shard.fetch"} 3
# TYPE disq_tpu_executor_fetch_seconds histogram
disq_tpu_executor_fetch_seconds_bucket{shard="0",le="0.005"} 2
disq_tpu_executor_fetch_seconds_bucket{shard="0",le="+Inf"} 2
disq_tpu_executor_fetch_seconds_sum{shard="0"} 0.004
disq_tpu_executor_fetch_seconds_count{shard="0"} 2
"""


@pytest.fixture(autouse=True)
def _clean_telemetry():
    reset_telemetry()
    yield
    reset_telemetry()


# -- parsing ---------------------------------------------------------------------


@pytest.mark.parametrize("text", [
    EXPO, "not a sample\n# random comment\nname_only\n",
    'x{a="q\\"uote",b="2"} 1e3\n# TYPE y gauge\ny -4.5\nz{} +Inf\n',
])
def test_parse_metrics_text_equals_reference(text):
    assert parse_metrics_text(text) == ref_cluster.parse_metrics_text(text)


def test_kinds_and_samples():
    kinds, samples = parse_metrics_text(EXPO)
    assert kinds["disq_tpu_progress_records"] == "counter"
    assert kinds["disq_tpu_executor_fetch_seconds"] == "histogram"
    by_name = {}
    for name, labels, value in samples:
        by_name.setdefault(name, []).append((labels, value))
    assert by_name["disq_tpu_progress_records"] == [((), 1200.0)]
    assert by_name["disq_tpu_retry_attempts"] == [
        ((("what", "shard.fetch"),), 3.0)]
    assert parse_metrics_text("garbage\n") == ({}, [])


# -- merges over hand-built workers -----------------------------------------------


def _fake_worker(mod, pid, records, retries, active=False, done=4):
    w = mod.WorkerState(f"w{pid}")
    w.ok = True
    w.process_id = pid
    w.kinds, w.samples = mod.parse_metrics_text(
        "# TYPE disq_tpu_progress_records counter\n"
        f"disq_tpu_progress_records {records}\n"
        "# TYPE disq_tpu_retry_attempts counter\n"
        f'disq_tpu_retry_attempts{{what="x"}} {retries}\n'
        "# TYPE disq_tpu_executor_fetch_seconds histogram\n"
        f'disq_tpu_executor_fetch_seconds_bucket{{le="0.1"}} {pid + 1}\n'
        f'disq_tpu_executor_fetch_seconds_bucket{{le="+Inf"}} {pid + 2}\n')
    w.progress = {
        "run_id": f"run{pid}", "process_id": pid,
        "directions": {"read": {
            "active": active, "shards_total": 4, "shards_done": done,
            "in_flight": 0, "records": records, "bytes_compressed": 10,
            "bytes_uncompressed": 30, "records_per_sec": 100.0,
            "shards_per_sec": 2.0, "elapsed_s": 1.5,
            "eta_s": 0.0 if done == 4 else 1.0,
        }},
    }
    w.healthz = {"status": "ok"}
    return w


def _views(mod, **worker_kw):
    agg = mod.ClusterAggregator(["w0:1", "w1:1"])
    workers = [_fake_worker(mod, 0, 700, 1, **worker_kw),
               _fake_worker(mod, 1, 500, 2, **worker_kw)]
    degraded = _fake_worker(mod, 2, 1, 0)
    degraded.healthz = {"status": "degraded", "stalls": [{"shard": 3}]}
    dead = mod.WorkerState("w3:1")
    dead.ok = False
    dead.error = "ConnectionRefusedError: x"
    health = agg.healthz(workers + [degraded, dead])
    return (agg.metrics_text(workers), agg.progress(workers),
            agg.healthz(workers), health)


@pytest.mark.parametrize("active,done", [(False, 4), (True, 2)])
def test_merged_views_equal_reference(active, done):
    got = _views(cluster, active=active, done=done)
    want = _views(ref_cluster, active=active, done=done)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        for doc in (g, w):
            doc.pop("epoch", None)
            doc.pop("ts", None)
        assert g == w


def test_metrics_rollup_equals_per_process_sum():
    text = _views(cluster)[0]
    _kinds, samples = parse_metrics_text(text)
    recs = {labels: v for name, labels, v in samples
            if name == "disq_tpu_progress_records"}
    assert recs[(("process", "0"),)] == 700.0
    assert recs[(("process", "1"),)] == 500.0
    assert recs[()] == 1200.0
    assert 'disq_tpu_cluster_workers{state="ok"} 2' in text


def test_progress_and_health_views():
    _text, prog, ok, health = _views(cluster)
    read = prog["directions"]["read"]
    assert read["shards_total"] == read["shards_done"] == 8
    assert read["records"] == 1200 and read["records_per_sec"] == 200.0
    assert set(prog["processes"]) == {"0", "1"}
    assert ok["status"] == "ok"
    assert health["status"] == "degraded"
    assert {p["status"] for p in health["problems"]} == {"degraded",
                                                        "unreachable"}
    eta = _views(cluster, active=True, done=2)[1]["directions"]["read"]
    assert eta["eta_s"] == pytest.approx(1.0)


def _slo_and_serve(mod):
    agg = mod.ClusterAggregator(["s0:1", "s1:1"])
    w0, w1 = _fake_worker(mod, 0, 1, 0), _fake_worker(mod, 1, 1, 0)
    w0.slo = {"enabled": True, "tenants": {"t0": {
        "fast_burn": True, "windows": {
            "60": {"burn": 20.0, "availability_burn": None},
            "300": {"burn": 15.0, "availability_burn": None}}}}}
    w1.slo = {"enabled": True, "tenants": {
        "t0": {"fast_burn": False, "windows": {
            "60": {"burn": 0.5, "availability_burn": 1.5}}},
        "t1": {"fast_burn": False, "windows": {
            "60": {"burn": 0.0, "availability_burn": 0.2}}}}}
    w0.serve_stats = {"admission": {"slots": 4, "queue_depth": 8,
                                    "tenants": {"t0": {
                                        "active": 2, "queued": 1,
                                        "oldest_wait_s": 0.5}}}}
    w1.serve_stats = {}
    dead = mod.WorkerState("s2:1")
    dead.ok = False
    dead.error = "ConnectionRefusedError: x"
    return agg.slo([w0, w1, dead]), agg.serve_stats([w0, w1, dead])


def test_slo_and_serve_merges_equal_reference():
    got, want = _slo_and_serve(cluster), _slo_and_serve(ref_cluster)
    assert got == want
    slo = got[0]
    assert slo["fast_burn_tenants"] == ["t0"]
    assert slo["tenants"]["t0"]["worst_burn"] == 20.0
    assert slo["tenants"]["t1"]["worst_burn"] == 0.2
    assert got[1]["serving"] == 1


def test_requires_endpoints():
    with pytest.raises(ValueError):
        ClusterAggregator([])


# -- process identity -------------------------------------------------------------


@pytest.mark.parametrize("args", [(8, 2), (8, 1), (4, 4), (6, 4), (0, 1),
                                  (4, 0)])
def test_plan_axes_equals_reference(args):
    try:
        want = ref_multihost.plan_axes(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            multihost.plan_axes(*args)
        assert str(got.value) == str(e)
    else:
        assert multihost.plan_axes(*args) == want


@pytest.mark.parametrize("raw,want_id,want_count", [
    (None, 0, 1), ("3", 3, 3), ("-2", 0, 1), ("x", 0, 1), ("", 0, 1),
])
def test_process_identity_resolution(monkeypatch, raw, want_id, want_count):
    for knob in ("DISQ_TPU_TORCH_PROCESS_ID", "DISQ_TPU_TORCH_PROCESS_COUNT",
                 "DISQ_TPU_PROCESS_ID", "DISQ_TPU_PROCESS_COUNT"):
        monkeypatch.delenv(knob, raising=False)
    if raw is not None:
        monkeypatch.setenv("DISQ_TPU_TORCH_PROCESS_ID", raw)
        monkeypatch.setenv("DISQ_TPU_TORCH_PROCESS_COUNT", raw)
        monkeypatch.setenv("DISQ_TPU_PROCESS_ID", raw)
        monkeypatch.setenv("DISQ_TPU_PROCESS_COUNT", raw)
    assert multihost.process_id() == want_id
    assert multihost.process_count() == want_count
    if raw is not None and raw not in ("x", ""):
        # the reference reads its own knob the same way
        assert ref_multihost.process_id() == multihost.process_id()


def test_process_identity_follows_torch_distributed(tmp_path):
    code = (
        "import sys, torch.distributed as dist\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from disq_tpu_torch.runtime.multihost import process_id, "
        "process_count\n"
        "assert (process_id(), process_count()) == (0, 1)\n"
        f"dist.init_process_group('gloo', init_method="
        f"'file://{tmp_path}/rdv', rank=0, world_size=1)\n"
        "print(process_id(), process_count())\n"
        "dist.destroy_process_group()\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DISQ_TPU")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["0", "1"]


# -- end to end over subprocess workers ------------------------------------------------


WORKER_CODE = """\
import sys
sys.path.insert(0, {repo!r})
from disq_tpu_torch.runtime.introspect import HEALTH, start_introspect_server
from disq_tpu_torch.runtime.tracing import counter

records = int(sys.argv[1])
counter("retry.attempts").inc(int(sys.argv[2]), what="bench")
tok = HEALTH.register_run("read", 4)
for s in range(4):
    HEALTH.beat(tok, "fetch", s)
    HEALTH.shard_done(tok, s)
HEALTH.note_counters("read", records=records, bytes_compressed=records)
HEALTH.finish_run(tok)
assert "disq_tpu" not in sys.modules and "jax" not in sys.modules
addr = start_introspect_server(0)
print("ADDR", addr, flush=True)
sys.stdin.readline()
"""


def _start_workers(specs):
    procs, addrs = [], []
    code = WORKER_CODE.format(repo=REPO)
    for pid, records, retries in specs:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DISQ_TPU")}
        env.update(DISQ_TPU_TORCH_PROCESS_ID=str(pid),
                   DISQ_TPU_TORCH_PROCESS_COUNT="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(records), str(retries)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=env, cwd=REPO))
    for p in procs:
        line = p.stdout.readline()
        assert line.startswith("ADDR "), line
        addrs.append(line.split()[1])
    return procs, addrs


def _stop_workers(procs):
    for p in procs:
        try:
            p.stdin.close()
        except OSError:
            pass
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()


@pytest.fixture()
def two_workers():
    procs, addrs = _start_workers([(0, 800, 2), (1, 300, 5)])
    try:
        yield procs, addrs
    finally:
        _stop_workers(procs)


def test_aggregates_two_workers_with_distinct_labels(two_workers):
    _procs, addrs = two_workers
    for mod in MODS:  # the reference's aggregator reads the port too
        agg = mod.ClusterAggregator(addrs, timeout_s=10)
        workers = agg.scrape()
        assert all(w.ok for w in workers)
        assert sorted(w.process_id for w in workers) == [0, 1]
        _kinds, samples = mod.parse_metrics_text(agg.metrics_text(workers))
        recs = {labels: v for name, labels, v in samples
                if name == "disq_tpu_progress_records"}
        assert recs[(("process", "0"),)] == 800.0
        assert recs[(("process", "1"),)] == 300.0
        assert recs[()] == 1100.0
        retries = {labels: v for name, labels, v in samples
                   if name == "disq_tpu_retry_attempts"}
        assert retries[(("what", "bench"),)] == 7.0
        read = agg.progress(workers)["directions"]["read"]
        assert read["shards_total"] == read["shards_done"] == 8
        assert read["records"] == 1100
        assert agg.healthz(workers)["status"] == "ok"


def test_served_rollup_endpoint(two_workers):
    _procs, addrs = two_workers
    agg = ClusterAggregator(addrs, timeout_s=10)
    addr = agg.serve(0)
    try:
        with urllib.request.urlopen(f"http://{addr}/metrics",
                                    timeout=10) as resp:
            text = resp.read().decode()
        assert 'disq_tpu_progress_records{process="0"} 800' in text
        assert 'disq_tpu_cluster_workers{state="ok"} 2' in text
        with urllib.request.urlopen(f"http://{addr}/progress",
                                    timeout=10) as resp:
            assert json.loads(resp.read())["directions"]["read"][
                "records"] == 1100
        with urllib.request.urlopen(f"http://{addr}/healthz",
                                    timeout=10) as resp:
            assert json.loads(resp.read())["status"] == "ok"
    finally:
        agg.close()


def test_dead_worker_degrades_cluster_health(two_workers):
    procs, addrs = two_workers
    procs[1].kill()
    procs[1].wait(timeout=10)
    agg = ClusterAggregator(addrs, timeout_s=3, min_scrape_interval_s=0.0)
    deadline = time.time() + 20
    while time.time() < deadline:
        doc = agg.healthz(agg.scrape())
        if doc["status"] == "degraded":
            break
        time.sleep(0.2)
    assert doc["status"] == "degraded"
    assert any(p["status"] == "unreachable" for p in doc["problems"])
    assert doc["workers_ok"] == 1


def test_duplicate_reported_ids_get_unique_labels():
    procs, addrs = _start_workers([(0, 600, 1), (0, 400, 1)])
    try:
        agg = ClusterAggregator(addrs, timeout_s=10)
        workers = agg.scrape()
        assert sorted(w.process_id for w in workers) == [0, 1]
        _k, samples = parse_metrics_text(agg.metrics_text(workers))
        recs = {labels: v for name, labels, v in samples
                if name == "disq_tpu_progress_records"}
        assert sorted(v for ls, v in recs.items() if ls) == [400.0, 600.0]
        assert recs[()] == 1000.0
        assert set(agg.progress(workers)["processes"]) == {"0", "1"}
    finally:
        _stop_workers(procs)


def test_metrics_aggregate_cli_reads_port_workers(two_workers):
    _procs, addrs = two_workers
    script = os.path.join(REPO, "scripts", "metrics_aggregate.py")
    proc = subprocess.run([sys.executable, script, "--endpoints",
                           ",".join(addrs), "--once", "progress"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["directions"]["read"]["records"] == 1100
    assert doc["workers_ok"] == 2
