"""The port's shard scheduler (``disq_tpu_torch/runtime/scheduler.py``)
against ``disq_tpu``'s, on the CPU.

The cases of ``tests/test_scheduler.py`` on the port: the coordinator on
an injected clock, the HTTP plane on a live ephemeral endpoint, the
scheduled read (one worker emits the static sequence; two workers
partition the splits exactly once), the SIGKILL handoff through a shared
``ReadLedger``, fairness, write direction, the journal, rediscovery, the
coordinator's SIGKILL with a standby's takeover, and the write lease's
SIGKILL. Subprocess workers import only ``disq_tpu_torch`` and are
configured by ``DISQ_TPU_TORCH_SCHED*``.

Parity with the reference: one scripted schedule through both
``ShardCoordinator``s gives equal answers and fingerprints; each
package's ``replay_journal`` rebuilds the other's live state from its
journal; scheduled BAM, CRAM and VCF reads equal ``disq_tpu``'s static
reads (columns and ``ds.counters``); and a leased 8-shard write is
byte-identical to ``disq_tpu``'s unscheduled write.

Every wait is bounded.
"""

import hashlib
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import fields

import numpy as np
import pytest

import disq_tpu.api as R
from bam_oracle import DEFAULT_REFS, make_bam_bytes, o_bgzf_compress, synth_records
from disq_tpu.runtime import scheduler as ref_sched
from disq_tpu.runtime.errors import CoordinatorLostError as RefLost
from disq_tpu.runtime.manifest import SchedJournal as RefJournal
import disq_tpu_torch as P
from disq_tpu_torch.runtime import introspect, scheduler
from disq_tpu_torch.runtime.columnar import as_read_batch
from disq_tpu_torch.runtime.manifest import SchedJournal
from disq_tpu_torch.runtime.scheduler import (
    SchedulerClient,
    ShardCoordinator,
    _scheduled_iter,
    client_for_storage,
    scheduled_map_ordered,
)
from disq_tpu_torch.util import shutdown_shared_host_pool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READ_FIELDS = ("refid", "pos", "mapq", "flag", "next_refid", "next_pos",
               "tlen", "seqs", "quals", "names", "cigars", "seq_offsets",
               "name_offsets")
SUBPROCESS_S = 120  # the bound of every wait on a subprocess


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    yield
    shutdown_shared_host_pool()


@pytest.fixture
def clean():
    """Forget the coordinator and stop the endpoint after a case (both
    packages': a parity case may arm the reference's)."""
    from disq_tpu.runtime.introspect import reset_introspection

    yield
    scheduler.stop_coordinator()
    introspect.reset_introspection()
    ref_sched.stop_coordinator()
    reset_introspection()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def register_run(coord, host="A", n=6, key="k"):
    return coord.join(host, {
        "key": key, "path": "p",
        "shards": {str(i): [i * 100, (i + 1) * 100] for i in range(n)},
    })


def _port():
    return P.ReadsStorage.make_default(device="cpu")


def _digest(batch) -> str:
    batch = as_read_batch(batch)
    h = hashlib.sha1()
    for f in ("refid", "pos", "flag", "seqs", "quals", "names"):
        h.update(np.ascontiguousarray(getattr(batch, f)).tobytes())
    return h.hexdigest()


def _fixture(tmp_path, n=1500, seed=3):
    p = tmp_path / "in.bam"
    p.write_bytes(make_bam_bytes(DEFAULT_REFS, synth_records(n, seed=seed),
                                 blocksize=600))
    return str(p)


def _split_digests(storage, path):
    """{shard id: digest} of a static read through the port's source."""
    from disq_tpu_torch.bam.source import BamSource, read_header
    from disq_tpu_torch.fsw.filesystem import resolve_path
    from disq_tpu_torch.runtime.errors import context_for_storage

    src = BamSource(storage)
    fs, p = resolve_path(path)
    header, fv = read_header(fs, p)
    batches = src.read_split_batches(fs, p, header, fv,
                                     context_for_storage(storage, p))
    return {str(c.shard_id): _digest(b)
            for c, b in zip(src._last_counters, batches)}


def _counters(c):
    return {f.name: getattr(c, f.name) for f in fields(c)
            if f.name != "wall_seconds"}


def _wait_for(cond, what, proc=None, timeout=SUBPROCESS_S):
    """Poll ``cond()`` until it returns a true value (returned), failing
    if ``proc`` exits first or ``timeout`` passes."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            pytest.fail(f"subprocess exited early ({what}): "
                        + proc.stderr.read().decode()[-800:])
        got = cond()
        if got:
            return got
        time.sleep(0.02)
    pytest.fail(f"never reached: {what}")


def _env(**knobs):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DISQ_TPU_TORCH_SCHED")}
    env.update({f"DISQ_TPU_TORCH_{k}": str(v) for k, v in knobs.items()})
    return env


# -- the coordinator ----------------------------------------------------------


class TestCoordinator:
    def test_lease_fifo_ascending_and_done(self):
        c = ShardCoordinator(clock=FakeClock())
        doc = register_run(c)
        assert doc["registered"] and doc["members"] == 1
        r1 = c.lease("A", "k", want=2)
        assert r1["shards"] == [0, 1] and r1["pending"] == 4
        r2 = c.lease("A", "k", want=10)
        assert r2["shards"] == [2, 3, 4, 5] and r2["pending"] == 0
        for s in range(6):
            d = c.done("A", "k", s)
            assert d["won"]
        assert d["finished"]
        assert c.lease("A", "k")["finished"]

    def test_join_idempotent_second_registration_ignored(self):
        c = ShardCoordinator(clock=FakeClock())
        assert register_run(c)["registered"]
        assert not register_run(c, host="B")["registered"]
        assert c.stats()["runs"]["k"]["shards"] == 6

    def test_unknown_run_is_an_error_not_a_crash(self):
        c = ShardCoordinator(clock=FakeClock())
        assert "error" in c.lease("A", "nope")
        assert "error" in c.done("A", "nope", 0)
        assert "error" in c.steal("A", "nope")

    def test_locality_routes_cached_range_first(self):
        c = ShardCoordinator(clock=FakeClock())
        register_run(c)
        # B's cache holds blocks 4 and 5 of 100 bytes: shards 4 and 5
        # lease first although 0-3 are older
        r = c.lease("B", "k", want=2, block_size=100, blocks=[4, 5])
        assert r["shards"] == [4, 5]
        run = c.stats()["runs"]["k"]
        assert run["locality_hits"] == 2 and run["locality_misses"] == 0
        r = c.lease("A", "k", want=2)  # no hint: queue order, misses
        assert r["shards"] == [0, 1]
        run = c.stats()["runs"]["k"]
        assert run["locality_misses"] == 2
        assert run["locality_hit_rate"] == 0.5

    def test_lease_expiry_requeues_and_books_member_loss(self):
        clock = FakeClock()
        c = ShardCoordinator(lease_s=5.0, clock=clock)
        register_run(c)
        assert c.lease("A", "k", want=2)["shards"] == [0, 1]
        clock.t = 5.1  # past lease_s: A's leases expire on B's request
        r = c.lease("B", "k", want=10)
        assert r["shards"] == [0, 1, 2, 3, 4, 5]
        run = c.stats(key="k")["runs"]["k"]
        assert sorted(run["requeued"]) == [0, 1]
        # A silent past 2 x lease_s with no lease left is dropped; B
        # leased at 5.1, so at 14.0 it is still inside its window
        clock.t = 14.0
        assert "A" not in c.stats()["members"]
        assert "B" in c.stats()["members"]

    def test_steal_takes_oldest_stale_lease_from_most_loaded(self):
        clock = FakeClock()
        c = ShardCoordinator(lease_s=100.0, steal_after_s=1.0, clock=clock)
        register_run(c)
        c.lease("A", "k", want=4)          # A holds 0..3
        clock.t = 0.5
        c.lease("B", "k", want=2)          # B holds 4, 5 (younger)
        assert c.steal("C", "k")["shards"] == []  # nothing stale yet
        clock.t = 1.2                      # A's leases stale, B's not
        r = c.steal("C", "k")
        assert r["shards"] == [0] and r["victim"] == "A"
        assert c.done("A", "k", 0)["won"]          # the victim first
        assert not c.done("C", "k", 0)["won"]      # the thief's dropped
        run = c.stats()["runs"]["k"]
        assert run["stolen"] == [0] and run["done"]["0"] == "A"

    def test_done_idempotent_for_winner_loses_for_other_host(self):
        c = ShardCoordinator(clock=FakeClock())
        register_run(c)
        c.lease("A", "k", want=1)
        assert c.done("A", "k", 0)["won"]
        assert c.done("A", "k", 0)["won"]      # a retried POST: still won
        assert not c.done("B", "k", 0)["won"]  # a lost race: dropped

    def test_stale_epoch_callers_are_fenced_off_the_new_pass(self):
        c = ShardCoordinator(clock=FakeClock())
        assert register_run(c, host="A")["epoch"] == 1
        for s in range(6):
            c.lease("A", "k", want=1)
            c.done("A", "k", s, epoch=1)
        e2 = register_run(c, host="A")  # A registers again: a new pass
        assert e2["registered"] and e2["epoch"] == 2
        r = c.lease("B", "k", want=4, epoch=1)
        assert r["shards"] == [] and r["finished"] and r["stale"]
        assert c.steal("B", "k", epoch=1)["stale"]
        assert not c.done("B", "k", 3, epoch=1)["won"]
        assert 3 in c.stats()["runs"]["k"]["pending"]  # pass 2 intact

    def test_static_filter_restricts_to_residue_class(self):
        c = ShardCoordinator(clock=FakeClock())
        register_run(c)
        assert c.lease("A", "k", want=10, static_of=(1, 2))["shards"] == \
            [1, 3, 5]
        assert c.lease("A", "k", want=10, static_of=(1, 2))["shards"] == []
        assert c.lease("B", "k", want=10, static_of=(0, 2))["shards"] == \
            [0, 2, 4]

    def test_late_done_of_expired_lease_still_wins_once(self):
        clock = FakeClock()
        c = ShardCoordinator(lease_s=1.0, clock=clock)
        register_run(c)
        c.lease("A", "k", want=1)
        clock.t = 1.5
        assert 0 in c.stats()["runs"]["k"]["pending"]  # swept back
        assert c.done("A", "k", 0)["won"]  # the late completion wins
        assert 0 not in c.stats()["runs"]["k"]["pending"]
        assert 0 not in c.lease("B", "k", want=10)["shards"]


def test_concurrent_hosts_lease_each_shard_once():
    """More hosts than cores hammer one coordinator with a short switch
    interval: every shard is leased by one host and done once."""
    n_shards, n_hosts = 400, 32
    c = ShardCoordinator(lease_s=600.0)
    register_run(c, n=n_shards)
    got, lost = {}, []
    lock = threading.Lock()
    deadline = time.monotonic() + 30.0  # a lost update strands a shard

    def host(name):
        try:
            while time.monotonic() < deadline:
                r = c.lease(name, "k", want=3)
                if not r["shards"]:
                    if r["finished"]:
                        return
                    continue
                for s in r["shards"]:
                    with lock:
                        got.setdefault(s, []).append(name)
                    if not c.done(name, "k", s)["won"]:
                        lost.append(s)
        except Exception as e:  # noqa: BLE001 — failed below
            lost.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=host, args=(f"h{i}",),
                                    daemon=True) for i in range(n_hosts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not lost
    assert sorted(got) == list(range(n_shards))
    assert all(len(hosts) == 1 for hosts in got.values())
    run = c.stats()["runs"]["k"]
    assert run["finished"] and not run["pending"] and not run["leases"]


# -- parity with the reference's coordinator ---------------------------------


def _schedule(coord, clock):
    """One schedule of every transition: two runs, locality, a quota
    that binds, expiry, a steal, a lost race, a static lease, a fenced
    epoch, a finished pass started again. Returns every answer."""
    table = {str(i): ([i * 100, i * 100 + 100] if i % 2 else None)
             for i in range(8)}
    out = [coord.join("A", {"key": "r1", "path": "p1", "shards": table}),
           coord.join("B", {"key": "r1", "path": "p1", "shards": table}),
           coord.join("B", {"key": "r2", "path": "p2", "weight": 3.0,
                            "shards": {str(i): None for i in range(4)}}),
           coord.lease("A", "r1", want=3, block_size=100, blocks=[5, 7])]
    clock.t = 1.0
    out += [coord.lease("B", "r1", want=2),
            coord.lease("B", "r2", want=2),
            coord.lease("C", "r1", want=1, static_of=(0, 4)),
            coord.done("A", "r1", 5),
            coord.done("B", "r1", 5),        # a lost race
            coord.steal("C", "r1")]
    clock.t = 12.0
    out += [coord.lease("B", "r1", want=1),  # sweeps: expiries requeue
            coord.steal("A", "r1")]
    for s in range(4):
        out.append(coord.done("B", "r2", s, epoch=1))
    out += [coord.join("B", {"key": "r2", "path": "p2", "weight": 3.0,
                             "shards": {str(i): None for i in range(4)}}),
            coord.lease("B", "r2", want=2, epoch=1),   # fenced
            coord.lease("B", "r2", want=2, epoch=2),
            coord.join("D", {"key": "r2"}, rejoin=True)]
    clock.t = 40.0
    out.append(coord.stats())  # drops the silent members
    return out


def test_coordinator_answers_and_fingerprint_equal_reference():
    got_clock, want_clock = FakeClock(), FakeClock()
    got_c = ShardCoordinator(lease_s=10.0, clock=got_clock)
    want_c = ref_sched.ShardCoordinator(lease_s=10.0, clock=want_clock)
    got = _schedule(got_c, got_clock)
    want = _schedule(want_c, want_clock)
    assert got == want
    assert got_c.state_fingerprint() == want_c.state_fingerprint()
    assert got_c.stats() == want_c.stats()


def test_each_replay_rebuilds_the_other_packages_journal(tmp_path):
    """The port's replay of the reference's journal gives the
    reference's live state, and the other way round; the journals are
    the same bytes."""
    got_clock, want_clock = FakeClock(), FakeClock()
    got_j = SchedJournal(str(tmp_path / "port.jsonl"))
    want_j = RefJournal(str(tmp_path / "ref.jsonl"))
    got_c = ShardCoordinator(lease_s=10.0, clock=got_clock, journal=got_j)
    want_c = ref_sched.ShardCoordinator(lease_s=10.0, clock=want_clock,
                                        journal=want_j)
    _schedule(got_c, got_clock)
    _schedule(want_c, want_clock)
    got_j.close()
    want_j.close()
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()
    from_ref = scheduler.replay_journal(
        SchedJournal.load(str(tmp_path / "ref.jsonl")), lease_s=10.0)
    from_port = ref_sched.replay_journal(
        RefJournal.load(str(tmp_path / "port.jsonl")), lease_s=10.0)
    assert from_ref.state_fingerprint() == want_c.state_fingerprint()
    assert from_port.state_fingerprint() == got_c.state_fingerprint()


# -- the HTTP plane -----------------------------------------------------------


class TestHttpPlane:
    def test_endpoints_over_live_server(self, clean):
        addr = scheduler.serve_coordinator(lease_s=30.0)
        cl = SchedulerClient(addr, "hA", lease_n=2)
        doc = cl.join({"key": "httprun", "path": "p",
                       "shards": {str(i): [i, i + 1] for i in range(3)}})
        assert doc["registered"]
        assert cl.lease()["shards"] == [0, 1]
        assert cl.done(0)["won"]
        assert cl.done(0)["won"] is True  # the winner's retry stays won
        other = SchedulerClient(addr, "hB")
        other.run_key, other.epoch = cl.run_key, cl.epoch
        assert other.done(0)["won"] is False
        assert cl.lease()["shards"] == [2]
        for s in (1, 2):
            cl.done(s)
        assert cl.lease()["finished"]
        stats = json.load(urllib.request.urlopen(
            f"http://{addr}/sched/stats?run=httprun", timeout=10))
        assert stats["runs"]["httprun"]["finished"]
        assert set(stats["members"]) == {"hA", "hB"}

    def test_sched_paths_without_coordinator_answer_409(self, clean):
        addr = introspect.start_introspect_server(0)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://{addr}/sched/stats", timeout=10)
        assert ei.value.code == 409

    def test_bad_post_body_is_400_not_crash(self, clean):
        addr = scheduler.serve_coordinator()
        req = urllib.request.Request(
            f"http://{addr}/sched/lease", data=b"not json",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 400


# -- the scheduled read -------------------------------------------------------


class TestScheduledRead:
    def test_off_by_default_returns_inline_generator(self, clean):
        from disq_tpu_torch.runtime.executor import (
            ShardPipelineExecutor,
            ShardTask,
        )

        gen = scheduled_map_ordered(
            _port(), None, "x", ShardPipelineExecutor(workers=1),
            [ShardTask(shard_id=0, fetch=lambda: 1, decode=lambda p: p)])
        assert gen.gi_code.co_name == "_run_sequential"
        assert [r.value for r in gen] == [1]
        assert scheduler.active_coordinator() is None

    def test_client_for_storage_env_resolution(self, monkeypatch):
        st = _port()
        assert client_for_storage(st) is None
        for k, v in (("", "127.0.0.1:59999"), ("_LEASE_N", "5"),
                     ("_STEAL", "0"), ("_HOST", "hX"), ("_STATIC", "1,4")):
            monkeypatch.setenv("DISQ_TPU_TORCH_SCHED" + k, v)
        cl = client_for_storage(st)
        assert (cl.address, cl.host, cl.lease_n, cl.steal, cl.static_of,
                cl.serves) == ("127.0.0.1:59999", "hX", 5, False, (1, 4),
                               False)

    def test_single_worker_scheduled_read_byte_identical(self, tmp_path,
                                                         clean):
        path = _fixture(tmp_path)
        base = _port().split_size(4096).read(path)
        ds = _port().split_size(4096).scheduler("serve").read(path)
        assert ds.count() == base.count()
        got, want = as_read_batch(ds.reads), as_read_batch(base.reads)
        for f in READ_FIELDS:
            np.testing.assert_array_equal(getattr(want, f), getattr(got, f),
                                          err_msg=f)
        assert _counters(ds.counters) == _counters(base.counters)

    def test_repeated_read_starts_a_fresh_pass(self, tmp_path, clean):
        """A participant reading the same input again starts a new pass;
        a host that took no part in a finished pass gets nothing."""
        path = _fixture(tmp_path, n=400)
        st = _port().split_size(8192).scheduler("serve")
        first = st.read(path)
        second = st.read(path)
        assert second.count() == first.count() > 0
        cl = SchedulerClient(scheduler.serve_coordinator(), "latecomer")
        run_key = next(iter(scheduler.active_coordinator().stats()["runs"]))
        cl.join({"key": run_key, "path": path, "shards": {}})
        assert cl.lease()["finished"]

    def test_two_inprocess_workers_partition_exactly_once(self, tmp_path,
                                                          clean):
        import functools

        from disq_tpu_torch.bam.source import BamSource, read_header
        from disq_tpu_torch.fsw.filesystem import (
            compute_path_splits,
            resolve_path,
        )
        from disq_tpu_torch.runtime.errors import context_for_storage
        from disq_tpu_torch.runtime.executor import (
            ShardPipelineExecutor,
            ShardTask,
        )

        path = _fixture(tmp_path)
        addr = scheduler.serve_coordinator(lease_s=30.0, steal_after_s=0.05)
        truth = {int(k): v for k, v in
                 _split_digests(_port().split_size(4096), path).items()}
        fs, p = resolve_path(path)
        results, errors = {}, []

        def worker(host, delay):
            try:
                st = _port().split_size(4096)
                src = BamSource(st)
                hdr, first = read_header(fs, p)
                ctx = context_for_storage(st, p)
                splits = compute_path_splits(fs, p, 4096)
                bounds = src._split_boundaries(fs, p, hdr, first, splits,
                                               src._try_load_sbi(fs, p), ctx)
                tasks = []
                for i in range(len(splits)):
                    lo, hi = bounds[i], bounds[i + 1]
                    shard_ctx = ctx.for_shard(i)

                    def decode(fetched, _s=shard_ctx, _d=delay):
                        time.sleep(_d)  # the slow host: overlap, stealing
                        return src._decode_booked(hdr, fetched, _s)

                    tasks.append(ShardTask(
                        shard_id=i,
                        fetch=functools.partial(src._fetch_range, fs, p, lo,
                                                hi, shard_ctx),
                        decode=decode,
                        byte_range=(lo >> 16, (hi >> 16) + 1)))
                cl = SchedulerClient(addr, host, lease_n=2, steal=True)
                results[host] = {
                    res.shard_id: _digest(res.value[0])
                    for res in _scheduled_iter(
                        cl, st, fs, p, ShardPipelineExecutor(workers=1),
                        tasks, None)}
            except BaseException as e:  # noqa: BLE001 — failed below
                errors.append(e)

        slow = threading.Thread(target=worker, args=("slow", 0.12))
        fast = threading.Thread(target=worker, args=("fast", 0.0))
        slow.start()
        time.sleep(0.05)
        fast.start()
        slow.join(timeout=SUBPROCESS_S)
        fast.join(timeout=SUBPROCESS_S)
        assert not errors and not slow.is_alive() and not fast.is_alive()
        got = {}
        for shards in results.values():
            for sid, dig in shards.items():
                assert sid not in got, f"shard {sid} emitted twice"
                got[sid] = dig
        assert got == truth
        run = scheduler.active_coordinator().stats()["runs"][
            scheduler.run_key_for(p, len(truth))]
        assert run["finished"]
        assert len(set(run["done"].values())) == 2  # both took part


# -- the SIGKILL handoff ------------------------------------------------------

_KILL_WORKER = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
from disq_tpu_torch import ReadsStorage
from disq_tpu_torch.bam.source import BamSource, read_header
from disq_tpu_torch.fsw.filesystem import resolve_path
from disq_tpu_torch.runtime.errors import context_for_storage

# split {wedge}'s decode hangs: the worker leases, completes and spills
# the splits before it, then holds a live lease until it is killed
_orig = BamSource._decode_fetched

def _wedged(self, header, fetched, ctx=None):
    if ctx is not None and ctx.shard_id == {wedge}:
        time.sleep(300.0)
    return _orig(self, header, fetched, ctx)

BamSource._decode_fetched = _wedged
st = (ReadsStorage.make_default(device="cpu").split_size({split})
      .read_ledger({ledger!r}))
fs, p = resolve_path({path!r})
header, fv = read_header(fs, p)
BamSource(st).read_split_batches(fs, p, header, fv,
                                 context_for_storage(st, p))
os._exit(3)  # not reached: the wedge outlives the kill
"""

_SUCCESSOR_WORKER = r"""
import hashlib, json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np
from disq_tpu_torch import ReadsStorage
from disq_tpu_torch.bam.source import BamSource, read_header
from disq_tpu_torch.fsw.filesystem import resolve_path
from disq_tpu_torch.runtime.columnar import as_read_batch
from disq_tpu_torch.runtime.errors import context_for_storage

# the dead worker's path string (the run key and the ledger's
# fingerprint must match), no wedge
st = (ReadsStorage.make_default(device="cpu").split_size({split})
      .read_ledger({ledger!r}))
src = BamSource(st)
fs, p = resolve_path({path!r})
header, fv = read_header(fs, p)
batches = src.read_split_batches(fs, p, header, fv,
                                 context_for_storage(st, p))
digests = {{}}
for c, b in zip(src._last_counters, batches):
    b = as_read_batch(b)
    h = hashlib.sha1()
    for f in ("refid", "pos", "flag", "seqs", "quals", "names"):
        h.update(np.ascontiguousarray(getattr(b, f)).tobytes())
    digests[str(c.shard_id)] = h.hexdigest()
print(json.dumps(digests))
"""


class TestKillHandoff:
    def test_sigkill_requeues_exactly_unfinished_and_resumes_from_ledger(
            self, tmp_path, clean):
        """A leased worker is killed: the coordinator requeues exactly
        its unfinished leases, the successor decodes only those (the
        dead worker's finished splits come from its spills), and the
        assembled splits equal a one-host read."""
        from disq_tpu_torch.runtime.manifest import ReadLedger

        split = 32768
        # the fixture carries its SBI, so the victim reaches the queue
        # fast and its wedge fires in a leased split's decode
        raw = _fixture(tmp_path, n=9000, seed=9)
        path = str(tmp_path / "kill.bam")
        _port().num_shards(4).write(_port().read(raw), path,
                                    P.SbiWriteOption.ENABLE)
        ledger_dir = str(tmp_path / "ledger")
        wedge = 2  # lease_n 2: the victim finishes 0 and 1, wedges on 2
        truth = _split_digests(_port().split_size(split), path)
        assert len(truth) >= 5, "fixture too small for a handoff"

        addr = scheduler.serve_coordinator(lease_s=0.9, steal_after_s=0.3)
        victim = subprocess.Popen(
            [sys.executable, "-c", _KILL_WORKER.format(
                repo=REPO, path=path, split=split, wedge=wedge,
                ledger=ledger_dir)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            env=_env(SCHED=addr, SCHED_HOST="victim", SCHED_LEASE_N=2))
        run_key = scheduler.run_key_for(path, len(truth))
        try:
            def wedged():
                run = scheduler.active_coordinator().stats()["runs"].get(
                    run_key)
                if run and run["done"] and run["leases"] and max(
                        lease["age_s"]
                        for lease in run["leases"].values()) > 0.4:
                    return run
                return None

            run = _wait_for(wedged, "the victim wedged holding a lease",
                            victim)
        finally:
            victim.kill()
            victim.wait(timeout=SUBPROCESS_S)
        victim_done = set(run["done"])
        victim_leased = {int(s) for s in run["leases"]}
        assert victim_done and victim_leased

        # every finished split was spilled before its done
        ledger = ReadLedger(ledger_dir)
        assert {str(k) for k in ledger.completed_shards()} >= victim_done

        # no stealing: the successor gets the victim's splits through
        # lease expiry, so the exact requeue below is deterministic
        successor = subprocess.run(
            [sys.executable, "-c", _SUCCESSOR_WORKER.format(
                repo=REPO, path=path, split=split, ledger=ledger_dir)],
            capture_output=True, text=True, timeout=SUBPROCESS_S,
            env=_env(SCHED=addr, SCHED_HOST="successor", SCHED_LEASE_N=2,
                     SCHED_STEAL=0))
        assert successor.returncode == 0, successor.stderr[-800:]
        succ = json.loads(successor.stdout.strip().splitlines()[-1])

        run = scheduler.active_coordinator().stats()["runs"][run_key]
        assert run["finished"]
        assert set(run["requeued"]) == victim_leased
        # the successor decoded exactly what the victim had not finished
        assert set(succ) == set(truth) - victim_done
        assert {int(s) for s in run["done"]} == {int(s) for s in truth}
        for s in victim_done:
            assert run["done"][s] == "victim"
        assembled = dict(succ)
        for s in victim_done:
            batch, _stats, _books = ledger.load(int(s))
            assembled[s] = _digest(batch)
        assert assembled == truth


# -- fairness -----------------------------------------------------------------


class TestFairness:
    def test_single_run_never_throttled(self):
        c = ShardCoordinator(clock=FakeClock())
        register_run(c, n=8)
        assert len(c.lease("A", "k", want=8)["shards"]) == 8

    def test_weighted_run_holds_quota_share_under_saturating_batch(self):
        from disq_tpu_torch.runtime.tracing import counter

        g0 = counter("sched.quota.granted").total()
        d0 = counter("sched.quota.deferred").total()
        c = ShardCoordinator(clock=FakeClock())
        c.join("B", {"key": "batch", "path": "p1",
                     "shards": {str(i): None for i in range(16)}})
        c.join("L", {"key": "live", "path": "p2", "weight": 3.0,
                     "shards": {str(i): None for i in range(16)}})
        # the batch run asks for everything: capped at 1 of 4
        rb = c.lease("B", "batch", want=16)
        assert len(rb["shards"]) == 4
        rl = c.lease("L", "live", want=16)  # then at least 3 of 4
        assert len(rl["shards"]) == 15
        assert len(rl["shards"]) / (len(rb["shards"]) + len(rl["shards"])) \
            >= 3.0 / 4.0
        assert counter("sched.quota.granted").total() - g0 == 19
        assert counter("sched.quota.deferred").total() - d0 == 13
        # deferred, not starved: completions free its quota
        for s in rb["shards"]:
            c.done("B", "batch", s)
        assert len(c.lease("B", "batch", want=4)["shards"]) >= 1

    def test_every_run_keeps_at_least_one_lease(self):
        c = ShardCoordinator(clock=FakeClock())
        c.join("G", {"key": "big", "path": "p", "weight": 1000.0,
                     "shards": {str(i): None for i in range(32)}})
        c.join("T", {"key": "tiny", "path": "p2", "weight": 0.001,
                     "shards": {str(i): None for i in range(4)}})
        c.lease("G", "big", want=32)
        assert len(c.lease("T", "tiny", want=4)["shards"]) >= 1

    def test_quota_disengages_when_contender_finishes(self):
        c = ShardCoordinator(clock=FakeClock())
        register_run(c, host="A", n=4, key="r1")
        c.join("B", {"key": "r2", "path": "p2",
                     "shards": {str(i): None for i in range(4)}})
        for s in range(4):
            c.lease("B", "r2", want=1)
            c.done("B", "r2", s)
        assert len(c.lease("A", "r1", want=4)["shards"]) == 4


class TestWriteLeaseDirection:
    def test_direction_mismatch_is_an_error(self):
        c = ShardCoordinator(clock=FakeClock())
        register_run(c)  # a read-direction run
        assert "error" in c.lease("A", "k", want=1, direction="write")
        c.join("A", {"key": "w", "path": "p", "dir": "write",
                     "shards": {"0": None}})
        assert "error" in c.lease("A", "w", want=1, direction="read")
        assert c.lease("A", "w", want=1, direction="write")["shards"] == [0]


# -- the journal --------------------------------------------------------------


class TestJournalReplay:
    def test_journal_roundtrip_and_torn_tail(self, tmp_path):
        jp = str(tmp_path / "j.jsonl")
        j = SchedJournal(jp)
        j.append("run", key="k", t=0.0)
        j.append("lease", key="k", host="A", shards=[0], t=1.0)
        j.sync()
        j.close()
        assert [r["op"] for r in SchedJournal.load(jp)] == ["run", "lease"]
        with open(jp, "a") as f:  # a crash tears the last line
            f.write('{"op": "done", "ho')
        assert len(SchedJournal.load(jp)) == 2
        # a successor reopening the torn journal keeps its first append
        j2 = SchedJournal(jp)
        j2.append("takeover", host="B", pid=1)
        j2.close()
        assert SchedJournal.load(jp)[-1] == {"op": "takeover", "host": "B",
                                             "pid": 1}

    def test_foreign_journal_set_aside_not_replayed(self, tmp_path):
        jp = str(tmp_path / "j.jsonl")
        with open(jp, "w") as f:
            f.write("not a journal\n")
        assert SchedJournal.load(jp) == []
        j = SchedJournal(jp)
        j.append("run", key="k", t=0.0)
        j.close()
        assert [r["op"] for r in SchedJournal.load(jp)] == ["run"]
        assert os.path.exists(jp + ".bak")

    def test_replay_reproduces_live_fingerprint(self, tmp_path):
        jp = str(tmp_path / "j.jsonl")
        journal = SchedJournal(jp)
        clock = FakeClock()
        c = ShardCoordinator(lease_s=5.0, clock=clock, journal=journal)
        register_run(c, host="A")
        register_run(c, host="B")
        c.lease("A", "k", want=2)
        clock.t = 1.0
        c.lease("B", "k", want=2)
        c.done("A", "k", 0)
        clock.t = 6.0
        c.lease("B", "k", want=1)  # sweeps: A's stale lease requeues
        journal.sync()
        replayed = scheduler.replay_journal(SchedJournal.load(jp),
                                            lease_s=5.0)
        assert replayed.state_fingerprint() == c.state_fingerprint()

    def test_rejoin_never_restarts_a_finished_pass(self):
        c = ShardCoordinator(clock=FakeClock())
        register_run(c)
        for s in range(6):
            c.lease("A", "k", want=1)
            c.done("A", "k", s)
        assert c.stats()["runs"]["k"]["finished"]
        doc = {"key": "k", "path": "p",
               "shards": {str(i): [i * 100, (i + 1) * 100]
                          for i in range(6)}}
        r = c.join("A", doc, rejoin=True)
        assert not r["registered"] and r["epoch"] == 1
        assert c.lease("A", "k")["finished"]
        assert register_run(c)["registered"]  # a new read still does


# -- failover -----------------------------------------------------------------


class TestFailoverPlane:
    def test_advertise_discover_roundtrip(self, tmp_path):
        fdir = str(tmp_path / "fo")
        scheduler.advertise_coordinator(fdir, "127.0.0.1:12345")
        assert scheduler.discover_coordinator(fdir) == "127.0.0.1:12345"
        with pytest.raises(IOError):
            scheduler.discover_coordinator(str(tmp_path / "empty"),
                                           wait_s=0.1)

    def test_done_after_coordinator_restart_rejoins_then_wins(self, clean):
        addr = scheduler.serve_coordinator()
        cl = SchedulerClient(addr, "hA", lease_n=2)
        cl.join({"key": "r", "path": "p",
                 "shards": {str(i): None for i in range(3)}})
        assert cl.lease()["shards"] == [0, 1]
        scheduler.stop_coordinator()
        scheduler.serve_coordinator()  # the same endpoint, a blank queue
        d = cl.done(0)
        assert "error" not in d and d["won"]
        assert scheduler.active_coordinator().stats()["runs"]["r"][
            "done"]["0"] == "hA"

    def test_client_rediscovers_readvertised_coordinator(self, tmp_path,
                                                         clean):
        from disq_tpu_torch.runtime.tracing import counter

        fdir = str(tmp_path / "fo")
        addr1 = scheduler.serve_coordinator(lease_s=5.0, failover_dir=fdir)
        cl = SchedulerClient(addr1, "hA", lease_n=2, failover_dir=fdir,
                             lease_s=5.0)
        cl.join({"key": "r", "path": "p",
                 "shards": {str(i): None for i in range(4)}})
        assert cl.lease()["shards"] == [0, 1]
        r0 = counter("sched.failover.rediscoveries").total()
        scheduler.stop_coordinator()
        introspect.reset_introspection()  # the endpoint goes away too
        addr2 = scheduler.serve_coordinator(lease_s=5.0, failover_dir=fdir)
        assert addr2 != addr1
        d = cl.done(0)  # dead endpoint: rediscover, rejoin, win
        assert "error" not in d and d["won"]
        assert cl.address == addr2
        assert counter("sched.failover.rediscoveries").total() > r0

    def test_coordinator_lost_error_is_transient(self):
        from disq_tpu_torch.runtime.errors import (
            CoordinatorLostError,
            is_transient,
        )

        err = CoordinatorLostError("scheduler coordinator lost",
                                   address="x:1", op="lease")
        assert is_transient(err)
        assert "x:1" in str(err) and "lease" in str(err)
        assert str(err) == str(RefLost("scheduler coordinator lost",
                                       address="x:1", op="lease"))


_COORD_SERVER = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
from disq_tpu_torch.runtime import scheduler

# a coordinator that decodes nothing: after its death every split
# comes from the standby's own pass
addr = scheduler.serve_coordinator(lease_s=1.5, failover_dir={fdir!r})
scheduler.register_member({fdir!r}, "coord", addr)
print("up", flush=True)
time.sleep(600)
"""

_FAILOVER_WORKER = r"""
import hashlib, json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
from disq_tpu_torch import ReadsStorage
from disq_tpu_torch.bam.source import BamSource, read_header
from disq_tpu_torch.fsw.filesystem import resolve_path
from disq_tpu_torch.runtime import scheduler
from disq_tpu_torch.runtime.columnar import as_read_batch
from disq_tpu_torch.runtime.errors import context_for_storage

# every decode slowed, so the coordinator dies mid-pass with a lease
# table to replay
_orig = BamSource._decode_fetched

def _slowed(self, header, fetched, ctx=None):
    time.sleep(0.08)
    return _orig(self, header, fetched, ctx)

BamSource._decode_fetched = _slowed
st = (ReadsStorage.make_default(device="cpu").split_size({split})
      .read_ledger({ledger!r}))
src = BamSource(st)
fs, p = resolve_path({path!r})
header, fv = read_header(fs, p)
batches = src.read_split_batches(fs, p, header, fv,
                                 context_for_storage(st, p))
digests = {{}}
for c, b in zip(src._last_counters, batches):
    b = as_read_batch(b)
    h = hashlib.sha1()
    for f in ("refid", "pos", "flag", "seqs", "quals", "names"):
        h.update(np.ascontiguousarray(getattr(b, f)).tobytes())
    digests[str(c.shard_id)] = h.hexdigest()
print(json.dumps({{"took_over": scheduler.active_coordinator() is not None,
                   "shards": digests}}))
"""


class TestCoordinatorFailover:
    def test_coordinator_sigkill_standby_replays_and_finishes(
            self, tmp_path, clean):
        """The coordinator's process is killed mid-pass: the standby
        (the lowest live process id) wins the election, replays the
        journal and finishes the same pass, each split done once and the
        splits equal to a one-host read."""
        split = 4096
        path = _fixture(tmp_path, n=600, seed=5)
        fdir = str(tmp_path / "failover")
        jpath = os.path.join(fdir, "journal.jsonl")
        truth = _split_digests(_port().split_size(split), path)
        assert len(truth) >= 12, "fixture too small for a kill window"

        coord = subprocess.Popen(
            [sys.executable, "-c", _COORD_SERVER.format(repo=REPO,
                                                        fdir=fdir)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=_env(PROCESS_ID=9))
        worker = None
        try:
            scheduler.discover_coordinator(fdir, wait_s=SUBPROCESS_S)
            worker = subprocess.Popen(
                [sys.executable, "-c", _FAILOVER_WORKER.format(
                    repo=REPO, split=split, path=path,
                    ledger=str(tmp_path / "ledger"))],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                env=_env(SCHED="auto", SCHED_FAILOVER=fdir,
                         SCHED_HOST="standby", PROCESS_ID=1,
                         SCHED_LEASE_N=1, SCHED_LEASE_S=1.5,
                         SCHED_STEAL=0))

            def kill_window():
                if coord.poll() is not None:
                    pytest.fail("the coordinator exited early")
                recs = SchedJournal.load(jpath)
                joined = {r["host"] for r in recs if r["op"] == "join"}
                dones = sum(1 for r in recs if r["op"] == "done")
                return "standby" in joined and \
                    3 <= dones <= len(truth) - 6

            _wait_for(kill_window, "the kill window", worker)
            coord.kill()
            coord.wait(timeout=SUBPROCESS_S)
            out, err = worker.communicate(timeout=SUBPROCESS_S)
            assert worker.returncode == 0, err.decode()[-1000:]
        finally:
            for proc in (coord, worker):
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=SUBPROCESS_S)
        doc = json.loads(out.decode().strip().splitlines()[-1])
        assert doc["took_over"]  # the worker ended hosting the coordinator
        assert doc["shards"] == truth  # the dead coordinator decoded none
        recs = SchedJournal.load(jpath)
        assert sum(1 for r in recs if r["op"] == "run") == 1  # one pass
        takeovers = [r for r in recs if r["op"] == "takeover"]
        assert takeovers and takeovers[0]["host"] == "standby"
        done_shards = [r["shard"] for r in recs if r["op"] == "done"]
        assert len(done_shards) == len(set(done_shards)) == len(truth)
        run = next(iter(scheduler.replay_journal(
            recs, lease_s=1.5).state_fingerprint()["runs"].values()))
        assert not run["pending"] and not run["leases"]
        assert len(run["done"]) == len(truth)


# -- write leases -------------------------------------------------------------

_WRITE_LEASE_VICTIM = r"""
import os, sys
sys.path.insert(0, {repo!r})
from disq_tpu_torch import DisqOptions, ReadsStorage, StageManifestWriteOption
from disq_tpu_torch.fsw.faultfs import FaultInjectingFileSystemWrapper, FaultSpec
from disq_tpu_torch.fsw.filesystem import (PosixFileSystemWrapper,
                                           register_filesystem)

# the 4th write call hangs: a couple of leased parts land (in the
# manifest and at the coordinator), then the writer holds live write
# leases until it is killed
register_filesystem("fault", FaultInjectingFileSystemWrapper(
    PosixFileSystemWrapper(),
    [FaultSpec(kind="stall", op="write", stall_s=300.0, call_index=3,
               times=1)]))
ds = ReadsStorage.make_default(device="cpu").split_size({split}).read(
    {path!r})
st = (ReadsStorage.make_default(device="cpu").num_shards(6)
      .options(DisqOptions(retry_backoff_s=0.0)).writer_workers(2))
st.write(ds, "fault://" + {out!r}, StageManifestWriteOption({mpath!r}))
os._exit(3)  # not reached: the wedge outlives the kill
"""


class TestWriteLeasing:
    @pytest.fixture
    def fault_fs(self, clean):
        from disq_tpu_torch.fsw.faultfs import FaultInjectingFileSystemWrapper
        from disq_tpu_torch.fsw.filesystem import (
            PosixFileSystemWrapper,
            register_filesystem,
        )

        yield register_filesystem
        register_filesystem("fault", FaultInjectingFileSystemWrapper(
            PosixFileSystemWrapper(), []))

    def test_write_lease_sigkill_staged_parts_survive(self, tmp_path,
                                                      fault_fs):
        """A writer holding write leases is killed: its staged parts
        survive in the manifest, the coordinator requeues only the
        unfinished shards, and the resumed writer stages exactly those,
        bytes equal to a fault-free write."""
        from disq_tpu_torch.fsw.faultfs import FaultInjectingFileSystemWrapper
        from disq_tpu_torch.fsw.filesystem import PosixFileSystemWrapper
        from disq_tpu_torch.runtime.manifest import StageManifest

        split = 4096
        raw = _fixture(tmp_path, n=1500, seed=3)
        out = str(tmp_path / "leased.bam")
        mpath = str(tmp_path / "leased.manifest")
        addr = scheduler.serve_coordinator(lease_s=0.9)
        victim = subprocess.Popen(
            [sys.executable, "-c", _WRITE_LEASE_VICTIM.format(
                repo=REPO, split=split, path=raw, out=out, mpath=mpath)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            env=_env(SCHED=addr, SCHED_HOST="victim", SCHED_LEASE_N=2,
                     SCHED_STEAL=0))

        wkey = scheduler.run_key_for("fault://" + out, 6, direction="write")

        def booked():
            run = scheduler.active_coordinator().stats()["runs"].get(wkey)
            return run if run and len(run["done"]) >= 2 else None

        try:
            _wait_for(booked, "the victim's first lease batch done", victim)
        finally:
            victim.kill()
            victim.wait(timeout=SUBPROCESS_S)
        pre_done = set(StageManifest(mpath).completed_shards("bam.parts"))
        # the run leased in the write direction, and every shard the
        # coordinator holds done has its record in the manifest (flushed
        # before the batch's done calls); the manifest may hold one more,
        # a part of the batch in flight that landed before the kill
        run = scheduler.active_coordinator().stats()["runs"][wkey]
        assert run["dir"] == "write"
        assert len(run["done"]) >= 2
        assert {int(s) for s in run["done"]} <= pre_done

        writes = []

        class Counting(PosixFileSystemWrapper):
            def write_all(self, p, data):
                writes.append(p)
                super().write_all(p, data)

        fault_fs("fault", FaultInjectingFileSystemWrapper(Counting(), []))
        ds = _port().split_size(split).read(raw)
        st = (_port().num_shards(6)
              .scheduler(addr, lease_n=2, lease_s=0.9, steal=False)
              .writer_workers(2))
        st.write(ds, "fault://" + out, P.StageManifestWriteOption(mpath))
        restaged = {int(p.rsplit("part-", 1)[1][:5])
                    for p in writes if "part-" in p}
        assert not (restaged & pre_done), "the resume staged a done shard"
        assert restaged == set(range(6)) - pre_done
        assert not os.path.exists(mpath), "the manifest outlived the commit"
        run = scheduler.active_coordinator().stats()["runs"][wkey]
        assert run["finished"]
        assert {int(s) for s in run["done"]} == set(range(6))
        clean_out = str(tmp_path / "clean.bam")
        _port().num_shards(6).write(ds, clean_out)
        with open(out, "rb") as fa, open(clean_out, "rb") as fb:
            assert fa.read() == fb.read()

    def test_torn_response_body_lands_in_the_failover_ladder(
            self, monkeypatch):
        """A coordinator killed mid-body raises ``IncompleteRead`` (an
        ``HTTPException``, no ``OSError``) from ``resp.read()``: the RPC
        layer turns it into the ``IOError`` failover catches."""
        import http.client

        class TornResp:
            def __enter__(self):
                return self

            def __exit__(self, *a):
                return False

            def read(self):
                raise http.client.IncompleteRead(b"", 67)

        monkeypatch.setattr(scheduler.urllib.request, "urlopen",
                            lambda *a, **k: TornResp())
        monkeypatch.setattr(scheduler, "_RPC_BACKOFF_S", 0.0)
        with pytest.raises(IOError, match="unreachable"):
            SchedulerClient("127.0.0.1:1", "hA")._call_once("lease", {})


# -- scheduled reads and the leased write against disq_tpu --------------------


def test_scheduled_bam_read_equals_reference(tmp_path, clean):
    path = _fixture(tmp_path, n=1200, seed=21)
    want = R.ReadsStorage.make_default().split_size(4096).read(path)
    got = _port().split_size(4096).scheduler("serve", lease_n=3).read(path)
    assert got.count() == want.count()
    g = as_read_batch(got.reads)
    for f in READ_FIELDS + ("bin", "tags", "tag_offsets", "cigar_offsets"):
        a, b = getattr(g, f), getattr(want.reads, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert _counters(got.counters) == _counters(want.counters)
    run = next(iter(scheduler.active_coordinator().stats()["runs"].values()))
    assert run["finished"] and run["locality_misses"] == run["shards"] > 1


def test_scheduled_cram_read_equals_reference(tmp_path, clean):
    bam = _fixture(tmp_path, n=600, seed=23)
    cram = str(tmp_path / "in.cram")
    st = R.ReadsStorage.make_default().num_shards(3)
    st.write(st.read(bam), cram, R.CraiWriteOption.ENABLE)
    want = R.ReadsStorage.make_default().split_size(2000).read(cram)
    got = _port().split_size(2000).scheduler("serve").read(cram)
    assert got.count() == want.count() > 0
    g = as_read_batch(got.reads)
    for f in READ_FIELDS + ("tags", "tag_offsets", "cigar_offsets"):
        np.testing.assert_array_equal(getattr(g, f), getattr(want.reads, f),
                                      err_msg=f)
    assert _counters(got.counters) == _counters(want.counters)
    run = next(iter(scheduler.active_coordinator().stats()["runs"].values()))
    assert run["finished"] and run["shards"] > 1


def test_scheduled_vcf_read_equals_reference(tmp_path, clean):
    from test_torch_vcf import _make_vcf_text, same_dataset

    header, body, _recs = _make_vcf_text(500, seed=4)
    bgz = str(tmp_path / "a.vcf.bgz")
    with open(bgz, "wb") as f:
        f.write(o_bgzf_compress((header + body).encode(), blocksize=777))
    want = R.VariantsStorage.make_default().split_size(3000).read(bgz)
    got = (P.VariantsStorage.make_default(device="cpu").split_size(3000)
           .scheduler("serve").read(bgz))
    same_dataset(got, want)
    run = next(iter(scheduler.active_coordinator().stats()["runs"].values()))
    assert run["finished"] and run["shards"] > 1


def test_leased_write_byte_identical_to_reference(tmp_path, clean):
    path = _fixture(tmp_path, n=1500, seed=25)
    want = str(tmp_path / "ref.bam")
    rst = R.ReadsStorage.make_default().num_shards(8)
    rst.write(rst.read(path), want, R.BaiWriteOption.ENABLE,
              R.SbiWriteOption.ENABLE, sort=True)
    got = str(tmp_path / "port.bam")
    pst = _port().num_shards(8).writer_workers(2).scheduler("serve")
    pst.write(_port().read(path), got, P.BaiWriteOption.ENABLE,
              P.SbiWriteOption.ENABLE,
              P.StageManifestWriteOption(str(tmp_path / "m.json")),
              sort=True)
    for ext in ("", ".bai", ".sbi"):
        with open(got + ext, "rb") as a, open(want + ext, "rb") as b:
            assert a.read() == b.read(), ext
    run = scheduler.active_coordinator().stats()["runs"][
        scheduler.run_key_for(got, 8, direction="write")]
    assert run["finished"] and run["dir"] == "write"
    assert sorted(int(s) for s in run["done"]) == list(range(8))
    # each part registered its byte range: contiguous, in shard order
    ranges = scheduler.active_coordinator().state_fingerprint()["runs"][
        scheduler.run_key_for(got, 8, direction="write")]["ranges"]
    bounds = [ranges[str(k)] for k in range(8)]
    assert bounds[0][0] == 0 and all(
        a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert not os.path.exists(str(tmp_path / "m.json"))
