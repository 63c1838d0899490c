#!/usr/bin/env python
"""Invariants of the port's resilience and observability planes.

The port's counterpart of ``scripts/check_resilience.py`` and of the
disabled-path section of ``scripts/check_overhead.py``, over
``disq_tpu_torch`` alone, on the CPU:

1. **The breaker's state machine is total.** Every ``(state, event)``
   pair lands in a defined state, and only the legal edges are taken
   (closed→open, open→half_open, half_open→closed, half_open→open), each
   of them at least once; driven with an injected clock.
2. **Hedge books balance.** In a sample hedged run every
   ``hedge.launched`` has exactly one ``hedge.won`` booking.
3. **Disabled is free.** Default ``DisqOptions`` build no resilience
   manager, no retry budget, no breaker, no health-board run, no flight
   recorder, no profiler and no SLO evaluator; a default read and write
   start no ``disq-hedge``, ``disq-watchdog``, ``disq-introspect``,
   ``disq-profiler`` or ``disq-slo`` thread; and a read with every fetch
   hedged decodes, and writes back, the same bytes as the default read.
4. **The scheduler off is free.** With no scheduler knob
   ``client_for_storage`` returns None, ``scheduled_map_ordered`` returns
   the very iterator ``map_ordered_resumable`` returns, write leasing is
   not armed, and no coordinator, journal or ``disq-introspect`` thread
   exists; a scheduled read with failover off writes no journal.
5. **The serving plane and the fleet off are free.** After a default
   read and write neither ``runtime/serve.py`` nor ``runtime/fleet.py``
   is imported; imported, ``serve_if_running()`` and ``fleet_if_running()``
   return None, ``handle_http`` answers 503 and leaves them None, no
   trace id is minted, no plane thread runs, and importing the fleet
   leaves the serving plane's answers as they were.
6. **Journal replay is exact and pure.** A journaled ``ShardCoordinator``
   driven through joins, leases, completions, expiry, a steal, a lost
   race, a second run and a restarted pass replays (``replay_journal``)
   to its live ``state_fingerprint()``, with a torn tail line too; the
   replay reads no clock, leaves its records as they were and gives the
   same state twice.

Run it in a fresh interpreter (the planes are process-global):
``python scripts/torch_check_resilience.py`` prints ``OK`` and exits 0.
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

LEGAL_EDGES = {
    ("closed", "open"),
    ("open", "half_open"),
    ("half_open", "closed"),
    ("half_open", "open"),
}
PLANE_THREADS = ("disq-hedge", "disq-watchdog", "disq-introspect",
                 "disq-profiler", "disq-slo")


def check_breaker_totality(errors):
    from disq_tpu_torch.runtime.errors import BreakerOpenError
    from disq_tpu_torch.runtime.resilience import CircuitBreaker

    now = [0.0]
    taken = set()

    def drive(br, event):
        before = br.state
        if event == "success":
            br.record_success()
        elif event == "failure":
            br.record_failure()
        else:
            if event == "call_after_cooldown":
                now[0] += br.cooldown_s + 1.0
            try:
                br.before_call()
            except BreakerOpenError:
                pass
        after = br.state
        if before != after:
            taken.add((before, after))
        if after not in ("closed", "open", "half_open"):
            errors.append(f"breaker reached {after!r} from {before!r} "
                          f"on {event}")

    def fresh(state):
        # window 1: one driven failure takes closed -> open inside drive
        br = CircuitBreaker("probe", window=1, cooldown_s=10.0,
                            clock=lambda: now[0])
        if state in ("open", "half_open"):
            br.record_failure()
        if state == "half_open":
            now[0] += br.cooldown_s + 1.0
            br.before_call()
        if br.state != state:
            errors.append(f"could not build a breaker in state {state!r}")
        return br

    for state in ("closed", "open", "half_open"):
        for event in ("success", "failure", "call", "call_after_cooldown"):
            drive(fresh(state), event)
    if taken - LEGAL_EDGES:
        errors.append(f"illegal breaker transitions: "
                      f"{sorted(taken - LEGAL_EDGES)}")
    if LEGAL_EDGES - taken:
        errors.append(f"breaker never took: {sorted(LEGAL_EDGES - taken)}")


def check_hedge_accounting(errors):
    from disq_tpu_torch.runtime.resilience import HedgeController
    from disq_tpu_torch.runtime.tracing import counter

    launched0 = counter("hedge.launched").total()
    won0 = counter("hedge.won").total()
    hedge = HedgeController(quantile=0.9, min_s=0.01)
    calls = {"n": 0}
    lock = threading.Lock()

    def fetch():
        with lock:
            calls["n"] += 1
            k = calls["n"]
        # odd calls are the slow tail, so primaries hedge
        time.sleep(0.05 if k % 2 else 0.001)
        return b"x" * 64

    for shard in range(4):
        if hedge.call(fetch, shard_id=shard) != b"x" * 64:
            errors.append("a hedged call returned a wrong payload")
    hedge.close()
    time.sleep(0.1)  # the losers' done-callbacks land
    launched = counter("hedge.launched").total() - launched0
    won = counter("hedge.won").total() - won0
    if launched == 0:
        errors.append("the sample run launched no hedge")
    if launched != won:
        errors.append(f"hedge books out of balance: {launched} launched, "
                      f"{won} won")


def _plane_threads():
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith(PLANE_THREADS))


def check_disabled_path(errors):
    import numpy as np

    from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records

    from disq_tpu_torch import DisqOptions, ReadsStorage
    from disq_tpu_torch.runtime import flightrec, introspect, profiler, slo
    from disq_tpu_torch.runtime.resilience import (
        active_budget,
        breaker_for,
        breakers_snapshot,
        reset_resilience,
        resilience_for_options,
    )

    reset_resilience()
    if resilience_for_options(DisqOptions()) is not None:
        errors.append("default options built a resilience manager")
    if introspect.configure_from_options(DisqOptions()) is not None:
        errors.append("default options returned a health board")
    with tempfile.TemporaryDirectory(prefix="torch-resilience-") as tmp:
        path = os.path.join(tmp, "t.bam")
        with open(path, "wb") as f:
            f.write(make_bam_bytes(DEFAULT_REFS,
                                   synth_records(300, seed=11),
                                   blocksize=600))
        runs0 = introspect.HEALTH._next_token
        storage = ReadsStorage.make_default(device="cpu").split_size(4096)
        plain = storage.executor_workers(2).writer_workers(2).read(path)
        out_a = os.path.join(tmp, "a.bam")
        storage.num_shards(4).write(plain, out_a)
        if introspect.HEALTH._next_token != runs0:
            errors.append("a default read or write registered a health "
                          "board run")
        if active_budget() is not None or breaker_for(path) is not None \
                or breakers_snapshot():
            errors.append("a default read installed a budget or breaker")
        if flightrec.recorder() is not None:
            errors.append("a default read built a flight recorder")
        if profiler.active_profiler() is not None:
            errors.append("a default read started the profiler")
        if slo.evaluator_if_running() is not None:
            errors.append("a default read started an SLO evaluator")
        if introspect.introspect_address() is not None:
            errors.append("a default read started the endpoint")
        if _plane_threads():
            errors.append(f"a default read and write started plane "
                          f"threads: {_plane_threads()}")

        hedged = (ReadsStorage.make_default(device="cpu").split_size(4096)
                  .hedged_fetches(0.5, 0.0)  # every fetch hedges
                  .executor_workers(2).read(path))
        if plain.count() != hedged.count() or not (
                np.array_equal(plain.reads.pos, hedged.reads.pos)
                and np.array_equal(plain.reads.names, hedged.reads.names)):
            errors.append("a hedged read differs from the default read")
        out_b = os.path.join(tmp, "b.bam")
        ReadsStorage.make_default(device="cpu").num_shards(4).write(
            hedged, out_b)
        with open(out_a, "rb") as fa, open(out_b, "rb") as fb:
            if fa.read() != fb.read():
                errors.append("the write-back of a hedged read differs "
                              "from the default read's")
    reset_resilience()


def check_scheduler_off(errors):
    from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records

    from disq_tpu_torch import ReadsStorage
    from disq_tpu_torch.runtime import introspect, scheduler
    from disq_tpu_torch.runtime.executor import (
        ShardPipelineExecutor,
        ShardTask,
    )

    storage = ReadsStorage.make_default(device="cpu")
    if scheduler.client_for_storage(storage) is not None:
        errors.append("client_for_storage built a client with no knob set")
    if scheduler.write_leasing_armed(storage):
        errors.append("write leasing armed with no knob set")
    gen = scheduler.scheduled_map_ordered(
        storage, None, "x", ShardPipelineExecutor(workers=1),
        [ShardTask(shard_id=0, fetch=lambda: 1, decode=lambda p: p)])
    if getattr(gen, "gi_code", None) is not \
            ShardPipelineExecutor._run_sequential.__code__:
        errors.append("scheduled_map_ordered (scheduler off) did not "
                      "return map_ordered_resumable's iterator")
    list(gen)
    if scheduler.active_coordinator() is not None \
            or scheduler.active_journal() is not None:
        errors.append("a coordinator or journal exists with no knob set")
    if _plane_threads():
        errors.append(f"plane threads with the scheduler off: "
                      f"{_plane_threads()}")
    with tempfile.TemporaryDirectory(prefix="torch-sched-") as tmp:
        path = os.path.join(tmp, "t.bam")
        with open(path, "wb") as f:
            f.write(make_bam_bytes(DEFAULT_REFS, synth_records(200, seed=3),
                                   blocksize=600))
        ds = storage.split_size(4096).scheduler("serve").read(path)
        if ds.count() != 200:
            errors.append(f"a scheduled read gave {ds.count()} records")
        if scheduler.active_journal() is not None or any(
                "journal" in name for _d, _s, names in os.walk(tmp)
                for name in names):
            errors.append("a scheduled read with failover off journaled")
    scheduler.stop_coordinator()
    introspect.reset_introspection()


def check_serve_fleet_off(errors):
    import json

    from disq_tpu_torch.runtime import tracing

    for name in ("serve", "fleet"):
        if f"disq_tpu_torch.runtime.{name}" in sys.modules:
            errors.append(f"runtime.{name} was imported with no serve() or "
                          "serve_fleet() call")
    from disq_tpu_torch.runtime import serve

    if serve.serve_if_running() is not None:
        errors.append("a serve daemon exists with no serve() call")
    off = [serve.handle_http("POST", "/query/reads", {}),
           serve.handle_http("GET", "/serve/stats", {}),
           serve.handle_http("GET", "/serve/cachemap", {})]
    if any(code != 503 for code, _ in off):
        errors.append(f"serve.handle_http answered {[c for c, _ in off]} "
                      "with no daemon running")
    if serve.serve_if_running() is not None:
        errors.append("serve.handle_http with no daemon built one")
    if "disq_tpu_torch.runtime.fleet" in sys.modules:
        errors.append("the serve-off path imported runtime.fleet")
    from disq_tpu_torch.runtime import fleet

    if fleet.fleet_if_running() is not None:
        errors.append("a fleet router exists with no serve_fleet() call")
    code, _ = fleet.handle_http("POST", "/fleet/query/reads", {})
    if code != 503:
        errors.append(f"fleet.handle_http answered {code} with no router")
    if fleet.fleet_if_running() is not None:
        errors.append("fleet.handle_http with no router built one")
    after = [serve.handle_http("POST", "/query/reads", {}),
             serve.handle_http("GET", "/serve/stats", {}),
             serve.handle_http("GET", "/serve/cachemap", {})]
    if json.dumps(off) != json.dumps(after):
        errors.append("the serve-off answers changed once the fleet module "
                      "was imported")
    if tracing.trace_ids_minted():
        errors.append(f"{tracing.trace_ids_minted()} trace ids minted with "
                      "request tracing off")
    if _plane_threads():
        errors.append(f"plane threads with serve and fleet off: "
                      f"{_plane_threads()}")


def _sched_schedule(coord, now):
    table = {str(i): ([i * 100, i * 100 + 100] if i % 2 else None)
             for i in range(8)}
    coord.join("A", {"key": "r1", "path": "p1", "shards": table})
    coord.join("B", {"key": "r1", "path": "p1", "shards": table})
    coord.join("B", {"key": "r2", "path": "p2", "weight": 3.0,
                     "shards": {str(i): None for i in range(4)}})
    coord.lease("A", "r1", want=3)
    now[0] = 1.0
    coord.lease("B", "r1", want=2)
    coord.lease("B", "r2", want=2)
    coord.done("A", "r1", 0)
    coord.done("B", "r1", 0)  # a lost race: no record
    now[0] = 12.0
    coord.lease("B", "r1", want=1)  # the sweep requeues expired leases
    coord.steal("A", "r1")
    for s in range(4):
        coord.done("B", "r2", s, epoch=1)
    coord.join("B", {"key": "r2", "path": "p2", "weight": 3.0,
                     "shards": {str(i): None for i in range(4)}})


def check_journal_replay(errors):
    import copy
    import json

    from disq_tpu_torch.runtime.manifest import SchedJournal
    from disq_tpu_torch.runtime.scheduler import (
        ShardCoordinator,
        replay_journal,
    )

    with tempfile.TemporaryDirectory(prefix="torch-journal-") as tmp:
        jpath = os.path.join(tmp, "journal.jsonl")
        journal = SchedJournal(jpath)
        now = [0.0]
        coord = ShardCoordinator(lease_s=10.0, clock=lambda: now[0],
                                 journal=journal)
        _sched_schedule(coord, now)
        journal.close()
        records = SchedJournal.load(jpath)
        if not records:
            errors.append("the journaled coordinator wrote no records")
            return
        live = coord.state_fingerprint()
        before = copy.deepcopy(records)
        clocks = (time.monotonic, time.time, time.perf_counter)

        def no_clock():
            raise AssertionError("replay_journal read a clock")

        time.monotonic = time.time = time.perf_counter = no_clock
        try:
            first = replay_journal(records, lease_s=10.0).state_fingerprint()
            second = replay_journal(records, lease_s=10.0).state_fingerprint()
        except AssertionError as e:
            errors.append(str(e))
            return
        finally:
            time.monotonic, time.time, time.perf_counter = clocks
        if first != live:
            errors.append(
                "journal replay diverged from the live coordinator:\n"
                f"    live:     {json.dumps(live, sort_keys=True)}\n"
                f"    replayed: {json.dumps(first, sort_keys=True)}")
        if second != first or records != before:
            errors.append("replay_journal is not pure: a second replay "
                          "differs or the records changed")
        with open(jpath, "a") as f:  # a crash tears the last line
            f.write('{"op": "done", "key": "r1", "hos')
        torn = SchedJournal.load(jpath)
        if len(torn) != len(records) or \
                replay_journal(torn, lease_s=10.0).state_fingerprint() != live:
            errors.append("a torn journal tail did not replay the "
                          "surviving prefix")


def main() -> int:
    errors = []
    check_breaker_totality(errors)
    check_hedge_accounting(errors)
    check_disabled_path(errors)
    check_scheduler_off(errors)
    check_serve_fleet_off(errors)
    check_journal_replay(errors)
    if errors:
        print(f"torch_check_resilience: {len(errors)} problem(s)")
        for e in errors:
            print(f"  - {e}")
        return 1
    print("torch_check_resilience: OK (breaker machine total, hedge books "
          "balanced, disabled path builds nothing, scheduler off builds "
          "nothing, serve and fleet off build nothing, journal replay "
          "exact and pure)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
