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


def main() -> int:
    errors = []
    check_breaker_totality(errors)
    check_hedge_accounting(errors)
    check_disabled_path(errors)
    if errors:
        print(f"torch_check_resilience: {len(errors)} problem(s)")
        for e in errors:
            print(f"  - {e}")
        return 1
    print("torch_check_resilience: OK (breaker machine total, hedge books "
          "balanced, disabled path builds nothing)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
