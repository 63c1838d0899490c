"""The port's resilience layer (``disq_tpu_torch/runtime/resilience.py``
and its hooks) against ``disq_tpu``'s, on the CPU.

The cases of ``tests/test_resilience.py`` and
``tests/test_resilience_check.py``, each unit held against the
reference's own class on the same inputs, exactly:

- ``CircuitBreaker``: the same event sequences over the same injected
  clock give the same states, snapshots and refusals;
- ``RetryBudget``: the same spends and refills give the same tokens, and
  a ``ShardRetrier`` drawing from it makes the same calls;
- ``ShardRetrier``: the same seeded jitter, the same stop at a deadline;
- ``HedgeController``: the same thresholds from the same latencies;
- reads: the port's read under the same seeded ``FaultSpec`` schedule as
  the reference's (a stall past the shard deadline, a store whose every
  read fails, a stall with a damaged block header on a hedged split)
  gives the same records, ``ds.counters`` and quarantine manifest, and
  the same error where the reference raises.

Plus the executor's teardown (an abort leaves no fetch or hedge
thread), the read ledger's deadline fingerprint, ``/healthz`` and
``telemetry_report`` surfacing, and ``scripts/torch_check_resilience.py``
in a fresh interpreter (disabled is free).
"""

import json
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import disq_tpu.api as R
from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
from disq_tpu.bgzf.block import parse_block_header
from disq_tpu.fsw import FaultInjectingFileSystemWrapper as RefFaultFS
from disq_tpu.fsw import FaultSpec as RefFaultSpec
from disq_tpu.fsw import PosixFileSystemWrapper as RefPosix
from disq_tpu.fsw import register_filesystem as ref_register
from disq_tpu.runtime import errors as ref_errors
from disq_tpu.runtime import resilience as ref_res
from disq_tpu.runtime.errors import DisqOptions as RefOptions
import disq_tpu_torch as P
from disq_tpu_torch.fsw.faultfs import FaultInjectingFileSystemWrapper, FaultSpec
from disq_tpu_torch.fsw.filesystem import PosixFileSystemWrapper, register_filesystem
from disq_tpu_torch.runtime import errors as port_errors
from disq_tpu_torch.runtime import resilience as port_res
from disq_tpu_torch.runtime.errors import (
    BreakerOpenError,
    DeadlineExceededError,
    DisqOptions,
    ShardRetrier,
    TransientIOError,
    is_transient,
)
from disq_tpu_torch.runtime.resilience import (
    CircuitBreaker,
    HedgeController,
    configure_budget,
    resilience_for_options,
)
from disq_tpu_torch.runtime.tracing import counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKSIZE = 600
SPLIT = 4096
FIELDS = ("refid", "pos", "mapq", "flag", "next_refid", "next_pos", "tlen",
          "names", "cigars", "seqs", "quals", "tags")


@pytest.fixture(scope="module")
def bam_file(tmp_path_factory):
    records = synth_records(500, seed=7, unmapped_tail=6)
    data = make_bam_bytes(DEFAULT_REFS, records, blocksize=BLOCKSIZE)
    path = str(tmp_path_factory.mktemp("resbam") / "in.bam")
    with open(path, "wb") as f:
        f.write(data)
    return path, records, data


@pytest.fixture(scope="module")
def baseline(bam_file):
    path, _, _ = bam_file
    return P.ReadsStorage.make_default(device="cpu").split_size(SPLIT) \
        .read(path)


@pytest.fixture(autouse=True)
def _clean_resilience():
    ref_res.reset_resilience()
    port_res.reset_resilience()
    yield
    ref_res.reset_resilience()
    port_res.reset_resilience()


def _port_fs(specs, seed=0):
    fsw = FaultInjectingFileSystemWrapper(
        PosixFileSystemWrapper(), [FaultSpec(**s) for s in specs], seed=seed)
    register_filesystem("fault", fsw)
    return fsw


def _ref_fs(specs, seed=0):
    fsw = RefFaultFS(RefPosix(), [RefFaultSpec(**s) for s in specs],
                     seed=seed)
    ref_register("fault", fsw)
    return fsw


def _reads_of(batch):
    return batch.to_read_batch() if hasattr(batch, "to_read_batch") \
        else batch


def _assert_same_reads(got, want):
    got, want = _reads_of(got), _reads_of(want)
    assert int(got.count) == int(want.count)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def _counters(ds):
    c = ds.counters
    return {k: getattr(c, k) for k in (
        "records", "blocks", "bytes_compressed", "bytes_uncompressed",
        "skipped_blocks", "quarantined_blocks", "retried_reads")}


def _drain_threads(prefixes, timeout=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        alive = [t.name for t in threading.enumerate()
                 if t.name.startswith(prefixes) and t.is_alive()]
        if not alive:
            return []
        time.sleep(0.02)
    return alive


# -- CircuitBreaker ------------------------------------------------------------


def _breaker_trace(res_mod, err_mod, events, window, cooldown):
    """Drive one breaker through ``events`` on an injected clock: each
    step's state, snapshot and refusal."""
    now = [0.0]
    br = res_mod.CircuitBreaker("k", window=window, cooldown_s=cooldown,
                                clock=lambda: now[0])
    out = []
    for ev, arg in events:
        refused = None
        if ev == "advance":
            now[0] += arg
        elif ev == "success":
            br.record_success()
        elif ev == "failure":
            br.record_failure()
        elif ev == "release":
            br.release_probe()
        else:
            try:
                br.before_call()
            except err_mod.BreakerOpenError as e:
                refused = (round(e.retry_after_s, 9), str(e))
        out.append((ev, br.state, refused, br.snapshot()))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_breaker_transitions_equal_reference(seed):
    rng = np.random.default_rng(seed)
    kinds = ["success", "failure", "failure", "call", "call", "release",
             "advance"]
    events = [(k, float(rng.choice([0.3, 0.7, 1.1, 2.5])))
              for k in rng.choice(kinds, size=200)]
    window, cooldown = int(rng.integers(1, 4)), float(rng.choice([0.5, 1.0]))
    want = _breaker_trace(ref_res, ref_errors, events, window, cooldown)
    got = _breaker_trace(port_res, port_errors, events, window, cooldown)
    assert got == want
    assert {s for _, s, _, _ in got} == {"closed", "open", "half_open"}


def _scenario(res_mod, err_mod, name):
    now = [0.0]

    def make(window, cooldown):
        return res_mod.CircuitBreaker("t", window=window,
                                      cooldown_s=cooldown,
                                      clock=lambda: now[0])

    def call(br):
        try:
            br.before_call()
            return "admitted"
        except err_mod.BreakerOpenError:
            return "refused"

    log = []
    if name == "trips_and_recloses":
        br = make(3, 5.0)
        for _ in range(3):
            br.record_failure()
            log.append(br.state)
        log.append(call(br))
        now[0] += 5.1
        log += [call(br), br.state, call(br)]
        br.record_success()
        log.append(br.state)
    elif name == "failed_probe_reopens":
        br = make(1, 1.0)
        br.record_failure()
        now[0] += 1.5
        log += [call(br), br.state]
        br.record_failure()
        log += [br.state, call(br)]
    elif name == "non_transient_probe_releases":
        br = make(1, 1.0)
        br.record_failure()
        now[0] += 1.5
        r = err_mod.ShardRetrier(max_retries=2, backoff_s=0.0, breaker=br)
        with pytest.raises(FileNotFoundError):
            r.call(lambda: (_ for _ in ()).throw(FileNotFoundError("gone")))
        log.append(br.state)
        r2 = err_mod.ShardRetrier(max_retries=0, backoff_s=0.0, breaker=br)
        log += [r2.call(lambda: "ok"), br.state]
    elif name == "silent_probe_times_out":
        br = make(1, 1.0)
        br.record_failure()
        now[0] += 1.5
        log += [call(br), call(br)]
        now[0] += 1.1
        log.append(call(br))
        br.record_success()
        log.append(br.state)
    elif name == "success_resets_window":
        br = make(3, 1.0)
        for ev in ("f", "f", "s", "f", "f"):
            br.record_failure() if ev == "f" else br.record_success()
            log.append(br.state)
    return log, br.snapshot()


@pytest.mark.parametrize("name,want_log", [
    ("trips_and_recloses", ["closed", "closed", "open", "refused",
                            "admitted", "half_open", "refused", "closed"]),
    ("failed_probe_reopens", ["admitted", "half_open", "open", "refused"]),
    ("non_transient_probe_releases", ["half_open", "ok", "closed"]),
    ("silent_probe_times_out", ["admitted", "refused", "admitted",
                                "closed"]),
    ("success_resets_window", ["closed"] * 5),
])
def test_breaker_scenarios_equal_reference(name, want_log):
    got = _scenario(port_res, port_errors, name)
    assert got == _scenario(ref_res, ref_errors, name)
    assert got[0] == want_log


def test_breaker_refusal_is_not_transient():
    br = CircuitBreaker("t", window=1, cooldown_s=5.0)
    br.record_failure()
    with pytest.raises(BreakerOpenError) as ei:
        br.before_call()
    assert ei.value.retry_after_s > 0
    assert not is_transient(ei.value)
    assert not is_transient(DeadlineExceededError("x"))
    assert not is_transient(port_errors.WatchdogStallError("x"))


# -- RetryBudget ----------------------------------------------------------------


def _budget_trace(res_mod, ops, capacity, refill):
    b = res_mod.RetryBudget(capacity, refill_per_success=refill)
    out = []
    for op in ops:
        out.append(b.try_spend() if op else b.on_success())
        out.append(b.tokens)
    return out, b.snapshot()


@pytest.mark.parametrize("capacity,refill", [(10, 0.5), (3, 5.0), (2, 0.0),
                                             (7, 0.1)])
def test_budget_refills_equal_reference(capacity, refill):
    ops = [bool(x) for x in np.random.default_rng(capacity).integers(
        0, 2, size=120)]
    assert _budget_trace(port_res, ops, capacity, refill) == \
        _budget_trace(ref_res, ops, capacity, refill)


def _dry_bucket(res_mod, err_mod):
    budget = res_mod.configure_budget(2, refill_per_success=0.0)
    sleeps, calls = [], {"n": 0}
    r = err_mod.ShardRetrier(max_retries=10, backoff_s=0.01,
                             sleep=sleeps.append, rng=random.Random(4))

    def fn():
        calls["n"] += 1
        raise err_mod.TransientIOError("flaky")

    with pytest.raises(err_mod.TransientIOError):
        r.call(fn)
    return calls["n"], r.retried, budget.tokens, sleeps


def test_dry_bucket_denies_retries_like_reference():
    got = _dry_bucket(port_res, port_errors)
    assert got == _dry_bucket(ref_res, ref_errors)
    assert got[:3] == (3, 2, 0.0)  # 1 + 2 budgeted retries, not 1 + 10


def test_unconfigured_budget_costs_nothing():
    r = ShardRetrier(max_retries=2, backoff_s=0.0)
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        raise TransientIOError("flaky")

    with pytest.raises(TransientIOError):
        r.call(fn)
    assert calls["n"] == 3
    assert port_res.active_budget() is None


# -- ShardRetrier jitter and deadlines ------------------------------------------


def _sleeps(err_mod, seed, n=4, base=0.05):
    sleeps = []
    r = err_mod.ShardRetrier(max_retries=n, backoff_s=base,
                             sleep=sleeps.append, rng=random.Random(seed))
    with pytest.raises(err_mod.TransientIOError):
        r.call(lambda: (_ for _ in ()).throw(
            err_mod.TransientIOError("flaky")))
    return sleeps


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_jitter_equals_reference_and_is_bounded(seed):
    got = _sleeps(port_errors, seed)
    assert got == _sleeps(ref_errors, seed)
    assert all(0.05 <= s <= 0.05 * 2 ** 4 for s in got)
    assert _sleeps(port_errors, seed) != _sleeps(port_errors, seed + 10)
    assert _sleeps(port_errors, seed, n=3, base=0.0) == [0.0, 0.0, 0.0]


def _deadline_ladder(res_mod, err_mod):
    now = [0.0]
    dl = res_mod.ShardDeadline(10.0, shard_id=4, clock=lambda: now[0])
    dl.arm()
    out = [(dl.should_force_hedge(), dl.exceeded())]
    now[0] = 5.0
    out.append((dl.should_force_hedge(), dl.exceeded()))
    now[0] = 10.0
    with pytest.raises(err_mod.DeadlineExceededError) as ei:
        dl.check()
    out.append((ei.value.shard_id, str(ei.value)))
    r = err_mod.ShardRetrier(max_retries=10, backoff_s=0.0)
    clock = [0.0]
    r.deadline = res_mod.ShardDeadline(5.0, shard_id=1,
                                       clock=lambda: clock[0])
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        clock[0] += 3.0
        raise err_mod.TransientIOError("flaky")

    with pytest.raises(err_mod.DeadlineExceededError):
        r.call(fn)
    out.append(calls["n"])
    return out


def test_deadline_ladder_and_retrier_stop_equal_reference():
    got = _deadline_ladder(port_res, port_errors)
    assert got == _deadline_ladder(ref_res, ref_errors)
    assert got[0] == (False, False) and got[1] == (True, False)
    assert got[3] == 2  # 3 s in budget, 6 s past it: no third attempt


# -- HedgeController ------------------------------------------------------------


@pytest.mark.parametrize("quantile,min_s", [(0.9, 0.01), (0.5, 0.0),
                                            (0.99, 0.2)])
def test_hedge_threshold_equals_reference(quantile, min_s):
    rng = np.random.default_rng(int(quantile * 100))
    lats = rng.exponential(0.05, size=400).tolist()
    got = HedgeController(quantile=quantile, min_s=min_s)
    want = ref_res.HedgeController(quantile=quantile, min_s=min_s)
    assert got.threshold() == want.threshold() == min_s  # cold: the floor
    for v in lats:
        got.record(v)
        want.record(v)
        assert got.threshold() == want.threshold()
    got.close()
    want.close()


def test_hedge_survives_primary_failure():
    h = HedgeController(quantile=0.5, min_s=0.01)
    calls = {"n": 0}
    lock = threading.Lock()

    def fetch():
        with lock:
            calls["n"] += 1
            k = calls["n"]
        if k == 1:
            time.sleep(0.05)
            raise TransientIOError("primary died slowly")
        return b"ok"

    assert h.call(fetch, shard_id=0) == b"ok"
    h.close()


def test_hedge_both_failures_surface_and_book_neither():
    h = HedgeController(quantile=0.5, min_s=0.0)
    neither0 = counter("hedge.won").value(winner="neither")

    def fetch():
        time.sleep(0.01)
        raise TransientIOError("storm")

    with pytest.raises(TransientIOError):
        h.call(fetch, shard_id=0)
    h.close()
    assert counter("hedge.won").value(winner="neither") == neither0 + 1


# -- reads under the same fault schedule -----------------------------------------


def _ref_storage(opts):
    return R.ReadsStorage.make_default().split_size(SPLIT).options(opts)


def _port_storage(opts, split=SPLIT):
    return P.ReadsStorage.make_default(device="cpu").split_size(split) \
        .options(opts)


# one 2 s stall on a split's fetch (call 40 of the fixture's sequential
# read: 38 header and boundary calls, then one range read per split),
# past a 1 s deadline that no other split comes near
_STALL = [dict(kind="stall", path_substr="in.bam", stall_s=2.0,
               call_index=40, times=1)]


@pytest.mark.parametrize("policy", ["skip", "quarantine"])
def test_over_deadline_split_set_aside_like_reference(bam_file, tmp_path,
                                                      policy):
    path, _, _ = bam_file
    qdirs = [str(tmp_path / "rq"), str(tmp_path / "pq")]
    _ref_fs(_STALL)
    ref = _ref_storage(RefOptions(error_policy=policy, max_retries=1,
                                  retry_backoff_s=0.0,
                                  quarantine_dir=qdirs[0])
                       .with_shard_deadline(1.0)).read("fault://" + path)
    skipped0 = counter("errors.skipped_blocks").value(kind="shard deadline")
    fsw = _port_fs(_STALL)
    got = _port_storage(DisqOptions(error_policy=policy, max_retries=1,
                                    retry_backoff_s=0.0,
                                    quarantine_dir=qdirs[1])
                        .with_shard_deadline(1.0)).read("fault://" + path)
    assert [i.kind for i in fsw.injected] == ["stall"]
    _assert_same_reads(got.reads, ref.reads)
    assert _counters(got) == _counters(ref)
    assert 0 < 506 - got.count() < 506
    if policy == "skip":
        assert got.counters.skipped_blocks == 1
        assert counter("errors.skipped_blocks").value(
            kind="shard deadline") == skipped0 + 1
    else:
        lines = [[json.loads(ln) for ln in
                  open(os.path.join(q, "MANIFEST.jsonl")).read()
                  .splitlines()][1:] for q in qdirs]
        for e in lines[0] + lines[1]:
            del e["run_id"]
        assert lines[1] == [dict(e, sidecar=e["sidecar"].replace(
            qdirs[0], qdirs[1])) for e in lines[0]]
        assert lines[1][0]["kind"] == "shard deadline"


def test_strict_deadline_aborts_like_reference(bam_file):
    path, _, _ = bam_file
    _ref_fs(_STALL)
    with pytest.raises(ref_errors.DeadlineExceededError) as ref_e:
        _ref_storage(RefOptions(max_retries=1, retry_backoff_s=0.0)
                     .with_shard_deadline(1.0)).read("fault://" + path)
    _port_fs(_STALL)
    with pytest.raises(DeadlineExceededError) as got_e:
        _port_storage(DisqOptions(max_retries=1, retry_backoff_s=0.0)
                      .with_shard_deadline(1.0)).read("fault://" + path)
    assert got_e.value.shard_id == ref_e.value.shard_id


def test_breaker_storm_fails_fast_and_recloses_like_reference(bam_file,
                                                              baseline):
    path, _, _ = bam_file
    storm = [dict(kind="transient", probability=1.0)]
    opts = dict(max_retries=8, retry_backoff_s=0.0)
    ref_fsw = _ref_fs(storm)
    with pytest.raises(ref_errors.BreakerOpenError) as ref_e:
        _ref_storage(RefOptions(**opts).with_breaker(3, cooldown_s=0.2)) \
            .read("fault://" + path)
    fsw = _port_fs(storm)
    st = _port_storage(DisqOptions(**opts).with_breaker(3, cooldown_s=0.2))
    with pytest.raises(BreakerOpenError) as got_e:
        st.read("fault://" + path)
    assert str(got_e.value).split("[")[0] == str(ref_e.value).split("[")[0]
    assert len(fsw.injected) == len(ref_fsw.injected) == 3
    snap = port_res.breakers_snapshot()["fault"]
    want = ref_res.breakers_snapshot()["fault"]
    assert {k: snap[k] for k in ("state", "window", "cooldown_s")} == \
        {k: want[k] for k in ("state", "window", "cooldown_s")} == \
        {"state": "open", "window": 3, "cooldown_s": 0.2}
    with pytest.raises(BreakerOpenError):
        st.read("fault://" + path)
    assert len(fsw.injected) == 3  # it failed fast: no store call
    fsw.faults.clear()
    time.sleep(0.25)
    ds = st.read("fault://" + path)
    assert port_res.breakers_snapshot()["fault"]["state"] == "closed"
    _assert_same_reads(ds.reads, baseline.reads)


def test_retry_budget_bounds_a_storm_like_reference(bam_file):
    path, _, _ = bam_file
    storm = [dict(kind="transient", probability=1.0)]
    opts = dict(max_retries=8, retry_backoff_s=0.0)
    ref_fsw = _ref_fs(storm)
    with pytest.raises(ref_errors.TransientIOError):
        _ref_storage(RefOptions(**opts).with_retry_budget(5, 0.0)) \
            .read("fault://" + path)
    fsw = _port_fs(storm)
    with pytest.raises(TransientIOError):
        _port_storage(DisqOptions(**opts).with_retry_budget(5, 0.0)) \
            .read("fault://" + path)
    # 1 attempt + 5 budgeted retries, then the bucket is dry
    assert len(fsw.injected) == len(ref_fsw.injected) == 6
    assert port_res.active_budget().tokens == \
        ref_res.active_budget().tokens == 0.0


def _damaged_block(data):
    """A mid-file block, and the bitflip that breaks its header."""
    pos, layout = 0, []
    while pos < len(data):
        total = parse_block_header(data, pos)
        layout.append(pos)
        pos += total
    start = layout[len(layout) // 2]
    return start, dict(kind="bitflip", path_substr="in.bam",
                       offset=start + 1, bit=0)


def test_hedged_split_books_the_winner_once_like_reference(bam_file,
                                                           tmp_path):
    """One split whose fetch stalls (so a duplicate fetch races it) and
    holds a damaged block header (so both attempts salvage-walk and
    quarantine it): records, counters and the quarantine manifest equal
    the reference's, and the port's manifest holds the block once, also
    after the loser has finished."""
    path, _, data = bam_file
    start, flip = _damaged_block(data)
    # a single split: call 0 reads the header, 1 the EOF marker, 2 is the
    # split's fetch
    specs = [flip, dict(kind="stall", path_substr="in.bam", stall_s=3.0,
                        call_index=2, times=1)]
    qdirs = [str(tmp_path / "rq"), str(tmp_path / "pq")]
    launched0 = counter("hedge.launched").total()
    ref_fsw = _ref_fs(specs)
    ref = R.ReadsStorage.make_default().split_size(10**9).options(
        RefOptions(error_policy="quarantine", retry_backoff_s=0.0,
                   quarantine_dir=qdirs[0]).with_hedging(0.5, 0.05)) \
        .read("fault://" + path)
    fsw = _port_fs(specs)
    got = _port_storage(DisqOptions(error_policy="quarantine",
                                    retry_backoff_s=0.0,
                                    quarantine_dir=qdirs[1])
                        .with_hedging(0.5, 0.05), split=10**9) \
        .read("fault://" + path)
    assert counter("hedge.launched").total() - launched0 == 1
    assert "stall" in [i.kind for i in fsw.injected]
    assert [i.kind for i in fsw.injected][:2] == \
        [i.kind for i in ref_fsw.injected][:2]
    _assert_same_reads(got.reads, ref.reads)
    assert _counters(got) == _counters(ref)
    assert got.counters.quarantined_blocks == 1
    assert not _drain_threads(("disq-hedge",))  # both losers finished
    lines = [[json.loads(ln) for ln in
              open(os.path.join(q, "MANIFEST.jsonl")).read().splitlines()
              ][1:] for q in qdirs]
    assert len(lines[1]) == 1  # the winner booked, the loser did not
    last_ref = {(e["path"], e["block_offset"]): e for e in lines[0]}
    [want] = last_ref.values()
    [g] = lines[1]
    assert g["block_offset"] == want["block_offset"] == start
    assert g["kind"] == want["kind"] == "BGZF block header"
    assert open(g["sidecar"], "rb").read() == \
        open(want["sidecar"], "rb").read()


def test_hedged_read_books_every_launch_won(bam_file, baseline):
    path, _, _ = bam_file
    _port_fs([dict(kind="stall", path_substr="in.bam", stall_s=0.3,
                   call_index=40, times=1),
              dict(kind="stall", path_substr="in.bam", stall_s=0.3,
                   call_index=44, times=1)])
    launched0 = counter("hedge.launched").total()
    won0 = counter("hedge.won").total()
    ds = P.ReadsStorage.make_default(device="cpu").split_size(SPLIT) \
        .hedged_fetches(0.5, 0.01).executor_workers(4) \
        .read("fault://" + path)
    _assert_same_reads(ds.reads, baseline.reads)
    launched = counter("hedge.launched").total() - launched0
    assert launched > 0
    assert counter("hedge.won").total() - won0 == launched


def test_decode_affecting_options_reset_ledger(tmp_path):
    from disq_tpu_torch.runtime.executor import read_ledger_for_storage

    class _Storage:
        def __init__(self, opts):
            self._options = opts

    d = str(tmp_path / "lg")
    base = DisqOptions(error_policy="skip").with_read_ledger(d)
    read_ledger_for_storage(_Storage(base), "p", 4, False).record(0, "v")
    assert read_ledger_for_storage(_Storage(base), "p", 4, False).is_done(0)
    assert not read_ledger_for_storage(
        _Storage(DisqOptions().with_read_ledger(d)), "p", 4, False) \
        .is_done(0)
    assert not read_ledger_for_storage(
        _Storage(base.with_shard_deadline(1.0)), "p", 4, False).is_done(0)


# -- teardown ---------------------------------------------------------------------


def test_abort_cancels_inflight_fetches():
    from disq_tpu_torch.runtime.executor import ShardPipelineExecutor, ShardTask

    release = threading.Event()
    started = []

    def make_fetch(i):
        def fetch():
            started.append(i)
            if i == 0:
                raise ValueError("boom")
            assert release.wait(5.0)
            return i
        return fetch

    tasks = [ShardTask(shard_id=i, fetch=make_fetch(i), decode=lambda p: p)
             for i in range(32)]
    ex = ShardPipelineExecutor(workers=4, prefetch_shards=6)
    with pytest.raises(ValueError):
        for _ in ex.map_ordered(tasks):
            pass
    release.set()
    assert len(started) <= 12, started
    assert not _drain_threads(("disq-torch-fetch", "disq-torch-decode"))


def test_abort_cancels_hedge_duplicates():
    from disq_tpu_torch.runtime.executor import ShardPipelineExecutor, ShardTask
    from disq_tpu_torch.runtime.resilience import ResilienceManager

    release = threading.Event()

    def make_fetch(i):
        def fetch():
            if i == 0:
                time.sleep(0.05)
                raise ValueError("boom")
            assert release.wait(5.0)
            return i
        return fetch

    tasks = [ShardTask(shard_id=i, fetch=make_fetch(i), decode=lambda p: p)
             for i in range(8)]
    res = ResilienceManager(hedge=HedgeController(quantile=0.5, min_s=0.01))
    ex = ShardPipelineExecutor(workers=2, prefetch_shards=3, resilience=res)
    with pytest.raises(ValueError):
        for _ in ex.map_ordered(tasks):
            pass
    release.set()
    assert not _drain_threads(("disq-torch-fetch", "disq-torch-decode",
                               "disq-hedge"))


def test_inline_hedge_pool_closes_after_run(bam_file):
    path, _, _ = bam_file
    P.ReadsStorage.make_default(device="cpu").split_size(SPLIT) \
        .hedged_fetches(0.5, 0.0).read(path)
    assert not _drain_threads(("disq-hedge",))


# -- surfacing and options --------------------------------------------------------


def test_healthz_carries_budget_and_breakers():
    from disq_tpu_torch.runtime.introspect import HEALTH
    from disq_tpu_torch.runtime.resilience import breaker_for, configure_breakers

    configure_budget(50)
    configure_breakers(4, 1.0)
    br = breaker_for("http://host/x")
    doc = HEALTH.healthz()
    assert doc["resilience"]["budget"]["capacity"] == 50
    assert doc["resilience"]["breakers"]["http"]["state"] == "closed"
    for _ in range(4):
        br.record_failure()
    doc = HEALTH.healthz()
    assert doc["resilience"]["breakers"]["http"]["state"] == "open"
    assert doc["status"] == "degraded"


def test_telemetry_report_resilience_rollup(bam_file):
    from disq_tpu_torch.runtime.resilience import breaker_for, configure_breakers

    path, _, _ = bam_file
    budget = configure_budget(50)
    configure_breakers(4, 1.0)
    assert budget.try_spend(what="test")
    breaker_for("file:///x")
    counter("hedge.launched").inc()
    report = P.ReadsStorage.make_default(device="cpu").split_size(SPLIT) \
        .read(path).telemetry_report()
    roll = report["resilience"]
    assert {n.split(".", 1)[0] for n in roll} <= {"hedge", "breaker",
                                                 "budget", "deadline"}
    assert "budget.spent" in roll and "hedge.launched" in roll
    for name in roll:
        assert any(name in kind for kind in report["metrics"].values())
    assert report["process_id"] == 0 and report["introspect"] is None


def test_disabled_options_build_no_manager():
    assert resilience_for_options(DisqOptions()) is None
    assert resilience_for_options(None) is None
    m = resilience_for_options(DisqOptions(executor_workers=3)
                               .with_hedging(0.9))
    assert m.hedge._max_workers == 6 and m.deadline_s is None
    m.close()


@pytest.mark.parametrize("call", [
    lambda o: o.with_hedging(1.5), lambda o: o.with_hedging(0.5, -1),
    lambda o: o.with_shard_deadline(0), lambda o: o.with_retry_budget(0),
    lambda o: o.with_breaker(0), lambda o: o.with_breaker(2, 0),
])
def test_option_validation_equals_reference(call):
    with pytest.raises(ValueError) as got:
        call(DisqOptions())
    with pytest.raises(ValueError) as want:
        call(RefOptions())
    assert str(got.value) == str(want.value)


def test_builders_round_trip_like_reference():
    def build(storage):
        return (storage.hedged_fetches(0.9, 0.02).shard_deadline(12.0)
                .retry_budget(100, 0.25).circuit_breaker(5, 2.0)
                .read_ledger("/tmp/lg"))._options

    got = build(P.ReadsStorage.make_default(device="cpu"))
    want = build(R.ReadsStorage.make_default())
    for f in ("hedge_quantile", "hedge_min_s", "shard_deadline_s",
              "retry_budget_tokens", "retry_budget_refill", "breaker_window",
              "breaker_cooldown_s", "read_ledger"):
        assert getattr(got, f) == getattr(want, f), f
    vgot = build(P.VariantsStorage.make_default(device="cpu"))
    assert vgot == got


def test_port_resilience_guard_passes():
    """``scripts/torch_check_resilience.py`` in a fresh interpreter: the
    breaker machine is total, hedge books balance, and the disabled path
    builds no plane object and starts no plane thread."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "torch_check_resilience.py")],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK" in proc.stdout
