"""The shard scheduler: leased splits across processes.

Counterpart of ``disq_tpu/runtime/scheduler.py``. Without it a job of N
processes is N static partitions and ends with the slowest. With it one
process (the coordinator) serves a shared queue of a run's shards on its
introspection endpoint (``/sched/*``), and every process, the
coordinator's too, leases shards in small batches:

- **Locality.** A lease request carries the worker's HTTP block-cache
  occupancy (``fsw/http.py``); a shard whose byte range those blocks
  cover goes to that worker first (``sched.locality{result=hit}``),
  the rest in queue order (``miss``).
- **Stealing.** An idle worker takes the oldest lease held past
  ``steal_after_s`` by the most loaded other host (``/sched/steal``).
  The first ``/sched/done`` of a shard wins; the loser's books
  ``sched.dup_done`` and its result is dropped, so each shard is
  emitted by one process.
- **Membership and handoff.** Processes join at any time; a lease not
  done within ``lease_s`` goes back to the queue
  (``sched.lease_expired``), so a killed worker's shards go to the
  survivors. With a shared ``ReadLedger`` every emitted shard is spilled
  before its ``done``, and a successor that leases a spilled shard loads
  it instead of decoding it again.
- **Coordinator failover** (``sched_failover_dir``, off by default). The
  coordinator journals every transition (``manifest.SchedJournal``) and
  advertises its address in ``<dir>/coordinator.addr``; workers register
  in ``<dir>/members/``. A worker whose call fails past its retries reads
  the address again, or, as the lowest live member, takes an ``O_EXCL``
  lock, replays the journal (``replay_journal``, a pure function),
  rebases the lease clocks and serves the run from its own endpoint.
  ``CoordinatorLostError`` is transient: the others wait on
  rediscovery.
- **Write leases.** A write stage with a ``StageManifest`` leases its
  shards through the same coordinator (run key ``...#write``, leases
  ``dir=write``), the manifest the durable side
  (``scheduled_write_stage``).
- **Fairness.** With several runs on one coordinator, a grant is capped
  at the run's weighted max-min share of the leases in flight
  (``sched_run_weight``); every run can hold one lease
  (``sched.quota.granted`` / ``deferred``).

Off (the default) it costs nothing: ``client_for_storage`` returns None,
``scheduled_map_ordered`` returns ``map_ordered_resumable``'s iterator,
and no coordinator, thread, socket or journal exists.

Knobs (``DisqOptions`` fields; the env wins for the tuning knobs, so a
subprocess worker takes its launcher's settings):

- ``scheduler`` / ``DISQ_TPU_TORCH_SCHED``: None (off), ``"serve"`` (host
  the coordinator and work), ``"host:port"`` (join it), ``"auto"``
  (find it through the failover directory);
- ``sched_lease_n`` / ``_SCHED_LEASE_N``: shards per lease (2);
- ``sched_lease_s`` / ``_SCHED_LEASE_S``: lease expiry, the handoff
  latency (10 s);
- ``sched_steal`` / ``_SCHED_STEAL``: stealing (on);
- ``_SCHED_HOST``: the host name (default ``p<process_id()>``);
- ``_SCHED_STATIC=k,N``: lease only shards ``≡ k (mod N)`` and stop when
  they are gone, a static split through the same RPCs;
- ``_SCHED_SALT``: appended to the run key, so repeated reads of one
  input register as distinct runs;
- ``sched_run_weight`` / ``_SCHED_WEIGHT``: the fairness weight (1.0);
- ``sched_failover_dir`` / ``_SCHED_FAILOVER``: arms failover.
"""

from __future__ import annotations

import bisect
import http.client
import json
import math
import os
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from disq_tpu_torch.runtime import flightrec
from disq_tpu_torch.runtime.tracing import (
    REGISTRY,
    counter,
    inject_trace_headers,
    observe_gauge,
    record_span,
    span,
)

DEFAULT_LEASE_N = 2
DEFAULT_LEASE_S = 10.0
_IDLE_SLEEP_MIN_S = 0.02
_IDLE_SLEEP_MAX_S = 0.25
_RPC_RETRIES = 3
_RPC_BACKOFF_S = 0.05
_ENV = "DISQ_TPU_TORCH_SCHED"


# -- the coordinator ----------------------------------------------------------


class _Run:
    """One registered run's queue on the coordinator."""

    def __init__(self, key: str, path: str,
                 ranges: Dict[int, Optional[Tuple[int, int]]],
                 weight: float = 1.0, direction: str = "read") -> None:
        self.key = key
        self.path = path
        self.ranges = ranges
        self.weight = max(1e-9, float(weight))
        self.direction = direction  # "read" or "write"
        self.joined: set = set()    # hosts that joined this pass
        self.epoch = 1              # the pass number of this key
        self.pending: List[int] = sorted(ranges)
        self.leases: Dict[int, Tuple[str, float]] = {}  # shard: (host, since)
        self.done: Dict[int, str] = {}                  # shard: winner
        self.requeued: List[int] = []                   # expired leases
        self.stolen: List[int] = []
        self.locality_hits = 0
        self.locality_misses = 0

    @property
    def finished(self) -> bool:
        return len(self.done) == len(self.ranges)


class ShardCoordinator:
    """The shared queue. Every mutation runs under one lock; expiry is
    swept on each request (no thread of its own). ``clock`` is
    injectable; ``journal`` (a ``SchedJournal``) records each transition
    under the lock, so its order is the mutation order."""

    def __init__(self, lease_s: float = DEFAULT_LEASE_S,
                 steal_after_s: Optional[float] = None,
                 clock=time.monotonic, journal=None) -> None:
        self.lease_s = float(lease_s)
        self.steal_after_s = (float(steal_after_s) if steal_after_s
                              is not None else self.lease_s / 3.0)
        self._clock = clock
        self._lock = threading.Lock()
        self._runs: Dict[str, _Run] = {}
        self._hosts: Dict[str, float] = {}  # host: last seen
        self._epochs: Dict[str, int] = {}   # run key: last pass number
        self._journal = journal

    def attach_journal(self, journal) -> None:
        self._journal = journal

    def _journal_locked(self, op: str, **fields: Any) -> None:
        if self._journal is not None:
            self._journal.append(op, **fields)

    def _sweep_locked(self, now: float) -> None:
        """Requeue expired leases and drop silent members."""
        expired: List[Tuple[str, str, int]] = []
        for run in self._runs.values():
            for shard, (host, since) in list(run.leases.items()):
                if now - since >= self.lease_s:
                    del run.leases[shard]
                    bisect.insort(run.pending, shard)
                    run.requeued.append(shard)
                    expired.append((run.key, host, shard))
                    self._journal_locked("expire", key=run.key,
                                         host=host, shard=shard, t=now)
        for host, seen in list(self._hosts.items()):
            if now - seen < 2.0 * self.lease_s:
                continue
            if any(host == h for run in self._runs.values()
                   for h, _s in run.leases.values()):
                continue
            del self._hosts[host]
            self._journal_locked("member_lost", host=host, t=now)
            flightrec.record_event("sched_member_lost", host=host)
        if expired:
            observe_gauge("sched.members", len(self._hosts))
        for key, host, shard in expired:
            counter("sched.lease_expired").inc()
            flightrec.record_event("sched_lease_expired", host=host,
                                   shard=shard, run=key)

    def join(self, host: str, run: Optional[Dict[str, Any]] = None,
             rejoin: bool = False) -> Dict[str, Any]:
        """Register ``host`` and, with a ``run`` document, the run (the
        first registration wins: every worker computes the same table).
        A host of a finished pass that registers the key again starts a
        new pass; a host that took no part in it gets the finished run;
        a ``rejoin`` (after a failover) never restarts a pass."""
        now = self._clock()
        with self._lock:
            fresh = host not in self._hosts
            self._hosts[host] = now
            registered = False
            key: Optional[str] = None
            epoch: Optional[int] = None
            if run and run.get("key"):
                key = str(run["key"])
                existing = self._runs.get(key)
                if (existing is not None and existing.finished
                        and host in existing.joined and not rejoin):
                    del self._runs[key]
                    existing = None
                if existing is None:
                    ranges = {int(sid): (tuple(rng) if rng else None)
                              for sid, rng in (run.get("shards") or {}).items()}
                    new = _Run(key, str(run.get("path", "")), ranges,
                               weight=float(run.get("weight") or 1.0),
                               direction=str(run.get("dir") or "read"))
                    new.epoch = self._epochs.get(key, 0) + 1
                    self._epochs[key] = new.epoch
                    self._runs[key] = new
                    registered = True
                    self._journal_locked(
                        "run", key=key, path=new.path,
                        shards={str(s): (list(r) if r else None)
                                for s, r in ranges.items()},
                        epoch=new.epoch, weight=new.weight,
                        dir=new.direction, host=host, t=now)
                self._runs[key].joined.add(host)
                epoch = self._runs[key].epoch
            self._journal_locked("join", host=host, key=key, t=now)
            members = len(self._hosts)
        observe_gauge("sched.members", members)
        if fresh:
            flightrec.record_event("sched_join", host=host)
        return {"host": host, "registered": registered, "members": members,
                "epoch": epoch}

    @staticmethod
    def _locality_score(rng: Optional[Tuple[int, int]],
                        blocks: frozenset, block_size: int) -> int:
        """The cached blocks inside ``rng``'s block span."""
        if rng is None or not blocks or block_size <= 0:
            return 0
        lo, hi = rng
        if hi <= lo:
            return 0
        first, last = lo // block_size, (hi - 1) // block_size
        # walk the smaller side: a tiny block size must not make one
        # score a scan of a huge range
        if last - first + 1 > len(blocks):
            return sum(1 for b in blocks if first <= b <= last)
        return sum(1 for b in range(first, last + 1) if b in blocks)

    def _quota_locked(self, run: _Run, want: int) -> Tuple[int, int]:
        """The weighted max-min cap: while another unfinished run has
        pending shards, ``run`` grows its leases in flight only to its
        weighted share of the total, never below one. ``(grant,
        deferred)``; deferred 0 means the cap did not bind."""
        contending = [r for r in self._runs.values()
                      if not r.finished and (r.pending or r.leases)]
        if not any(r is not run and r.pending for r in contending):
            return want, 0
        total_weight = sum(r.weight for r in contending) or run.weight
        in_flight = sum(len(r.leases) for r in contending)
        share = max(1, math.ceil(
            (in_flight + want) * run.weight / total_weight))
        cap = max(0, share - len(run.leases))
        return min(want, cap), max(0, want - cap)

    def lease(self, host: str, key: str, want: int = DEFAULT_LEASE_N,
              block_size: Optional[int] = None,
              blocks: Optional[Sequence[int]] = None,
              static_of: Optional[Tuple[int, int]] = None,
              epoch: Optional[int] = None,
              direction: Optional[str] = None) -> Dict[str, Any]:
        """Up to ``want`` pending shards for ``host``: those its cached
        ``blocks`` score first, then the queue's order. ``static_of=(k,
        N)`` leases only shards ``≡ k (mod N)``; ``direction`` must match
        the run's; an ``epoch`` of an earlier pass gets nothing."""
        now = self._clock()
        want = max(1, int(want))
        cached = frozenset(int(b) for b in blocks) if blocks else frozenset()
        with self._lock:
            self._hosts[host] = now
            self._sweep_locked(now)
            run = self._runs.get(key)
            if run is None:
                return {"error": f"unknown run {key!r}", "shards": []}
            if direction is not None and direction != run.direction:
                return {"error": f"run {key!r} leases dir="
                                 f"{run.direction}, not dir={direction}",
                        "shards": []}
            if epoch is not None and epoch != run.epoch:
                return {"shards": [], "finished": True, "stale": True}
            want, deferred = self._quota_locked(run, want)
            eligible = [s for s in run.pending
                        if static_of is None
                        or s % static_of[1] == static_of[0]] if want else []
            picked: List[int] = []
            hits = 0
            if cached and block_size:
                scored = sorted(
                    ((self._locality_score(run.ranges.get(s), cached,
                                           int(block_size)), s)
                     for s in eligible),
                    key=lambda t: (-t[0], t[1]))
                for score, s in scored:
                    if len(picked) >= want or score <= 0:
                        break
                    picked.append(s)
                    hits += 1
            for s in eligible:
                if len(picked) >= want:
                    break
                if s not in picked:
                    picked.append(s)
            for s in picked:
                run.pending.remove(s)
                run.leases[s] = (host, now)
            if picked:
                self._journal_locked("lease", key=key, host=host,
                                     shards=list(picked), t=now)
            run.locality_hits += hits
            run.locality_misses += len(picked) - hits
            pending_n = len(run.pending)
            outstanding = len(run.leases)
            finished = run.finished
        if picked:
            counter("sched.leases").inc(len(picked), host=host)
            if hits:
                counter("sched.locality").inc(hits, result="hit")
            if len(picked) - hits:
                counter("sched.locality").inc(len(picked) - hits,
                                              result="miss")
        if deferred:
            counter("sched.quota.deferred").inc(deferred)
            if picked:
                counter("sched.quota.granted").inc(len(picked))
        observe_gauge("sched.queue_depth", pending_n)
        return {"shards": sorted(picked), "pending": pending_n,
                "outstanding": outstanding, "finished": finished}

    def done(self, host: str, key: str, shard: int,
             epoch: Optional[int] = None) -> Dict[str, Any]:
        """Mark ``shard`` complete. The first completion wins; it stays
        won for its host (a retried POST), and another host's completion
        gets ``won=False`` and drops its result."""
        now = self._clock()
        shard = int(shard)
        with self._lock:
            self._hosts[host] = now
            run = self._runs.get(key)
            if run is None:
                return {"error": f"unknown run {key!r}", "won": False}
            if epoch is not None and epoch != run.epoch:
                # a straggler of a finished pass
                return {"won": False, "finished": True, "stale": True}
            newly = shard not in run.done
            if newly:
                run.done[shard] = host
                run.leases.pop(shard, None)
                # a late completion of an expired lease wins too
                if shard in run.pending:
                    run.pending.remove(shard)
                self._journal_locked("done", key=key, host=host,
                                     shard=shard, t=now)
            won = run.done[shard] == host
            by_host = sum(1 for h in run.done.values() if h == host)
            finished = run.finished
        if newly:
            REGISTRY.gauge("sched.shards").observe(by_host, host=host)
        elif not won:
            counter("sched.dup_done").inc()
        return {"won": won, "finished": finished}

    def steal(self, host: str, key: str,
              epoch: Optional[int] = None) -> Dict[str, Any]:
        """Give ``host`` the oldest lease held past ``steal_after_s`` by
        the most loaded other host."""
        now = self._clock()
        with self._lock:
            self._hosts[host] = now
            self._sweep_locked(now)
            run = self._runs.get(key)
            if run is None:
                return {"error": f"unknown run {key!r}", "shards": []}
            if epoch is not None and epoch != run.epoch:
                return {"shards": [], "finished": True, "stale": True}
            stale: Dict[str, List[Tuple[float, int]]] = {}
            for shard, (holder, since) in run.leases.items():
                if holder != host and now - since >= self.steal_after_s:
                    stale.setdefault(holder, []).append((since, shard))
            if not stale:
                return {"shards": [], "pending": len(run.pending),
                        "outstanding": len(run.leases),
                        "finished": run.finished}
            victim = max(stale, key=lambda h: len(stale[h]))
            _since, shard = min(stale[victim])
            run.leases[shard] = (host, now)
            run.stolen.append(shard)
            self._journal_locked("steal", key=key, host=host,
                                 victim=victim, shard=shard, t=now)
            finished = run.finished
        counter("sched.steals").inc(victim=victim)
        flightrec.record_event("sched_steal", thief=host, victim=victim,
                               shard=shard, run=key)
        return {"shards": [shard], "victim": victim, "finished": finished}

    def stats(self, key: Optional[str] = None) -> Dict[str, Any]:
        """The queue's snapshot (``GET /sched/stats``)."""
        with self._lock:
            now = self._clock()
            self._sweep_locked(now)
            runs = {}
            for k, run in self._runs.items():
                if key is not None and k != key:
                    continue
                total = run.locality_hits + run.locality_misses
                runs[k] = {
                    "path": run.path,
                    "epoch": run.epoch,
                    "dir": run.direction,
                    "weight": run.weight,
                    "shards": len(run.ranges),
                    "pending": list(run.pending),
                    "leases": {str(s): {"host": h,
                                        "age_s": round(now - since, 3)}
                               for s, (h, since) in run.leases.items()},
                    "done": {str(s): h for s, h in run.done.items()},
                    "requeued": list(run.requeued),
                    "stolen": list(run.stolen),
                    "locality_hits": run.locality_hits,
                    "locality_misses": run.locality_misses,
                    "locality_hit_rate": round(run.locality_hits / total, 3)
                    if total else 0.0,
                    "finished": run.finished,
                }
            return {"members": sorted(self._hosts), "runs": runs}

    def state_fingerprint(self) -> Dict[str, Any]:
        """The queue's canonical state: the epochs and every run's lease
        table, timestamps included. ``replay_journal`` of this
        coordinator's journal reproduces it exactly; telemetry (locality
        counts, heartbeats) is left out."""
        with self._lock:
            runs: Dict[str, Any] = {}
            for k, run in self._runs.items():
                runs[k] = {
                    "path": run.path,
                    "dir": run.direction,
                    "weight": run.weight,
                    "epoch": run.epoch,
                    "joined": sorted(run.joined),
                    "ranges": {str(s): (list(r) if r else None)
                               for s, r in sorted(run.ranges.items())},
                    "pending": list(run.pending),
                    "leases": {str(s): [h, t] for s, (h, t)
                               in sorted(run.leases.items())},
                    "done": {str(s): h for s, h in sorted(run.done.items())},
                    "requeued": list(run.requeued),
                    "stolen": list(run.stolen),
                }
            return {"epochs": dict(self._epochs), "runs": runs}

    def rebase_clock(self, clock=time.monotonic) -> None:
        """Move replayed timestamps (the dead coordinator's clock) onto
        ``clock``: the newest becomes now, so relative lease ages hold
        and a lease the dead coordinator thought fresh gets its whole
        ``lease_s`` again."""
        with self._lock:
            last = 0.0
            for run in self._runs.values():
                for _h, since in run.leases.values():
                    last = max(last, since)
            for seen in self._hosts.values():
                last = max(last, seen)
            delta = clock() - last
            for run in self._runs.values():
                run.leases = {s: (h, since + delta)
                              for s, (h, since) in run.leases.items()}
            self._hosts = {h: seen + delta for h, seen in self._hosts.items()}
            self._clock = clock


def replay_journal(records: Sequence[Dict[str, Any]],
                   lease_s: float = DEFAULT_LEASE_S,
                   steal_after_s: Optional[float] = None
                   ) -> ShardCoordinator:
    """A coordinator rebuilt from its ``SchedJournal`` records: a pure
    function of the list (no clock read, no I/O, no journaling), applied
    in the order the dead coordinator's mutations ran, so its
    ``state_fingerprint()`` equals the dead one's. The caller rebases the
    clock before serving."""
    last_t = 0.0
    coord = ShardCoordinator(lease_s, steal_after_s, clock=lambda: last_t)
    runs = coord._runs
    for rec in records:
        op = rec.get("op")
        t = float(rec.get("t") or 0.0)
        last_t = max(last_t, t)
        key = rec.get("key")
        run = runs.get(key) if key is not None else None
        host = str(rec.get("host", ""))
        if op == "run":
            ranges = {int(s): (tuple(r) if r else None)
                      for s, r in (rec.get("shards") or {}).items()}
            new = _Run(str(key), str(rec.get("path", "")), ranges,
                       weight=float(rec.get("weight") or 1.0),
                       direction=str(rec.get("dir") or "read"))
            new.epoch = int(rec.get("epoch") or 1)
            coord._epochs[str(key)] = new.epoch
            runs[str(key)] = new
            new.joined.add(host)
        elif op == "join":
            coord._hosts[host] = t
            if run is not None:
                run.joined.add(host)
        elif op == "lease" and run is not None:
            coord._hosts[host] = t
            for s in rec.get("shards") or []:
                s = int(s)
                if s in run.pending:
                    run.pending.remove(s)
                run.leases[s] = (host, t)
        elif op == "done" and run is not None:
            coord._hosts[host] = t
            shard = int(rec["shard"])
            if shard not in run.done:
                run.done[shard] = host
                run.leases.pop(shard, None)
                if shard in run.pending:
                    run.pending.remove(shard)
        elif op == "steal" and run is not None:
            coord._hosts[host] = t
            shard = int(rec["shard"])
            run.leases[shard] = (host, t)
            run.stolen.append(shard)
        elif op == "expire" and run is not None:
            shard = int(rec["shard"])
            if run.leases.pop(shard, None) is not None:
                bisect.insort(run.pending, shard)
            run.requeued.append(shard)
        elif op == "member_lost":
            coord._hosts.pop(host, None)
        # "takeover" and unknown ops mark provenance: no queue effect
    return coord


# -- the process's coordinator and its HTTP plane ----------------------------

_COORD_LOCK = threading.Lock()
_COORDINATOR: Optional[ShardCoordinator] = None
_JOURNAL = None  # a manifest.SchedJournal when failover is armed


def active_coordinator() -> Optional[ShardCoordinator]:
    return _COORDINATOR


def active_journal():
    """The coordinator's failover journal, or None (failover off)."""
    return _JOURNAL


# The failover directory:
#   journal.jsonl         the coordinator's SchedJournal
#   coordinator.addr      {address, pid, process_id}, replaced atomically
#   members/<host>.json   one per worker: {host, process_id, pid, endpoint}
#   takeover.lock         the O_EXCL election guard (its owner's pid)


def _failover_paths(failover_dir: str) -> Dict[str, str]:
    return {
        "journal": os.path.join(failover_dir, "journal.jsonl"),
        "addr": os.path.join(failover_dir, "coordinator.addr"),
        "members": os.path.join(failover_dir, "members"),
        "lock": os.path.join(failover_dir, "takeover.lock"),
    }


def _atomic_write_json(path: str, doc: Dict[str, Any]) -> None:
    from disq_tpu_torch.runtime.manifest import _atomic_write

    _atomic_write(path, lambda f: json.dump(doc, f), prefix=".addr-")


def _read_json(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path, "r") as f:
            doc = json.load(f)
    except (OSError, ValueError, UnicodeDecodeError):
        return None
    return doc if isinstance(doc, dict) else None


def advertise_coordinator(failover_dir: str, address: str) -> None:
    """Publish the live coordinator's address (a reader sees the old or
    the new document, never a torn one)."""
    from disq_tpu_torch.runtime.multihost import process_id

    _atomic_write_json(_failover_paths(failover_dir)["addr"], {
        "address": address, "pid": os.getpid(), "process_id": process_id()})


def discover_coordinator(failover_dir: str, wait_s: float = 10.0) -> str:
    """The advertised coordinator address (``scheduler="auto"``),
    waiting up to ``wait_s`` for a coordinator that is starting."""
    addr_path = _failover_paths(failover_dir)["addr"]
    deadline = time.monotonic() + wait_s
    while True:
        doc = _read_json(addr_path)
        if doc and doc.get("address"):
            return str(doc["address"])
        if time.monotonic() >= deadline:
            raise IOError(f"no scheduler coordinator advertised in "
                          f"{failover_dir!r} after {wait_s:.1f}s")
        time.sleep(0.05)


def register_member(failover_dir: str, host: str, endpoint: str) -> None:
    """Enter this process in the standby election: its liveness endpoint
    and its election key ``(process_id, pid)``."""
    from disq_tpu_torch.runtime.multihost import process_id

    members = _failover_paths(failover_dir)["members"]
    _atomic_write_json(os.path.join(members, f"{host}.json"), {
        "host": host, "process_id": process_id(), "pid": os.getpid(),
        "endpoint": endpoint})


def _list_members(failover_dir: str) -> List[Dict[str, Any]]:
    members_dir = _failover_paths(failover_dir)["members"]
    try:
        names = sorted(os.listdir(members_dir))
    except OSError:
        return []
    out = []
    for name in names:
        if name.endswith(".json"):
            doc = _read_json(os.path.join(members_dir, name))
            if doc and doc.get("endpoint"):
                out.append(doc)
    return out


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(int(pid), 0)
    except (OSError, ValueError):
        return False
    return True


def _acquire_takeover_lock(failover_dir: str, host: str) -> bool:
    """One standby wins the replay: ``O_EXCL`` create; a lock whose
    owner is dead (it crashed mid-takeover) is reclaimed."""
    lock_path = _failover_paths(failover_dir)["lock"]
    payload = json.dumps({"host": host, "pid": os.getpid()})
    for _attempt in (0, 1):
        try:
            fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            return True
        except FileExistsError:
            owner = _read_json(lock_path)
            if owner is not None and _pid_alive(owner.get("pid", -1)):
                return False
            try:
                os.unlink(lock_path)
            except OSError:
                return False
    return False


def _release_takeover_lock(failover_dir: str) -> None:
    try:
        os.unlink(_failover_paths(failover_dir)["lock"])
    except OSError:
        pass


def serve_coordinator(lease_s: float = DEFAULT_LEASE_S,
                      steal_after_s: Optional[float] = None,
                      port: int = 0,
                      failover_dir: Optional[str] = None) -> str:
    """Host the coordinator on this process's introspection endpoint
    (started if needed); idempotent. Returns ``host:port``. With
    ``failover_dir`` it journals there and advertises its address."""
    global _COORDINATOR, _JOURNAL
    from disq_tpu_torch.runtime.introspect import start_introspect_server

    with _COORD_LOCK:
        if _COORDINATOR is None:
            journal = None
            if failover_dir:
                from disq_tpu_torch.runtime.manifest import SchedJournal

                journal = SchedJournal(
                    _failover_paths(failover_dir)["journal"])
            _COORDINATOR = ShardCoordinator(lease_s, steal_after_s,
                                            journal=journal)
            _JOURNAL = journal
    address = start_introspect_server(port)
    if failover_dir and _JOURNAL is not None:
        advertise_coordinator(failover_dir, address)
    return address


def adopt_coordinator(coord: ShardCoordinator, journal=None,
                      port: int = 0) -> str:
    """Install a replayed coordinator (the standby's takeover) and serve
    it on this process's endpoint; returns the address."""
    global _COORDINATOR, _JOURNAL
    from disq_tpu_torch.runtime.introspect import start_introspect_server

    with _COORD_LOCK:
        if journal is not None:
            coord.attach_journal(journal)
        _COORDINATOR = coord
        _JOURNAL = journal
    return start_introspect_server(port)


def stop_coordinator() -> None:
    """Forget the coordinator and close its journal (the endpoint, if
    any, keeps running: ``introspect.reset_introspection`` stops it)."""
    global _COORDINATOR, _JOURNAL
    with _COORD_LOCK:
        _COORDINATOR = None
        journal, _JOURNAL = _JOURNAL, None
    if journal is not None:
        journal.close()


def handle_http(method: str, path: str,
                doc: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
    """``(status, body)`` of one ``/sched/*`` request of the
    introspection endpoint."""
    coord = _COORDINATOR
    if coord is None:
        return 409, {"error": "no scheduler coordinator in this process "
                              "(DisqOptions.scheduler='serve' arms one)"}
    op = path[len("/sched/"):]
    try:
        if op == "stats" and method == "GET":
            return 200, coord.stats(doc.get("run"))
        host = str(doc.get("host", ""))
        if not host:
            return 400, {"error": "missing host"}
        if op == "join":
            return 200, coord.join(host, doc.get("run"),
                                   rejoin=bool(doc.get("rejoin")))
        epoch = doc.get("epoch")
        if epoch is not None:
            epoch = int(epoch)
        run = str(doc.get("run", ""))
        if op == "lease":
            static_of = doc.get("static_of")
            direction = doc.get("dir")
            return 200, coord.lease(
                host, run, want=int(doc.get("want", DEFAULT_LEASE_N)),
                block_size=doc.get("block_size"), blocks=doc.get("blocks"),
                static_of=(tuple(int(x) for x in static_of)
                           if static_of else None),
                epoch=epoch,
                direction=(str(direction) if direction else None))
        if op == "done":
            return 200, coord.done(host, run, int(doc["shard"]), epoch=epoch)
        if op == "steal":
            return 200, coord.steal(host, run, epoch=epoch)
    except (KeyError, TypeError, ValueError) as e:
        return 400, {"error": f"bad request: {type(e).__name__}: {e}"}
    return 404, {"error": f"unknown scheduler path {path!r}",
                 "endpoints": ["/sched/join", "/sched/lease", "/sched/done",
                               "/sched/steal", "/sched/stats"]}


# -- the worker's client ------------------------------------------------------


class SchedulerClient:
    """A worker's JSON-over-HTTP client of the coordinator. With
    ``failover_dir``, a call that fails past its retries rediscovers the
    coordinator (the advertised address, or a takeover when this process
    is the lowest live member) and retries on a ``ShardRetrier``
    (``resilience.rediscovery_retrier``), raising the transient
    ``CoordinatorLostError`` only when those retries run out."""

    def __init__(self, address: str, host: str,
                 lease_n: int = DEFAULT_LEASE_N, steal: bool = True,
                 static_of: Optional[Tuple[int, int]] = None,
                 serves: bool = False, timeout_s: float = 10.0,
                 weight: float = 1.0, failover_dir: Optional[str] = None,
                 lease_s: float = DEFAULT_LEASE_S,
                 direction: str = "read") -> None:
        self.address = address
        self.host = host
        self.lease_n = max(1, int(lease_n))
        self.steal = bool(steal)
        self.static_of = static_of
        self.serves = serves  # this process hosts the coordinator
        self.timeout_s = timeout_s
        self.weight = float(weight)
        self.failover_dir = failover_dir
        self.lease_s = float(lease_s)  # the replay's, on a takeover
        self.direction = direction
        self.run_key: Optional[str] = None
        self.epoch: Optional[int] = None  # the pass, set by join()
        self._run_doc: Optional[Dict[str, Any]] = None  # for a rejoin

    def _call_once(self, op: str, doc: Dict[str, Any]) -> Dict[str, Any]:
        url = f"http://{self.address}/sched/{op}"
        body = json.dumps(doc).encode()
        last: Optional[Exception] = None
        with span("sched.rpc", op=op):
            for attempt in range(_RPC_RETRIES):
                try:
                    req = urllib.request.Request(
                        url, data=body, headers=inject_trace_headers(
                            {"Content-Type": "application/json"}))
                    with urllib.request.urlopen(
                            req, timeout=self.timeout_s) as resp:
                        return json.loads(resp.read())
                except urllib.error.HTTPError as e:
                    # the coordinator answered: its error, verbatim
                    try:
                        return json.loads(e.read())
                    except (ValueError, OSError, http.client.HTTPException):
                        raise IOError(
                            f"scheduler {op} failed: HTTP {e.code}") from e
                except (urllib.error.URLError, OSError, ValueError,
                        http.client.HTTPException) as e:
                    # HTTPException: a coordinator killed mid-body raises
                    # IncompleteRead, which is no OSError
                    last = e
                    time.sleep(_RPC_BACKOFF_S * (attempt + 1))
        raise IOError(f"scheduler coordinator at {self.address} unreachable "
                      f"({op}): {last}") from last

    def _call(self, op: str, doc: Dict[str, Any]) -> Dict[str, Any]:
        try:
            return self._call_once(op, doc)
        except IOError:
            if not self.failover_dir:
                raise
            return self._call_failover(op, doc)

    def _call_failover(self, op: str,
                       doc: Dict[str, Any]) -> Dict[str, Any]:
        from disq_tpu_torch.runtime.errors import CoordinatorLostError
        from disq_tpu_torch.runtime.resilience import rediscovery_retrier

        flightrec.record_event("sched_coordinator_lost",
                               address=self.address, op=op)

        def attempt() -> Dict[str, Any]:
            self._rediscover()
            fresh = dict(doc)
            if "epoch" in fresh:  # a rejoin may have moved the pass
                fresh["epoch"] = self.epoch
            try:
                return self._call_once(op, fresh)
            except IOError as e:
                raise CoordinatorLostError(
                    "scheduler coordinator lost", address=self.address,
                    op=op) from e

        return rediscovery_retrier().call(attempt, what="sched")

    def _rediscover(self) -> None:
        """The advertised address if it moved, else the election."""
        info = _read_json(_failover_paths(self.failover_dir)["addr"])
        advertised = str(info.get("address", "")) if info else ""
        if advertised and advertised != self.address:
            self.address = advertised
            counter("sched.failover.rediscoveries").inc()
            flightrec.record_event("sched_rediscovered",
                                   address=advertised, host=self.host)
            self._rejoin()
            return
        if self.serves and active_coordinator() is not None:
            return  # this process is the coordinator
        self._maybe_takeover()

    @staticmethod
    def _election_key(member: Dict[str, Any]) -> Tuple:
        return (int(member.get("process_id") or 0),
                int(member.get("pid") or 0), str(member.get("host") or ""))

    def _maybe_takeover(self) -> None:
        from disq_tpu_torch.runtime.cluster import probe_liveness

        members = _list_members(self.failover_dir)
        if not members:
            return
        alive = probe_liveness([m["endpoint"] for m in members],
                               timeout_s=1.0)
        live = sorted((m for m in members if alive.get(m["endpoint"])),
                      key=self._election_key)
        if not live:
            return
        winner = live[0]
        if (str(winner.get("host")) != self.host
                or int(winner.get("pid") or -1) != os.getpid()):
            return  # a lower live member takes over
        if not _acquire_takeover_lock(self.failover_dir, self.host):
            return
        try:
            # under the lock: a standby of an earlier election may serve
            info = _read_json(_failover_paths(self.failover_dir)["addr"])
            if (info and str(info.get("address", "")) != self.address
                    and _pid_alive(info.get("pid", -1))):
                self.address = str(info["address"])
                self._rejoin()
                return
            self._take_over_locked()
        finally:
            _release_takeover_lock(self.failover_dir)

    def _take_over_locked(self) -> None:
        """Replay the journal and serve it from this process."""
        from disq_tpu_torch.runtime.manifest import SchedJournal

        paths = _failover_paths(self.failover_dir)
        records = SchedJournal.load(paths["journal"])
        coord = replay_journal(records, lease_s=self.lease_s)
        coord.rebase_clock()
        journal = SchedJournal(paths["journal"])
        address = adopt_coordinator(coord, journal)
        journal.append("takeover", host=self.host, pid=os.getpid())
        advertise_coordinator(self.failover_dir, address)
        self.address = address
        self.serves = True
        counter("sched.failover.takeovers").inc(host=self.host)
        flightrec.record_event("sched_takeover", host=self.host,
                               address=address, replayed=len(records))
        self._rejoin()

    def _rejoin(self) -> None:
        """Register again with the join document of ``join()``: the
        replay kept the run, so this refreshes membership and the epoch."""
        if self._run_doc is None:
            return
        try:
            resp = self._call_once("join", {"host": self.host,
                                            "run": self._run_doc,
                                            "rejoin": True})
        except IOError:
            return  # the retrier's next attempt rediscovers again
        if resp.get("epoch") is not None:
            self.epoch = resp.get("epoch")

    def _with_rejoin(self, op: str, doc: Dict[str, Any]) -> Dict[str, Any]:
        """``op``; an ``unknown run`` answer (a coordinator restarted
        since this worker joined) rejoins and retries once."""
        resp = self._call(op, doc)
        err = resp.get("error")
        if (isinstance(err, str) and "unknown run" in err
                and self._run_doc is not None):
            jr = self._call("join", {"host": self.host, "run": self._run_doc,
                                     "rejoin": True})
            if jr.get("epoch") is not None:
                self.epoch = jr.get("epoch")
            doc = dict(doc)
            if "epoch" in doc:
                doc["epoch"] = self.epoch
            flightrec.record_event("sched_rejoin", host=self.host, op=op,
                                   run=self.run_key)
            resp = self._call(op, doc)
        return resp

    def join(self, run_doc: Dict[str, Any]) -> Dict[str, Any]:
        self.run_key = str(run_doc["key"])
        run_doc.setdefault("weight", self.weight)
        if self.direction != "read":
            run_doc.setdefault("dir", self.direction)
        self._run_doc = run_doc
        resp = self._call("join", {"host": self.host, "run": run_doc})
        self.epoch = resp.get("epoch")
        return resp

    def lease(self, cache: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
        doc: Dict[str, Any] = {"host": self.host, "run": self.run_key,
                               "want": self.lease_n, "epoch": self.epoch}
        if cache:
            doc.update(cache)
        if self.static_of is not None:
            doc["static_of"] = list(self.static_of)
        if self.direction != "read":
            doc["dir"] = self.direction
        return self._with_rejoin("lease", doc)

    def steal_once(self) -> Dict[str, Any]:
        return self._with_rejoin("steal", {"host": self.host,
                                           "run": self.run_key,
                                           "epoch": self.epoch})

    def done(self, shard: int) -> Dict[str, Any]:
        return self._with_rejoin("done", {"host": self.host,
                                          "run": self.run_key,
                                          "shard": int(shard),
                                          "epoch": self.epoch})


def _env_number(name: str, default, cast):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return cast(raw)
    except ValueError:
        return default


def _mode(storage) -> Optional[str]:
    """The storage's scheduler mode, else ``DISQ_TPU_TORCH_SCHED``."""
    opts = getattr(storage, "_options", None)
    mode = getattr(opts, "scheduler", None) if opts is not None else None
    return mode or os.environ.get(_ENV) or None


def client_for_storage(storage, direction: str = "read"
                       ) -> Optional[SchedulerClient]:
    """The scheduler client of one read (or, with ``direction="write"``,
    one write stage); None when the scheduler is off."""
    from disq_tpu_torch.runtime.errors import DisqOptions
    from disq_tpu_torch.runtime.multihost import process_id

    mode = _mode(storage)
    if not mode:
        return None
    opts = getattr(storage, "_options", None) or DisqOptions()
    lease_n = _env_number(_ENV + "_LEASE_N", opts.sched_lease_n, int)
    lease_s = _env_number(_ENV + "_LEASE_S", opts.sched_lease_s, float)
    steal = bool(_env_number(_ENV + "_STEAL", int(opts.sched_steal), int))
    weight = _env_number(_ENV + "_WEIGHT", opts.sched_run_weight, float)
    failover_dir = (os.environ.get(_ENV + "_FAILOVER")
                    or opts.sched_failover_dir)
    static_of = None
    static_raw = os.environ.get(_ENV + "_STATIC")
    if static_raw:
        try:
            k, n = static_raw.replace("/", ",").split(",")
            static_of = (int(k), int(n))
        except ValueError:
            static_of = None
    serves = mode in ("serve", "1", "coordinator")
    host = os.environ.get(_ENV + "_HOST") or f"p{process_id()}"
    if serves:
        address = serve_coordinator(lease_s=lease_s,
                                    port=opts.introspect_port or 0,
                                    failover_dir=failover_dir)
        if failover_dir:
            register_member(failover_dir, host, address)
    elif mode == "auto":
        if not failover_dir:
            raise ValueError(
                "scheduler='auto' finds the coordinator through the "
                "failover directory: set DisqOptions.sched_failover_dir "
                "or DISQ_TPU_TORCH_SCHED_FAILOVER")
        address = discover_coordinator(failover_dir)
    else:
        address = mode
    if failover_dir and not serves:
        # a member of the election must answer a liveness probe (and
        # can host an adopted coordinator): it serves the endpoint too
        from disq_tpu_torch.runtime.introspect import start_introspect_server

        register_member(failover_dir, host, start_introspect_server(0))
    return SchedulerClient(address, host, lease_n=lease_n, steal=steal,
                           static_of=static_of, serves=serves,
                           weight=weight, failover_dir=failover_dir,
                           lease_s=lease_s, direction=direction)


# -- the scheduled split loop -------------------------------------------------


def _cache_hints(fs, path: str) -> Optional[Dict[str, Any]]:
    """The worker's locality hint: its HTTP block cache for ``path``
    (None on other filesystems: every pick is then a miss, the truth)."""
    from disq_tpu_torch.fsw.http import HttpFileSystemWrapper

    inner = fs
    if hasattr(fs, "inner"):  # the fault-injecting wrapper
        if hasattr(fs, "_strip"):
            path = fs._strip(path)
        inner = fs.inner
    if not isinstance(inner, HttpFileSystemWrapper):
        return None
    return {"block_size": inner.block_size,
            "blocks": inner.cached_block_indices(path)}


def run_key_for(path: str, n_shards: int, direction: str = "read") -> str:
    """``path#n_shards`` (``#salt`` with ``DISQ_TPU_TORCH_SCHED_SALT``); a
    write stage's key ends in ``#write``, apart from the read feeding it."""
    salt = os.environ.get(_ENV + "_SALT", "")
    key = f"{path}#{n_shards}" + (f"#{salt}" if salt else "")
    return key + "#write" if direction == "write" else key


def scheduled_map_ordered(storage, fs, path: str, executor, tasks,
                          ledger=None) -> Iterator:
    """``map_ordered_resumable`` behind the scheduler. Off (the default)
    it is ``map_ordered_resumable``'s own iterator. On, this worker joins
    the run's queue and yields the shards it wins, ascending within each
    lease batch, so a single scheduled worker emits the static sequence.
    With a ``ledger`` each emitted shard is spilled before its
    ``/sched/done``: a successor loads a dead worker's finished shards
    instead of decoding them."""
    from disq_tpu_torch.runtime.executor import map_ordered_resumable

    client = client_for_storage(storage)
    if client is None:
        return map_ordered_resumable(executor, tasks, ledger)
    return _scheduled_iter(client, storage, fs, path, executor, list(tasks),
                           ledger)


def _scheduled_iter(client: SchedulerClient, storage, fs, path: str,
                    executor, tasks: List, ledger) -> Iterator:
    from disq_tpu_torch.runtime.executor import (
        ShardResult,
        executor_for_storage,
    )

    by_id = {t.shard_id: t for t in tasks}
    client.join({
        "key": run_key_for(path, len(tasks)),
        "path": path,
        "shards": {str(t.shard_id): (list(t.byte_range) if t.byte_range
                                     else None) for t in tasks},
    })
    if ledger is not None:
        # several processes record into one ledger: merge on flush
        ledger.manifest.mark_shared()
    # one map_ordered per lease batch: an executor with resilience armed
    # closes its manager when a run ends, so each batch gets a new one
    single_use = executor._resilience is not None
    current = executor
    idle = _IDLE_SLEEP_MIN_S
    finished = False
    while True:
        resp = client.lease(_cache_hints(fs, path))
        if resp.get("error"):
            # a coordinator that forgot the run: fail loudly, not spin
            raise IOError(f"scheduler lease failed: {resp['error']}")
        ids = list(resp.get("shards") or [])
        if not ids and client.steal and client.static_of is None:
            with span("sched.steal"):
                sresp = client.steal_once()
            if sresp.get("error"):
                raise IOError(f"scheduler steal failed: {sresp['error']}")
            ids = list(sresp.get("shards") or [])
            if not ids and sresp.get("finished"):
                finished = True
        if not ids:
            if resp.get("finished") or finished:
                finished = True
                break
            if client.static_of is not None:
                break  # this host's residue class is drained
            record_span("sched.wait", idle)
            time.sleep(idle)
            idle = min(_IDLE_SLEEP_MAX_S, idle * 1.7)
            continue
        idle = _IDLE_SLEEP_MIN_S
        ids.sort()
        cached = {i for i in ids if ledger is not None and ledger.is_done(i)}
        if current is None:
            current = executor_for_storage(storage)
        fresh_iter = current.map_ordered(
            [by_id[i] for i in ids if i not in cached])
        for i in ids:
            if i in cached:
                res = ShardResult(i, ledger.load(i))
            else:
                res = next(fresh_iter)
                if ledger is not None:
                    # spill before done: a shard the coordinator thinks
                    # complete can be loaded by anyone
                    ledger.record(res.shard_id, res.value)
            if client.done(res.shard_id).get("won", True):
                yield res
            # else a thief emitted it first: this copy is dropped
        # end the batch's run now (its resilience manager, its pools)
        if next(fresh_iter, None) is not None:
            raise RuntimeError("scheduled batch emitted extra shards")
        if single_use:
            current = None
    if finished and client.serves and ledger is not None:
        # the coordinator's host saw the run complete: the commit point
        ledger.finish()


# -- write leases -------------------------------------------------------------


def write_leasing_armed(storage) -> bool:
    """Whether write stages lease through the coordinator: the mode test
    of ``client_for_storage`` without building a client."""
    return bool(_mode(storage))


def scheduled_write_stage(storage, path: str, pipeline, n_shards: int,
                          make_task, manifest,
                          stage_name: str = "write.parts",
                          retries: int = 1, fs=None) -> List[Any]:
    """``run_write_stage`` behind the scheduler: the stage's shards lease
    through the coordinator (run key ``...#write``, ``dir=write``), the
    shared ``StageManifest`` the durable side. Each shard is marked as
    its part lands and the manifest is flushed once per lease batch,
    before the batch's ``done`` calls, so every shard the coordinator
    thinks complete has its record on disk, and a killed writer loses at
    most its batch in flight, whose leases expire to the survivors. No
    stealing: a stolen write would stage one part twice at once. Tasks
    with a ``byte_range`` register it, and each lease carries the
    worker's block cache of ``path`` (``fs`` permitting), so write
    leases are scored as read leases are. Returns every shard's info in
    shard order, other hosts' from the shared manifest."""
    from disq_tpu_torch.runtime.executor import _checkpointed, run_write_stage

    client = client_for_storage(storage, direction="write")
    if client is None:
        return run_write_stage(pipeline, n_shards, make_task,
                               manifest=manifest, stage_name=stage_name,
                               retries=retries)
    # several processes mark into one file: merge on flush, flushes
    # batched behind a short interval
    manifest.mark_shared(flush_interval_s=0.05)
    tasks = {k: make_task(k) for k in range(n_shards)}
    client.join({
        "key": run_key_for(path, n_shards, direction="write"),
        "path": path,
        "shards": {str(k): (list(t.byte_range) if t.byte_range else None)
                   for k, t in tasks.items()},
        "dir": "write",
    })
    # resume: shards the manifest holds are reported done, never leased
    for k in range(n_shards):
        if manifest.is_done(stage_name, k):
            client.done(k)
    idle = _IDLE_SLEEP_MIN_S
    while True:
        resp = client.lease(_cache_hints(fs, path) if fs is not None
                            else None)
        if resp.get("error"):
            raise IOError(f"scheduler write lease failed: {resp['error']}")
        ids = sorted(resp.get("shards") or [])
        if not ids:
            if resp.get("finished"):
                break
            record_span("sched.wait", idle)
            time.sleep(idle)
            idle = min(_IDLE_SLEEP_MAX_S, idle * 1.7)
            continue
        idle = _IDLE_SLEEP_MIN_S
        fresh = [_checkpointed(tasks[k], manifest, stage_name, retries)
                 for k in ids
                 if not manifest.is_done(stage_name, k)]
        for _res in pipeline.map_ordered(fresh):
            pass  # the infos come from the manifest below
        manifest.flush()  # on disk before the coordinator learns
        for k in ids:
            client.done(k)
    manifest.flush()
    manifest.reload()  # other hosts' infos are only in the file
    return [manifest.shard_info(stage_name, k) for k in range(n_shards)]
