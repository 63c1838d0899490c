"""Live introspection: is the run making progress right now.

Counterpart of ``disq_tpu/runtime/introspect.py``:

- **PipelineHealth board** (the ``HEALTH`` singleton): both pipeline
  directions (``ShardPipelineExecutor`` reads, ``ShardWritePipeline``
  writes) register each ``map_ordered`` run and stamp per-shard,
  per-stage heartbeats as stage workers start and finish work. It feeds
  the watchdog, ``/healthz``, ``/progress`` and the progress log.
- **Heartbeat watchdog**: a ``disq-watchdog`` thread flags any shard
  whose active stage has been silent past ``watchdog_stall_s``
  (``watchdog.stalled_shards{stage=}``, a ``watchdog.stall`` span, one
  rate-limited stderr line, ``/healthz`` degraded). Policy ``warn``
  keeps going; ``abort`` cancels the run through the pipeline's
  first-error-abort path with a ``WatchdogStallError``.
- **Progress and ETA**: shard completions and each source's
  ``ShardCounters`` (``note_shard_counters``) feed rolling records/s,
  shards done / in flight / total, byte totals and an ETA, served on
  ``/progress`` and appended to the optional JSONL progress log
  (``DisqOptions.progress_log``).
- **HTTP endpoint**: an opt-in ``http.server`` on 127.0.0.1
  (``DisqOptions.introspect_port`` / ``DISQ_TPU_TORCH_INTROSPECT_PORT``;
  0 binds an ephemeral port) serving ``/metrics``, ``/healthz``,
  ``/progress``, ``/spans``, ``/slo``, ``/debug/stacks``,
  ``/debug/profile`` and ``/debug/bundle``. Every payload carries
  ``multihost.process_id()`` (the ``disq_tpu_process_info`` series, a
  ``process_id`` key) so ``runtime/cluster.py`` can merge N workers.
  The scheduler, serving and fleet planes (``/sched/*``, ``/serve/*``,
  ``/query/*``, ``/fleet/*``) are not ported yet; they answer as the
  reference's answer when none is running.

Disabled (the default), ``configure_from_options`` returns None, the
pipelines carry ``health=None`` (every per-shard hook is one ``is None``
test), ``note_shard_counters`` returns after one boolean test, and no
thread or socket exists.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from disq_tpu_torch.runtime import flightrec, tracing
from disq_tpu_torch.runtime.errors import WatchdogStallError
from disq_tpu_torch.runtime.multihost import process_id as _process_id
from disq_tpu_torch.runtime.tracing import RUN_ID, counter, record_span

# Module lifecycle (server / monitor / progress sink) is guarded by one
# lock; the board has its own finer-grained lock for per-shard traffic.
_STATE_LOCK = threading.RLock()

DEFAULT_PROGRESS_INTERVAL_S = 0.5
_WARN_INTERVAL_S = 1.0       # stderr stall warnings, at most one per
_IDLE_TICKS_BEFORE_EXIT = 25  # monitor exits after ~5 s with nothing to do
_SPANS_TAIL_DEFAULT = 512
_SPANS_TAIL_MAX = 8192
_RATE_WINDOW_S = 10.0        # rolling-rate lookback


class _RunState:
    """One registered ``map_ordered`` run on the board."""

    __slots__ = ("token", "direction", "total", "stall_s", "policy",
                 "done", "started", "active", "flagged", "abort",
                 "abort_sent", "pending_abort")

    def __init__(self, token: int, direction: str, total: int,
                 stall_s: Optional[float], policy: str) -> None:
        self.token = token
        self.direction = direction
        self.total = total
        self.stall_s = stall_s
        self.policy = policy
        self.done = 0
        self.started = time.perf_counter()
        self.active: Dict[int, Tuple[str, float]] = {}  # shard -> (stage, since)
        self.flagged: set = set()
        self.abort: Optional[Callable[[BaseException], None]] = None
        self.abort_sent = False
        # Cooperative delivery for inline (workers=1) runs, which have
        # no pipeline to inject an error into: the run's own thread
        # picks this up at its next stage boundary (take_abort).
        self.pending_abort: Optional[BaseException] = None


def _new_agg() -> Dict[str, Any]:
    return {
        "records": 0, "bytes_compressed": 0, "bytes_uncompressed": 0,
        "shards_done": 0,
        "record_samples": deque(maxlen=512),  # (mono, cumulative records)
        "shard_samples": deque(maxlen=512),   # (mono, cumulative shards)
        "last_total": 0, "last_done": 0, "last_elapsed_s": 0.0,
    }


class PipelineHealth:
    """Shared heartbeat/progress board for both pipeline directions.

    Thread-safe; every mutator is cheap (dict/deque ops under one
    lock). The pipelines only talk to it when live-introspection is
    configured for their run — the disabled path never reaches here.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._runs: Dict[int, _RunState] = {}
        self._next_token = 0
        self._agg: Dict[str, Dict[str, Any]] = {
            "read": _new_agg(), "write": _new_agg(),
        }
        self._stall_events = 0
        self._last_warn = 0.0

    # -- liveness gate ------------------------------------------------------

    @property
    def live(self) -> bool:
        """True when any consumer of progress data exists (endpoint,
        progress log, or an introspected run in flight) — the one-test
        gate ``note_shard_counters`` uses."""
        return bool(self._runs) or _server is not None \
            or _progress_sink is not None

    # -- run lifecycle ------------------------------------------------------

    def register_run(self, direction: str, total: int,
                     stall_s: Optional[float] = None,
                     policy: str = "warn") -> int:
        with self._lock:
            self._next_token += 1
            token = self._next_token
            self._runs[token] = _RunState(token, direction, total,
                                          stall_s, policy)
        if stall_s or _progress_sink is not None:
            _ensure_monitor()
        return token

    def set_abort(self, token: int,
                  abort: Callable[[BaseException], None]) -> None:
        with self._lock:
            run = self._runs.get(token)
            if run is not None:
                run.abort = abort

    def finish_run(self, token: int) -> None:
        with self._lock:
            run = self._runs.pop(token, None)
            if run is None:
                return
            agg = self._agg[run.direction]
            agg["last_total"] = run.total
            agg["last_done"] = run.done
            agg["last_elapsed_s"] = time.perf_counter() - run.started
        _maybe_write_progress(final_direction=run.direction)

    # -- heartbeats ---------------------------------------------------------

    def beat(self, token: int, stage: str, shard_id: int) -> None:
        """A stage worker starts (or refreshes) work on one shard."""
        with self._lock:
            run = self._runs.get(token)
            if run is None:
                return
            run.active[shard_id] = (stage, time.perf_counter())
            run.flagged.discard(shard_id)

    def clear(self, token: int, stage: str, shard_id: int) -> None:
        """A stage worker finished its stage for one shard."""
        with self._lock:
            run = self._runs.get(token)
            if run is None:
                return
            entry = run.active.get(shard_id)
            if entry is not None and entry[0] == stage:
                del run.active[shard_id]
            run.flagged.discard(shard_id)

    def shard_done(self, token: int, shard_id: int) -> None:
        now = time.perf_counter()
        with self._lock:
            run = self._runs.get(token)
            if run is None:
                return
            run.done += 1
            run.active.pop(shard_id, None)
            run.flagged.discard(shard_id)
            agg = self._agg[run.direction]
            agg["shards_done"] += 1
            agg["shard_samples"].append((now, agg["shards_done"]))
            direction = run.direction
        counter("progress.shards").inc(direction=direction)

    def note_counters(self, direction: str, records: int = 0,
                      bytes_compressed: int = 0,
                      bytes_uncompressed: int = 0) -> None:
        now = time.perf_counter()
        with self._lock:
            agg = self._agg.get(direction)
            if agg is None:
                return
            agg["records"] += records
            agg["bytes_compressed"] += bytes_compressed
            agg["bytes_uncompressed"] += bytes_uncompressed
            agg["record_samples"].append((now, agg["records"]))
        if records:
            counter("progress.records").inc(records)
        if bytes_compressed:
            counter("progress.bytes").inc(bytes_compressed,
                                          kind="compressed")
        if bytes_uncompressed:
            counter("progress.bytes").inc(bytes_uncompressed,
                                          kind="uncompressed")

    # -- watchdog -----------------------------------------------------------

    def suggested_tick(self) -> float:
        with self._lock:
            stalls = [r.stall_s for r in self._runs.values() if r.stall_s]
        if not stalls:
            return 0.2
        return max(0.02, min(0.25, min(stalls) / 4.0))

    def check(self, now: Optional[float] = None) -> int:
        """One watchdog sweep: flag every shard whose active stage has
        been silent past its run's ``watchdog_stall_s``. Returns the
        number of NEW stall events flagged this sweep."""
        if now is None:
            now = time.perf_counter()
        events: List[Tuple[_RunState, int, str, float]] = []
        with self._lock:
            for run in self._runs.values():
                if not run.stall_s:
                    continue
                for shard, (stage, since) in list(run.active.items()):
                    age = now - since
                    if age >= run.stall_s and shard not in run.flagged:
                        run.flagged.add(shard)
                        events.append((run, shard, stage, age))
            self._stall_events += len(events)
        for run, shard, stage, age in events:
            counter("watchdog.stalled_shards").inc(stage=stage)
            record_span("watchdog.stall", age, shard=shard, stage=stage,
                        direction=run.direction)
            flightrec.record_event(
                "watchdog_stall", shard=shard, stage=stage,
                age_s=round(age, 3), direction=run.direction,
                policy=run.policy)
            self._warn(run, shard, stage, age, now)
            if run.policy == "abort" and not run.abort_sent:
                run.abort_sent = True
                exc = WatchdogStallError(
                    "watchdog: shard stalled past "
                    f"watchdog_stall_s={run.stall_s}s",
                    shard_id=shard, stage=stage, age_s=age,
                    direction=run.direction)
                abort = run.abort
                if abort is not None:
                    # Pipelined run: inject into the first-error-abort
                    # path, raised at the ordered emit.
                    abort(exc)
                else:
                    # Inline (workers=1) run: no pipeline to inject
                    # into — park the error for the run's own thread to
                    # raise at its next stage boundary.
                    with self._lock:
                        run.pending_abort = exc
        return len(events)

    def take_abort(self, token: int) -> Optional[BaseException]:
        """Cooperative abort pickup for inline runs: the pending
        watchdog error for this run, if any (cleared on read). The
        inline executors call this at every stage boundary."""
        with self._lock:
            run = self._runs.get(token)
            if run is None or run.pending_abort is None:
                return None
            exc, run.pending_abort = run.pending_abort, None
            return exc

    def _warn(self, run: _RunState, shard: int, stage: str, age: float,
              now: float) -> None:
        with self._lock:
            if now - self._last_warn < _WARN_INTERVAL_S:
                return
            self._last_warn = now
        sys.stderr.write(
            f"disq_tpu_torch watchdog: {run.direction} shard {shard} stalled "
            f"in {stage} for {age:.2f}s "
            f"(watchdog_stall_s={run.stall_s}, policy={run.policy})\n")

    # -- views --------------------------------------------------------------

    def has_active_runs(self) -> bool:
        return bool(self._runs)

    def healthz(self) -> Dict[str, Any]:
        """JSON liveness verdict: ``degraded`` while any flagged stall
        is still active — or any circuit breaker is open — ``ok``
        otherwise (``stall_events`` keeps the historical total either
        way).  When the resilience layer is configured
        (``runtime/resilience.py``), its state rides along: the retry
        budget's fill level and every per-filesystem breaker."""
        from disq_tpu_torch.runtime import resilience

        now = time.perf_counter()
        with self._lock:
            stalls = []
            watchdogged = False
            for run in self._runs.values():
                if run.stall_s:
                    watchdogged = True
                for shard in sorted(run.flagged):
                    entry = run.active.get(shard)
                    if entry is None:
                        continue
                    stage, since = entry
                    stalls.append({
                        "direction": run.direction, "shard": shard,
                        "stage": stage, "age_s": round(now - since, 3),
                        "policy": run.policy,
                    })
            doc = {
                "status": "degraded" if stalls else "ok",
                "run_id": RUN_ID,
                "active_runs": len(self._runs),
                "watchdog_active": watchdogged,
                "stall_events": self._stall_events,
                "stalls": stalls,
            }
        res = resilience.snapshot()
        if res:
            doc["resilience"] = res
            if any(b["state"] == "open"
                   for b in res.get("breakers", {}).values()):
                doc["status"] = "degraded"
        # Per-tenant SLO verdict (runtime/slo.py): a tenant burning its
        # error budget past the fast-burn threshold on the short
        # windows is a paging condition — the fleet aggregator and any
        # LB health check see it here, not just on /slo.
        from disq_tpu_torch.runtime import slo as _slo

        ev = _slo.evaluator_if_running()
        if ev is not None:
            frag = ev.health_fragment()
            doc["slo"] = frag
            if frag.get("fast_burn_tenants"):
                doc["status"] = "degraded"
        return doc

    @staticmethod
    def _rate(samples: "deque") -> float:
        if len(samples) < 2:
            return 0.0
        t1, v1 = samples[-1]
        window = [(t, v) for t, v in samples if t1 - t <= _RATE_WINDOW_S]
        if len(window) < 2:
            window = [samples[-2], samples[-1]]
        t0, v0 = window[0]
        dt = t1 - t0
        return (v1 - v0) / dt if dt > 1e-6 else 0.0

    def progress(self) -> Dict[str, Any]:
        """Progress view per direction: shards done / in flight /
        total, records and bytes so far, rolling rates, ETA."""
        now = time.perf_counter()
        out: Dict[str, Any] = {"run_id": RUN_ID, "directions": {}}
        with self._lock:
            for direction in ("read", "write"):
                agg = self._agg[direction]
                runs = [r for r in self._runs.values()
                        if r.direction == direction]
                total = sum(r.total for r in runs) or agg["last_total"]
                done = sum(r.done for r in runs) if runs else agg["last_done"]
                if not total and not agg["records"]:
                    continue
                shards_per_sec = self._rate(agg["shard_samples"])
                remaining = max(0, total - done)
                view = {
                    "active": bool(runs),
                    "shards_total": total,
                    "shards_done": done,
                    "in_flight": sum(len(r.active) for r in runs),
                    "records": agg["records"],
                    "bytes_compressed": agg["bytes_compressed"],
                    "bytes_uncompressed": agg["bytes_uncompressed"],
                    "records_per_sec":
                        round(self._rate(agg["record_samples"]), 1),
                    "shards_per_sec": round(shards_per_sec, 3),
                    "elapsed_s": round(
                        (now - min(r.started for r in runs)) if runs
                        else agg["last_elapsed_s"], 3),
                    "eta_s": (round(remaining / shards_per_sec, 3)
                              if runs and remaining and shards_per_sec > 0
                              else (0.0 if not remaining else None)),
                }
                out["directions"][direction] = view
        return out

    def reset(self) -> None:
        """Test hook: forget every run and aggregate."""
        with self._lock:
            self._runs.clear()
            self._agg = {"read": _new_agg(), "write": _new_agg()}
            self._stall_events = 0
            self._last_warn = 0.0


HEALTH = PipelineHealth()


def note_shard_counters(direction: str, counters) -> None:
    """Feed one shard's ``ShardCounters`` into the progress view — the
    single plumbing call each source makes at ordered emit. Free when
    nothing is watching."""
    if not HEALTH.live:
        return
    HEALTH.note_counters(
        direction,
        records=int(getattr(counters, "records", 0) or 0),
        bytes_compressed=int(getattr(counters, "bytes_compressed", 0) or 0),
        bytes_uncompressed=int(
            getattr(counters, "bytes_uncompressed", 0) or 0),
    )


# ---------------------------------------------------------------------------
# Watchdog / progress monitor thread
# ---------------------------------------------------------------------------

_monitor_thread: Optional[threading.Thread] = None


def _ensure_monitor() -> None:
    global _monitor_thread
    with _STATE_LOCK:
        if _monitor_thread is not None and _monitor_thread.is_alive():
            return
        _monitor_thread = threading.Thread(
            target=_monitor_loop, name="disq-watchdog", daemon=True)
        _monitor_thread.start()


def _monitor_loop() -> None:
    global _monitor_thread
    idle = 0
    next_progress = 0.0
    while True:
        time.sleep(HEALTH.suggested_tick())
        now = time.perf_counter()
        HEALTH.check(now)
        if _progress_sink is not None and now >= next_progress:
            _maybe_write_progress()
            next_progress = now + _progress_interval
        if HEALTH.has_active_runs() or _progress_sink is not None:
            idle = 0
            continue
        idle += 1
        if idle > _IDLE_TICKS_BEFORE_EXIT:
            with _STATE_LOCK:
                if (not HEALTH.has_active_runs()
                        and _progress_sink is None):
                    _monitor_thread = None
                    return
            idle = 0


# ---------------------------------------------------------------------------
# Progress JSONL log
# ---------------------------------------------------------------------------

_progress_sink = None
_progress_path: Optional[str] = None
_progress_interval = DEFAULT_PROGRESS_INTERVAL_S


def start_progress_log(path: str,
                       interval_s: float = DEFAULT_PROGRESS_INTERVAL_S
                       ) -> None:
    """Start (or re-point) the periodic progress JSONL: one line per
    direction per ``interval_s`` while runs are active, plus a final
    line as each run finishes. Replay with
    ``scripts/trace_report.py --progress``."""
    global _progress_sink, _progress_path, _progress_interval
    with _STATE_LOCK:
        _progress_interval = max(0.05, float(interval_s))
        if _progress_sink is not None:
            if _progress_path == path:
                return
            _progress_sink.close()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _progress_sink = open(path, "a")
        _progress_path = path
        _progress_sink.write(json.dumps({
            "meta": 1, "kind": "progress", "run_id": RUN_ID,
            "pid": os.getpid(), "epoch": time.time(),
            "mono": time.perf_counter(),
        }) + "\n")
        _progress_sink.flush()
    _ensure_monitor()


def stop_progress_log() -> None:
    global _progress_sink, _progress_path
    with _STATE_LOCK:
        if _progress_sink is not None:
            _progress_sink.close()
            _progress_sink = None
            _progress_path = None


def progress_log_path() -> Optional[str]:
    return _progress_path


def _maybe_write_progress(final_direction: Optional[str] = None) -> None:
    """Append one progress line per direction that has data. With
    ``final_direction`` (a run just finished), only that direction is
    written — so even sub-interval runs leave at least one line."""
    with _STATE_LOCK:
        if _progress_sink is None:
            return
        snap = HEALTH.progress()
        now = time.perf_counter()
        for direction, view in snap["directions"].items():
            if final_direction is not None and direction != final_direction:
                continue
            rec = {"ts": round(time.time(), 6), "mono": round(now, 6),
                   "run_id": snap["run_id"], "direction": direction}
            rec.update(view)
            _progress_sink.write(json.dumps(rec, default=str) + "\n")
        _progress_sink.flush()


# ---------------------------------------------------------------------------
# HTTP endpoint
# ---------------------------------------------------------------------------

_server: Optional[ThreadingHTTPServer] = None
_server_thread: Optional[threading.Thread] = None
_address: Optional[str] = None


class _NamedThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose per-request threads carry a
    canonical ``disq-*`` name — the sampling profiler and py-spy both
    attribute by thread name, and an anonymous handler thread (e.g.
    one blocking inside ``/debug/profile``) would profile as
    ``other``."""

    # socketserver's default listen backlog of 5 predates the serving
    # plane: a burst of concurrent query clients (bench config 13 runs
    # 32) overflows it and the kernel resets the excess connects before
    # the accept loop ever sees them. Admission control must be the
    # thing that sheds load, not the listen queue.
    request_queue_size = 128

    def process_request_thread(self, request, client_address):
        threading.current_thread().name = "disq-introspect-req"
        super().process_request_thread(request, client_address)


def _unported_plane(path: str) -> Tuple[int, Dict[str, Any]]:
    """``(status, doc)`` of a scheduler, serving or fleet request: the
    reference's answer when the plane is not running in the process (409
    for ``/sched/*``, 503 for the others)."""
    if path.startswith("/sched/"):
        return 409, {"error": "no scheduler coordinator in this process "
                              "(DisqOptions.scheduler='serve' arms one)"}
    if path.startswith("/fleet/"):
        return 503, {"error": "fleet tier not started"}
    return 503, {"error": "serving plane not started"}


class _Handler(BaseHTTPRequestHandler):
    server_version = "disq-tpu-torch-introspect/1"
    # Keep-alive matters once the serving plane (runtime/serve.py) runs
    # query traffic over this endpoint: a closed-loop client holds one
    # connection instead of paying connect+teardown per request. Safe
    # because every response goes through _send, which always sets
    # Content-Length. The socket timeout reaps idle parked connections
    # so handler threads never outlive their client by more than this.
    protocol_version = "HTTP/1.1"
    timeout = 30
    # Headers and body leave as separate writes; with Nagle on, the
    # second segment waits out the peer's delayed ACK (~40 ms) — a
    # latency floor that buries every sub-millisecond cache hit.
    disable_nagle_algorithm = True

    def log_message(self, *args: Any) -> None:  # quiet by design
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, doc: Dict[str, Any], code: int = 200) -> None:
        self._send(code, json.dumps(doc, default=str).encode(),
                   "application/json")

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        path, _, query = self.path.partition("?")
        if path == "/metrics":
            # The process-identity info series is what lets a cluster
            # aggregator (runtime/cluster.py) tell N workers'
            # expositions apart and label merged series process=<id>.
            info = (
                "# TYPE disq_tpu_process_info gauge\n"
                'disq_tpu_process_info{process_id="%d",run_id="%s"} 1\n'
                % (_process_id(), RUN_ID))
            self._send(200, (info + tracing.metrics_text()).encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            doc = HEALTH.healthz()
            doc["process_id"] = _process_id()
            self._send_json(doc, 200 if doc["status"] == "ok" else 503)
        elif path == "/progress":
            doc = HEALTH.progress()
            doc["process_id"] = _process_id()
            self._send_json(doc)
        elif path == "/spans":
            n = _SPANS_TAIL_DEFAULT
            for part in query.split("&"):
                if part.startswith("n="):
                    try:
                        n = max(1, min(_SPANS_TAIL_MAX, int(part[2:])))
                    except ValueError:
                        pass
            ring = tracing.spans()
            # epoch+mono pair: lets a cross-process stitcher
            # (trace_report --request over live endpoints) align this
            # process's monotonic span timestamps to wall clock
            self._send_json({
                "run_id": RUN_ID,
                "pid": os.getpid(),
                "epoch": time.time(),
                "mono": time.perf_counter(),
                "dropped_spans":
                    counter("telemetry.dropped_spans").total(),
                "total_in_ring": len(ring),
                "spans": ring[-n:],
            })
        elif path.startswith(("/sched/", "/serve/", "/fleet/")):
            code, body = _unported_plane(path)
            self._send_json(body, code)
        elif path == "/debug/stacks":
            self._send(200, flightrec.thread_stacks_text().encode(),
                       "text/plain; charset=utf-8")
        elif path == "/debug/profile":
            self._serve_profile(query)
        elif path == "/debug/bundle":
            bundle = flightrec.dump(reason="endpoint")
            if bundle is None:
                self._send_json({
                    "error": "flight recorder disabled — set "
                             "DisqOptions.postmortem_dir or "
                             "DISQ_TPU_TORCH_POSTMORTEM_DIR (or the "
                             "per-process bundle cap was reached)",
                }, 409)
            else:
                self._send_json({"bundle": bundle, "run_id": RUN_ID})
        elif path == "/slo":
            # Per-tenant SLO view (runtime/slo.py): resolved lazily —
            # the SLO-off path reports a disabled stub and never
            # creates an evaluator.
            from disq_tpu_torch.runtime import slo

            doc = slo.slo_doc()
            doc["process_id"] = _process_id()
            self._send_json(doc)
        else:
            self._send_json({"error": "unknown path", "endpoints": [
                "/metrics", "/healthz", "/progress", "/spans", "/slo",
                "/debug/stacks", "/debug/profile", "/debug/bundle",
                "/sched/stats", "/serve/stats", "/serve/cachemap",
                "/fleet/stats"]},
                404)

    def do_POST(self) -> None:  # noqa: N802 — http.server API
        """The mutating endpoints of the scheduler (``/sched/*``),
        serving (``/query/*``, ``/serve/*``) and fleet (``/fleet/*``)
        planes; everything else is GET-only. None of the three is
        ported yet, so a well-formed request gets the reference's answer
        for a process that runs none of them."""
        path, _, _query = self.path.partition("?")
        if not path.startswith(("/sched/", "/query/", "/serve/",
                                "/fleet/")):
            self._send_json(
                {"error": "POST only serves /sched/*, /query/*, "
                          "/serve/* and /fleet/*"}, 404)
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            doc = json.loads(self.rfile.read(length)) if length else {}
            if not isinstance(doc, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, OSError) as e:
            self._send_json({"error": f"bad request body: {e}"}, 400)
            return
        code, body = _unported_plane(path)
        self._send_json(body, code)

    def _serve_profile(self, query: str) -> None:
        """``/debug/profile?seconds=N&hz=M[&format=speedscope]``:
        sample this process for N seconds (blocking this request
        only — the server is threading) and return collapsed stacks
        (default) or a speedscope JSON document."""
        from disq_tpu_torch.runtime import profiler

        seconds, hz, fmt = 2.0, profiler.DEFAULT_HZ, "collapsed"
        for part in query.split("&"):
            key, _, value = part.partition("=")
            try:
                if key == "seconds":
                    seconds = max(0.05, min(60.0, float(value)))
                elif key == "hz":
                    hz = max(1.0, min(1000.0, float(value)))
            except ValueError:
                pass
            if key == "format":
                fmt = value
        prof = profiler.profile_for(seconds, hz)
        if fmt == "speedscope":
            self._send_json(prof.speedscope())
        else:
            self._send(200, prof.collapsed().encode(),
                       "text/plain; charset=utf-8")


def start_introspect_server(port: int = 0) -> str:
    """Start the in-process endpoint on 127.0.0.1 (``port`` 0 binds an
    ephemeral port); idempotent — returns the bound ``host:port``."""
    global _server, _server_thread, _address
    with _STATE_LOCK:
        if _server is not None:
            return _address  # type: ignore[return-value]
        srv = _NamedThreadingHTTPServer(("127.0.0.1", int(port)),
                                        _Handler)
        srv.daemon_threads = True
        _server = srv
        _address = "127.0.0.1:%d" % srv.server_address[1]
        _server_thread = threading.Thread(
            target=srv.serve_forever, name="disq-introspect", daemon=True)
        _server_thread.start()
        return _address


def stop_introspect_server() -> None:
    global _server, _server_thread, _address
    with _STATE_LOCK:
        srv, thread = _server, _server_thread
        _server = None
        _server_thread = None
        _address = None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if thread is not None:
        thread.join(timeout=5)


def introspect_address() -> Optional[str]:
    """``host:port`` of the live endpoint, or None when disabled."""
    return _address


# ---------------------------------------------------------------------------
# Options plumbing
# ---------------------------------------------------------------------------

_env_resolved = False


def _resolve_env() -> None:
    """Honor ``DISQ_TPU_TORCH_INTROSPECT_PORT`` once per process (an explicit
    ``DisqOptions.introspect_port`` / ``start_introspect_server`` call
    also wins, exactly like the span-log env knob)."""
    global _env_resolved
    if _env_resolved:
        return
    with _STATE_LOCK:
        if _env_resolved:
            return
        _env_resolved = True
        raw = os.environ.get("DISQ_TPU_TORCH_INTROSPECT_PORT")
    if raw is not None and raw != "":
        try:
            port = int(raw)
        except ValueError:
            return
        start_introspect_server(port)


def configure_from_options(opts) -> Optional[PipelineHealth]:
    """Resolve the live-introspection knobs of one ``DisqOptions`` and
    return the health board iff this run should feed it (endpoint or
    progress log live, or a watchdog requested). Returns None on the
    default path — the pipelines then skip every per-shard hook."""
    _resolve_env()
    if opts is not None:
        port = getattr(opts, "introspect_port", None)
        if port is not None and _server is None:
            start_introspect_server(port)
        plog = getattr(opts, "progress_log", None)
        if plog:
            start_progress_log(plog)
        if getattr(opts, "watchdog_stall_s", None):
            return HEALTH
    if _server is not None or _progress_sink is not None:
        return HEALTH
    return None


def reset_introspection() -> None:
    """Test hook: stop the endpoint + progress log, clear the board,
    and allow the env knob to be re-resolved."""
    global _env_resolved
    stop_introspect_server()
    stop_progress_log()
    HEALTH.reset()
    with _STATE_LOCK:
        _env_resolved = False
