"""Cross-host metric aggregation: N processes' introspection joined.

Counterpart of ``disq_tpu/runtime/cluster.py``. A multi-process run
leaves N ``runtime/introspect.py`` endpoints; a :class:`ClusterAggregator`
scrapes every worker's ``/metrics``, ``/progress`` and ``/healthz``,
merges them, and serves (or returns) the cluster view:

- **Metrics.** Each worker's exposition is re-emitted with a
  ``process="<id>"`` label on every series (the id comes from the
  ``disq_tpu_process_info`` series each endpoint exposes, from
  ``multihost.process_id()``), plus one rollup series per metric without
  the label whose value is the sum over processes.
- **Progress.** Per-direction shard, record and byte totals and rolling
  rates summed over workers, the ETA recomputed from them, the
  per-process views kept under ``"processes"``.
- **Health.** ``ok`` only when every worker is reachable and ``ok``; a
  degraded or unreachable worker degrades the verdict and is named.

Stdlib only (``urllib`` and ``http.server``), testable on the CPU
against subprocess workers' ephemeral endpoints. The scrape books the
``cluster.scrape`` span (labeled with the endpoint),
``cluster.scrape_errors`` and the ``cluster.processes`` gauge. The
series names and the exposition prefix are the reference's, so one
aggregator reads workers of either package.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.error
import urllib.request
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple

from disq_tpu_torch.runtime.tracing import REGISTRY, inject_trace_headers, span

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})?\s+(\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

PROCESS_INFO_SERIES = "disq_tpu_process_info"


def parse_metrics_text(text: str) -> Tuple[
        Dict[str, str], List[Tuple[str, Tuple[Tuple[str, str], ...], float]]]:
    """Parse a Prometheus text exposition into
    ``({series_base_name: kind}, [(sample_name, labels, value), ...])``.

    Handles exactly the exposition this framework emits (``# TYPE``
    comments + plain samples; histogram samples appear as
    ``name_bucket`` / ``name_sum`` / ``name_count`` under a ``# TYPE
    name histogram``)."""
    kinds: Dict[str, str] = {}
    samples: List[Tuple[str, Tuple[Tuple[str, str], ...], float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                kinds[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, _, raw_labels, raw_value = m.groups()
        try:
            value = float(raw_value)
        except ValueError:
            continue
        labels = tuple(
            (k, v.replace('\\"', '"').replace("\\\\", "\\"))
            for k, v in _LABEL_RE.findall(raw_labels or ""))
        samples.append((name, labels, value))
    return kinds, samples


def _kind_of(sample_name: str, kinds: Dict[str, str]) -> str:
    """The TYPE of one sample series, resolving histogram suffixes."""
    if sample_name in kinds:
        return kinds[sample_name]
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            if kinds.get(base) == "histogram":
                return "histogram"
    return "untyped"


def probe_liveness(endpoints: Sequence[str],
                   timeout_s: float = 1.0) -> Dict[str, bool]:
    """One-shot reachability probe of introspection endpoints — the
    scheduler failover election's view of "live" (``scheduler.py``
    standby election picks the lowest live member).  Hits ``/healthz``
    with a short timeout; a 503 (degraded) still counts as *alive* —
    election needs "is the process up", not "is it healthy"."""
    alive: Dict[str, bool] = {}
    for endpoint in endpoints:
        base = endpoint if "://" in endpoint else "http://" + endpoint
        try:
            with urllib.request.urlopen(base + "/healthz",
                                        timeout=timeout_s):
                alive[endpoint] = True
        except urllib.error.HTTPError:
            alive[endpoint] = True  # answered — the process is up
        except Exception:  # noqa: BLE001 — reachability verdict
            alive[endpoint] = False
    return alive


class WorkerState:
    """One scraped worker: reachability, identity, parsed payloads."""

    def __init__(self, endpoint: str) -> None:
        self.endpoint = endpoint          # "host:port"
        self.ok = False
        self.error: Optional[str] = None
        self.process_id: Optional[int] = None
        self.run_id: Optional[str] = None
        self.kinds: Dict[str, str] = {}
        self.samples: List[Tuple[str, Tuple[Tuple[str, str], ...],
                                 float]] = []
        self.progress: Dict[str, Any] = {}
        self.healthz: Dict[str, Any] = {}
        self.slo: Dict[str, Any] = {}
        self.serve_stats: Dict[str, Any] = {}


class ClusterAggregator:
    """Scrape N introspection endpoints and merge (see module doc).

    ``endpoints`` are ``host:port`` strings (scheme optional).
    ``scrape()`` refreshes every worker synchronously and returns the
    worker list; the ``metrics_text`` / ``progress`` / ``healthz``
    views render the most recent scrape.  ``serve(port)`` starts an
    HTTP server exposing the same three paths, scraping on demand
    (throttled to at most one scrape per ``min_scrape_interval_s``).
    """

    def __init__(self, endpoints: Sequence[str], timeout_s: float = 5.0,
                 min_scrape_interval_s: float = 0.2) -> None:
        if not endpoints:
            raise ValueError("at least one worker endpoint required")
        self.endpoints = [e.strip() for e in endpoints if e.strip()]
        self.timeout_s = timeout_s
        self.min_scrape_interval_s = min_scrape_interval_s
        self._lock = threading.Lock()
        self._workers: List[WorkerState] = [
            WorkerState(e) for e in self.endpoints]
        self._last_scrape = 0.0
        self._server: Optional[ThreadingHTTPServer] = None
        self._server_thread: Optional[threading.Thread] = None
        self._address: Optional[str] = None

    # -- scraping -----------------------------------------------------------

    def _get(self, endpoint: str, path: str,
             timeout_s: Optional[float] = None) -> bytes:
        base = endpoint
        if "://" not in base:
            base = "http://" + base
        req = urllib.request.Request(
            base + path, headers=inject_trace_headers({}))
        with urllib.request.urlopen(
                req,
                timeout=self.timeout_s if timeout_s is None
                else timeout_s) as resp:
            return resp.read()

    def _scrape_one(self, worker: WorkerState) -> None:
        with span("cluster.scrape", endpoint=worker.endpoint):
            try:
                metrics_raw = self._get(worker.endpoint,
                                        "/metrics").decode()
                progress_raw = self._get(worker.endpoint, "/progress")
                try:
                    healthz_raw = self._get(worker.endpoint, "/healthz")
                except urllib.error.HTTPError as e:
                    # /healthz answers 503 when degraded — that IS the
                    # payload, not a scrape failure.
                    healthz_raw = e.read()
            except Exception as e:  # noqa: BLE001 — reachability verdict
                worker.ok = False
                worker.error = f"{type(e).__name__}: {e}"
                REGISTRY.counter("cluster.scrape_errors").inc(
                    endpoint=worker.endpoint)
                return
            # /slo is newer than /metrics — a worker without the route
            # (or with SLOs unconfigured) must still scrape clean.
            try:
                slo_raw = self._get(worker.endpoint, "/slo")
            except Exception:  # noqa: BLE001 — optional endpoint
                slo_raw = b"{}"
            # /serve/stats likewise: older replicas 404 it and
            # non-serving workers answer 503 — both scrape clean.
            try:
                serve_raw = self._get(worker.endpoint, "/serve/stats")
            except Exception:  # noqa: BLE001 — optional endpoint
                serve_raw = b"{}"
        worker.kinds, worker.samples = parse_metrics_text(metrics_raw)
        try:
            worker.slo = json.loads(slo_raw)
            if not isinstance(worker.slo, dict):
                worker.slo = {}
        except ValueError:
            worker.slo = {}
        try:
            worker.serve_stats = json.loads(serve_raw)
            if not isinstance(worker.serve_stats, dict):
                worker.serve_stats = {}
        except ValueError:
            worker.serve_stats = {}
        try:
            worker.progress = json.loads(progress_raw)
        except ValueError:
            worker.progress = {}
        try:
            worker.healthz = json.loads(healthz_raw)
        except ValueError:
            worker.healthz = {}
        worker.process_id = self._identity(worker)
        worker.run_id = worker.progress.get("run_id") \
            or worker.healthz.get("run_id")
        worker.ok = True
        worker.error = None

    @staticmethod
    def _identity(worker: WorkerState) -> int:
        """Worker process id: the process_info series first, then the
        JSON endpoints, then the scrape-list position."""
        for name, labels, _value in worker.samples:
            if name == PROCESS_INFO_SERIES:
                for k, v in labels:
                    if k == "process_id":
                        try:
                            return int(v)
                        except ValueError:
                            break
        for doc in (worker.progress, worker.healthz):
            pid = doc.get("process_id")
            if isinstance(pid, int):
                return pid
        return -1

    def scrape(self) -> List[WorkerState]:
        """Refresh every worker (concurrently — a dead worker's timeout
        must not serialize the healthy ones) and return the states."""
        with self._lock:
            workers = [WorkerState(e) for e in self.endpoints]
            threads = [
                threading.Thread(target=self._scrape_one, args=(w,),
                                 name=f"disq-cluster-scrape-{i}",
                                 daemon=True)
                for i, w in enumerate(workers)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            # Every worker ends up with a UNIQUE id: a reported id is
            # kept first-come; duplicates (N workers all reporting
            # jax.process_index()==0), missing ids and unreachable
            # workers fall back to unused integers — otherwise two
            # same-id workers would overwrite each other's process-
            # labeled series and break the rollup-equals-sum contract.
            taken = set()
            for w in workers:
                if (w.ok and isinstance(w.process_id, int)
                        and w.process_id >= 0
                        and w.process_id not in taken):
                    taken.add(w.process_id)
                else:
                    w.process_id = None
            next_free = 0
            for w in workers:
                if w.process_id is None:
                    while next_free in taken:
                        next_free += 1
                    w.process_id = next_free
                    taken.add(next_free)
            self._workers = workers
            self._last_scrape = time.perf_counter()
            REGISTRY.gauge("cluster.processes").observe(
                sum(1 for w in workers if w.ok))
            return workers

    def _fresh(self) -> List[WorkerState]:
        with self._lock:
            age = time.perf_counter() - self._last_scrape
            if self._last_scrape and age < self.min_scrape_interval_s:
                return self._workers
        return self.scrape()

    # -- merged views -------------------------------------------------------

    def metrics_text(self, workers: Optional[List[WorkerState]] = None
                     ) -> str:
        """Merged Prometheus exposition: every worker series re-labeled
        ``process="<id>"`` plus, for each (name, labels) series, one
        rollup sample WITHOUT the process label holding the sum across
        processes."""
        if workers is None:
            workers = self._fresh()
        kinds: Dict[str, str] = {}
        # sample name -> labelset(with process) -> value, and rollups
        per_process: Dict[str, Dict[Tuple[Tuple[str, str], ...],
                                    float]] = defaultdict(dict)
        rollup: Dict[str, Dict[Tuple[Tuple[str, str], ...],
                               float]] = defaultdict(lambda:
                                                     defaultdict(float))
        for w in workers:
            if not w.ok:
                continue
            kinds.update(w.kinds)
            for name, labels, value in w.samples:
                if name == PROCESS_INFO_SERIES:
                    continue
                labeled = tuple(sorted(
                    labels + (("process", str(w.process_id)),)))
                per_process[name][labeled] = value
                rollup[name][labels] += value

        def fmt(labels: Tuple[Tuple[str, str], ...]) -> str:
            if not labels:
                return ""
            body = ",".join(
                '%s="%s"' % (k, v.replace("\\", "\\\\").replace(
                    '"', '\\"')) for k, v in labels)
            return "{" + body + "}"

        def fmt_val(v: float) -> str:
            return repr(round(v, 9)) if v != int(v) else str(int(v))

        lines: List[str] = [
            "# TYPE disq_tpu_cluster_workers gauge",
            "disq_tpu_cluster_workers{state=\"ok\"} %d"
            % sum(1 for w in workers if w.ok),
            "disq_tpu_cluster_workers{state=\"unreachable\"} %d"
            % sum(1 for w in workers if not w.ok),
        ]
        typed_done = set()
        for name in sorted(per_process):
            base_kind = _kind_of(name, kinds)
            type_name = name
            for suffix in ("_bucket", "_sum", "_count"):
                if (base_kind == "histogram"
                        and name.endswith(suffix)):
                    type_name = name[: -len(suffix)]
            if type_name not in typed_done and base_kind != "untyped":
                lines.append(f"# TYPE {type_name} {base_kind}")
                typed_done.add(type_name)
            for labels in sorted(rollup[name]):
                lines.append(
                    f"{name}{fmt(labels)} "
                    f"{fmt_val(rollup[name][labels])}")
            for labels in sorted(per_process[name]):
                lines.append(
                    f"{name}{fmt(labels)} "
                    f"{fmt_val(per_process[name][labels])}")
        return "\n".join(lines) + "\n"

    def progress(self, workers: Optional[List[WorkerState]] = None
                 ) -> Dict[str, Any]:
        """Cluster progress: per-direction totals summed across
        workers, rates summed, ETA recomputed from cluster
        remaining/rate; per-process views preserved."""
        if workers is None:
            workers = self._fresh()
        directions: Dict[str, Dict[str, Any]] = {}
        processes: Dict[str, Any] = {}
        for w in workers:
            key = str(w.process_id if w.process_id is not None else -1)
            if not w.ok:
                processes[key] = {"endpoint": w.endpoint,
                                  "ok": False, "error": w.error}
                continue
            processes[key] = {"endpoint": w.endpoint, "ok": True,
                              "run_id": w.run_id,
                              "directions": w.progress.get(
                                  "directions", {})}
            for direction, view in (w.progress.get("directions")
                                    or {}).items():
                agg = directions.setdefault(direction, {
                    "active": False, "shards_total": 0, "shards_done": 0,
                    "in_flight": 0, "records": 0, "bytes_compressed": 0,
                    "bytes_uncompressed": 0, "records_per_sec": 0.0,
                    "shards_per_sec": 0.0, "elapsed_s": 0.0,
                    "eta_s": None,
                })
                agg["active"] = agg["active"] or bool(view.get("active"))
                for k in ("shards_total", "shards_done", "in_flight",
                          "records", "bytes_compressed",
                          "bytes_uncompressed"):
                    agg[k] += int(view.get(k) or 0)
                for k in ("records_per_sec", "shards_per_sec"):
                    agg[k] = round(agg[k] + float(view.get(k) or 0.0), 3)
                agg["elapsed_s"] = max(agg["elapsed_s"],
                                       float(view.get("elapsed_s")
                                             or 0.0))
        for view in directions.values():
            remaining = max(0, view["shards_total"] - view["shards_done"])
            rate = view["shards_per_sec"]
            if not remaining:
                view["eta_s"] = 0.0
            elif view["active"] and rate > 0:
                view["eta_s"] = round(remaining / rate, 3)
        return {
            "cluster": True,
            "workers_ok": sum(1 for w in workers if w.ok),
            "workers_total": len(workers),
            "directions": directions,
            "processes": processes,
        }

    def healthz(self, workers: Optional[List[WorkerState]] = None
                ) -> Dict[str, Any]:
        """Cluster liveness: ok only when every worker is reachable and
        itself ok; degraded/unreachable workers are named."""
        if workers is None:
            workers = self._fresh()
        problems = []
        for w in workers:
            if not w.ok:
                problems.append({"endpoint": w.endpoint,
                                 "process_id": w.process_id,
                                 "status": "unreachable",
                                 "error": w.error})
            elif w.healthz.get("status") not in (None, "ok"):
                problems.append({"endpoint": w.endpoint,
                                 "process_id": w.process_id,
                                 "status": w.healthz.get("status"),
                                 "stalls": w.healthz.get("stalls", [])})
        return {
            "status": "ok" if not problems else "degraded",
            "cluster": True,
            "workers_ok": sum(1 for w in workers if w.ok),
            "workers_total": len(workers),
            "problems": problems,
        }

    def slo(self, workers: Optional[List[WorkerState]] = None
            ) -> Dict[str, Any]:
        """Fleet SLO verdict: per-tenant worst burn across workers
        (max — one hot replica pages, it does not average away), the
        union of fast-burn tenants, per-process docs preserved."""
        if workers is None:
            workers = self._fresh()
        tenants: Dict[str, Dict[str, Any]] = {}
        processes: Dict[str, Any] = {}
        enabled = False
        for w in workers:
            key = str(w.process_id if w.process_id is not None else -1)
            if not w.ok:
                processes[key] = {"endpoint": w.endpoint, "ok": False,
                                  "error": w.error}
                continue
            doc = w.slo or {}
            processes[key] = {"endpoint": w.endpoint, "ok": True,
                              "slo": doc}
            if not doc.get("enabled"):
                continue
            enabled = True
            for tenant, tdoc in (doc.get("tenants") or {}).items():
                agg = tenants.setdefault(str(tenant), {
                    "worst_burn": 0.0, "fast_burn": False,
                    "processes": [],
                })
                worst = 0.0
                for wdoc in (tdoc.get("windows") or {}).values():
                    worst = max(worst,
                                float(wdoc.get("burn") or 0.0),
                                float(wdoc.get("availability_burn")
                                      or 0.0))
                agg["worst_burn"] = round(
                    max(agg["worst_burn"], worst), 4)
                if tdoc.get("fast_burn"):
                    agg["fast_burn"] = True
                agg["processes"].append(key)
        return {
            "cluster": True,
            "enabled": enabled,
            "workers_ok": sum(1 for w in workers if w.ok),
            "workers_total": len(workers),
            "fast_burn_tenants": sorted(
                t for t, d in tenants.items() if d["fast_burn"]),
            "tenants": tenants,
            "processes": processes,
        }

    def serve_stats(self, workers: Optional[List[WorkerState]] = None
                    ) -> Dict[str, Any]:
        """Fleet-wide serving-plane view: per-tenant admission usage
        summed across replicas (active/queued add — they are fleet
        capacity consumption), head-of-line blocking as the max
        ``oldest_wait_s`` (one stuck replica pages), aggregate
        slots/queue as the fleet's admission ceiling, per-process docs
        preserved under ``process=`` keys. Workers whose ``/serve/stats``
        404d or 503d (older build, serving off) contribute nothing but
        do not poison the merge — same tolerance as the ``/slo`` view.
        """
        if workers is None:
            workers = self._fresh()
        tenants: Dict[str, Dict[str, Any]] = {}
        processes: Dict[str, Any] = {}
        slots = queue_depth = serving = 0
        for w in workers:
            key = str(w.process_id if w.process_id is not None else -1)
            if not w.ok:
                processes[key] = {"endpoint": w.endpoint, "ok": False,
                                  "error": w.error}
                continue
            doc = w.serve_stats or {}
            processes[key] = {"endpoint": w.endpoint, "ok": True,
                              "serve": doc}
            adm = doc.get("admission") or {}
            if not adm:
                continue
            serving += 1
            slots += int(adm.get("slots") or 0)
            queue_depth += int(adm.get("queue_depth") or 0)
            for tenant, tdoc in (adm.get("tenants") or {}).items():
                agg = tenants.setdefault(str(tenant), {
                    "active": 0, "queued": 0, "oldest_wait_s": 0.0,
                    "processes": [],
                })
                agg["active"] += int(tdoc.get("active") or 0)
                agg["queued"] += int(tdoc.get("queued") or 0)
                agg["oldest_wait_s"] = round(
                    max(agg["oldest_wait_s"],
                        float(tdoc.get("oldest_wait_s") or 0.0)), 6)
                agg["processes"].append(key)
        return {
            "cluster": True,
            "serving": serving,
            "workers_ok": sum(1 for w in workers if w.ok),
            "workers_total": len(workers),
            "slots": slots,
            "queue_depth": queue_depth,
            "tenants": tenants,
            "processes": processes,
        }

    # -- fleet debug collection ---------------------------------------------

    def _collect_debug(self, path: str,
                       workers: Optional[List[WorkerState]] = None,
                       extra_timeout_s: float = 0.0
                       ) -> Dict[int, Dict[str, Any]]:
        """Fetch one ``/debug/*`` path from every reachable worker
        concurrently; ``{process_id: {"endpoint", "ok", "body"|"error"}}``.
        Debug fetches are deliberately scrape-independent: a wedged
        worker that no longer answers ``/metrics`` may still answer
        ``/debug/stacks`` (the whole point of collecting stacks).
        ``extra_timeout_s`` stretches the per-fetch timeout for paths
        that legitimately block (a ``/debug/profile`` holds its
        response for the whole sampling window)."""
        if workers is None:
            workers = self._fresh()
        out: Dict[int, Dict[str, Any]] = {}
        lock = threading.Lock()
        timeout_s = self.timeout_s + extra_timeout_s

        def fetch(worker: WorkerState, idx: int) -> None:
            # scrape() guarantees unique ids, but externally-built
            # WorkerStates may carry None — fall back to a unique
            # negative slot so two unidentified workers never clobber
            # each other's debug output.
            pid = (worker.process_id if worker.process_id is not None
                   else -(idx + 1))
            try:
                body = self._get(worker.endpoint, path,
                                 timeout_s=timeout_s).decode()
                doc = {"endpoint": worker.endpoint, "ok": True,
                       "body": body}
            except Exception as e:  # noqa: BLE001 — reachability verdict
                doc = {"endpoint": worker.endpoint, "ok": False,
                       "error": f"{type(e).__name__}: {e}"}
            with lock:
                out[pid] = doc

        threads = [
            threading.Thread(target=fetch, args=(w, i),
                             name=f"disq-cluster-debug-{i}", daemon=True)
            for i, w in enumerate(workers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out

    def debug_stacks(self, workers: Optional[List[WorkerState]] = None
                     ) -> Dict[str, Any]:
        """Every worker's all-thread stack dump, keyed by process id —
        the cluster answer to "what is each process doing right now"."""
        collected = self._collect_debug("/debug/stacks", workers)
        return {
            "cluster": True,
            "processes": {
                str(pid): doc for pid, doc in sorted(collected.items())
            },
        }

    def debug_profile(self, seconds: float = 2.0,
                      workers: Optional[List[WorkerState]] = None) -> str:
        """Sample every worker for ``seconds`` concurrently and merge
        the collapsed stacks into one document, each stack rooted at a
        ``process=<id>`` frame — one flamegraph for the whole fleet,
        split by process then thread role."""
        seconds = max(0.05, min(60.0, float(seconds)))
        collected = self._collect_debug(
            "/debug/profile?seconds=%g" % seconds, workers,
            extra_timeout_s=seconds)
        lines: List[str] = []
        for pid, doc in sorted(collected.items()):
            if not doc.get("ok"):
                continue
            for line in doc["body"].splitlines():
                if line.strip():
                    lines.append(f"process={pid};{line}")
        return "\n".join(lines) + ("\n" if lines else "")

    # -- serving ------------------------------------------------------------

    def serve(self, port: int = 0) -> str:
        """Serve the merged ``/metrics`` / ``/progress`` / ``/healthz``
        on 127.0.0.1 (``port`` 0 = ephemeral); each request scrapes on
        demand (throttled).  Returns the bound ``host:port``."""
        if self._server is not None:
            return self._address  # type: ignore[return-value]
        aggregator = self

        class _Handler(BaseHTTPRequestHandler):
            server_version = "disq-tpu-cluster/1"

            def log_message(self, *args: Any) -> None:
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802
                path, _, query = self.path.partition("?")
                workers = aggregator._fresh()
                if path == "/metrics":
                    self._send(
                        200, aggregator.metrics_text(workers).encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/progress":
                    self._send(
                        200,
                        json.dumps(aggregator.progress(workers),
                                   default=str).encode(),
                        "application/json")
                elif path == "/healthz":
                    doc = aggregator.healthz(workers)
                    self._send(
                        200 if doc["status"] == "ok" else 503,
                        json.dumps(doc, default=str).encode(),
                        "application/json")
                elif path == "/slo":
                    self._send(
                        200,
                        json.dumps(aggregator.slo(workers),
                                   default=str).encode(),
                        "application/json")
                elif path == "/serve/stats":
                    self._send(
                        200,
                        json.dumps(aggregator.serve_stats(workers),
                                   default=str).encode(),
                        "application/json")
                elif path == "/debug/stacks":
                    self._send(
                        200,
                        json.dumps(aggregator.debug_stacks(workers),
                                   default=str).encode(),
                        "application/json")
                elif path == "/debug/profile":
                    seconds = 2.0
                    for part in query.split("&"):
                        if part.startswith("seconds="):
                            try:
                                seconds = float(part[len("seconds="):])
                            except ValueError:
                                pass
                    self._send(
                        200,
                        aggregator.debug_profile(seconds,
                                                 workers).encode(),
                        "text/plain; charset=utf-8")
                else:
                    self._send(404, json.dumps({
                        "error": "unknown path",
                        "endpoints": ["/metrics", "/progress",
                                      "/healthz", "/slo",
                                      "/debug/stacks",
                                      "/debug/profile"]}).encode(),
                        "application/json")

        class _NamedServer(ThreadingHTTPServer):
            # named request threads: profiler/py-spy attribution
            def process_request_thread(self, request, client_address):
                threading.current_thread().name = "disq-cluster-req"
                super().process_request_thread(request, client_address)

        srv = _NamedServer(("127.0.0.1", int(port)), _Handler)
        srv.daemon_threads = True
        self._server = srv
        self._address = "127.0.0.1:%d" % srv.server_address[1]
        self._server_thread = threading.Thread(
            target=srv.serve_forever, name="disq-cluster", daemon=True)
        self._server_thread.start()
        return self._address

    def close(self) -> None:
        srv, thread = self._server, self._server_thread
        self._server = None
        self._server_thread = None
        self._address = None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if thread is not None:
            thread.join(timeout=5)

    @property
    def address(self) -> Optional[str]:
        return self._address
