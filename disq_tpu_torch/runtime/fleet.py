"""Fleet tier: replicated, cache-locality-routed serving, the
counterpart of ``disq_tpu/runtime/fleet.py``: one coherent service over N
``runtime/serve.py`` replicas, each a daemon on its own card (or CPU).

A fleet of serving daemons is only faster than one if each query lands
on the replica that already holds its blocks. This module is that
routing layer; it is host code and runs no kernel of its own:

- **Locality routing**: every replica advertises a cache digest on its
  endpoint (``GET /serve/cachemap``: ``(path, 64 KiB bucket)`` sets,
  refreshed incrementally through the digest op log). The router
  resolves a query's intervals to BAI/TBI chunks with the index code the
  daemon uses, scores each replica by digest overlap (the shard
  scheduler's block-locality signal, ``scheduler._locality_score``,
  keyed by ``(path, coffset range)``) and forwards to the best. A cold
  query falls back to rendezvous hashing on the path and the region's
  first bucket, so repeats of one region stick to one replica and warm
  it.
- **Cross-replica hedging** (``resilience.HedgeController``): a slow
  primary races a duplicate sent to the runner-up; the first answer
  wins. ``X-Disq-Trace-*`` headers ride both legs.
- **Fleet-wide admission**: the replicas' per-tenant admission stats are
  summed at the router, so a tenant spraying requests across replicas
  meets one fleet-wide 429 ceiling.
- **Epoch invalidation**: ``register`` fans out to every replica, each
  of which bumps the dataset's epoch and drops its stale cache entries;
  the epochs ride ``/serve/cachemap`` so the router sheds stale digests.
- **Keep-alive transport**: a small pool of persistent HTTP/1.1
  connections per replica, Nagle off.

Disabled path: no router, thread, socket or import of this module until
:func:`start_fleet` runs; :func:`fleet_if_running` never creates one, and
:func:`handle_http` answers 503 without allocating. The router owns no
thread: requests run on the endpoint's request threads, and the hedge
pool appears only once a hedge launches.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import random
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from disq_tpu_torch.runtime.flightrec import record_event
from disq_tpu_torch.runtime.serve import (
    DEFAULT_TENANT, DEFAULT_TENANT_QUEUE, DEFAULT_TENANT_SLOTS,
    IndexCache, ServeDaemon, digest_buckets)
from disq_tpu_torch.runtime.tracing import (
    activate_trace, counter, current_trace, deactivate_trace, gauge,
    histogram, inject_trace_headers, mint_trace, record_span, span,
    trace_requests_enabled)

DEFAULT_REFRESH_S = 1.0      # cachemap/stats refresh cadence
DEFAULT_PROBE_S = 2.0        # dead-replica re-probe cadence
DEFAULT_HEDGE_QUANTILE = 0.95
DEFAULT_HEDGE_MIN_S = 0.05
DEFAULT_HEDGE_WORKERS = 16   # both legs of a hedge ride this pool
MAX_IDLE_CONNS = 4

POLICIES = ("locality", "random", "roundrobin")


class ReplicaError(RuntimeError):
    """Transport-level failure talking to one replica (connection
    refused/reset, timeout) — distinct from an HTTP error status,
    which is the replica *answering*. The router maps this to
    "replica lost": mark dead, reroute, re-probe later."""

    def __init__(self, endpoint: str, cause: BaseException) -> None:
        super().__init__(f"replica {endpoint}: "
                         f"{type(cause).__name__}: {cause}")
        self.endpoint = endpoint
        self.cause = cause


class ReplicaClient:
    """Persistent keep-alive HTTP client for one replica.

    Connections are pooled (borrowed exclusively per request, parked
    on return, at most :data:`MAX_IDLE_CONNS` idle) with TCP_NODELAY
    set — hedged requests need two concurrent sockets, and hot-cache
    hits must not pay TCP handshake + slow-start per query. A parked
    connection the replica closed while idle is retried once on a
    fresh one before the failure counts as a :class:`ReplicaError`.
    """

    def __init__(self, endpoint: str, timeout_s: float = 30.0) -> None:
        self.endpoint = endpoint
        host, _, port = endpoint.rpartition(":")
        self._host = host or "127.0.0.1"
        self._port = int(port)
        self._timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._idle: List[http.client.HTTPConnection] = []

    def _connect(self) -> http.client.HTTPConnection:
        conn = http.client.HTTPConnection(
            self._host, self._port, timeout=self._timeout_s)
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn

    def _borrow(self) -> Tuple[http.client.HTTPConnection, bool]:
        with self._lock:
            if self._idle:
                return self._idle.pop(), True
        return self._connect(), False

    def _park(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if len(self._idle) < MAX_IDLE_CONNS:
                self._idle.append(conn)
                return
        conn.close()

    def request(self, method: str, path: str,
                doc: Optional[Dict[str, Any]] = None,
                headers: Optional[Dict[str, str]] = None,
                ) -> Tuple[int, Dict[str, Any]]:
        """One request over a pooled connection -> ``(status, doc)``.
        Raises :class:`ReplicaError` when the replica is unreachable.
        """
        body = json.dumps(doc).encode("utf-8") if doc is not None else None
        hdrs = dict(headers or {})
        if body is not None:
            hdrs.setdefault("Content-Type", "application/json")
        last_exc: Optional[BaseException] = None
        for _attempt in (0, 1):
            try:
                conn, reused = self._borrow()
            except Exception as e:  # noqa: BLE001 — connect failure
                raise ReplicaError(self.endpoint, e)
            try:
                conn.request(method, path, body=body, headers=hdrs)
                resp = conn.getresponse()
                payload = resp.read()  # drain fully so conn is reusable
            except Exception as e:  # noqa: BLE001 — transport failure
                conn.close()
                last_exc = e
                if reused:
                    continue  # stale keep-alive conn: retry fresh once
                raise ReplicaError(self.endpoint, e)
            self._park(conn)
            try:
                out = json.loads(payload) if payload else {}
            except ValueError:
                out = {"raw": payload.decode("utf-8", "replace")}
            if not isinstance(out, dict):
                out = {"value": out}
            return resp.status, out
        raise ReplicaError(self.endpoint, last_exc)  # type: ignore[arg-type]

    def close(self) -> None:
        with self._lock:
            conns, self._idle = self._idle, []
        for conn in conns:
            conn.close()


class _Replica:
    """Router-side view of one serving replica."""

    __slots__ = ("endpoint", "client", "alive", "digest", "seq",
                 "epochs", "stats", "routed")

    def __init__(self, endpoint: str, client: Any) -> None:
        self.endpoint = endpoint
        self.client = client
        self.alive = True
        self.digest: Dict[str, set] = {}   # path -> warm buckets
        self.seq = None                    # last cachemap seq seen
        self.epochs: Dict[str, int] = {}
        self.stats: Dict[str, Any] = {}
        self.routed = 0


class FleetRouter:
    """The routing layer: forwards each ``/query/*`` to the replica
    whose cache already holds the query's blocks, hedging tail
    requests to the runner-up. Owns no threads; liveness and digest
    refresh are lazy (amortized on the query path against the
    injected ``clock``, which tests fake)."""

    def __init__(self, endpoints: List[str], *,
                 policy: str = "locality",
                 hedge_quantile: Optional[float] = DEFAULT_HEDGE_QUANTILE,
                 hedge_min_s: float = DEFAULT_HEDGE_MIN_S,
                 hedge_workers: int = DEFAULT_HEDGE_WORKERS,
                 tenant_slots: int = DEFAULT_TENANT_SLOTS,
                 tenant_queue: int = DEFAULT_TENANT_QUEUE,
                 refresh_s: float = DEFAULT_REFRESH_S,
                 probe_s: float = DEFAULT_PROBE_S,
                 timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 client_factory: Optional[Callable[[str], Any]] = None,
                 ) -> None:
        if not endpoints:
            raise ValueError("fleet needs at least one replica endpoint")
        if policy not in POLICIES:
            raise ValueError(
                f"unknown routing policy {policy!r}; pick from {POLICIES}")
        factory = client_factory or (
            lambda ep: ReplicaClient(ep, timeout_s))
        self.policy = policy
        self._replicas = [_Replica(ep, factory(ep)) for ep in endpoints]
        if hedge_quantile is not None and len(self._replicas) > 1:
            from disq_tpu_torch.runtime.resilience import HedgeController

            self._hedge: Optional[Any] = HedgeController(
                hedge_quantile, hedge_min_s, max_workers=hedge_workers)
        else:
            self._hedge = None
        self._tenant_slots = int(tenant_slots)
        self._tenant_queue = int(tenant_queue)
        self._refresh_s = float(refresh_s)
        self._probe_s = float(probe_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._datasets: Dict[str, Tuple[str, str]] = {}  # name->(path,kind)
        self._indexes = IndexCache()
        self._inflight: Dict[str, int] = {}
        self._last_refresh: Optional[float] = None
        self._last_probe: Optional[float] = None
        self._rr = 0
        self._rng = random.Random(0x5EED)
        gauge("fleet.replicas").observe(len(self._replicas))

    # -- membership: lazy refresh + lazy liveness --------------------------

    def _live(self) -> List[_Replica]:
        return [r for r in self._replicas if r.alive]

    def _mark_dead(self, endpoint: str, reason: str) -> None:
        with self._lock:
            changed = False
            for r in self._replicas:
                if r.endpoint == endpoint and r.alive:
                    r.alive = False
                    r.seq = None      # force a full digest resync on return
                    r.digest.clear()
                    changed = True
            live = len(self._live())
        if changed:
            record_event("fleet.replica_lost", endpoint=endpoint,
                         reason=reason, live=live)
            gauge("fleet.replicas").observe(live)

    def _maybe_refresh(self) -> None:
        """Amortized upkeep on the query path: refresh live replicas'
        digests/stats every ``refresh_s``, re-probe dead ones every
        ``probe_s``. No background thread — a fleet-off process must
        not grow one, and an idle router costs nothing."""
        now = self._clock()
        with self._lock:
            refresh = (self._last_refresh is None
                       or now - self._last_refresh >= self._refresh_s)
            if refresh:
                self._last_refresh = now
            probe = (self._last_probe is None
                     or now - self._last_probe >= self._probe_s)
            if probe:
                self._last_probe = now
        if refresh:
            for r in self._live():
                self._refresh_one(r)
        if probe:
            for r in self._replicas:
                if not r.alive:
                    self._probe_one(r)

    def _refresh_one(self, r: _Replica) -> None:
        qs = f"?since={r.seq}" if r.seq is not None else ""
        try:
            with span("fleet.cachemap", replica=r.endpoint):
                status, doc = r.client.request(
                    "GET", "/serve/cachemap" + qs)
                st_status, st_doc = r.client.request("GET", "/serve/stats")
        except ReplicaError as e:
            self._mark_dead(r.endpoint, str(e.cause))
            return
        with self._lock:
            if status == 200 and "seq" in doc:
                self._apply_cachemap(r, doc)
            else:
                r.seq = None  # replica serve plane down/older: no digest
                r.digest.clear()
            r.stats = st_doc if st_status == 200 else {}

    def _apply_cachemap(self, r: _Replica, doc: Dict[str, Any]) -> None:
        # caller holds self._lock
        epochs = {str(p): int(e)
                  for p, e in (doc.get("epochs") or {}).items()}
        for path, epoch in epochs.items():
            if r.epochs.get(path, epoch) != epoch:
                # dataset re-registered: this replica invalidated its
                # cache, and so must our view of it
                r.digest.pop(path, None)
        r.epochs = epochs
        if "paths" in doc:
            r.digest = {str(p): set(b)
                        for p, b in (doc["paths"] or {}).items()}
        else:
            for op, path, bucket in doc.get("delta") or []:
                if op == "add":
                    r.digest.setdefault(str(path), set()).add(int(bucket))
                else:
                    warm = r.digest.get(str(path))
                    if warm is not None:
                        warm.discard(int(bucket))
                        if not warm:
                            del r.digest[str(path)]
        r.seq = int(doc["seq"])

    def _probe_one(self, r: _Replica) -> None:
        try:
            status, _doc = r.client.request("GET", "/healthz")
        except ReplicaError:
            return
        # answered at all (even 503-degraded) => the process is back,
        # same verdict cluster.probe_liveness gives the scheduler
        with self._lock:
            r.alive = True
            live = len(self._live())
        record_event("fleet.replica_restored", endpoint=r.endpoint,
                     status=status, live=live)
        gauge("fleet.replicas").observe(live)

    # -- the locality signal -----------------------------------------------

    def _resolve(self, doc: Dict[str, Any]
                 ) -> Tuple[str, Optional[List[int]]]:
        """``(path_key, digest buckets)`` of one query — the query's
        BAI/TBI chunks run through the same ``digest_buckets`` math
        the replica caches advertise, so overlap scoring compares
        like with like. Any resolution failure degrades to
        ``buckets=None`` (rendezvous fallback), never an error: the
        replica will produce the authoritative 4xx."""
        from disq_tpu_torch.fsw.filesystem import resolve_path

        name = str(doc.get("dataset") or doc.get("path") or "")
        with self._lock:
            ds = self._datasets.get(name)
        if ds is not None:
            path, kind = ds
        else:
            path, kind = name, None
        try:
            fs, fs_path = resolve_path(path)
        except Exception:  # noqa: BLE001 — fallback routing key
            return name, None
        try:
            from disq_tpu_torch.runtime.serve import _sniff_kind

            kind = kind or _sniff_kind(fs_path)
            intervals = ServeDaemon._parse_intervals(doc)
            chunks: List[Tuple[int, int]] = []
            if kind == "reads":
                from disq_tpu_torch.traversal.bai_query import chunks_for_intervals

                header, _first_vo, bai = self._indexes.get(
                    fs, fs_path, ServeDaemon._build_bam_meta)
                chunks = list(chunks_for_intervals(header, bai, intervals))
            else:
                _header, tbi = self._indexes.get(
                    fs, fs_path, ServeDaemon._build_vcf_meta)
                for iv in intervals:
                    chunks += tbi.chunks_for_interval(
                        iv.contig, iv.start - 1, iv.end)
            buckets = sorted({b for cb, ce in chunks
                              for b in digest_buckets(cb, ce)})
            return fs_path, buckets
        except Exception:  # noqa: BLE001 — fallback routing key
            return fs_path, None

    @staticmethod
    def _rendezvous(key: str, endpoint: str) -> int:
        h = hashlib.md5(f"{key}|{endpoint}".encode("utf-8")).digest()
        return int.from_bytes(h[:8], "big")

    def _rank(self, path_key: str,
              buckets: Optional[List[int]]) -> List[_Replica]:
        """Live replicas, best routing target first."""
        # The tie-break key carries the query's *region* (its first
        # digest bucket), not just the dataset path: rendezvous then
        # spreads distinct cold regions across the fleet — that is
        # what partitions a working set bigger than any one replica's
        # cache — while repeats of one region still stick together.
        tie = (f"{path_key}#{buckets[0]}" if buckets else path_key)
        with self._lock:
            live = self._live()
            if not live:
                return []
            if self.policy == "roundrobin":
                self._rr += 1
                k = self._rr % len(live)
                return live[k:] + live[:k]
            if self.policy == "random":
                order = list(live)
                self._rng.shuffle(order)
                return order
            want = set(buckets or ())
            scored = sorted(
                live,
                key=lambda r: (-len(want & r.digest.get(path_key, set())),
                               -self._rendezvous(tie, r.endpoint)))
            hit = bool(want & scored[0].digest.get(path_key, set()))
        counter("fleet.route").inc(result="hit" if hit else "miss")
        return scored

    # -- fleet-wide admission ----------------------------------------------

    def _admit(self, tenant: str) -> bool:
        """Fleet-wide token check: a tenant's aggregate slots+queue
        usage across every live replica (from their ``/serve/stats``)
        — or the router's own in-flight count, whichever is worse —
        must stay under the fleet's aggregate capacity."""
        with self._lock:
            live = self._live()
            capacity = used = 0
            for r in live:
                adm = (r.stats or {}).get("admission") or {}
                capacity += (int(adm.get("slots",
                                         self._tenant_slots))
                             + int(adm.get("queue_depth",
                                           self._tenant_queue)))
                td = (adm.get("tenants") or {}).get(tenant) or {}
                used += int(td.get("active", 0)) + int(td.get("queued", 0))
            inflight = self._inflight.get(tenant, 0)
        return max(used, inflight) < max(capacity, 1)

    # -- query path --------------------------------------------------------

    def _send(self, r: _Replica, qpath: str, doc: Dict[str, Any],
              headers: Dict[str, str]) -> Tuple[_Replica, int,
                                                Dict[str, Any]]:
        status, body = r.client.request("POST", qpath, doc, headers)
        return r, status, body

    def _book_hedge(self, winner: str, hedged: bool) -> None:
        if hedged:
            counter("fleet.hedge.launched").inc()
            counter("fleet.hedge.won").inc(winner=winner)

    def _dispatch(self, ranked: List[_Replica], qpath: str,
                  doc: Dict[str, Any], headers: Dict[str, str]
                  ) -> Tuple[_Replica, int, Dict[str, Any]]:
        """Send to ``ranked[0]``; when hedging is armed and a runner-up
        exists, a slow primary races a duplicate on the second-best
        replica — region queries are idempotent reads, so first
        response wins and the loser is discarded."""
        targets = ranked[:2]
        if self._hedge is None or len(targets) < 2:
            return self._send(targets[0], qpath, doc, headers)
        state = {"next": 0}
        pick = threading.Lock()

        def attempt() -> Tuple[_Replica, int, Dict[str, Any]]:
            with pick:
                i = min(state["next"], len(targets) - 1)
                state["next"] += 1
            return self._send(targets[i], qpath, doc, headers)

        return self._hedge.call(attempt, on_outcome=self._book_hedge)

    def query(self, qpath: str,
              doc: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """Route one ``/query/*`` request -> ``(status, body)``,
        retrying across survivors when a replica dies mid-request."""
        self._maybe_refresh()
        tenant = str(doc.get("tenant") or DEFAULT_TENANT)
        endpoint = qpath.rsplit("/", 1)[-1]
        t0 = time.perf_counter()
        if not self._admit(tenant):
            counter("fleet.admission").inc(result="shed", tenant=tenant)
            record_event("fleet.shed", tenant=tenant, endpoint=endpoint)
            return 429, {"error": f"fleet admission: tenant {tenant!r} "
                                  "saturates aggregate replica capacity",
                         "tenant": tenant}
        counter("fleet.admission").inc(result="admit", tenant=tenant)
        # The router is the fleet's serving edge: adopt the client's
        # context or mint the root here, and capture the outbound
        # headers ONCE — contextvars do not follow the hedge pool's
        # threads, the header dict does.
        ctx = current_trace()
        token = None
        if ctx is None and trace_requests_enabled():
            ctx = mint_trace(tenant)
            token = activate_trace(ctx)
        with self._lock:
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
        status = 503
        try:
            headers = inject_trace_headers({})
            path_key, buckets = self._resolve(doc)
            last_error = "no live replicas"
            for _attempt in range(len(self._replicas)):
                ranked = self._rank(path_key, buckets)
                if not ranked:
                    break
                try:
                    replica, status, body = self._dispatch(
                        ranked, qpath, doc, headers)
                except ReplicaError as e:
                    self._mark_dead(e.endpoint, str(e.cause))
                    last_error = str(e)
                    continue
                with self._lock:
                    replica.routed += 1
                counter("fleet.routed").inc(endpoint=endpoint,
                                            replica=replica.endpoint)
                return status, body
            status = 503
            return 503, {"error": f"fleet: {last_error}"}
        finally:
            with self._lock:
                self._inflight[tenant] = max(
                    0, self._inflight.get(tenant, 0) - 1)
            dur = time.perf_counter() - t0
            histogram("fleet.request").observe(
                dur, endpoint=endpoint, tenant=tenant)
            if ctx is not None:
                # the stitched waterfall's root on the router hop
                record_span("fleet.request.trace", dur,
                            endpoint=endpoint, tenant=tenant,
                            status=status)
            if token is not None:
                deactivate_trace(token)

    # -- registry fan-out --------------------------------------------------

    def register(self, name: str, path: str,
                 kind: Optional[str] = None) -> Tuple[int, Dict[str, Any]]:
        """Fan a dataset registration out to every live replica. Each
        replica bumps the dataset's epoch and invalidates its stale
        cache entries; the router drops its own digest view so the
        next refresh resyncs."""
        self._maybe_refresh()
        headers = inject_trace_headers({})
        body = {"name": name, "path": path}
        if kind:
            body["kind"] = kind
        per_replica: Dict[str, Any] = {}
        epoch = 0
        ok = 0
        for r in self._live():
            try:
                status, doc = r.client.request(
                    "POST", "/serve/register", body, headers)
            except ReplicaError as e:
                self._mark_dead(r.endpoint, str(e.cause))
                per_replica[r.endpoint] = {"error": str(e)}
                continue
            per_replica[r.endpoint] = doc
            if status == 200:
                ok += 1
                epoch = max(epoch, int(doc.get("epoch", 1)))
            else:
                return status, {"error": doc.get("error",
                                                 f"HTTP {status}"),
                                "endpoint": r.endpoint}
        if ok == 0:
            return 503, {"error": "fleet: no live replicas to register on",
                         "replicas": per_replica}
        resolved_kind = str(
            next(iter(per_replica.values())).get("kind") or kind or "")
        try:
            from disq_tpu_torch.fsw.filesystem import resolve_path

            _fs, fs_path = resolve_path(path)
        except Exception:  # noqa: BLE001 — digest key best-effort
            fs_path = path
        with self._lock:
            self._datasets[name] = (path, resolved_kind)
            for r in self._replicas:
                # stale digests die with the old epoch; the next
                # cachemap refresh rebuilds the warm view
                r.digest.pop(fs_path, None)
        record_event("fleet.register", name=name, epoch=epoch,
                     replicas=ok)
        return 200, {"name": name, "path": path, "kind": resolved_kind,
                     "epoch": epoch, "replicas": per_replica}

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        lat = histogram("fleet.request")
        with self._lock:
            replicas = [
                {"endpoint": r.endpoint, "alive": r.alive,
                 "routed": r.routed, "digest_seq": r.seq,
                 "digest_paths": len(r.digest),
                 "digest_buckets": sum(len(b) for b in r.digest.values())}
                for r in self._replicas
            ]
            datasets = {n: {"path": p, "kind": k}
                        for n, (p, k) in sorted(self._datasets.items())}
            inflight = {t: n for t, n in sorted(self._inflight.items())
                        if n > 0}
        return {
            "policy": self.policy,
            "hedge": self._hedge is not None,
            "replicas": replicas,
            "live": sum(1 for r in replicas if r["alive"]),
            "datasets": datasets,
            "inflight": inflight,
            "latency": {
                "p50_ms": lat.percentile(50) * 1e3,
                "p99_ms": lat.percentile(99) * 1e3,
            },
        }

    def handle(self, method: str, path: str,
               doc: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        if method == "GET" and path == "/fleet/stats":
            return 200, self.stats()
        if method != "POST":
            return 405, {"error": f"{path} expects POST"}
        if path == "/fleet/register":
            name = str(doc.get("name") or doc.get("path") or "")
            if not doc.get("path"):
                return 400, {"error": "register needs 'path'"}
            return self.register(name, str(doc["path"]), doc.get("kind"))
        if path.startswith("/fleet/query/"):
            return self.query(path[len("/fleet"):], doc)
        return 404, {"error": f"unknown fleet path {path}",
                     "endpoints": ["/fleet/query/reads",
                                   "/fleet/query/variants",
                                   "/fleet/query/stats",
                                   "/fleet/register", "/fleet/stats"]}

    def close(self) -> None:
        if self._hedge is not None:
            self._hedge.close()
        for r in self._replicas:
            try:
                r.client.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass


# -- module-level router lifecycle ------------------------------------------

_LOCK = threading.RLock()
_ROUTER: Optional[FleetRouter] = None


def fleet_if_running() -> Optional[FleetRouter]:
    """The live router, or None. Never creates one."""
    return _ROUTER


def start_fleet(endpoints: List[str], port: int = 0,
                **router_kwargs: Any) -> str:
    """Create the router (idempotent) and return the ``host:port`` of
    the introspection HTTP server now also answering ``/fleet/*``."""
    global _ROUTER
    with _LOCK:
        if _ROUTER is None:
            _ROUTER = FleetRouter(list(endpoints), **router_kwargs)
    from disq_tpu_torch.runtime.introspect import start_introspect_server

    return start_introspect_server(port)


def stop_fleet() -> None:
    """Drop the router (connections, hedge pool, digest state). The
    introspection server is shared — its starter stops it."""
    global _ROUTER
    with _LOCK:
        router, _ROUTER = _ROUTER, None
    if router is not None:
        router.close()


def handle_http(method: str, path: str,
                doc: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
    """Route one fleet-plane request; 503 (allocating nothing) when no
    router is running."""
    router = _ROUTER
    if router is None:
        return 503, {
            "error": "fleet tier not started — call "
                     "disq_tpu_torch.api.serve_fleet() or "
                     "scripts/torch_serve.py --fleet"}
    return router.handle(method, path, doc)
