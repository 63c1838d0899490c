"""The port's fleet router (``disq_tpu_torch/runtime/fleet.py``) and the
serve-side cache digest it routes on, on the CPU:

- the reference's cases (``tests/test_fleet.py``) on the port: digest
  bookkeeping through put, evict and invalidate, the incremental
  ``/serve/cachemap``, locality ranking and rendezvous stickiness on an
  injected clock and scripted replica clients, hedge accounting,
  fleet-wide admission, epoch invalidation and replica loss;
- parity: the reference's ``FleetRouter`` and the port's, fed the same
  scripted replicas and digests, rank the replicas alike, pick the same
  rendezvous winner for each of the 64 regions of the reference's serving
  workload (``bench.py`` config 13), and admit and shed alike;
- the request-trace helpers against the reference's.

The fleet of replica processes on the card is checked by
``chip_smoke.py``'s serve phase, not here.
"""

import random
import threading

import pytest

from disq_tpu.runtime import fleet as ref_fleet
from disq_tpu.runtime import tracing as ref_tracing

from disq_tpu_torch.runtime import tracing
from disq_tpu_torch.runtime.fleet import FleetRouter, ReplicaError, handle_http
from disq_tpu_torch.runtime.serve import (
    DIGEST_BUCKET_BITS,
    HotBlockCache,
    digest_buckets,
)
from disq_tpu_torch.runtime.tracing import (
    activate_trace,
    counter,
    deactivate_trace,
    gauge,
    mint_trace,
    reset_telemetry,
)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    reset_telemetry()
    ref_tracing.reset_telemetry()
    yield
    reset_telemetry()
    ref_tracing.reset_telemetry()


# -- serve-side cache digest ------------------------------------------------


def _mk_cache(**caps):
    kw = {"compressed_bytes": 1 << 20, "decoded_bytes": 1 << 20,
          "parsed_bytes": 1 << 20}
    kw.update(caps)
    return HotBlockCache(**kw)


class TestCacheDigest:
    def test_digest_buckets_share_the_scheduler_math(self):
        """Virtual-offset chunks and cached coffsets must land in the
        same buckets, or router overlap scores compare unlike units."""
        cb = 65_536 << 16          # coffset 64 KiB -> bucket 1
        ce = 200_000 << 16         # coffset ~195 KiB -> bucket 3
        assert digest_buckets(cb, ce) == (1, 2, 3)
        # an intra-block chunk (ce's coffset == cb's) is one bucket
        assert digest_buckets(cb, cb | 0x1FF) == (1,)
        # the int-coffset form the cache books on put()
        assert (65_536 >> DIGEST_BUCKET_BITS) == 1

    def test_put_journals_digest_and_cachemap_reports_it(self):
        cache = _mk_cache()
        cache.put("compressed", "p.bam", 0, b"x", 8, "t")
        cache.put("decoded", "p.bam", 70_000, b"y", 8, "t")
        doc = cache.cachemap()
        assert doc["bucket_bits"] == DIGEST_BUCKET_BITS
        assert doc["paths"] == {"p.bam": [0, 1]}
        assert doc["seq"] == 2

    def test_cachemap_incremental_delta(self):
        cache = _mk_cache()
        cache.put("compressed", "p.bam", 0, b"x", 8, "t")
        s0 = cache.cachemap()["seq"]
        assert cache.cachemap(since=s0)["delta"] == []
        cache.put("compressed", "p.bam", 70_000, b"y", 8, "t")
        delta = cache.cachemap(since=s0)
        assert delta["delta"] == [["add", "p.bam", 1]]
        # a refcounted re-add of a warm bucket journals nothing
        cache.put("parsed", "p.bam", 70_001, b"z", 8, "t")
        assert cache.cachemap(since=delta["seq"])["delta"] == []

    def test_eviction_journals_digest_del(self):
        cache = _mk_cache(compressed_bytes=16)
        cache.put("compressed", "p.bam", 0, b"x", 10, "t")
        s0 = cache.cachemap()["seq"]
        # second put exceeds the 16-byte tier cap -> first is evicted
        cache.put("compressed", "p.bam", 70_000, b"y", 10, "t")
        delta = cache.cachemap(since=s0)["delta"]
        assert ["add", "p.bam", 1] in delta
        assert ["del", "p.bam", 0] in delta
        assert cache.cachemap()["paths"] == {"p.bam": [1]}

    def test_invalidate_path_drops_only_that_path(self):
        cache = _mk_cache()
        cache.put("compressed", "a.bam", 0, b"x", 8, "t")
        cache.put("parsed", "a.bam", 70_000, b"y", 8, "t")
        cache.put("compressed", "b.bam", 0, b"z", 8, "t")
        dropped = cache.invalidate_path("a.bam")
        assert dropped == 2
        assert cache.cachemap()["paths"] == {"b.bam": [0]}
        assert cache.stats()["compressed"]["bytes"] == 8
        assert counter("serve.cache.invalidations").value(
            tier="compressed") == 1

    def test_clear_scrolls_routers_to_full_map(self):
        cache = _mk_cache()
        cache.put("compressed", "p.bam", 0, b"x", 8, "t")
        s0 = cache.cachemap()["seq"]
        cache.clear()
        # seq bumped with the log emptied: an incremental `since`
        # falls back to the (now empty) full map, never a stale delta
        doc = cache.cachemap(since=s0)
        assert "delta" not in doc
        assert doc["paths"] == {}


# -- router units on scripted clients + injected clock ----------------------


class _FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


class _FakeClient:
    """Scripted replica: cachemap/stats/healthz/register/query, a
    ``fail`` switch for transport death, a ``block`` event to wedge
    query responses (hedge tests)."""

    def __init__(self, endpoint):
        self.endpoint = endpoint
        self.cachemap = {"seq": 0, "bucket_bits": DIGEST_BUCKET_BITS,
                         "paths": {}, "epochs": {}}
        self.stats_doc = {"admission": {"slots": 4, "queue_depth": 8,
                                        "tenants": {}}}
        self.register_epoch = 1
        self.fail = False
        self.block = None
        self.queries = []
        self.registers = []

    def request(self, method, path, doc=None, headers=None):
        if self.fail:
            raise ReplicaError(self.endpoint,
                               ConnectionRefusedError("down"))
        if path.startswith("/serve/cachemap"):
            return 200, dict(self.cachemap)
        if path == "/serve/stats":
            return 200, self.stats_doc
        if path == "/healthz":
            return 200, {"status": "ok"}
        if path == "/serve/register":
            self.registers.append(doc)
            return 200, {"name": doc["name"], "kind": "reads",
                         "epoch": self.register_epoch}
        if path.startswith("/query/"):
            if self.block is not None:
                self.block.wait(timeout=10)
            self.queries.append((doc, dict(headers or {})))
            return 200, {"count": 1, "replica": self.endpoint}
        return 404, {"error": path}

    def close(self):
        pass


def _mk_router(n=2, **kw):
    clients = {}

    def factory(ep):
        clients[ep] = _FakeClient(ep)
        return clients[ep]

    clock = _FakeClock()
    kw.setdefault("hedge_quantile", None)
    router = FleetRouter([f"r{i}:1" for i in range(n)],
                         client_factory=factory, clock=clock, **kw)
    return router, clients, clock


class TestFleetRouter:
    def test_locality_routes_to_the_digest_holder(self):
        router, clients, _clock = _mk_router()
        try:
            clients["r1:1"].cachemap = {
                "seq": 3, "bucket_bits": DIGEST_BUCKET_BITS,
                "paths": {"p.bam": [5, 6]}, "epochs": {}}
            router._resolve = lambda doc: ("p.bam", [5])
            status, body = router.query("/query/reads", {"dataset": "p.bam"})
            assert status == 200
            assert body["replica"] == "r1:1"
            assert counter("fleet.route").value(result="hit") == 1
            assert counter("fleet.routed").value(
                endpoint="reads", replica="r1:1") == 1
        finally:
            router.close()

    def test_cold_rendezvous_is_sticky_per_region(self):
        """No digest anywhere: repeats of one region go to ONE replica
        (and become warm there), while distinct regions spread across
        the fleet — the tie-break key carries the region, not just the
        dataset path."""
        router, clients, _clock = _mk_router()
        try:
            region = {}
            router._resolve = lambda doc: ("p.bam", [region["b"]])
            region["b"] = 7
            for _ in range(3):
                status, body = router.query("/query/reads", {})
                assert status == 200
            first = {body["replica"]}
            assert {c.endpoint for c in clients.values()
                    if c.queries} == first
            targets = set()
            for b in range(32):
                region["b"] = b
                _status, body = router.query("/query/reads", {})
                targets.add(body["replica"])
            assert targets == {"r0:1", "r1:1"}
            assert counter("fleet.route").value(result="miss") == 35
        finally:
            router.close()

    def test_hedge_books_launch_and_win(self):
        """A wedged primary races a duplicate on the runner-up; first
        response wins and both sides of the outcome are booked."""
        router, clients, _clock = _mk_router(
            hedge_quantile=0.5, hedge_min_s=0.005)
        wedge = threading.Event()
        try:
            # digest overlap ranks r0 first; r0 then wedges on query
            clients["r0:1"].cachemap = {
                "seq": 1, "bucket_bits": DIGEST_BUCKET_BITS,
                "paths": {"p.bam": [1]}, "epochs": {}}
            clients["r0:1"].block = wedge
            router._resolve = lambda doc: ("p.bam", [1])
            status, body = router.query("/query/reads", {"tenant": "t"})
            assert status == 200
            assert body["replica"] == "r1:1"
            assert counter("fleet.hedge.launched").total() == 1
            assert counter("fleet.hedge.won").value(winner="hedge") == 1
        finally:
            wedge.set()
            router.close()

    def test_trace_headers_ride_the_dispatch(self):
        router, clients, _clock = _mk_router()
        ctx = mint_trace("t")
        token = activate_trace(ctx)
        try:
            router._resolve = lambda doc: ("p.bam", None)
            status, _body = router.query("/query/reads", {"tenant": "t"})
            assert status == 200
            (_doc, headers), = [q for c in clients.values()
                                for q in c.queries]
            assert headers.get("X-Disq-Trace-Id") == ctx.trace_id
        finally:
            deactivate_trace(token)
            router.close()

    def test_fleet_admission_sheds_an_aggregate_hog(self):
        """A tenant whose summed active+queued across replica stats
        saturates the fleet's aggregate capacity gets 429 at the
        router, even though each replica alone looks tolerable."""
        router, clients, _clock = _mk_router()
        try:
            for c in clients.values():
                c.stats_doc = {"admission": {
                    "slots": 1, "queue_depth": 0,
                    "tenants": {"hog": {"active": 2, "queued": 0}}}}
            router._resolve = lambda doc: ("p.bam", None)
            status, body = router.query("/query/reads", {"tenant": "hog"})
            assert status == 429
            assert "hog" in body["error"]
            assert counter("fleet.admission").value(
                result="shed", tenant="hog") == 1
            # other tenants still clear the same fleet
            status, _body = router.query("/query/reads", {"tenant": "ok"})
            assert status == 200
        finally:
            router.close()

    def test_replica_loss_reroutes_and_records(self, tmp_path):
        from disq_tpu_torch.runtime import flightrec

        flightrec.enable(str(tmp_path))
        router, clients, clock = _mk_router(probe_s=2.0)
        try:
            clients["r0:1"].fail = True
            router._resolve = lambda doc: ("p.bam", None)
            status, body = router.query("/query/reads", {})
            assert status == 200
            assert body["replica"] == "r1:1"
            assert router.stats()["live"] == 1
            assert gauge("fleet.replicas").state()["last"] == 1
            events = flightrec.recorder().events()
            assert any(e.get("kind") == "fleet.replica_lost"
                       and e.get("endpoint") == "r0:1" for e in events)
            # replica returns; the lazy probe restores it
            clients["r0:1"].fail = False
            clock.now += 10.0
            status, _body = router.query("/query/reads", {})
            assert status == 200
            assert router.stats()["live"] == 2
            assert any(e.get("kind") == "fleet.replica_restored"
                       for e in flightrec.recorder().events())
        finally:
            router.close()

    def test_epoch_bump_drops_router_digest_view(self):
        router, _clients, _clock = _mk_router()
        try:
            r = router._replicas[0]
            router._apply_cachemap(r, {
                "seq": 4, "paths": {"p.bam": [1, 2]},
                "epochs": {"p.bam": 1}})
            assert r.digest == {"p.bam": {1, 2}}
            # re-register on the replica: epoch bumps, delta is empty —
            # the router must still shed its stale warm view
            router._apply_cachemap(r, {
                "seq": 5, "delta": [], "epochs": {"p.bam": 2}})
            assert r.digest == {}
            assert r.seq == 5
        finally:
            router.close()

    def test_register_fans_out_and_resyncs(self, tmp_path):
        from disq_tpu_torch.fsw.filesystem import resolve_path

        path = tmp_path / "d.bam"
        path.write_bytes(b"")
        _fs, fs_path = resolve_path(str(path))
        router, clients, _clock = _mk_router()
        try:
            clients["r1:1"].register_epoch = 3
            router._replicas[0].digest[fs_path] = {1, 2}
            status, doc = router.register("ds", str(path))
            assert status == 200
            assert doc["epoch"] == 3
            assert all(len(c.registers) == 1 for c in clients.values())
            assert fs_path not in router._replicas[0].digest
            assert router.stats()["datasets"]["ds"]["kind"] == "reads"
        finally:
            router.close()

    def test_handle_routes_and_rejects(self):
        router, _clients, _clock = _mk_router()
        try:
            status, doc = router.handle("GET", "/fleet/stats", {})
            assert status == 200 and doc["live"] == 2
            status, _doc = router.handle("GET", "/fleet/query/reads", {})
            assert status == 405
            status, doc = router.handle("POST", "/fleet/register",
                                        {"name": "x"})
            assert status == 400
            status, doc = router.handle("POST", "/fleet/nope", {})
            assert status == 404 and "/fleet/query/reads" in doc["endpoints"]
        finally:
            router.close()

    def test_fleet_off_answers_503_without_allocating(self):
        from disq_tpu_torch.runtime import fleet as fleet_mod

        assert fleet_mod.fleet_if_running() is None
        status, doc = handle_http("POST", "/fleet/query/reads", {})
        assert status == 503
        assert "not started" in doc["error"]

    def test_router_rejects_bad_config(self):
        with pytest.raises(ValueError, match="at least one replica"):
            FleetRouter([])
        with pytest.raises(ValueError, match="unknown routing policy"):
            FleetRouter(["r0:1"], policy="nearest",
                        client_factory=_FakeClient)


# -- parity with the reference's router ---------------------------------------

REFS13 = ("chr1", "chr2", "chr3")


def _regions13():
    """The 64 regions of the reference's serving workload (``bench.py``
    config 13: ``random.Random(13)``, 20,000 bp, weight 1/rank)."""
    rng = random.Random(13)
    span = 20_000
    return [(REFS13[rng.randrange(len(REFS13))],
             rng.randrange(0, 1_000_000 - span)) for _ in range(64)]


class _RefFakeClient(_FakeClient):
    def request(self, method, path, doc=None, headers=None):
        if self.fail:
            raise ref_fleet.ReplicaError(self.endpoint,
                                         ConnectionRefusedError("down"))
        return super().request(method, path, doc, headers)


def _both(n=3, **kw):
    """A reference and a port router over the same scripted replicas."""
    out = []
    for mod, client in ((ref_fleet, _RefFakeClient), (None, _FakeClient)):
        clients = {}

        def factory(ep, _c=clients, _cls=client):
            _c[ep] = _cls(ep)
            return _c[ep]

        kw2 = dict(kw)
        kw2.setdefault("hedge_quantile", None)
        cls = mod.FleetRouter if mod is not None else FleetRouter
        router = cls([f"r{i}:{7000 + i}" for i in range(n)],
                     client_factory=factory, clock=_FakeClock(), **kw2)
        out.append((router, clients))
    return out


class TestParity:
    def test_rendezvous_winner_per_config13_region(self):
        (ref, _), (port, _) = _both(3)
        try:
            for contig, start in _regions13():
                # the region's first digest bucket, as the router keys it
                cb = (start * 37) << 16
                key = f"/data/{contig}.bam"
                buckets = list(digest_buckets(cb, cb + (20_000 << 16)))
                want = [r.endpoint for r in ref._rank(key, buckets)]
                got = [r.endpoint for r in port._rank(key, buckets)]
                assert got == want, (contig, start)
        finally:
            ref.close()
            port.close()

    def test_locality_ranking_equal_reference(self):
        (ref, rc), (port, pc) = _both(4)
        try:
            rng = random.Random(7)
            digests = {f"r{i}:{7000 + i}": {
                "p.bam": sorted(rng.sample(range(64), 12))}
                for i in range(4)}
            for clients in (rc, pc):
                for ep, paths in digests.items():
                    clients[ep].cachemap = {
                        "seq": 1, "bucket_bits": DIGEST_BUCKET_BITS,
                        "paths": paths, "epochs": {"p.bam": 1}}
            ref._maybe_refresh()
            port._maybe_refresh()
            for _ in range(64):
                lo = rng.randrange(60)
                want = [r.endpoint for r in ref._rank("p.bam",
                                                      [lo, lo + 1, lo + 2])]
                got = [r.endpoint for r in port._rank("p.bam",
                                                      [lo, lo + 1, lo + 2])]
                assert got == want
            assert counter("fleet.route").value(result="hit") == \
                ref_tracing.counter("fleet.route").value(result="hit")
        finally:
            ref.close()
            port.close()

    def test_admission_decisions_equal_reference(self):
        (ref, rc), (port, pc) = _both(2)
        try:
            usage = [(0, 0), (2, 1), (4, 4), (5, 6), (1, 0), (9, 9)]
            got, want = [], []
            for active, queued in usage:
                for clients in (rc, pc):
                    for c in clients.values():
                        c.stats_doc = {"admission": {
                            "slots": 2, "queue_depth": 3, "tenants": {
                                "t": {"active": active, "queued": queued}}}}
                for router, out in ((ref, want), (port, got)):
                    router._refresh_one(router._replicas[0])
                    router._refresh_one(router._replicas[1])
                    out.append(router._admit("t"))
            assert got == want
            assert got == [True, True, False, False, True, False]
        finally:
            ref.close()
            port.close()


# -- request-trace helpers ----------------------------------------------------


class TestTraceHelpers:
    def test_mint_counts_child_and_headers_equal_reference(
            self, monkeypatch):
        for mod in (tracing, ref_tracing):
            mod.reset_trace_state()
        try:
            assert tracing.trace_ids_minted() == 0
            ctx, rctx = mint_trace("acme"), ref_tracing.mint_trace("acme")
            assert tracing.trace_ids_minted() == \
                ref_tracing.trace_ids_minted() == 2
            assert (len(ctx.trace_id), len(ctx.span_id)) == \
                (len(rctx.trace_id), len(rctx.span_id)) == (16, 8)
            child = tracing.child_context(ctx)
            assert (child.trace_id, child.tenant) == (ctx.trace_id, "acme")
            assert child.span_id != ctx.span_id
            assert tracing.trace_ids_minted() == 2  # a hop mints no id
            token = activate_trace(ctx)
            try:
                headers = tracing.inject_trace_headers({})
            finally:
                deactivate_trace(token)
            rtoken = ref_tracing.activate_trace(rctx)
            try:
                rheaders = ref_tracing.inject_trace_headers({})
            finally:
                ref_tracing.deactivate_trace(rtoken)
            assert sorted(headers) == sorted(rheaders)
            back = tracing.trace_from_headers(headers)
            rback = ref_tracing.trace_from_headers(headers)
            assert (back.trace_id, back.span_id, back.tenant) == \
                (rback.trace_id, rback.span_id, rback.tenant) == \
                (ctx.trace_id, ctx.span_id, "acme")
            assert tracing.current_trace() is None
        finally:
            for mod in (tracing, ref_tracing):
                mod.reset_trace_state()

    @pytest.mark.parametrize("value,want", [("", False), ("0", False),
                                            ("off", False), ("1", True),
                                            ("yes", True)])
    def test_trace_requests_knob_equals_reference(self, monkeypatch, value,
                                                  want):
        monkeypatch.setenv("DISQ_TPU_TORCH_TRACE_REQUESTS", value)
        monkeypatch.setenv("DISQ_TPU_TRACE_REQUESTS", value)
        for mod in (tracing, ref_tracing):
            mod.reset_trace_state()
        try:
            assert tracing.trace_requests_enabled() is want
            assert ref_tracing.trace_requests_enabled() is want
            # resolving the knob mints nothing
            assert tracing.trace_ids_minted() == 0
        finally:
            for mod in (tracing, ref_tracing):
                mod.reset_trace_state()
