"""The port's serving plane (``disq_tpu_torch/runtime/serve.py``) on the
CPU, in three groups:

- the reference's cases (``tests/test_serve.py``) on the port: endpoint
  answers against the direct traversal read, the shared hot-block cache,
  the index LRU, per-tenant admission, cross-client identity (host zlib,
  and the device service, slow-marked as the reference's), the operator
  endpoints and their trace stitching;
- parity: the same seeded indexed BAM and VCF.bgz go to
  ``disq_tpu.runtime.serve.ServeDaemon`` (host zlib) and the port's
  daemon (host zlib, and the device route through the kernels' plain
  versions); the same request sequence gives equal JSON for every query
  endpoint, equal ``/serve/cachemap`` buckets and epochs, and the same
  admission shed sequence;
- routes: the per-request B1 route, the device service and B4 under
  ``legacy`` decode (plain versions) to the host route's bytes, one B1
  batch per request that missed the decoded tier; a corrupted payload
  answers 500 with ``CorruptBlockError`` and no host decode.

Tolerance: exact everywhere.
"""

import json
import os
import random
import threading
import urllib.request

import numpy as np
import pytest
import torch

from bam_oracle import (DEFAULT_REFS, make_bam_bytes, o_bgzf_compress,
                        oracle_pileup, synth_records)
from disq_tpu.runtime import serve as ref_serve

import disq_tpu_torch as P
from disq_tpu_torch.api import Interval
from disq_tpu_torch.runtime import serve as serve_mod
from disq_tpu_torch.runtime.introspect import stop_introspect_server
from disq_tpu_torch.runtime.tracing import (
    TRACE_ID_HEADER,
    TRACE_PARENT_HEADER,
    TRACE_TENANT_HEADER,
    counter,
    spans,
)

REGIONS = [
    ("chr1", 1, 5000),
    ("chr1", 40_000, 60_000),
    ("chr2", 1, 50_000),
    ("chrM", 1, 16_569),
]
VCF_CONTIGS = [("chr1", 100_000), ("chr2", 50_000)]


def _storage():
    return P.ReadsStorage.make_default(device="cpu")


def _write_indexed(raw_bytes, tmp, name):
    raw = str(tmp / f"{name}-raw.bam")
    with open(raw, "wb") as f:
        f.write(raw_bytes)
    st = _storage().num_shards(4)
    out = str(tmp / f"{name}.bam")
    st.write(st.read(raw), out, P.BaiWriteOption.ENABLE,
             P.SbiWriteOption.ENABLE, sort=True)
    return out


@pytest.fixture(scope="module")
def indexed_bam(tmp_path_factory):
    return _write_indexed(
        make_bam_bytes(DEFAULT_REFS, synth_records(1500, seed=23,
                                                   unmapped_tail=0),
                       blocksize=700),
        tmp_path_factory.mktemp("serve"), "sorted")


@pytest.fixture(scope="module")
def indexed_vcf(tmp_path_factory):
    rng = np.random.default_rng(5)
    header = ("##fileformat=VCFv4.2\n"
              + "".join(f"##contig=<ID={c},length={n}>\n"
                        for c, n in VCF_CONTIGS)
              + '##INFO=<ID=END,Number=1,Type=Integer,Description="End">\n'
              + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n")
    recs = []
    for i in range(600):
        ci = int(rng.integers(0, len(VCF_CONTIGS)))
        pos = int(rng.integers(1, VCF_CONTIGS[ci][1] - 600))
        info = f"END={pos + 499}" if i % 37 == 0 else "."
        recs.append((ci, pos, f"{VCF_CONTIGS[ci][0]}\t{pos}\tid{i}\tA\tT\t50"
                              f"\tPASS\t{info}\tGT\t0/1"))
    recs.sort(key=lambda t: (t[0], t[1]))
    d = tmp_path_factory.mktemp("serve-vcf")
    src = str(d / "in.vcf.bgz")
    with open(src, "wb") as f:
        f.write(o_bgzf_compress(
            (header + "".join(r + "\n" for _, _, r in recs)).encode(),
            blocksize=900))
    st = P.VariantsStorage.make_default(device="cpu").num_shards(2)
    out = str(d / "v.vcf.bgz")
    st.write(st.read(src), out, P.TabixIndexWriteOption.ENABLE)
    return out


@pytest.fixture()
def daemon(indexed_bam):
    """A running daemon on the CPU with the module BAM as ``reads``."""
    addr = serve_mod.start_serve(port=0, device="cpu", tenant_slots=8,
                                 tenant_queue=32)
    d = serve_mod.serve_if_running()
    d.register("reads", indexed_bam)
    try:
        yield d, addr
    finally:
        serve_mod.stop_serve()
        stop_introspect_server()


def _post(addr, path, doc, timeout=30):
    req = urllib.request.Request(
        f"http://{addr}{path}", data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _truth_count(path, contig, start, end):
    ds = _storage().read(
        path, P.TraversalParameters(intervals=[Interval(contig, start, end)]))
    return int(ds.reads.count)


def _q(contig, start, end, tenant="t0", **kw):
    doc = {"dataset": "reads", "tenant": tenant,
           "intervals": [{"contig": contig, "start": start, "end": end}]}
    doc.update(kw)
    return doc


def _pin(adm, tenant, slots, queued):
    """Hold every slot of ``tenant`` and park ``queued`` waiters in its
    queue; returns the waiter threads."""
    for _ in range(slots):
        adm.acquire(tenant)

    def parked():
        try:
            adm.acquire(tenant)
        except serve_mod.AdmissionShed:
            return
        adm.release(tenant)

    waiters = [threading.Thread(target=parked) for _ in range(queued)]
    for t in waiters:
        t.start()
    spins = 500
    while spins and adm.stats()["tenants"][tenant]["queued"] < queued:
        spins -= 1
        threading.Event().wait(0.01)
    return waiters


def _unpin(adm, tenant, slots, waiters):
    for _ in range(slots):
        adm.release(tenant)
    for t in waiters:
        t.join(timeout=30)


# -- the reference's cases (tests/test_serve.py) -----------------------------


class TestEndpoints:
    @pytest.mark.parametrize("contig,start,end", REGIONS)
    def test_reads_count_matches_traversal(self, daemon, indexed_bam,
                                           contig, start, end):
        _, addr = daemon
        status, out = _post(addr, "/query/reads", _q(contig, start, end))
        assert status == 200
        assert out["count"] == _truth_count(indexed_bam, contig, start, end)
        assert len(out["records"]) == min(out["count"], 100)
        for r in out["records"]:
            assert r["contig"] == contig

    def test_count_only_fast_path_matches(self, daemon):
        _, addr = daemon
        contig, start, end = REGIONS[1]
        _, full = _post(addr, "/query/reads", _q(contig, start, end))
        status, fast = _post(addr, "/query/reads",
                             _q(contig, start, end, limit=0, digest=False))
        assert status == 200
        assert fast["count"] == full["count"]
        assert fast["records"] == []
        assert "digest" not in fast and "digest" in full

    def test_stats_flagstat_and_depth(self, daemon, indexed_bam):
        _, addr = daemon
        contig, start, end = REGIONS[0]
        status, out = _post(addr, "/query/stats",
                            _q(contig, start, end, stat="flagstat"))
        assert status == 200
        assert out["flagstat"]["total"] == _truth_count(
            indexed_bam, contig, start, end)
        status, out = _post(addr, "/query/stats",
                            _q(contig, start, end, stat="depth", window=512))
        assert status == 200
        assert out["depth"]["window"] == 512
        assert out["depth"]["refs"]["chr1"]["total"] >= out["count"]

    def test_serve_stats_shape(self, daemon):
        _, addr = daemon
        _post(addr, "/query/reads", _q(*REGIONS[0]))
        with urllib.request.urlopen(f"http://{addr}/serve/stats",
                                    timeout=30) as r:
            st = json.loads(r.read())
        assert {"datasets", "cache", "index_cache", "admission",
                "latency"} <= set(st)
        assert [d["name"] for d in st["datasets"]] == ["reads"]
        for tier in ("compressed", "decoded", "parsed"):
            assert st["cache"][tier]["bytes"] >= 0
        assert st["admission"]["slots"] == 8

    def test_errors(self, daemon):
        _, addr = daemon
        status, _ = _post(addr, "/query/reads",
                          _q(*REGIONS[0], dataset="nope"))
        assert status == 404
        status, _ = _post(addr, "/query/reads", {"tenant": "x"})
        assert status == 400
        status, _ = _post(addr, "/query/stats",
                          _q(*REGIONS[0], stat="bogus"))
        assert status == 400

    def test_handle_http_503_when_off(self):
        assert serve_mod.serve_if_running() is None
        status, out = serve_mod.handle_http("POST", "/query/reads", {})
        assert status == 503
        assert "serv" in out["error"]

    def test_serve_metrics_exposed(self, daemon):
        _, addr = daemon
        _post(addr, "/query/reads", _q(*REGIONS[0]))
        with urllib.request.urlopen(f"http://{addr}/metrics",
                                    timeout=30) as r:
            body = r.read().decode()
        for name in ("serve_request", "serve_cache_misses",
                     "serve_admission"):
            assert name in body


class TestHotBlockCache:
    def test_repeat_query_hits_parsed_tier(self, daemon):
        d, addr = daemon
        _, first = _post(addr, "/query/reads", _q(*REGIONS[2]))
        hits0 = counter("serve.cache.hits").total()
        _, second = _post(addr, "/query/reads", _q(*REGIONS[2]))
        assert second["digest"] == first["digest"]
        assert second["count"] == first["count"]
        assert counter("serve.cache.hits").total() > hits0
        st = d.cache.stats()
        assert st["parsed"]["blocks"] > 0
        assert st["parsed"]["tenant_bytes"]["t0"] > 0

    def test_eviction_under_byte_budget(self, daemon):
        ev0 = counter("serve.cache.evictions").total()
        cache = serve_mod.HotBlockCache(
            compressed_bytes=1 << 12, decoded_bytes=1 << 12,
            parsed_bytes=1 << 12)
        for i in range(8):
            cache.put("decoded", "p", i, b"x" * 1024, 1024, "t")
        assert cache.stats()["decoded"]["bytes"] <= 1 << 12
        assert counter("serve.cache.evictions").total() > ev0
        assert cache.get("decoded", "p", 0, "t") is None
        assert cache.get("decoded", "p", 7, "t") == b"x" * 1024

    def test_clear_empties_every_tier(self, daemon):
        d, addr = daemon
        _post(addr, "/query/reads", _q(*REGIONS[0]))
        d.cache.clear()
        st = d.cache.stats()
        for tier in serve_mod.HotBlockCache.TIERS:
            assert st[tier]["blocks"] == 0
            assert st[tier]["bytes"] == 0


class TestIndexCache:
    def test_mtime_size_invalidation(self, tmp_path, daemon):
        d, addr = daemon
        p = str(tmp_path / "swap.bam")
        storage = _storage().num_shards(2)

        def write_n(n, seed):
            raw = str(tmp_path / "raw.bam")
            with open(raw, "wb") as f:
                f.write(make_bam_bytes(
                    DEFAULT_REFS, synth_records(n, seed=seed), blocksize=700))
            storage.write(storage.read(raw), p, P.BaiWriteOption.ENABLE,
                          P.SbiWriteOption.ENABLE, sort=True)

        write_n(200, seed=1)
        d.register("swap", p)
        doc = _q("chr1", 1, 200_000, dataset="swap", digest=False, limit=0)
        _, out1 = _post(addr, "/query/reads", doc)
        misses1 = counter("serve.index_cache.misses").total()
        _, again = _post(addr, "/query/reads", doc)
        assert again["count"] == out1["count"]
        assert counter("serve.index_cache.misses").total() == misses1
        assert counter("serve.index_cache.hits").total() > 0
        # rewrite in place: (size, mtime) change and the entry drops
        write_n(400, seed=2)
        d.cache.clear()
        _, out2 = _post(addr, "/query/reads", doc)
        assert counter("serve.index_cache.misses").total() > misses1
        assert out2["count"] != out1["count"]
        assert out2["count"] == _truth_count(p, "chr1", 1, 200_000)

    def test_lru_capacity_bound(self):
        ic = serve_mod.IndexCache(entries=2)
        calls = []

        class _FS:
            def get_file_length(self, path):
                return 1

        def build(fs, path):
            calls.append(path)
            return path.upper()

        for p in ("a", "b", "c", "a"):
            ic.get(_FS(), p, build)
        assert calls == ["a", "b", "c", "a"]


class TestAdmission:
    def test_deterministic_shed(self):
        adm = serve_mod.TenantAdmission(slots=1, queue_depth=0)
        shed0 = counter("serve.admission").value(result="shed",
                                                 tenant="noisy")
        adm.acquire("noisy")
        with pytest.raises(serve_mod.AdmissionShed):
            adm.acquire("noisy")
        assert counter("serve.admission").value(
            result="shed", tenant="noisy") == shed0 + 1
        adm.acquire("polite")
        adm.release("polite")
        adm.release("noisy")
        adm.acquire("noisy")
        adm.release("noisy")

    def test_queue_then_release(self):
        adm = serve_mod.TenantAdmission(slots=1, queue_depth=4)
        adm.acquire("t")
        got = []

        def waiter():
            adm.acquire("t")
            got.append(1)
            adm.release("t")

        th = threading.Thread(target=waiter)
        th.start()
        deadline = 50
        while adm.stats()["tenants"].get("t", {}).get("queued", 0) < 1 \
                and deadline:
            deadline -= 1
            threading.Event().wait(0.01)
        adm.release("t")
        th.join(timeout=10)
        assert got == [1]

    def test_http_429_when_pinned(self, daemon):
        d, addr = daemon
        waiters = _pin(d.admission, "pig", 8, 32)
        try:
            status, _ = _post(addr, "/query/reads",
                              _q(*REGIONS[0], tenant="pig"))
            assert status == 429
            status2, _ = _post(addr, "/query/reads",
                               _q(*REGIONS[0], tenant="calm"))
            assert status2 == 200
        finally:
            _unpin(d.admission, "pig", 8, waiters)


class TestConcurrencyIdentity:
    """N threads issuing overlapping region queries get the answers of
    serial queries: host zlib, and the device service."""

    def _run_identity(self, daemon, dataset, n_threads=16, passes=2,
                      timeout=30):
        d, addr = daemon
        serial = {}
        for i, (contig, start, end) in enumerate(REGIONS):
            status, doc = _post(
                addr, "/query/reads",
                _q(contig, start, end, tenant="s", dataset=dataset),
                timeout=timeout)
            assert status == 200, doc
            serial[i] = doc["digest"]
        d.cache.clear()
        results = [None] * n_threads
        errors = []

        def client(k, order):
            try:
                for i in order:
                    contig, start, end = REGIONS[i]
                    status, doc = _post(
                        addr, "/query/reads",
                        _q(contig, start, end, tenant=f"t{k % 4}",
                           dataset=dataset),
                        timeout=timeout)
                    assert status == 200, doc
                    assert doc["digest"] == serial[i], (k, i)
                results[k] = True
            except Exception as e:  # pragma: no cover - surfaced below
                errors.append((k, repr(e)))

        threads = []
        for k in range(n_threads):
            order = list(range(len(REGIONS))) * passes
            random.Random(k).shuffle(order)
            threads.append(threading.Thread(target=client, args=(k, order)))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not errors, errors
        assert all(results)

    def test_identity_host_zlib(self, daemon, monkeypatch):
        monkeypatch.delenv("DISQ_TPU_TORCH_DEVICE_SERVICE", raising=False)
        self._run_identity(daemon, "reads")

    @pytest.mark.slow
    def test_identity_device_service(self, daemon, tmp_path, monkeypatch):
        """The same contract through the device service (B1's plain
        version on the CPU), on a tiny BAM."""
        from disq_tpu_torch.runtime import device_service

        tiny = _write_indexed(
            make_bam_bytes(DEFAULT_REFS, synth_records(120, seed=5),
                           blocksize=4096), tmp_path, "tiny")
        d, _addr = daemon
        d.register("tiny", tiny)
        d.device_route = True
        monkeypatch.setenv("DISQ_TPU_TORCH_DEVICE_SERVICE", "1")
        try:
            self._run_identity(daemon, "tiny", n_threads=4, passes=1,
                               timeout=300)
        finally:
            device_service.shutdown_service()


class TestOperatorEndpoints:
    def test_markdup_stats_and_filtered_count_shape(self, daemon):
        _, addr = daemon
        contig, start, end = REGIONS[1]
        _, reads = _post(addr, "/query/reads",
                         _q(contig, start, end, limit=0, digest=False))
        status, md = _post(addr, "/query/markdup-stats",
                           _q(contig, start, end, rgstats=True))
        assert status == 200
        assert md["count"] == reads["count"]
        assert md["markdup"]["examined"] <= md["count"]
        assert md["markdup"]["duplicates"] <= md["markdup"]["examined"]
        assert sum(g["reads"] for g in md["rgstats"].values()) \
            == md["count"]
        _, hit = _post(addr, "/query/filtered-count",
                       _q(contig, start, end, filter="-f 0x10"))
        _, miss = _post(addr, "/query/filtered-count",
                        _q(contig, start, end, filter="-F 0x10"))
        assert hit["matched"] + miss["matched"] == reads["count"]
        status, err = _post(addr, "/query/filtered-count",
                            _q(contig, start, end, filter="-z oops"))
        assert status == 400 and "error" in err

    def test_pileup_matches_host_oracle(self, daemon):
        _, addr = daemon
        contig, start, end = REGIONS[0]
        status, out = _post(addr, "/query/pileup", _q(contig, start, end))
        assert status == 200
        truth = oracle_pileup(synth_records(1500, seed=23, unmapped_tail=0),
                              0, start - 1, end)
        assert out["coverage"] == truth.astype(int).tolist()
        assert out["max"] == int(truth.max())
        assert out["nonzero"] == int((truth > 0).sum())
        status, slim = _post(addr, "/query/pileup",
                             _q(contig, start, end, max_bases=16))
        assert status == 200 and "coverage" not in slim
        assert slim["max"] == out["max"]
        doc = _q(contig, start, end)
        doc["intervals"].append({"contig": "chr2", "start": 1, "end": 10})
        status, err = _post(addr, "/query/pileup", doc)
        assert status == 400 and "error" in err

    def test_admission_counts_operator_queries(self, daemon):
        d, addr = daemon
        waiters = _pin(d.admission, "pig", 8, 32)
        try:
            for path in ("/query/pileup", "/query/markdup-stats"):
                status, out = _post(addr, path, _q(*REGIONS[0], tenant="pig"))
                assert status == 429, (path, out)
                assert out["tenant"] == "pig"
            status, _ = _post(addr, "/query/pileup",
                              _q(*REGIONS[0], tenant="calm"))
            assert status == 200
        finally:
            _unpin(d.admission, "pig", 8, waiters)

    def test_operator_spans_stitch_under_request_root(self, daemon):
        _, addr = daemon
        for trace_id, path, doc, op_span in [
            ("beefcafe00000021", "/query/pileup",
             _q(*REGIONS[0], tenant="acme"), "ops.pileup.apply"),
            ("beefcafe00000022", "/query/markdup-stats",
             _q(*REGIONS[1], tenant="acme"), "ops.markdup.apply"),
        ]:
            req = urllib.request.Request(
                f"http://{addr}{path}", data=json.dumps(doc).encode(),
                headers={"Content-Type": "application/json",
                         TRACE_ID_HEADER: trace_id,
                         TRACE_PARENT_HEADER: "00",
                         TRACE_TENANT_HEADER: "acme"},
                method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status == 200
            roots = [s for s in spans()
                     if s["name"] == "serve.request.trace"
                     and s.get("trace") == trace_id]
            assert roots, f"no request root for {path}"
            assert roots[-1]["labels"]["status"] == 200
            assert roots[-1]["labels"]["endpoint"] == path.rsplit("/", 1)[-1]
            assert roots[-1]["tenant"] == "acme"
            assert [s for s in spans()
                    if s["name"] == op_span and s.get("trace") == trace_id]


# -- parity with the reference daemon -----------------------------------------


def _sequence():
    """The parity request sequence: every query endpoint, repeats (hot
    tiers), multi-interval requests and the count-only fast path."""
    reads = [
        ("/query/reads", _q(*REGIONS[1])),
        ("/query/reads", {"dataset": "reads", "tenant": "t1", "intervals": [
            {"contig": "chr1", "start": 1, "end": 60_000},
            {"contig": "chr2", "start": 1, "end": 50_000}]}),
        ("/query/reads", _q(*REGIONS[1])),
        ("/query/reads", _q(*REGIONS[3], limit=0, digest=False)),
        ("/query/stats", _q(*REGIONS[2], stat="flagstat")),
        ("/query/stats", _q(*REGIONS[2], stat="depth", window=512)),
        ("/query/markdup-stats", _q(*REGIONS[1], rgstats=True)),
        ("/query/pileup", _q(*REGIONS[0])),
        ("/query/filtered-count", _q("chr1", 1, 200_000,
                                     filter="-F 0x904 -q 20 -s 7.5")),
        ("/query/filtered-count", _q(*REGIONS[2], filter="-f 0x10")),
    ]
    variants = [
        ("/query/variants", {"dataset": "calls", "tenant": "v",
                             "intervals": [{"contig": "chr1", "start": 1,
                                            "end": 30_000}]}),
        ("/query/variants", {"dataset": "calls", "tenant": "v", "limit": 3,
                             "intervals": [
                                 {"contig": "chr1", "start": 50_000,
                                  "end": 90_000},
                                 {"contig": "chr2", "start": 1,
                                  "end": 25_000}]}),
        ("/query/variants", {"dataset": "calls", "tenant": "v",
                             "intervals": [{"contig": "chr1", "start": 1,
                                            "end": 30_000}]}),
    ]
    return reads + variants


@pytest.fixture(scope="module")
def reference_answers(indexed_bam, indexed_vcf):
    d = ref_serve.ServeDaemon()
    d.register("reads", indexed_bam)
    d.register("calls", indexed_vcf)
    answers = [d.handle("POST", path, dict(doc)) for path, doc in _sequence()]
    return answers, d.cachemap({})


def _port_daemon(indexed_bam, indexed_vcf, **kw):
    d = serve_mod.ServeDaemon(device="cpu", **kw)
    d.register("reads", indexed_bam)
    d.register("calls", indexed_vcf)
    return d


class TestParity:
    @pytest.mark.parametrize("route", ["host", "device"])
    def test_query_answers_and_cachemap_equal_reference(
            self, indexed_bam, indexed_vcf, reference_answers, route):
        want, want_map = reference_answers
        d = _port_daemon(indexed_bam, indexed_vcf,
                         resident_decode=route == "device")
        got = [d.handle("POST", path, dict(doc))
               for path, doc in _sequence()]
        for (path, doc), g, w in zip(_sequence(), got, want):
            assert g == w, (path, doc)
        got_map = d.cachemap({})
        assert got_map["paths"] == want_map["paths"]
        assert got_map["epochs"] == want_map["epochs"]
        assert got_map["bucket_bits"] == want_map["bucket_bits"]

    def test_register_epochs_and_errors_equal_reference(
            self, indexed_bam, indexed_vcf):
        ref = ref_serve.ServeDaemon()
        port = serve_mod.ServeDaemon(device="cpu")
        calls = [("POST", "/serve/register", {"name": "r",
                                              "path": indexed_bam}),
                 ("POST", "/serve/register", {"name": "r",
                                              "path": indexed_bam}),
                 ("POST", "/serve/register", {"name": "v",
                                              "path": indexed_vcf}),
                 ("POST", "/serve/register", {"name": "x"}),
                 ("POST", "/serve/register", {"path": indexed_bam + ".no"}),
                 ("POST", "/query/reads", _q(*REGIONS[0], dataset="nope")),
                 ("POST", "/query/reads", {"tenant": "x"}),
                 ("POST", "/query/stats", _q(*REGIONS[0], dataset="r",
                                             stat="bogus")),
                 ("POST", "/query/variants", _q(*REGIONS[0], dataset="r")),
                 ("POST", "/query/nope", {}),
                 ("GET", "/query/reads", {})]
        for method, path, doc in calls:
            assert port.handle(method, path, dict(doc)) == \
                ref.handle(method, path, dict(doc)), (method, path, doc)
        assert port.cachemap({})["epochs"] == ref.cachemap({})["epochs"]

    def test_admission_shed_sequence_equals_reference(self):
        def drive(mod):
            adm = mod.TenantAdmission(slots=2, queue_depth=0)
            out = []
            for op, tenant in [("a", "x"), ("a", "x"), ("a", "x"),
                               ("a", "y"), ("r", "x"), ("a", "x"),
                               ("a", "x"), ("r", "y"), ("a", "y"),
                               ("a", "y"), ("a", "y")]:
                if op == "r":
                    adm.release(tenant)
                    continue
                try:
                    adm.acquire(tenant)
                    out.append("admit")
                except mod.AdmissionShed as e:
                    out.append(f"shed: {e.reason}")
            st = adm.stats()
            return out, {t: (v["active"], v["queued"])
                         for t, v in st["tenants"].items()}

        assert drive(serve_mod) == drive(ref_serve)

    def test_digest_buckets_equal_reference(self):
        rng = np.random.default_rng(9)
        for _ in range(200):
            cb = int(rng.integers(0, 1 << 40))
            ce = cb + int(rng.integers(0, 1 << 36))
            assert serve_mod.digest_buckets(cb, ce) == \
                ref_serve.digest_buckets(cb, ce)


# -- the device routes on the CPU ---------------------------------------------


def _counting(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls


class TestRoutes:
    def test_daemon_resolves_cuda_and_raises_without_it(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_mod.ServeDaemon()
        d = serve_mod.ServeDaemon(device="cpu")
        assert d.device.type == "cpu" and not d.device_route

    def test_per_request_route_one_b1_batch_per_missing_request(
            self, indexed_bam, indexed_vcf, reference_answers, monkeypatch):
        from disq_tpu_torch.ops import inflate_simd as B1

        monkeypatch.delenv("DISQ_TPU_TORCH_DEVICE_SERVICE", raising=False)
        plain = _counting(monkeypatch, B1, "inflate_plain")
        d = _port_daemon(indexed_bam, indexed_vcf, resident_decode=True)
        missed = _counting(monkeypatch, d, "_inflate_pending")
        lanes0 = B1.last_stats["device_lanes"]
        multi = _sequence()[1]
        status, body = d.handle("POST", *multi)
        assert (status, body) == reference_answers[0][1]
        # two intervals, their chunks' blocks in one launch
        assert len(plain) == len(missed) == 1
        assert B1.last_stats["device_lanes"] > lanes0
        assert d.handle("POST", *multi) == (status, body)
        assert len(plain) == 1  # hot: the parsed tier answers

    @pytest.mark.parametrize("route", ["service", "legacy"])
    def test_service_and_legacy_routes_equal_host(
            self, indexed_bam, indexed_vcf, reference_answers, monkeypatch,
            route):
        from disq_tpu_torch.ops import inflate as B4
        from disq_tpu_torch.ops import inflate_simd as B1
        from disq_tpu_torch.runtime import device_service

        if route == "service":
            monkeypatch.setenv("DISQ_TPU_TORCH_DEVICE_SERVICE", "1")
            plain = _counting(monkeypatch, B1, "inflate_plain")
        else:
            monkeypatch.setenv("DISQ_TPU_TORCH_DEVICE_INFLATE", "legacy")
            plain = _counting(monkeypatch, B4, "inflate_stacked_plain")
        b1 = _counting(monkeypatch, B1, "launch_payloads")
        d = _port_daemon(indexed_bam, indexed_vcf, resident_decode=True)
        try:
            seq = _sequence()
            for i in (0, 1, 10):
                assert d.handle("POST", seq[i][0], dict(seq[i][1])) == \
                    reference_answers[0][i]
        finally:
            device_service.shutdown_service()
        assert plain
        if route == "legacy":
            assert not b1

    @pytest.mark.parametrize("route", ["b1", "service", "legacy"])
    def test_corrupt_payload_answers_500_without_host_decode(
            self, indexed_bam, tmp_path, monkeypatch, route):
        from disq_tpu_torch.runtime import counters, device_service

        monkeypatch.delenv("DISQ_TPU_TORCH_DEVICE_SERVICE", raising=False)
        if route == "service":
            monkeypatch.setenv("DISQ_TPU_TORCH_DEVICE_SERVICE", "1")
        elif route == "legacy":
            monkeypatch.setenv("DISQ_TPU_TORCH_DEVICE_INFLATE", "legacy")

        data = bytearray(open(indexed_bam, "rb").read())
        hdr_end = 18 + int.from_bytes(data[16:18], "little") + 1
        data[hdr_end + 200] ^= 0x5A  # inside the second block's payload
        bad = str(tmp_path / "bad.bam")
        with open(bad, "wb") as f:
            f.write(bytes(data))
        with open(indexed_bam + ".bai", "rb") as f:
            bai = f.read()
        with open(bad + ".bai", "wb") as f:
            f.write(bai)
        d = serve_mod.ServeDaemon(device="cpu", resident_decode=True)
        d.register("bad", bad)
        ds = d._datasets["bad"]
        d.indexes.get(ds.fs, ds.path, d._build_bam_meta)  # header, BAI
        zlib_calls = _counting(monkeypatch, serve_mod.zlib, "decompress")
        before = counters.snapshot()["host_fallback_blocks"]
        try:
            status, out = d.handle("POST", "/query/reads",
                                   _q("chr1", 1, 249_000_000, dataset="bad"))
        finally:
            device_service.shutdown_service()
        assert status == 500
        assert out["error"].startswith("CorruptBlockError")
        assert "block_offset=" in out["error"]
        assert not zlib_calls
        assert counters.snapshot()["host_fallback_blocks"] == before
        assert counter("serve.request.errors").value(
            endpoint="reads", tenant="t0") >= 1

    def test_f1_plain_count_equals_host_mask(self, indexed_bam):
        from disq_tpu_torch.ops import rfilter

        host = serve_mod.ServeDaemon(device="cpu")
        dev = serve_mod.ServeDaemon(device="cpu", resident_decode=True)
        for d in (host, dev):
            d.register("reads", indexed_bam)
        for spec in ("-F 0x904 -q 20 -s 7.5", "-f 0x40 -q 30", "-s 3.25"):
            doc = _q("chr1", 1, 249_000_000, filter=spec)
            a, b = host.handle("POST", "/query/filtered-count", dict(doc)), \
                dev.handle("POST", "/query/filtered-count", dict(doc))
            assert a == b and a[0] == 200
            _, batch, _ = host._read_batch(host._datasets["reads"],
                                           host._parse_intervals(doc), "t")
            rf = rfilter.parse_read_filter(spec)
            nh = rfilter.name_hashes_from_columns(batch.names,
                                                  batch.name_offsets)
            want = int(rfilter.host_mask(rf, batch.flag, batch.mapq,
                                         nh).sum())
            assert a[1]["matched"] == want


def test_serve_script_serves_and_stops_on_sigterm(indexed_bam):
    """``scripts/torch_serve.py --device cpu`` names its address on its
    first line, answers a query, and exits 0 on SIGTERM."""
    import signal
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(repo, "scripts", "torch_serve.py"),
         "--device", "cpu", "--port", "0", "--dataset", f"d={indexed_bam}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()
        assert first.startswith("serving on http://"), first
        addr = first.split()[2][len("http://"):]
        status, out = _post(addr, "/query/reads",
                            _q(*REGIONS[1], dataset="d"))
        assert status == 200
        assert out["count"] == _truth_count(indexed_bam, *REGIONS[1])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("host_rescue", [True, False])
def test_service_submission_without_host_rescue_fails_flagged_lane(
        monkeypatch, host_rescue):
    """A lane B1 flags on valid data is decoded again on the host for a
    read's submission, and fails for the serving plane's
    (``host_rescue=False``): no host bytes reach a request."""
    import zlib

    from disq_tpu_torch.ops import inflate_simd as B1
    from disq_tpu_torch.runtime import device_service as DS

    real = B1.inflate

    def flag_third(*args):
        out, out_len, status = real(*args)
        status[3] = 3
        return out, out_len, status

    monkeypatch.setattr(B1, "inflate", flag_third)
    rng = np.random.default_rng(8)
    raws = [bytes(rng.integers(65, 70, 120 + 9 * i, dtype=np.uint8))
            for i in range(6)]
    comps = []
    for r in raws:
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        comps.append(c.compress(r) + c.flush())
    before = dict(B1.last_stats)
    svc = DS.DeviceDecodeService("cpu", flush_timeout_s=30.0)
    try:
        sub = svc.submit_inflate(comps, [len(r) for r in raws],
                                 host_rescue=host_rescue)
    finally:
        svc.close()
    (blob, offsets), errors = sub.outcome(timeout=60)
    rescued = B1.last_stats["host_fallback"] - before["host_fallback"]
    if host_rescue:
        assert not errors and rescued == 1
        assert blob.tobytes() == b"".join(raws)
    else:
        assert list(errors) == [3] and rescued == 0
        assert "status 3" in str(errors[3])
        for i in (0, 1, 2, 4, 5):
            assert blob[offsets[i]: offsets[i + 1]].tobytes() == raws[i]
