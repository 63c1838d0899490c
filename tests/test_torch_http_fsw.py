"""The port's remote filesystem (``fsw/http.py``) against an in-process
HTTP server on 127.0.0.1, never the network: the 20 cases of the
reference's ``tests/test_http_fsw.py`` run on the port (range reads and
prefetch, the block LRU and its counters, transient retries, servers
that ignore Range, HEAD retries, eviction around in-flight prefetches,
the cache-size knob and the occupancy signal), plus the remote read end
to end on the host and the device route (``resident_decode`` on the
CPU) column for column against the port's local read and ``disq_tpu``'s,
the gs:// and s3:// dispatch through ``rewrite_remote_uri``, and the
trace headers on every ranged GET.
"""

import os
import threading
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
import disq_tpu.api as R
import disq_tpu_torch as P
from disq_tpu_torch.fsw import filesystem
from disq_tpu_torch.fsw import http as http_mod
from disq_tpu_torch.fsw.filesystem import resolve_path
from disq_tpu_torch.fsw.http import HttpFileSystemWrapper, rewrite_remote_uri
from disq_tpu_torch.runtime import tracing
from disq_tpu_torch.runtime.columnar import ColumnarBatch
from disq_tpu_torch.runtime.errors import DisqOptions
from disq_tpu_torch.runtime.executor import executor_for_storage
from disq_tpu_torch.runtime.tracing import REGISTRY, counter

COLUMNS = ("refid", "pos", "mapq", "bin", "flag", "next_refid", "next_pos",
           "tlen", "name_offsets", "names", "cigar_offsets", "cigars",
           "seq_offsets", "seqs", "quals", "tag_offsets", "tags")


class _RangeHandler(BaseHTTPRequestHandler):
    files = {}
    headers_seen = []

    def log_message(self, *a):
        pass

    def do_HEAD(self):
        data = self.files.get(self.path)
        if data is None:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()

    def do_GET(self):
        self.headers_seen.append(dict(self.headers))
        data = self.files.get(self.path)
        if data is None:
            self.send_error(404)
            return
        rng = self.headers.get("Range")
        if rng and rng.startswith("bytes="):
            lo, hi = rng[len("bytes="):].split("-")
            lo, hi = int(lo), min(int(hi), len(data) - 1)
            body = data[lo: hi + 1]
            self.send_response(206)
            self.send_header(
                "Content-Range", f"bytes {lo}-{hi}/{len(data)}")
        else:
            body = data
            self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _serve(handler_cls):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler_cls)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def http_server():
    srv = _serve(_RangeHandler)
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def bam_url(http_server):
    raw = make_bam_bytes(DEFAULT_REFS, synth_records(2500, seed=21))
    _RangeHandler.files["/remote.bam"] = raw
    return http_server + "/remote.bam", raw


@pytest.fixture(autouse=True)
def _isolate_registry(monkeypatch):
    """Each test runs with a scheme registry of its own holding no remote
    wrapper, and no configured cache size; both are restored after."""
    monkeypatch.setattr(filesystem, "_SCHEME_REGISTRY", {
        k: v for k, v in filesystem._SCHEME_REGISTRY.items()
        if k not in ("http", "https", "gs", "s3")})
    monkeypatch.setattr(http_mod, "_configured_cache_blocks", None)


def _assert_same(got, want):
    assert got.count == want.count
    for col in COLUMNS:
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col),
                                      err_msg=col)


def test_uri_rewrites():
    assert rewrite_remote_uri("gs://bkt/a/b.bam") == (
        "https://storage.googleapis.com/bkt/a/b.bam")
    assert rewrite_remote_uri("s3://bkt/a/b.bam") == (
        "https://bkt.s3.amazonaws.com/a/b.bam")
    assert rewrite_remote_uri("http://x/y") == "http://x/y"


def test_scheme_dispatch_resolves_remote():
    seen = {}
    for scheme in ("http", "https", "gs", "s3"):
        fs, p = resolve_path(f"{scheme}://bucket/key.bam")
        assert isinstance(fs, HttpFileSystemWrapper)
        assert p == f"{scheme}://bucket/key.bam"
        seen[scheme] = fs
        # one registered wrapper per scheme
        assert resolve_path(f"{scheme}://other/x.bam")[0] is fs
    assert len({id(fs) for fs in seen.values()}) == 4
    assert filesystem.get_filesystem("gs://b/k") is seen["gs"]
    with pytest.raises(ValueError, match="scheme 'hdfs'"):
        resolve_path("hdfs://nn/x.bam")


def test_range_reads_and_prefetch(bam_url):
    url, raw = bam_url
    fs = HttpFileSystemWrapper(block_size=32 * 1024)
    assert fs.exists(url)
    assert not fs.exists(url + ".nope")
    assert fs.get_file_length(url) == len(raw)
    assert fs.read_range(url, 30_000, 40_000) == raw[30_000:70_000]
    with fs.open(url) as f:
        f.seek(1000)
        assert f.read(5000) == raw[1000:6000]
    assert fs.stats.range_requests > 0
    assert fs.stats.prefetch_issued > 0
    assert fs.stats.cache_misses > 0
    before = fs.stats.range_requests
    hits_before = fs.stats.cache_hits
    assert fs.read_range(url, 30_000, 40_000) == raw[30_000:70_000]
    assert fs.stats.range_requests == before
    assert fs.stats.cache_hits > hits_before
    assert counter("fsw.http.cache.hits").total() >= fs.stats.cache_hits
    assert counter("fsw.http.cache.misses").total() >= fs.stats.cache_misses


def test_lru_eviction_counted(bam_url):
    url, raw = bam_url
    fs = HttpFileSystemWrapper(
        block_size=16 * 1024, prefetch=False, max_cached_blocks=2)
    assert fs.exists(url)
    fs.read_range(url, 0, 16 * 1024 * 6)  # 6 blocks through a 2-slot LRU
    assert fs.stats.cache_evictions >= 4
    assert fs.stats.cache_misses >= 6
    assert counter("fsw.http.cache.evictions").total() >= 4


@pytest.mark.parametrize("route", ["host", "resident"])
def test_bam_source_end_to_end_over_http(bam_url, tmp_path, route):
    url, raw = bam_url
    local = tmp_path / "local.bam"
    local.write_bytes(raw)

    def storage():
        st = P.ReadsStorage.make_default(device="cpu").split_size(65536)
        return st.resident_decode() if route == "resident" else st

    host = storage().read(str(local))
    remote = storage().read(url)
    ref = R.ReadsStorage.make_default().split_size(65536).read(str(local))
    assert remote.count() == host.count() == ref.count() == 2500
    if route == "resident":
        assert isinstance(remote.reads, ColumnarBatch)
        assert remote.reads.device_backed
    _assert_same(remote.reads, host.reads)
    _assert_same(remote.reads, ref.reads)
    assert remote.counters.as_dict() == host.counters.as_dict() | {
        "wall_seconds": remote.counters.wall_seconds}


def test_gs_and_s3_reads_resolve_through_the_rewrite(bam_url, monkeypatch):
    url, raw = bam_url
    base = url.rsplit("/", 1)[0]
    asked = []

    def rewrite(path):
        asked.append(path)
        return base + "/" + path.split("/", 3)[3]

    want = P.ReadsStorage.make_default(device="cpu").split_size(65536) \
        .read(url)
    monkeypatch.setattr(http_mod, "rewrite_remote_uri", rewrite)
    for scheme in ("gs", "s3"):
        ds = P.ReadsStorage.make_default(device="cpu").split_size(65536) \
            .read(f"{scheme}://bucket/remote.bam")
        assert isinstance(filesystem._SCHEME_REGISTRY[scheme],
                          HttpFileSystemWrapper)
        _assert_same(ds.reads, want.reads)
    assert {p.split("://")[0] for p in asked} == {"gs", "s3"}


def test_remote_write_rejected(http_server, bam_url):
    fs = HttpFileSystemWrapper()
    with pytest.raises(NotImplementedError, match="read-only"):
        fs.create(http_server + "/out.bam")
    ds = P.ReadsStorage.make_default(device="cpu").read(bam_url[0])
    with pytest.raises(NotImplementedError, match="read-only"):
        P.ReadsStorage.make_default(device="cpu").write(
            ds, http_server + "/out.bam")


def test_trace_headers_ride_on_ranged_gets(bam_url):
    url, raw = bam_url
    fs = HttpFileSystemWrapper(block_size=16 * 1024, prefetch=False)
    _RangeHandler.headers_seen.clear()
    fs.read_range(url, 0, 100)
    assert not any("X-Disq-Trace-Id" in h for h in _RangeHandler.headers_seen)
    ctx = tracing.TraceContext("t-123", "hop-1", "tenant-a")
    with tracing.trace_scope(ctx):
        fs.read_range(url, 40_000, 100)
    sent = _RangeHandler.headers_seen[-1]
    assert (sent["X-Disq-Trace-Id"], sent["X-Disq-Trace-Parent"],
            sent["X-Disq-Trace-Tenant"]) == ("t-123", "hop-1", "tenant-a")


class TestTransientRetry:
    def test_503_then_success_retries(self):
        payload = os.urandom(50_000)

        class Flaky(_RangeHandler):
            files = {"/f.bin": payload}
            fails = {"n": 2}

            def do_GET(self):
                if self.fails["n"] > 0:
                    self.fails["n"] -= 1
                    self.send_error(503)
                    return
                super().do_GET()

        srv = _serve(Flaky)
        try:
            fs = HttpFileSystemWrapper(block_size=16_384)
            fs._BACKOFF_S = 0.01
            url = f"http://127.0.0.1:{srv.server_address[1]}/f.bin"
            got = fs.read_range(url, 1000, 30_000)
            assert got == payload[1000:31_000]
            assert fs.stats.retries >= 2
        finally:
            srv.shutdown()
            srv.server_close()

    def test_404_fails_fast_no_retry(self):
        class GoneAfterHead(_RangeHandler):
            files = {}
            calls = {"n": 0}

            def do_GET(self):
                self.calls["n"] += 1
                self.send_error(404)

            def do_HEAD(self):
                self.send_response(200)
                self.send_header("Content-Length", "100000")
                self.send_header("Accept-Ranges", "bytes")
                self.end_headers()

        srv = _serve(GoneAfterHead)
        try:
            fs = HttpFileSystemWrapper(block_size=16_384, prefetch=False)
            fs._BACKOFF_S = 0.01
            url = f"http://127.0.0.1:{srv.server_address[1]}/nope"
            with pytest.raises(Exception):
                fs.read_range(url, 0, 10)
            assert GoneAfterHead.calls["n"] == 1  # no retry storm on 4xx
            assert fs.stats.retries == 0
        finally:
            srv.shutdown()
            srv.server_close()

    def test_range_ignoring_server_sliced(self):
        payload = os.urandom(40_000)

        class NoRange(_RangeHandler):
            files = {"/f.bin": payload}

            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        srv = _serve(NoRange)
        try:
            fs = HttpFileSystemWrapper(block_size=16_384)
            url = f"http://127.0.0.1:{srv.server_address[1]}/f.bin"
            assert fs.read_range(url, 5_000, 20_000) == payload[5_000:25_000]
        finally:
            srv.shutdown()
            srv.server_close()

    def test_range_ignoring_server_capped_read(self):
        payload = os.urandom(600_000)

        class NoRange(_RangeHandler):
            files = {"/big.bin": payload}

            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                try:
                    self.wfile.write(payload)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the client abandoned the capped stream

        srv = _serve(NoRange)
        try:
            fs = HttpFileSystemWrapper(block_size=4096, prefetch=False)
            fs._FULL_READ_SLACK_BLOCKS = 4
            url = f"http://127.0.0.1:{srv.server_address[1]}/big.bin"
            assert fs.read_range(url, 1000, 5000) == payload[1000:6000]
            assert fs.stats.bytes_fetched <= 2 * 4096 + 4 * 4096
            before = fs.stats.range_requests
            assert fs.read_range(url, 0, 4096) == payload[:4096]
            assert fs.stats.range_requests == before
            assert fs.read_range(url, 500_000, 1000) == \
                payload[500_000:501_000]
        finally:
            srv.shutdown()
            srv.server_close()

    def test_range_ignoring_server_downloads_once(self):
        payload = os.urandom(100_000)

        class NoRange(_RangeHandler):
            files = {"/f.bin": payload}
            gets = {"n": 0}

            def do_GET(self):
                self.gets["n"] += 1
                self.send_response(200)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        srv = _serve(NoRange)
        try:
            fs = HttpFileSystemWrapper(block_size=16_384, prefetch=False)
            url = f"http://127.0.0.1:{srv.server_address[1]}/f.bin"
            assert fs.read_range(url, 0, len(payload)) == payload
            assert NoRange.gets["n"] == 1
            assert fs.stats.bytes_fetched == len(payload)
        finally:
            srv.shutdown()
            srv.server_close()


class TestExistsRetry:
    def test_503_head_then_success(self):
        class FlakyHead(_RangeHandler):
            files = {"/f.bin": b"x" * 1000}
            fails = {"n": 2}

            def do_HEAD(self):
                if self.fails["n"] > 0:
                    self.fails["n"] -= 1
                    self.send_error(503)
                    return
                super().do_HEAD()

        srv = _serve(FlakyHead)
        try:
            fs = HttpFileSystemWrapper()
            fs._BACKOFF_S = 0.01
            url = f"http://127.0.0.1:{srv.server_address[1]}/f.bin"
            assert fs.exists(url) is True
            assert fs.stats.retries >= 2
            assert fs.get_file_length(url) == 1000
        finally:
            srv.shutdown()
            srv.server_close()

    def test_missing_key_no_retry(self):
        class Counting(_RangeHandler):
            files = {}
            heads = {"n": 0}

            def do_HEAD(self):
                self.heads["n"] += 1
                super().do_HEAD()

        srv = _serve(Counting)
        try:
            fs = HttpFileSystemWrapper()
            fs._BACKOFF_S = 0.01
            url = f"http://127.0.0.1:{srv.server_address[1]}/nope"
            assert fs.exists(url) is False
            assert Counting.heads["n"] == 1
            assert fs.stats.retries == 0
        finally:
            srv.shutdown()
            srv.server_close()

    def test_persistent_failure_raises_after_budget(self):
        class AlwaysDown(_RangeHandler):
            files = {}
            heads = {"n": 0}

            def do_HEAD(self):
                self.heads["n"] += 1
                self.send_error(503)

        srv = _serve(AlwaysDown)
        try:
            fs = HttpFileSystemWrapper()
            fs._BACKOFF_S = 0.01
            url = f"http://127.0.0.1:{srv.server_address[1]}/f"
            with pytest.raises(Exception):
                fs.exists(url)
            assert AlwaysDown.heads["n"] == fs._RETRIES + 1
        finally:
            srv.shutdown()
            srv.server_close()


class TestCacheEviction:
    def test_inflight_future_does_not_block_eviction(self):
        fs = HttpFileSystemWrapper(max_cached_blocks=4)
        stalled = Future()  # never completes
        with fs._lock:
            fs._cache_put(("u", 0), stalled)
            for i in range(1, 8):
                fs._cache_put(("u", i), b"data")
        assert len(fs._cache) <= fs.max_cached_blocks
        assert ("u", 0) in fs._cache
        stalled.cancel()

    def test_completed_future_is_evictable(self):
        fs = HttpFileSystemWrapper(max_cached_blocks=2)
        done = Future()
        done.set_result(b"done")
        with fs._lock:
            fs._cache_put(("u", 0), done)
            fs._cache_put(("u", 1), b"a")
            fs._cache_put(("u", 2), b"b")
        assert len(fs._cache) <= 2
        assert ("u", 0) not in fs._cache


class TestCacheSizeKnob:
    def test_env_knob_sizes_new_wrappers(self, monkeypatch):
        monkeypatch.setenv("DISQ_TPU_TORCH_HTTP_CACHE_BLOCKS", "7")
        assert HttpFileSystemWrapper().max_cached_blocks == 7
        monkeypatch.setenv("DISQ_TPU_TORCH_HTTP_CACHE_BLOCKS", "garbage")
        assert HttpFileSystemWrapper().max_cached_blocks == 32
        monkeypatch.delenv("DISQ_TPU_TORCH_HTTP_CACHE_BLOCKS")
        assert HttpFileSystemWrapper().max_cached_blocks == 32
        assert HttpFileSystemWrapper(max_cached_blocks=3) \
            .max_cached_blocks == 3

    def test_options_plumbing_resizes_registered_wrappers(
            self, monkeypatch, bam_url):
        url, raw = bam_url
        fs = HttpFileSystemWrapper(block_size=1024, max_cached_blocks=64)
        monkeypatch.setitem(filesystem._SCHEME_REGISTRY, "http", fs)
        fs.read_range(url, 0, 16 * 1024)  # fill > 4 blocks
        assert len(fs._cache) > 4

        class _Storage:
            _options = DisqOptions().with_http_cache_blocks(4)

        executor_for_storage(_Storage())
        assert fs.max_cached_blocks == 4
        assert len(fs._cache) <= 4 + 1  # an in-flight prefetch may overhang
        assert HttpFileSystemWrapper().max_cached_blocks == 4
        # ReadsStorage.http_cache_blocks sets the same option
        st = P.ReadsStorage.make_default(device="cpu").http_cache_blocks(9)
        assert st._options.http_cache_blocks == 9
        with pytest.raises(ValueError, match=">= 1"):
            P.ReadsStorage.make_default(device="cpu").http_cache_blocks(0)

    def test_occupancy_gauge_and_block_indices(self, bam_url):
        url, raw = bam_url
        fs = HttpFileSystemWrapper(block_size=1024, prefetch=False,
                                   max_cached_blocks=8)
        fs.read_range(url, 0, 2048)       # blocks 0, 1
        fs.read_range(url, 5 * 1024, 10)  # block 5
        assert fs.cached_block_indices(url) == [0, 1, 5]
        assert fs.cached_block_indices(url + ".other") == []
        state = REGISTRY.gauge("fsw.http.cache.blocks").state()
        assert state is not None and state["last"] >= 3

    def test_cached_block_ranges_coalesces_adjacent(self, bam_url):
        url, raw = bam_url
        fs = HttpFileSystemWrapper(block_size=1024, prefetch=False,
                                   max_cached_blocks=8)
        fs.read_range(url, 0, 2048)
        fs.read_range(url, 5 * 1024, 10)
        assert fs.cached_block_ranges(url) == [(0, 2048), (5120, 6144)]
        assert fs.cached_block_ranges(url + ".other") == []
