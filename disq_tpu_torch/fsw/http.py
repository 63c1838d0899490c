"""HTTP range-read filesystem wrapper — the remote FSW.

Counterpart of ``disq_tpu/fsw/http.py`` (disq's
``HadoopFileSystemWrapper`` remote role: gs://, s3a:// and hdfs:// URIs
behind the same interface). It speaks plain HTTP/1.1 range requests,
the wire protocol every blob store exposes:

- ``http(s)://`` — used directly.
- ``gs://bucket/key`` — ``https://storage.googleapis.com/bucket/key``
  (public objects / anonymous access; authenticated access installs a
  wrapper through ``register_filesystem``).
- ``s3://bucket/key`` — ``https://bucket.s3.amazonaws.com/key``.

Reads are served from a block cache of fixed-size ranges with an
**async prefetch** of the next block on every cache miss, so a
sequential scan (the BamSource staging pattern) always has the next
range in flight while the current one decodes. The wrapper's ``stats``
(range_requests / bytes_fetched / prefetch_issued / prefetch_hits /
cache_hits / cache_misses / cache_evictions) makes the staging
behavior observable and testable; the same events feed the telemetry
registry (``fsw.http.cache.*`` counters and the
``fsw.http.range_get`` latency histogram).

Writes are not supported (the reference writes through Hadoop's
committer; our sinks stage locally and upload out-of-band).
"""

from __future__ import annotations

import io
import os
import threading
import urllib.error
import urllib.request
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import BinaryIO, List, Optional, Tuple

from disq_tpu_torch.fsw.filesystem import FileSystemWrapper
from disq_tpu_torch.runtime.tracing import counter as _counter
from disq_tpu_torch.runtime.tracing import (
    inject_trace_headers as _inject_trace_headers)
from disq_tpu_torch.runtime.tracing import observe_gauge as _observe_gauge
from disq_tpu_torch.runtime.tracing import span as _span

DEFAULT_BLOCK = 4 * 1024 * 1024
DEFAULT_CACHED_BLOCKS = 32

# Process-wide cache-capacity override installed by
# ``configure_cache_blocks`` (DisqOptions.http_cache_blocks): applied
# to every registered wrapper AND to wrappers constructed later.
_configured_cache_blocks: Optional[int] = None


def _default_cache_blocks() -> int:
    """Capacity resolution for a wrapper built without an explicit
    ``max_cached_blocks``: the options-installed override, then
    ``DISQ_TPU_TORCH_HTTP_CACHE_BLOCKS``, then the built-in 32."""
    if _configured_cache_blocks is not None:
        return _configured_cache_blocks
    raw = os.environ.get("DISQ_TPU_TORCH_HTTP_CACHE_BLOCKS")
    if raw:
        try:
            n = int(raw)
            if n >= 1:
                return n
        except ValueError:
            pass
    return DEFAULT_CACHED_BLOCKS


def configure_cache_blocks(n: int) -> None:
    """Size the HTTP block-LRU process-wide (``DisqOptions.
    http_cache_blocks`` plumbing): updates every registered HTTP
    wrapper (including ones wrapped by the fault injector) and becomes
    the default for wrappers constructed later."""
    global _configured_cache_blocks
    n = int(n)
    if n < 1:
        raise ValueError(f"http cache capacity must be >= 1, got {n}")
    _configured_cache_blocks = n
    from disq_tpu_torch.fsw import filesystem

    for fs in list(filesystem._SCHEME_REGISTRY.values()):
        inner = getattr(fs, "inner", fs)
        if isinstance(inner, HttpFileSystemWrapper):
            inner.set_max_cached_blocks(n)


def rewrite_remote_uri(path: str) -> str:
    """gs:// and s3:// → their public HTTP endpoints."""
    if path.startswith("gs://"):
        return "https://storage.googleapis.com/" + path[len("gs://"):]
    if path.startswith("s3://"):
        bucket, _, key = path[len("s3://"):].partition("/")
        return f"https://{bucket}.s3.amazonaws.com/{key}"
    return path


class _Stats:
    __slots__ = ("range_requests", "bytes_fetched", "prefetch_hits",
                 "prefetch_issued", "retries", "cache_hits",
                 "cache_misses", "cache_evictions")

    def __init__(self) -> None:
        self.range_requests = 0
        self.bytes_fetched = 0
        self.prefetch_hits = 0
        self.prefetch_issued = 0
        self.retries = 0
        # Block-LRU efficacy (mirrored as fsw.http.cache.* telemetry
        # counters): a hit is a ``_block`` call served from cached
        # bytes or a completed prefetch; a miss pays an inline fetch;
        # an eviction drops one completed block from the LRU head.
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_evictions = 0


class HttpFileSystemWrapper(FileSystemWrapper):
    """Read-only remote FSW over HTTP range requests."""

    def __init__(self, block_size: int = DEFAULT_BLOCK,
                 prefetch: bool = True,
                 max_cached_blocks: Optional[int] = None) -> None:
        self.block_size = block_size
        self.prefetch = prefetch
        # None ⇒ DisqOptions.http_cache_blocks override, then the
        # DISQ_TPU_TORCH_HTTP_CACHE_BLOCKS env knob, then 32 — operators
        # size the LRU to the workload, reading occupancy off the
        # fsw.http.cache.blocks gauge.
        self.max_cached_blocks = (int(max_cached_blocks)
                                  if max_cached_blocks is not None
                                  else _default_cache_blocks())
        self.stats = _Stats()
        # canonical disq-* thread naming, by which py-spy and the
        # reference's sampling profiler attribute samples
        self._pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="disq-http-prefetch")
        self._lock = threading.Lock()
        # (url, block_index) -> bytes or in-flight Future; LRU-bounded
        # (the wrapper is process-global via the scheme registry, so an
        # unbounded cache would retain a whole remote file)
        self._cache: "OrderedDict[Tuple[str, int], object]" = OrderedDict()
        self._lengths: dict = {}

    def set_max_cached_blocks(self, n: int) -> None:
        """Resize the block LRU; shrinking trims completed blocks from
        the LRU head immediately (in-flight prefetches are never
        dropped, exactly like steady-state eviction)."""
        n = int(n)
        if n < 1:
            raise ValueError(f"http cache capacity must be >= 1, got {n}")
        with self._lock:
            self.max_cached_blocks = n
            for old_key in list(self._cache):
                if len(self._cache) <= n:
                    break
                old = self._cache[old_key]
                if isinstance(old, Future) and not old.done():
                    continue
                self._cache.pop(old_key)
                self.stats.cache_evictions += 1
                _counter("fsw.http.cache.evictions").inc()
            _observe_gauge("fsw.http.cache.blocks", len(self._cache))

    def cached_block_indices(self, path: str) -> List[int]:
        """The completed block indices this cache holds for ``path``: the
        occupancy a locality-aware scheduler places shards by (the
        reference's ``runtime/scheduler.py``; not ported yet)."""
        url = rewrite_remote_uri(path)
        with self._lock:
            return sorted(idx for (u, idx), v in self._cache.items()
                          if u == url and isinstance(v, bytes))

    def cached_block_ranges(self, path: str) -> List[Tuple[int, int]]:
        """Coalesced ``(lo, hi)`` byte ranges of the completed blocks
        this cache holds for ``path``: :meth:`cached_block_indices` as
        ``(path, coffset range)``, adjacent blocks merged so a warm
        contiguous region reads as one range."""
        ranges: List[Tuple[int, int]] = []
        for idx in self.cached_block_indices(path):
            lo = idx * self.block_size
            hi = lo + self.block_size
            if ranges and ranges[-1][1] == lo:
                ranges[-1] = (ranges[-1][0], hi)
            else:
                ranges.append((lo, hi))
        return ranges

    def _cache_put(self, key, value) -> None:
        # caller holds self._lock
        self._cache[key] = value
        self._cache.move_to_end(key)
        if len(self._cache) <= self.max_cached_blocks:
            _observe_gauge("fsw.http.cache.blocks", len(self._cache))
            return
        # Evict from the LRU head, *skipping* (never dropping) in-flight
        # prefetches: an in-flight Future at the head must not shield
        # completed blocks behind it from eviction, or the cache grows
        # past max_cached_blocks for as long as fetches stall.
        for old_key in list(self._cache):
            if len(self._cache) <= self.max_cached_blocks:
                break
            if old_key == key:
                # With everything older in flight, the walk reaches the
                # entry just inserted — evicting it would refetch the
                # block on the very next read. Let the cache run over by
                # the in-flight count instead.
                continue
            old = self._cache[old_key]
            if isinstance(old, Future) and not old.done():
                continue  # never drop an in-flight prefetch
            self._cache.pop(old_key)
            self.stats.cache_evictions += 1
            _counter("fsw.http.cache.evictions").inc()
        _observe_gauge("fsw.http.cache.blocks", len(self._cache))

    # -- plumbing ----------------------------------------------------------

    _RETRIES = 3          # transient-failure retries (5xx / network)
    _BACKOFF_S = 0.1      # doubled per attempt
    _TIMEOUT_S = 60.0     # per-request; a stalled connection must fail
                          # into the retry loop, not hang a worker

    def _retrying(self, op):
        """Run ``op()`` under the read stack's shared transient
        classification and bounded backoff (``runtime.errors.
        ShardRetrier`` / ``is_transient``) — one definition of
        "transient", shared by ranged GETs and HEADs. Client errors
        (4xx) raise at once; 5xx, network errors and stalls back off and
        retry; the last transient error surfaces once the budget is
        spent.

        With breakers armed (``DisqOptions.breaker_window``), every
        request is gated by the ``http`` filesystem's circuit breaker: a
        fault storm opens it, and later requests fail fast with
        ``BreakerOpenError``. Each retry draws from the shared retry
        budget when one is installed."""
        from disq_tpu_torch.runtime.errors import ShardRetrier
        from disq_tpu_torch.runtime.resilience import breaker_for

        retrier = ShardRetrier(self._RETRIES, self._BACKOFF_S,
                               breaker=breaker_for("http://"))
        try:
            return retrier.call(op, what="http")
        finally:
            if retrier.retried:
                with self._lock:
                    self.stats.retries += retrier.retried

    # A server that ignores Range replies 200 with the body from byte 0;
    # bytes up to ``end_incl`` must be read regardless (HTTP streams
    # can't seek) but everything past it is pure slack — read at most
    # this many blocks of it (they seed the cache), then abandon the
    # connection instead of buffering a possibly-multi-GB object on
    # every attempt.
    _FULL_READ_SLACK_BLOCKS = 32

    def _fetch(self, url: str, start: int, end_incl: int) -> bytes:
        """One ranged GET via ``_retrying``. A server ignoring Range
        (200 with the whole object) is stream-read to a bounded prefix
        — the requested range plus ``_FULL_READ_SLACK_BLOCKS`` blocks —
        sliced, accounted at its REAL transfer size, and seeds the
        block cache so a scan doesn't re-download the object per
        block."""
        def ranged_get():
            req = urllib.request.Request(
                url, headers=_inject_trace_headers(
                    {"Range": f"bytes={start}-{end_incl}"}))
            with urllib.request.urlopen(
                    req, timeout=self._TIMEOUT_S) as resp:
                if resp.status != 200:  # 206: the server honored Range
                    return resp.read(), None
                cap = (end_incl + 1
                       + self._FULL_READ_SLACK_BLOCKS * self.block_size)
                chunks: List[bytes] = []
                got = 0
                while got < cap:
                    chunk = resp.read(min(1 << 20, cap - got))
                    if not chunk:
                        break
                    chunks.append(chunk)
                    got += len(chunk)
                full = b"".join(chunks)
                return full[start: end_incl + 1], full

        with _span("fsw.http.range_get", start=start, end=end_incl):
            data, full = self._retrying(ranged_get)
        if full is not None:
            bs = self.block_size
            want = start // bs
            total = self._lengths.get(url)
            with self._lock:
                self.stats.range_requests += 1
                self.stats.bytes_fetched += len(full)
                for bi in range((len(full) + bs - 1) // bs):
                    blk = full[bi * bs: (bi + 1) * bs]
                    # Only complete blocks may seed the cache: the
                    # capped prefix can end mid-block, and a short
                    # cached block would silently truncate later reads.
                    complete = len(blk) == bs or (
                        total is not None and (bi + 1) * bs >= total)
                    if bi != want and complete:
                        self._cache_put((url, bi), blk)
                # the requested block last, so LRU keeps it
                want_blk = full[want * bs: (want + 1) * bs]
                if len(want_blk) == bs or (
                        total is not None and (want + 1) * bs >= total):
                    self._cache_put((url, want), want_blk)
        else:
            with self._lock:
                self.stats.range_requests += 1
                self.stats.bytes_fetched += len(data)
        return data

    def _block(self, url: str, idx: int, length: int) -> bytes:
        key = (url, idx)
        with self._lock:
            entry = self._cache.get(key)
            if entry is not None:
                self._cache.move_to_end(key)
        if isinstance(entry, bytes):
            with self._lock:
                self.stats.cache_hits += 1
            _counter("fsw.http.cache.hits").inc()
            return entry
        if isinstance(entry, Future):
            try:
                data = entry.result()
            except Exception:
                # transient prefetch failure must not poison the block:
                # drop the future and fetch inline (which may raise a
                # fresh, retryable error)
                with self._lock:
                    if self._cache.get(key) is entry:
                        self._cache.pop(key)
                entry = None
            else:
                with self._lock:
                    self._cache_put(key, data)
                    self.stats.prefetch_hits += 1
                    self.stats.cache_hits += 1
                _counter("fsw.http.cache.hits").inc()
                return data
        with self._lock:
            self.stats.cache_misses += 1
        _counter("fsw.http.cache.misses").inc()
        start = idx * self.block_size
        end = min(start + self.block_size, length) - 1
        data = self._fetch(url, start, end)
        with self._lock:
            self._cache_put(key, data)
        # async prefetch of the NEXT block while the caller decodes
        nxt = idx + 1
        if self.prefetch and nxt * self.block_size < length:
            nkey = (url, nxt)
            with self._lock:
                if nkey not in self._cache:
                    ns = nxt * self.block_size
                    ne = min(ns + self.block_size, length) - 1
                    self._cache_put(nkey, self._pool.submit(
                        self._fetch, url, ns, ne))
                    self.stats.prefetch_issued += 1
        return data

    # -- FileSystemWrapper interface --------------------------------------

    def exists(self, path: str) -> bool:
        """HEAD through the same ``_retrying`` timeout + transient-retry
        discipline as ``_fetch``: a stalled or 5xx HEAD must not hang a
        worker or misreport a live object as missing."""
        url = rewrite_remote_uri(path)
        req = urllib.request.Request(
            url, headers=_inject_trace_headers({}), method="HEAD")

        def head():
            with urllib.request.urlopen(
                    req, timeout=self._TIMEOUT_S) as resp:
                return resp.headers.get("Content-Length")

        try:
            clen = self._retrying(head)
        except urllib.error.HTTPError as e:
            # S3 answers 403 for missing keys without list permission
            if e.code in (403, 404):
                return False
            raise
        if clen is None:
            # a length-less HEAD would make every read clamp to b"" — a
            # deterministic protocol defect, not transient: fail loudly
            raise IOError(
                f"HEAD {url} returned no Content-Length; "
                "range staging needs a sized object")
        self._lengths[url] = int(clen)
        return True

    def get_file_length(self, path: str) -> int:
        url = rewrite_remote_uri(path)
        if url not in self._lengths:
            if not self.exists(path):
                raise FileNotFoundError(path)
        return self._lengths[url]

    def read_range(self, path: str, start: int, length: int) -> bytes:
        url = rewrite_remote_uri(path)
        total = self.get_file_length(path)
        end = min(start + length, total)
        if end <= start:
            return b""
        first = start // self.block_size
        last = (end - 1) // self.block_size
        parts: List[bytes] = []
        for idx in range(first, last + 1):
            blk = self._block(url, idx, total)
            lo = max(start - idx * self.block_size, 0)
            hi = min(end - idx * self.block_size, len(blk))
            parts.append(blk[lo:hi])
        return b"".join(parts)

    def open(self, path: str) -> BinaryIO:
        return _HttpReader(self, path)

    def create(self, path: str) -> BinaryIO:
        raise NotImplementedError(
            "remote HTTP filesystem is read-only; sinks stage locally")

    def list_directory(self, path: str) -> List[str]:
        raise NotImplementedError(
            "HTTP has no directory listing; pass explicit object paths")

    def is_directory(self, path: str) -> bool:
        return False

    def delete(self, path: str, recursive: bool = False) -> None:
        raise NotImplementedError("remote HTTP filesystem is read-only")

    def mkdirs(self, path: str) -> None:
        raise NotImplementedError("remote HTTP filesystem is read-only")


class _HttpReader(io.RawIOBase):
    """Seekable read stream over the block cache (htsjdk-style usage:
    seek to a virtual offset's coffset, stream forward)."""

    def __init__(self, fs: HttpFileSystemWrapper, path: str) -> None:
        self._fs = fs
        self._path = path
        self._pos = 0
        self._len = fs.get_file_length(path)

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = pos
        elif whence == 1:
            self._pos += pos
        else:
            self._pos = self._len + pos
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = self._len - self._pos
        data = self._fs.read_range(self._path, self._pos, n)
        self._pos += len(data)
        return data

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)
