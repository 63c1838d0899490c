"""Serving plane: a long-lived multi-tenant interval-query daemon, the
counterpart of ``disq_tpu/runtime/serve.py``.

Many concurrent region queries over shared indexed files (a genome
browser or a cohort portal pulling the reads and calls of a locus):

- **Endpoints** ride the introspection HTTP plane
  (``runtime/introspect.py``): ``POST /query/reads``,
  ``POST /query/variants``, ``POST /query/stats``, the operator queries
  ``POST /query/markdup-stats`` / ``POST /query/pileup`` /
  ``POST /query/filtered-count``, ``GET /serve/stats``,
  ``GET /serve/cachemap`` (the cache-locality digest the fleet router in
  ``runtime/fleet.py`` consumes) and ``POST /serve/register``, all
  through :func:`handle_http`, which the handler resolves lazily.
- **Inflate on the daemon's device.** Every cache-missing BGZF block of a
  request is inflated in one batch. On ``cuda`` (or on the CPU with
  ``resident_decode``, through the kernels' plain versions) that batch
  is one launch of kernel B1 per request (``ops/inflate_simd.py``'s
  ``launch_payloads`` / ``fetch_payloads``), one of B4 under
  ``DISQ_TPU_TORCH_DEVICE_INFLATE=legacy``, or, with
  ``DISQ_TPU_TORCH_DEVICE_SERVICE=1``, one ``submit_inflate`` to the
  device service, whose dispatcher coalesces concurrent requests' lanes
  into shared B1 launches. Every decoded payload's CRC is checked; a
  flagged lane or a CRC mismatch raises ``CorruptBlockError`` naming the
  block (HTTP 500), and nothing is decoded again on the host. On the CPU
  without ``resident_decode`` the blocks go through host zlib, as the
  reference's host route.
- **Shared hot-block cache**: a process-wide LRU in three tiers keyed by
  ``(path, coffset)``: ``compressed`` (raw BGZF blocks), ``decoded``
  (inflated payloads) and ``parsed`` (decoded chunk batches keyed by
  virtual-offset chunk), with per-tenant byte accounting.
- **Per-tenant QoS**: concurrency slots plus a bounded wait queue per
  tenant; past that a request is shed with HTTP 429.
- **Index/header LRU** keyed ``(path, size, mtime)``.
- ``/query/filtered-count`` builds its keep mask with kernel F1
  (``ops/rfilter.py::build_mask``) on the device route, with
  ``host_mask`` on the host route; the count is the same.

Disabled path: no daemon, cache, admission state or thread exists until
:func:`start_serve` runs; :func:`serve_if_running` never creates one, and
:func:`handle_http` answers 503 without allocating. The daemon owns no
thread: requests run on the endpoint's request threads.
"""

from __future__ import annotations

import hashlib
import os
import struct
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from disq_tpu_torch.runtime.flightrec import record_event
from disq_tpu_torch.runtime.tracing import (
    TraceContext, activate_trace, counter, current_trace,
    deactivate_trace, gauge, histogram, mint_trace, record_span,
    trace_requests_enabled)

DEFAULT_TENANT = "anon"

# Cache budgets (bytes). Decoded payloads are ~3-4x the compressed
# blocks for genomic data, so the decoded tier gets more.
DEFAULT_COMPRESSED_CACHE_MB = 64
DEFAULT_DECODED_CACHE_MB = 128
DEFAULT_PARSED_CACHE_MB = 128
DEFAULT_TENANT_SLOTS = 4
DEFAULT_TENANT_QUEUE = 16
DEFAULT_INDEX_CACHE_ENTRIES = 16

_BGZF_FOOTER = 8

# Cache-locality digest granularity: one bucket per 64 KiB of compressed
# file offset. A BGZF block is at most 64 KiB, so a cached block lands in
# one or two buckets, and the fleet router's overlap score compares the
# same units as the cache books.
DIGEST_BUCKET_BITS = 16
# Bounded op log behind the incremental /serve/cachemap refresh; a router
# whose ``since`` scrolled off gets the full map.
DIGEST_LOG_CAP = 4096


def digest_buckets(cb: int, ce: int) -> Tuple[int, ...]:
    """Digest buckets covered by virtual-offset chunk ``[cb, ce)``, the
    same math for the cache (put/evict) and the fleet router (a query's
    chunks against replica digests)."""
    lo = (cb >> 16) >> DIGEST_BUCKET_BITS
    hi = max(lo, ((ce >> 16) >> DIGEST_BUCKET_BITS))
    return tuple(range(lo, hi + 1))


class AdmissionShed(Exception):
    """Request shed by per-tenant admission control (HTTP 429)."""

    def __init__(self, tenant: str, reason: str) -> None:
        super().__init__(f"tenant {tenant!r} shed: {reason}")
        self.tenant = tenant
        self.reason = reason


class TenantAdmission:
    """Per-tenant concurrency slots and a bounded wait queue.

    A tenant holds at most ``slots`` requests in flight; up to
    ``queue_depth`` more may wait for a slot; anything beyond is shed at
    once (the caller maps :class:`AdmissionShed` to 429). A queued wait
    is booked as a ``serve.admission.wait`` span.
    """

    def __init__(self, slots: int = DEFAULT_TENANT_SLOTS,
                 queue_depth: int = DEFAULT_TENANT_QUEUE,
                 wait_timeout_s: float = 30.0) -> None:
        if slots < 1:
            raise ValueError(f"tenant slots must be >= 1, got {slots}")
        if queue_depth < 0:
            raise ValueError(
                f"tenant queue depth must be >= 0, got {queue_depth}")
        self.slots = slots
        self.queue_depth = queue_depth
        self.wait_timeout_s = wait_timeout_s
        self._cond = threading.Condition()
        self._active: Dict[str, int] = {}
        self._queued: Dict[str, int] = {}
        # tenant -> enqueue times of the waiters still queued, so
        # /serve/stats reports head-of-line blocking before a timeout
        self._waiting: Dict[str, List[float]] = {}

    def acquire(self, tenant: str) -> None:
        adm = counter("serve.admission")
        with self._cond:
            if self._active.get(tenant, 0) < self.slots:
                self._active[tenant] = self._active.get(tenant, 0) + 1
                adm.inc(result="admit", tenant=tenant)
                return
            if self._queued.get(tenant, 0) >= self.queue_depth:
                adm.inc(result="shed", tenant=tenant)
                raise AdmissionShed(
                    tenant,
                    f"{self._active.get(tenant, 0)} active, "
                    f"{self._queued.get(tenant, 0)} queued")
            t0 = time.perf_counter()
            self._queued[tenant] = self._queued.get(tenant, 0) + 1
            self._waiting.setdefault(tenant, []).append(t0)
            adm.inc(result="queued", tenant=tenant)
            deadline = t0 + self.wait_timeout_s
            try:
                while self._active.get(tenant, 0) >= self.slots:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        adm.inc(result="shed", tenant=tenant)
                        raise AdmissionShed(tenant, "queue wait timeout")
                    self._cond.wait(remaining)
                self._active[tenant] = self._active.get(tenant, 0) + 1
            finally:
                self._queued[tenant] -= 1
                self._waiting[tenant].remove(t0)
                record_span("serve.admission.wait",
                            time.perf_counter() - t0, tenant=tenant)

    def release(self, tenant: str) -> None:
        with self._cond:
            self._active[tenant] = max(0, self._active.get(tenant, 0) - 1)
            self._cond.notify_all()

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            now = time.perf_counter()
            tenants = sorted(set(self._active) | set(self._queued))
            return {
                "slots": self.slots,
                "queue_depth": self.queue_depth,
                "tenants": {
                    t: {"active": self._active.get(t, 0),
                        "queued": self._queued.get(t, 0),
                        "oldest_wait_s": (
                            round(now - min(self._waiting[t]), 6)
                            if self._waiting.get(t) else 0.0)}
                    for t in tenants
                },
            }


class HotBlockCache:
    """Process-wide block and chunk LRU shared by every tenant.

    Tier ``compressed`` maps ``(path, coffset)`` to the raw BGZF block
    (header, deflate payload, footer); tier ``decoded`` maps the same key
    to ``(csize, payload)``, the inflated payload and the compressed
    size that advances a block walk; tier ``parsed`` is keyed ``(path,
    (chunk_begin, chunk_end))`` and holds a chunk's decoded batch (with
    its alignment ends for reads), so a hot region skips inflate, record
    decode and the CIGAR walk. Each tier evicts LRU under its byte
    budget; resident bytes are accounted per tenant (a hit is a hit
    whoever inserted the block).
    """

    TIERS = ("compressed", "decoded", "parsed")

    def __init__(self,
                 compressed_bytes: int = DEFAULT_COMPRESSED_CACHE_MB << 20,
                 decoded_bytes: int = DEFAULT_DECODED_CACHE_MB << 20,
                 parsed_bytes: int = DEFAULT_PARSED_CACHE_MB << 20) -> None:
        self._lock = threading.Lock()
        self._cap = {"compressed": int(compressed_bytes),
                     "decoded": int(decoded_bytes),
                     "parsed": int(parsed_bytes)}
        self._lru: Dict[str, OrderedDict] = {
            t: OrderedDict() for t in self.TIERS}
        self._bytes = {t: 0 for t in self.TIERS}
        self._tenant_bytes: Dict[Tuple[str, str], int] = {}
        # Cache-locality digest: path -> {bucket -> refcount} over every
        # tier ("which regions are warm here"). Each 0 <-> 1 transition
        # is journaled for /serve/cachemap's incremental refresh.
        self._digest: Dict[str, Dict[int, int]] = {}
        self._digest_seq = 0
        self._digest_log: deque = deque(maxlen=DIGEST_LOG_CAP)

    def get(self, tier: str, path: str, coffset: int,
            tenant: str) -> Optional[Any]:
        with self._lock:
            ent = self._lru[tier].get((path, coffset))
            if ent is None:
                counter("serve.cache.misses").inc(tier=tier, tenant=tenant)
                return None
            self._lru[tier].move_to_end((path, coffset))
            counter("serve.cache.hits").inc(tier=tier, tenant=tenant)
            return ent[0]

    def put(self, tier: str, path: str, coffset: int, value: Any,
            nbytes: int, tenant: str) -> None:
        cap = self._cap[tier]
        if nbytes > cap:
            return
        buckets = (digest_buckets(*coffset) if isinstance(coffset, tuple)
                   else (coffset >> DIGEST_BUCKET_BITS,))
        with self._lock:
            lru = self._lru[tier]
            key = (path, coffset)
            if key in lru:
                lru.move_to_end(key)
                return
            lru[key] = (value, nbytes, tenant, buckets)
            self._digest_add(path, buckets)
            self._bytes[tier] += nbytes
            tk = (tier, tenant)
            self._tenant_bytes[tk] = self._tenant_bytes.get(tk, 0) + nbytes
            while self._bytes[tier] > cap and lru:
                ev_key, (_, ev_bytes, ev_tenant, ev_buckets) = lru.popitem(
                    last=False)
                self._bytes[tier] -= ev_bytes
                ek = (tier, ev_tenant)
                self._tenant_bytes[ek] = max(
                    0, self._tenant_bytes.get(ek, 0) - ev_bytes)
                self._digest_del(ev_key[0], ev_buckets)
                counter("serve.cache.evictions").inc(tier=tier)
                record_event("serve_cache_evict", tier=tier,
                             tenant=ev_tenant, nbytes=ev_bytes)
            gauge("serve.cache.bytes").observe(self._bytes[tier], tier=tier)

    def clear(self) -> None:
        with self._lock:
            for t in self.TIERS:
                self._lru[t].clear()
                self._bytes[t] = 0
            self._tenant_bytes.clear()
            # the digest goes cold with the cache; the seq moves on with
            # the log emptied, so a router's ``since`` gets the full map
            self._digest.clear()
            self._digest_seq += 1
            self._digest_log.clear()

    # -- cache-locality digest (the fleet's routing signal) ----------------

    def _digest_add(self, path: str, buckets: Tuple[int, ...]) -> None:
        refs = self._digest.setdefault(path, {})
        for b in buckets:
            n = refs.get(b, 0)
            refs[b] = n + 1
            if n == 0:
                self._digest_seq += 1
                self._digest_log.append((self._digest_seq, "add", path, b))

    def _digest_del(self, path: str, buckets: Tuple[int, ...]) -> None:
        refs = self._digest.get(path)
        if refs is None:
            return
        for b in buckets:
            n = refs.get(b, 0)
            if n <= 1:
                refs.pop(b, None)
                self._digest_seq += 1
                self._digest_log.append((self._digest_seq, "del", path, b))
            else:
                refs[b] = n - 1
        if not refs:
            self._digest.pop(path, None)

    def invalidate_path(self, path: str) -> int:
        """Drop every cached entry of ``path`` in every tier: the cache's
        side of a dataset's epoch bump on re-register."""
        dropped = 0
        with self._lock:
            for tier in self.TIERS:
                lru = self._lru[tier]
                stale = [k for k in lru if k[0] == path]
                for k in stale:
                    _, ev_bytes, ev_tenant, ev_buckets = lru.pop(k)
                    self._bytes[tier] -= ev_bytes
                    ek = (tier, ev_tenant)
                    self._tenant_bytes[ek] = max(
                        0, self._tenant_bytes.get(ek, 0) - ev_bytes)
                    self._digest_del(path, ev_buckets)
                if stale:
                    counter("serve.cache.invalidations").inc(
                        len(stale), tier=tier)
                    gauge("serve.cache.bytes").observe(
                        self._bytes[tier], tier=tier)
                dropped += len(stale)
        if dropped:
            record_event("serve_cache_invalidate", path=path,
                         entries=dropped)
        return dropped

    def cachemap(self, since: Optional[int] = None) -> Dict[str, Any]:
        """Which ``(path, 64 KiB bucket)`` regions are warm in any tier.
        With ``since`` a ``seq`` returned before, the delta while the
        bounded op log still covers it; otherwise the full map."""
        with self._lock:
            doc: Dict[str, Any] = {"seq": self._digest_seq,
                                   "bucket_bits": DIGEST_BUCKET_BITS}
            if since is not None and 0 <= since <= self._digest_seq:
                if since == self._digest_seq:
                    doc["delta"] = []
                    return doc
                log = self._digest_log
                if log and log[0][0] <= since + 1:
                    doc["delta"] = [[op, path, bucket]
                                    for seq, op, path, bucket in log
                                    if seq > since]
                    return doc
            doc["paths"] = {p: sorted(refs)
                            for p, refs in self._digest.items() if refs}
            return doc

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                tier: {
                    "blocks": len(self._lru[tier]),
                    "bytes": self._bytes[tier],
                    "capacity_bytes": self._cap[tier],
                    "tenant_bytes": {
                        tenant: n
                        for (t, tenant), n in sorted(
                            self._tenant_bytes.items())
                        if t == tier and n > 0
                    },
                }
                for tier in self.TIERS
            }


class IndexCache:
    """Parsed header and index LRU keyed ``(path, size, mtime)``, so a
    daemon parses each BAI/TBI once and a rewritten file invalidates on
    its next query (backends without ``os.stat`` key on size alone)."""

    def __init__(self, entries: int = DEFAULT_INDEX_CACHE_ENTRIES) -> None:
        self._lock = threading.Lock()
        self._entries = int(entries)
        self._lru: OrderedDict = OrderedDict()

    @staticmethod
    def _stat(fs, path: str) -> Tuple[int, int]:
        try:
            st = os.stat(path)
            return int(st.st_size), int(st.st_mtime_ns)
        except OSError:
            return int(fs.get_file_length(path)), -1

    def get(self, fs, path: str, build):
        """``build(fs, path)``, cached until ``path``'s stat changes
        (``build`` may parse sidecars too: every writer rewrites them with
        the data file)."""
        key = (path,) + self._stat(fs, path)
        with self._lock:
            if key in self._lru:
                self._lru.move_to_end(key)
                counter("serve.index_cache.hits").inc()
                return self._lru[key]
        counter("serve.index_cache.misses").inc()
        value = build(fs, path)
        with self._lock:
            # drop older generations of the path, then bound the LRU
            for stale in [k for k in self._lru if k[0] == path]:
                del self._lru[stale]
            self._lru[key] = value
            while len(self._lru) > self._entries:
                self._lru.popitem(last=False)
        return value

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "entries": len(self._lru),
                "capacity": self._entries,
                "hits": counter("serve.index_cache.hits").total(),
                "misses": counter("serve.index_cache.misses").total(),
            }


class _Dataset:
    """One registered dataset: resolved filesystem and kind."""

    __slots__ = ("name", "path", "kind", "fs")

    def __init__(self, name: str, path: str, kind: str, fs) -> None:
        self.name = name
        self.path = path
        self.kind = kind
        self.fs = fs


def _parse_raw_block(raw: bytes) -> Tuple[bytes, int, int]:
    """(deflate payload, usize, CRC32) of one raw BGZF block."""
    xlen = struct.unpack_from("<H", raw, 10)[0]
    crc, usize = struct.unpack_from("<II", raw, len(raw) - _BGZF_FOOTER)
    return raw[12 + xlen: len(raw) - _BGZF_FOOTER], usize, crc


def _sniff_kind(path: str) -> str:
    low = path.lower()
    if low.endswith((".vcf.gz", ".vcf.bgz", ".vcf")):
        return "variants"
    return "reads"


class ServeDaemon:
    """Registry and query engine behind the ``/query/*`` endpoints, on
    ``device`` (``cuda`` unless the caller asks for another; without
    CUDA a request for it raises). ``resident_decode`` takes the device
    route on the CPU too, through the kernels' plain versions.

    Holds no thread: requests run on the endpoint's request threads,
    synchronized only by the cache and admission locks.
    """

    def __init__(self, *, options=None, device=None,
                 resident_decode: bool = False,
                 compressed_cache_mb: int = DEFAULT_COMPRESSED_CACHE_MB,
                 decoded_cache_mb: int = DEFAULT_DECODED_CACHE_MB,
                 parsed_cache_mb: int = DEFAULT_PARSED_CACHE_MB,
                 tenant_slots: int = DEFAULT_TENANT_SLOTS,
                 tenant_queue: int = DEFAULT_TENANT_QUEUE) -> None:
        from disq_tpu_torch.runtime.errors import DisqOptions, ShardRetrier
        from disq_tpu_torch.util import resolve_device

        self.device = resolve_device(device)
        self.device_route = (self.device.type == "cuda"
                             or bool(resident_decode))
        self._options = options or DisqOptions()
        self.cache = HotBlockCache(compressed_cache_mb << 20,
                                   decoded_cache_mb << 20,
                                   parsed_cache_mb << 20)
        self.indexes = IndexCache()
        self.admission = TenantAdmission(tenant_slots, tenant_queue)
        self._retrier = ShardRetrier(self._options.max_retries,
                                     self._options.retry_backoff_s)
        quantile = getattr(self._options, "hedge_quantile", None)
        if quantile is not None:
            from disq_tpu_torch.runtime.resilience import HedgeController

            self._hedge: Optional[HedgeController] = HedgeController(
                quantile, getattr(self._options, "hedge_min_s", 0.05))
        else:
            self._hedge = None
        self._datasets: Dict[str, _Dataset] = {}
        # resolved path -> dataset epoch, bumped on every re-register so
        # the fleet can invalidate stale digests and caches
        self._epochs: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- registry ----------------------------------------------------------

    def register(self, name: str, path: str,
                 kind: Optional[str] = None) -> Dict[str, Any]:
        from disq_tpu_torch.fsw.filesystem import resolve_path

        kind = kind or _sniff_kind(path)
        if kind not in ("reads", "variants"):
            raise ValueError(f"unknown dataset kind {kind!r}")
        fs, fs_path = resolve_path(path)
        if not fs.exists(fs_path):
            raise FileNotFoundError(path)
        ds = _Dataset(name, fs_path, kind, fs)
        with self._lock:
            epoch = self._epochs.get(fs_path, 0) + 1
            self._epochs[fs_path] = epoch
            self._datasets[name] = ds
            gauge("serve.datasets").observe(len(self._datasets))
        if epoch > 1:
            # a re-register: the file may have been rewritten under the
            # same path; shed its cached entries, and /serve/cachemap's
            # epochs tell the routers to do the same
            dropped = self.cache.invalidate_path(fs_path)
            record_event("serve_register_epoch", name=name,
                         path=fs_path, epoch=epoch, dropped=dropped)
        return {"name": name, "path": path, "kind": kind, "epoch": epoch}

    def _dataset(self, doc: Dict[str, Any], kind: str) -> _Dataset:
        name = doc.get("dataset")
        if name is not None:
            with self._lock:
                ds = self._datasets.get(name)
            if ds is None:
                # 404: the request is well formed, the resource is absent
                raise FileNotFoundError(
                    f"dataset {name!r} not registered")
            return ds
        path = doc.get("path")
        if not path:
            raise ValueError("request needs 'dataset' or 'path'")
        # a query by path registers the path under itself
        with self._lock:
            ds = self._datasets.get(path)
        if ds is None:
            self.register(path, path, kind)
            with self._lock:
                ds = self._datasets[path]
        return ds

    # -- cached index resolution ------------------------------------------

    @staticmethod
    def _build_bam_meta(fs, path: str):
        from disq_tpu_torch.bam.source import read_header
        from disq_tpu_torch.traversal.bai_query import _resolve_bai

        header, first_vo = read_header(fs, path)
        return header, first_vo, _resolve_bai(fs, path)

    @staticmethod
    def _build_vcf_meta(fs, path: str):
        from disq_tpu_torch.index.tbi import TbiIndex
        from disq_tpu_torch.vcf.header import read_vcf_header

        header = read_vcf_header(fs, path)
        tbi = TbiIndex.from_bytes(fs.read_all(path + ".tbi"))
        return header, tbi

    # -- the cached, batched block pipeline -------------------------------

    def _chunk_blobs(self, ds: _Dataset, chunks, tenant: str
                     ) -> List[bytes]:
        """Decoded bytes of each virtual-offset chunk ``[cb, ce)`` of one
        request: every block goes through the shared cache, and the
        cache-missing blocks of all the chunks are inflated in one batch
        (``_inflate_pending``), so a request makes one device launch or
        service submission however many chunks it spans."""
        length = ds.fs.get_file_length(ds.path)
        payloads: Dict[int, bytes] = {}  # coffset -> decoded payload
        csizes: Dict[int, int] = {}
        # coffset -> (deflate payload, usize, CRC32), in first-seen order
        pending: Dict[int, Tuple[bytes, int, int]] = {}
        plans = []
        for cb, ce in chunks:
            lo_block = cb >> 16
            hi_block, hi_u = ce >> 16, ce & 0xFFFF
            want_end = max(hi_block + (1 if hi_u > 0 else 0), lo_block + 1)
            order: List[int] = []  # the chunk's coffsets in file order
            pos = lo_block
            while pos < want_end and pos < length:
                if pos in payloads or pos in pending:
                    order.append(pos)
                    pos += csizes[pos]
                    continue
                ent = self.cache.get("decoded", ds.path, pos, tenant)
                if ent is not None:
                    csize, payload = ent
                    order.append(pos)
                    payloads[pos] = payload
                    csizes[pos] = csize
                    pos += csize
                    continue
                raw = self.cache.get("compressed", ds.path, pos, tenant)
                if raw is not None:
                    order.append(pos)
                    csizes[pos] = len(raw)
                    pending[pos] = _parse_raw_block(raw)
                    pos += len(raw)
                    continue
                # a miss: walk and stage the rest of the chunk in one
                # range read, retried (a transient storage fault must not
                # 500 a tenant)
                blocks, data = self._fetch(ds, pos, want_end, length)
                if not blocks:
                    break
                base = blocks[0].pos
                for blk in blocks:
                    raw_b = data[blk.pos - base: blk.end - base]
                    self.cache.put("compressed", ds.path, blk.pos, raw_b,
                                   len(raw_b), tenant)
                    comp, _, crc = _parse_raw_block(raw_b)
                    order.append(blk.pos)
                    csizes[blk.pos] = blk.csize
                    pending.setdefault(blk.pos, (comp, blk.usize, crc))
                pos = blocks[-1].end
            plans.append((order, cb & 0xFFFF, hi_block, hi_u))
        if pending:
            self._inflate_pending(
                ds, [(co, *v) for co, v in pending.items()], payloads,
                csizes, tenant)
        out = []
        for order, lo_u, hi_block, hi_u in plans:
            blob = b"".join(payloads[co] for co in order)
            if hi_u > 0:
                end_u = sum(len(payloads[co]) for co in order
                            if co < hi_block) + hi_u
            else:
                end_u = len(blob)
            out.append(blob[lo_u:end_u])
        return out

    @staticmethod
    def _walk(fs, path, pos, want_end, length):
        from disq_tpu_torch.bgzf.guesser import walk_blocks_collect

        return walk_blocks_collect(
            fs, path, pos, max(want_end, pos + 1), length)

    def _fetch(self, ds: _Dataset, pos: int, want_end: int, length: int):
        """One retried range fetch and block walk, hedged when
        ``DisqOptions.hedge_quantile`` is set: a slow storage read races
        a duplicate (a ``hedge_launched`` flight-recorder event)."""
        def call():
            return self._retrier.call(
                self._walk, ds.fs, ds.path, pos, want_end, length,
                what="serve.fetch")

        if self._hedge is None:
            return call()
        return self._hedge.call(call)

    def _inflate_pending(self, ds: _Dataset, pending, payloads, csizes,
                         tenant: str) -> None:
        """Inflate every cache-missing block of one request in one batch
        (the device route of the module docstring, or host zlib) and put
        the payloads in the decoded tier."""
        if self.device_route:
            decoded = self._inflate_device(ds, pending)
        else:
            decoded = [
                zlib.decompress(comp, -15, usize or 1)
                for _, comp, usize, _ in pending
            ]
        for (coffset, _comp, _usize, _crc), payload in zip(pending, decoded):
            payloads[coffset] = payload
            self.cache.put("decoded", ds.path, coffset,
                           (csizes[coffset], payload), len(payload),
                           tenant)

    def _inflate_device(self, ds: _Dataset, pending) -> List[bytes]:
        """The device route of one request's batch: B4 under ``legacy``,
        the device service when it is on, else one B1 launch. Raises
        ``CorruptBlockError`` for the first block a kernel flags or whose
        CRC does not match; nothing is decoded on the host."""
        import numpy as np

        from disq_tpu_torch.bgzf.codec import legacy_inflate
        from disq_tpu_torch.runtime import counters, device_service
        from disq_tpu_torch.runtime.errors import (
            CorruptBlockError, FlaggedBlocksError)

        comps = [comp for _, comp, _, _ in pending]
        usizes = [usize for _, _, usize, _ in pending]
        errors: Dict[int, str] = {}
        if legacy_inflate():
            from disq_tpu_torch.ops.inflate import inflate_payloads

            try:
                decoded = inflate_payloads(comps, usizes, self.device)
            except FlaggedBlocksError as e:
                decoded, errors[int(e.bad[0])] = None, str(e)
        else:
            if device_service.enabled():
                sub = device_service.get_service(self.device).submit_inflate(
                    comps, usizes, host_rescue=False)
                (blob, out_off), failed = sub.outcome()
                errors = {int(i): str(e) for i, e in failed.items()}
            else:
                from disq_tpu_torch.ops import inflate_simd as B1

                blob, out_len, status, out_off = B1.fetch_payloads(
                    B1.launch_payloads(comps, usizes, self.device))
                bad = np.nonzero((status != 0)
                                 | (out_len != np.asarray(usizes)))[0]
                for i in bad:
                    errors[int(i)] = (f"status {int(status[i])} "
                                      f"({B1.STATUS_NAMES[int(status[i])]})")
                counters.add_stats(B1.last_stats,
                                   device_lanes=len(pending) - len(bad))
            decoded = [blob[int(out_off[i]): int(out_off[i + 1])].tobytes()
                       for i in range(len(pending))]
        if decoded is not None:
            # the first block whose bytes fail their footer's CRC, before
            # any flagged one
            for i in range(min(errors, default=len(pending))):
                if zlib.crc32(decoded[i]) != pending[i][3]:
                    errors[i] = "BGZF CRC mismatch"
                    break
        if errors:
            i = min(errors)
            raise CorruptBlockError(
                f"device inflate failed: {errors[i]}", path=ds.path,
                block_offset=pending[i][0])
        return decoded

    # -- query execution ---------------------------------------------------

    @staticmethod
    def _parse_intervals(doc: Dict[str, Any]):
        from disq_tpu_torch.api import Interval

        raw = doc.get("intervals")
        if not isinstance(raw, list) or not raw:
            raise ValueError(
                "request needs 'intervals': [{contig, start, end}, …]")
        out = []
        for iv in raw:
            if not isinstance(iv, dict):
                raise ValueError("each interval must be an object")
            try:
                out.append(Interval(str(iv["contig"]), int(iv["start"]),
                                    int(iv["end"])))
            except KeyError as e:
                raise ValueError(f"interval missing {e.args[0]!r}")
        return out

    @staticmethod
    def _batch_nbytes(batch, *extra) -> int:
        return sum(v.nbytes for v in vars(batch).values()
                   if hasattr(v, "nbytes")) \
            + sum(a.nbytes for a in extra)

    def _parsed_chunks(self, ds: _Dataset, header, chunks, tenant: str):
        """(batch, alignment ends) of each virtual-offset chunk (None for
        an empty one) through the parsed tier: the chunks it misses are
        decoded in one batch, and their record decode and CIGAR walk run
        on the host once per chunk, as the reference's."""
        from disq_tpu_torch.bam.codec import decode_records, scan_record_offsets

        ents = [self.cache.get("parsed", ds.path, (cb, ce), tenant)
                for cb, ce in chunks]
        missing = [i for i, ent in enumerate(ents) if ent is None]
        blobs = self._chunk_blobs(ds, [chunks[i] for i in missing], tenant)
        for i, record_bytes in zip(missing, blobs):
            if not record_bytes:
                continue
            offsets = scan_record_offsets(record_bytes)
            sub = decode_records(record_bytes, offsets, n_ref=header.n_ref)
            ends = sub.alignment_ends()
            ents[i] = (sub, ends)
            self.cache.put("parsed", ds.path, chunks[i], ents[i],
                           self._batch_nbytes(sub, ends), tenant)
        return ents

    def _read_batch(self, ds: _Dataset, intervals, tenant: str,
                    materialize: bool = True):
        """(header, filtered ReadBatch or None, count) of ``intervals``.
        With ``materialize=False`` (count-only: ``limit`` 0 and no
        digest) only the overlap mask is summed per chunk."""
        from disq_tpu_torch.bam.columnar import ReadBatch
        from disq_tpu_torch.traversal.bai_query import (
            chunks_for_intervals, overlap_mask)

        header, _first_vo, bai = self.indexes.get(
            ds.fs, ds.path, self._build_bam_meta)
        batches = []
        count = 0
        chunks = chunks_for_intervals(header, bai, intervals)
        for ent in self._parsed_chunks(ds, header, chunks, tenant):
            if ent is None:
                continue
            sub, ends = ent
            mask = overlap_mask(sub, header, intervals, ends=ends)
            if materialize:
                batches.append(sub.filter(mask))
            else:
                count += int(mask.sum())
        if not materialize:
            return header, None, count
        batch = (ReadBatch.concat(batches) if batches
                 else ReadBatch.empty())
        return header, batch, int(batch.count)

    @staticmethod
    def _batch_digest(batch) -> str:
        h = hashlib.sha1()
        for col in (batch.refid, batch.pos, batch.flag, batch.mapq,
                    batch.tlen):
            h.update(col.tobytes())
        h.update(batch.names.tobytes())
        h.update(batch.cigars.tobytes())
        h.update(batch.seqs.tobytes())
        h.update(batch.quals.tobytes())
        return h.hexdigest()

    def _q_reads(self, doc: Dict[str, Any], tenant: str) -> Dict[str, Any]:
        ds = self._dataset(doc, "reads")
        if ds.kind != "reads":
            raise ValueError(f"dataset {ds.name!r} holds variants")
        intervals = self._parse_intervals(doc)
        limit = int(doc.get("limit", 100))
        want_digest = bool(doc.get("digest", True))
        header, batch, count = self._read_batch(
            ds, intervals, tenant,
            materialize=want_digest or limit > 0)
        names = [s.name for s in header.sequences]
        records = [
            {
                "name": batch.name(i),
                "contig": (names[int(batch.refid[i])]
                           if 0 <= int(batch.refid[i]) < len(names)
                           else None),
                "pos": int(batch.pos[i]) + 1,
                "flag": int(batch.flag[i]),
                "mapq": int(batch.mapq[i]),
            }
            for i in range(min(count, max(0, limit)))
        ] if batch is not None else []
        out = {
            "dataset": ds.name,
            "count": count,
            "records": records,
        }
        # a sha1 over every column is the cross-client identity check;
        # latency-sensitive callers opt out with "digest": false
        if want_digest:
            out["digest"] = self._batch_digest(batch)
        return out

    def _q_variants(self, doc: Dict[str, Any],
                    tenant: str) -> Dict[str, Any]:
        from disq_tpu_torch.vcf.columnar import VariantBatch, parse_vcf_lines
        from disq_tpu_torch.vcf.source import VcfSource

        ds = self._dataset(doc, "variants")
        if ds.kind != "variants":
            raise ValueError(f"dataset {ds.name!r} holds reads")
        intervals = self._parse_intervals(doc)
        header, tbi = self.indexes.get(ds.fs, ds.path,
                                       self._build_vcf_meta)
        chunks = []
        for iv in intervals:
            chunks += tbi.chunks_for_interval(iv.contig, iv.start - 1,
                                              iv.end)
        chunks.sort()
        merged: List[Tuple[int, int]] = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
            else:
                merged.append((cb, ce))
        batches = [self.cache.get("parsed", ds.path, ch, tenant)
                   for ch in merged]
        missing = [i for i, sub in enumerate(batches) if sub is None]
        blobs = self._chunk_blobs(ds, [merged[i] for i in missing], tenant)
        for i, blob in zip(missing, blobs):
            lines = [
                ln for ln in blob.split(b"\n")
                if ln and not ln.startswith(b"#")
                and ln.count(b"\t") >= 7
            ]
            batches[i] = parse_vcf_lines(lines, header.contig_names)
            self.cache.put("parsed", ds.path, merged[i], batches[i],
                           self._batch_nbytes(batches[i]), tenant)
        batch = (VariantBatch.concat(batches) if batches
                 else VariantBatch.empty(header.contig_names))
        batch = batch.filter(VcfSource._overlap_mask(batch, intervals))
        limit = int(doc.get("limit", 100))
        out = {
            "dataset": ds.name,
            "count": int(batch.count),
            "records": [batch.line(i)
                        for i in range(min(int(batch.count),
                                           max(0, limit)))],
        }
        if doc.get("digest", True):
            h = hashlib.sha1()
            h.update(batch.chrom.tobytes())
            h.update(batch.pos.tobytes())
            h.update(batch.lines.tobytes())
            out["digest"] = h.hexdigest()
        return out

    def _q_stats(self, doc: Dict[str, Any], tenant: str) -> Dict[str, Any]:
        ds = self._dataset(doc, "reads")
        if ds.kind != "reads":
            raise ValueError("/query/stats serves reads datasets")
        intervals = self._parse_intervals(doc)
        header, batch, _count = self._read_batch(ds, intervals, tenant)
        from disq_tpu_torch.api import ReadsDataset

        view = ReadsDataset(header=header, reads=batch, device=self.device)
        out: Dict[str, Any] = {"dataset": ds.name,
                               "count": int(batch.count)}
        which = doc.get("stat", "flagstat")
        if which not in ("flagstat", "depth"):
            raise ValueError(f"unknown stat {which!r}")
        if which == "flagstat":
            out["flagstat"] = {k: int(v)
                               for k, v in view.flagstat().items()}
        else:
            window = int(doc.get("window", 1024))
            depth = view.depth(window=window)
            names = [s.name for s in header.sequences]
            out["depth"] = {
                "window": window,
                "refs": {
                    (names[int(refid)]
                     if 0 <= int(refid) < len(names) else str(refid)): {
                        "windows": int(len(arr)),
                        "max": int(arr.max()) if len(arr) else 0,
                        "total": int(arr.sum()) if len(arr) else 0,
                    }
                    for refid, arr in depth.items()
                },
            }
        return out

    # -- operator queries (ops/*.py on the parsed tier) ---------------------

    def _q_markdup_stats(self, doc: Dict[str, Any],
                         tenant: str) -> Dict[str, Any]:
        """``POST /query/markdup-stats``: duplicate-marking stats of the
        reads overlapping ``intervals`` (``ops/markdup.py``; the batch is
        one coordinate scan, so no seam merge). ``"rgstats": true`` adds
        the per-read-group breakdown of the marked batch."""
        from disq_tpu_torch.ops.markdup import markdup_batch

        ds = self._dataset(doc, "reads")
        if ds.kind != "reads":
            raise ValueError("/query/markdup-stats serves reads datasets")
        intervals = self._parse_intervals(doc)
        _header, batch, count = self._read_batch(ds, intervals, tenant)
        batch, res = markdup_batch(batch)
        out: Dict[str, Any] = {"dataset": ds.name, "count": count,
                               "markdup": res.stats()}
        if doc.get("rgstats"):
            from disq_tpu_torch.ops.rgstats import read_group_stats

            out["rgstats"] = read_group_stats(batch)
        return out

    def _q_pileup(self, doc: Dict[str, Any], tenant: str) -> Dict[str, Any]:
        """``POST /query/pileup``: per-base coverage over one interval
        (``ops/pileup.py``, summed on the daemon's device). The base
        vector comes back up to ``max_bases`` (default 16384) positions;
        a wider region gets the summary only."""
        from disq_tpu_torch.ops.pileup import region_pileup

        ds = self._dataset(doc, "reads")
        if ds.kind != "reads":
            raise ValueError("/query/pileup serves reads datasets")
        intervals = self._parse_intervals(doc)
        if len(intervals) != 1:
            raise ValueError("/query/pileup wants exactly one interval")
        iv = intervals[0]
        header, batch, _count = self._read_batch(ds, [iv], tenant)
        names = [s.name for s in header.sequences]
        if iv.contig not in names:
            raise ValueError(f"unknown contig {iv.contig!r}")
        start, end = int(iv.start) - 1, int(iv.end)
        cov = region_pileup(batch, names.index(iv.contig), start, end,
                            device=self.device)
        out: Dict[str, Any] = {
            "dataset": ds.name, "contig": iv.contig,
            "start": int(iv.start), "end": int(iv.end),
            "max": int(cov.max()) if len(cov) else 0,
            "mean": round(float(cov.mean()), 4) if len(cov) else 0.0,
            "nonzero": int((cov > 0).sum()),
        }
        if len(cov) <= int(doc.get("max_bases", 16384)):
            out["coverage"] = cov.astype(int).tolist()
        return out

    def _q_filtered_count(self, doc: Dict[str, Any],
                          tenant: str) -> Dict[str, Any]:
        """``POST /query/filtered-count``: how many reads in ``intervals``
        pass a ``samtools view``-grammar ``"filter"`` spec
        (``ops/rfilter.py``), without records in the response. The mask
        is kernel F1's on the device route, ``host_mask`` otherwise."""
        import numpy as np

        from disq_tpu_torch.ops.rfilter import (
            host_mask, name_hashes_from_columns, parse_read_filter)

        ds = self._dataset(doc, "reads")
        if ds.kind != "reads":
            raise ValueError("/query/filtered-count serves reads datasets")
        rf = parse_read_filter(str(doc.get("filter", "")))
        intervals = self._parse_intervals(doc)
        _header, batch, count = self._read_batch(ds, intervals, tenant)
        nh = None
        if rf.needs_name_hash:
            nh = name_hashes_from_columns(
                np.asarray(batch.names), np.asarray(batch.name_offsets))
        if self.device_route:
            matched = self._device_mask_count(rf, batch, nh)
        else:
            matched = int(host_mask(rf, np.asarray(batch.flag),
                                    np.asarray(batch.mapq), nh).sum())
        return {"dataset": ds.name, "count": count, "matched": matched}

    def _device_mask_count(self, rf, batch, nh) -> int:
        """The keep count of ``batch`` under ``rf`` from kernel F1 on the
        daemon's device (its plain version on the CPU)."""
        import numpy as np

        from disq_tpu_torch.ops.rfilter import build_mask
        from disq_tpu_torch.runtime.device_pipeline import upload
        from disq_tpu_torch.runtime.tracing import device_span

        def col(a):
            return upload(np.asarray(a).astype(np.int32), self.device)

        hashes = None if nh is None else col(np.asarray(nh).view(np.int32))
        with device_span("device.kernel", kernel="read_filter",
                         records=int(batch.count)) as fence:
            keep = fence.sync(build_mask(
                col(batch.flag), col(batch.mapq), hashes, rf.require_flags,
                rf.exclude_flags, rf.min_mapq, rf.seed_mix, rf.threshold))
        return int(keep.sum())

    # -- stats and HTTP ----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        lat = histogram("serve.request")
        with self._lock:
            datasets = [
                {"name": d.name, "path": d.path, "kind": d.kind}
                for d in self._datasets.values()
            ]
        return {
            "datasets": datasets,
            "cache": self.cache.stats(),
            "index_cache": self.indexes.stats(),
            "admission": self.admission.stats(),
            "latency": {
                "p50_ms": lat.percentile(50) * 1e3,
                "p99_ms": lat.percentile(99) * 1e3,
                "p999_ms": lat.percentile(99.9) * 1e3,
                "max_ms": lat.percentile(100) * 1e3,
            },
        }

    _QUERIES = {
        "/query/reads": "_q_reads",
        "/query/variants": "_q_variants",
        "/query/stats": "_q_stats",
        "/query/markdup-stats": "_q_markdup_stats",
        "/query/pileup": "_q_pileup",
        "/query/filtered-count": "_q_filtered_count",
    }

    def cachemap(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        """``GET /serve/cachemap[?since=N]``: the cache digest and the
        dataset epochs, for the fleet router's incremental refresh."""
        since = doc.get("since")
        try:
            since = int(since) if since is not None else None
        except (TypeError, ValueError):
            since = None
        out = self.cache.cachemap(since)
        with self._lock:
            out["epochs"] = dict(self._epochs)
        return out

    def handle(self, method: str, path: str,
               doc: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        from disq_tpu_torch.runtime.errors import CorruptBlockError

        if method == "GET" and path == "/serve/stats":
            return 200, self.stats()
        if method == "GET" and path == "/serve/cachemap":
            return 200, self.cachemap(doc)
        if method != "POST":
            return 405, {"error": f"{path} expects POST"}
        if path == "/serve/register":
            try:
                return 200, self.register(
                    str(doc.get("name") or doc.get("path") or ""),
                    str(doc["path"]), doc.get("kind"))
            except KeyError:
                return 400, {"error": "register needs 'path'"}
            except (ValueError, FileNotFoundError) as e:
                return 400, {"error": str(e)}
        fn_name = self._QUERIES.get(path)
        if fn_name is None:
            return 404, {"error": f"unknown serve path {path}",
                         "endpoints": sorted(self._QUERIES)
                         + ["/serve/register", "/serve/stats"]}
        tenant = str(doc.get("tenant") or DEFAULT_TENANT)
        t0 = time.perf_counter()
        endpoint = path.rsplit("/", 1)[-1]
        # The request's causal context: the client's (activated from
        # X-Disq-Trace-* by the endpoint's handler), or a minted root
        # under DISQ_TPU_TORCH_TRACE_REQUESTS. The tenant rides the body,
        # so an adopted context is rebound to the body's tenant.
        ctx = current_trace()
        token = None
        if ctx is None:
            if trace_requests_enabled():
                ctx = mint_trace(tenant)
                token = activate_trace(ctx)
        elif ctx.tenant != tenant:
            ctx = TraceContext(ctx.trace_id, ctx.span_id, tenant)
            token = activate_trace(ctx)
        try:
            try:
                self.admission.acquire(tenant)
            except AdmissionShed as e:
                record_event("serve_shed", tenant=tenant,
                             endpoint=endpoint, reason=e.reason)
                if ctx is not None:
                    record_span("serve.request.trace",
                                time.perf_counter() - t0,
                                endpoint=endpoint, tenant=tenant,
                                status=429)
                return 429, {"error": str(e), "tenant": tenant}
            status = 500
            try:
                body = getattr(self, fn_name)(doc, tenant)
                status = 200
                return 200, body
            except CorruptBlockError as e:
                # a server-side fault, as the reference's zlib error is,
                # though CorruptBlockError is a ValueError
                return 500, {"error": f"{type(e).__name__}: {e}"}
            except (KeyError, ValueError) as e:
                status = 400
                return 400, {"error": str(e)}
            except FileNotFoundError as e:
                status = 404
                return 404, {"error": f"not found: {e}"}
            except Exception as e:  # noqa: BLE001 — surfaced as HTTP 500
                return 500, {"error": f"{type(e).__name__}: {e}"}
            finally:
                self.admission.release(tenant)
                dur = time.perf_counter() - t0
                histogram("serve.request").observe(
                    dur, endpoint=endpoint, tenant=tenant)
                if status >= 500:
                    counter("serve.request.errors").inc(
                        endpoint=endpoint, tenant=tenant)
                if ctx is not None:
                    # the stitched waterfall's root in this process
                    record_span("serve.request.trace", dur,
                                endpoint=endpoint, tenant=tenant,
                                status=status)
        finally:
            if token is not None:
                deactivate_trace(token)


# -- module-level daemon lifecycle ----------------------------------------

_LOCK = threading.RLock()
_DAEMON: Optional[ServeDaemon] = None


def serve_if_running() -> Optional[ServeDaemon]:
    """The live daemon, or None. Never creates one."""
    return _DAEMON


def start_serve(port: int = 0, **daemon_kwargs: Any) -> str:
    """Create the daemon (idempotent) and return the ``host:port`` of the
    endpoint now also answering ``/query/*`` and ``/serve/*``. Keyword
    arguments go to :class:`ServeDaemon` on the first start and are
    ignored by a running daemon."""
    global _DAEMON
    with _LOCK:
        if _DAEMON is None:
            _DAEMON = ServeDaemon(**daemon_kwargs)
    # The daemon is the serving edge the SLO layer watches, so it arms
    # the evaluator from DISQ_TPU_TORCH_SLO (no-op, no thread, unset).
    from disq_tpu_torch.runtime import slo as _slo

    _slo.configure_from_env()
    from disq_tpu_torch.runtime.introspect import start_introspect_server

    return start_introspect_server(port)


def stop_serve() -> None:
    """Drop the daemon (registry, caches, admission state). The endpoint
    is shared with the rest of the telemetry plane: its starter stops
    it."""
    global _DAEMON
    with _LOCK:
        daemon, _DAEMON = _DAEMON, None
    if daemon is not None and daemon._hedge is not None:
        daemon._hedge.close()


def handle_http(method: str, path: str,
                doc: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
    """Route one serving-plane request; 503, allocating nothing, when no
    daemon runs."""
    daemon = _DAEMON
    if daemon is None:
        return 503, {
            "error": "serving plane not started — call "
                     "disq_tpu_torch.api.serve() or scripts/torch_serve.py"}
    return daemon.handle(method, path, doc)
