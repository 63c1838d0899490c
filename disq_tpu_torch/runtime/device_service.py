"""Cross-shard device service: one dispatcher thread owns the card's
queue and feeds kernels B1, B3 and W2 with lanes coalesced across shards.

The counterpart of ``disq_tpu/runtime/device_service.py``. Executor
decode stages submit their split's
BGZF payloads (``submit_inflate``) or order-0 rANS streams
(``submit_rans``), and write-pipeline deflate stages their shard's block
payloads (``submit_deflate``); each gets a ``Submission`` back. The
dispatcher coalesces lanes across the submissions in flight into chunks
of at most ``LANES``, flushing a queue when it holds ``LANES`` lanes
(``full``), when its oldest lane has waited ``flush_timeout_s``
(``timeout``; ``DISQ_TPU_TORCH_SERVICE_FLUSH_MS``, default 2) or at
``close()`` (``drain``), oldest lane first across the queues. It keeps
``_WINDOW`` launches in flight.

Mesh (``runtime/mesh.py``): when the mesh knob is armed at service
start, each codec keeps one sub-queue per mesh device
(``mesh.service_devices``) and the one dispatcher feeds them all: a
submission's lanes go to the least-loaded device, each launch runs on
that device's engine and stream, ``device.lane_fill`` is labelled with
the device's index, and the window of launches in flight scales with the
device count. With the mesh off the device list is ``[None]``, the
service's own device, and one queue per codec as before.

On a card the dispatcher enters the service's own ``torch.cuda.Stream``:
each chunk is staged into a pinned arena, copied up and launched on that
stream without a wait, and fetched once its event completed, so the
copies and kernels of one chunk overlap the host's finalize of the
previous one. Owners receive host bytes only: every tensor of a chunk
lives and dies on the service's stream.

Error isolation is per owner: a lane the kernel flags is decoded again
on the host, over the shared host pool (an inflate submission made with
``host_rescue=False`` records the error instead), and if the host fails
too only its owner's submission records the error (under the lane's
index, so a caller can name the block or stream); lanes of other owners
in the same chunk are delivered. A chunk whose launch or fetch fails
fails every owner with lanes in it; nothing falls back to the host for
it.

Telemetry: ``device.batch.flush{reason}``, ``device.lane_fill`` (lanes
per launch / ``LANES``), ``device.queue_depth``, ``device.service.wait``
(the oldest lane's queue wait per chunk), and for traced requests
``device.batch.requests`` and ``device.batch.share``.

Enablement: ``DISQ_TPU_TORCH_DEVICE_SERVICE=1``, read by the codec entry
points (``bgzf/codec.py``, ``cram/rans.py``). Off (the default) no
dispatcher thread, queue or arena exists.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime import flightrec as _flightrec
from disq_tpu_torch.runtime.tracing import (
    counter as _counter,
    current_trace as _current_trace,
    observe_gauge as _observe_gauge,
    record_span as _record_span,
    trace_scope as _trace_scope,
)

# The chunk cap, from B1's launch geometry (csrc/inflate.cu): one warp
# per payload, 4 warps (128 threads) per CTA, and 32,944 bytes of shared
# memory per CTA (FixedSmem 5,824 + 4 x WarpSmem 6,780). An H100 SM has
# 228 KB of shared memory and reserves 1 KB per CTA, so 6 CTAs fit
# (6 x 33,968 = 203,808 bytes), 24 payloads per SM, and one wave over
# 132 SMs is 6 x 4 x 132 = 3,168 payloads. A 64 MiB BAM split holds
# ~1,830 payloads and a CRAM split ~48 order-0 streams, so one split's
# submission fits a chunk: the service launches no more often than the
# per-split route, but for chunks that flush on timeout. (The
# reference's 128 is the TPU's lane width; tests patch LANES to 128 to
# replay its contracts.)
LANES = 3168

# Launches in flight: enough to overlap one chunk's copies and kernel
# with the host's finalize of the previous ones. A full chunk stages at
# most LANES x (a 64 KiB payload in + 64 KiB out) = 3,168 x 128 KiB
# = 396 MiB, so 4 in flight hold ~1.6 GiB of the card's 80 GB.
_WINDOW = 4

_KINDS = ("inflate", "rans", "deflate")


class _Lane:
    """One payload or stream queued for a kernel lane."""

    __slots__ = ("sub", "index", "payload", "expect", "ts", "trace")

    def __init__(self, sub: "Submission", index: int, payload: Any,
                 expect: int, trace: Any = None) -> None:
        self.sub = sub
        self.index = index
        self.payload = payload
        self.expect = expect
        self.ts = 0.0          # stamped at enqueue
        # the submitting request's TraceContext (or None), for its share
        self.trace = trace


class Submission:
    """Future for one shard's submitted batch.

    Inflate submissions carry a preallocated host ``blob`` at
    ``offsets`` that lanes are written into as they land; rANS and
    deflate submissions collect per-lane ``parts``. A lane that fails
    records its error under its index; the waiter is released once
    every lane landed or failed."""

    __slots__ = ("_event", "_lock", "_pending", "errors", "blob",
                 "offsets", "parts", "host_rescue")

    def __init__(self, blob: Optional[np.ndarray] = None,
                 offsets: Optional[np.ndarray] = None,
                 parts_n: Optional[int] = None,
                 host_rescue: bool = True) -> None:
        self._event = threading.Event()
        # False: a lane the kernel flags fails, with no host decode
        self.host_rescue = host_rescue
        self._lock = threading.Lock()
        self.blob = blob
        self.offsets = offsets
        self.parts: Optional[List[Optional[bytes]]] = (
            [None] * parts_n if parts_n is not None else None)
        self._pending = (parts_n if parts_n is not None
                         else len(offsets) - 1)
        self.errors: Dict[int, BaseException] = {}
        if self._pending == 0:
            self._event.set()

    def _store(self, index: int, value: Any) -> None:
        if self.parts is not None:
            self.parts[index] = (value if isinstance(value, bytes)
                                 else bytes(value))
        else:
            lo, hi = int(self.offsets[index]), int(self.offsets[index + 1])
            self.blob[lo:hi] = (value if isinstance(value, np.ndarray)
                                else np.frombuffer(value, dtype=np.uint8))

    def deliver_local(self, index: int, value: Any) -> None:
        """Delivery on the submitting thread, before enqueue."""
        self._store(index, value)
        self._pending -= 1

    def fail_local(self, index: int, exc: BaseException) -> None:
        """A lane that failed on the submitting thread, before enqueue."""
        self.errors.setdefault(index, exc)
        self._pending -= 1

    def deliver(self, index: int, value: Any) -> None:
        self.deliver_run(index, 1, value)

    def deliver_run(self, first: int, count: int, value: Any) -> None:
        """Lanes ``first .. first+count-1`` of an inflate submission,
        contiguous in ``value`` (one copy), or one lane's value."""
        with self._lock:
            if count == 1 or self.parts is not None:
                self._store(first, value)
            else:
                lo = int(self.offsets[first])
                self.blob[lo: int(self.offsets[first + count])] = value
            self._pending -= count
            if self._pending <= 0:
                self._event.set()

    def fail(self, index: int, exc: BaseException) -> None:
        with self._lock:
            self.errors.setdefault(index, exc)
            self._pending -= 1
            if self._pending <= 0:
                self._event.set()

    def outcome(self, timeout: Optional[float] = None):
        """Wait for every lane: ``(value, errors by lane index)``, the
        value being ``(blob, offsets)`` or the parts list."""
        if not self._event.wait(timeout):
            raise TimeoutError("device service result timed out")
        value = (list(self.parts) if self.parts is not None
                 else (self.blob, self.offsets))
        return value, dict(self.errors)

    def result(self, timeout: Optional[float] = None):
        """The value of ``outcome``; raises the error of the lowest
        failed lane."""
        value, errors = self.outcome(timeout)
        if errors:
            raise errors[min(errors)]
        return value


def _runs(lanes: Sequence[_Lane], ok: Sequence[bool]):
    """Maximal runs ``(j0, j1)`` of good lanes that belong to one
    submission at consecutive indices (one copy each)."""
    j, n = 0, len(lanes)
    while j < n:
        if not ok[j]:
            j += 1
            continue
        k = j + 1
        while (k < n and ok[k] and lanes[k].sub is lanes[j].sub
               and lanes[k].index == lanes[k - 1].index + 1):
            k += 1
        yield j, k
        j = k


class _InflateEngine:
    """B1 over a chunk of BGZF payloads; each lane's bytes land in its
    owner's blob. A flagged lane (status ≠ 0, or a length other than its
    ISIZE) is inflated again by host zlib."""

    kind = "inflate"

    def __init__(self, device, host_map) -> None:
        self.device = device
        self._host_map = host_map

    def launch(self, lanes: Sequence[_Lane]):
        from disq_tpu_torch.ops import inflate_simd as IS

        return IS.launch_payloads([l.payload for l in lanes],
                                  [l.expect for l in lanes], self.device)

    def finalize(self, handle, lanes: Sequence[_Lane]) -> None:
        from disq_tpu_torch.ops import inflate_simd as IS

        blob, out_len, status, out_off = IS.fetch_payloads(handle)
        expect = np.fromiter((l.expect for l in lanes), np.int64, len(lanes))
        ok = (status == 0) & (out_len == expect)
        for j0, j1 in _runs(lanes, ok):
            lanes[j0].sub.deliver_run(lanes[j0].index, j1 - j0,
                                      blob[out_off[j0]: out_off[j1]])
        flagged = np.nonzero(~ok)[0]
        rescue = []
        for j in flagged:
            lane = lanes[j]
            if lane.sub.host_rescue:
                rescue.append(lane)
            else:
                lane.sub.fail(lane.index, ValueError(
                    f"device inflate failed: status {int(status[j])} "
                    f"({IS.STATUS_NAMES[int(status[j])]}), {int(out_len[j])}"
                    f" of {lane.expect} bytes"))
        counters.add_stats(IS.last_stats,
                           device_lanes=len(lanes) - len(flagged),
                           host_fallback=len(rescue))
        if rescue:
            counters.book_host_fallback("flagged", len(rescue))
            self._host_map(
                rescue, lambda lane: IS.host_inflate(lane.payload,
                                                     lane.expect))


class _RansEngine:
    """B3 over a chunk of order-0 streams; a lane's payload is ``(stream
    bytes, parsed meta)``, parsed on the submitting thread. A flagged
    lane is decoded again by the host codec."""

    kind = "rans"

    def __init__(self, device, host_map) -> None:
        self.device = device
        self._host_map = host_map

    def launch(self, lanes: Sequence[_Lane]):
        from disq_tpu_torch.ops import rans_simd as RS

        return RS.launch_streams([l.payload[1] for l in lanes], self.device)

    def finalize(self, handle, lanes: Sequence[_Lane]) -> None:
        from disq_tpu_torch.cram.rans import rans_decode
        from disq_tpu_torch.ops import rans_simd as RS

        blob, _used, status, _ren_off, out_off = RS.fetch_streams(handle)
        flagged = []
        for j, lane in enumerate(lanes):
            if status[j]:
                flagged.append(lane)
            else:
                lane.sub.deliver(lane.index,
                                 blob[out_off[j]: out_off[j + 1]].tobytes())
        counters.add_stats(RS.last_stats,
                           device_lanes=len(lanes) - len(flagged),
                           host_fallback=len(flagged))
        if flagged:
            counters.book_host_fallback("flagged", len(flagged))
            self._host_map(flagged, lambda lane: rans_decode(lane.payload[0]))


class _DeflateEngine:
    """W2 over a chunk of BGZF block payloads (each ≤ 65,280 bytes) under
    one table from the chunk's byte histogram (the sum of its lanes'),
    counted on the device in one pass; a lane's delivery is its framed
    BGZF block. Lanes the coder expanded go to host zlib."""

    kind = "deflate"

    def __init__(self, device, host_map) -> None:
        self.device = device
        self._host_map = host_map

    def launch(self, lanes: Sequence[_Lane]):
        from disq_tpu_torch.ops import deflate as DF
        from disq_tpu_torch.ops.inflate_simd import Staged

        n = len(lanes)
        pay_len = np.fromiter((len(l.payload) for l in lanes), np.int32, n)
        pay_off = np.zeros(n, dtype=np.int64)
        np.cumsum(pay_len[:-1], out=pay_off[1:])
        staged = Staged("deflate", [[l.payload for l in lanes], pay_off,
                                    pay_len], self.device)
        try:
            payload, po, pl = staged.tensors
            # the histogram's d2h waits for the staged copy, so the
            # arena is free once W2 is enqueued (on the CPU, once it ran)
            table = DF.DeflateTable(DF.histogram(payload), n)
            bodies, end = DF.encode(payload, po, pl,
                                    *table.luts(self.device),
                                    table.header_bits, table.out_bytes)
        finally:
            staged.release()
        return bodies, end, table

    def finalize(self, handle, lanes: Sequence[_Lane]) -> None:
        from disq_tpu_torch.ops import deflate as DF

        bodies, end, table = handle
        body_h, end_h = DF.fetch(bodies, end, table)
        del bodies, end
        DF.finalize_chunk(
            body_h, end_h, table, [l.payload for l in lanes],
            lambda j, blk: lanes[j].sub.deliver(lanes[j].index, blk),
            lambda flagged: self._host_map(
                [lanes[j] for j in flagged],
                lambda lane: DF.host_block(lane.payload)))


class DeviceDecodeService:
    """The dispatcher that owns the device queue (module docstring)."""

    def __init__(self, device=None,
                 flush_timeout_s: Optional[float] = None) -> None:
        import os

        from disq_tpu_torch.util import resolve_device

        self.device = resolve_device(device)
        if flush_timeout_s is None:
            flush_timeout_s = float(os.environ.get(
                "DISQ_TPU_TORCH_SERVICE_FLUSH_MS", "2")) / 1e3
        self.flush_timeout_s = flush_timeout_s
        # outstanding host-fallback lanes, waited out at close
        self._fallback_pending = 0
        # dispatch targets, snapshotted once: [None] (the service's own
        # device) unless the mesh knob was armed before service start,
        # then one sub-queue per mesh device (module docstring)
        from disq_tpu_torch.runtime.mesh import service_devices

        self._devices = service_devices(self.device)
        targets = [self.device if d is None else torch.device(d)
                   for d in self._devices]
        self._engines = [{
            "inflate": _InflateEngine(t, self._host_map),
            "rans": _RansEngine(t, self._host_map),
            "deflate": _DeflateEngine(t, self._host_map),
        } for t in targets]
        self._cond = threading.Condition()
        self._queues: Dict[str, List[Deque[_Lane]]] = {
            k: [deque() for _ in targets] for k in _KINDS}
        self._inflight: Deque[Tuple[str, int, Any, List[_Lane]]] = deque()
        self._closed = False
        self._window = _WINDOW * len(targets)
        self._streams = [(t, torch.cuda.Stream(t) if t.type == "cuda"
                          else None) for t in targets]
        self._thread = threading.Thread(
            target=self._run, name="disq-device-dispatch", daemon=True)
        self._thread.start()

    # -- submission ---------------------------------------------------------

    @property
    def alive(self) -> bool:
        return self._thread.is_alive() and not self._closed

    def submit_inflate(self, payloads: Sequence, usizes: Sequence[int],
                       host_rescue: bool = True) -> Submission:
        """One split's raw-DEFLATE payloads; the result is ``(blob,
        offsets)``, every block's bytes contiguous in submission order.
        ``host_rescue=False`` fails a flagged lane instead of decoding it
        again on the host (the serving plane's contract)."""
        n = len(payloads)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.asarray(usizes, dtype=np.int64), out=offsets[1:])
        sub = Submission(blob=np.empty(int(offsets[-1]), np.uint8),
                         offsets=offsets, host_rescue=host_rescue)
        ctx = _current_trace()
        lanes = [_Lane(sub, i, p, int(usizes[i]), ctx)
                 for i, p in enumerate(payloads)]
        self._enqueue("inflate", lanes, sub)
        return sub

    def submit_rans(self, streams: Sequence[bytes]) -> Submission:
        """Order-0 rANS streams; the result is the per-stream decoded
        bytes. Header and table parse run on this thread: a stream that
        does not parse records its error under its index."""
        from disq_tpu_torch.ops import rans_simd as RS

        sub = Submission(parts_n=len(streams))
        ctx = _current_trace()
        lanes: List[_Lane] = []
        for k, s in enumerate(streams):
            try:
                meta = RS._parse_stream(k, s)
            except Exception as e:  # noqa: BLE001 — this owner's lane only
                sub.fail_local(k, RS.stream_error(e, k))
                continue
            if meta is None:
                sub.deliver_local(k, b"")
                continue
            lanes.append(_Lane(sub, k, (s, meta), meta[0], ctx))
        self._enqueue("rans", lanes, sub)
        return sub

    def submit_deflate(self, payloads: Sequence) -> Submission:
        """One write shard's BGZF block payloads (each ≤ 65,280 bytes);
        the result is the framed BGZF blocks, in submission order. A
        payload over the bound raises here, on the caller's thread."""
        from disq_tpu_torch.bgzf.block import BGZF_MAX_PAYLOAD

        sub = Submission(parts_n=len(payloads))
        ctx = _current_trace()
        lanes: List[_Lane] = []
        for i, p in enumerate(payloads):
            if len(p) > BGZF_MAX_PAYLOAD:
                raise ValueError(
                    f"payload too large for one BGZF block: {len(p)}")
            if len(p) == 0:
                sub.deliver_local(i, b"")
            else:
                lanes.append(_Lane(sub, i, p, len(p), ctx))
        self._enqueue("deflate", lanes, sub)
        return sub

    def _enqueue(self, kind: str, lanes: List[_Lane],
                 sub: Submission) -> None:
        # the flush clock starts here, after this thread's own parsing
        now = time.perf_counter()
        for lane in lanes:
            lane.ts = now
        with self._cond:
            if self._closed:
                raise RuntimeError("device service is closed")
            qs = self._queues[kind]
            # the least-loaded device (one queue per codec when mesh-off)
            i = min(range(len(qs)), key=lambda j: sum(
                len(self._queues[k][j]) for k in _KINDS))
            qs[i].extend(lanes)
            depth = self._depth_locked()
            if sub._pending <= 0:
                sub._event.set()
            self._cond.notify_all()
        _observe_gauge("device.queue_depth", depth)

    def _host_map(self, lanes: List[_Lane], fn) -> None:
        """Deliver host-route lanes, fanned over the shared host pool so
        a degraded shard's re-decodes do not stall the dispatcher; a host
        failure fails only the owner's lane."""

        def one(lane: _Lane) -> None:
            try:
                val = fn(lane)
            except Exception as e:  # noqa: BLE001 — owner-only
                lane.sub.fail(lane.index, e)
            else:
                lane.sub.deliver(lane.index, val)

        if len(lanes) <= 1:
            for lane in lanes:
                one(lane)
            return
        from disq_tpu_torch.util import shared_host_pool

        def tracked(lane: _Lane) -> None:
            try:
                one(lane)
            finally:
                with self._cond:
                    self._fallback_pending -= 1
                    self._cond.notify_all()

        with self._cond:
            self._fallback_pending += len(lanes)
        pool = shared_host_pool()
        for lane in lanes:
            pool.submit(tracked, lane)

    def close(self, timeout: float = 60.0) -> None:
        """Drain the queues (partial chunks flush with ``reason=drain``),
        wait out the host-route lanes, and stop the dispatcher."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout)
        with self._cond:
            self._cond.wait_for(lambda: self._fallback_pending <= 0, timeout)

    # -- dispatcher ---------------------------------------------------------

    def _depth_locked(self) -> int:
        return sum(len(q) for qs in self._queues.values() for q in qs)

    def _on(self, dev_i: int):
        """Device and stream context of ``dev_i``'s launches (nothing on
        the CPU)."""
        import contextlib

        target, stream = self._streams[dev_i]
        stack = contextlib.ExitStack()
        if stream is not None:
            stack.enter_context(torch.cuda.device(target))
            stack.enter_context(torch.cuda.stream(stream))
        return stack

    def _run(self) -> None:
        try:
            self._loop()
        except BaseException as e:  # noqa: BLE001 — fail pending, not hang
            self._abort_all(e)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while True:
                    chunk = self._take_chunk_locked()
                    if chunk is not None or self._inflight:
                        break
                    if self._closed:
                        return
                    self._cond.wait(self._wait_s_locked())
            if chunk is not None:
                entry = self._launch(*chunk)
                if entry is not None:
                    self._inflight.append(entry)
            if self._inflight and (chunk is None
                                   or len(self._inflight) >= self._window):
                self._materialize(self._inflight.popleft())

    def _take_chunk_locked(self):
        now = time.perf_counter()
        # oldest lane first across the queues: a burst of full chunks on
        # one codec must not starve another's lanes past their deadline
        ready = sorted(((k, i) for k, qs in self._queues.items()
                        for i, q in enumerate(qs) if q),
                       key=lambda ki: self._queues[ki[0]][ki[1]][0].ts)
        for kind, dev_i in ready:
            q = self._queues[kind][dev_i]
            if len(q) >= LANES:
                lanes = [q.popleft() for _ in range(LANES)]
                reason = "full"
            elif self._closed or now - q[0].ts >= self.flush_timeout_s:
                lanes = list(q)
                q.clear()
                reason = "drain" if self._closed else "timeout"
            else:
                continue
            return kind, dev_i, lanes, reason
        return None

    def _wait_s_locked(self) -> Optional[float]:
        now = time.perf_counter()
        waits = [self.flush_timeout_s - (now - q[0].ts)
                 for qs in self._queues.values() for q in qs if q]
        if not waits:
            return None  # nothing queued: sleep until a notify
        return max(1e-3, min(waits))

    def _launch(self, kind: str, dev_i: int, lanes: List[_Lane],
                reason: str):
        _counter("device.batch.flush").inc(reason=reason)
        _flightrec.record_event("device_flush", codec=kind,
                                reason=reason, lanes=len(lanes))
        # mesh-off keeps the unlabelled gauge; a device list labels the
        # fill per device so one device's partial chunks stay visible
        if self._devices[dev_i] is None:
            _observe_gauge("device.lane_fill", len(lanes) / LANES)
        else:
            _observe_gauge("device.lane_fill", len(lanes) / LANES,
                           device=str(dev_i))
        with self._cond:
            depth = self._depth_locked()
        _observe_gauge("device.queue_depth", depth)
        _record_span("device.service.wait",
                     time.perf_counter() - min(l.ts for l in lanes),
                     kind=kind, lanes=len(lanes))
        # a coalesced launch serves several requests: each traced owner
        # books its share of queue wait and launch time
        owners: Dict[Tuple[str, str, str], List[_Lane]] = {}
        for lane in lanes:
            if lane.trace is not None:
                owners.setdefault((lane.trace.trace_id, lane.trace.span_id,
                                   lane.trace.tenant), []).append(lane)
        if owners:
            _counter("device.batch.requests").inc(requests=str(len(owners)))
        t_launch = time.perf_counter()
        try:
            with self._on(dev_i):
                handle = self._engines[dev_i][kind].launch(lanes)
        except BaseException as e:  # noqa: BLE001 — the owners, not the loop
            for lane in lanes:
                lane.sub.fail(lane.index, e)
            return None
        if owners:
            launch_s = time.perf_counter() - t_launch
            for own in owners.values():
                share = launch_s * len(own) / len(lanes)
                wait = t_launch - min(l.ts for l in own)
                with _trace_scope(own[0].trace):
                    _record_span("device.batch.share", max(0.0, wait) + share,
                                 kind=kind, lanes=len(own),
                                 batch_lanes=len(lanes))
        return kind, dev_i, handle, lanes

    def _materialize(self, entry) -> None:
        kind, dev_i, handle, lanes = entry
        try:
            with self._on(dev_i):
                self._engines[dev_i][kind].finalize(handle, lanes)
        except BaseException as e:  # noqa: BLE001 — the owners, not the loop
            for lane in lanes:
                lane.sub.fail(lane.index, e)

    def _abort_all(self, exc: BaseException) -> None:
        with self._cond:
            self._closed = True
            pending = [l for qs in self._queues.values() for q in qs
                       for l in q]
            for qs in self._queues.values():
                for q in qs:
                    q.clear()
            inflight = list(self._inflight)
            self._inflight.clear()
        for _kind, _dev_i, _handle, lanes in inflight:
            pending.extend(lanes)
        for lane in pending:
            lane.sub.fail(lane.index, exc)


# ---------------------------------------------------------------------------
# Process-wide singleton (lazy: the disabled path touches none of this)
# ---------------------------------------------------------------------------

_SERVICE: Optional[DeviceDecodeService] = None
_SERVICE_LOCK = threading.Lock()


def enabled() -> bool:
    """True when ``DISQ_TPU_TORCH_DEVICE_SERVICE`` is set truthy: the
    codec entry points then route device work through the service."""
    from disq_tpu_torch.runtime.debug import env_flag

    return env_flag("DISQ_TPU_TORCH_DEVICE_SERVICE")


def get_service(device=None) -> DeviceDecodeService:
    """The process-wide service on ``device`` (``cuda`` unless asked
    otherwise), created on first use. One service serves one device:
    asking for another while it runs raises."""
    global _SERVICE
    from disq_tpu_torch.util import resolve_device

    device = resolve_device(device)
    with _SERVICE_LOCK:
        if _SERVICE is None or not _SERVICE.alive:
            _SERVICE = DeviceDecodeService(device)
        elif _SERVICE.device != device and not (
                device.type == _SERVICE.device.type == "cuda"
                and device.index is None):
            raise ValueError(f"the device service runs on "
                             f"{_SERVICE.device}, not {device}")
        return _SERVICE


def service_if_running() -> Optional[DeviceDecodeService]:
    """The live service or None; never creates one."""
    return _SERVICE


def shutdown_service() -> None:
    global _SERVICE
    with _SERVICE_LOCK:
        service, _SERVICE = _SERVICE, None
    if service is not None:
        service.close()
