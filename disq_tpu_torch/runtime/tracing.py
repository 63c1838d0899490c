"""Structured telemetry: a labeled metrics registry and per-shard span
timelines, the counterpart of ``disq_tpu/runtime/tracing.py``.

- **Metrics registry** (``MetricsRegistry`` / module-level ``REGISTRY``):
  labeled ``Counter`` / ``Gauge`` (min/max/last/mean) / fixed-bucket
  ``Histogram`` handles, thread-safe and resettable. Exported as
  Prometheus text by ``metrics_text()`` under the reference's
  ``disq_tpu_`` series names (a scraper reads either package), and as a
  dict by ``telemetry_snapshot()`` / ``telemetry_summary()``.
- **Span timeline**: ``span(name, shard=…)`` emits ``{ts, dur, name,
  labels}`` events with a process-wide ``RUN_ID`` and the emitting
  thread's native id (``tid``, the id the profiler's CPU rows carry)
  into a bounded ring (64k events; overflow drops the oldest and counts
  ``telemetry.dropped_spans``) and an optional JSONL sink
  (``DISQ_TPU_TORCH_TRACE_JSONL``, ``start_span_log(path)`` or
  ``DisqOptions.span_log``), the input of ``scripts/trace_report.py``.
- **Device spans**: ``device_span`` / ``synced_timer`` close on a CUDA
  event recorded on the registered tensors' current stream and
  synchronized, so a span covers the device work it launched; on CPU
  tensors the fence is a no-op. A kernel launch is booked once, by the
  kernel's wrapper where it launches (``runtime/counters.py``), so a
  device span books none. ``track_hbm`` is the reference's array-size
  arithmetic (what the port put on the device), not an allocator query.
- **Exporters**: Chrome/Perfetto ``trace_event`` JSON
  (``chrome_trace_events`` / ``export_chrome_trace``, device spans on
  pid 2) and the Prometheus text.
- **torch.profiler bridge**: ``trace_phase(name)`` also opens a
  ``torch.profiler.record_function`` range; ``start_trace(dir)`` (or
  ``DISQ_TPU_TORCH_TRACE_DIR``, started at the first phase) runs a
  ``torch.profiler.profile`` that ``stop_trace()`` (or process exit)
  exports as a Chrome trace into ``dir``, with the ring's spans of the
  capture added on the profiler's clock (one row per thread), so a
  kernel or an idle stretch of the card sits under the host spans that
  were open then.

The port emits the reference's names with the reference's kinds, so the
README's metric table documents both packages; the few spans only the
port has are listed in the README's second table (``port-metrics``).
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

logger = logging.getLogger("disq_tpu_torch.tracing")

# Process-wide run id: every span carries it, so timelines from
# different runs/processes appended to one JSONL stay separable.
RUN_ID = f"{os.getpid():x}-{time.time_ns() & 0xFFFFFFFF:08x}"

# Default latency buckets (seconds): spans are I/O + decode phases that
# range from sub-millisecond (cache hit) to tens of seconds (cold
# remote shard).  Fixed buckets keep observe() O(len(buckets)) with no
# allocation.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_LabelKey = Tuple[Tuple[str, Any], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted(labels.items()))


def _label_str(key: _LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


class Counter:
    """Monotonic labeled counter handle: ``inc(n, **labels)``."""

    kind = "counter"

    def __init__(self, name: str, registry: "MetricsRegistry") -> None:
        self.name = name
        self._registry = registry
        self._values: Dict[_LabelKey, float] = {}

    def inc(self, n: float = 1, **labels: Any) -> None:
        key = _label_key(labels)
        with self._registry._lock:
            self._values[key] = self._values.get(key, 0) + n

    def value(self, **labels: Any) -> float:
        """Value for one exact labelset (no labels ⇒ the unlabeled
        series)."""
        with self._registry._lock:
            return self._values.get(_label_key(labels), 0)

    def total(self) -> float:
        """Sum across every labelset."""
        with self._registry._lock:
            return sum(self._values.values())

    def _reset(self) -> None:
        self._values.clear()

    def _snapshot(self) -> Dict[str, float]:
        return {_label_str(k): v for k, v in sorted(self._values.items())}


class Gauge:
    """Level-style labeled quantity (queue depth, in-flight shards):
    keeps min / max / last / mean per labelset — gauges are states, not
    durations."""

    kind = "gauge"

    def __init__(self, name: str, registry: "MetricsRegistry") -> None:
        self.name = name
        self._registry = registry
        self._states: Dict[_LabelKey, Dict[str, float]] = {}

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        with self._registry._lock:
            g = self._states.get(key)
            if g is None:
                self._states[key] = {
                    "min": value, "max": value, "last": value,
                    "sum": value, "samples": 1,
                }
            else:
                g["min"] = min(g["min"], value)
                g["max"] = max(g["max"], value)
                g["last"] = value
                g["sum"] += value
                g["samples"] += 1

    def state(self, **labels: Any) -> Optional[Dict[str, float]]:
        with self._registry._lock:
            g = self._states.get(_label_key(labels))
            return None if g is None else self._view(g)

    @staticmethod
    def _view(g: Dict[str, float]) -> Dict[str, float]:
        out = {k: g[k] for k in ("min", "max", "last", "samples")}
        out["mean"] = g["sum"] / g["samples"] if g["samples"] else 0.0
        return out

    def _reset(self) -> None:
        self._states.clear()

    def _snapshot(self) -> Dict[str, Dict[str, float]]:
        return {
            _label_str(k): self._view(g)
            for k, g in sorted(self._states.items())
        }


class Histogram:
    """Fixed-bucket labeled histogram with percentile estimation.

    ``observe(seconds)`` is O(len(buckets)); ``percentile(p)`` linearly
    interpolates inside the winning bucket, clamped to the observed
    min/max so a single sample reports itself exactly."""

    kind = "histogram"

    def __init__(self, name: str, registry: "MetricsRegistry",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                 unit: str = "seconds") -> None:
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self.unit = unit
        self._registry = registry
        # labelset -> [bucket counts... , +Inf count]
        self._counts: Dict[_LabelKey, List[int]] = {}
        self._stats: Dict[_LabelKey, Dict[str, float]] = {}

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        with self._registry._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
                self._stats[key] = {"count": 0, "sum": 0.0,
                                    "min": value, "max": value}
            i = 0
            for i, b in enumerate(self.buckets):  # noqa: B007
                if value <= b:
                    break
            else:
                i = len(self.buckets)
            counts[i] += 1
            st = self._stats[key]
            st["count"] += 1
            st["sum"] += value
            st["min"] = min(st["min"], value)
            st["max"] = max(st["max"], value)

    # -- read side ---------------------------------------------------------

    def _merged(self) -> Tuple[List[int], Dict[str, float]]:
        """Aggregate counts+stats across every labelset (caller holds
        the registry lock)."""
        counts = [0] * (len(self.buckets) + 1)
        stats = {"count": 0, "sum": 0.0, "min": float("inf"), "max": 0.0}
        for key, c in self._counts.items():
            for i, n in enumerate(c):
                counts[i] += n
            st = self._stats[key]
            stats["count"] += st["count"]
            stats["sum"] += st["sum"]
            stats["min"] = min(stats["min"], st["min"])
            stats["max"] = max(stats["max"], st["max"])
        if stats["count"] == 0:
            stats["min"] = 0.0
        return counts, stats

    @property
    def count(self) -> int:
        with self._registry._lock:
            return self._merged()[1]["count"]

    @property
    def sum(self) -> float:
        with self._registry._lock:
            return self._merged()[1]["sum"]

    def percentile(self, p: float) -> float:
        """Estimate the p-th percentile (p in [0, 100]) across all
        labelsets from the bucket counts."""
        with self._registry._lock:
            counts, stats = self._merged()
        total = stats["count"]
        if total == 0:
            return 0.0
        rank = p / 100.0 * total
        cum = 0
        lo = stats["min"]
        for i, n in enumerate(counts):
            if n == 0:
                continue
            hi = (self.buckets[i] if i < len(self.buckets)
                  else stats["max"])
            if cum + n >= rank:
                frac = (rank - cum) / n
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return max(stats["min"], min(stats["max"], est))
            cum += n
            lo = hi
        return stats["max"]

    def _reset(self) -> None:
        self._counts.clear()
        self._stats.clear()

    def _snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key in sorted(self._counts):
            counts = self._counts[key]
            st = self._stats[key]
            out[_label_str(key)] = {
                "count": st["count"],
                "sum": round(st["sum"], 6),
                "min": round(st["min"], 6),
                "max": round(st["max"], 6),
                "buckets": {
                    ("+Inf" if i == len(self.buckets)
                     else repr(self.buckets[i])): n
                    for i, n in enumerate(counts) if n
                },
            }
        return out


class MetricsRegistry:
    """Thread-safe named-metric registry.  ``counter`` / ``gauge`` /
    ``histogram`` create-or-return handles; registering one name as two
    different kinds raises (the metric-name lint makes that a CI
    failure before it is a runtime one)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, factory: Callable[[], Any], kind: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, lambda: Counter(name, self), "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, lambda: Gauge(name, self), "gauge")

    def histogram(self, name: str,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  unit: str = "seconds") -> Histogram:
        return self._get(
            name, lambda: Histogram(name, self, buckets, unit), "histogram")

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._metrics)

    def reset(self) -> None:
        """Zero every metric (handles stay registered, so references
        held by long-lived objects keep working)."""
        with self._lock:
            for m in self._metrics.values():
                m._reset()

    # -- exporters ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Full registry state as a JSON-serializable dict:
        ``{"counters": …, "gauges": …, "histograms": …}``, each keyed
        by metric name then labelset string (``""`` = unlabeled)."""
        out: Dict[str, Dict[str, Any]] = {
            "counters": {}, "gauges": {}, "histograms": {},
        }
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                snap = m._snapshot()
                if snap:
                    out[m.kind + "s"][name] = snap
        return out

    def summary(self) -> Dict[str, Any]:
        """Compact one-level summary:
        counters as cross-label totals, gauges as last/max, histograms
        as calls/total/p50/p99.  The lock (re-entrant) is held across
        the whole walk so concurrent first-observations of a labelset
        can't mutate a state dict mid-iteration."""
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "phases": {}}
        with self._lock:
            items = sorted(self._metrics.items())
            for name, m in items:
                self._summarize_one(name, m, out)
        return out

    def _summarize_one(self, name: str, m, out: Dict[str, Any]) -> None:
        # caller holds self._lock
        if m.kind == "counter":
            total = m.total()
            if total:
                out["counters"][name] = total
        elif m.kind == "gauge":
            snap = m._snapshot()
            if snap:
                merged = list(snap.values())
                out["gauges"][name] = {
                    "last": merged[-1]["last"],
                    "max": max(g["max"] for g in merged),
                }
        else:
            if m.count:
                out["phases"][name] = {
                    "calls": m.count,
                    "total_s": round(m.sum, 6),
                    "p50_s": round(m.percentile(50), 6),
                    "p99_s": round(m.percentile(99), 6),
                }

    def metrics_text(self) -> str:
        """Prometheus text exposition.  Dotted names become
        ``disq_tpu_``-prefixed underscore names; histograms get the
        conventional ``_bucket``/``_sum``/``_count`` series with
        cumulative ``le`` labels."""
        def prom_name(name: str) -> str:
            return "disq_tpu_" + name.replace(".", "_")

        def esc(v: Any) -> str:
            return str(v).replace("\\", "\\\\").replace('"', '\\"')

        def fmt_labels(key: _LabelKey, extra: str = "") -> str:
            parts = ['%s="%s"' % (k, esc(v)) for k, v in key]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        def fmt_val(v: float) -> str:
            return repr(round(v, 9)) if isinstance(v, float) else str(v)

        lines: List[str] = []
        with self._lock:
            items = sorted(self._metrics.items())
            for name, m in items:
                pn = prom_name(name)
                if m.kind == "counter":
                    if not m._values:
                        continue
                    lines.append(f"# TYPE {pn} counter")
                    for key, v in sorted(m._values.items()):
                        lines.append(f"{pn}{fmt_labels(key)} {fmt_val(v)}")
                elif m.kind == "gauge":
                    if not m._states:
                        continue
                    lines.append(f"# TYPE {pn} gauge")
                    for key, g in sorted(m._states.items()):
                        lines.append(
                            f"{pn}{fmt_labels(key)} {fmt_val(g['last'])}")
                else:
                    if not m._counts:
                        continue
                    hn = pn + ("_" + m.unit if m.unit else "")
                    lines.append(f"# TYPE {hn} histogram")
                    for key in sorted(m._counts):
                        counts = m._counts[key]
                        st = m._stats[key]
                        cum = 0
                        for i, n in enumerate(counts):
                            cum += n
                            le = ("+Inf" if i == len(m.buckets)
                                  else repr(m.buckets[i]))
                            lines.append(
                                "%s_bucket%s %d" % (
                                    hn, fmt_labels(key, 'le="%s"' % le), cum))
                        lines.append(
                            f"{hn}_sum{fmt_labels(key)} "
                            f"{fmt_val(st['sum'])}")
                        lines.append(
                            f"{hn}_count{fmt_labels(key)} "
                            f"{int(st['count'])}")
        return "\n".join(lines) + ("\n" if lines else "")


REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str,
              buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, buckets)


def metrics_text() -> str:
    return REGISTRY.metrics_text()


def telemetry_snapshot() -> Dict[str, Any]:
    return REGISTRY.snapshot()


def telemetry_summary() -> Dict[str, Any]:
    return REGISTRY.summary()


# ---------------------------------------------------------------------------
# Request-scoped trace context: causal identity across threads/processes
# ---------------------------------------------------------------------------
#
# A TraceContext is the causal identity of one request, carried via
# contextvars: every span emitted under it is stamped with its trace id.
# Across the device service's thread hop, the submitting thread's
# context rides on each queued lane and the dispatcher re-activates it
# per owner via ``trace_scope`` when booking that owner's share. An HTTP
# hop (the remote filesystem's ranged GETs and HEADs) carries the
# context out in the X-Disq-Trace-* headers (``inject_trace_headers``).
# The serving edge (``runtime/serve.py``, ``runtime/fleet.py``) adopts an
# inbound context (``trace_from_headers``) or, under
# DISQ_TPU_TORCH_TRACE_REQUESTS, mints a root one (``mint_trace``). With
# no context active, ``current_trace()`` is one ContextVar read and no id
# is ever minted.

TRACE_ID_HEADER = "X-Disq-Trace-Id"
TRACE_PARENT_HEADER = "X-Disq-Trace-Parent"
TRACE_TENANT_HEADER = "X-Disq-Trace-Tenant"


class TraceContext:
    """Immutable causal identity of one request: the trace id shared by
    every hop, the parent span/hop id that reached here, the tenant."""

    __slots__ = ("trace_id", "span_id", "tenant")

    def __init__(self, trace_id: str, span_id: str, tenant: str) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.tenant = tenant

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TraceContext(trace_id={self.trace_id!r}, "
                f"span_id={self.span_id!r}, tenant={self.tenant!r})")


_trace_var: "contextvars.ContextVar[Optional[TraceContext]]" = (
    contextvars.ContextVar("disq_tpu_torch_trace", default=None))
_trace_mint_lock = threading.Lock()
_trace_ids_minted = 0
_trace_span_seq = 0
_trace_env_resolved = False
_trace_requests = False


def trace_requests_enabled() -> bool:
    """True when ``DISQ_TPU_TORCH_TRACE_REQUESTS`` is set truthy: the
    serving edge then mints a trace for requests that arrive without
    one. Resolved once per process (explicit headers always win)."""
    global _trace_env_resolved, _trace_requests
    if not _trace_env_resolved:
        with _trace_mint_lock:
            if not _trace_env_resolved:
                _trace_requests = os.environ.get(
                    "DISQ_TPU_TORCH_TRACE_REQUESTS", "").lower() not in (
                        "", "0", "false", "off")
                _trace_env_resolved = True
    return _trace_requests


def current_trace() -> Optional[TraceContext]:
    """The active request context, or None (the common, free case)."""
    return _trace_var.get()


def _mint_id(nbytes: int = 8) -> str:
    global _trace_ids_minted
    with _trace_mint_lock:
        _trace_ids_minted += 1
    return os.urandom(nbytes).hex()


def trace_ids_minted() -> int:
    """How many trace/span ids this process has minted: the disabled
    path's checks hold it at 0."""
    with _trace_mint_lock:
        return _trace_ids_minted


def mint_trace(tenant: str) -> TraceContext:
    """A fresh root context at the serving edge."""
    return TraceContext(_mint_id(8), _mint_id(4), str(tenant))


def child_context(ctx: TraceContext) -> TraceContext:
    """A hop-local context under ``ctx``'s trace: the same trace id and
    tenant, a fresh hop id (a sequence, not entropy: hop ids need only be
    unique within one process's part of the trace)."""
    global _trace_span_seq
    with _trace_mint_lock:
        _trace_span_seq += 1
        seq = _trace_span_seq
    return TraceContext(ctx.trace_id, f"{RUN_ID}-{seq:x}", ctx.tenant)


def activate_trace(ctx: TraceContext) -> "contextvars.Token":
    """Make ``ctx`` the active context of this thread; returns the token
    for ``deactivate_trace``."""
    return _trace_var.set(ctx)


def deactivate_trace(token: "contextvars.Token") -> None:
    _trace_var.reset(token)


def reset_trace_state() -> None:
    """Test hook: forget the env resolution and zero the mint counter
    (an active context of the calling thread stays)."""
    global _trace_env_resolved, _trace_requests, _trace_ids_minted
    global _trace_span_seq
    with _trace_mint_lock:
        _trace_env_resolved = False
        _trace_requests = False
        _trace_ids_minted = 0
        _trace_span_seq = 0


def inject_trace_headers(headers: Dict[str, str]) -> Dict[str, str]:
    """Add ``X-Disq-Trace-*`` to an outbound header dict when a context
    is active; with none active this is one ContextVar read and the
    dict is returned untouched."""
    ctx = _trace_var.get()
    if ctx is not None:
        headers[TRACE_ID_HEADER] = ctx.trace_id
        headers[TRACE_PARENT_HEADER] = ctx.span_id
        headers[TRACE_TENANT_HEADER] = ctx.tenant
    return headers


def trace_from_headers(headers: Any) -> Optional[TraceContext]:
    """The inbound context of an HTTP request's headers (any mapping
    with ``.get``), or None when it carries no trace id."""
    trace_id = headers.get(TRACE_ID_HEADER)
    if not trace_id:
        return None
    return TraceContext(str(trace_id),
                        str(headers.get(TRACE_PARENT_HEADER) or ""),
                        str(headers.get(TRACE_TENANT_HEADER) or "anon"))


@contextlib.contextmanager
def trace_scope(ctx: Optional[TraceContext]) -> Iterator[None]:
    """Scope ``ctx`` (None = no-op) over a block — used by the device
    dispatcher to book each owner's share under its own trace."""
    if ctx is None:
        yield
        return
    token = _trace_var.set(ctx)
    try:
        yield
    finally:
        _trace_var.reset(token)


# ---------------------------------------------------------------------------
# Span timeline: bounded ring + optional JSONL sink
# ---------------------------------------------------------------------------

DEFAULT_SPAN_RING = 65536

_span_lock = threading.Lock()
_span_ring: "deque[Dict[str, Any]]" = deque(maxlen=DEFAULT_SPAN_RING)
_span_sink = None            # open file object, or None
_span_sink_path: Optional[str] = None
_span_writes = 0             # lines since the last explicit flush
_sink_dropped_base = 0.0     # telemetry.dropped_spans total when this
                             # sink opened — the stop trailer reports
                             # only drops during the sink's lifetime
_SINK_FLUSH_EVERY = 64       # amortize flushes: a synchronous flush per
                             # span would serialize every worker thread
                             # on trace-disk latency (close() flushes
                             # the tail, so at most this many spans are
                             # lost to a hard crash)
_env_resolved = False        # DISQ_TPU_TORCH_TRACE_JSONL honored at first use


def _resolve_span_env() -> None:
    global _env_resolved
    if _env_resolved:
        return
    with _span_lock:
        if _env_resolved:
            return
        _env_resolved = True
        path = os.environ.get("DISQ_TPU_TORCH_TRACE_JSONL")
    if path and _span_sink is None:
        start_span_log(path)


def start_span_log(path: str) -> None:
    """Start (or re-point) the JSONL span sink.  Each emitted span is
    appended as one JSON line; a meta line maps this run's monotonic
    clock to the epoch so timelines from multiple runs stay
    separable."""
    global _span_sink, _span_sink_path, _env_resolved, _sink_dropped_base
    dropped_now = REGISTRY.counter("telemetry.dropped_spans").total()
    with _span_lock:
        _env_resolved = True  # explicit call wins over the env knob
        if _span_sink is not None:
            if _span_sink_path == path:
                return
            _span_sink.close()
        _sink_dropped_base = dropped_now
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _span_sink = open(path, "a")
        _span_sink_path = path
        _span_sink.write(json.dumps({
            "meta": 1, "run_id": RUN_ID, "pid": os.getpid(),
            "epoch": time.time(), "mono": time.perf_counter(),
        }) + "\n")
        _span_sink.flush()
        atexit.register(stop_span_log)


def stop_span_log() -> None:
    global _span_sink, _span_sink_path, _span_writes
    total = REGISTRY.counter("telemetry.dropped_spans").total()
    with _span_lock:
        if _span_sink is not None:
            dropped = int(total - _sink_dropped_base)
            if dropped > 0:
                # Trailer meta line: the in-memory ring overflowed
                # during this sink's lifetime, so any ring-derived view
                # (/spans, chrome export) is truncated even though the
                # JSONL itself is complete — trace_report surfaces it
                # as a banner instead of silently rendering a partial
                # waterfall.
                _span_sink.write(json.dumps({
                    "meta": 1, "run_id": RUN_ID,
                    "dropped_spans": dropped,
                }) + "\n")
            _span_sink.close()  # flushes any buffered tail
            _span_sink = None
            _span_sink_path = None
            _span_writes = 0


def span_log_path() -> Optional[str]:
    with _span_lock:
        return _span_sink_path


def set_span_ring_capacity(n: int) -> None:
    """Resize the in-memory span ring (keeps the most recent spans)."""
    global _span_ring
    with _span_lock:
        _span_ring = deque(_span_ring, maxlen=max(1, int(n)))


def spans() -> List[Dict[str, Any]]:
    """Snapshot of the in-memory span ring, oldest first."""
    with _span_lock:
        return list(_span_ring)


def reset_spans() -> None:
    with _span_lock:
        _span_ring.clear()


def _emit_span(name: str, ts: float, dur: float,
               labels: Dict[str, Any]) -> None:
    global _span_writes
    REGISTRY.histogram(name).observe(dur)
    rec = {"ts": round(ts, 6), "dur": round(dur, 6), "name": name,
           "run": RUN_ID, "tid": threading.get_native_id(),
           "labels": labels}
    ctx = _trace_var.get()
    if ctx is not None:
        rec["trace"] = ctx.trace_id
        rec["parent"] = ctx.span_id
        rec["tenant"] = ctx.tenant
    # Serialize outside the lock (unlocked sink check is benign: worst
    # case one wasted dumps around a concurrent start/stop).
    line = (json.dumps(rec, default=str) + "\n"
            if _span_sink is not None else None)
    with _span_lock:
        dropped = len(_span_ring) == _span_ring.maxlen
        _span_ring.append(rec)
        if _span_sink is not None:
            if line is None:
                line = json.dumps(rec, default=str) + "\n"
            _span_sink.write(line)
            _span_writes += 1
            if _span_writes >= _SINK_FLUSH_EVERY:
                _span_sink.flush()
                _span_writes = 0
    if dropped:
        REGISTRY.counter("telemetry.dropped_spans").inc()
    logger.debug("span %s: %.4fs %s", name, dur, labels)


@contextlib.contextmanager
def span(name: str, **labels: Any) -> Iterator[None]:
    """Timeline span: emits a ``{ts, dur, name, labels}`` event into the
    ring/JSONL and books the duration in the ``name`` histogram (so
    ``phase_report()`` and percentiles see it)."""
    _resolve_span_env()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _emit_span(name, t0, time.perf_counter() - t0, labels)


def record_span(name: str, seconds: float, **labels: Any) -> None:
    """Book an already-measured duration as a span ending now (for
    waits timed inline — e.g. the executor's ordered-emit stall — where
    a context manager would nest a lock inside a condition wait)."""
    _resolve_span_env()
    now = time.perf_counter()
    _emit_span(name, now - seconds, seconds, labels)


def wrap_span(name: str, fn: Callable, **labels: Any) -> Callable:
    """``fn`` wrapped in ``span(name, **labels)`` — for handing staged
    callables (executor ``ShardTask.fetch``/``decode``) a per-shard
    span without changing their signatures."""
    def wrapped(*args: Any, **kwargs: Any):
        with span(name, **labels):
            return fn(*args, **kwargs)
    return wrapped



# ---------------------------------------------------------------------------
# Device telemetry: synced kernel spans, transfer counters, HBM gauge
# ---------------------------------------------------------------------------


def fence(tensors) -> None:
    """Wait for the device work that produces ``tensors``: one CUDA event
    per device, recorded on that device's current stream (the stream the
    work was enqueued on) and synchronized. CPU tensors need nothing."""
    import torch

    devices = {t.device for t in tensors
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        with torch.cuda.device(dev):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            ev.synchronize()


class _DeviceSync:
    """Handle yielded by ``device_span``: the body registers its device
    outputs with ``sync(...)``; the span's close fences on them."""

    __slots__ = ("_values",)

    def __init__(self) -> None:
        self._values: List[Any] = []

    def sync(self, *values: Any):
        """Register tensors (or tuples / lists / dicts of them) to fence
        on at span close. Returns the single value (or the tuple) so a
        call site can wrap an expression in place."""
        self._values.extend(values)
        return values[0] if len(values) == 1 else values

    def materialize(self) -> None:
        leaves: List[Any] = []
        stack = list(self._values)
        while stack:
            v = stack.pop()
            if isinstance(v, (list, tuple)):
                stack.extend(v)
            elif isinstance(v, dict):
                stack.extend(v.values())
            else:
                leaves.append(v)
        self._values.clear()
        fence(leaves)


@contextlib.contextmanager
def device_span(name: str, **labels: Any) -> Iterator[_DeviceSync]:
    """Span over device work whose close is a true sync point: the body
    hands its output tensors to ``.sync(...)`` and the span fences on
    them before taking the end timestamp, so its duration is the host
    wall time up to the end of the device work."""
    _resolve_span_env()
    handle = _DeviceSync()
    t0 = time.perf_counter()
    try:
        yield handle
    finally:
        handle.materialize()
        _emit_span(name, t0, time.perf_counter() - t0, labels)


def synced_timer(name: str, **labels: Any) -> Callable:
    """Decorator form of ``device_span``: times the wrapped function and
    fences on its return value before the span closes."""
    def deco(fn: Callable) -> Callable:
        def wrapped(*args: Any, **kwargs: Any):
            with device_span(name, **labels) as fence_:
                return fence_.sync(fn(*args, **kwargs))
        return wrapped
    return deco


def count_transfer(direction: str, nbytes: int) -> None:
    """Book one explicit host↔device transfer (``direction`` ``"h2d"``
    or ``"d2h"``) in the ``device.bytes_*`` counters."""
    if direction == "h2d":
        REGISTRY.counter("device.bytes_to_device").inc(int(nbytes))
    else:
        REGISTRY.counter("device.bytes_to_host").inc(int(nbytes))


_hbm_lock = threading.Lock()
_hbm_live = 0


def track_hbm(nbytes: int) -> int:
    """Adjust the live device-footprint estimate (negative to release)
    and observe the ``device.hbm_bytes`` gauge; returns the new estimate.
    Array-size arithmetic, not an allocator query: it tracks what the
    port put on the device, and runs the same on the CPU."""
    global _hbm_live
    with _hbm_lock:
        _hbm_live = max(0, _hbm_live + int(nbytes))
        live = _hbm_live
    REGISTRY.gauge("device.hbm_bytes").observe(live)
    return live


def hbm_live_bytes() -> int:
    with _hbm_lock:
        return _hbm_live


@contextlib.contextmanager
def hbm_resident(nbytes: int) -> Iterator[None]:
    """Scope one call's device residency: adds ``nbytes`` to the live
    estimate on entry and releases it on exit, so the gauge's max is the
    peak concurrent footprint across overlapping device calls."""
    track_hbm(nbytes)
    try:
        yield
    finally:
        track_hbm(-nbytes)


# ---------------------------------------------------------------------------
# Chrome/Perfetto trace_event export
# ---------------------------------------------------------------------------


_DEVICE_TRACK_PID = 2  # device.* spans render as their own process row


def chrome_trace_events(
    span_list: Optional[List[Dict[str, Any]]] = None
) -> List[Dict[str, Any]]:
    """Spans as Chrome ``trace_event`` complete events (``ph: "X"``,
    microseconds). Rows (``tid``) are shard ids when the span carries
    one; ``device.*`` spans land on their own track (process row 2,
    named by metadata events)."""
    events = []
    has_device = False
    for s in (spans() if span_list is None else span_list):
        labels = s.get("labels") or {}
        tid = labels.get("shard")
        try:
            tid = int(tid)
        except (TypeError, ValueError):
            tid = 0
        device = s["name"].startswith("device.")
        has_device = has_device or device
        events.append({
            "name": s["name"],
            "ph": "X",
            "ts": round(s["ts"] * 1e6, 3),
            "dur": round(s["dur"] * 1e6, 3),
            "pid": _DEVICE_TRACK_PID if device else 1,
            "tid": tid,
            "args": labels,
        })
    if has_device:
        events = [
            {"name": "process_name", "ph": "M", "pid": 1,
             "args": {"name": "host"}},
            {"name": "process_name", "ph": "M", "pid": _DEVICE_TRACK_PID,
             "args": {"name": "device"}},
        ] + events
    return events


def export_chrome_trace(path: str,
                        span_list: Optional[List[Dict[str, Any]]] = None
                        ) -> None:
    with open(path, "w") as f:
        # default=str: label values may be numpy scalars
        json.dump({"traceEvents": chrome_trace_events(span_list),
                   "displayTimeUnit": "ms"}, f, default=str)


# ---------------------------------------------------------------------------
# torch.profiler bridge + phase views
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_profiler = None              # the running torch.profiler.profile, or None
_profiler_dir: Optional[str] = None
_profiler_anchor: Optional[Tuple[float, int]] = None  # (perf_counter, time_ns)
_phase_env_resolved = False
_trace_dir: Optional[str] = None


def _resolve_phase_env() -> None:
    global _phase_env_resolved, _trace_dir
    if _phase_env_resolved:
        return
    with _lock:
        if not _phase_env_resolved:
            _trace_dir = os.environ.get("DISQ_TPU_TORCH_TRACE_DIR")
            _phase_env_resolved = True


def start_trace(trace_dir: str) -> None:
    """Begin a ``torch.profiler`` capture (host ops, and the card's
    kernels and copies when CUDA is available); ``stop_trace()`` or
    process exit writes it into ``trace_dir`` as a Chrome trace. The
    capture's start is sampled on both clocks at once, the spans'
    (``time.perf_counter``) and the profiler's (the epoch's), which is
    what places the spans in the exported file."""
    global _profiler, _profiler_dir, _profiler_anchor
    import torch

    with _lock:
        if _profiler is not None:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        _profiler, _profiler_dir = prof, trace_dir
        _profiler_anchor = (time.perf_counter(), time.time_ns())
        atexit.register(stop_trace)


def stop_trace() -> Optional[str]:
    """End the capture and export it with the spans of the capture
    merged in (``merge_spans``): returns the Chrome trace's path
    (``<dir>/trace-<run id>.json``), or None when none was running."""
    global _profiler, _profiler_dir, _profiler_anchor
    with _lock:
        prof, trace_dir, anchor = _profiler, _profiler_dir, _profiler_anchor
        _profiler = _profiler_dir = _profiler_anchor = None
    if prof is None:
        return None
    end = time.perf_counter()
    prof.__exit__(None, None, None)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace-{RUN_ID}.json")
    prof.export_chrome_trace(path)
    merge_spans(path, anchor, end)
    return path


# The spans' process row in a merged capture: above every Linux pid
# (pid_max is at most 2**22) and the profiler's device rows (0, 1, ...).
_SPAN_ROW_PID = 1 << 22


def merge_spans(path: str, anchor: Tuple[float, int], end: float) -> int:
    """Add the ring's spans that lie in ``[anchor, end]`` (seconds of
    ``time.perf_counter``) to the profiler's Chrome trace at ``path`` as
    complete events on its clock, on their own process row with one row
    per thread (``tid``, the profiler's CPU rows' ids). ``anchor`` is
    ``(perf_counter, time_ns)`` sampled together; the profiler's events
    are microseconds after the file's ``baseTimeNanoseconds``. Returns
    the number of spans added."""
    perf0, ns0 = anchor
    with open(path) as f:
        doc = json.load(f)
    shift_us = (ns0 - doc.get("baseTimeNanoseconds", 0)) / 1e3 - perf0 * 1e6
    events = doc.setdefault("traceEvents", [])
    kept = [s for s in spans()
            if perf0 <= s["ts"] and s["ts"] + s["dur"] <= end]
    events.extend({"ph": "X", "cat": "host_span", "name": s["name"],
                   "pid": _SPAN_ROW_PID, "tid": s["tid"],
                   "ts": round(s["ts"] * 1e6 + shift_us, 3),
                   "dur": round(s["dur"] * 1e6, 3), "args": s["labels"]}
                  for s in kept)
    events.append({"ph": "M", "name": "process_name", "pid": _SPAN_ROW_PID,
                   "tid": 0, "args": {"name": "disq_tpu_torch spans"}})
    events.extend({"ph": "M", "name": "thread_name", "pid": _SPAN_ROW_PID,
                   "tid": tid, "args": {"name": f"spans of thread {tid}"}}
                  for tid in sorted({s["tid"] for s in kept}))
    with open(path, "w") as f:
        # default=str: label values may be numpy scalars
        json.dump(doc, f, default=str)
    return len(kept)


@contextlib.contextmanager
def trace_phase(name: str, **labels: Any) -> Iterator[None]:
    """``span`` plus a ``torch.profiler.record_function`` range, so the
    phase shows on a profiler capture; the first phase entered starts a
    ``DISQ_TPU_TORCH_TRACE_DIR`` capture."""
    _resolve_phase_env()
    if _trace_dir and _profiler is None:
        start_trace(_trace_dir)
    import torch

    with span(name, **labels):
        with torch.profiler.record_function(f"disq_tpu.{name}"):
            yield


def record_phase(name: str, seconds: float, **labels: Any) -> None:
    """Alias of ``record_span``."""
    record_span(name, seconds, **labels)


def phase_report() -> Dict[str, Dict[str, float]]:
    """``{phase: {calls, total_s}}`` since process start: a view over
    the registry's duration histograms (every span books one)."""
    out: Dict[str, Dict[str, float]] = {}
    with REGISTRY._lock:
        for name, m in sorted(REGISTRY.metrics().items()):
            if m.kind != "histogram":
                continue
            calls = m.count
            if calls:
                out[name] = {"calls": calls, "total_s": round(m.sum, 6)}
    return out


def reset_phase_report() -> None:
    """Zero the duration histograms and the span ring."""
    with REGISTRY._lock:
        for m in REGISTRY.metrics().values():
            if m.kind == "histogram":
                m._reset()
    reset_spans()


def observe_gauge(name: str, value: float, **labels: Any) -> None:
    """One sample of a level-style quantity: ``gauge(name).observe``."""
    REGISTRY.gauge(name).observe(value, **labels)


def gauge_report() -> Dict[str, Dict[str, float]]:
    """Every gauge's unlabeled series (or its first labeled one):
    ``min`` / ``max`` / ``last`` / ``mean`` / ``samples``."""
    out: Dict[str, Dict[str, float]] = {}
    with REGISTRY._lock:
        for name, m in sorted(REGISTRY.metrics().items()):
            if m.kind != "gauge":
                continue
            st = m.state()
            if st is not None:
                out[name] = st
            else:
                snap = m._snapshot()
                if snap:
                    out[name] = next(iter(snap.values()))
    return out


def reset_gauges() -> None:
    with REGISTRY._lock:
        for m in REGISTRY.metrics().values():
            if m.kind == "gauge":
                m._reset()


def reset_telemetry() -> None:
    """Zero everything: registry, span ring, the live device-footprint
    estimate (an open JSONL sink stays open: it is an append log)."""
    global _hbm_live
    REGISTRY.reset()
    reset_spans()
    with _hbm_lock:
        _hbm_live = 0
