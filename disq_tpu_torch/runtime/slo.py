"""Per-tenant SLOs: multi-window burn rates over the metrics registry.

Counterpart of ``disq_tpu/runtime/slo.py``, served on ``/slo`` and merged
by ``runtime/cluster.py``. A spec (``DisqOptions.slo`` /
``DISQ_TPU_TORCH_SLO``) is a comma-separated list of per-tenant
objectives::

    tenant:latency_ms:target_pct[:availability_pct]

    t0:250:99          # 99% of t0's requests under 250 ms
    *:500:95:99.9      # every other tenant: 95% under 500 ms AND
                       # 99.9% of requests not 5xx

The evaluator samples the ``serve.request`` latency histogram (per
tenant, summed over endpoints) and the ``serve.request.errors`` counter
on a periodic tick, keeps a bounded ring of snapshots, and computes
``burn = observed_error_rate / (1 - target)`` over several windows. A
burn at or past the fast-burn threshold (14.4 by default) over the two
shortest windows flips ``/healthz`` to degraded. A latency threshold is
rounded up to the histogram's next bucket edge. The serving plane that
books those series is not ported yet; the evaluator reads whatever the
registry holds.

Nothing here runs until ``configure(...)``, the env knob or
``DisqOptions.slo`` arms it: ``evaluator_if_running()`` stays None and
no ``disq-slo`` thread exists.

Telemetry: ``slo.burn_rate{tenant,window}`` (gauge), ``slo.fast_burn``
(gauge, 0/1), ``slo.evaluations`` (counter).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from disq_tpu_torch.runtime.tracing import (
    REGISTRY, RUN_ID, counter as _counter, gauge as _gauge)

# Default burn windows (seconds): short/mid/long.  The fast-burn page
# condition requires the threshold over BOTH of the two shortest
# windows, so a single spike can't flip healthz but a sustained burn
# does within one short window.
DEFAULT_WINDOWS: Tuple[float, ...] = (60.0, 300.0, 3600.0)
DEFAULT_FAST_BURN = 14.4

LATENCY_HISTOGRAM = "serve.request"
ERROR_COUNTER = "serve.request.errors"
WILDCARD = "*"


class SloObjective:
    """One tenant's objectives: latency (required) and availability
    (optional)."""

    __slots__ = ("tenant", "latency_s", "target", "availability")

    def __init__(self, tenant: str, latency_s: float, target: float,
                 availability: Optional[float] = None) -> None:
        self.tenant = tenant
        self.latency_s = latency_s
        self.target = target
        self.availability = availability

    def as_doc(self) -> Dict[str, Any]:
        return {
            "latency_ms": round(self.latency_s * 1e3, 3),
            "target": self.target,
            "availability": self.availability,
        }


def parse_slo_spec(spec: str) -> Dict[str, SloObjective]:
    """Parse the spec grammar above; raises ``ValueError`` with the
    offending clause on any malformed input."""
    objectives: Dict[str, SloObjective] = {}
    for clause in str(spec).split(","):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(
                f"bad SLO clause {clause!r}: expected "
                "tenant:latency_ms:target_pct[:availability_pct]")
        tenant = parts[0].strip()
        if not tenant:
            raise ValueError(f"bad SLO clause {clause!r}: empty tenant")
        try:
            latency_ms = float(parts[1])
            target_pct = float(parts[2])
            avail_pct = float(parts[3]) if len(parts) == 4 else None
        except ValueError:
            raise ValueError(
                f"bad SLO clause {clause!r}: non-numeric field") from None
        if latency_ms <= 0:
            raise ValueError(
                f"bad SLO clause {clause!r}: latency_ms must be > 0")
        for pct in (target_pct,) + (
                (avail_pct,) if avail_pct is not None else ()):
            if not 0.0 < pct < 100.0:
                raise ValueError(
                    f"bad SLO clause {clause!r}: percent targets must "
                    "be in (0, 100)")
        objectives[tenant] = SloObjective(
            tenant, latency_ms / 1e3, target_pct / 100.0,
            avail_pct / 100.0 if avail_pct is not None else None)
    if not objectives:
        raise ValueError(f"empty SLO spec {spec!r}")
    return objectives


def _tenant_samples() -> Dict[str, Tuple[int, int, float]]:
    """Per-tenant ``(total, errors, latency_sum_by_bucket…)`` sampled
    from the registry: returns ``{tenant: (cum_bucket_counts, total,
    errors)}`` with bucket counts CUMULATIVE (so goodness at a
    threshold is one index lookup) and summed across endpoints."""
    hist = REGISTRY.histogram(LATENCY_HISTOGRAM)
    err = REGISTRY.counter(ERROR_COUNTER)
    out: Dict[str, Any] = {}
    with REGISTRY._lock:
        nb = len(hist.buckets) + 1
        for key, bucket_counts in hist._counts.items():
            tenant = dict(key).get("tenant")
            if tenant is None:
                continue
            entry = out.setdefault(str(tenant), [[0] * nb, 0, 0])
            for i, n in enumerate(bucket_counts):
                entry[0][i] += n
            entry[1] += hist._stats[key]["count"]
        for key, v in err._values.items():
            tenant = dict(key).get("tenant")
            if tenant is None:
                continue
            entry = out.setdefault(str(tenant),
                                   [[0] * nb, 0, 0])
            entry[2] += int(v)
    # cumulative buckets
    result: Dict[str, Tuple[List[int], int, int]] = {}
    for tenant, (buckets, total, errors) in out.items():
        cum, acc = [], 0
        for n in buckets:
            acc += n
            cum.append(acc)
        result[tenant] = (cum, int(total), int(errors))
    return result


class SloEvaluator:
    """The periodic evaluator: one daemon thread, a bounded snapshot
    ring, per-tenant multi-window burn rates, and the fast-burn flag
    ``/healthz`` merges."""

    def __init__(self, objectives: Dict[str, SloObjective],
                 windows: Tuple[float, ...] = DEFAULT_WINDOWS,
                 interval_s: float = 5.0,
                 fast_burn: float = DEFAULT_FAST_BURN,
                 clock=time.monotonic) -> None:
        self.objectives = dict(objectives)
        self.windows = tuple(sorted(windows))
        self.interval_s = float(interval_s)
        self.fast_burn = float(fast_burn)
        self._clock = clock
        self._lock = threading.Lock()
        self._snaps: Deque[Tuple[float, Dict[str, Any]]] = deque()
        self._latest: Dict[str, Any] = {}
        self._stop = threading.Event()
        # baseline snapshot so the first evaluation has a delta anchor
        self._snaps.append((self._clock(), _tenant_samples()))
        self._thread = threading.Thread(
            target=self._loop, name="disq-slo", daemon=True)
        self._thread.start()

    # -- evaluation ---------------------------------------------------------

    def _objective_for(self, tenant: str) -> Optional[SloObjective]:
        return self.objectives.get(tenant) or self.objectives.get(WILDCARD)

    @staticmethod
    def _good_index(buckets: Tuple[float, ...], latency_s: float) -> int:
        """Index into cumulative counts whose boundary is the threshold
        rounded UP to the nearest bucket edge (+Inf if beyond all)."""
        for i, b in enumerate(buckets):
            if latency_s <= b:
                return i
        return len(buckets)

    def _window_delta(self, now: float, window: float,
                      current: Dict[str, Any], tenant: str
                      ) -> Tuple[List[int], int, int, float]:
        """(bucket_delta, total_delta, error_delta, span_s) for one
        tenant over one window — against the newest snapshot at least
        ``window`` old, else the oldest we have (partial window)."""
        base_t, base = self._snaps[0]
        for t, snap in reversed(self._snaps):
            if now - t >= window:
                base_t, base = t, snap
                break
        cur = current.get(tenant)
        if cur is None:
            return [], 0, 0, max(now - base_t, 1e-9)
        cum, total, errors = cur
        b = base.get(tenant)
        if b is None:
            return list(cum), total, errors, max(now - base_t, 1e-9)
        bcum, btotal, berrors = b
        delta = [c - p for c, p in zip(cum, bcum)]
        return (delta, total - btotal, errors - berrors,
                max(now - base_t, 1e-9))

    def evaluate_now(self) -> Dict[str, Any]:
        """One evaluation tick: sample the registry, compute per-tenant
        burn over every window, book the slo.* metrics, store + return
        the snapshot doc.  Called by the loop and by tests that need a
        deterministic tick."""
        now = self._clock()
        current = _tenant_samples()
        hist_buckets = REGISTRY.histogram(LATENCY_HISTOGRAM).buckets
        tenants: Dict[str, Any] = {}
        with self._lock:
            for tenant in sorted(current):
                obj = self._objective_for(tenant)
                if obj is None:
                    continue
                gi = self._good_index(hist_buckets, obj.latency_s)
                budget = max(1e-9, 1.0 - obj.target)
                avail_budget = (max(1e-9, 1.0 - obj.availability)
                                if obj.availability is not None else None)
                wdocs: Dict[str, Any] = {}
                burns: List[float] = []
                for w in self.windows:
                    delta, total, errors, span = self._window_delta(
                        now, w, current, tenant)
                    good = delta[gi] if delta else 0
                    bad = max(0, total - good)
                    burn = (bad / total / budget) if total > 0 else 0.0
                    avail_burn = None
                    if avail_budget is not None:
                        avail_burn = (errors / total / avail_budget
                                      if total > 0 else 0.0)
                    wdocs[str(int(w))] = {
                        "total": total, "good": good, "errors": errors,
                        "burn": round(burn, 4),
                        "availability_burn": (
                            round(avail_burn, 4)
                            if avail_burn is not None else None),
                        "span_s": round(span, 3),
                    }
                    worst = max(burn, avail_burn or 0.0)
                    burns.append(worst)
                    _gauge("slo.burn_rate").observe(
                        worst, tenant=tenant, window=str(int(w)))
                fast = (len(burns) >= 2
                        and burns[0] >= self.fast_burn
                        and burns[1] >= self.fast_burn)
                _gauge("slo.fast_burn").observe(
                    1.0 if fast else 0.0, tenant=tenant)
                tenants[tenant] = dict(
                    objective=obj.as_doc(), windows=wdocs,
                    fast_burn=fast)
            self._snaps.append((now, current))
            horizon = now - (self.windows[-1] + 2 * self.interval_s)
            while len(self._snaps) > 2 and self._snaps[1][0] < horizon:
                self._snaps.popleft()
            self._latest = {
                "enabled": True, "run_id": RUN_ID,
                "windows": [int(w) for w in self.windows],
                "fast_burn_threshold": self.fast_burn,
                "tenants": tenants,
            }
            _counter("slo.evaluations").inc()
            return dict(self._latest)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_now()
            except Exception:  # noqa: BLE001 — the evaluator must survive
                pass

    # -- read side ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The latest evaluation doc (evaluating once if the loop has
        not ticked yet) — what ``/slo`` serves."""
        with self._lock:
            latest = dict(self._latest)
        return latest if latest else self.evaluate_now()

    def fast_burn_tenants(self) -> List[str]:
        with self._lock:
            return sorted(
                t for t, doc in self._latest.get("tenants", {}).items()
                if doc.get("fast_burn"))

    def health_fragment(self) -> Dict[str, Any]:
        """The compact fragment ``/healthz`` merges: fast-burn tenants
        plus each tenant's worst current burn."""
        with self._lock:
            tenants = self._latest.get("tenants", {})
            return {
                "fast_burn_tenants": sorted(
                    t for t, d in tenants.items() if d.get("fast_burn")),
                "worst_burn": {
                    t: max((w["burn"] for w in d["windows"].values()),
                           default=0.0)
                    for t, d in tenants.items()
                },
            }

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout)


# ---------------------------------------------------------------------------
# Process-wide singleton (lazy — the unconfigured path touches none of
# this module beyond an is-None test)
# ---------------------------------------------------------------------------

_EVALUATOR: Optional[SloEvaluator] = None
_LOCK = threading.Lock()


def configure(spec: str, **kwargs: Any) -> SloEvaluator:
    """Arm (or re-arm with a new spec) the process-wide evaluator."""
    global _EVALUATOR
    objectives = parse_slo_spec(spec)
    with _LOCK:
        if _EVALUATOR is not None:
            _EVALUATOR.stop()
        _EVALUATOR = SloEvaluator(objectives, **kwargs)
        return _EVALUATOR


def configure_from_env() -> Optional[SloEvaluator]:
    """Arm from ``DISQ_TPU_TORCH_SLO`` if set (idempotent: an evaluator that
    is already running is kept)."""
    spec = os.environ.get("DISQ_TPU_TORCH_SLO")
    if not spec:
        return None
    with _LOCK:
        if _EVALUATOR is not None:
            return _EVALUATOR
    return configure(spec)


def configure_from_options(options: Any) -> Optional[SloEvaluator]:
    """The ``DisqOptions.slo`` funnel (``context_for_storage``)."""
    spec = getattr(options, "slo", None)
    if not spec:
        return configure_from_env()
    return configure(spec)


def evaluator_if_running() -> Optional[SloEvaluator]:
    """The live evaluator or None — NEVER creates one (the overhead
    guard asserts this stays None on the default path)."""
    return _EVALUATOR


def slo_doc() -> Dict[str, Any]:
    """What ``/slo`` serves: the evaluator's snapshot, or a disabled
    stub when nothing is configured."""
    ev = _EVALUATOR
    if ev is None:
        return {"enabled": False, "run_id": RUN_ID, "tenants": {}}
    return ev.snapshot()


def reset_slo() -> None:
    """Test hook: stop and forget the evaluator."""
    global _EVALUATOR
    with _LOCK:
        if _EVALUATOR is not None:
            _EVALUATOR.stop()
        _EVALUATOR = None
