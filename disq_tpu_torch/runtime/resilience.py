"""Adaptive resilience: closed-loop fault handling for the pipelines.

Counterpart of ``disq_tpu/runtime/resilience.py``. Bounded retry and the
stall watchdog only *observe* a slow or failing shard; this module acts
on it, with four mechanisms under one rule, **disabled is free** (no
knob set: no object, no thread, no timer, the same bytes):

- **Hedged fetches** (``HedgeController``): a range read that outlives a
  rolling quantile of this run's fetch latencies
  (``DisqOptions.hedge_quantile``, never below ``hedge_min_s``) gets a
  duplicate; the first result wins and the loser is cancelled or
  discarded (``hedge.launched``, ``hedge.won{winner=}``,
  ``hedge.wasted_bytes``, the ``hedge.fetch`` and ``hedge.waste``
  spans). Only the fetch stage is duplicated: the device kernels run in
  decode, once per split, whoever wins.
- **Per-shard deadlines** (``ShardDeadline``): ``shard_deadline_s`` gives
  each shard a wall-clock budget that escalates: retry while young, a
  forced hedge past half of it (``deadline.hedge_forced``), and a
  non-transient ``DeadlineExceededError`` once it is spent
  (``deadline.exceeded``), which skip and quarantine turn into one
  set-aside empty shard.
- **Shared retry budget** (``RetryBudget``): a process-wide token bucket
  every ``ShardRetrier`` consults; a retry spends a token, a success
  refills a fraction, a dry bucket denies the retry (``budget.spent``,
  ``budget.denied``).
- **Circuit breaker** (``CircuitBreaker``): per filesystem scheme,
  closed → open → half-open. ``breaker_window`` consecutive transient
  failures open it, calls then fail fast with ``BreakerOpenError``
  (``breaker.rejected``) until a probe after ``breaker_cooldown_s``
  recloses it (``breaker.transitions{to=}``, the ``breaker.state``
  gauge, the ``breaker.open`` / ``breaker.half_open`` spans).

Budget and breakers are process-wide (they model the store); hedging and
deadlines are per run. ``scripts/torch_check_resilience.py`` checks the
invariants: the breaker's transitions are total, every hedge launch is
booked won (or ``neither``), and the disabled path builds nothing.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, Optional

from disq_tpu_torch.runtime import flightrec
from disq_tpu_torch.runtime.errors import (
    BreakerOpenError,
    DeadlineExceededError,
    DisqOptions,
)
from disq_tpu_torch.runtime.tracing import counter, observe_gauge, record_span, span

# ---------------------------------------------------------------------------
# Coordinator rediscovery backoff (scheduler failover)
# ---------------------------------------------------------------------------

# How long a worker hunts for a new coordinator before its
# CoordinatorLostError surfaces: 8 retries on a 0.25 s decorrelated-
# jitter base gives a standby several seconds to probe liveness,
# replay the journal and re-advertise, without a dead failover
# directory wedging the read for minutes.
REDISCOVERY_RETRIES = 8
REDISCOVERY_BACKOFF_S = 0.25


def rediscovery_retrier():
    """The retrier behind ``SchedulerClient`` rediscovery — a plain
    ``ShardRetrier`` so failover waits ride the same decorrelated
    jitter, retry-budget accounting and telemetry as every other
    transient-fault retry in the runtime."""
    from disq_tpu_torch.runtime.errors import ShardRetrier

    return ShardRetrier(REDISCOVERY_RETRIES, REDISCOVERY_BACKOFF_S)


# ---------------------------------------------------------------------------
# Shared retry budget — the anti-stampede token bucket
# ---------------------------------------------------------------------------


class RetryBudget:
    """Process-wide token bucket bounding the *total* retry rate.

    Every ``ShardRetrier.call`` retry spends one token; every
    successful call refills ``refill_per_success`` tokens (capped at
    ``capacity``) — so a healthy store earns back retry headroom and a
    degraded one drains it, after which retries are denied and the
    original error surfaces immediately.  The refill-on-success
    coupling is what prevents the synchronized-stampede failure mode:
    when *nothing* succeeds, the whole process stops retrying together.
    """

    def __init__(self, capacity: int, refill_per_success: float = 0.1
                 ) -> None:
        if capacity < 1:
            raise ValueError(f"budget capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.refill_per_success = float(refill_per_success)
        self._tokens = float(capacity)
        self._lock = threading.Lock()

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def try_spend(self, what: str = "retry") -> bool:
        """Consume one token for a retry; False = denied (bucket dry)."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                tokens = self._tokens
                ok = True
            else:
                tokens = self._tokens
                ok = False
        if ok:
            counter("budget.spent").inc()
        else:
            counter("budget.denied").inc(what=what)
        observe_gauge("budget.tokens", tokens)
        return ok

    def on_success(self) -> None:
        """A call succeeded: earn back retry headroom."""
        if self.refill_per_success <= 0:
            return
        with self._lock:
            self._tokens = min(float(self.capacity),
                               self._tokens + self.refill_per_success)
            tokens = self._tokens
        observe_gauge("budget.tokens", tokens)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"tokens": round(self._tokens, 3),
                    "capacity": self.capacity,
                    "refill_per_success": self.refill_per_success}


_budget_lock = threading.Lock()
_BUDGET: Optional[RetryBudget] = None


def configure_budget(capacity: Optional[int],
                     refill_per_success: float = 0.1
                     ) -> Optional[RetryBudget]:
    """Install (or clear, with ``capacity=None``) the process-wide
    retry budget.  Idempotent for an unchanged capacity — repeated runs
    with the same options share one bucket rather than refilling it."""
    global _BUDGET
    with _budget_lock:
        if capacity is None:
            _BUDGET = None
        elif (_BUDGET is None or _BUDGET.capacity != int(capacity)
              or _BUDGET.refill_per_success != float(refill_per_success)):
            _BUDGET = RetryBudget(capacity, refill_per_success)
        return _BUDGET


def active_budget() -> Optional[RetryBudget]:
    return _BUDGET


# ---------------------------------------------------------------------------
# Circuit breaker — per-filesystem closed→open→half-open
# ---------------------------------------------------------------------------

_STATE_VALUE = {"closed": 0.0, "half_open": 1.0, "open": 2.0}


class CircuitBreaker:
    """Fail-fast guard for one backing store (one filesystem/scheme).

    - ``closed``: calls flow; ``window`` *consecutive* transient
      failures trip to ``open`` (any success resets the count).
    - ``open``: every call is rejected immediately with
      ``BreakerOpenError`` until ``cooldown_s`` has elapsed.
    - ``half_open``: exactly one probe call is admitted; its success
      recloses the breaker, its failure re-opens (fresh cooldown).
      Concurrent callers during the probe stay rejected.

    The transition set is total — every ``(state, event)`` pair has a
    defined successor — which ``scripts/torch_check_resilience.py``
    asserts by exhaustive enumeration.  ``clock`` is injectable so tests drive
    the cooldown with a fake clock.
    """

    def __init__(self, key: str, window: int = 5, cooldown_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if window < 1:
            raise ValueError(f"breaker window must be >= 1, got {window}")
        self.key = key
        self.window = int(window)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._state_since = clock()
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, to: str, now: float) -> None:
        # caller holds self._lock
        prev, since = self._state, self._state_since
        if prev == to:
            return
        self._state = to
        self._state_since = now
        counter("breaker.transitions").inc(key=self.key, to=to)
        flightrec.record_event("breaker_transition", key=self.key,
                               to=to, window_s=round(now - since, 3))
        observe_gauge("breaker.state", _STATE_VALUE[to], key=self.key)
        # The window just left renders as a shaded band in trace_report:
        # open/half-open spans carry the window's real duration.
        if prev == "open":
            record_span("breaker.open", now - since, key=self.key)
        elif prev == "half_open":
            record_span("breaker.half_open", now - since, key=self.key)

    def before_call(self) -> None:
        """Gate one call: raises ``BreakerOpenError`` while open (and
        while a half-open probe is already in flight)."""
        with self._lock:
            now = self._clock()
            if self._state == "open":
                if now - self._opened_at < self.cooldown_s:
                    counter("breaker.rejected").inc(key=self.key)
                    raise BreakerOpenError(
                        "circuit breaker open — failing fast",
                        key=self.key,
                        retry_after_s=self.cooldown_s
                        - (now - self._opened_at),
                    )
                self._transition("half_open", now)
                self._probing = True
                return
            if self._state == "half_open":
                if (self._probing
                        and now - self._state_since < self.cooldown_s):
                    counter("breaker.rejected").inc(key=self.key)
                    raise BreakerOpenError(
                        "circuit breaker half-open — probe in flight",
                        key=self.key, retry_after_s=self.cooldown_s)
                # Either the previous probe resolved without an event
                # (released below) or it has been silent a whole
                # cooldown — a probe that died without reporting must
                # not wedge the breaker in half_open forever.
                self._probing = True

    def release_probe(self) -> None:
        """The admitted call ended without a success/failure verdict
        for the *store* (a non-transient error — corrupt data, a 404 —
        says nothing about the fault storm that opened the breaker):
        free the probe slot so the next caller can probe."""
        with self._lock:
            self._probing = False

    def record_success(self) -> None:
        with self._lock:
            now = self._clock()
            self._failures = 0
            if self._state == "open":
                # A success observed while open is stale (the call was
                # admitted before the trip): the breaker may only
                # reclose through a half-open probe.
                return
            self._probing = False
            # Recloses a probing breaker; in closed state a no-op.
            self._transition("closed", now)

    def record_failure(self) -> None:
        with self._lock:
            now = self._clock()
            self._probing = False
            if self._state == "half_open":
                self._opened_at = now
                self._transition("open", now)
                return
            self._failures += 1
            if self._failures >= self.window:
                self._failures = 0
                self._opened_at = now
                self._transition("open", now)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "window": self.window,
                "cooldown_s": self.cooldown_s,
                "state_age_s": round(self._clock() - self._state_since, 3),
            }


_breaker_lock = threading.Lock()
_BREAKERS: Dict[str, CircuitBreaker] = {}
_breaker_config: Optional[Dict[str, float]] = None


def configure_breakers(window: Optional[int],
                       cooldown_s: float = 1.0) -> None:
    """Enable (or disable, ``window=None``) per-filesystem breakers.
    Existing breaker instances keep their state — reconfiguring only
    changes what ``breaker_for`` builds next."""
    global _breaker_config
    with _breaker_lock:
        if window is None:
            _breaker_config = None
        else:
            _breaker_config = {"window": int(window),
                               "cooldown_s": float(cooldown_s)}


def breaker_for(path: str) -> Optional[CircuitBreaker]:
    """The breaker guarding ``path``'s filesystem (keyed by URI scheme,
    ``local`` for scheme-less paths), or None when breakers are off."""
    with _breaker_lock:
        cfg = _breaker_config
        if cfg is None:
            return None
        key = path.split("://", 1)[0] if "://" in path else "local"
        br = _BREAKERS.get(key)
        if br is None:
            br = _BREAKERS[key] = CircuitBreaker(
                key, window=int(cfg["window"]),
                cooldown_s=cfg["cooldown_s"])
        return br


def breakers_snapshot() -> Dict[str, Dict[str, Any]]:
    with _breaker_lock:
        return {k: b.snapshot() for k, b in sorted(_BREAKERS.items())}


# ---------------------------------------------------------------------------
# Per-shard deadline — the escalation ladder's clock
# ---------------------------------------------------------------------------

# Fraction of the deadline after which hedging is forced (a shard past
# half its budget cannot afford to wait for the hedge quantile).
HEDGE_ESCALATE_FRACTION = 0.5


class ShardDeadline:
    """Wall-clock budget for one shard's whole pipeline life (armed at
    the first stage it is checked in, spanning every retry).  The
    escalation ladder reads it at three points: the retrier denies
    further retries once exceeded, the hedge controller forces an
    immediate duplicate past ``HEDGE_ESCALATE_FRACTION``, and the
    executor's stage boundaries raise ``DeadlineExceededError``."""

    __slots__ = ("deadline_s", "shard_id", "_clock", "_start")

    def __init__(self, deadline_s: float, shard_id: int = -1,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.deadline_s = float(deadline_s)
        self.shard_id = shard_id
        self._clock = clock
        self._start: Optional[float] = None

    def arm(self) -> None:
        if self._start is None:
            self._start = self._clock()

    def elapsed(self) -> float:
        if self._start is None:
            return 0.0
        return self._clock() - self._start

    def exceeded(self) -> bool:
        self.arm()
        return self.elapsed() >= self.deadline_s

    def should_force_hedge(self) -> bool:
        self.arm()
        return self.elapsed() >= HEDGE_ESCALATE_FRACTION * self.deadline_s

    def check(self, what: str = "shard") -> None:
        """Raise (and book) once the budget is gone."""
        if self.exceeded():
            counter("deadline.exceeded").inc(what=what)
            flightrec.record_event(
                "deadline_exceeded", what=what, shard=self.shard_id,
                elapsed_s=round(self.elapsed(), 3),
                deadline_s=self.deadline_s)
            raise DeadlineExceededError(
                "shard exceeded its deadline",
                shard_id=self.shard_id,
                elapsed_s=self.elapsed(),
                deadline_s=self.deadline_s,
            )


# ---------------------------------------------------------------------------
# Hedged fetches — first-result-wins duplicate reads
# ---------------------------------------------------------------------------


def _payload_nbytes(value: Any) -> int:
    """Best-effort byte size of a discarded fetch payload (the
    ``hedge.wasted_bytes`` booking): bytes-likes report their length,
    staged tuples (the sources' fetch payloads carry the compressed
    range as one bytes element) sum their bytes-like elements."""
    if value is None:
        return 0
    if isinstance(value, (bytes, bytearray, memoryview)):
        return len(value)
    if isinstance(value, tuple):
        return sum(len(v) for v in value
                   if isinstance(v, (bytes, bytearray, memoryview)))
    nbytes = getattr(value, "nbytes", None)
    return int(nbytes) if isinstance(nbytes, int) else 0


class HedgeController:
    """Per-run hedged-fetch machinery: tracks a rolling window of fetch
    latencies and races a duplicate against any fetch that outlives the
    configured quantile of that window (never below ``min_s`` — a warm
    run must not hedge every fetch because the window is fast).

    The worker pool is created lazily on the first hedge launch, so a
    run whose fetches all beat the threshold costs one ``wait()``
    timeout per fetch and zero threads.  ``close()`` cancels any
    pending duplicates — the executor calls it from the same ``finally``
    that shuts the stage pools down, so an aborted run leaves no
    orphaned hedge futures behind."""

    WINDOW = 128

    def __init__(self, quantile: float, min_s: float,
                 max_workers: int = 4) -> None:
        if not 0.0 < quantile < 1.0:
            raise ValueError(
                f"hedge_quantile must be in (0, 1), got {quantile}")
        self.quantile = float(quantile)
        self.min_s = float(min_s)
        self._max_workers = max(1, int(max_workers))
        self._lock = threading.Lock()
        self._latencies: "deque[float]" = deque(maxlen=self.WINDOW)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._closed = False

    # -- latency window -----------------------------------------------------

    def record(self, seconds: float) -> None:
        with self._lock:
            self._latencies.append(seconds)

    def threshold(self) -> float:
        """Current hedge delay: the rolling ``quantile`` of observed
        fetch latencies, floored at ``min_s`` (which is also the cold
        answer while the window is empty)."""
        with self._lock:
            lats = sorted(self._latencies)
        if not lats:
            return self.min_s
        k = min(len(lats) - 1, int(self.quantile * len(lats)))
        return max(self.min_s, lats[k])

    # -- pool lifecycle -----------------------------------------------------

    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._closed:
                raise RuntimeError("hedge controller already closed")
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._max_workers,
                    thread_name_prefix="disq-hedge")
            return self._pool

    def close(self) -> None:
        """Tear the hedge pool down, cancelling queued duplicates (a
        duplicate already running finishes its I/O and is discarded by
        its done-callback)."""
        with self._lock:
            pool, self._pool = self._pool, None
            self._closed = True
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)

    # -- the hedged call ----------------------------------------------------

    def call(self, fn: Callable[[], Any], shard_id: int = -1,
             deadline: Optional[ShardDeadline] = None,
             on_outcome: Optional[Callable[[str, bool], None]] = None) -> Any:
        """Run ``fn`` with hedging: if it outlives the rolling-quantile
        threshold, launch a duplicate and take whichever finishes first
        (first *success* wins; if one side fails while the other is in
        flight, the survivor's outcome decides).  With a deadline past
        its escalation point the duplicate launches immediately.

        ``on_outcome(winner, hedged)`` — when given — fires once per
        resolved call with ``winner`` in ``{"primary", "hedge",
        "neither"}`` and whether a duplicate was launched, so callers
        like the fleet router can book their own hedge accounting
        (``fleet.hedge.*``) without re-deriving the race result."""
        delay = self.threshold()
        if deadline is not None and deadline.should_force_hedge():
            counter("deadline.hedge_forced").inc()
            flightrec.record_event("hedge_forced", shard=shard_id,
                                   elapsed_s=round(deadline.elapsed(), 3))
            delay = 0.0
        pool = self._ensure_pool()
        t0 = time.perf_counter()
        primary = pool.submit(fn)
        done, _ = wait([primary], timeout=delay)
        if primary in done:
            if primary.exception() is None:
                self.record(time.perf_counter() - t0)
                if on_outcome is not None:
                    on_outcome("primary", False)
            return primary.result()

        counter("hedge.launched").inc()
        flightrec.record_event("hedge_launched", shard=shard_id,
                               delay_s=round(delay, 4))
        h0 = time.perf_counter()

        def duplicate() -> Any:
            with span("hedge.fetch", shard=shard_id):
                return fn()

        secondary = pool.submit(duplicate)
        futures = {primary: "primary", secondary: "hedge"}
        winner = None
        first_error: Optional[BaseException] = None
        pending = set(futures)
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            ok = [f for f in done if f.exception() is None]
            if ok:
                winner = ok[0]
                break
            for f in done:
                if first_error is None:
                    first_error = f.exception()
        if winner is None:
            # Both sides failed: surface the first failure (the retrier
            # above classifies and may retry the whole hedged call).
            # Booked as winner="neither" so launched == won stays an
            # exact invariant (torch_check_resilience.py asserts it).
            counter("hedge.won").inc(winner="neither")
            if on_outcome is not None:
                on_outcome("neither", True)
            raise first_error  # type: ignore[misc]
        loser = secondary if winner is primary else primary
        loser_started = t0 if loser is primary else h0
        counter("hedge.won").inc(winner=futures[winner])
        if on_outcome is not None:
            on_outcome(futures[winner], True)
        if winner is primary:
            self.record(time.perf_counter() - t0)
        if not loser.cancel():
            # Still running: discard its payload when it lands, booking
            # the bytes and time the lost race burned.
            def _discard(f, started=loser_started, shard=shard_id) -> None:
                burned = time.perf_counter() - started
                record_span("hedge.waste", burned, shard=shard)
                if f.cancelled() or f.exception() is not None:
                    return
                counter("hedge.wasted_bytes").inc(
                    _payload_nbytes(f.result()))

            loser.add_done_callback(_discard)
        return winner.result()


# ---------------------------------------------------------------------------
# Per-run manager + options plumbing
# ---------------------------------------------------------------------------


class ResilienceManager:
    """One run's resilience bundle, built by ``resilience_for_options``:
    the hedge controller (if hedging is on) and the deadline factory
    (if deadlines are on).  The executor owns its lifecycle — ``close``
    runs in the same ``finally`` as the stage-pool shutdown."""

    def __init__(self, hedge: Optional[HedgeController] = None,
                 deadline_s: Optional[float] = None) -> None:
        self.hedge = hedge
        self.deadline_s = deadline_s

    def new_deadline(self, shard_id: int) -> Optional[ShardDeadline]:
        if self.deadline_s is None:
            return None
        return ShardDeadline(self.deadline_s, shard_id=shard_id)

    def fetch(self, fn: Callable[[], Any], shard_id: int = -1,
              deadline: Optional[ShardDeadline] = None) -> Any:
        if self.hedge is None:
            return fn()
        return self.hedge.call(fn, shard_id=shard_id, deadline=deadline)

    def close(self) -> None:
        if self.hedge is not None:
            self.hedge.close()


def configure_globals_from_options(opts) -> None:
    """Install the process-wide budget/breaker configuration from one
    ``DisqOptions`` — the single chokepoint every entry path
    (``context_for_storage``, ``write_retrier_for_storage``,
    ``resilience_for_options``) funnels through.  Budget/breakers are
    process-wide (they model the shared store): a run that sets the
    knobs installs them; a run that doesn't leaves another run's
    protection alone (clear via ``reset_resilience``)."""
    if getattr(opts, "retry_budget_tokens", None) is not None:
        configure_budget(opts.retry_budget_tokens,
                         getattr(opts, "retry_budget_refill", 0.1))
    if getattr(opts, "breaker_window", None) is not None:
        configure_breakers(opts.breaker_window,
                           getattr(opts, "breaker_cooldown_s", 1.0))


def resilience_for_options(opts: Optional[DisqOptions]
                           ) -> Optional[ResilienceManager]:
    """Resolve one ``DisqOptions``' resilience knobs.  Also installs
    the process-wide budget/breaker configuration (they are consulted
    by every ``ShardRetrier``, not just this run's pipeline).  Returns
    None on the default path — the executor then never touches this
    module per shard."""
    if opts is None:
        return None
    configure_globals_from_options(opts)
    quantile = getattr(opts, "hedge_quantile", None)
    deadline_s = getattr(opts, "shard_deadline_s", None)
    if quantile is None and deadline_s is None:
        return None
    hedge = None
    if quantile is not None:
        # Primaries AND duplicates share the hedge pool: size it at
        # 2 × the fetch concurrency so a correlated slow tail hitting
        # every worker at once (exactly what hedging exists for) still
        # leaves a free slot for each duplicate — W primaries must
        # never queue out their own hedges.
        workers = max(1, int(getattr(opts, "executor_workers", 1)))
        hedge = HedgeController(
            quantile, getattr(opts, "hedge_min_s", 0.05),
            max_workers=2 * workers)
    return ResilienceManager(hedge=hedge, deadline_s=deadline_s)


def snapshot() -> Dict[str, Any]:
    """Resilience state for ``/healthz``: the budget's fill level and
    every breaker's state machine.  Empty dict when nothing is
    configured (the endpoint then omits the section)."""
    out: Dict[str, Any] = {}
    budget = _BUDGET
    if budget is not None:
        out["budget"] = budget.snapshot()
    breakers = breakers_snapshot()
    if breakers:
        out["breakers"] = breakers
    return out


def reset_resilience() -> None:
    """Test hook: drop the budget, every breaker, and their config."""
    global _BUDGET, _breaker_config
    with _budget_lock:
        _BUDGET = None
    with _breaker_lock:
        _BREAKERS.clear()
        _breaker_config = None
