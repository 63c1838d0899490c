"""Read-path error policy: retry, skip, quarantine.

Counterpart of ``disq_tpu/runtime/errors.py``:

- **Transient faults** (a range read that raised ``TransientIOError``,
  timed out or came back short) are retried per shard with bounded
  backoff (``ShardRetrier``), and counted (``ShardCounters.retried_reads``).
- **Corrupt data** (a failed CRC, bad DEFLATE bits, impossible framing)
  is not retried — re-reading corrupt bytes yields the same bytes. It
  follows the storage's ``ErrorPolicy``:

  - ``STRICT`` (default): raise ``CorruptBlockError`` with the block's
    coordinates (path, shard, compressed block offset, virtual offset);
  - ``SKIP``: drop the corrupt block, count it, decode the rest;
  - ``QUARANTINE``: as ``SKIP``, and copy the corrupt compressed bytes
    to a sidecar recorded in a ``QuarantineManifest``
    (``runtime/manifest.py``).

``DisqOptions`` carries the fields this path reads, ``read_ledger``
(the crash-resumable read, ``runtime/manifest.py``),
``http_cache_blocks``, and the knobs of the resilience
(``runtime/resilience.py``), introspection (``runtime/introspect.py``),
SLO (``runtime/slo.py``), flight-recorder (``runtime/flightrec.py``) and
profiler (``runtime/profiler.py``) planes and of the shard scheduler
(``runtime/scheduler.py``), each off by default.
``ShardRetrier`` is the resilience layer's choke point: the shared
retry budget, a filesystem's circuit breaker and a shard's deadline all
act through it.
"""

from __future__ import annotations

import enum
import random
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional, TypeVar

from disq_tpu_torch.runtime import flightrec
from disq_tpu_torch.runtime.tracing import counter, span, start_span_log

T = TypeVar("T")


class ErrorPolicy(enum.Enum):
    """What to do with a shard's corrupt (non-transient) block."""

    STRICT = "strict"
    SKIP = "skip"
    QUARANTINE = "quarantine"

    @classmethod
    def coerce(cls, value: "ErrorPolicy | str") -> "ErrorPolicy":
        if isinstance(value, cls):
            return value
        try:
            return cls(str(value).lower())
        except ValueError:
            raise ValueError(
                f"unknown error policy {value!r}; expected one of "
                f"{[p.value for p in cls]}"
            ) from None


@dataclass(frozen=True)
class DisqOptions:
    """Read and write runtime knobs of a storage.

    ``quarantine_dir`` defaults to ``<input path> + ".quarantine"`` for
    local inputs; other schemes must set it.

    ``executor_workers`` / ``prefetch_shards`` size the read's shard
    executor (``runtime/executor.py``): 1 worker (the default) runs the
    splits inline in order; N > 1 overlaps range reads, inflate and
    record decode across splits with at most ``prefetch_shards`` splits
    in flight past the emit frontier (None ⇒ ``2 × executor_workers``).
    ``writer_workers`` / ``writer_prefetch_shards`` are the write-side
    mirror (``ShardWritePipeline``). Output is identical at any width.

    ``read_ledger`` points the crash-resumable read ledger at a
    directory: each decoded split is spilled there as it emits, and a
    read run again with the same ledger decodes only the unfinished
    splits (``runtime/manifest.py:ReadLedger``).

    ``device_deflate`` arms the device write path (``ops/deflate.py``,
    ``runtime/device_write.py``; env ``DISQ_TPU_TORCH_DEVICE_DEFLATE``):
    every BGZF deflate of the storage's sinks runs kernel W2, and a
    sorted device-backed batch gathers its records with kernel W1. Its
    blocks are valid BGZF that decompresses to the same bytes, but not
    the zlib-6 bytes, so it is off by default.

    ``span_log`` points the process-wide JSONL span sink
    (``runtime/tracing.py``) at a path when a read through the storage
    starts, as ``DISQ_TPU_TORCH_TRACE_JSONL`` does: one sink per
    process, the storage that most recently started a read wins, and it
    keeps collecting until ``stop_span_log()``.

    ``read_filter`` pushes a ``samtools view``-grammar predicate into
    the BAM decode (``ops/rfilter.py``; env ``DISQ_TPU_TORCH_READ_FILTER``):
    each split's batch is filtered inside ``bam.split.decode``, on the
    device with kernel F1 for a device-backed batch. None (the default)
    builds no mask.

    ``http_cache_blocks`` sizes the remote filesystem's block LRU
    (``fsw/http.py``) when a read built from these options starts: every
    registered HTTP wrapper, and the default for wrappers built later.
    None keeps the default (32 blocks of 4 MiB, or
    ``DISQ_TPU_TORCH_HTTP_CACHE_BLOCKS``).

    Live introspection (``runtime/introspect.py``): ``introspect_port``
    starts the process-wide 127.0.0.1 endpoint the first time a pipeline
    built from these options runs (0: an ephemeral port; env
    ``DISQ_TPU_TORCH_INTROSPECT_PORT``); ``watchdog_stall_s`` flags a
    shard whose active stage has been silent that long, and
    ``watchdog_policy="abort"`` then cancels the run with a
    ``WatchdogStallError``; ``progress_log`` appends periodic JSONL
    progress lines.

    Resilience (``runtime/resilience.py``): ``hedge_quantile`` /
    ``hedge_min_s`` hedge a fetch that outlives that quantile of the
    run's fetch latencies; ``shard_deadline_s`` gives each shard a
    wall-clock budget (a skip/quarantine read sets an over-budget shard
    aside as one empty shard); ``retry_budget_tokens`` /
    ``retry_budget_refill`` install the process-wide retry token bucket;
    ``breaker_window`` / ``breaker_cooldown_s`` arm the per-filesystem
    circuit breaker.

    Postmortem and profiling: ``postmortem_dir`` arms the flight
    recorder (bundles on every abort; env
    ``DISQ_TPU_TORCH_POSTMORTEM_DIR``), ``profile_hz`` starts the
    sampling profiler (env ``DISQ_TPU_TORCH_PROFILE_HZ``), and ``slo``
    arms the per-tenant burn-rate evaluator (env ``DISQ_TPU_TORCH_SLO``).

    The shard scheduler (``runtime/scheduler.py``): ``scheduler`` None
    (the default) keeps the static split loops, with no coordinator,
    thread or socket; ``"serve"`` hosts the coordinator on this process's
    introspection endpoint and works; ``"host:port"`` joins that
    coordinator; ``"auto"`` finds it through ``sched_failover_dir``.
    ``sched_lease_n`` splits per lease, ``sched_lease_s`` seconds before
    an unfinished lease goes back to the queue, ``sched_steal`` lets an
    idle worker take a stale lease, ``sched_run_weight`` is the run's
    share under the coordinator's weighted max-min quota, and
    ``sched_failover_dir`` arms coordinator failover (a journal, the
    address file and the member registry in that directory). Env
    ``DISQ_TPU_TORCH_SCHED`` and ``DISQ_TPU_TORCH_SCHED_{LEASE_N,LEASE_S,
    STEAL,WEIGHT,FAILOVER}``; the env wins for the tuning knobs, so a
    subprocess worker takes its launcher's settings.

    ``resident_decode`` takes the device route (the kernels, or their
    plain versions on the CPU) off ``cuda``, where it is always on (env
    ``DISQ_TPU_TORCH_RESIDENT_DECODE``). ``mesh`` shards the resident
    parse, sort and reductions over a ``batch`` axis of local devices
    (``runtime/mesh.py``): None (the default) builds no mesh, 0 takes
    every local device, ``n`` the first n, floored to a power of two
    (one device is the off path; env ``DISQ_TPU_TORCH_MESH``).
    """

    error_policy: ErrorPolicy = ErrorPolicy.STRICT
    max_retries: int = 3
    retry_backoff_s: float = 0.05
    quarantine_dir: Optional[str] = None
    executor_workers: int = 1
    prefetch_shards: Optional[int] = None
    writer_workers: int = 1
    writer_prefetch_shards: Optional[int] = None
    read_ledger: Optional[str] = None
    resident_decode: bool = False
    device_deflate: bool = False
    mesh: Optional[int] = None
    span_log: Optional[str] = None
    read_filter: Optional[str] = None
    http_cache_blocks: Optional[int] = None
    introspect_port: Optional[int] = None
    watchdog_stall_s: Optional[float] = None
    watchdog_policy: str = "warn"
    progress_log: Optional[str] = None
    hedge_quantile: Optional[float] = None
    hedge_min_s: float = 0.05
    shard_deadline_s: Optional[float] = None
    retry_budget_tokens: Optional[int] = None
    retry_budget_refill: float = 0.1
    breaker_window: Optional[int] = None
    breaker_cooldown_s: float = 1.0
    postmortem_dir: Optional[str] = None
    profile_hz: Optional[float] = None
    slo: Optional[str] = None
    scheduler: Optional[str] = None
    sched_lease_n: int = 2
    sched_lease_s: float = 10.0
    sched_steal: bool = True
    sched_run_weight: float = 1.0
    sched_failover_dir: Optional[str] = None

    def with_policy(self, policy: "ErrorPolicy | str") -> "DisqOptions":
        return replace(self, error_policy=ErrorPolicy.coerce(policy))

    def with_executor(self, workers: int,
                      prefetch_shards: Optional[int] = None) -> "DisqOptions":
        if workers < 1:
            raise ValueError(f"executor_workers must be >= 1, got {workers}")
        return replace(self, executor_workers=int(workers),
                       prefetch_shards=prefetch_shards)

    def with_writer(self, workers: int,
                    prefetch_shards: Optional[int] = None) -> "DisqOptions":
        if workers < 1:
            raise ValueError(f"writer_workers must be >= 1, got {workers}")
        return replace(self, writer_workers=int(workers),
                       writer_prefetch_shards=prefetch_shards)

    def with_watchdog(self, stall_s: float,
                      policy: str = "warn") -> "DisqOptions":
        if stall_s <= 0:
            raise ValueError(
                f"watchdog_stall_s must be > 0, got {stall_s}")
        if policy not in ("warn", "abort"):
            raise ValueError(
                f"watchdog_policy must be 'warn' or 'abort', got {policy!r}")
        return replace(self, watchdog_stall_s=float(stall_s),
                       watchdog_policy=policy)

    def with_hedging(self, quantile: float,
                     min_s: float = 0.05) -> "DisqOptions":
        if not 0.0 < quantile < 1.0:
            raise ValueError(
                f"hedge_quantile must be in (0, 1), got {quantile}")
        if min_s < 0:
            raise ValueError(f"hedge_min_s must be >= 0, got {min_s}")
        return replace(self, hedge_quantile=float(quantile),
                       hedge_min_s=float(min_s))

    def with_shard_deadline(self, deadline_s: float) -> "DisqOptions":
        if deadline_s <= 0:
            raise ValueError(
                f"shard_deadline_s must be > 0, got {deadline_s}")
        return replace(self, shard_deadline_s=float(deadline_s))

    def with_retry_budget(self, tokens: int,
                          refill_per_success: float = 0.1) -> "DisqOptions":
        if tokens < 1:
            raise ValueError(
                f"retry_budget_tokens must be >= 1, got {tokens}")
        return replace(self, retry_budget_tokens=int(tokens),
                       retry_budget_refill=float(refill_per_success))

    def with_breaker(self, window: int,
                     cooldown_s: float = 1.0) -> "DisqOptions":
        if window < 1:
            raise ValueError(f"breaker_window must be >= 1, got {window}")
        if cooldown_s <= 0:
            raise ValueError(
                f"breaker_cooldown_s must be > 0, got {cooldown_s}")
        return replace(self, breaker_window=int(window),
                       breaker_cooldown_s=float(cooldown_s))

    def with_read_ledger(self, path: str) -> "DisqOptions":
        return replace(self, read_ledger=path)

    def with_postmortem(self, path: str) -> "DisqOptions":
        if not path:
            raise ValueError("postmortem_dir must be a non-empty path")
        return replace(self, postmortem_dir=path)

    def with_profile(self, hz: float) -> "DisqOptions":
        if hz <= 0:
            raise ValueError(f"profile_hz must be > 0, got {hz}")
        return replace(self, profile_hz=float(hz))

    def with_slo(self, spec: str) -> "DisqOptions":
        """Attach a per-tenant SLO spec, validated here so a typo fails
        when the options are built."""
        from disq_tpu_torch.runtime.slo import parse_slo_spec

        parse_slo_spec(spec)  # raises ValueError on a malformed spec
        return replace(self, slo=str(spec))

    def with_scheduler(self, mode: str, lease_n: int = 2,
                       lease_s: float = 10.0, steal: bool = True,
                       run_weight: float = 1.0,
                       failover_dir: Optional[str] = None) -> "DisqOptions":
        """Join the shard scheduler, validated here so a bad knob fails
        when the options are built."""
        if not mode:
            raise ValueError(
                "scheduler mode must be 'serve', 'auto' or 'host:port'")
        if lease_n < 1:
            raise ValueError(f"sched_lease_n must be >= 1, got {lease_n}")
        if lease_s <= 0:
            raise ValueError(f"sched_lease_s must be > 0, got {lease_s}")
        if run_weight <= 0:
            raise ValueError(
                f"sched_run_weight must be > 0, got {run_weight}")
        return replace(self, scheduler=str(mode), sched_lease_n=int(lease_n),
                       sched_lease_s=float(lease_s), sched_steal=bool(steal),
                       sched_run_weight=float(run_weight),
                       sched_failover_dir=(str(failover_dir)
                                           if failover_dir else None))

    def with_resident_decode(self, enable: bool = True) -> "DisqOptions":
        return replace(self, resident_decode=bool(enable))

    def with_device_deflate(self, enable: bool = True) -> "DisqOptions":
        return replace(self, device_deflate=bool(enable))

    def with_mesh(self, devices: int = 0) -> "DisqOptions":
        """Arm the mesh: 0 = every local device, n = the first n
        (power-of-two floor; one device keeps the single-device path)."""
        if devices < 0:
            raise ValueError(f"mesh devices must be >= 0, got {devices}")
        return replace(self, mesh=int(devices))

    def with_http_cache_blocks(self, n: int) -> "DisqOptions":
        if n < 1:
            raise ValueError(f"http_cache_blocks must be >= 1, got {n}")
        return replace(self, http_cache_blocks=int(n))

    def with_read_filter(self, spec: str) -> "DisqOptions":
        """Push a read filter into the decode, validated here so a typo
        fails when the options are built, not per split."""
        from disq_tpu_torch.ops.rfilter import parse_read_filter

        parse_read_filter(spec)  # raises ValueError on a malformed spec
        return replace(self, read_filter=str(spec))


class CorruptBlockError(ValueError):
    """A compressed block failed decode with certainty (CRC mismatch,
    invalid DEFLATE bits, impossible framing), with its coordinates."""

    def __init__(
        self,
        message: str,
        *,
        path: str = "",
        shard_id: int = -1,
        block_offset: int = -1,
        virtual_offset: Optional[int] = None,
    ) -> None:
        detail = (
            f"{message} [path={path!r} shard={shard_id} "
            f"block_offset={block_offset}"
            + (f" voffset={virtual_offset:#x}"
               if virtual_offset is not None else "")
            + "]"
        )
        super().__init__(detail)
        self.path = path
        self.shard_id = shard_id
        self.block_offset = block_offset
        self.virtual_offset = virtual_offset


class FlaggedBlocksError(ValueError):
    """A device batch inflate that flagged blocks or failed their CRC.
    ``bad`` lists them (indices in the batch); the batch's other blocks
    decoded into ``blob`` (host) and ``blob_dev`` (device, or None) at
    ``out_off``, which the salvage path keeps."""

    def __init__(self, message: str, bad, *, blob=None, blob_dev=None,
                 out_off=None) -> None:
        super().__init__(message)
        self.bad = [int(i) for i in bad]
        self.blob = blob
        self.blob_dev = blob_dev
        self.out_off = out_off


class TransientIOError(IOError):
    """An error known to be transient (the fault injector raises it)."""


class CoordinatorLostError(TransientIOError):
    """The shard scheduler's coordinator became unreachable mid-run
    (``runtime/scheduler.py``). Transient: with failover armed the
    worker finds the new coordinator and retries; without it, or once
    the rediscovery retries run out, it is the read's failure."""

    def __init__(self, message: str, *, address: str = "",
                 op: str = "") -> None:
        super().__init__(
            f"{message} [address={address or '?'} op={op or '?'}]")
        self.address = address
        self.op = op


class MissingReferenceError(ValueError):
    """Reference FASTA absent or wrong for reference-compressed CRAM — a
    configuration error, never retried and never a corrupt block."""


class WatchdogStallError(RuntimeError):
    """The heartbeat watchdog (``runtime/introspect.py``) flagged a shard
    silent past ``watchdog_stall_s`` under ``watchdog_policy="abort"``:
    the run is cancelled through its first-error-abort path. Not
    transient: retrying the work the watchdog declared wedged would hide
    the hang."""

    def __init__(self, message: str, *, shard_id: int = -1,
                 stage: str = "", age_s: float = 0.0,
                 direction: str = "") -> None:
        detail = (f"{message} [direction={direction or '?'} "
                  f"shard={shard_id} stage={stage or '?'} "
                  f"silent_for={age_s:.3f}s]")
        super().__init__(detail)
        self.shard_id = shard_id
        self.stage = stage
        self.age_s = age_s
        self.direction = direction


class DeadlineExceededError(RuntimeError):
    """A shard spent its ``shard_deadline_s`` budget: the last rung of
    the escalation ladder (retry, hedge, this). Not transient. Under
    skip and quarantine the sources set the shard aside as one empty
    shard instead of aborting the run."""

    def __init__(self, message: str, *, shard_id: int = -1,
                 elapsed_s: float = 0.0, deadline_s: float = 0.0) -> None:
        detail = (f"{message} [shard={shard_id} "
                  f"elapsed={elapsed_s:.3f}s deadline={deadline_s:.3f}s]")
        super().__init__(detail)
        self.shard_id = shard_id
        self.elapsed_s = elapsed_s
        self.deadline_s = deadline_s


class BreakerOpenError(RuntimeError):
    """The circuit breaker guarding a filesystem is open: the call was
    refused before it reached the store (``runtime/resilience.py``). Not
    transient: the breaker exists to stop retry loops against a store it
    has declared degraded."""

    def __init__(self, message: str, *, key: str = "",
                 retry_after_s: float = 0.0) -> None:
        super().__init__(
            f"{message} [filesystem={key or '?'} "
            f"retry_after={retry_after_s:.3f}s]")
        self.key = key
        self.retry_after_s = retry_after_s


class TruncatedReadError(OSError, ValueError):
    """A range read returned fewer bytes than the on-disk structure
    requires: an I/O symptom (retried) and a ValueError for callers of
    the block walk."""


# OSError subclasses that are definitive, not worth retrying.
_PERMANENT_OS_ERRORS = (
    FileNotFoundError, PermissionError, IsADirectoryError,
    NotADirectoryError, FileExistsError,
)


def is_transient(exc: BaseException) -> bool:
    """Transient (retryable) against permanent or corrupt."""
    if isinstance(exc, TransientIOError):
        return True
    if isinstance(exc, (CorruptBlockError, WatchdogStallError,
                        DeadlineExceededError, BreakerOpenError)) or \
            isinstance(exc, _PERMANENT_OS_ERRORS):
        return False
    if isinstance(exc, (TimeoutError, ConnectionError, TruncatedReadError)):
        return True
    import http.client
    import urllib.error

    if isinstance(exc, urllib.error.HTTPError):
        return exc.code >= 500  # a 4xx is definitive
    if isinstance(exc, (urllib.error.URLError, http.client.HTTPException)):
        # network errors, IncompleteRead, RemoteDisconnected: wire-level
        # symptoms a re-request can fix
        return True
    return isinstance(exc, OSError)


def corrupt(error: BaseException, *, kind: str, path: str, shard_id: int,
            block_offset: int,
            virtual_offset: Optional[int] = None) -> CorruptBlockError:
    """The strict policy's error for one corrupt block or record run."""
    return CorruptBlockError(
        f"corrupt {kind}: {error}", path=path, shard_id=shard_id,
        block_offset=block_offset, virtual_offset=virtual_offset)


# Shared backoff-jitter RNG: concurrent retriers draw different sleeps.
_JITTER_RNG = random.Random()


_resilience = None  # the module, bound at first use (an import cycle)


def _resilience_mod():
    global _resilience
    if _resilience is None:
        from disq_tpu_torch.runtime import resilience

        _resilience = resilience
    return _resilience


class ShardRetrier:
    """Bounded retry of transient faults with decorrelated-jitter backoff
    (``sleep = uniform(base, 3 × prev)``, capped at ``base ×
    2^max_retries``). ``call(fn, ...)`` runs ``fn`` up to ``1 +
    max_retries`` times, retrying only what ``is_transient`` accepts;
    ``retried`` counts the retries.

    The resilience hooks, each a no-op until its knob is set: the
    process-wide ``RetryBudget`` is drawn before every retry (a dry
    bucket re-raises the error); an attached ``breaker`` gates every
    attempt (``BreakerOpenError`` while open) and hears every transient
    outcome; an attached ``deadline`` ends the retries with a
    ``DeadlineExceededError`` once the shard's budget is spent."""

    def __init__(self, max_retries: int = 3, backoff_s: float = 0.05,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None,
                 breaker=None) -> None:
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self._sleep = sleep
        self._rng = rng if rng is not None else _JITTER_RNG
        self.retried = 0
        self.breaker = breaker
        self.deadline = None

    def _next_backoff(self, prev: float) -> float:
        base = self.backoff_s
        if base <= 0:
            return 0.0
        cap = base * (2 ** max(1, self.max_retries))
        return min(cap, self._rng.uniform(base, max(base, prev * 3)))

    def call(self, fn: Callable[..., T], *args: Any,
             what: str = "read", **kwargs: Any) -> T:
        attempt = 0
        prev_sleep = self.backoff_s
        if self.deadline is not None:
            # the shard's budget starts with its first attempt
            self.deadline.arm()
        while True:
            if self.breaker is not None:
                self.breaker.before_call()
            try:
                result = fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — classified below
                transient = is_transient(e)
                if self.breaker is not None:
                    if transient:
                        self.breaker.record_failure()
                    else:
                        # no verdict on the store, but a half-open probe
                        # slot must be freed
                        self.breaker.release_probe()
                if not transient or attempt >= self.max_retries:
                    raise
                if self.deadline is not None:
                    try:
                        self.deadline.check(what=what)
                    except Exception as deadline_exc:
                        raise deadline_exc from e
                budget = _resilience_mod().active_budget()
                if budget is not None and not budget.try_spend(what=what):
                    raise  # the bucket is dry: no stampede
                attempt += 1
                self.retried += 1
                counter("retry.attempts").inc(what=what)
                flightrec.record_event(
                    "retry", what=what, attempt=attempt,
                    error=f"{type(e).__name__}: {e}")
                prev_sleep = self._next_backoff(prev_sleep)
                with span("retry.backoff", what=what, attempt=attempt):
                    self._sleep(prev_sleep)
            else:
                if self.breaker is not None:
                    self.breaker.record_success()
                budget = _resilience_mod().active_budget()
                if budget is not None:
                    budget.on_success()
                return result


@dataclass
class ShardErrorContext:
    """Per-shard bundle: the policy, the retrier and the corrupt-block
    books, threaded through a source's shard loop."""

    policy: ErrorPolicy
    path: str
    shard_id: int = -1
    retrier: ShardRetrier = field(default_factory=ShardRetrier)
    quarantine: Optional["QuarantineManifest"] = None  # noqa: F821
    quarantine_dir: Optional[str] = None
    skipped_blocks: int = 0
    quarantined_blocks: int = 0

    def for_shard(self, shard_id: int) -> "ShardErrorContext":
        """A fresh per-shard view (own retrier and counts) sharing the
        policy and the quarantine sink."""
        ctx = ShardErrorContext(
            policy=self.policy, path=self.path, shard_id=shard_id,
            retrier=ShardRetrier(self.retrier.max_retries,
                                 self.retrier.backoff_s, self.retrier._sleep,
                                 rng=self.retrier._rng,
                                 breaker=self.retrier.breaker),
            quarantine=self.quarantine, quarantine_dir=self.quarantine_dir)
        ctx._parent = self  # type: ignore[attr-defined]
        return ctx

    def handle_corrupt_block(self, error: BaseException, *, block_offset: int,
                             raw: bytes = b"",
                             virtual_offset: Optional[int] = None,
                             kind: str = "block") -> None:
        """Apply the policy to one corrupt block: STRICT raises
        ``CorruptBlockError`` with its coordinates, SKIP counts it,
        QUARANTINE also copies ``raw`` to the sidecar."""
        if self.policy is ErrorPolicy.STRICT:
            raise corrupt(error, kind=kind, path=self.path,
                          shard_id=self.shard_id, block_offset=block_offset,
                          virtual_offset=virtual_offset) from error
        notes = getattr(self, "_notes", None)
        if notes is not None:
            notes.append((error, dict(block_offset=block_offset, raw=raw,
                                      virtual_offset=virtual_offset,
                                      kind=kind)))
            return
        if self.policy is ErrorPolicy.QUARANTINE:
            self._quarantine_sink().quarantine(
                self.path, block_offset, raw, shard_id=self.shard_id,
                virtual_offset=virtual_offset, error=str(error), kind=kind)
            self.quarantined_blocks += 1
            if not getattr(self, "_is_silent", False):
                counter("quarantine.blocks").inc(kind=kind)
                flightrec.record_event(
                    "quarantine", block_kind=kind, path=self.path,
                    shard=self.shard_id, block_offset=block_offset,
                    error=str(error))
        else:
            self.skipped_blocks += 1
            if not getattr(self, "_is_silent", False):
                counter("errors.skipped_blocks").inc(kind=kind)
                flightrec.record_event(
                    "skipped_block", block_kind=kind, path=self.path,
                    shard=self.shard_id, block_offset=block_offset,
                    error=str(error))

    def attempt(self) -> "ShardErrorContext":
        """A view for one fetch attempt that may race another (a hedged
        fetch): STRICT raises as ever, but under skip and quarantine each
        corrupt block is only noted, and ``commit`` books the notes of
        the attempt that won. The loser's notes are dropped with it, so
        neither the counts nor the quarantine sidecar double."""
        ctx = ShardErrorContext(policy=self.policy, path=self.path,
                                shard_id=self.shard_id,
                                quarantine_dir=self.quarantine_dir)
        ctx._notes = []  # type: ignore[attr-defined]
        return ctx

    def commit(self, attempt: "ShardErrorContext") -> None:
        """Book the corrupt blocks ``attempt`` noted, as a fetch of this
        context would have: the counts start again (a retried fetch
        counts once), then each note goes to the policy."""
        self.skipped_blocks = 0
        self.quarantined_blocks = 0
        for error, kwargs in attempt._notes:  # type: ignore[attr-defined]
            self.handle_corrupt_block(error, **kwargs)

    def silent(self) -> "ShardErrorContext":
        """A non-counting view for blocks this shard reads but does not
        own (a boundary straddle, a boundary-guess window): the owner
        counts and quarantines them. STRICT still raises."""
        if self.policy is ErrorPolicy.STRICT:
            return self
        ctx = ShardErrorContext(policy=ErrorPolicy.SKIP, path=self.path,
                                shard_id=self.shard_id)
        # nor does it book the telemetry counters: the owner does
        ctx._is_silent = True  # type: ignore[attr-defined]
        return ctx

    # two shards meeting their first corrupt block at once share ONE
    # manifest: sink creation is locked
    _sink_lock = threading.Lock()

    def _quarantine_sink(self) -> "QuarantineManifest":  # noqa: F821
        if self.quarantine is None:
            from disq_tpu_torch.runtime.manifest import QuarantineManifest

            parent = getattr(self, "_parent", None)
            with ShardErrorContext._sink_lock:
                if parent is not None and parent.quarantine is not None:
                    self.quarantine = parent.quarantine
                    return self.quarantine
                base = self.quarantine_dir
                if base is None:
                    if "://" in self.path:
                        raise ValueError(
                            "ErrorPolicy.QUARANTINE on input "
                            f"{self.path!r} requires an explicit "
                            "DisqOptions.quarantine_dir — the default "
                            "sidecar location <input>.quarantine only "
                            "exists for local files")
                    base = self.path + ".quarantine"
                self.quarantine = QuarantineManifest(base)
                if parent is not None:
                    parent.quarantine = self.quarantine
        return self.quarantine


class FetchAttempt:
    """A hedged fetch's payload with the books of its attempt
    (``ShardErrorContext.attempt``); ``nbytes`` is what a lost race
    wasted (``hedge.wasted_bytes``)."""

    __slots__ = ("payload", "books", "nbytes")

    def __init__(self, payload, books: ShardErrorContext,
                 nbytes: int = 0) -> None:
        self.payload = payload
        self.books = books
        self.nbytes = int(nbytes)


def committed(fetched, ctx: ShardErrorContext):
    """The payload of a fetch: a ``FetchAttempt`` has its books committed
    to ``ctx`` (the decode of the winning attempt books once)."""
    if isinstance(fetched, FetchAttempt):
        ctx.commit(fetched.books)
        return fetched.payload
    return fetched


def context_for_storage(storage, path: str) -> ShardErrorContext:
    """The read's error context from the storage's ``DisqOptions``
    (absent ⇒ STRICT, 3 retries). Every source starts here, so this is
    also where ``span_log`` starts the JSONL span sink, the flight
    recorder and the SLO evaluator are armed, and the retry budget and
    the path's circuit breaker are installed."""
    opts = getattr(storage, "_options", None) or DisqOptions()
    if opts.span_log:
        start_span_log(opts.span_log)
    # the event ring is live before any split is planned
    flightrec.configure_from_options(opts)
    if opts.slo:
        from disq_tpu_torch.runtime import slo

        slo.configure_from_options(opts)
    breaker = None
    if opts.retry_budget_tokens is not None or \
            opts.breaker_window is not None:
        res = _resilience_mod()
        res.configure_globals_from_options(opts)
        breaker = res.breaker_for(path)
    return ShardErrorContext(
        policy=ErrorPolicy.coerce(opts.error_policy), path=path,
        retrier=ShardRetrier(opts.max_retries, opts.retry_backoff_s,
                             breaker=breaker),
        quarantine_dir=opts.quarantine_dir)


def deadline_fallback_for(opts, shard_ctx: Optional[ShardErrorContext],
                          make_empty: Callable[[], T]
                          ) -> Optional[Callable[[], T]]:
    """A ``ShardTask.deadline_fallback`` for one shard: under skip or
    quarantine with ``shard_deadline_s`` set, an over-budget shard is
    booked as one corrupt unit (``kind="shard deadline"`` in the
    quarantine manifest) and replaced by ``make_empty()``. STRICT, or no
    deadline, gets None: the ``DeadlineExceededError`` aborts the run."""
    if getattr(opts, "shard_deadline_s", None) is None:
        return None
    if shard_ctx is None or shard_ctx.policy is ErrorPolicy.STRICT:
        return None

    def fallback() -> T:
        shard_ctx.handle_corrupt_block(
            DeadlineExceededError(
                "shard deadline exceeded — shard set aside",
                shard_id=shard_ctx.shard_id,
                deadline_s=float(opts.shard_deadline_s)),
            block_offset=-1, kind="shard deadline")
        return make_empty()

    return fallback


def inflate_blocks_salvage(data, blocks, base: int, ctx: ShardErrorContext,
                           owned_until: Optional[int] = None):
    """Per-block host inflate under ``ctx``'s policy: the per-block
    payloads, with ``None`` where a corrupt block was skipped or
    quarantined (STRICT raises at the first). Blocks at or past
    ``owned_until`` belong to the next shard and are handled through
    ``ctx.silent()``. The slow path behind a batch inflate that failed;
    the fault-free read never runs it."""
    from disq_tpu_torch.bgzf.codec import inflate_block

    payloads = []
    for b in blocks:
        try:
            payloads.append(inflate_block(data, b.pos - base))
        except ValueError as e:
            _corrupt_block(ctx, e, data, b, base, owned_until)
            payloads.append(None)
    return payloads


def salvage_flagged(data, blocks, base: int, ctx: ShardErrorContext,
                    err: FlaggedBlocksError,
                    owned_until: Optional[int] = None) -> list:
    """The device route's salvage: only the blocks the batch flagged
    inflate alone on the host. One that inflates there was a fault of
    the batch, not of the data, and ``err`` is raised; the others go to
    the policy as in ``inflate_blocks_salvage``. Returns the per-block
    mask of lost blocks."""
    from disq_tpu_torch.bgzf.codec import inflate_block

    failed = []
    for i in err.bad:
        try:
            inflate_block(data, blocks[i].pos - base)
        except ValueError as e:
            failed.append((i, e))
        else:
            raise err
    lost = [False] * len(blocks)
    for i, e in failed:
        _corrupt_block(ctx, e, data, blocks[i], base, owned_until)
        lost[i] = True
    return lost


def _corrupt_block(ctx: ShardErrorContext, error: BaseException, data, b,
                   base: int, owned_until: Optional[int]) -> None:
    """One BGZF block that failed alone on the host, to the policy;
    blocks at or past ``owned_until`` through ``ctx.silent()``."""
    from disq_tpu_torch.bgzf.block import make_virtual_offset

    target = (ctx.silent() if owned_until is not None and b.pos >= owned_until
              else ctx)
    off = b.pos - base
    target.handle_corrupt_block(
        error, block_offset=b.pos, raw=bytes(data[off: off + b.csize]),
        virtual_offset=make_virtual_offset(b.pos, 0), kind="BGZF block")
