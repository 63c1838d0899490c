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
(the crash-resumable read, ``runtime/manifest.py``) and
``http_cache_blocks``; the reference's resilience, introspection, SLO
and flight-recorder fields are not ported yet.
"""

from __future__ import annotations

import enum
import random
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional, TypeVar

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
    device_deflate: bool = False
    span_log: Optional[str] = None
    read_filter: Optional[str] = None
    http_cache_blocks: Optional[int] = None

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

    def with_read_ledger(self, path: str) -> "DisqOptions":
        return replace(self, read_ledger=path)

    def with_device_deflate(self, enable: bool = True) -> "DisqOptions":
        return replace(self, device_deflate=bool(enable))

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


class MissingReferenceError(ValueError):
    """Reference FASTA absent or wrong for reference-compressed CRAM — a
    configuration error, never retried and never a corrupt block."""


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
    if isinstance(exc, CorruptBlockError) or \
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


class ShardRetrier:
    """Bounded retry of transient faults with decorrelated-jitter backoff
    (``sleep = uniform(base, 3 × prev)``, capped at ``base ×
    2^max_retries``). ``call(fn, ...)`` runs ``fn`` up to ``1 +
    max_retries`` times, retrying only what ``is_transient`` accepts;
    ``retried`` counts the retries."""

    def __init__(self, max_retries: int = 3, backoff_s: float = 0.05,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None) -> None:
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self._sleep = sleep
        self._rng = rng if rng is not None else _JITTER_RNG
        self.retried = 0

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
        while True:
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — classified below
                if not is_transient(e) or attempt >= self.max_retries:
                    raise
                attempt += 1
                self.retried += 1
                counter("retry.attempts").inc(what=what)
                prev_sleep = self._next_backoff(prev_sleep)
                with span("retry.backoff", what=what, attempt=attempt):
                    self._sleep(prev_sleep)


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
                                 rng=self.retrier._rng),
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
        if self.policy is ErrorPolicy.QUARANTINE:
            self._quarantine_sink().quarantine(
                self.path, block_offset, raw, shard_id=self.shard_id,
                virtual_offset=virtual_offset, error=str(error), kind=kind)
            self.quarantined_blocks += 1
            if not getattr(self, "_is_silent", False):
                counter("quarantine.blocks").inc(kind=kind)
        else:
            self.skipped_blocks += 1
            if not getattr(self, "_is_silent", False):
                counter("errors.skipped_blocks").inc(kind=kind)

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


def context_for_storage(storage, path: str) -> ShardErrorContext:
    """The read's error context from the storage's ``DisqOptions``
    (absent ⇒ STRICT, 3 retries). Every source starts here, so this is
    also where ``span_log`` starts the JSONL span sink."""
    opts = getattr(storage, "_options", None) or DisqOptions()
    if opts.span_log:
        start_span_log(opts.span_log)
    return ShardErrorContext(
        policy=ErrorPolicy.coerce(opts.error_policy), path=path,
        retrier=ShardRetrier(opts.max_retries, opts.retry_backoff_s),
        quarantine_dir=opts.quarantine_dir)


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
