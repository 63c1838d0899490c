"""Pipelined shard executor: bounded stage overlap in both directions.

Counterpart of ``disq_tpu/runtime/executor.py``. One core,
``_BoundedStagePipeline``, runs N stages, each on its own thread pool,
and emits results in task order:

- **Read** (``ShardPipelineExecutor``): fetch (range read and BGZF block
  walk) → decode (inflate, record scan, parse) → ordered emit.
- **Write** (``ShardWritePipeline``): encode (batch slice and record
  encode) → deflate (BGZF compression, voffset and index arithmetic) →
  stage (the part's durable write) → ordered emit.

Guarantees:

- **Order and identity.** Results come out in task order at any worker
  count, and each shard runs the same per-shard code, so output is
  identical for any ``workers``.
- **Inline default.** ``workers=1`` runs everything on the caller's
  thread, shard after shard — no threads, no queues.
- **Bounded window.** At most ``prefetch_shards`` shards past the emit
  frontier are admitted (default ``2 × workers``), so memory stays
  bounded by ``window × shard bytes``.
- **Errors.** Each task carries its shard's ``ShardRetrier``: transient
  faults in fetch retry the fetch; a transient fault escaping decode
  (a salvage re-read) re-runs the shard from fetch. The first raising
  shard aborts the run, raised at its turn in the emit order.
- **Resume.** ``run_write_stage`` with a ``StageManifest`` skips the
  shards it records and records each fresh one as its part lands;
  ``map_ordered_resumable`` with a ``ReadLedger`` serves finished splits
  from their spills and spills each fresh one as it emits
  (``runtime/manifest.py``).
- **Leases.** With the shard scheduler armed (``runtime/scheduler.py``)
  the sources' split loops and a manifest's write stage lease their
  shards from the shared queue instead; each task's ``byte_range`` is
  its locality coordinate there.

Kernel launches from decode threads go to the calling thread's current
CUDA stream; the executor adds no streams of its own.

Live introspection and resilience (``runtime/introspect.py``,
``runtime/resilience.py``), both off by default (``health=None``,
``resilience=None``: no hook runs): a run registers on the health board
and each stage worker stamps a per-shard heartbeat; the watchdog aborts
through the first-error-abort path. Only the fetch stage is hedged, and
each shard's deadline is checked at every stage boundary; a shard whose
deadline passes emits its task's ``deadline_fallback`` (skip and
quarantine) or aborts the run. Every abort goes to the flight recorder
(``flightrec.note_abort``).

Telemetry (``runtime/tracing.py``, the reference's names): per-shard
``executor.fetch`` / ``executor.decode`` spans, the ordered-emit stall
spans ``executor.emit.stall`` / ``writer.emit.stall`` (waits over half a
millisecond), and the window-depth gauges ``executor.in_flight`` /
``writer.in_flight``.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

from disq_tpu_torch.runtime import flightrec
from disq_tpu_torch.runtime.errors import (
    DeadlineExceededError,
    DisqOptions,
    ShardRetrier,
    is_transient,
)
from disq_tpu_torch.runtime.manifest import retry_shard
from disq_tpu_torch.runtime.tracing import observe_gauge, record_span, span

# an emit wait shorter than this is no stall worth a span
_STALL_SPAN_S = 0.0005

# what a fetch stage hands on when the shard's deadline passed and its
# task has a fallback: the decode stage then emits the fallback
_DEADLINE_MISS = object()


@dataclass
class ShardTask:
    """One split's work: ``fetch`` does the I/O (stage A) and returns a
    payload, ``decode`` turns it into the shard's result (stage B);
    ``retrier`` is the shard's ``ShardRetrier`` (None ⇒ no retry).
    ``deadline_fallback`` (skip and quarantine with a shard deadline)
    gives the shard's stand-in once its deadline passes; without one a
    ``DeadlineExceededError`` aborts the run. ``byte_range`` is the
    split's compressed byte window ``(lo, hi)`` in the input, which the
    shard scheduler's locality score matches against a worker's HTTP
    block cache (None: never routed by locality)."""

    shard_id: int
    fetch: Callable[[], Any]
    decode: Callable[[Any], Any]
    retrier: Optional[ShardRetrier] = None
    what: str = "shard"
    deadline_fallback: Optional[Callable[[], Any]] = None
    byte_range: Optional[Tuple[int, int]] = None


@dataclass
class ShardResult:
    """The decoded value and the shard's per-stage wall time."""

    shard_id: int
    value: Any
    fetch_seconds: float = 0.0
    decode_seconds: float = 0.0

    @property
    def wall_seconds(self) -> float:
        return self.fetch_seconds + self.decode_seconds


@dataclass
class ExecutorStats:
    """The size of one executor and the shards it ran."""

    workers: int = 0
    window: int = 0
    shards: int = 0
    max_in_flight: int = 0


class _BoundedStagePipeline:
    """N stages, one pool each, ordered streaming emit keyed by task
    index, first-error abort. ``stage_fns[i](task, payload)`` runs stage
    ``i`` (``payload`` is None for stage 0). ``on_admit(depth)`` keeps
    the in-flight high-water mark and ``on_stall(seconds, task)`` books
    each ordered-emit wait; both run with the pipeline's condition
    held. With a ``health`` board and its run ``health_token``, each
    stage worker beats as it starts a stage on a shard and clears as it
    ends, and the watchdog's abort is recorded at the emit frontier."""

    def __init__(self, workers: int, window: int,
                 stage_fns: Sequence[Callable[[Any, Any], Any]],
                 thread_prefixes: Sequence[str],
                 on_admit: Callable[[int], None],
                 on_stall: Callable[[float, Any], None],
                 drain_on_close: bool = False,
                 stage_names: Sequence[str] = (),
                 health=None, health_token: Optional[int] = None) -> None:
        self.workers = workers
        self.window = window
        self.stage_fns = list(stage_fns)
        self.thread_prefixes = list(thread_prefixes)
        self.on_admit = on_admit
        self.on_stall = on_stall
        # the write side drains running jobs at close, so an aborting
        # sink never races a part write against its temp-dir cleanup
        self.drain_on_close = drain_on_close
        self.stage_names = list(stage_names)
        self.health = health
        self.health_token = health_token

    def run(self, tasks: List[Any]) -> Iterator[tuple]:
        """Admit the first window now (stage 0 is in flight before the
        caller's first ``next()``) and return the generator yielding
        ``(index, value, per-stage seconds)`` in task order."""
        n_stages = len(self.stage_fns)
        cond = threading.Condition()
        results: Dict[int, tuple] = {}
        errors: Dict[int, BaseException] = {}
        state = {"next_admit": 0, "next_emit": 0, "in_flight": 0,
                 "aborted": False}
        pools = [ThreadPoolExecutor(max_workers=self.workers,
                                    thread_name_prefix=prefix)
                 for prefix in self.thread_prefixes]
        health, token = self.health, self.health_token
        if health is not None:
            def inject_abort(exc: BaseException) -> None:
                # the watchdog's abort, raised at the consumer's next
                # ``next()`` as a stage failure of the emit frontier
                with cond:
                    if not state["aborted"]:
                        errors.setdefault(state["next_emit"], exc)
                        cond.notify_all()

            health.set_abort(token, inject_abort)

        def job(stage: int, idx: int, task: Any, payload: Any,
                seconds: List[float]) -> None:
            if stage == 0:
                with cond:
                    if state["aborted"]:
                        state["in_flight"] -= 1
                        cond.notify_all()
                        return
            if health is not None:
                name = self.stage_names[stage]
                health.beat(token, name, task.shard_id)
            t0 = time.perf_counter()
            try:
                value = self.stage_fns[stage](task, payload)
            except BaseException as e:  # noqa: BLE001 — raised at emit
                if health is not None:
                    health.clear(token, name, task.shard_id)
                with cond:
                    errors[idx] = e
                    state["in_flight"] -= 1
                    cond.notify_all()
                return
            if health is not None:
                health.clear(token, name, task.shard_id)
            seconds.append(time.perf_counter() - t0)
            if stage + 1 < n_stages:
                pools[stage + 1].submit(job, stage + 1, idx, task, value,
                                        seconds)
                return
            with cond:
                results[idx] = (value, seconds)
                state["in_flight"] -= 1
                cond.notify_all()

        def admit_locked() -> None:
            while (not state["aborted"]
                   and state["next_admit"] < len(tasks)
                   and state["next_admit"] < state["next_emit"] + self.window):
                idx = state["next_admit"]
                state["next_admit"] += 1
                state["in_flight"] += 1
                self.on_admit(state["in_flight"])
                pools[0].submit(job, 0, idx, tasks[idx], None, [])

        with cond:
            admit_locked()

        def emit() -> Iterator[tuple]:
            try:
                for i in range(len(tasks)):
                    with cond:
                        t0 = time.perf_counter()
                        while i not in results and i not in errors:
                            cond.wait()
                        self.on_stall(time.perf_counter() - t0, tasks[i])
                        if i in errors:
                            state["aborted"] = True
                            # every stage worker is still live: the
                            # bundle's stacks show what each was doing
                            flightrec.note_abort(errors[i], where="emit")
                            raise errors[i]
                        value, seconds = results.pop(i)
                        state["next_emit"] = i + 1
                        admit_locked()
                    yield i, value, seconds
            finally:
                with cond:
                    state["aborted"] = True
                for pool in pools:
                    pool.shutdown(wait=self.drain_on_close,
                                  cancel_futures=True)

        return emit()


def _check_abort(health, token: Optional[int]) -> None:
    """The inline runs' watchdog abort: raise the parked
    ``WatchdogStallError`` at a stage boundary of the run's own
    thread."""
    if health is not None:
        exc = health.take_abort(token)
        if exc is not None:
            raise exc


def _tracked(inner: Iterator, health, token: int) -> Iterator:
    """``inner`` with each emitted shard marked done on the health board
    and the run closed when the iterator ends, fails or is dropped."""
    try:
        for res in inner:
            health.shard_done(token, res.shard_id)
            yield res
    finally:
        health.finish_run(token)


class ShardPipelineExecutor:
    """The read direction: fetch → decode → ordered emit. ``workers``
    sizes both pools; ``prefetch_shards`` bounds the shards in flight
    past the emit frontier (default ``2 × workers``). ``health`` (a
    ``PipelineHealth`` board) and ``resilience`` (a
    ``ResilienceManager``) are None unless the storage's options arm
    them."""

    def __init__(self, workers: int = 1,
                 prefetch_shards: Optional[int] = None, health=None,
                 watchdog_stall_s: Optional[float] = None,
                 watchdog_policy: str = "warn", resilience=None) -> None:
        self.workers = max(1, int(workers))
        if prefetch_shards is None:
            prefetch_shards = 2 * self.workers
        self.prefetch_shards = max(1, int(prefetch_shards))
        self.stats = ExecutorStats(workers=self.workers,
                                   window=self.prefetch_shards)
        self._health = health
        self._watchdog_stall_s = watchdog_stall_s
        self._watchdog_policy = watchdog_policy
        self._resilience = resilience

    def map_ordered(self, tasks: Sequence[ShardTask]) -> Iterator[ShardResult]:
        """Run every task through fetch → decode, yielding results in
        task order as they become ready."""
        tasks = list(tasks)
        self.stats.shards += len(tasks)
        if not tasks:
            return iter(())
        token = None
        if self._health is not None:
            token = self._health.register_run(
                "read", len(tasks), self._watchdog_stall_s,
                self._watchdog_policy)
        if self.workers == 1:
            inner = self._run_sequential(tasks, token)
        else:
            inner = self._run_pipelined(tasks, token)
        if token is None:
            return inner
        return _tracked(inner, self._health, token)

    def _run_sequential(self, tasks: List[ShardTask],
                        token: Optional[int] = None
                        ) -> Iterator[ShardResult]:
        try:
            for task in tasks:
                yield self._run_one_inline(task, token)
        except GeneratorExit:
            raise  # the consumer stopped early: no abort
        except BaseException as e:
            flightrec.note_abort(e, where="inline")
            raise
        finally:
            if self._resilience is not None:
                self._resilience.close()

    def _run_one_inline(self, task: ShardTask,
                        token: Optional[int] = None) -> ShardResult:
        """The whole shard under one retrier: a transient fault anywhere
        re-runs it from fetch."""
        times = [0.0, 0.0]
        health = self._health if token is not None else None
        res = self._resilience
        deadline = res.new_deadline(task.shard_id) if res is not None \
            else None
        if deadline is not None and task.retrier is not None:
            task.retrier.deadline = deadline

        def attempt():
            t0 = time.perf_counter()
            _check_abort(health, token)
            if deadline is not None:
                deadline.check(what=task.what)
            if health is not None:
                health.beat(token, "fetch", task.shard_id)
            with span("executor.fetch", shard=task.shard_id):
                if res is not None:
                    payload = res.fetch(task.fetch, task.shard_id, deadline)
                else:
                    payload = task.fetch()
            t1 = time.perf_counter()
            times[0] += t1 - t0
            _check_abort(health, token)
            if deadline is not None:
                deadline.check(what=task.what)
            if health is not None:
                health.beat(token, "decode", task.shard_id)
            with span("executor.decode", shard=task.shard_id):
                value = task.decode(payload)
            times[1] += time.perf_counter() - t1
            if health is not None:
                health.clear(token, "decode", task.shard_id)
            _check_abort(health, token)
            return value

        try:
            if task.retrier is not None:
                value = task.retrier.call(attempt, what=task.what)
            else:
                value = attempt()
        except DeadlineExceededError:
            if task.deadline_fallback is None:
                raise
            value = task.deadline_fallback()
        return ShardResult(task.shard_id, value, times[0], times[1])

    def _run_pipelined(self, tasks: List[ShardTask],
                       token: Optional[int] = None
                       ) -> Iterator[ShardResult]:
        res = self._resilience
        deadlines: Dict[int, Any] = {}
        if res is not None:
            for t in tasks:
                dl = res.new_deadline(t.shard_id)
                if dl is not None:
                    deadlines[t.shard_id] = dl
                    if t.retrier is not None:
                        t.retrier.deadline = dl

        def fetch_once(task: ShardTask) -> Any:
            if res is not None:
                return res.fetch(task.fetch, task.shard_id,
                                 deadlines.get(task.shard_id))
            return task.fetch()

        def fetch_fn(task: ShardTask, _payload: Any) -> Any:
            with span("executor.fetch", shard=task.shard_id):
                dl = deadlines.get(task.shard_id)
                try:
                    if dl is not None:
                        dl.check(what=task.what)
                    if task.retrier is not None:
                        return task.retrier.call(
                            lambda: fetch_once(task),
                            what=f"{task.what}.fetch")
                    return fetch_once(task)
                except DeadlineExceededError:
                    if task.deadline_fallback is None:
                        raise
                    return _DEADLINE_MISS

        def decode_fn(task: ShardTask, payload: Any) -> Any:
            with span("executor.decode", shard=task.shard_id):
                if payload is _DEADLINE_MISS:
                    return task.deadline_fallback()
                dl = deadlines.get(task.shard_id)
                try:
                    if dl is not None:
                        dl.check(what=task.what)
                    return self._decode_with_refetch(task, payload)
                except DeadlineExceededError:
                    if task.deadline_fallback is None:
                        raise
                    return task.deadline_fallback()

        def on_admit(depth: int) -> None:
            self.stats.max_in_flight = max(self.stats.max_in_flight, depth)
            observe_gauge("executor.in_flight", depth)

        def on_stall(stall: float, task: ShardTask) -> None:
            if stall > _STALL_SPAN_S:
                record_span("executor.emit.stall", stall,
                            shard=task.shard_id)

        core = _BoundedStagePipeline(
            workers=self.workers, window=self.stats.window,
            stage_fns=(fetch_fn, decode_fn),
            thread_prefixes=("disq-torch-fetch", "disq-torch-decode"),
            on_admit=on_admit, on_stall=on_stall,
            stage_names=("fetch", "decode"),
            health=self._health if token is not None else None,
            health_token=token)
        inner = core.run(tasks)

        def adapt() -> Iterator[ShardResult]:
            try:
                for idx, value, secs in inner:
                    yield ShardResult(tasks[idx].shard_id, value, secs[0],
                                      secs[1])
            finally:
                # with the stage pools: no hedge duplicate outlives the run
                if res is not None:
                    res.close()

        return adapt()

    @staticmethod
    def _decode_with_refetch(task: ShardTask, payload: Any) -> Any:
        """Stage B; a transient fault escaping it (a salvage walk's
        re-read) re-runs the shard from fetch under its retrier."""
        try:
            return task.decode(payload)
        except Exception as e:  # noqa: BLE001 — classified below
            if task.retrier is None or not is_transient(e):
                raise
            task.retrier.retried += 1  # the attempt that just failed
            return task.retrier.call(lambda: task.decode(task.fetch()),
                                     what=task.what)


def executor_for_storage(storage) -> ShardPipelineExecutor:
    """The read executor sized by the storage's ``DisqOptions``; it also
    applies the options' HTTP cache size (``http_cache_blocks``) and
    resolves, once per run, the flight recorder, the profiler, the
    introspection board (endpoint, watchdog, progress log) and the
    resilience manager (hedging, deadlines). With none of them set the
    executor gets ``health=None`` and ``resilience=None``."""
    from disq_tpu_torch.runtime import introspect, profiler
    from disq_tpu_torch.runtime.resilience import resilience_for_options

    opts = getattr(storage, "_options", None) or DisqOptions()
    flightrec.configure_from_options(opts)
    profiler.configure_from_options(opts)
    if opts.http_cache_blocks:
        from disq_tpu_torch.fsw.http import configure_cache_blocks

        configure_cache_blocks(opts.http_cache_blocks)
    return ShardPipelineExecutor(
        workers=opts.executor_workers, prefetch_shards=opts.prefetch_shards,
        health=introspect.configure_from_options(opts),
        watchdog_stall_s=opts.watchdog_stall_s,
        watchdog_policy=opts.watchdog_policy,
        resilience=resilience_for_options(opts))


def read_ledger_for_storage(storage, path: str, n_shards: int,
                            resident: bool):
    """The read's ``ReadLedger``, or None when ``DisqOptions.read_ledger``
    is unset. Its fingerprint holds everything that changes what a split
    decodes to: the path, the split count, the error policy, and the
    route actually taken (``resident``: a device-backed split spills as
    host bytes and parses again on its device when loaded), so resuming
    any other read starts afresh. The shard deadline is part of it: an
    over-budget split under skip spills as its empty stand-in."""
    opts = getattr(storage, "_options", None) or DisqOptions()
    if not opts.read_ledger:
        return None
    from disq_tpu_torch.runtime.errors import ErrorPolicy
    from disq_tpu_torch.runtime.manifest import ReadLedger

    return ReadLedger(opts.read_ledger, params={
        "path": path,
        "shards": int(n_shards),
        "error_policy": ErrorPolicy.coerce(opts.error_policy).value,
        "shard_deadline_s": opts.shard_deadline_s,
        "resident_decode": bool(resident),
    })


def map_ordered_resumable(executor: ShardPipelineExecutor,
                          tasks: Sequence[ShardTask],
                          ledger=None) -> Iterator[ShardResult]:
    """``executor.map_ordered`` with read resume: splits the ledger holds
    come from their spills (no fetch, no decode), fresh splits run
    through the executor and are spilled as they emit, and a run read to
    its end reaches the ledger's commit point (``finish``). Without a
    ledger this is ``map_ordered``."""
    tasks = list(tasks)
    if ledger is None:
        return executor.map_ordered(tasks)

    def gen() -> Iterator[ShardResult]:
        cached = {t.shard_id for t in tasks if ledger.is_done(t.shard_id)}
        fresh = executor.map_ordered(
            [t for t in tasks if t.shard_id not in cached])
        for t in tasks:
            if t.shard_id in cached:
                yield ShardResult(t.shard_id, ledger.load(t.shard_id))
            else:
                res = next(fresh)
                ledger.record(res.shard_id, res.value)
                yield res
        ledger.finish()

    return gen()


# -- write direction: encode → deflate → stage -------------------------------


@dataclass
class WriteShardTask:
    """One write shard: ``encode`` slices the batch and encodes records,
    ``deflate`` compresses (None ⇒ pass-through), ``stage`` writes the
    part (None ⇒ the caller consumes the payload at emit). ``retrier``
    guards only ``stage``: the other steps are CPU work. ``byte_range``
    is the part's uncompressed byte range in the merged output, the
    write leases' locality coordinate (None: leased in queue order)."""

    shard_id: int
    encode: Callable[[], Any]
    deflate: Optional[Callable[[Any], Any]] = None
    stage: Optional[Callable[[Any], Any]] = None
    retrier: Optional[ShardRetrier] = None
    what: str = "write"
    byte_range: Optional[Tuple[int, int]] = None


@dataclass
class WriteShardResult:
    """The stage step's return value."""

    shard_id: int
    value: Any


@dataclass
class WriterStats:
    workers: int = 0
    window: int = 0
    shards: int = 0
    max_in_flight: int = 0


class ShardWritePipeline:
    """The write direction: encode → deflate → stage → ordered emit, with
    the read executor's guarantees (task order, identical bytes at any
    ``workers``, inline ``workers=1``, bounded window) and its
    introspection hooks."""

    def __init__(self, workers: int = 1,
                 prefetch_shards: Optional[int] = None, health=None,
                 watchdog_stall_s: Optional[float] = None,
                 watchdog_policy: str = "warn") -> None:
        self.workers = max(1, int(workers))
        if prefetch_shards is None:
            prefetch_shards = 2 * self.workers
        self.prefetch_shards = max(1, int(prefetch_shards))
        self.stats = WriterStats(workers=self.workers,
                                 window=self.prefetch_shards)
        self._health = health
        self._watchdog_stall_s = watchdog_stall_s
        self._watchdog_policy = watchdog_policy

    def map_ordered(self, tasks: Sequence[WriteShardTask]
                    ) -> Iterator[WriteShardResult]:
        tasks = list(tasks)
        self.stats.shards += len(tasks)
        if not tasks:
            return iter(())
        token = None
        if self._health is not None:
            token = self._health.register_run(
                "write", len(tasks), self._watchdog_stall_s,
                self._watchdog_policy)
        if self.workers == 1:
            inner = self._run_sequential(tasks, token)
        else:
            inner = self._run_pipelined(tasks, token)
        if token is None:
            return inner
        return _tracked(inner, self._health, token)

    @staticmethod
    def _encode(task: WriteShardTask, _payload: Any) -> Any:
        return task.encode()

    @staticmethod
    def _deflate(task: WriteShardTask, payload: Any) -> Any:
        return payload if task.deflate is None else task.deflate(payload)

    @staticmethod
    def _stage(task: WriteShardTask, payload: Any) -> Any:
        if task.stage is None:
            return payload
        if task.retrier is not None:
            return task.retrier.call(lambda: task.stage(payload),
                                     what=f"{task.what}.stage")
        return task.stage(payload)

    # (step, also the name of its task attribute; thread prefix)
    _STEPS = (("encode", "disq-torch-encode"), ("deflate", "disq-torch-deflate"),
              ("stage", "disq-torch-stage"))

    def _run_sequential(self, tasks: List[WriteShardTask],
                        token: Optional[int] = None
                        ) -> Iterator[WriteShardResult]:
        health = self._health if token is not None else None
        try:
            for task in tasks:
                payload = None
                for step, _p in self._STEPS:
                    _check_abort(health, token)
                    if health is not None:
                        health.beat(token, step, task.shard_id)
                    payload = getattr(self, f"_{step}")(task, payload)
                    if health is not None:
                        health.clear(token, step, task.shard_id)
                yield WriteShardResult(task.shard_id, payload)
        except GeneratorExit:
            raise  # the consumer stopped early: no abort
        except BaseException as e:
            flightrec.note_abort(e, where="inline")
            raise

    def _run_pipelined(self, tasks: List[WriteShardTask],
                       token: Optional[int] = None
                       ) -> Iterator[WriteShardResult]:
        # a step that is None on every task gets no pool of its own
        used = [(step, prefix) for step, prefix in self._STEPS
                if step == "encode"
                or any(getattr(t, step) is not None for t in tasks)]
        steps = [step for step, _p in used]

        def on_admit(depth: int) -> None:
            self.stats.max_in_flight = max(self.stats.max_in_flight, depth)
            observe_gauge("writer.in_flight", depth)

        def on_stall(stall: float, task: WriteShardTask) -> None:
            if stall > _STALL_SPAN_S:
                record_span("writer.emit.stall", stall, shard=task.shard_id)

        core = _BoundedStagePipeline(
            workers=self.workers, window=self.stats.window,
            stage_fns=[getattr(self, f"_{step}") for step in steps],
            thread_prefixes=[prefix for _s, prefix in used],
            on_admit=on_admit, on_stall=on_stall, drain_on_close=True,
            stage_names=steps,
            health=self._health if token is not None else None,
            health_token=token)
        for idx, value, _secs in core.run(tasks):
            yield WriteShardResult(tasks[idx].shard_id, value)


def writer_for_storage(storage) -> ShardWritePipeline:
    """The write pipeline sized by the storage's ``DisqOptions``, with
    the flight recorder, the profiler and the introspection board
    resolved once per run as for a read."""
    from disq_tpu_torch.runtime import introspect, profiler

    opts = getattr(storage, "_options", None) or DisqOptions()
    flightrec.configure_from_options(opts)
    profiler.configure_from_options(opts)
    return ShardWritePipeline(
        workers=opts.writer_workers,
        prefetch_shards=opts.writer_prefetch_shards,
        health=introspect.configure_from_options(opts),
        watchdog_stall_s=opts.watchdog_stall_s,
        watchdog_policy=opts.watchdog_policy)


def write_retrier_for_storage(storage, path: Optional[str] = None
                              ) -> ShardRetrier:
    """A fresh per-shard retrier from the storage's retry knobs (writes
    have no corrupt-block policy, only transient retry). With ``path``
    and ``breaker_window`` set, the circuit breaker of the output's
    filesystem gates it; its retries draw from the retry budget."""
    opts = getattr(storage, "_options", None) or DisqOptions()
    breaker = None
    if opts.retry_budget_tokens is not None or \
            opts.breaker_window is not None:
        from disq_tpu_torch.runtime.resilience import (
            breaker_for,
            configure_globals_from_options,
        )

        configure_globals_from_options(opts)
        if path is not None:
            breaker = breaker_for(path)
    return ShardRetrier(opts.max_retries, opts.retry_backoff_s,
                        breaker=breaker)


def _checkpointed(task: WriteShardTask, manifest, stage_name: str
                  ) -> WriteShardTask:
    """``task`` with each step under ``retry_shard`` and its stage result
    recorded in ``manifest`` as it lands."""
    k = task.shard_id

    def retried(fn):
        return None if fn is None else retry_shard(fn, stage_name, k)

    stage = retried(task.stage)

    def marked(payload):
        info = payload if stage is None else stage(payload)
        manifest.mark_done(stage_name, k, info)
        return info

    return replace(task, encode=retried(task.encode),
                   deflate=retried(task.deflate), stage=marked)


def run_write_stage(pipeline: ShardWritePipeline, n_shards: int,
                    make_task: Callable[[int], WriteShardTask],
                    manifest=None, stage_name: str = "write.parts",
                    storage=None, path: Optional[str] = None, fs=None
                    ) -> List[Any]:
    """Run one write stage's shards through ``pipeline``; returns each
    shard's stage result in shard order. With a ``StageManifest``,
    recorded shards are skipped (their recorded info is returned), each
    step of a fresh shard runs under ``manifest.retry_shard`` (a shard
    that still fails raises ``RuntimeError`` naming it), and each fresh
    shard is recorded when its stage step lands, on the stage worker, in
    completion order: a crash while a straggler holds up the ordered
    emit keeps every shard already staged.

    With ``storage`` and ``path`` and a manifest, and the shard scheduler
    armed on the storage, the shards are leased from the coordinator
    instead (``scheduler.scheduled_write_stage``, the manifest as the
    durable side; ``fs``, the output's filesystem, gives the locality
    hint). Otherwise nothing more is built."""
    if manifest is not None and storage is not None and path is not None:
        from disq_tpu_torch.runtime import scheduler

        if scheduler.write_leasing_armed(storage):
            return scheduler.scheduled_write_stage(
                storage, path, pipeline, n_shards, make_task, manifest,
                stage_name=stage_name, fs=fs)
    infos: List[Any] = [None] * n_shards
    pending: List[int] = []
    for k in range(n_shards):
        if manifest is not None and manifest.is_done(stage_name, k):
            infos[k] = manifest.shard_info(stage_name, k)
        else:
            pending.append(k)
    tasks = []
    for k in pending:
        task = make_task(k)
        if manifest is not None:
            task = _checkpointed(task, manifest, stage_name)
        tasks.append(task)
    for res in pipeline.map_ordered(tasks):
        infos[res.shard_id] = res.value
    return infos
