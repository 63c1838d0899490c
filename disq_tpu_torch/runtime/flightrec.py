"""Flight recorder: postmortem bundles for runs that die.

Counterpart of ``disq_tpu/runtime/flightrec.py``. ``runtime/tracing.py``
says what a run cost and ``runtime/introspect.py`` whether it is making
progress; both live in the process, so when a run aborts (a pipeline's
first-error abort, a ``WatchdogStallError``, a breaker storm, a crash in
``native/`` or a CUDA kernel's host wrapper) they vanish with it. This
module keeps the postmortem:

- **Event ring** (:class:`FlightRecorder`): a bounded ring of recent
  *decisions*: retries, hedge launches, deadline expiries, breaker
  transitions, watchdog stalls, device-service flushes, quarantines,
  aborts. The hooks are one-line ``record_event(kind, ...)`` calls in
  ``errors.py``, ``resilience.py``, ``executor.py``, ``introspect.py``
  and ``device_service.py``.
- **Postmortem bundles**: on any abort path (or an explicit
  :func:`dump`) a directory is written under
  ``DisqOptions.postmortem_dir`` / ``DISQ_TPU_TORCH_POSTMORTEM_DIR``:
  every thread's stack, the Prometheus metrics, the span-ring tail, the
  event ring, ``/healthz`` and ``/progress``, the tails of every
  quarantine, stage-manifest and read-ledger file the run touched, and
  the resolved options, environment and ``RUN_ID``.
  ``scripts/trace_report.py --postmortem <bundle>`` renders it. At most
  ``MAX_BUNDLES`` per process.
- **Native crashes**: enabling the recorder points ``faulthandler`` at
  ``crash-<pid>.log`` in the postmortem directory.

Disabled (the default), no recorder exists, and ``record_event`` /
``note_artifact`` / ``note_abort`` return after one global-is-None test.
"""

from __future__ import annotations

import faulthandler
import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from disq_tpu_torch.runtime.tracing import REGISTRY, RUN_ID, current_trace

DEFAULT_RING = 4096       # events kept; overflow drops the oldest
LEDGER_TAIL_BYTES = 65536  # per noted ledger file in a bundle
SPAN_TAIL = 2048          # span-ring tail lines in a bundle
MAX_BUNDLES = 16          # per-process cap: an abort storm must not
                          # fill the disk with identical bundles

_LOCK = threading.RLock()
_RECORDER: Optional["FlightRecorder"] = None
_env_resolved = False


def thread_stacks_text() -> str:
    """Every live thread's current Python stack, named — the same text
    the ``/debug/stacks`` endpoint serves and every bundle embeds.
    Thread names matter here: the pipelines name their workers
    ``disq-<stage>``, so a hung stack is stage-attributed at sight."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: List[str] = [
        f"pid {os.getpid()} run {RUN_ID} "
        f"threads {len(names)} at {time.time():.3f}",
        "",
    ]
    for tid, frame in sorted(sys._current_frames().items()):
        out.append(f"--- thread {names.get(tid, '?')} (ident {tid}) ---")
        out.extend(
            line.rstrip("\n")
            for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


class FlightRecorder:
    """Bounded event ring + bundle writer (see module docstring).

    Mutators are dict/deque appends under one lock; the ring holds
    plain dicts so a dump is a JSON walk, never a pickle."""

    def __init__(self, postmortem_dir: str,
                 capacity: int = DEFAULT_RING) -> None:
        self.postmortem_dir = postmortem_dir
        self._lock = threading.Lock()
        self._ring: "deque[Dict[str, Any]]" = deque(
            maxlen=max(16, int(capacity)))
        # path -> short name: ledger files whose tails belong in a
        # bundle (quarantine manifest, stage manifest, read ledger).
        self._artifacts: Dict[str, str] = {}
        self._options: Dict[str, Any] = {}
        self._bundles: List[str] = []
        # Aborts dedupe by exception identity: the same error object
        # can surface from both a stage worker, the emit frontier and
        # the api-level backstop.  Strong references compared by
        # identity (BaseException has no __weakref__, so a WeakSet is
        # not an option; bare id()s would falsely match a recycled
        # address).  maxlen stays SMALL: dedupe only needs to span one
        # abort's double-fire window, and every held exception pins
        # its traceback (frames whose locals hold shard buffers).
        self._aborted: "deque[BaseException]" = deque(maxlen=8)
        self._crash_log = None

    # -- feeding ------------------------------------------------------------

    def record(self, kind: str, /, **fields: Any) -> None:
        # ``kind`` is positional-only so hooks can carry a ``kind=``
        # *field* (e.g. the corrupt-block kind) without colliding.
        rec = {"ts": round(time.time(), 6),
               "mono": round(time.perf_counter(), 6),
               "kind": kind}
        rec.update(fields)
        rec["kind"] = kind  # the event kind always wins the key
        ctx = current_trace()
        if ctx is not None:
            # request-scoped causality: events recorded under an active
            # trace context join that request's stitched timeline
            rec.setdefault("trace", ctx.trace_id)
            rec.setdefault("tenant", ctx.tenant)
        with self._lock:
            self._ring.append(rec)
        REGISTRY.counter("flightrec.events").inc(kind=kind)

    def note_artifact(self, name: str, path: str) -> None:
        with self._lock:
            self._artifacts.setdefault(path, name)

    def set_options(self, opts: Any) -> None:
        """Remember the resolved options of the most recent run that
        configured this recorder (dumped into ``options.json``)."""
        import dataclasses

        try:
            doc = dataclasses.asdict(opts)
        except TypeError:
            doc = {"repr": repr(opts)}
        with self._lock:
            self._options = doc

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    # -- abort / dump -------------------------------------------------------

    def abort(self, exc: BaseException, where: str = "") -> Optional[str]:
        """The abort chokepoint: record one ``abort`` event and write a
        bundle (once per distinct exception object)."""
        with self._lock:
            if any(seen is exc for seen in self._aborted):
                return None
            self._aborted.append(exc)
        reason = _abort_reason(exc)
        self.record(
            "abort", reason=reason, where=where,
            error=f"{type(exc).__name__}: {exc}",
            shard=getattr(exc, "shard_id", None),
            stage=getattr(exc, "stage", None))
        return self.dump(reason, exc=exc)

    def dump(self, reason: str = "explicit",
             exc: Optional[BaseException] = None) -> Optional[str]:
        """Write one bundle directory and return its path (None once
        the per-process bundle cap is reached).  Every artifact write
        is individually best-effort: a failing subsystem (a torn
        ledger, a dead health board) must never cost the bundle the
        artifacts that *did* survive."""
        with self._lock:
            if len(self._bundles) >= MAX_BUNDLES:
                return None
            seq = len(self._bundles)
            bundle = os.path.join(
                self.postmortem_dir, f"bundle-{RUN_ID}-{seq:02d}")
            self._bundles.append(bundle)
        try:
            os.makedirs(bundle, exist_ok=True)
        except OSError:
            # An unwritable/full postmortem dir must never mask the
            # abort that brought us here — the dump is best-effort
            # end to end, not just per artifact.
            return None
        artifacts: List[str] = []

        def put(name: str, render) -> None:
            try:
                body = render()
                if body is None:
                    return
                if isinstance(body, str):
                    body = body.encode()
                with open(os.path.join(bundle, name), "wb") as f:
                    f.write(body)
                artifacts.append(name)
            except Exception:  # noqa: BLE001 — best-effort per artifact
                pass

        put("stacks.txt", thread_stacks_text)
        put("metrics.prom", self._render_metrics)
        put("spans.jsonl", self._render_spans)
        put("events.jsonl", self._render_events)
        put("healthz.json", lambda: self._render_introspect("healthz"))
        put("progress.json", lambda: self._render_introspect("progress"))
        put("options.json", lambda: self._render_options(reason, exc))
        put("profile.collapsed", self._render_profile)
        with self._lock:
            ledgers = dict(self._artifacts)
        for i, (path, name) in enumerate(sorted(ledgers.items())):
            put(f"ledger-{name}-{i:02d}.tail",
                lambda p=path: _file_tail(p))
        put("MANIFEST.json", lambda: json.dumps({
            "run_id": RUN_ID, "pid": os.getpid(), "reason": reason,
            "epoch": round(time.time(), 6),
            "error": (f"{type(exc).__name__}: {exc}"
                      if exc is not None else None),
            "artifacts": sorted(artifacts),
            "ledgers": {name: path for path, name in ledgers.items()},
        }, indent=2, default=str))
        REGISTRY.counter("flightrec.dumps").inc(reason=reason)
        return bundle

    # -- bundle artifact renderers ------------------------------------------

    @staticmethod
    def _render_metrics() -> str:
        from disq_tpu_torch.runtime import tracing

        return tracing.metrics_text()

    @staticmethod
    def _render_spans() -> str:
        from disq_tpu_torch.runtime import tracing

        ring = tracing.spans()[-SPAN_TAIL:]
        return "".join(
            json.dumps(s, default=str) + "\n" for s in ring)

    def _render_events(self) -> str:
        return "".join(
            json.dumps(e, default=str) + "\n" for e in self.events())

    @staticmethod
    def _render_introspect(view: str) -> str:
        from disq_tpu_torch.runtime.introspect import HEALTH

        doc = getattr(HEALTH, view)()
        return json.dumps(doc, default=str)

    def _render_options(self, reason: str,
                        exc: Optional[BaseException]) -> str:
        with self._lock:
            opts = dict(self._options)
        return json.dumps({
            "run_id": RUN_ID,
            "pid": os.getpid(),
            "reason": reason,
            "error": (f"{type(exc).__name__}: {exc}"
                      if exc is not None else None),
            "options": opts,
            "env": {k: v for k, v in sorted(os.environ.items())
                    if k.startswith(("DISQ_TPU_TORCH_", "CUDA_VISIBLE_DEVICES"))},
        }, indent=2, default=str)

    @staticmethod
    def _render_profile() -> Optional[str]:
        from disq_tpu_torch.runtime import profiler

        active = profiler.active_profiler()
        if active is None or not active.samples:
            return None
        return active.collapsed()

    # -- native-crash wiring -------------------------------------------------

    def wire_faulthandler(self) -> None:
        """Point ``faulthandler`` at a crash log inside the postmortem
        dir so a native segfault (``disq_tpu_torch/native``) leaves Python
        tracebacks next to the bundles instead of dying silently."""
        if self._crash_log is not None:
            return
        try:
            os.makedirs(self.postmortem_dir, exist_ok=True)
            self._crash_log = open(
                os.path.join(self.postmortem_dir,
                             f"crash-{os.getpid()}.log"), "a")
            faulthandler.enable(file=self._crash_log)
        except OSError:
            # An unwritable postmortem dir must not fail the run that
            # merely configured it; the event ring still works.
            self._crash_log = None


def _abort_reason(exc: BaseException) -> str:
    # Local name check instead of an import: errors.py imports this
    # module, so classifying by type identity would be a cycle.
    name = type(exc).__name__
    if name == "WatchdogStallError":
        return "watchdog_abort"
    if name == "BreakerOpenError":
        return "breaker_open"
    if name == "DeadlineExceededError":
        return "deadline"
    return "pipeline_abort"


def _file_tail(path: str, nbytes: int = LEDGER_TAIL_BYTES) -> bytes:
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(max(0, size - nbytes))
        return f.read()


# ---------------------------------------------------------------------------
# Module-level hooks — the only surface the hot paths touch
# ---------------------------------------------------------------------------


def enable(postmortem_dir: str,
           capacity: int = DEFAULT_RING) -> FlightRecorder:
    """Turn the flight recorder on (idempotent for an unchanged dir);
    also wires ``faulthandler`` into the dir for native crashes.  A
    dir change re-points the recorder, carrying the live event ring /
    artifacts along and closing the old crash log (no fd leak, no
    silently emptied ``events.jsonl`` right after the switch)."""
    global _RECORDER
    with _LOCK:
        if _RECORDER is None:
            _RECORDER = FlightRecorder(postmortem_dir, capacity)
        elif _RECORDER.postmortem_dir != postmortem_dir:
            old = _RECORDER
            fresh = FlightRecorder(postmortem_dir, capacity)
            with old._lock:
                fresh._ring.extend(old._ring)
                fresh._artifacts.update(old._artifacts)
                fresh._options = dict(old._options)
                if old._crash_log is not None:
                    faulthandler.disable()
                    old._crash_log.close()
                    old._crash_log = None
            _RECORDER = fresh
        _RECORDER.wire_faulthandler()
        return _RECORDER


def enabled() -> bool:
    return _RECORDER is not None


def recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def record_event(kind: str, /, **fields: Any) -> None:
    """The one-line hook every subsystem calls: free (one global read)
    when the recorder is off."""
    rec = _RECORDER
    if rec is None:
        return
    rec.record(kind, **fields)


def note_artifact(name: str, path: str) -> None:
    rec = _RECORDER
    if rec is None:
        return
    rec.note_artifact(name, path)


def note_abort(exc: BaseException, where: str = "") -> None:
    """Abort-path hook (pipeline first-error-abort, inline stage
    raise): records the abort and writes a bundle when enabled.  Never
    raises — a failing dump on the abort path would mask ``exc``, the
    very error the caller is about to surface."""
    rec = _RECORDER
    if rec is None:
        return
    try:
        rec.abort(exc, where=where)
    except Exception:  # noqa: BLE001 — postmortem is best-effort
        pass


def dump(reason: str = "explicit",
         exc: Optional[BaseException] = None) -> Optional[str]:
    """Explicitly write a bundle now; None when disabled."""
    rec = _RECORDER
    if rec is None:
        return None
    return rec.dump(reason, exc=exc)


def _resolve_env() -> None:
    global _env_resolved
    if _env_resolved:
        return
    with _LOCK:
        if _env_resolved:
            return
        _env_resolved = True
        path = os.environ.get("DISQ_TPU_TORCH_POSTMORTEM_DIR")
    if path:
        enable(path)


def configure_from_options(opts) -> None:
    """Resolve one ``DisqOptions``' postmortem knob (and the env knob,
    once).  The default path — no knob, no env — changes nothing and
    allocates nothing."""
    _resolve_env()
    d = getattr(opts, "postmortem_dir", None) if opts is not None else None
    if d:
        enable(d).set_options(opts)
    elif _RECORDER is not None and opts is not None:
        _RECORDER.set_options(opts)


def reset_flightrec() -> None:
    """Test hook: drop the recorder and re-allow env resolution
    (``faulthandler`` is disabled again so a later test owns it)."""
    global _RECORDER, _env_resolved
    with _LOCK:
        if _RECORDER is not None and _RECORDER._crash_log is not None:
            faulthandler.disable()
            _RECORDER._crash_log.close()
        _RECORDER = None
        _env_resolved = False
