"""In-process sampling profiler: where the host CPU goes.

Counterpart of ``disq_tpu/runtime/profiler.py``. Spans time the phases
someone thought to instrument; this answers which Python or C frames a
stage burns. A :class:`SamplingProfiler` thread walks
``sys._current_frames()`` at ``hz`` and folds the stacks **by thread
role**: every thread the port starts has a canonical name, and
``THREAD_ROLES`` maps each name to the reference's role (``fetch``,
``decode``, ``encode``, ``deflate``, ``stage``, ``dispatcher``,
``hedge``, ``hostwork``, ``prefetch``, ...), so a sample is booked per
pipeline stage with no instrumentation in the sampled code. The port's
pools are named ``disq-torch-<stage>``; the table maps those names too,
so no pipeline sample lands under ``other``.

Exports: ``collapsed()`` (``role;frame;frame count`` lines, for
``flamegraph.pl``, speedscope or ``scripts/trace_report.py --flame``)
and ``speedscope()`` (one sampled profile per role).

Books ``profile.samples{thread_role=}`` per sample and
``profile.dropped`` per tick skipped because a walk overran its
interval (the profile gets sparser; the sampled threads never wait).

Two lifecycles: **continuous** (``DisqOptions.profile_hz`` /
``DISQ_TPU_TORCH_PROFILE_HZ`` → :func:`start_profiler`, embedded in a
postmortem bundle), and **windowed** (:func:`profile_for`, behind the
introspection endpoint's ``/debug/profile?seconds=N``). Off by default:
no thread, no sample.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from disq_tpu_torch.runtime.tracing import REGISTRY

DEFAULT_HZ = 99.0   # off the metronome: a round 100 Hz beats against
                    # periodic work and aliases it in or out entirely
MAX_STACK_DEPTH = 64

# Canonical thread-name prefix -> role. First match wins. The port's
# pipeline pools carry ``disq-torch-<stage>`` names and map to the
# reference's roles; every other thread the port starts carries the
# reference's own name. A thread the table does not know is ``other``.
THREAD_ROLES: Tuple[Tuple[str, str], ...] = (
    ("disq-torch-fetch", "fetch"),
    ("disq-torch-decode", "decode"),
    ("disq-torch-encode", "encode"),
    ("disq-torch-deflate", "deflate"),
    ("disq-torch-stage", "stage"),
    ("disq-torch-hostwork", "hostwork"),
    ("disq-fetch", "fetch"),
    ("disq-decode", "decode"),
    ("disq-encode", "encode"),
    ("disq-deflate", "deflate"),
    ("disq-stage", "stage"),
    ("disq-device-dispatch", "dispatcher"),
    ("disq-hedge", "hedge"),
    ("disq-hostwork", "hostwork"),
    ("disq-http-prefetch", "prefetch"),
    ("disq-watchdog", "watchdog"),
    ("disq-introspect", "introspect"),
    ("disq-cluster", "cluster"),
    ("disq-slo", "slo"),
    ("disq-bench-http", "bench_http"),
    ("disq-profiler", "profiler"),
    ("MainThread", "main"),
)


def role_of(thread_name: str) -> str:
    for prefix, role in THREAD_ROLES:
        if thread_name.startswith(prefix):
            return role
    return "other"


class SamplingProfiler:
    """One sampling session: ``start()`` spawns the ``disq-profiler``
    thread, ``stop()`` joins it; the aggregate is then readable via
    ``collapsed()`` / ``speedscope()`` / ``by_role()``."""

    def __init__(self, hz: float = DEFAULT_HZ,
                 max_depth: int = MAX_STACK_DEPTH,
                 book_metrics: bool = True) -> None:
        if hz <= 0:
            raise ValueError(f"profile hz must be > 0, got {hz}")
        self.hz = float(hz)
        self.max_depth = int(max_depth)
        # ``profile.samples`` / ``profile.dropped`` are process-wide:
        # a windowed profile racing the continuous one books with
        # book_metrics=False so the shared counters never double-count
        # one process's CPU (profile_for resolves this automatically).
        self.book_metrics = bool(book_metrics)
        self._lock = threading.Lock()
        # (role, (frame, frame, ...)) -> sample count, root-first
        self._counts: Dict[Tuple[str, Tuple[str, ...]], int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples = 0
        self.dropped = 0
        self.started_at: Optional[float] = None
        self.stopped_at: Optional[float] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            return self
        self.started_at = time.perf_counter()
        self._thread = threading.Thread(
            target=self._run, name="disq-profiler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> "SamplingProfiler":
        thread = self._thread
        if thread is None:
            return self
        self._stop.set()
        thread.join(timeout=10)
        self._thread = None
        self.stopped_at = time.perf_counter()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- sampling loop ------------------------------------------------------

    def _run(self) -> None:
        interval = 1.0 / self.hz
        next_tick = time.perf_counter()
        dropped_counter = REGISTRY.counter("profile.dropped")
        samples_counter = (REGISTRY.counter("profile.samples")
                           if self.book_metrics else None)
        while not self._stop.is_set():
            self._sample_once(samples_counter)
            next_tick += interval
            now = time.perf_counter()
            if now > next_tick:
                # Overran: skip the missed ticks (count them) instead
                # of bursting to catch up — a catch-up burst would
                # oversample exactly the moments the walk is slowest.
                missed = int((now - next_tick) / interval) + 1
                self.dropped += missed
                if self.book_metrics:
                    dropped_counter.inc(missed)
                next_tick = now + interval
                continue
            self._stop.wait(next_tick - now)

    def _sample_once(self, samples_counter=None) -> None:
        # Thread names re-resolve every tick — pools come and go
        # mid-run.
        names = {t.ident: t.name for t in threading.enumerate()}
        own = threading.get_ident()
        # _current_frames is one atomic C call: the dict is a snapshot,
        # the frames themselves keep mutating — fine for sampling.
        for tid, frame in sys._current_frames().items():
            if tid == own:
                continue
            role = role_of(names.get(tid, "?"))
            stack: List[str] = []
            f = frame
            while f is not None and len(stack) < self.max_depth:
                code = f.f_code
                stack.append(
                    f"{os.path.basename(code.co_filename)}:{code.co_name}")
                f = f.f_back
            stack.reverse()  # root-first, the collapsed-stack order
            key = (role, tuple(stack))
            with self._lock:
                self._counts[key] = self._counts.get(key, 0) + 1
                self.samples += 1
            if samples_counter is not None:
                samples_counter.inc(thread_role=role)

    # -- views --------------------------------------------------------------

    def folded(self) -> Dict[str, int]:
        """``{"role;frame;frame": count}`` — role is the root frame so
        one folded set attributes per pipeline stage."""
        with self._lock:
            return {
                ";".join((role,) + stack): n
                for (role, stack), n in sorted(self._counts.items())
            }

    def collapsed(self) -> str:
        """Collapsed-stack text, one ``stack count`` line per folded
        stack (flamegraph.pl / speedscope / ``--flame`` input)."""
        return "".join(
            f"{stack} {n}\n" for stack, n in self.folded().items())

    def by_role(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for (role, _stack), n in self._counts.items():
                out[role] = out.get(role, 0) + n
            return out

    def speedscope(self) -> Dict[str, Any]:
        """A speedscope file document: one ``sampled`` profile per
        thread role, frames shared across them."""
        frame_index: Dict[str, int] = {}
        frames: List[Dict[str, str]] = []

        def idx(name: str) -> int:
            i = frame_index.get(name)
            if i is None:
                i = frame_index[name] = len(frames)
                frames.append({"name": name})
            return i

        with self._lock:
            items = sorted(self._counts.items())
        per_role: Dict[str, Tuple[List[List[int]], List[int]]] = {}
        for (role, stack), n in items:
            samples, weights = per_role.setdefault(role, ([], []))
            samples.append([idx(f) for f in stack])
            weights.append(n)
        profiles = []
        for role in sorted(per_role):
            samples, weights = per_role[role]
            profiles.append({
                "type": "sampled",
                "name": role,
                "unit": "none",
                "startValue": 0,
                "endValue": sum(weights),
                "samples": samples,
                "weights": weights,
            })
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "shared": {"frames": frames},
            "profiles": profiles,
            "exporter": "disq_tpu_torch.runtime.profiler",
        }


# ---------------------------------------------------------------------------
# Process-wide continuous profiler + windowed helper
# ---------------------------------------------------------------------------

_LOCK = threading.RLock()
_ACTIVE: Optional[SamplingProfiler] = None
_env_resolved = False


def start_profiler(hz: float = DEFAULT_HZ) -> SamplingProfiler:
    """Start (or return) the process-wide continuous profiler."""
    global _ACTIVE
    with _LOCK:
        if _ACTIVE is None or not _ACTIVE.running:
            _ACTIVE = SamplingProfiler(hz).start()
        return _ACTIVE


def stop_profiler() -> Optional[SamplingProfiler]:
    """Stop the continuous profiler and return it (with its aggregate
    intact); None if nothing was running."""
    global _ACTIVE
    with _LOCK:
        active, _ACTIVE = _ACTIVE, None
    if active is not None:
        active.stop()
    return active


def active_profiler() -> Optional[SamplingProfiler]:
    return _ACTIVE


def profile_for(seconds: float, hz: float = DEFAULT_HZ
                ) -> SamplingProfiler:
    """Run an independent profiler for ``seconds`` (blocking) and
    return it — the ``/debug/profile?seconds=N`` implementation.
    When the continuous profiler is already booking the process-wide
    ``profile.*`` counters, the windowed one samples without booking
    so concurrent profiles never double-count one process's CPU."""
    active = _ACTIVE
    prof = SamplingProfiler(
        hz, book_metrics=active is None or not active.running).start()
    time.sleep(max(0.05, float(seconds)))
    return prof.stop()


def _resolve_env() -> None:
    global _env_resolved
    if _env_resolved:
        return
    with _LOCK:
        if _env_resolved:
            return
        _env_resolved = True
        raw = os.environ.get("DISQ_TPU_TORCH_PROFILE_HZ")
    if raw:
        try:
            hz = float(raw)
        except ValueError:
            return
        if hz > 0:
            start_profiler(hz)


def configure_from_options(opts) -> None:
    """Resolve one ``DisqOptions``' ``profile_hz`` knob (and the env
    knob, once).  Default path: nothing happens, no thread exists."""
    _resolve_env()
    hz = getattr(opts, "profile_hz", None) if opts is not None else None
    if hz:
        start_profiler(float(hz))


def reset_profiler() -> None:
    """Test hook: stop the continuous profiler and re-allow env
    resolution."""
    global _env_resolved
    stop_profiler()
    with _LOCK:
        _env_resolved = False
