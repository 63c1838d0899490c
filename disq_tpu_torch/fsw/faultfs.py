"""Deterministic fault injection at the file layer.

Counterpart of ``disq_tpu/fsw/faultfs.py``, with the same schedule
semantics, so both packages replay the same seeded fault sequence.
``FaultInjectingFileSystemWrapper`` wraps any ``FileSystemWrapper`` and
injects seeded, reproducible faults, so the error policy runtime
(``runtime/errors.py``) can be driven end to end: "fault on shard 3's
second block" is an addressable, repeatable event.

Fault kinds (``FaultSpec.kind``):

- ``"transient"`` — raise ``TransientIOError`` before the read; a retry
  re-executes the read, which may fault again independently.
- ``"stall"`` — sleep ``stall_s`` before serving (the read succeeds).
- ``"slow"`` — sleep a seeded latency drawn from ``[0, slow_s)``.
- ``"truncate"`` — serve the read but drop its last ``truncate_bytes``
  bytes (a connection cut mid-body).
- ``"bitflip"`` — flip bit ``bit`` of the byte at absolute offset
  ``offset`` in any read covering it: at-rest corruption, not transient.

Targeting: by path substring, a seeded Bernoulli ``probability``, a
``call_index`` (the Nth matching call) and an ``offset``; ``times``
bounds the fires (-1 = unlimited). ``op`` picks the direction:
``"read"`` fires on ``read_range``; ``"write"`` on ``write_all``,
``create`` and ``concat`` (``truncate`` and ``bitflip`` mutate the bytes
before ``write_all`` commits them). Every read, ``open()`` streams
included, goes through ``read_range``, one injection point; the
``injected`` log records every fired fault.

Registered under a scheme (``register_filesystem("fault", fsw)``),
paths like ``fault:///data/x.bam`` are served by stripping the scheme
and delegating to ``inner``.
"""

from __future__ import annotations

import io
import random
import threading
import time
from dataclasses import dataclass
from typing import BinaryIO, List, Optional, Sequence, Tuple

from disq_tpu_torch.fsw.filesystem import FileSystemWrapper
from disq_tpu_torch.runtime.errors import TransientIOError


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault. Matching is AND across the set criteria."""

    kind: str                       # transient|stall|slow|truncate|bitflip
    path_substr: str = ""           # match paths containing this
    probability: float = 0.0        # Bernoulli per matching call (seeded)
    call_index: Optional[int] = None  # fire on the Nth matching call (0-based)
    offset: Optional[int] = None    # fire when the read covers this byte
    times: int = -1                 # max fires; -1 = unlimited
    stall_s: float = 0.0            # kind="stall"
    slow_s: float = 0.0             # kind="slow": max seeded latency
    truncate_bytes: int = 1         # kind="truncate": bytes dropped from tail
    bit: int = 0                    # kind="bitflip": bit index 0..7
    op: str = "read"                # direction: "read" | "write"

    def __post_init__(self) -> None:
        if self.kind not in ("transient", "stall", "slow", "truncate",
                             "bitflip"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.op not in ("read", "write"):
            raise ValueError(f"unknown fault op {self.op!r}")
        if self.kind == "bitflip" and self.offset is None:
            raise ValueError("bitflip faults need an absolute byte offset")


@dataclass
class _Injection:
    """Log entry for one fired fault."""

    kind: str
    op: str
    path: str
    start: int
    length: int
    call: int


class FaultInjectingFileSystemWrapper(FileSystemWrapper):
    """Wraps ``inner``, injecting the ``faults`` schedule into reads.

    When registered under a scheme (``register_filesystem("fault",
    fsw)``), paths like ``fault:///data/x.bam`` are served by stripping
    the scheme and delegating to ``inner`` — so the *public* read entry
    points can be driven end-to-end through injected faults.
    """

    def __init__(
        self,
        inner: FileSystemWrapper,
        faults: Sequence[FaultSpec] = (),
        seed: int = 0,
        scheme: str = "fault",
    ) -> None:
        self.inner = inner
        self.faults = list(faults)
        self.scheme = scheme
        self._rng = random.Random(seed)
        # The parallel shard executor drives reads from worker threads:
        # the schedule's bookkeeping (call counter, per-spec matched /
        # fired counts, RNG draws) must stay consistent — racing
        # threads must not double-consume one call_index or skip a draw.
        # The inner read itself runs unlocked, so injected stalls and
        # real I/O still overlap.
        self._mutex = threading.Lock()
        self._pending_stall = 0.0            # booked under the mutex,
        self._calls = 0                      # slept outside it
        self._fired: List[int] = [0] * len(self.faults)
        self._matched: List[int] = [0] * len(self.faults)
        self.injected: List[_Injection] = []
        self._sleep = time.sleep

    # -- plumbing ----------------------------------------------------------

    def _strip(self, path: str) -> str:
        prefix = self.scheme + "://"
        return path[len(prefix):] if path.startswith(prefix) else path

    def _spec_matches(
        self, i: int, spec: FaultSpec, path: str, start: int, length: int,
        op: str = "read_range",
    ) -> bool:
        if spec.op != ("read" if op == "read_range" else "write"):
            return False
        if spec.path_substr and spec.path_substr not in path:
            return False
        if spec.offset is not None and not (
            start <= spec.offset < start + length
        ):
            return False
        if spec.times >= 0 and self._fired[i] >= spec.times:
            return False
        # Positional / probabilistic gates consume the per-spec match
        # counter and the seeded RNG — deterministic per (seed, call seq).
        idx = self._matched[i]
        self._matched[i] += 1
        if spec.call_index is not None and idx != spec.call_index:
            return False
        if spec.probability > 0.0 and self._rng.random() >= spec.probability:
            return False
        if (
            spec.probability == 0.0
            and spec.call_index is None
            and spec.offset is None
            and not spec.path_substr
        ):
            return False  # a spec must target *something*
        return True

    def _apply_faults(self, path: str, start: int, length: int,
                      data: Optional[bytes], call: int,
                      op: str = "read_range") -> Optional[bytes]:
        """Run the schedule for one call. ``data=None`` = pre-op phase
        (raise/stall); bytes = mutation phase (post-read for reads,
        pre-commit for writes — the staged bytes are damaged before
        they land)."""
        for i, spec in enumerate(self.faults):
            pre = spec.kind in ("transient", "stall", "slow")
            if pre != (data is None):
                continue
            if not self._spec_matches(i, spec, path, start, length, op):
                continue
            self._fired[i] += 1
            self.injected.append(
                _Injection(spec.kind, op, path, start, length, call)
            )
            if spec.kind == "transient":
                raise TransientIOError(
                    f"injected transient fault #{call} on {op} {path} "
                    f"[{start}, {start + length})"
                )
            if spec.kind == "stall":
                self._pending_stall += spec.stall_s
            elif spec.kind == "slow":
                # Seeded tail latency: the draw consumes the schedule
                # RNG under the mutex, so the whole latency sequence is
                # a pure function of (seed, call sequence).
                self._pending_stall += self._rng.uniform(0.0, spec.slow_s)
            elif spec.kind == "truncate" and data:
                data = data[: max(0, len(data) - spec.truncate_bytes)]
            elif spec.kind == "bitflip" and data:
                rel = spec.offset - start
                if 0 <= rel < len(data):
                    buf = bytearray(data)
                    buf[rel] ^= 1 << spec.bit
                    data = bytes(buf)
        return data

    # -- FileSystemWrapper interface --------------------------------------

    def read_range(self, path: str, start: int, length: int) -> bytes:
        real = self._strip(path)
        # Pre-read faults raise/stall; the matched-call and RNG state
        # advance exactly once per attempt, so a retry is a NEW draw.
        with self._mutex:
            self._calls += 1
            call = self._calls
            self._apply_faults(real, start, length, None, call)
            stall, self._pending_stall = self._pending_stall, 0.0
        if stall:
            # Injected latency must not serialize concurrent readers:
            # sleep outside the schedule mutex.
            self._sleep(stall)
        data = self.inner.read_range(real, start, length)
        with self._mutex:
            return self._apply_faults(real, start, length, data, call)

    def open(self, path: str) -> BinaryIO:
        # Route stream reads through read_range so every byte a caller
        # sees passes the single injection point.
        return _RangeReader(self, path)

    def exists(self, path: str) -> bool:
        return self.inner.exists(self._strip(path))

    def get_file_length(self, path: str) -> int:
        return self.inner.get_file_length(self._strip(path))

    def _pre_write_faults(self, real: str, length: int, op: str) -> None:
        """Pre-op phase for a write-side call: transient raises and
        stall booking under the mutex, sleeping outside it."""
        with self._mutex:
            self._calls += 1
            call = self._calls
            self._apply_faults(real, 0, length, None, call, op=op)
            stall, self._pending_stall = self._pending_stall, 0.0
        if stall:
            self._sleep(stall)

    def write_all(self, path: str, data: bytes) -> None:
        real = self._strip(path)
        with self._mutex:
            self._calls += 1
            call = self._calls
            self._apply_faults(real, 0, len(data), None, call,
                               op="write_all")
            # Mutation phase BEFORE the durable write: a truncate or
            # bitflip here models a partial/corrupted upload that the
            # store nevertheless committed.
            data = self._apply_faults(real, 0, len(data), data, call,
                                      op="write_all")
            stall, self._pending_stall = self._pending_stall, 0.0
        if stall:
            self._sleep(stall)
        self.inner.write_all(real, data)

    def create(self, path: str) -> BinaryIO:
        real = self._strip(path)
        self._pre_write_faults(real, 0, "create")
        return self.inner.create(real)

    def concat(self, parts, target: str) -> None:
        real = self._strip(target)
        self._pre_write_faults(real, 0, "concat")
        self.inner.concat([self._strip(p) for p in parts], real)

    def list_directory(self, path: str) -> List[str]:
        return self.inner.list_directory(self._strip(path))

    def delete(self, path: str, recursive: bool = False) -> None:
        self.inner.delete(self._strip(path), recursive)

    def mkdirs(self, path: str) -> None:
        self.inner.mkdirs(self._strip(path))

    def is_directory(self, path: str) -> bool:
        return self.inner.is_directory(self._strip(path))

    # -- introspection -----------------------------------------------------

    def fired_counts(self) -> List[Tuple[str, int]]:
        return [(s.kind, n) for s, n in zip(self.faults, self._fired)]

    def reset(self, seed: Optional[int] = None) -> None:
        """Rewind the schedule (same seed ⇒ identical fault sequence)."""
        if seed is not None:
            self._rng = random.Random(seed)
        self._calls = 0
        self._fired = [0] * len(self.faults)
        self._matched = [0] * len(self.faults)
        self.injected.clear()


class _RangeReader(io.RawIOBase):
    """Seekable read stream over ``read_range``: gives ``open()`` the
    same fault surface as bulk staging reads.

    Reads ahead in ``READAHEAD``-sized chunks, like a remote stream: a
    sequential header scan issues a handful of faultable range reads,
    not one per BGZF block, which keeps whole-phase retries convergent
    under a sustained injected fault rate."""

    READAHEAD = 256 * 1024

    def __init__(self, fs: FaultInjectingFileSystemWrapper, path: str) -> None:
        self._fs = fs
        self._path = path
        self._pos = 0
        self._len = fs.get_file_length(path)
        self._buf = b""
        self._buf_start = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = pos
        elif whence == 1:
            self._pos += pos
        else:
            self._pos = self._len + pos
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = self._len - self._pos
        if n <= 0:
            return b""
        lo = self._pos - self._buf_start
        if 0 <= lo and lo + n <= len(self._buf):
            data = self._buf[lo: lo + n]
            self._pos += len(data)
            return data
        want = min(max(n, self.READAHEAD), self._len - self._pos)
        if want <= 0:
            return b""
        self._buf = self._fs.read_range(self._path, self._pos, want)
        self._buf_start = self._pos
        data = self._buf[:n]
        self._pos += len(data)
        return data

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)
