"""On-disk ledgers: write resume, read resume and the quarantine.

Counterparts of ``disq_tpu/runtime/manifest.py``, with its file layouts:

- ``StageManifest``: the shards of each named stage that completed, with
  a small JSON result per shard (a part's path and length). A write run
  again with the same manifest re-runs only the missing shards; the
  commit step (the merge) runs once every shard is present. The whole
  document is rewritten atomically (temp file, fsync, rename) on every
  completion, so a crash at any point leaves a consistent file. A
  ``params`` fingerprint that differs from the stored one starts the
  manifest afresh.
- ``ReadLedger``: the read's counterpart. A split's result is in
  memory, so the ledger pickles it to ``shard-<k>.pkl`` (temp file +
  rename) as the split emits and marks it done in an embedded
  ``StageManifest``; a read run again with the same ledger loads the
  finished splits and decodes only the others.
- ``QuarantineManifest``: the corrupt blocks set aside under
  ``ErrorPolicy.QUARANTINE``. Under ``base_dir`` (default
  ``<input>.quarantine``):

  - ``MANIFEST.jsonl``: line 1 is ``{"version": 1}``; each further line
    is one quarantined block ``{"path", "shard_id", "block_offset",
    "virtual_offset", "kind", "error", "sidecar", "length", "run_id"}``,
    appended as the block is set aside. A crash can tear at most the
    last line, which the loader skips; quarantining the same ``(path,
    block_offset)`` again appends a newer record and readers take the
    last one.
  - ``block-<pathtag>-<offset>.bin``: the verbatim corrupt compressed
    bytes; ``pathtag`` is a digest of the input path, so several inputs
    can share one directory.

``RUN_ID`` (``runtime/tracing.py``'s, so the span log and the ledgers
name a run alike) names this process's run: quarantine lines
and every shard a manifest marks done carry it, so a resumed manifest
tells which run completed each shard. Every ledger is mutated under a
lock: the pipelines' worker threads record shards at the same time.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from disq_tpu_torch.runtime.tracing import RUN_ID, span

FORMAT_VERSION = 1
QUARANTINE_FORMAT_VERSION = 1
# extra attempts of each step of a checkpointed shard
STAGE_RETRIES = 1


def retry_shard(fn: Callable, stage: str, shard_id: int,
                retries: int = STAGE_RETRIES) -> Callable:
    """``fn`` run up to ``retries`` extra times on any error: the
    shard-level retry of a checkpointed stage (a ``ShardRetrier`` retries
    only transient faults). A shard that still fails raises
    ``RuntimeError`` naming it, from the last error."""

    def wrapped(*args: Any) -> Any:
        last: Optional[BaseException] = None
        for _attempt in range(retries + 1):
            try:
                return fn(*args)
            except Exception as e:  # noqa: BLE001 — shard-level retry
                last = e
        raise RuntimeError(f"stage {stage!r} shard {shard_id} failed after "
                           f"{retries + 1} attempts") from last

    return wrapped


def _atomic_write(path: str, write: Callable[[Any], None],
                  mode: str = "w", prefix: str = ".tmp-") -> None:
    """``write(file)`` into a temp file beside ``path``, fsync, rename
    over ``path``: a crash leaves the old file or the new, never a torn
    one."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=prefix)
    try:
        with os.fdopen(fd, mode) as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class StageManifest:
    """Shard-level checkpoint ledger of a multi-stage run, keyed by
    ``(stage, shard_id)``. A stored ``params`` fingerprint that differs
    from ``params`` (or a damaged file) starts afresh; the old file is
    replaced at the next flush."""

    def __init__(self, path: str, params: Optional[Dict[str, Any]] = None):
        self.path = path
        # the write pipeline marks shards from its stage workers
        self._lock = threading.RLock()
        self._state: Dict[str, Any] = {
            "version": FORMAT_VERSION,
            "params": params or {},
            "stages": {},
            "run_id": RUN_ID,
        }
        if os.path.exists(path):
            try:
                with open(path, "r") as f:
                    stored = json.load(f)
            except (json.JSONDecodeError, OSError, UnicodeDecodeError):
                stored = {}
            if (isinstance(stored, dict)
                    and stored.get("version") == FORMAT_VERSION
                    and (params is None or stored.get("params") == params)):
                self._state = stored

    def _flush(self) -> None:
        _atomic_write(self.path, lambda f: json.dump(self._state, f),
                      prefix=".manifest-")

    def _stage(self, stage: str) -> Dict[str, Any]:
        return self._state["stages"].setdefault(stage, {"shards": {}})

    def is_done(self, stage: str, shard_id: int) -> bool:
        with self._lock:
            return str(shard_id) in self._stage(stage)["shards"]

    def shard_info(self, stage: str, shard_id: int) -> Any:
        with self._lock:
            return self._stage(stage)["shards"][str(shard_id)]

    def mark_done(self, stage: str, shard_id: int, info: Any = None) -> None:
        """Record ``shard_id`` of ``stage`` as done with its JSON
        ``info``, and the run that did it; flushed before returning."""
        with self._lock:
            st = self._stage(stage)
            st["shards"][str(shard_id)] = info
            st.setdefault("runs", {})[str(shard_id)] = RUN_ID
            self._flush()

    def shard_run_id(self, stage: str, shard_id: int) -> Optional[str]:
        """The ``RUN_ID`` of the run that marked this shard done."""
        with self._lock:
            return self._stage(stage).get("runs", {}).get(str(shard_id))

    def completed_shards(self, stage: str) -> List[int]:
        with self._lock:
            return sorted(int(k) for k in self._stage(stage)["shards"])

    def run_stage(self, stage: str, n_shards: int, fn: Callable[[int], Any],
                  retries: int = STAGE_RETRIES) -> List[Any]:
        """``fn(shard_id)`` for every shard not recorded yet, in shard
        order, each under ``retry_shard`` and recorded as it completes.
        Returns every shard's info in shard order, recorded and fresh
        alike (``fn``'s result must be JSON-serializable)."""
        out: List[Any] = [None] * n_shards
        for k in range(n_shards):
            if self.is_done(stage, k):
                out[k] = self.shard_info(stage, k)
                continue
            out[k] = retry_shard(fn, stage, k, retries)(k)
            self.mark_done(stage, k, out[k])
        return out

    def finish(self) -> None:
        """The commit point: remove the manifest (the caller removes the
        staged parts)."""
        if os.path.exists(self.path):
            os.unlink(self.path)


class ReadLedger:
    """Crash-resumable read: each split's decoded value is spilled to
    ``shard-<k>.pkl`` and marked done as it emits; ``params``
    fingerprints the input and the options that change what a split
    decodes to, so a different read starts afresh."""

    STAGE = "read.shards"

    def __init__(self, base_dir: str,
                 params: Optional[Dict[str, Any]] = None) -> None:
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)
        self.manifest = StageManifest(
            os.path.join(base_dir, "MANIFEST.json"), params)

    def _spill_path(self, shard_id: int) -> str:
        return os.path.join(self.base_dir, f"shard-{shard_id}.pkl")

    def is_done(self, shard_id: int) -> bool:
        """Recorded and its spill present (a recorded split whose spill
        is gone runs again)."""
        return (self.manifest.is_done(self.STAGE, shard_id)
                and os.path.exists(self._spill_path(shard_id)))

    def record(self, shard_id: int, value: Any) -> None:
        import pickle

        _atomic_write(
            self._spill_path(shard_id),
            lambda f: pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL),
            mode="wb", prefix=".shard-")
        self.manifest.mark_done(self.STAGE, shard_id,
                                {"spill": self._spill_path(shard_id)})

    def load(self, shard_id: int) -> Any:
        import pickle

        with open(self._spill_path(shard_id), "rb") as f:
            return pickle.load(f)

    def completed_shards(self) -> List[int]:
        return [k for k in self.manifest.completed_shards(self.STAGE)
                if os.path.exists(self._spill_path(k))]

    def shard_run_id(self, shard_id: int) -> Optional[str]:
        return self.manifest.shard_run_id(self.STAGE, shard_id)

    def finish(self) -> None:
        """The read completed: drop the manifest and every spill."""
        self.manifest.finish()
        for name in os.listdir(self.base_dir):
            if name.startswith("shard-") and name.endswith(".pkl"):
                os.unlink(os.path.join(self.base_dir, name))


class QuarantineManifest:
    MANIFEST_NAME = "MANIFEST.jsonl"

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        self.path = os.path.join(base_dir, self.MANIFEST_NAME)
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, int], Dict[str, Any]] = {}
        self._header_ok = False
        if os.path.exists(self.path):
            try:
                with open(self.path, "r") as f:
                    lines = f.read().splitlines()
            except (OSError, UnicodeDecodeError):
                lines = []
            for i, line in enumerate(lines):
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    if i == 0:
                        break  # headerless or torn ledger: not trusted
                    continue  # torn tail line
                if i == 0:
                    if (not isinstance(rec, dict)
                            or rec.get("version") != QUARANTINE_FORMAT_VERSION):
                        break  # a foreign ledger: not merged into
                    self._header_ok = True
                    continue
                if isinstance(rec, dict):
                    key = (rec.get("path", ""), rec.get("block_offset", -1))
                    self._entries[key] = rec

    @property
    def entries(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._entries.values())

    def _append(self, rec: Dict[str, Any]) -> None:
        if (not self._header_ok and os.path.exists(self.path)
                and os.path.getsize(self.path) > 0):
            # a headerless or foreign ledger is set aside, not appended to
            os.replace(self.path, self.path + ".bak")
        with open(self.path, "a") as f:
            if not self._header_ok:
                f.write(json.dumps({"version": QUARANTINE_FORMAT_VERSION})
                        + "\n")
                self._header_ok = True
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")

    def quarantine(self, path: str, block_offset: int, raw: bytes, *,
                   shard_id: int = -1, virtual_offset: Optional[int] = None,
                   error: str = "", kind: str = "block") -> str:
        """Copy one corrupt block aside; returns the sidecar path. The
        sidecar is committed (temp file + rename) before the ledger
        line that names it. Timed as a ``quarantine.write`` span."""
        with span("quarantine.write", shard=shard_id,
                  block_offset=block_offset, kind=kind):
            return self._quarantine(path, block_offset, raw, shard_id,
                                    virtual_offset, error, kind)

    def _quarantine(self, path, block_offset, raw, shard_id, virtual_offset,
                    error, kind) -> str:
        os.makedirs(self.base_dir, exist_ok=True)
        tag = hashlib.sha1(path.encode()).hexdigest()[:8]
        sidecar = os.path.join(self.base_dir, f"block-{tag}-{block_offset}.bin")
        fd, tmp = tempfile.mkstemp(dir=self.base_dir, prefix=".block-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(raw)
            os.replace(tmp, sidecar)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        entry = {
            "path": path, "shard_id": shard_id, "block_offset": block_offset,
            "virtual_offset": virtual_offset, "kind": kind, "error": error,
            "sidecar": sidecar, "length": len(raw), "run_id": RUN_ID,
        }
        with self._lock:
            self._entries[(path, block_offset)] = entry
            self._append(entry)
        return sidecar
