"""Quarantine ledger for corrupt blocks set aside under
``ErrorPolicy.QUARANTINE`` — the reference's ``QuarantineManifest``
(``disq_tpu/runtime/manifest.py``), with its layout.

Under ``base_dir`` (default ``<input>.quarantine``):

- ``MANIFEST.jsonl``: line 1 is ``{"version": 1}``; each further line is
  one quarantined block ``{"path", "shard_id", "block_offset",
  "virtual_offset", "kind", "error", "sidecar", "length", "run_id"}``,
  appended as the block is set aside (``run_id`` names the process's
  run). A crash can tear at most the last line, which the loader skips;
  quarantining the same ``(path, block_offset)`` again appends a newer
  record and readers take the last one.
- ``block-<pathtag>-<offset>.bin``: the verbatim corrupt compressed
  bytes; ``pathtag`` is a digest of the input path, so several inputs
  can share one directory.

The ledger is appended under a lock: the shard executor's decode threads
may quarantine blocks at the same time.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

QUARANTINE_FORMAT_VERSION = 1
RUN_ID = f"{os.getpid():x}-{time.time_ns() & 0xFFFFFFFF:08x}"


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
        line that names it."""
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
