"""The counters this port books.

Process-wide books, one lock for all of them (the shard executor runs
decodes on several threads, so every ``+=`` goes through the lock):

- ``launches[kernel]``: one per launch of a hand-written CUDA kernel,
  added by the kernel's wrapper right where it launches (the plain
  versions on CPU tensors book nothing);
- ``host_fallback_blocks[reason]``: BGZF blocks the device route
  flagged, which the host then inflated block by block (the salvage
  path of ``runtime/errors.py``);
- ``transfer_bytes["h2d" | "d2h"]``: bytes copied between host and card
  (on the legacy inflate route this includes the upload of the blob
  assembled on the host);
- ``host_rans_streams["rans0" | "rans1"]``: rANS streams the host codec
  decoded, by order (on ``cuda`` every order-0 stream goes to a kernel,
  so ``rans0`` stays 0 there);
- the kernels' ``last_stats`` dicts, updated through ``add_stats``.

``reset()`` zeroes the books, so a caller can read exactly what one run
of the main path did.

Per read, the reference's ``ShardCounters`` / ``PipelineCounters``: each
shard of a read fills one, and ``reduce_counters`` folds them into the
dataset's totals (``ReadsDataset.counters``).
"""

from __future__ import annotations

import threading
from collections import Counter
from dataclasses import dataclass, fields
from typing import Dict, Iterable

_lock = threading.Lock()
launches: Counter = Counter()
host_fallback_blocks: Counter = Counter()
transfer_bytes: Counter = Counter()
host_rans_streams: Counter = Counter()


def book_launch(kernel: str) -> None:
    with _lock:
        launches[kernel] += 1


def book_host_fallback(reason: str, blocks: int = 1) -> None:
    with _lock:
        host_fallback_blocks[reason] += blocks


def book_transfer(direction: str, nbytes: int) -> None:
    with _lock:
        transfer_bytes[direction] += int(nbytes)


def book_host_rans(order: int) -> None:
    with _lock:
        host_rans_streams[f"rans{order}"] += 1


def add_stats(stats: Dict[str, int], **increments: int) -> None:
    """``stats[k] += v`` for each increment, under the books' lock."""
    with _lock:
        for k, v in increments.items():
            stats[k] += int(v)


def reset() -> None:
    with _lock:
        launches.clear()
        host_fallback_blocks.clear()
        transfer_bytes.clear()
        host_rans_streams.clear()


def snapshot() -> Dict[str, Dict[str, int]]:
    with _lock:
        return {
            "launches": dict(launches),
            "host_fallback_blocks": dict(host_fallback_blocks),
            "transfer_bytes": dict(transfer_bytes),
            "host_rans_streams": dict(host_rans_streams),
        }


# -- per-read counters ------------------------------------------------------


@dataclass
class ShardCounters:
    shard_id: int = -1
    records: int = 0
    blocks: int = 0
    bytes_compressed: int = 0
    bytes_uncompressed: int = 0
    wall_seconds: float = 0.0
    # corrupt blocks this shard dropped / copied aside, and transient
    # read failures absorbed by retry
    skipped_blocks: int = 0
    quarantined_blocks: int = 0
    retried_reads: int = 0

    def as_dict(self) -> Dict[str, float]:
        return {f.name: getattr(self, f.name) for f in fields(self)}


@dataclass
class PipelineCounters:
    shards: int = 0
    records: int = 0
    blocks: int = 0
    bytes_compressed: int = 0
    bytes_uncompressed: int = 0
    wall_seconds: float = 0.0
    skipped_blocks: int = 0
    quarantined_blocks: int = 0
    retried_reads: int = 0

    @property
    def compression_ratio(self) -> float:
        if self.bytes_compressed == 0:
            return 0.0
        return self.bytes_uncompressed / self.bytes_compressed

    def as_dict(self) -> Dict[str, float]:
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d["compression_ratio"] = round(self.compression_ratio, 4)
        return d


def reduce_counters(shard_counters: Iterable[ShardCounters]) -> PipelineCounters:
    """Field-wise sum of every ``ShardCounters`` field but ``shard_id``."""
    summed = [f.name for f in fields(ShardCounters) if f.name != "shard_id"]
    total = PipelineCounters()
    for c in shard_counters:
        total.shards += 1
        for name in summed:
            setattr(total, name, getattr(total, name) + getattr(c, name))
    return total
