"""The counters this port books.

Process-wide books, views over the telemetry registry
(``runtime/tracing.py``), so the port keeps one book:

- ``launches[kernel]``: one per launch of a hand-written CUDA kernel,
  added by the kernel's wrapper right where it launches (the plain
  versions on CPU tensors book nothing); the registry's
  ``device.kernel_launches{kernel=}`` under the reference's kernel names
  (``REFERENCE_KERNEL``: B1 ``inflate_simd``, B4 ``inflate``, B3
  ``rans_simd``, B5 ``rans``, B2 ``parse``, W2 ``deflate_simd``, W1
  ``encode_resident``, F1 ``read_filter``), read back here under the
  port's;
- ``host_fallback_blocks[reason]``: blocks the device route handed to
  the host (``flagged`` by a kernel, ``expanded`` by the deflate coder);
  the registry's ``device.host_fallback_blocks{reason=}``;
- ``transfer_bytes["h2d" | "d2h"]``: bytes copied between host and card;
  the registry's ``device.bytes_to_device`` / ``device.bytes_to_host``;
- ``host_rans_streams["rans0" | "rans1"]``: rANS streams the host codec
  decoded, by order (on ``cuda`` every order-0 stream goes to a kernel,
  so ``rans0`` stays 0 there); the ``route="host"`` series of the
  registry's ``cram.rans.streams{order=, route=}``, whose
  ``route="device"`` series counts the streams B3 or B5 decoded (a
  port-only book);
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

from disq_tpu_torch.runtime.tracing import REGISTRY, count_transfer

#: the port's kernel name → the reference's ``kernel=`` label
REFERENCE_KERNEL = {
    "inflate": "inflate_simd", "inflate_legacy": "inflate",
    "rans_simd": "rans_simd", "rans": "rans", "parse": "parse",
    "deflate": "deflate_simd", "record_gather": "encode_resident",
    "read_filter": "read_filter",
}
_PORT_KERNEL = {v: k for k, v in REFERENCE_KERNEL.items()}

_lock = threading.Lock()


def _launch_counter():
    return REGISTRY.counter("device.kernel_launches")


def _fallback_counter():
    return REGISTRY.counter("device.host_fallback_blocks")


def _transfer_counters():
    return {"h2d": REGISTRY.counter("device.bytes_to_device"),
            "d2h": REGISTRY.counter("device.bytes_to_host")}


def book_launch(kernel: str) -> None:
    _launch_counter().inc(kernel=REFERENCE_KERNEL.get(kernel, kernel))


def book_host_fallback(reason: str, blocks: int = 1) -> None:
    _fallback_counter().inc(blocks, reason=reason)


def book_transfer(direction: str, nbytes: int) -> None:
    count_transfer(direction, nbytes)


def _rans_counter():
    return REGISTRY.counter("cram.rans.streams")


def book_rans_streams(order: int, route: str, n: int = 1) -> None:
    """``n`` rANS streams of ``order`` decoded on ``route`` (``host`` or
    ``device``)."""
    _rans_counter().inc(n, order=str(order), route=route)


def host_rans_streams() -> Dict[str, int]:
    with REGISTRY._lock:
        out = Counter()
        for key, v in _rans_counter()._values.items():
            labels = dict(key)
            if v and labels.get("route") == "host":
                out[f"rans{labels['order']}"] += int(v)
    return dict(out)


def add_stats(stats: Dict[str, int], **increments: int) -> None:
    """``stats[k] += v`` for each increment, under the books' lock."""
    with _lock:
        for k, v in increments.items():
            stats[k] += int(v)


def _by_label(counter, label: str) -> Dict[str, int]:
    with REGISTRY._lock:
        return {dict(key)[label]: int(v) for key, v in counter._values.items()
                if v and label in dict(key)}


def launches() -> Dict[str, int]:
    """Launches by the port's kernel names."""
    return {_PORT_KERNEL.get(k, k): n
            for k, n in _by_label(_launch_counter(), "kernel").items()}


def reset() -> None:
    with REGISTRY._lock:
        for c in (_launch_counter(), _fallback_counter(), _rans_counter(),
                  *_transfer_counters().values()):
            c._reset()


def snapshot() -> Dict[str, Dict[str, int]]:
    with REGISTRY._lock:
        transfer = {d: int(c.value()) for d, c in _transfer_counters().items()
                    if c.value()}
    rans = host_rans_streams()
    return {
        "launches": launches(),
        "host_fallback_blocks": _by_label(_fallback_counter(), "reason"),
        "transfer_bytes": transfer,
        "host_rans_streams": rans,
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
