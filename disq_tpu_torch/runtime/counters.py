"""The few counters this port books.

- ``launches[kernel]``: one per launch of a hand-written CUDA kernel,
  added by the kernel's wrapper right where it launches (the plain
  versions on CPU tensors book nothing);
- ``host_fallback_blocks[reason]``: BGZF blocks the host had to inflate
  after the device route flagged them;
- ``transfer_bytes["h2d" | "d2h"]``: bytes copied between host and card;
- ``host_rans_streams["rans0" | "rans1"]``: rANS streams the host codec
  decoded, by order (on ``cuda`` every order-0 stream goes to a kernel,
  so ``rans0`` stays 0 there).

They are process-wide and plain integers; ``reset()`` zeroes them, so a
caller can read exactly what one run of the main path did.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Dict

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
