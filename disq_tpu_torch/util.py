"""Small shared helpers: device resolution, shard counts, the host pool."""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    asks for another one. Without CUDA a request for it raises — the
    port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def bucket_pow2(n: int, lo: int = 64) -> int:
    """Power-of-two bucket of ``n`` with floor ``lo``."""
    b = lo
    while b < n:
        b *= 2
    return b


_HOST_POOL = None
_HOST_POOL_LOCK = threading.Lock()


def shared_host_pool():
    """The process-wide ThreadPoolExecutor for short GIL-released host
    work (batch CRC checks, the zlib fallbacks). Created lazily on first
    use; min(4, cpus) threads, which stay until
    ``shutdown_shared_host_pool``."""
    global _HOST_POOL
    from concurrent.futures import ThreadPoolExecutor

    with _HOST_POOL_LOCK:
        if _HOST_POOL is None:
            _HOST_POOL = ThreadPoolExecutor(
                max_workers=min(4, os.cpu_count() or 1),
                thread_name_prefix="disq-torch-hostwork")
        return _HOST_POOL


def shutdown_shared_host_pool() -> None:
    """Join the shared pool's threads; the next use starts a new pool."""
    global _HOST_POOL
    with _HOST_POOL_LOCK:
        pool, _HOST_POOL = _HOST_POOL, None
    if pool is not None:
        pool.shutdown(wait=True)


def resolve_num_shards(storage) -> int:
    """Shard count for write paths: the storage's ``num_shards``
    override, else the visible CUDA device count, else 1. Written bytes
    depend on it, so parity tests pin it on both packages."""
    n: Optional[int] = getattr(storage, "_num_shards", None)
    if n:
        return n
    return max(1, torch.cuda.device_count())


def shard_bounds(storage, count: int):
    """(n_shards, bounds) for partitioning ``count`` records across
    write shards."""
    n_shards = min(resolve_num_shards(storage), max(1, count))
    bounds = np.linspace(0, count, n_shards + 1).astype(np.int64)
    return n_shards, bounds
