"""Process identity and axis planning of a multi-process job.

Counterpart of ``disq_tpu/runtime/multihost.py``'s host functions:
``plan_axes`` (the ``(dcn, shards)`` split of a device set over its
processes), and ``process_id`` / ``process_count``, the identity every
introspection endpoint stamps on its output so a cluster aggregation
(``runtime/cluster.py``) can tell N workers apart. The reference falls
back to ``jax.process_index()``; the port falls back to the rank and
world size of an initialised ``torch.distributed`` group. Bootstrapping
the job and its global mesh come with the multi-card slice.
"""

from __future__ import annotations

import os
from typing import Tuple


def plan_axes(n_devices_total: int, n_processes: int) -> Tuple[int, int]:
    """(dcn, shards) axis sizes: hosts on the outer axis, the per-host
    device count on the inner one."""
    if n_processes <= 0:
        raise ValueError("n_processes must be positive")
    if n_devices_total <= 0:
        raise ValueError("n_devices_total must be positive")
    if n_devices_total % n_processes:
        raise ValueError(
            f"{n_devices_total} devices do not split over "
            f"{n_processes} processes")
    return n_processes, n_devices_total // n_processes


def _distributed():
    """``torch.distributed`` when a process group is initialised, else
    None."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist
    except Exception:  # noqa: BLE001 — a torch without distributed
        pass
    return None


def process_id() -> int:
    """This process's id in the job: ``DISQ_TPU_TORCH_PROCESS_ID`` (a
    negative or malformed value falls through), then the
    ``torch.distributed`` rank, then 0."""
    raw = os.environ.get("DISQ_TPU_TORCH_PROCESS_ID")
    if raw is not None and raw != "":
        try:
            value = int(raw)
            if value >= 0:
                return value
        except ValueError:
            pass
    dist = _distributed()
    return int(dist.get_rank()) if dist is not None else 0


def process_count() -> int:
    """Processes in the job: ``DISQ_TPU_TORCH_PROCESS_COUNT`` (clamped to
    at least 1), then the ``torch.distributed`` world size, then 1."""
    raw = os.environ.get("DISQ_TPU_TORCH_PROCESS_COUNT")
    if raw is not None and raw != "":
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    dist = _distributed()
    return int(dist.get_world_size()) if dist is not None else 1
