"""Process identity and axis planning of a multi-process job.

Counterpart of ``disq_tpu/runtime/multihost.py``'s host functions:
``plan_axes`` (the ``(dcn, shards)`` split of a device set over its
processes), and ``process_id`` / ``process_count``, the identity every
introspection endpoint stamps on its output so a cluster aggregation
(``runtime/cluster.py``) can tell N workers apart. The reference falls
back to ``jax.process_index()``; the port falls back to the rank and
world size of an initialised ``torch.distributed`` group.

``initialize`` bootstraps that group (``torch.distributed`` is used here
and by the mesh's collectives over the ``dcn`` axis, nowhere else), and
``global_mesh`` is the ``(dcn, shards)`` mesh over every process's local
devices (``runtime/mesh.py``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


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


def initialize(coordinator_address: Optional[str] = None,
               num_processes: int = 1,
               process_id: int = 0,
               device=None) -> None:
    """Join a job of ``num_processes`` processes (nothing for one).

    ``coordinator_address`` is ``host:port`` of process 0, the rendezvous
    the reference's ``jax.distributed.initialize`` takes. The process
    group runs ``nccl`` when this process's device (``cuda`` unless
    given) is a card, ``gloo`` on the CPU."""
    if num_processes <= 1:
        return
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    dev = torch.device("cuda" if device is None else device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None:
        raise ValueError("a job of several processes needs the "
                         "coordinator's host:port")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))


def global_mesh(dcn_axis: str = "dcn", ici_axis: str = "shards",
                device=None):
    """Mesh over every device of every process: ``(processes, local
    devices)``, the process boundary outer. One process gives
    ``(1, n_local)``. This process holds row ``process_id()``; the
    other rows name the same local ordinals on their own hosts."""
    import numpy as np

    from disq_tpu_torch.runtime.mesh import Mesh, local_devices

    devs = local_devices(device)
    if not devs:
        raise RuntimeError("no local device for a mesh")
    n_proc = process_count()
    dcn, per_host = plan_axes(len(devs) * n_proc, n_proc)
    slots = [_Slot(p, p * per_host + k, d)
             for p in range(n_proc) for k, d in enumerate(devs)]
    arr = np.empty((dcn, per_host), dtype=object)
    for s, ordinal in _local_ordinals(slots).items():
        arr[s.process_index, ordinal] = s.device
    return Mesh(arr, (dcn_axis, ici_axis), process_index=process_id(),
                process_count=n_proc)


class _Slot:
    """One device of the job: its process, its job-wide id and its
    ``torch.device`` (the same ordinal on every host)."""

    __slots__ = ("process_index", "id", "device")

    def __init__(self, process_index: int, id: int, device) -> None:
        self.process_index, self.id, self.device = process_index, id, device


def _local_ordinals(devs) -> dict:
    """``{device: local ordinal}`` for every device, in one pass: within
    each process, devices are ranked by id."""
    by_proc: dict = {}
    for d in devs:
        by_proc.setdefault(d.process_index, []).append(d)
    ordinals: dict = {}
    for same in by_proc.values():
        for i, d in enumerate(sorted(same, key=lambda d: d.id)):
            ordinals[d] = i
    return ordinals
