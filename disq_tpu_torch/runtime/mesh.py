"""The device mesh: one process over its local devices.

Counterpart of ``disq_tpu/runtime/mesh.py``. The reference builds one
``jax.sharding.Mesh`` and runs its mesh stages as ``shard_map`` programs
with ``lax.psum`` and ``lax.all_to_all``. Here:

- ``Mesh`` holds a numpy array of ``torch.device``s with axis names
  (``("batch",)`` for the pipeline's mesh, ``("shards",)`` for the sort's,
  ``("dcn", "shards")`` for ``runtime/multihost.global_mesh``);
  ``mesh.shape[axis]`` and ``mesh.devices.flat`` work as in the reference.
- A **shard** is one entry of that array, and a sharded tensor is a list
  of per-shard tensors, each on its shard's device, in ``devices.flat``
  order. The ``shard_map`` bodies are plain torch functions on one
  shard's tensors.
- The two collectives are ``psum`` and ``all_to_all``, and nothing else
  implements one. Within one process they copy tensors
  (``.to(device, non_blocking=True)``) and add them; over the ``dcn``
  axis of a multi-process ``global_mesh`` they call
  ``torch.distributed.all_reduce`` / ``all_to_all_single``.
- ``batch_sharding`` / ``replicated`` are placement descriptors and
  ``mesh_put`` moves a tensor (or a sharded one) onto the mesh under
  one, booking ``device.mesh.reshard_bytes``; ``all_to_all`` books
  ``device.mesh.exchange_bytes``.

``local_devices()`` is the counterpart of XLA's
``--xla_force_host_platform_device_count``: the process's ``cuda``
devices (or the CPU when asked), and under
``DISQ_TPU_TORCH_FORCE_DEVICE_COUNT=n`` the first of them repeated n
times. It is a check and test seam, as the reference's flag is, not a
user feature: it lets one card or the CPU run an n-shard mesh.

Off-path contract (``scripts/torch_check_overhead.py`` section 1d): with
no knob set (``DisqOptions.mesh`` None, ``DISQ_TPU_TORCH_MESH`` unset)
nothing is built (``mesh_if_built() is None``) and every caller takes
its single-device path. A knob that resolves to one device is the same
off path. Device counts round down to a power of two, and asking for
more devices than exist clamps to those present.
"""

from __future__ import annotations

import os
import threading
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

MESH_AXIS = "batch"
FORCE_ENV = "DISQ_TPU_TORCH_FORCE_DEVICE_COUNT"
MESH_ENV = "DISQ_TPU_TORCH_MESH"

_MESH_CACHE: dict = {}
_MESH_LOCK = threading.Lock()


class Mesh:
    """Devices laid out over named axes. ``devices`` is a numpy object
    array of ``torch.device``; ``shape`` maps each axis name to its size.

    A mesh built by ``global_mesh`` in a job of several processes
    (``process_count > 1``) spans every process along its leading
    (``dcn``) axis, and this process holds the shards of row
    ``process_index`` only: its sharded tensors list those, and the
    collectives cross processes over that axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_index: int = 0, process_count: int = 1) -> None:
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        if process_count > 1 and devices.shape[0] != process_count:
            raise ValueError("a multi-process mesh has one row per process")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def distributed(self) -> bool:
        return self.process_count > 1

    @property
    def local_devices(self) -> List[torch.device]:
        """This process's shards' devices, in the order of its sharded
        tensors."""
        if self.distributed:
            return list(self.devices[self.process_index].flat)
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def local_devices(device=None) -> List[torch.device]:
    """The devices of this process a mesh can take: every ``cuda`` device
    (none without CUDA), or ``[device]`` for another device type (the
    CPU when asked). Under ``DISQ_TPU_TORCH_FORCE_DEVICE_COUNT=n`` the
    first of them is repeated n times."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [torch.device("cuda", i) for i in range(count)]
    else:
        devs = [dev]
    raw = os.environ.get(FORCE_ENV, "").strip()
    if raw and devs:
        try:
            n = int(raw)
        except ValueError:
            n = 0
        if n > 0:
            devs = [devs[0]] * n
    return devs


def _env_devices() -> Optional[int]:
    """``DISQ_TPU_TORCH_MESH`` → requested device count (0 = all), or
    None when the env knob is off."""
    raw = os.environ.get(MESH_ENV, "").strip().lower()
    if raw in ("", "0", "false", "off", "no"):
        return None
    if raw in ("all", "auto", "true", "on", "yes"):
        return 0
    try:
        n = int(raw)
    except ValueError:
        return 0
    return n if n > 0 else None


def mesh_devices_requested(storage: Any = None) -> Optional[int]:
    """The knob, resolved without building anything:
    ``DisqOptions.mesh`` first, then ``DISQ_TPU_TORCH_MESH``; None means
    off."""
    opts = getattr(storage, "_options", None) if storage is not None \
        else None
    n = getattr(opts, "mesh", None) if opts is not None else None
    if n is not None:
        return int(n)
    return _env_devices()


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def get_mesh(requested: int = 0, device=None) -> Optional[Mesh]:
    """The cached ``batch`` mesh over the first ``requested`` local
    devices of ``device``'s type (0 = all), rounded down to a power of
    two; None when that is one device (the off path). Only this function
    builds the pipeline's mesh, so ``mesh_if_built`` witnesses that the
    off path built nothing."""
    devs = local_devices(device)
    n = len(devs) if requested <= 0 else min(requested, len(devs))
    n = _pow2_floor(max(1, n))
    if n <= 1:
        return None
    key = (devs[0].type, n)
    with _MESH_LOCK:
        mesh = _MESH_CACHE.get(key)
        if mesh is None:
            arr = np.empty(n, dtype=object)
            arr[:] = devs[:n]
            mesh = Mesh(arr, (MESH_AXIS,))
            _MESH_CACHE[key] = mesh
            from disq_tpu_torch.runtime.tracing import observe_gauge

            observe_gauge("device.mesh.devices", float(n))
    return mesh


def mesh_if_built() -> Optional[Mesh]:
    """The largest mesh this process has built, or None."""
    with _MESH_LOCK:
        if not _MESH_CACHE:
            return None
        return _MESH_CACHE[max(_MESH_CACHE, key=lambda k: k[1])]


def reset_mesh() -> None:
    """Forget every mesh built so far (the cache is process-global, as
    the other planes' state is): ``mesh_if_built()`` is None after."""
    with _MESH_LOCK:
        _MESH_CACHE.clear()


def mesh_for_storage(storage: Any) -> Optional[Mesh]:
    """The ``batch`` mesh of reads through ``storage`` when the knob is
    armed and more than one device of the storage's type is usable, else
    None. Cheap when off: two attribute reads and one env lookup."""
    req = mesh_devices_requested(storage)
    if req is None:
        return None
    return get_mesh(req, storage._resolved_device())


def shard_count(mesh: Mesh) -> int:
    return int(mesh.shape[MESH_AXIS])


class Placement:
    """Where a tensor lives on a mesh: split along dim 0 over the mesh's
    shards (``batch``) or one copy on every shard (``replicated``)."""

    __slots__ = ("mesh", "batch")

    def __init__(self, mesh: Mesh, batch: bool) -> None:
        self.mesh, self.batch = mesh, batch

    def __eq__(self, other) -> bool:
        return isinstance(other, Placement) and other.mesh is self.mesh \
            and other.batch == self.batch

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.batch))

    def __repr__(self) -> str:
        return f"Placement({'batch' if self.batch else 'replicated'})"


def batch_sharding(mesh: Mesh) -> Placement:
    """Dim 0 split over the mesh's shards."""
    return Placement(mesh, True)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, False)


def shard_bounds(n: int, n_shards: int) -> List[Tuple[int, int]]:
    """The ``[lo, hi)`` rows of each shard of ``n`` rows split along dim
    0: ``ceil(n / n_shards)`` rows a shard, the last ones shorter or
    empty. No padding: the rows are the data's own."""
    per = -(-n // n_shards) if n_shards else 0
    return [(min(n, i * per), min(n, (i + 1) * per))
            for i in range(n_shards)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def mesh_put(x: Union[torch.Tensor, Sequence[torch.Tensor]], mesh: Mesh,
             batch: bool = True) -> List[torch.Tensor]:
    """``x`` (a tensor, or a sharded one: a list of parts that join along
    dim 0) placed on ``mesh``: split into ``shard_bounds`` rows per
    shard (``batch``), or one copy of the tensor per shard. Parts already
    placed so pass through untouched. Rows that change shard book into
    ``device.mesh.reshard_bytes``; a copy per shard books its bytes once
    per shard."""
    from disq_tpu_torch.runtime.tracing import counter

    devs = mesh.local_devices
    parts = list(x) if isinstance(x, (list, tuple)) else [x]
    if not batch:
        if len(parts) != 1:
            parts = [torch.cat([p.to(devs[0], non_blocking=True)
                                for p in parts])]
        t = parts[0]
        counter("device.mesh.reshard_bytes").inc(_nbytes(t) * len(devs))
        return [t.to(d, non_blocking=True) for d in devs]
    total = sum(int(p.shape[0]) for p in parts)
    bounds = shard_bounds(total, len(devs))
    if len(parts) == len(devs) and all(
            int(p.shape[0]) == hi - lo and p.device == d
            for p, (lo, hi), d in zip(parts, bounds, devs)):
        return parts
    starts = np.cumsum([0] + [int(p.shape[0]) for p in parts])
    moved = 0
    out = []
    for j, ((lo, hi), d) in enumerate(zip(bounds, devs)):
        pieces = []
        for i, p in enumerate(parts):
            a, b = max(lo, int(starts[i])), min(hi, int(starts[i + 1]))
            if a >= b:
                continue
            piece = p[a - int(starts[i]): b - int(starts[i])]
            if i != j or len(parts) != len(devs):
                moved += _nbytes(piece)
            pieces.append(piece.to(d, non_blocking=True))
        if not pieces:
            ref = parts[0]
            out.append(torch.empty((0,) + tuple(ref.shape[1:]),
                                   dtype=ref.dtype, device=d))
        else:
            out.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces))
    if moved:
        counter("device.mesh.reshard_bytes").inc(moved)
    return out


def axis_mesh(mesh: Mesh, axis: str) -> Mesh:
    """The 1-D mesh along ``axis`` of ``mesh`` (its shards at index 0 of
    every other axis): where a column split over that one axis lives."""
    if mesh.axis_names == (axis,):
        return mesh
    if mesh.distributed:
        raise ValueError("a column split over one axis of a multi-process "
                         "mesh takes that axis's own collectives")
    dim = mesh.axis_names.index(axis)
    idx = tuple(slice(None) if d == dim else 0
                for d in range(mesh.devices.ndim))
    return Mesh(mesh.devices[idx], (axis,))


def mesh_gather(parts: Sequence[torch.Tensor],
                device=None) -> torch.Tensor:
    """A sharded tensor joined along dim 0 on one device (the first
    shard's unless given)."""
    from disq_tpu_torch.runtime.tracing import counter

    device = parts[0].device if device is None else torch.device(device)
    if len(parts) == 1:
        return parts[0].to(device)
    counter("device.mesh.reshard_bytes").inc(
        sum(_nbytes(p) for p in parts[1:]))
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def service_devices(device=None) -> List[Any]:
    """The devices the device service keeps one sub-queue each for: the
    mesh's (over ``device``'s type, ``cuda`` unless given) when the knob
    is armed at service start, else ``[None]`` (the service's own
    device, as before the mesh)."""
    req = _env_devices()
    if req is not None:
        mesh = get_mesh(req, device)
    else:
        mesh = mesh_if_built()
    kind = torch.device("cuda" if device is None else device).type
    if mesh is None or mesh.devices.flat[0].type != kind:
        return [None]
    return list(mesh.devices.flat)


# -- the two collectives -------------------------------------------------------


def _axes(mesh: Mesh, axis) -> Tuple[str, ...]:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"axis {a!r} not in mesh axes {mesh.axis_names}")
    return axes


def _local_shape(parts: Sequence[torch.Tensor], mesh: Mesh
                 ) -> Tuple[int, ...]:
    """The shape of the shards this process holds (the whole mesh, or
    its own row of a multi-process one); ``parts`` lists them flat."""
    shape = mesh.devices.shape[1:] if mesh.distributed else mesh.devices.shape
    if len(parts) != int(np.prod(shape)):
        raise ValueError(f"{len(parts)} parts for a mesh holding "
                         f"{int(np.prod(shape))} shards here")
    return tuple(shape)


def _groups(shape: Tuple[int, ...], dims: Sequence[int]) -> List[List[int]]:
    """Flat indices grouped by the coordinates outside ``dims``: each
    group holds the shards that reduce or exchange together, in order."""
    idx = np.arange(int(np.prod(shape))).reshape(shape)
    rest = [d for d in range(len(shape)) if d not in dims]
    size = int(np.prod([shape[d] for d in dims]))  # 1 with no dims
    return np.transpose(idx, rest + list(dims)).reshape(-1, size).tolist()


def _dist_axis(mesh: Mesh, axes: Sequence[str]) -> Tuple[bool, List[str]]:
    """Whether the collective crosses processes (over the leading axis of
    a multi-process mesh), and the axes it spans within this process."""
    if not mesh.distributed:
        return False, list(axes)
    lead = mesh.axis_names[0]
    return lead in axes, [a for a in axes if a != lead]


def psum(parts: Sequence[torch.Tensor], mesh: Mesh, axis="batch"
         ) -> List[torch.Tensor]:
    """The sum of the per-shard tensors over ``axis`` (a name or a tuple
    of names), placed on every shard's device of that axis: the
    counterpart of ``lax.psum`` inside a ``shard_map``."""
    axes = _axes(mesh, axis)
    cross, local_axes = _dist_axis(mesh, axes)
    shape = _local_shape(parts, mesh)
    names = mesh.axis_names[1:] if mesh.distributed else mesh.axis_names
    dims = [names.index(a) for a in local_axes]
    flat = list(parts)
    devs = mesh.local_devices
    out: List[Optional[torch.Tensor]] = [None] * len(flat)
    for group in _groups(shape, dims):
        acc = flat[group[0]]
        for i in group[1:]:
            acc = acc + flat[i].to(acc.device, non_blocking=True)
        if cross:
            import torch.distributed as dist

            acc = acc.clone()
            dist.all_reduce(acc)
        for i in group:
            out[i] = acc.to(devs[i], non_blocking=True)
    return out


def all_to_all(parts: Sequence[torch.Tensor], mesh: Mesh, axis="batch"
               ) -> List[torch.Tensor]:
    """The exchange over ``axis``: each part's dim 0 has one bucket per
    shard of the axis, and shard *i*'s *j*-th bucket is copied to shard
    *j*'s device, where it lands at position *i*. The counterpart of
    ``lax.all_to_all(x, axis, split_axis=0, concat_axis=0)``. Books the
    parts' bytes into ``device.mesh.exchange_bytes``."""
    from disq_tpu_torch.runtime.tracing import counter

    (name,) = _axes(mesh, axis)
    cross, _ = _dist_axis(mesh, (name,))
    shape = _local_shape(parts, mesh)
    k = mesh.shape[name]
    for p in parts:
        if int(p.shape[0]) != k:
            raise ValueError(f"all_to_all over {name!r} wants dim 0 of "
                             f"{k}, got {tuple(p.shape)}")
    counter("device.mesh.exchange_bytes").inc(sum(_nbytes(p) for p in parts))
    flat = list(parts)
    devs = mesh.local_devices
    if cross:
        import torch.distributed as dist

        out = []
        for p in flat:
            src = p.contiguous()
            dst = torch.empty_like(src)
            dist.all_to_all_single(dst, src)
            out.append(dst)
        return out
    names = mesh.axis_names[1:] if mesh.distributed else mesh.axis_names
    dims = [names.index(name)]
    out = [None] * len(flat)
    for group in _groups(shape, dims):
        for j, dst in enumerate(group):
            out[dst] = torch.stack([
                flat[src][j].to(devs[dst], non_blocking=True)
                for src in group])
    return out
