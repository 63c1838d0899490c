"""flagstat — per-category read counts (the ``samtools flagstat``
equivalent) as torch ops over the flag column, on whatever device holds
it; only the 12 counts come back to the host.

On a mesh (``runtime/mesh.py``) each shard counts its slice of the
column and one ``psum`` over the mesh axis merges the 12 counts: integer
adds, so the row equals the single-device one exactly.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

FLAGSTAT_FIELDS = (
    "total", "secondary", "supplementary", "duplicates", "mapped",
    "paired", "read1", "read2", "proper_pair", "with_mate_mapped",
    "singletons", "qc_fail",
)


def _counts(flag: torch.Tensor) -> torch.Tensor:
    """samtools-flagstat semantics: pair-related categories count only
    PRIMARY records (secondary 0x100 and supplementary 0x800 excluded),
    and 'with itself and mate mapped' requires the read itself mapped."""
    f = flag.to(torch.int32)

    def c(hit):
        return hit.sum()

    primary = (f & (0x100 | 0x800)) == 0
    paired = primary & ((f & 0x1) != 0)
    self_mapped = (f & 0x4) == 0
    mate_unmapped = (f & 0x8) != 0
    return torch.stack(
        [
            torch.tensor(f.numel(), device=f.device),
            c((f & 0x100) != 0),                         # secondary
            c((f & 0x800) != 0),                         # supplementary
            c((f & 0x400) != 0),                         # duplicates
            c(self_mapped),                              # mapped
            c(paired),                                   # paired
            c(paired & ((f & 0x40) != 0)),               # read1
            c(paired & ((f & 0x80) != 0)),               # read2
            c(paired & ((f & 0x2) != 0) & self_mapped),  # proper pair
            c(paired & self_mapped & ~mate_unmapped),    # with mate mapped
            c(paired & self_mapped & mate_unmapped),     # singletons
            c((f & 0x200) != 0),                         # qc fail
        ]
    )


def _row(row) -> Dict[str, int]:
    return {k: int(v) for k, v in zip(FLAGSTAT_FIELDS, row)}


def _device_row(flag: torch.Tensor) -> Dict[str, int]:
    """flagstat of a device column; 12 counts cross d2h."""
    from disq_tpu_torch.runtime.tracing import device_span

    with device_span("device.kernel", kernel="flagstat",
                     records=flag.numel()) as fence:
        row = fence.sync(_counts(flag))
    row = row.cpu().tolist()
    if flag.is_cuda:
        from disq_tpu_torch.runtime import counters

        counters.book_transfer("d2h", 8 * len(row))
    return _row(row)


def flagstat_resident(flag_dev: torch.Tensor, n: int) -> Dict[str, int]:
    """flagstat of the first ``n`` records of a resident flag column,
    where it lives."""
    return _device_row(flag_dev[:n])


def flagstat_resident_sharded(flag_dev, n: int, mesh,
                              axis: Optional[str] = None) -> Dict[str, int]:
    """flagstat of a batch-sharded resident flag column (one tensor per
    shard): each shard counts its slice and a ``psum`` over ``axis``
    (the mesh's ``batch`` axis, else its first) merges the rows."""
    from disq_tpu_torch.runtime import counters
    from disq_tpu_torch.runtime.mesh import MESH_AXIS, psum
    from disq_tpu_torch.runtime.tracing import device_span

    if axis is None:
        axis = MESH_AXIS if MESH_AXIS in mesh.axis_names \
            else mesh.axis_names[0]
    parts = list(flag_dev)
    if sum(int(p.numel()) for p in parts) != n:
        raise ValueError(f"sharded flag column does not hold {n} records")
    with device_span("device.kernel", kernel="flagstat", records=int(n),
                     devices=len(parts)) as fence:
        out = fence.sync(psum([_counts(p) for p in parts], mesh, axis)[0])
    row = out.cpu().tolist()
    if out.is_cuda:
        counters.book_transfer("d2h", 8 * len(row))
    return _row(row)


def flagstat_counts(flag, mesh=None, axis: str = "shards") -> Dict[str, int]:
    """Flag column (tensor on any device, or host array) → counts. With
    a mesh, the column is split over its ``axis`` and the counts are a
    ``psum`` of the shards'."""
    if mesh is not None and axis not in mesh.axis_names:
        if len(mesh.axis_names) == 1:
            axis = mesh.axis_names[0]
        else:
            raise ValueError(
                f"axis {axis!r} not in mesh axes {mesh.axis_names}; pass "
                "axis= explicitly for multi-axis meshes")
    if mesh is not None and mesh.shape[axis] > 1 and len(flag) > 0:
        from disq_tpu_torch.runtime.mesh import mesh_put

        from disq_tpu_torch.runtime.mesh import axis_mesh

        if isinstance(flag, np.ndarray):
            flag = torch.from_numpy(flag.astype(np.int32))
        sub = axis_mesh(mesh, axis)
        return flagstat_resident_sharded(mesh_put(flag, sub), len(flag),
                                         sub, axis)
    if isinstance(flag, np.ndarray):
        return _row(_counts(torch.from_numpy(flag.astype(np.int32))).tolist())
    return _device_row(flag)
