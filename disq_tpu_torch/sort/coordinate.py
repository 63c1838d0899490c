"""Coordinate sort.

SAM coordinate order: ascending refID (unmapped refID −1 LAST), then
ascending pos; ties keep input order (stable). A device-backed batch
sorts its device refid/pos columns with one stable ``torch.sort`` of
the int64 key (over its shards with ``sort/sharded.py`` when it is on a
mesh); a host batch takes the permutation from
``sharded_coordinate_sort`` when more than one local device exists
(``runtime/mesh.local_devices``), else numpy's stable argsort of the
same key. Ragged columns are reordered on the host by one segment
gather, unless the write keeps the sorted batch resident: a BAM write,
whose sink gathers each shard's record bytes from the read's blob, and
any write with the device deflate.
"""

from __future__ import annotations

import time

import numpy as np

from disq_tpu_torch.bam.columnar import ReadBatch
from disq_tpu_torch.runtime.tracing import record_span

# Key layout: refid in the high 32 bits with unmapped (−1) remapped
# ABOVE all real refs, pos+1 in the low 32 — monotone in coordinate
# order, so one stable sort of the u64 key suffices.


def coordinate_keys(refid: np.ndarray, pos: np.ndarray) -> np.ndarray:
    rid = refid.astype(np.int64)
    rid = np.where(rid < 0, np.int64(0x7FFFFFFF), rid)
    return (rid.astype(np.uint64) << np.uint64(32)) | (
        (pos.astype(np.int64) + 1).astype(np.uint64) & np.uint64(0xFFFFFFFF)
    )


def coordinate_sort_batch(batch, use_mesh: bool = True,
                          keep_resident: bool = False):
    """Sort a batch (``ReadBatch`` or ``ColumnarBatch``) into coordinate
    order. With ``use_mesh`` and more than one local device (of ``cuda``,
    or of the CPU where CUDA is absent), a host batch's permutation comes
    from the sharded sort over them; a failure there raises, it never
    falls back to the host argsort.

    ``keep_resident`` (a BAM write, the device write path) returns
    ``batch.permuted(order)`` for a batch with an encode source instead
    of materializing host records: the fixed columns are permuted on the
    device and the record bytes stay where the BAM sink gathers them
    from (``bam/sink.py``, ``runtime/device_write.py``).

    One ``sort.coordinate`` span covers the call: the permutation, the
    gather of the sorted records and a host parse of the records it
    triggers (``columnar.batch.materialize``; none with
    ``keep_resident``); its ``route`` says where the permutation came
    from (``device``, ``mesh`` or ``host``)."""
    t0 = time.perf_counter()
    out, route = _sort_batch(batch, use_mesh, keep_resident)
    record_span("sort.coordinate", time.perf_counter() - t0,
                records=int(batch.count), route=route)
    return out


def _sort_batch(batch, use_mesh, keep_resident):
    """``coordinate_sort_batch``'s work: (sorted batch, route)."""
    from disq_tpu_torch.runtime.columnar import ColumnarBatch

    resident_src = None
    if isinstance(batch, ColumnarBatch):
        if batch.device_backed and batch.count > 0:
            route = "mesh" if batch.mesh is not None else "device"
            order = batch.sort_permutation()
            if keep_resident and batch.encode_source() is not None:
                return batch.permuted(order), route
            return batch.take(order), route
        resident_src = batch if keep_resident else None
        batch = batch.to_read_batch()
    keys = coordinate_keys(batch.refid, batch.pos)
    order = None
    route = "host"
    if use_mesh and batch.count > 0:
        import torch

        from disq_tpu_torch.runtime.mesh import local_devices

        devs = local_devices(None if torch.cuda.is_available() else "cpu")
        if len(devs) > 1:
            from disq_tpu_torch.sort.sharded import (
                make_mesh, sharded_coordinate_sort)

            _, order = sharded_coordinate_sort(
                keys, make_mesh(len(devs), device=devs[0]))
            route = "mesh"
    if order is None:
        order = np.argsort(keys, kind="stable")
    if resident_src is not None and resident_src.encode_source() is not None:
        return resident_src.permuted(order), route
    return batch.take(order), route
