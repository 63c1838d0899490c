"""Coordinate sort.

SAM coordinate order: ascending refID (unmapped refID −1 LAST), then
ascending pos; ties keep input order (stable). A device-backed batch
sorts its device refid/pos columns with one stable ``torch.sort`` of
the int64 key; a host batch uses numpy's stable argsort of the same
key. Ragged columns are reordered on the host by one segment gather,
unless the device write path keeps the sorted batch resident.
"""

from __future__ import annotations

import numpy as np

from disq_tpu_torch.bam.columnar import ReadBatch

# Key layout: refid in the high 32 bits with unmapped (−1) remapped
# ABOVE all real refs, pos+1 in the low 32 — monotone in coordinate
# order, so one stable sort of the u64 key suffices.


def coordinate_keys(refid: np.ndarray, pos: np.ndarray) -> np.ndarray:
    rid = refid.astype(np.int64)
    rid = np.where(rid < 0, np.int64(0x7FFFFFFF), rid)
    return (rid.astype(np.uint64) << np.uint64(32)) | (
        (pos.astype(np.int64) + 1).astype(np.uint64) & np.uint64(0xFFFFFFFF)
    )


def coordinate_sort_batch(batch, keep_resident: bool = False):
    """Sort a batch (``ReadBatch`` or ``ColumnarBatch``) into coordinate
    order, single device.

    ``keep_resident`` (the device write path) returns
    ``batch.permuted(order)`` for a batch with an encode source instead
    of materializing host records: the fixed columns are permuted on the
    device and the record bytes stay where the device write gathers
    them from (``runtime/device_write.py``)."""
    from disq_tpu_torch.runtime.columnar import ColumnarBatch

    resident_src = None
    if isinstance(batch, ColumnarBatch):
        if batch.device_backed and batch.count > 0:
            order = batch.sort_permutation()
            if keep_resident and batch.encode_source() is not None:
                return batch.permuted(order)
            return batch.take(order)
        resident_src = batch if keep_resident else None
        batch = batch.to_read_batch()
    order = np.argsort(coordinate_keys(batch.refid, batch.pos), kind="stable")
    if resident_src is not None and resident_src.encode_source() is not None:
        return resident_src.permuted(order)
    return batch.take(order)
