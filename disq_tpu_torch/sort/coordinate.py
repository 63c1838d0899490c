"""Coordinate sort.

SAM coordinate order: ascending refID (unmapped refID −1 LAST), then
ascending pos; ties keep input order (stable). A device-backed batch
sorts its device refid/pos columns with one stable ``torch.sort`` of
the int64 key; a host batch uses numpy's stable argsort of the same
key. Ragged columns are reordered on the host by one segment gather.
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


def coordinate_sort_batch(batch) -> ReadBatch:
    """Sort a batch (``ReadBatch`` or ``ColumnarBatch``) into coordinate
    order, single device."""
    from disq_tpu_torch.runtime.columnar import ColumnarBatch

    if isinstance(batch, ColumnarBatch):
        return batch.take(batch.sort_permutation())
    order = np.argsort(coordinate_keys(batch.refid, batch.pos), kind="stable")
    return batch.take(order)
