"""Region pileup: per-base coverage over one reference interval, the
base-granularity form of ``ops/depth.py``'s windowed depth.

Counterpart of ``disq_tpu/ops/pileup.py`` (the single-device path; the
mesh's ``_depth_psum`` waits for multi-GPU). The same difference array
summed by a cumulative sum (``ops/depth.py::_depth_global``), at one
window per base over the queried region: depth at base b counts the
mapped alignments whose reference span covers b. Mapped records only
(``flag & 0x4`` clear, as ``window_depth``); secondary, supplementary
and duplicate records count unless the caller filtered them
(``ops/rfilter.py``).

A device-backed ``ColumnarBatch`` never host-parses here: the alignment
spans come from the vectorized CIGAR walk over its record bytes
(``ops/markdup.py::cigar_arrays_from_blob``), and the sum runs on its
device; a host batch sums on ``device`` (``cuda`` unless asked).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# a query's response and scatter space stay bounded: one region
MAX_REGION_BP = 1 << 22


def _span_bounds(batch) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """(refid, pos, end, mapped mask) for any batch flavor; a
    device-backed batch derives the CIGAR spans from its record blob."""
    from disq_tpu_torch.ops.markdup import (
        cigar_arrays_from_blob, clip_and_span, record_fields_from_blob)
    from disq_tpu_torch.runtime.columnar import ColumnarBatch

    if isinstance(batch, ColumnarBatch) and batch.device_backed:
        src = batch.encode_source()
        if src is not None:
            blob, offsets, order = src
            fields = record_fields_from_blob(blob, offsets, order)
            cig, cig_off = cigar_arrays_from_blob(blob, fields)
            span, _lead, _trail = clip_and_span(cig, cig_off)
            refid, pos, flag = fields["refid"], fields["pos"], fields["flag"]
            end = pos + np.maximum(span, 1)
            return refid, pos, end, (flag & 0x4) == 0
    refid = np.asarray(batch.refid, np.int64)
    pos = np.asarray(batch.pos, np.int64)
    end = np.asarray(batch.alignment_ends(), np.int64)
    return refid, pos, end, (np.asarray(batch.flag) & 0x4) == 0


def region_pileup(batch, refid: int, start: int, end: int,
                  device=None) -> np.ndarray:
    """int32 per-base coverage of ``[start, end)`` on ``refid``, summed
    on the device of a device-backed batch, else on ``device`` (``cuda``
    unless the caller asks for another). Books ``ops.pileup.records``
    with the number of overlapping alignments scattered."""
    from disq_tpu_torch.ops.depth import _depth_global
    from disq_tpu_torch.runtime import counters
    from disq_tpu_torch.runtime.device_pipeline import upload
    from disq_tpu_torch.runtime.tracing import counter, device_span, span
    from disq_tpu_torch.util import resolve_device

    length = int(end) - int(start)
    if length <= 0:
        return np.zeros(0, np.int32)
    if length > MAX_REGION_BP:
        raise ValueError(
            f"pileup region of {length} bp exceeds the {MAX_REGION_BP} "
            "bp bound; query a smaller interval")
    if getattr(batch, "device_backed", False):
        device = batch.device
    else:
        device = resolve_device(device)
    with span("ops.pileup.apply", records=int(batch.count),
              region_bp=length):
        rid, pos, ends, mapped = _span_bounds(batch)
        sel = mapped & (rid == refid) & (pos < end) & (ends > start)
        counter("ops.pileup.records").inc(int(sel.sum()))
        if not sel.any():
            return np.zeros(length, np.int32)
        # clamp onto the region's base space [0, length - 1]
        b_lo = np.clip(pos[sel] - start, 0, length - 1).astype(np.int64)
        b_hi = np.clip(ends[sel] - 1 - start, 0, length - 1).astype(np.int64)
        lo, hi = upload(b_lo, device), upload(b_hi, device)
        with device_span("device.kernel", kernel="depth",
                         records=len(b_lo)) as fence:
            cov = fence.sync(_depth_global(lo, hi, length))
        out = cov.cpu().numpy()
        if cov.is_cuda:
            counters.book_transfer("d2h", out.nbytes)
        return out
