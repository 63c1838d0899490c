"""Windowed coverage depth (``samtools depth``-shaped) over a record batch.

Counterpart of ``disq_tpu/ops/depth.py``. A difference array — +1 at
each mapped record's first window, −1 one past its last — summed by a
cumulative sum, as two torch ops on the batch's device. Depth of window
``w`` counts the records overlapping any base of ``[w*window,
(w+1)*window)`` (exact per base at ``window=1``). A batch on a mesh
(``runtime/mesh.py``) splits the window bounds over its shards, each
shard scatters its own difference array, and one ``psum`` merges them
before the cumulative sum (``_depth_psum``): integer adds, so the depth
equals the single-device one exactly.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime.device_pipeline import upload
from disq_tpu_torch.runtime.tracing import device_span
from disq_tpu_torch.util import resolve_device


def _depth_global(w_lo: torch.Tensor, w_hi: torch.Tensor,
                  n_windows: int) -> torch.Tensor:
    """Depth of each of ``n_windows`` windows from the records' first and
    last window indices (int64 on one device), as int32 there."""
    diff = torch.zeros(n_windows + 1, dtype=torch.int32, device=w_lo.device)
    ones = torch.ones(len(w_lo), dtype=torch.int32, device=w_lo.device)
    diff.index_add_(0, w_lo, ones)
    diff.index_add_(0, w_hi + 1, -ones)
    return torch.cumsum(diff, 0, dtype=torch.int32)[:-1]


def _depth_psum(w_lo: np.ndarray, w_hi: np.ndarray, n_windows: int,
                mesh) -> np.ndarray:
    """Depth of ``n_windows`` windows over a mesh: the bounds split over
    the ``batch`` axis (``shard_bounds``), a difference array per shard,
    a ``psum``, then the cumulative sum."""
    from disq_tpu_torch.runtime.mesh import MESH_AXIS, psum, shard_bounds

    devs = mesh.local_devices
    diffs = []
    with device_span("device.kernel", kernel="depth", records=len(w_lo),
                     devices=len(devs)) as fence:
        for d, (lo, hi) in zip(devs, shard_bounds(len(w_lo), len(devs))):
            lo_t = upload(np.asarray(w_lo[lo:hi], dtype=np.int64), d)
            hi_t = upload(np.asarray(w_hi[lo:hi], dtype=np.int64), d)
            diff = torch.zeros(n_windows + 1, dtype=torch.int32, device=d)
            ones = torch.ones(hi - lo, dtype=torch.int32, device=d)
            diff.index_add_(0, lo_t, ones)
            diff.index_add_(0, hi_t + 1, -ones)
            diffs.append(diff)
        total = psum(diffs, mesh, MESH_AXIS)[0]
        depth = fence.sync(torch.cumsum(total, 0, dtype=torch.int32)[:-1])
    flat = depth.cpu().numpy()
    if depth.is_cuda:
        counters.book_transfer("d2h", flat.nbytes)
    return flat


def window_depth(batch, ref_lengths: Sequence[int], window: int = 1024,
                 device=None) -> Dict[int, np.ndarray]:
    """Per-reference windowed depth of the mapped records of ``batch``
    (a host ``ReadBatch`` or a ``ColumnarBatch``): ``{refid: int32
    array of window depths}``. The window bounds come from the refid,
    pos and flag columns and the CIGAR-derived alignment ends on the
    host; the sum runs in one pass over a window space shared by all
    references, on the device of a device-backed batch, else on
    ``device`` (``cuda`` unless the caller asks for another)."""
    if getattr(batch, "device_backed", False):
        device = batch.device
    else:
        device = resolve_device(device)
    n_win_per_ref = [max(1, -(-int(ln) // window)) for ln in ref_lengths]
    ref_win_off = np.zeros(len(ref_lengths) + 1, dtype=np.int64)
    np.cumsum(n_win_per_ref, out=ref_win_off[1:])
    total_windows = int(ref_win_off[-1])
    if total_windows + 1 > np.iinfo(np.int32).max:
        raise ValueError(
            f"total window count {total_windows} exceeds int32 scatter-index "
            f"range; use a larger window than {window} for these reference "
            "lengths")
    refid = batch.refid
    sel = (refid >= 0) & (refid < len(ref_lengths)) & ((batch.flag & 0x4) == 0)
    if not sel.any():
        return {r: np.zeros(n_win_per_ref[r], dtype=np.int32)
                for r in range(len(ref_lengths))}
    rid = refid[sel].astype(np.int64)
    pos = batch.pos[sel].astype(np.int64)
    ends = batch.alignment_ends()[sel].astype(np.int64)
    per_ref_nw = np.asarray(n_win_per_ref, dtype=np.int64)
    w_lo = ref_win_off[rid] + np.clip(pos // window, 0, per_ref_nw[rid] - 1)
    w_hi = ref_win_off[rid] + np.clip((ends - 1) // window, 0,
                                      per_ref_nw[rid] - 1)
    mesh = getattr(batch, "mesh", None)
    if mesh is not None:
        flat = _depth_psum(w_lo, w_hi, total_windows, mesh)
    else:
        lo, hi = upload(w_lo, device), upload(w_hi, device)
        with device_span("device.kernel", kernel="depth",
                         records=len(w_lo)) as fence:
            depth = fence.sync(_depth_global(lo, hi, total_windows))
        flat = depth.cpu().numpy()
        if depth.is_cuda:
            counters.book_transfer("d2h", flat.nbytes)
    return {r: flat[ref_win_off[r]: ref_win_off[r + 1]]
            for r in range(len(ref_lengths))}
