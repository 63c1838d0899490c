"""Per-read-group statistics: reads, duplicates, duplicate rate and the
MAPQ histogram of each ``RG``, reduced on the batch's device.

Counterpart of ``disq_tpu/ops/rgstats.py`` (the single-device path; the
mesh's ``_rg_psum_kernel`` waits for multi-GPU). The ``RG:Z`` tag is a
ragged attribute, so the id column is resolved on the host: an exact
per-record walk of the BAM tag region over the record blob (a
device-backed batch, no host record parse) or the host tag column, with
a vectorized ``RGZ`` pre-scan so a file without RG tags skips the walk.
The dense ids go up once (4 bytes per record) and the reduction (one
``index_add_`` over ``rg * 256 + mapq`` and one over the duplicate bit)
runs as torch ops against the resident mapq and flag columns; only the
histogram rows come back. A host batch bincounts in numpy; the integers
are the same.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

NO_RG = "(none)"

# BAM tag value sizes by type char: A c C s S i I f
_TYPE_SIZE = {65: 1, 99: 1, 67: 1, 115: 2, 83: 2, 105: 4, 73: 4, 102: 4}


def _walk_rg(buf, s: int, e: int) -> Optional[bytes]:
    """Exact tag walk of one record's tag region: its RG:Z value, or
    None."""
    while s + 3 <= e:
        t0, t1, tp = buf[s], buf[s + 1], buf[s + 2]
        s += 3
        if tp in (90, 72):  # Z / H: NUL-terminated
            z = s
            while z < e and buf[z] != 0:
                z += 1
            if t0 == 82 and t1 == 71 and tp == 90:
                return bytes(buf[s:z])
            s = z + 1
        elif tp == 66:  # B: subtype, i32 count, payload
            if s + 5 > e:
                break
            sub = buf[s]
            cnt = int.from_bytes(buf[s + 1: s + 5], "little")
            s += 5 + _TYPE_SIZE.get(sub, 1) * cnt
        else:
            s += _TYPE_SIZE.get(tp, 1)
    return None


def _has_rgz(flat: np.ndarray) -> bool:
    """Vectorized pre-scan: can any ``RG:Z`` tag exist? A real one
    always holds the bytes ``RGZ``, so a miss skips the walk."""
    if len(flat) < 3:
        return False
    return bool(np.any((flat[:-2] == 82) & (flat[1:-1] == 71)
                       & (flat[2:] == 90)))


def read_group_ids(batch) -> Tuple[np.ndarray, List[str]]:
    """(dense i32 RG id per record, id -> name). Records without an RG
    tag map to a trailing ``(none)`` group when any exist."""
    from disq_tpu_torch.ops.markdup import record_fields_from_blob
    from disq_tpu_torch.runtime.columnar import ColumnarBatch

    n = int(batch.count)
    spans: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    if isinstance(batch, ColumnarBatch) and batch.device_backed:
        src = batch.encode_source()
        if src is not None:
            blob, offsets, order = src
            fields = record_fields_from_blob(blob, offsets, order)
            lseq = fields["l_seq"]
            tag_lo = (fields["_off"] + 36 + fields["l_read_name"]
                      + 4 * fields["n_cigar"] + (lseq + 1) // 2 + lseq)
            rec_len = np.diff(np.asarray(offsets, np.int64))
            if order is not None:
                rec_len = rec_len[np.asarray(order, np.int64)]
            spans = (blob, tag_lo, fields["_off"] + rec_len)
    if spans is None:
        off = np.asarray(batch.tag_offsets, np.int64)
        spans = (np.asarray(batch.tags), off[:-1], off[1:])
    flat, lo, hi = spans
    ids = np.full(n, -1, np.int32)
    names: List[str] = []
    if n and _has_rgz(flat):
        # one Python turn per record, as in the reference
        by_name: Dict[bytes, int] = {}
        buf = memoryview(np.ascontiguousarray(flat))
        for i in range(n):
            rg = _walk_rg(buf, int(lo[i]), int(hi[i]))
            if rg is None:
                continue
            rid = by_name.get(rg)
            if rid is None:
                rid = by_name[rg] = len(by_name)
                names.append(rg.decode("utf-8", "replace"))
            ids[i] = rid
    if (ids < 0).any() and names:
        ids = np.where(ids < 0, np.int32(len(names)), ids)
        names = names + [NO_RG]
    elif not names:
        ids = np.zeros(n, np.int32)
        names = [NO_RG]
    return ids, names


def rg_reduce(rg: torch.Tensor, mapq: torch.Tensor, flag: torch.Tensor,
              n_rg: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reduction as torch ops on the inputs' device: the
    ``(n_rg * 256,)`` count of each (read group, mapq) pair and the
    ``(n_rg,)`` count of records flagged 0x400 per group, both int64.
    ``rg`` is int64, ``mapq`` and ``flag`` int32."""
    comb = rg * 256 + mapq.to(torch.int64)
    hist = torch.zeros(n_rg * 256, dtype=torch.int64, device=rg.device)
    hist.index_add_(0, comb, torch.ones_like(comb))
    dups = torch.zeros(n_rg, dtype=torch.int64, device=rg.device)
    dups.index_add_(0, rg, ((flag >> 10) & 1).to(torch.int64))
    return hist, dups


def _reduce_resident(batch, ids: np.ndarray, n_rg: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The reduction against the resident mapq and flag columns: the
    ids go up, only the histogram rows come back."""
    from disq_tpu_torch.runtime import counters
    from disq_tpu_torch.runtime.device_pipeline import upload
    from disq_tpu_torch.runtime.tracing import device_span

    dev = batch.device_columns()
    n = int(batch.count)
    rg = upload(ids.astype(np.int64), batch.device)
    with device_span("device.kernel", kernel="rgstats", records=n) as fence:
        hist, dups = fence.sync(rg_reduce(rg, dev["mapq"], dev["flag"],
                                          n_rg))
    h, d = hist.cpu().numpy(), dups.cpu().numpy()
    if hist.is_cuda:
        counters.book_transfer("d2h", h.nbytes + d.nbytes)
    batch._consume_on_device("mapq", 4 * n)
    batch._consume_on_device("flag", 4 * n)
    return h.reshape(n_rg, 256), d


def read_group_stats(batch) -> Dict[str, Dict[str, object]]:
    """{rg name: {reads, duplicates, dup_rate, mean_mapq, mapq_hist}}.
    A device-backed batch reduces on its device from the resident mapq
    and flag columns; a host batch bincounts in numpy (the same
    integers)."""
    from disq_tpu_torch.runtime.columnar import ColumnarBatch
    from disq_tpu_torch.runtime.tracing import span

    n = int(batch.count)
    with span("ops.rgstats.apply", records=n):
        ids, names = read_group_ids(batch)
        n_rg = len(names)
        if isinstance(batch, ColumnarBatch) and batch.device_backed and n:
            hist, dups = _reduce_resident(batch, ids, n_rg)
        else:
            mapq = np.asarray(batch.mapq, np.int64) if n else np.zeros(0)
            flag = np.asarray(batch.flag, np.int64) if n else np.zeros(0)
            comb = ids.astype(np.int64) * 256 + mapq
            hist = np.bincount(comb.astype(np.int64),
                               minlength=n_rg * 256).reshape(n_rg, 256)
            dups = np.bincount(ids, weights=(flag >> 10) & 1,
                               minlength=n_rg).astype(np.int64)
        return summarize(names, hist, dups)


def summarize(names: List[str], hist: np.ndarray,
              dups: np.ndarray) -> Dict[str, Dict[str, object]]:
    """The per-group dicts from the ``(n_rg, 256)`` histogram and the
    per-group duplicate counts."""
    out: Dict[str, Dict[str, object]] = {}
    mq = np.arange(256)
    for rid, name in enumerate(names):
        h = np.asarray(hist[rid])
        reads = int(h.sum())
        d = int(dups[rid])
        out[name] = {
            "reads": reads,
            "duplicates": d,
            "dup_rate": round(d / reads, 6) if reads else 0.0,
            "mean_mapq": round(float((h * mq).sum() / reads), 3)
            if reads else 0.0,
            "mapq_hist": h.astype(int).tolist(),
        }
    return out
