"""ColumnarBatch — a record batch whose fixed columns live on a device.

The read path's device route parses each decoded shard into fixed
columns with the parse kernel and keeps them as int32 tensors on the
device:

- **Lazy d2h.** Attribute access (``batch.pos``, ``batch.flag``, …)
  copies that one column to the host once, in ``ReadBatch`` dtypes;
  repeated access returns the cached copy.
- **Device consumers.** ``flagstat()`` reduces the device flag column
  and brings back 12 counts; ``sort_permutation()`` builds the
  coordinate keys and sorts them on the device and brings back only
  the permutation.
- **Host interop.** Ragged columns (names / cigars / seqs / quals /
  tags) come lazily from the host copy of the decoded blob, which the
  read path holds anyway for the CRC check and the record scan;
  ``to_read_batch()`` / ``take()`` materialize a plain ``ReadBatch``.
- **Device transforms.** ``permuted(order)`` and ``filter(mask)`` gather
  the fixed columns on the device with one index upload and stay
  device-backed: a permuted batch keeps the host blob and the pending
  order (applied at the host parse), a filtered one compacts the blob.
  ``or_flags(mask, bits)`` (duplicate marking's write-back) patches the
  device flag column and the blob's flag bytes (copy-on-write unless the
  batch owns its blob) and drops the host caches. ``encode_source()``
  hands the blob, offsets and pending order to the device write path.
- **Pickling** (the read ledger's spills) stores host data only: a
  device-backed batch spills its record blob, offsets, reference count,
  pending order and device, and parses the blob again with the parse
  kernel on that device when loaded (raising if it is absent); a host
  batch spills its ``ReadBatch``.
- **Telemetry** (the reference's names): ``columnar.batch.build`` /
  ``fetch`` / ``compact`` spans, the ``columnar.batch.materializations``
  counter (host parses of the records), the
  ``columnar.batch.resident_bytes`` gauge and ``track_hbm`` of the fixed
  columns. ``release()`` books the d2h the lazy fetch skipped (fixed
  columns never fetched, and what a device consumer used in place:
  flagstat's flag column, the sort keys) into
  ``device.d2h_avoided_bytes`` and a ``columnar.batch.release`` span.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from disq_tpu_torch.bam.columnar import FIXED_COLUMNS, RAGGED_COLUMNS, ReadBatch
from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime.tracing import (
    counter,
    device_span,
    observe_gauge,
    record_span,
    span,
    track_hbm,
)

_stats_lock = threading.Lock()
_resident_live_bytes = 0


def _note_resident(delta: int) -> None:
    """Adjust the live resident-column bytes (the
    ``columnar.batch.resident_bytes`` gauge) and ``track_hbm``."""
    global _resident_live_bytes
    with _stats_lock:
        _resident_live_bytes = max(0, _resident_live_bytes + delta)
        live = _resident_live_bytes
    track_hbm(delta)
    observe_gauge("columnar.batch.resident_bytes", live)

_COL_DTYPE = {
    "refid": np.int32, "pos": np.int32, "mapq": np.uint8,
    "bin": np.uint16, "flag": np.uint16, "next_refid": np.int32,
    "next_pos": np.int32, "tlen": np.int32,
}


class DeviceParseFault(ValueError):
    """The device record check flagged a record that the host parser
    accepts: a fault of the device parse, not corrupt input."""


def record_check(cols: Dict[str, torch.Tensor], rec_len: torch.Tensor,
                 n_ref: Optional[int]) -> bool:
    """Eager corrupt-record test mirroring the host parser
    (``bam/codec.decode_records``): impossible refIDs (when ``n_ref`` is
    known) or record sections overflowing their record. One boolean
    crosses d2h."""
    lseq = cols["l_seq"].to(torch.int64)
    neg = lseq < 0
    over = lseq > rec_len
    lseq_c = torch.minimum(lseq.clamp(min=0), rec_len)
    head = (36 + cols["l_read_name"].to(torch.int64)
            + 4 * cols["n_cigar"].to(torch.int64) + (lseq_c + 1) // 2)
    bad = neg | over | (head > rec_len - lseq_c)
    if n_ref is not None:
        refid, nref = cols["refid"], cols["next_refid"]
        bad = bad | (refid >= n_ref) | (refid < -1) \
            | (nref >= n_ref) | (nref < -1)
    return bool(bad.any())


def coordinate_key(refid: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """int64 coordinate key, the same value as ``sort/coordinate.
    coordinate_keys``: (refid, unmapped −1 mapped to 0x7FFFFFFF) in the
    high 32 bits, pos + 1 in the low 32."""
    rid = refid.to(torch.int64)
    rid = torch.where(rid < 0, torch.full_like(rid, 0x7FFFFFFF), rid)
    return (rid << 32) | ((pos.to(torch.int64) + 1) & 0xFFFFFFFF)


class ColumnarBatch:
    """N alignment records with fixed columns on a device (or a thin
    wrapper over a host ``ReadBatch``). Duck-compatible with
    ``ReadBatch``: every column attribute returns a host numpy array."""

    def __init__(self) -> None:
        self._n = 0
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._blob: Optional[np.ndarray] = None
        self._blob_parts: Optional[List[np.ndarray]] = None
        self._offsets: Optional[np.ndarray] = None
        self._n_ref: Optional[int] = None
        self._cache: Dict[str, np.ndarray] = {}
        self._ragged_rb: Optional[ReadBatch] = None
        self._rb: Optional[ReadBatch] = None
        # logical record i is blob record _order[i] (a permuted batch)
        self._order: Optional[np.ndarray] = None
        # the blob is this batch's own (a compaction's), so or_flags may
        # patch it in place; otherwise it copies first
        self._blob_owned = False
        # lazy builds and fetches happen once even under threads
        self._lock = threading.RLock()
        # bytes a device consumer used in place, by column or result;
        # booked as avoided d2h at release unless fetched after all
        self._consumed: Dict[str, int] = {}
        self._resident = 0   # bytes of device columns this batch holds
        self._released = False

    # -- construction -------------------------------------------------------

    @classmethod
    def from_host(cls, batch: ReadBatch) -> "ColumnarBatch":
        self = cls()
        self._n = batch.count
        self._rb = batch
        self._ragged_rb = batch
        return self

    @classmethod
    def from_blob(
        cls,
        blob: np.ndarray,
        offsets: np.ndarray,
        device_blob: torch.Tensor,
        n_ref: Optional[int] = None,
        origin: int = 0,
    ) -> "ColumnarBatch":
        """Parse the records at ``offsets`` into columns on
        ``device_blob``'s device, in place from ``device_blob`` (the
        inflate kernel's output, rebased by ``origin``); ``blob`` is its
        host copy, kept for the ragged columns. Raises ``ValueError``
        like the host parser on a corrupt record, and
        ``DeviceParseFault`` when only the device check flags one."""
        from disq_tpu_torch.runtime.device_pipeline import (
            parse_columns_resident,
            upload,
        )

        n = len(offsets) - 1
        if n <= 0:
            return cls.from_host(ReadBatch.empty())
        self = cls()
        self._n = n
        self._blob = blob
        self._offsets = np.asarray(offsets, dtype=np.int64)
        self._n_ref = n_ref
        with span("columnar.batch.build", records=n,
                  bytes=int(self._offsets[-1])):
            cols = parse_columns_resident(device_blob, self._offsets, origin)
        rec_len = upload(np.diff(self._offsets), device_blob.device)
        if record_check(cols, rec_len, n_ref):
            # the host parser is the authority on the error message
            from disq_tpu_torch.bam.codec import decode_records

            decode_records(blob, self._offsets, n_ref=n_ref)
            raise DeviceParseFault(
                "device record check flagged a record that the host "
                "parser accepts")
        self._set_dev({k: cols[k] for k in FIXED_COLUMNS})
        return self

    def _set_dev(self, dev: Dict[str, torch.Tensor]) -> None:
        """Hold ``dev`` as this batch's device columns, booked as
        resident."""
        self._dev = dev
        self._resident = sum(t.numel() * t.element_size()
                             for t in dev.values())
        _note_resident(self._resident)

    # -- identity -----------------------------------------------------------

    @property
    def device_backed(self) -> bool:
        return self._dev is not None

    @property
    def device(self) -> Optional[torch.device]:
        return None if self._dev is None else self._dev["flag"].device

    @property
    def count(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    def device_columns(self) -> Dict[str, torch.Tensor]:
        """The fixed columns as device int32 tensors (no copy)."""
        if self._dev is None:
            raise ValueError("host-backed batch has no device columns")
        return dict(self._dev)

    # -- lazy column access -------------------------------------------------

    def _fetch_col(self, name: str) -> np.ndarray:
        arr = self._cache.get(name)
        if arr is not None:
            return arr
        with self._lock:
            arr = self._cache.get(name)
            if arr is not None:
                return arr
            if self._dev is None:
                if self._rb is not None:
                    return getattr(self._rb, name)
                if self._blob is not None or self._blob_parts:
                    return getattr(self._ragged_source(), name)
                raise RuntimeError(
                    f"column {name!r} of a released ColumnarBatch")
            col = self._dev[name]
            with span("columnar.batch.fetch", column=name,
                      bytes=col.numel() * col.element_size()):
                raw = col.cpu().numpy()
            if col.is_cuda:
                counters.book_transfer("d2h", raw.nbytes)
            arr = raw.astype(_COL_DTYPE[name])
            self._cache[name] = arr
            # a column that crossed d2h after all is no longer avoided
            self._consumed.pop(name, None)
            return arr

    def _consume_on_device(self, key: str, nbytes: int) -> None:
        """Mark a column (or a derived result) used on the device without
        a host fetch: booked as avoided d2h at release, unless a later
        fetch brings it to the host after all."""
        with self._lock:
            if key not in self._consumed and key not in self._cache:
                self._consumed[key] = nbytes

    refid = property(lambda self: self._fetch_col("refid"))
    pos = property(lambda self: self._fetch_col("pos"))
    mapq = property(lambda self: self._fetch_col("mapq"))
    bin = property(lambda self: self._fetch_col("bin"))
    flag = property(lambda self: self._fetch_col("flag"))
    next_refid = property(lambda self: self._fetch_col("next_refid"))
    next_pos = property(lambda self: self._fetch_col("next_pos"))
    tlen = property(lambda self: self._fetch_col("tlen"))

    # -- ragged columns (host blob, parsed lazily once) ---------------------

    def _host_blob(self) -> Optional[np.ndarray]:
        with self._lock:
            if self._blob is None and self._blob_parts is not None:
                self._blob = np.concatenate(self._blob_parts)
                self._blob_parts = None
            return self._blob

    def _ragged_source(self) -> ReadBatch:
        if self._ragged_rb is None:
            with self._lock:
                if self._ragged_rb is None:
                    from disq_tpu_torch.bam.codec import decode_records

                    rb = decode_records(self._host_blob(), self._offsets,
                                        n_ref=self._n_ref)
                    if self._order is not None:
                        rb = rb.take(self._order)
                    self._ragged_rb = rb
                    counter("columnar.batch.materializations").inc()
        return self._ragged_rb

    def __getattr__(self, name: str):
        if name in RAGGED_COLUMNS:
            return getattr(self._ragged_source(), name)
        raise AttributeError(name)

    # -- ReadBatch interop --------------------------------------------------

    def to_read_batch(self) -> ReadBatch:
        """One plain ``ReadBatch``. The ragged columns need the host
        parse anyway, and its fixed columns equal the device-parsed ones
        (the parity contract), so no fixed column is fetched for this:
        they are cached from the host parse, booked neither as moved nor
        as avoided."""
        if self._rb is None:
            with self._lock:
                if self._rb is None:
                    rag = self._ragged_source()
                    if self._dev is not None:
                        for name in FIXED_COLUMNS:
                            if name not in self._cache:
                                self._cache[name] = getattr(rag, name)
                                self._consumed.pop(name, None)
                    self._rb = rag
        return self._rb

    def take(self, indices: np.ndarray) -> ReadBatch:
        return self.to_read_batch().take(indices)

    # -- device transforms --------------------------------------------------

    def _gathered(self, indices: np.ndarray) -> Dict[str, torch.Tensor]:
        """The fixed columns gathered by ``indices`` on their device (one
        index upload)."""
        from disq_tpu_torch.runtime.device_pipeline import upload

        idx = upload(np.asarray(indices, dtype=np.int64), self.device)
        return {name: torch.index_select(self._dev[name], 0, idx)
                for name in FIXED_COLUMNS}

    def permuted(self, order: np.ndarray) -> "ColumnarBatch":
        """The records in ``order``, still device-backed: the fixed
        columns are gathered on the device, the host blob is shared and
        the order is applied when the ragged columns are parsed. A
        host-backed batch gives a host-backed result."""
        order = np.asarray(order, dtype=np.int64)
        if len(order) != self._n:
            raise ValueError(
                f"permutation of {len(order)} over {self._n} records")
        if self._dev is None or self._offsets is None:
            return ColumnarBatch.from_host(self.to_read_batch().take(order))
        out = ColumnarBatch()
        out._n = self._n
        out._n_ref = self._n_ref
        out._set_dev(self._gathered(order))
        with self._lock:
            out._blob, out._blob_parts = self._blob, self._blob_parts
        out._offsets = self._offsets
        out._order = self._order[order] if self._order is not None else order
        return out

    def filter(self, mask: np.ndarray) -> "ReadBatch | ColumnarBatch":
        """The records where ``mask`` is true. A device-backed batch
        stays device-backed: the kept rows of the fixed columns are
        gathered on the device, and the host blob is compacted to the
        kept records (the pending order folded in). A host-backed
        batch filters its ``ReadBatch``."""
        if self._dev is None or self._offsets is None:
            return self.to_read_batch().filter(mask)
        keep = np.nonzero(np.asarray(mask))[0]
        if len(keep) == 0:
            return ColumnarBatch.from_host(ReadBatch.empty())
        from disq_tpu_torch.bam.columnar import segment_gather

        with span("columnar.batch.compact", records=self._n, kept=len(keep)):
            src = self._order[keep] if self._order is not None else keep
            out = ColumnarBatch()
            out._n = len(keep)
            out._n_ref = self._n_ref
            out._set_dev(self._gathered(keep))
            out._blob, out._offsets = segment_gather(self._host_blob(),
                                                     self._offsets, src)
            out._blob_owned = True
        return out

    def or_flags(self, mask: np.ndarray, bits: int = 0x400) -> None:
        """OR ``bits`` into the flag of every record where ``mask`` is
        true, in place: duplicate marking's write-back. Three views
        change together: the device flag column (a new tensor, from one
        index upload), the host record blob's flag bytes at ``off + 18``
        / ``19`` (copied first unless this batch owns its blob) and the
        host caches, dropped so the next fetch derives them again. The
        blob patch is what makes a resident chain's written BAM equal to
        a host-marked one's."""
        idx = np.nonzero(np.asarray(mask))[0]
        if len(idx) == 0:
            return
        lo_b, hi_b = bits & 0xFF, (bits >> 8) & 0xFF
        with self._lock:
            if self._offsets is not None:
                blob = self._host_blob()
                if not self._blob_owned:
                    blob = blob.copy()
                    self._blob_owned = True
                src = self._order[idx] if self._order is not None else idx
                off = self._offsets[src]
                if lo_b:
                    blob[off + 18] |= np.uint8(lo_b)
                if hi_b:
                    blob[off + 19] |= np.uint8(hi_b)
                self._blob = blob
            if self._dev is not None:
                from disq_tpu_torch.runtime.device_pipeline import upload

                flag = self._dev["flag"]
                at = upload(idx.astype(np.int64), flag.device)
                self._dev["flag"] = flag.index_put(
                    (at,), flag.index_select(0, at) | bits)
            elif self._rb is not None:
                self._rb.flag[idx] |= np.uint16(bits)
            # the host-side views are stale now
            self._cache.pop("flag", None)
            if self._ragged_rb is not None and self._offsets is not None:
                self._ragged_rb = None
                self._rb = None

    def encode_source(self):
        """``(host record blob, record offsets, pending order or None)``,
        what the device write path gathers the sorted records from
        (``runtime/device_write.py``), or None when this batch holds no
        record blob (a wrapper of a host ``ReadBatch``)."""
        with self._lock:
            if self._offsets is None or (
                    self._blob is None and self._blob_parts is None):
                return None
        return self._host_blob(), self._offsets, self._order

    # -- pickling (the read ledger's spills) --------------------------------

    def __reduce__(self):
        if self._dev is not None and self._offsets is not None:
            return (_rebuild_from_blob,
                    (self._host_blob(), self._offsets, self._n_ref,
                     self._order, str(self.device)))
        return (_rebuild_from_host, (self.to_read_batch(),))

    def slice(self, start: int, stop: int) -> ReadBatch:
        return self.to_read_batch().slice(start, stop)

    def alignment_ends(self) -> np.ndarray:
        return self._ragged_source().alignment_ends()

    # -- device consumers ---------------------------------------------------

    def flagstat(self) -> Dict[str, int]:
        """flagstat over the device flag column: 12 counts cross d2h."""
        from disq_tpu_torch.ops.flagstat import flagstat_counts

        if self._dev is None:
            return flagstat_counts(np.asarray(self.flag))
        out = flagstat_counts(self._dev["flag"])
        self._consume_on_device("flag", 4 * self._n)
        return out

    def sort_permutation(self) -> np.ndarray:
        """Coordinate-sort permutation: keys and one stable sort on the
        device; only the int64 order crosses d2h. Equal to
        ``np.argsort(coordinate_keys(refid, pos), kind="stable")``."""
        if self._dev is None:
            from disq_tpu_torch.sort.coordinate import coordinate_keys

            return np.argsort(coordinate_keys(self.refid, self.pos),
                              kind="stable")
        with device_span("device.kernel", kernel="coordinate_keys",
                         records=self._n) as fence:
            key = coordinate_key(self._dev["refid"], self._dev["pos"])
            order = fence.sync(torch.sort(key, stable=True).indices)
        order = order.cpu().numpy()
        if key.is_cuda:
            counters.book_transfer("d2h", order.nbytes)
        # the 8-byte-per-record keys stayed on the device
        self._consume_on_device("sort_keys", 8 * self._n)
        return order

    # -- concat / release ---------------------------------------------------

    @classmethod
    def concat(cls, batches: Sequence) -> "ReadBatch | ColumnarBatch":
        """Concatenate shards: all device-backed ⇒ the fixed columns
        concatenate on the device and host blobs join lazily; otherwise
        everything materializes into one host ``ReadBatch``. Consuming:
        device-backed inputs are released into the result."""
        batches = [b for b in batches if len(b)]
        if not batches:
            return ReadBatch.empty()
        if len(batches) == 1:
            return batches[0]
        if all(isinstance(b, ColumnarBatch) and b.device_backed
               for b in batches):
            self = cls()
            self._n = sum(b._n for b in batches)
            self._n_ref = batches[0]._n_ref
            self._set_dev({name: torch.cat([b._dev[name] for b in batches])
                           for name in FIXED_COLUMNS})
            parts: List[np.ndarray] = []
            for b in batches:
                parts.extend(b._blob_parts if b._blob_parts is not None
                             else [b._blob])
            self._blob_parts = parts
            offs = np.zeros(self._n + 1, dtype=np.int64)
            at, base = 1, 0
            for b in batches:
                offs[at: at + b._n] = b._offsets[1:] + base
                at += b._n
                base += int(b._offsets[-1])
            self._offsets = offs
            if any(b._order is not None for b in batches):
                orders, at = [], 0
                for b in batches:
                    orders.append(at + (b._order if b._order is not None
                                        else np.arange(b._n)))
                    at += b._n
                self._order = np.concatenate(orders)
            for b in batches:
                # the inputs live on inside the concat: no avoidance
                b._release(book_avoided=False)
            return self
        return ReadBatch.concat([as_read_batch(b) for b in batches])

    def release(self) -> None:
        """Drop the device columns (host caches and blob stay). The fixed
        columns never fetched, and what device consumers used in place,
        book into ``device.d2h_avoided_bytes``, and a
        ``columnar.batch.release`` span records the batch's total."""
        self._release(book_avoided=True)

    def _release(self, book_avoided: bool) -> None:
        with self._lock:
            if self._released or self._dev is None:
                self._released = True
                return
            self._released = True
            if book_avoided:
                avoided = sum(4 * self._n for name in FIXED_COLUMNS
                              if name not in self._cache
                              and name not in self._consumed)
                total = avoided + sum(self._consumed.values())
                if total:
                    counter("device.d2h_avoided_bytes").inc(total)
                record_span("columnar.batch.release", 0.0, records=self._n,
                            avoided_bytes=total)
            self._dev = None
            if self._resident:
                _note_resident(-self._resident)
                self._resident = 0


def _rebuild_from_blob(blob: np.ndarray, offsets: np.ndarray,
                       n_ref: Optional[int], order: Optional[np.ndarray],
                       device: str) -> ColumnarBatch:
    """Unpickle a spilled device-backed batch: the blob goes up to
    ``device`` once and the parse kernel reads it from offset 0. A
    ``cuda`` spill loaded without CUDA raises."""
    from disq_tpu_torch.runtime.device_pipeline import upload
    from disq_tpu_torch.util import resolve_device

    dev = resolve_device(device)
    batch = ColumnarBatch.from_blob(blob, offsets, upload(blob, dev),
                                    n_ref=n_ref)
    if order is not None:
        batch = batch.permuted(order)
    return batch


def _rebuild_from_host(batch: ReadBatch) -> ColumnarBatch:
    """Unpickle a spilled host-backed batch."""
    return ColumnarBatch.from_host(batch)


def as_read_batch(batch) -> ReadBatch:
    """Whatever a source emitted, as a plain host ``ReadBatch``."""
    if isinstance(batch, ColumnarBatch):
        return batch.to_read_batch()
    return batch
