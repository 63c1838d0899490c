"""The device write path: sort → record encode → deflate on the device.

The write-side mirror of the device read: a sorted device-backed
``ColumnarBatch`` (``ColumnarBatch.permuted``) encodes and deflates its
shards on its device, and only compressed blocks cross d2h.

- ``ResidentShardEncoder`` uploads the batch's host record blob once per
  write. The write pipeline's workers share it and only read it.
- ``encode_shard(lo, hi)`` gathers records [lo, hi) of the sorted batch
  into one contiguous payload on the device with kernel W1
  (``ops/record_gather.py``): the BAM encode of an unmodified record is
  its decoded bytes, so the gather is the record encode. Only the
  shard's source starts and destination offsets go up.
- ``EncodedShard.deflate`` codes that payload with kernel W2
  (``ops/deflate.py``) under one table from the shard's histogram, in
  one launch over all its BGZF blocks, and finalizes the blocks on the
  host.

The host keeps what it already has: the shard's bytes gathered from the
host blob (``host_payload``) give the CRC32 and ISIZE footers and the
expanded lanes' zlib route, so no device byte comes back for them. The
table's histogram is counted on the device (256 counts come back).

Armed by ``DisqOptions.device_deflate`` / ``DISQ_TPU_TORCH_DEVICE_DEFLATE``;
off, this module is not imported.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from disq_tpu_torch.bgzf.block import BGZF_MAX_PAYLOAD
from disq_tpu_torch.ops import deflate as DF
from disq_tpu_torch.runtime.tracing import device_span, span, track_hbm


class EncodedShard:
    """One shard's sorted records as one payload on the device, and the
    shard-local record offsets the voffset and index arithmetic needs."""

    def __init__(self, encoder: "ResidentShardEncoder", lo: int, hi: int,
                 payload: Optional[torch.Tensor], nbytes: int,
                 record_offsets: np.ndarray) -> None:
        self._encoder = encoder
        self._lo, self._hi = lo, hi
        self._payload = payload
        self.nbytes = nbytes
        #: (n+1,) shard-local uncompressed record offsets
        self.record_offsets = record_offsets
        self.n_blocks = -(-nbytes // BGZF_MAX_PAYLOAD)
        self._host: Optional[np.ndarray] = None
        self._table: Optional[DF.DeflateTable] = None

    def host_payload(self) -> np.ndarray:
        """The shard's bytes gathered from the host record blob (one
        memcpy per record): the same bytes as the device payload."""
        if self._host is None:
            from disq_tpu_torch.bam.columnar import segment_gather

            enc = self._encoder
            self._host, _ = segment_gather(enc._blob_u8, enc._offsets,
                                           enc._order[self._lo: self._hi])
        return self._host

    def table(self) -> DF.DeflateTable:
        """The shard's Huffman table: the payload's histogram, counted on
        the device, and the EOB once per block."""
        if self._table is None:
            self._table = DF.DeflateTable(DF.histogram(self._payload),
                                          self.n_blocks)
        return self._table

    def encode(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Kernel W2 over every block of the payload: (body rows, end
        bits) on the device."""
        return DF.encode_blocks(self._payload, self.nbytes, self.table())

    def deflate(self) -> Tuple[bytes, np.ndarray]:
        """(compressed bytes, per-block compressed sizes), the
        ``deflate_blob`` contract: W2, the end bits and the rows'
        occupied prefix d2h, the header, EOB and framing on the host;
        expanded lanes deflate again on the host (zlib-6 or stored)."""
        if self.nbytes == 0:
            return b"", np.zeros(0, dtype=np.int64)
        blocks: List[bytes] = [b""] * self.n_blocks
        with span("device.deflate.encode", blocks=self.n_blocks):
            table = self.table()
            bodies, end = self.encode()
            body_h, end_h = DF.fetch(bodies, end, table)
            del bodies, end
            host = self.host_payload()
            payloads = [host[b * BGZF_MAX_PAYLOAD:
                             (b + 1) * BGZF_MAX_PAYLOAD]
                        for b in range(self.n_blocks)]

            def host_route(flagged: List[int]) -> None:
                for j in flagged:
                    blocks[j] = DF.host_block(payloads[j])

            DF.finalize_chunk(body_h, end_h, table, payloads,
                              blocks.__setitem__, host_route)
        # only now: a step retried after a failure above finds its payload
        self.release()
        return DF.join_blocks(blocks)

    def release(self) -> None:
        """Drop the device payload."""
        self._payload = None


class ResidentShardEncoder:
    """One write's resident encode: the record blob uploaded once, then
    one W1 gather per shard. Built from a ``ColumnarBatch`` with an
    ``encode_source()``; safe for the write pipeline's workers, which
    only read the shared blob."""

    def __init__(self, batch, device) -> None:
        from disq_tpu_torch.runtime.device_pipeline import upload

        src = batch.encode_source()
        if src is None:
            raise ValueError("batch holds no host record blob: the device "
                             "write path needs a device-decoded ColumnarBatch")
        blob, offsets, order = src
        self._blob_u8 = np.asarray(blob, dtype=np.uint8)
        self._offsets = np.asarray(offsets, dtype=np.int64)
        n = len(self._offsets) - 1
        self._order = (np.arange(n, dtype=np.int64) if order is None
                       else np.asarray(order, dtype=np.int64))
        lens = np.diff(self._offsets)[self._order]
        self._src_starts = self._offsets[:-1][self._order]
        self._perm_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=self._perm_off[1:])
        self._device = torch.device(device)
        self._blob = upload(self._blob_u8, self._device)
        self._hbm = self._blob_u8.nbytes
        track_hbm(self._hbm)

    def encode_shard(self, lo: int, hi: int) -> EncodedShard:
        """Records [lo, hi) of the sorted batch gathered into one payload
        on the device (kernel W1); only their source starts and
        destination offsets go up."""
        from disq_tpu_torch.ops.record_gather import gather_records
        from disq_tpu_torch.runtime.device_pipeline import upload

        local_off = self._perm_off[lo: hi + 1] - self._perm_off[lo]
        nbytes = int(local_off[-1])
        if hi <= lo or nbytes == 0:
            return EncodedShard(self, lo, hi, None, 0,
                                np.zeros(1, dtype=np.int64))
        starts = upload(self._src_starts[lo:hi], self._device)
        dst = upload(local_off, self._device)
        with device_span("device.kernel", kernel="encode_resident",
                         records=hi - lo) as fence:
            payload = fence.sync(gather_records(self._blob, starts, dst,
                                                nbytes))
        return EncodedShard(self, lo, hi, payload, nbytes, local_off)

    def release(self) -> None:
        """Drop the uploaded blob (the write's parts stage is done)."""
        self._blob = None
        if self._hbm:
            track_hbm(-self._hbm)
            self._hbm = 0


def resident_encoder_for(storage, batch) -> Optional[ResidentShardEncoder]:
    """The encoder of one sink write on ``storage``'s device, or None
    when the device write path is off or the batch has no encode source
    (a host ``ReadBatch``, or a wrapper of one): that batch takes the
    host record encode, and its deflate still runs on the device."""
    from disq_tpu_torch.bgzf.codec import deflate_device_for
    from disq_tpu_torch.runtime.columnar import ColumnarBatch

    device = deflate_device_for(storage)
    if device is None or not isinstance(batch, ColumnarBatch) \
            or batch.encode_source() is None:
        return None
    return ResidentShardEncoder(batch, device)
