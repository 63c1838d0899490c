"""CramSource — the split-parallel CRAM read path, run split by split.

Reference parity: ``impl/formats/cram/CramSource.java``: container start
offsets are enumerated by walking container headers (payloads skipped);
containers are assigned to byte-range splits by the "container start in
[start, end)" first-owner rule; each split decodes its containers with
the reference supplied via ``reference_source_path`` (required for
reference-compressed data).

On ``cuda`` (or with resident decode asked for on the CPU) a split
first parses and CRC-checks every block of its containers, then decodes
all their order-0 rANS streams in one launch (kernel B3, or B5 under
``DISQ_TPU_TORCH_DEVICE_RANS=legacy``); the other blocks decompress on
the host and the records assemble on the host, as in the reference.
Otherwise every block decodes with the host codec. The result is a host
``ReadBatch``. A corrupt container raises ``CorruptBlockError`` with its
offset (the strict policy); a missing reference raises
``MissingReferenceError``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from disq_tpu_torch.bam.columnar import ReadBatch
from disq_tpu_torch.bam.header import SamHeader
from disq_tpu_torch.cram.codec import read_stored_blocks, records_from_blocks
from disq_tpu_torch.cram.io import Cursor
from disq_tpu_torch.cram.structure import (
    Block,
    ContainerHeader,
    FILE_HEADER,
    read_container_header_at,
    read_file_definition,
    walk_container_offsets,
)
from disq_tpu_torch.fsw.filesystem import (
    FileSystemWrapper,
    compute_path_splits,
    resolve_path,
)
from disq_tpu_torch.runtime.errors import MissingReferenceError, corrupt

# errors that are not corrupt input: configuration, and CUDA build or
# launch failures
_NOT_CORRUPTION = (MissingReferenceError, RuntimeError)


def read_cram_header(fs: FileSystemWrapper, path: str) -> SamHeader:
    """SAM header from the first (FILE_HEADER) container."""
    head = fs.read_range(path, 0, min(fs.get_file_length(path), 1 << 20))
    _, off = read_file_definition(head)
    cur = Cursor(head, off)
    hdr = ContainerHeader.read(cur)
    need = cur.off + hdr.length
    if need > len(head):
        head = fs.read_range(path, 0, need)
        cur = Cursor(head, off)
        hdr = ContainerHeader.read(cur)
    block = Block.read(cur)
    if block.content_type != FILE_HEADER:
        raise ValueError("first CRAM container does not hold the SAM header")
    (l_text,) = struct.unpack_from("<i", block.data, 0)
    text = block.data[4:4 + l_text].decode(errors="replace").rstrip("\x00")
    return SamHeader.from_text(text)


class CramSource:
    def __init__(self, storage):
        self._storage = storage

    @property
    def split_size(self) -> int:
        return self._storage._split_size

    def _decode_device(self):
        """The device the order-0 rANS streams decode on: ``cuda``
        always; the CPU (plain versions) only when resident decode was
        asked for; None for the host codec."""
        device = self._storage._resolved_device()
        if device.type == "cuda" or self._storage._resident_decode:
            return device
        return None

    def get_reads(self, path: str):
        from disq_tpu_torch.api import ReadsDataset
        from disq_tpu_torch.cram.refsource import fetcher_for_storage

        fs, path = resolve_path(path)
        header = read_cram_header(fs, path)
        ref_fetch = fetcher_for_storage(self._storage, header)
        data_containers = [(off, hdr) for off, hdr in
                           walk_container_offsets(fs, path)[1:]
                           if not hdr.is_eof]
        device = self._decode_device()
        batches: List[ReadBatch] = []
        for i, s in enumerate(compute_path_splits(fs, path, self.split_size)):
            owned = [(off, hdr) for off, hdr in data_containers
                     if s.start <= off < s.end]
            items = self._fetch_split_containers(fs, path, owned, i)
            batches.extend(self._decode_split_containers(
                items, ref_fetch, path, i, device))
        return ReadsDataset(header=header, reads=ReadBatch.concat(batches))

    # -- internals ----------------------------------------------------------

    def _fetch_split_containers(self, fs, path: str, owned,
                                shard_id: int) -> List[Tuple[int, bytes]]:
        """Range-read every container payload this split owns:
        ``[(offset, payload bytes), …]``."""
        length = fs.get_file_length(path)
        items = []
        for off, _hdr in owned:
            try:
                h, hdr_size = read_container_header_at(fs, path, off, length)
            except (IndexError, ValueError, struct.error) as e:
                raise corrupt(e, kind="CRAM container", path=path,
                              shard_id=shard_id, block_offset=off) from e
            items.append((off, fs.read_range(path, off + hdr_size, h.length)))
        return items

    def _decode_split_containers(self, items, ref_fetch, path: str,
                                 shard_id: int, device) -> List[ReadBatch]:
        """Decode the staged containers of one split (strict policy):
        parse and CRC-check every block, decode every order-0 rANS
        stream in one launch on ``device`` (when given), then decompress
        the rest and assemble the records container by container."""
        def fail(e: BaseException, off: int):
            return corrupt(e, kind="CRAM container", path=path,
                           shard_id=shard_id, block_offset=off)

        stored = []
        for off, payload in items:
            try:
                stored.append(read_stored_blocks(payload))
            except _NOT_CORRUPTION:
                raise
            except Exception as e:  # noqa: BLE001 — corrupt container
                raise fail(e, off) from e
        decoded: Dict[Tuple[int, int], bytes] = {}
        if device is not None:
            decoded = self._decode_rans0(items, stored, device, fail)
        batches = []
        for ci, (off, _payload) in enumerate(items):
            try:
                blocks = [b.decompress(decoded.get((ci, bi)))
                          for bi, b in enumerate(stored[ci])]
                batches.append(records_from_blocks(blocks, ref_fetch))
            except _NOT_CORRUPTION:
                raise
            except Exception as e:  # noqa: BLE001 — corrupt container
                raise fail(e, off) from e
        return batches

    @staticmethod
    def _decode_rans0(items, stored, device, fail
                      ) -> Dict[Tuple[int, int], bytes]:
        """Every order-0 rANS stream of the split, decoded in one launch:
        ``{(container index, block index): bytes}``. A stream that does
        not parse or that the kernel flags raises for its container."""
        from disq_tpu_torch.cram.rans import rans0_decode_streams

        keys = [(ci, bi) for ci, blocks in enumerate(stored)
                for bi, b in enumerate(blocks) if b.is_rans0]
        if not keys:
            return {}
        try:
            outs = rans0_decode_streams(
                [stored[ci][bi].comp for ci, bi in keys], device)
        except _NOT_CORRUPTION:
            raise
        except Exception as e:  # noqa: BLE001 — corrupt stream
            k: Optional[int] = getattr(e, "stream", None)
            off = items[keys[k][0] if k is not None else 0][0]
            raise fail(e, off) from e
        return dict(zip(keys, outs))
