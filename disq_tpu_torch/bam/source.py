"""BamSource — the split-parallel BAM read path, run split by split.

The header is read on the host; the file is cut into byte-range splits;
each split resolves its first whole-record boundary — from the ``.sbi``
splitting index when present, else by the ``BgzfBlockGuesser`` +
``BamRecordGuesser`` chain — and decodes records from its own boundary
up to the next split's, reading past its byte-range end to finish the
straddling record.

On ``cuda`` (or with resident decode asked for on the CPU) a split's
blocks inflate with the device kernel into one device blob, the record
offsets are scanned on the blob's host copy, and the parse kernel turns
the device blob into device columns in place. Otherwise the split
inflates on the host and parses with the host codec. Corrupt input
raises ``CorruptBlockError`` with its coordinates (the strict policy).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from disq_tpu_torch.bam.codec import decode_records, scan_record_offsets
from disq_tpu_torch.bam.columnar import ReadBatch
from disq_tpu_torch.bam.guesser import BamRecordGuesser
from disq_tpu_torch.bam.header import SamHeader
from disq_tpu_torch.bgzf.block import BGZF_EOF_MARKER, make_virtual_offset
from disq_tpu_torch.bgzf.codec import (
    BgzfReader,
    inflate_blocks,
    inflate_blocks_device,
)
from disq_tpu_torch.bgzf.guesser import (
    BgzfBlockGuesser,
    raise_bad_header,
    walk_blocks_collect,
)
from disq_tpu_torch.fsw.filesystem import (
    FileSystemWrapper,
    PathSplit,
    compute_path_splits,
    resolve_path,
)
from disq_tpu_torch.index.sbi import SbiIndex
from disq_tpu_torch.runtime.errors import (
    TruncatedReadError,
    corrupt,
    inflate_blocks_strict,
)


def read_header(fs: FileSystemWrapper, path: str) -> Tuple[SamHeader, int]:
    """(header, virtual offset of the first record)."""
    with fs.open(path) as raw:
        r = BgzfReader(raw)
        header = SamHeader.from_bam_stream(r)
        return header, r.tell_virtual()


class BamSource:
    def __init__(self, storage):
        self._storage = storage

    @property
    def split_size(self) -> int:
        return self._storage._split_size

    def get_reads(self, path: str):
        from disq_tpu_torch.api import ReadsDataset
        from disq_tpu_torch.runtime.columnar import ColumnarBatch

        fs, path = resolve_path(path)
        header, first_voffset = read_header(fs, path)
        batches = self.read_split_batches(fs, path, header, first_voffset)
        return ReadsDataset(header=header, reads=ColumnarBatch.concat(batches))

    # -- split machinery ----------------------------------------------------

    def read_split_batches(self, fs: FileSystemWrapper, path: str,
                           header: SamHeader, first_voffset: int) -> List:
        """One batch per split, in split order."""
        splits = compute_path_splits(fs, path, self.split_size)
        sbi = self._try_load_sbi(fs, path)
        bounds = self._split_boundaries(fs, path, header, first_voffset,
                                        splits, sbi)
        return [
            self._decode_fetched(
                header, self._fetch_range(fs, path, bounds[i], bounds[i + 1], i),
                path, i)
            for i in range(len(splits))
        ]

    def _try_load_sbi(self, fs: FileSystemWrapper, path: str) -> Optional[SbiIndex]:
        sbi_path = path + ".sbi"
        if fs.exists(sbi_path):
            return SbiIndex.from_bytes(fs.read_all(sbi_path))
        return None

    def _data_end_voffset(self, fs: FileSystemWrapper, path: str) -> int:
        """Virtual offset one past the last record: EOF minus terminator."""
        length = fs.get_file_length(path)
        tail = fs.read_range(path, max(0, length - len(BGZF_EOF_MARKER)),
                             len(BGZF_EOF_MARKER))
        end = length - len(BGZF_EOF_MARKER) if tail == BGZF_EOF_MARKER else length
        return make_virtual_offset(end, 0)

    def _split_boundaries(self, fs, path, header, first_voffset,
                          splits: List[PathSplit],
                          sbi: Optional[SbiIndex]) -> List[int]:
        """Virtual offsets b[0..n]: split i decodes records in
        [b[i], b[i+1]); b[0] is the first record, b[n] the end of data."""
        end_vo = self._data_end_voffset(fs, path)
        bounds = [first_voffset]
        for s in splits[1:]:
            if sbi is not None:
                vo = sbi.first_offset_at_or_after(s.start)
            else:
                vo = self._guess_record_voffset(fs, path, header, s.start)
                if vo is None:
                    vo = end_vo
            bounds.append(max(min(vo, end_vo), bounds[-1]))
        bounds.append(end_vo)
        return bounds

    def _guess_record_voffset(self, fs, path, header: SamHeader,
                              file_offset: int) -> Optional[int]:
        """First record boundary at or after ``file_offset``: block
        guesser, then the record guesser over a decompressed window that
        grows until a boundary is found or the window reaches EOF."""
        if file_offset == 0:
            raise ValueError("offset 0 is resolved by the header read")
        block_start = BgzfBlockGuesser(fs, path).guess_block_start(file_offset)
        if block_start is None:
            return None
        g = BamRecordGuesser(header.n_ref, [s.length for s in header.sequences])
        file_length = fs.get_file_length(path)
        window_csize = 4 * 0x10000
        while True:
            try:
                blocks, data = walk_blocks_collect(
                    fs, path, block_start, block_start + window_csize,
                    file_length)
            except TruncatedReadError:
                raise
            except ValueError as e:
                raise_bad_header(fs, path, block_start,
                                 block_start + window_csize, file_length, -1, e)
            if not blocks:
                return None
            try:
                window = inflate_blocks(data, blocks, base=block_start)
            except ValueError as e:
                inflate_blocks_strict(data, blocks, block_start, path, -1)
                raise e
            u = g.find_first_record(window)
            if u is not None:
                # window offset → (block, within): ISIZE is verified on
                # inflate, so cumulative usize == window offsets
                acc = 0
                for b in blocks:
                    if u < acc + b.usize:
                        return make_virtual_offset(b.pos, u - acc)
                    acc += b.usize
                return None
            if blocks[-1].end >= file_length:
                return None
            window_csize *= 4

    def _fetch_range(self, fs, path: str, lo_voffset: int, hi_voffset: int,
                     shard_id: int) -> Optional[Tuple]:
        """Range-read and walk the compressed blocks covering [lo, hi)
        virtual space — from lo's block through hi's block, past the
        split's byte-range end when a record straddles it."""
        if hi_voffset <= lo_voffset:
            return None
        lo_block = lo_voffset >> 16
        hi_block, hi_u = hi_voffset >> 16, hi_voffset & 0xFFFF
        length = fs.get_file_length(path)
        want_end = max(hi_block + (1 if hi_u > 0 else 0), lo_block + 1)
        try:
            blocks, data = walk_blocks_collect(fs, path, lo_block, want_end,
                                               length)
        except TruncatedReadError:
            raise
        except ValueError as e:
            raise_bad_header(fs, path, lo_block, want_end, length, shard_id, e)
        return blocks, data, lo_voffset, hi_voffset

    def _resident(self) -> bool:
        """The device route: always on ``cuda``; on the CPU only when
        resident decode was asked for."""
        return self._storage._resolved_device().type == "cuda" or \
            self._storage._resident_decode

    def _decode_fetched(self, header: SamHeader, fetched: Optional[Tuple],
                        path: str, shard_id: int):
        """Inflate + record-decode a staged range (strict policy)."""
        if fetched is None:
            return ReadBatch.empty()
        blocks, data, lo_voffset, hi_voffset = fetched
        lo_block, lo_u = lo_voffset >> 16, lo_voffset & 0xFFFF
        hi_block, hi_u = hi_voffset >> 16, hi_voffset & 0xFFFF
        if not blocks:
            return ReadBatch.empty()
        resident = self._resident()
        device = self._storage._resolved_device()
        dev_blob = None
        try:
            if resident:
                blob, dev_blob = inflate_blocks_device(
                    data, blocks, base=lo_block, device=device)
            else:
                blob = inflate_blocks(data, blocks, base=lo_block)
        except ValueError as first_err:
            # a flagged or CRC-failing block: name it (raises), or — when
            # every block decodes alone — surface the route's own error
            inflate_blocks_strict(data, blocks, lo_block, path, shard_id)
            raise first_err
        if hi_u > 0:
            end_u = sum(b.usize for b in blocks if b.pos < hi_block) + hi_u
        else:
            end_u = len(blob)
        record_bytes = blob[lo_u:end_u]
        try:
            offsets = scan_record_offsets(record_bytes)
            if resident:
                from disq_tpu_torch.runtime.columnar import ColumnarBatch

                return ColumnarBatch.from_blob(
                    record_bytes, offsets, dev_blob, n_ref=header.n_ref,
                    origin=lo_u)
            return decode_records(record_bytes, offsets, n_ref=header.n_ref)
        except ValueError as e:
            raise corrupt(e, kind="record run", path=path, shard_id=shard_id,
                          block_offset=lo_block,
                          virtual_offset=lo_voffset) from e
