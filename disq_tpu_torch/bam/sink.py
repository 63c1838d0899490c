"""BamSink — single-file BAM write with an optional BAI.

Protocol (the reference's): shards write headerless, terminatorless
BGZF parts to a temp dir, each with a part-local BAI fragment; then a
header-only BGZF prefix, the parts and the 28-byte terminator are
concatenated, and the fragments merge by shifting each part's virtual
offsets by its absolute start. Per-record virtual offsets inside a part
are array arithmetic: canonical BGZF blocking puts 65280 payload bytes
in every block, so ``voffset(u) = (block_comp_start[u // 65280] << 16)
| (u % 65280)``.

Shards run through the write pipeline (``runtime/executor.py``):
encode (slice and record encode) → deflate (BGZF blocks, virtual
offsets, BAI fragment) → stage (the part's write, retried on transient
faults), then the merge in shard order. With ``writer_workers > 1`` the
steps of different shards overlap; the bytes are the same at any width.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from disq_tpu_torch.bam.codec import encode_records_with_offsets
from disq_tpu_torch.bam.header import SamHeader
from disq_tpu_torch.bgzf.block import BGZF_EOF_MARKER, BGZF_MAX_PAYLOAD
from disq_tpu_torch.bgzf.codec import compress_to_bgzf, deflate_blob
from disq_tpu_torch.fsw.filesystem import resolve_path
from disq_tpu_torch.index.bai import build_bai, merge_bai_fragments
from disq_tpu_torch.runtime.executor import (
    WriteShardTask,
    run_write_stage,
    write_retrier_for_storage,
    writer_for_storage,
)
from disq_tpu_torch.util import shard_bounds


def voffsets_from_csizes(csizes: np.ndarray, record_offsets: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(start voffsets, end voffsets) of records at uncompressed offsets
    ``record_offsets`` ((N+1,)) in a canonical BGZF stream whose blocks
    have compressed sizes ``csizes``."""
    block_comp_start = np.zeros(len(csizes) + 1, dtype=np.int64)
    np.cumsum(csizes, out=block_comp_start[1:])
    offs = record_offsets.astype(np.int64)
    block_idx = offs // BGZF_MAX_PAYLOAD
    within = offs % BGZF_MAX_PAYLOAD
    voffs = (block_comp_start[block_idx].astype(np.uint64) << np.uint64(16)) \
        | within.astype(np.uint64)
    return voffs[:-1], voffs[1:]


class BamSink:
    """Single-file BAM write."""

    def __init__(self, storage):
        self._storage = storage

    def save(self, dataset, path: str, options: Sequence = ()) -> None:
        from disq_tpu_torch.api import (
            BaiWriteOption,
            SbiWriteOption,
            TempPartsDirectoryWriteOption,
            option_enabled,
        )

        fs, path = resolve_path(path)
        header: SamHeader = dataset.header
        batch = dataset.reads
        write_bai = option_enabled(options, BaiWriteOption)
        if option_enabled(options, SbiWriteOption):
            raise NotImplementedError(
                "SBI writes are not ported to the PyTorch package yet")
        temp_dir = next(
            (o.path for o in options
             if isinstance(o, TempPartsDirectoryWriteOption)),
            path + ".parts",
        )
        if write_bai and header.sort_order != "coordinate":
            raise ValueError(
                "BAI requires a coordinate-sorted header; "
                "sort first (ReadsStorage.write(..., sort=True))")
        n_shards, bounds = shard_bounds(self._storage, batch.count)
        fs.mkdirs(temp_dir)
        try:
            parts = run_write_stage(
                writer_for_storage(self._storage), n_shards,
                lambda k: self._write_task(fs, header, batch, temp_dir,
                                           bounds, k, write_bai))
            self._merge(fs, header, path, temp_dir,
                        [(p, n) for p, n, _ in parts],
                        [f for _, _, f in parts], write_bai)
        finally:
            fs.delete(temp_dir, recursive=True)

    def _write_task(self, fs, header, batch, temp_dir, bounds, k, write_bai):
        """Shard ``k``'s encode, deflate and stage steps; the stage step
        returns (part path, compressed length, BAI fragment or None)."""

        def encode():
            part = batch.slice(int(bounds[k]), int(bounds[k + 1]))
            return (part,) + encode_records_with_offsets(part)

        def deflate(payload):
            part, blob, rec_offs = payload
            comp, csizes = deflate_blob(blob)
            frag = None
            if write_bai:
                voffs, end_voffs = voffsets_from_csizes(csizes, rec_offs)
                frag = build_bai(part.refid, part.pos, part.alignment_ends(),
                                 part.flag, voffs, end_voffs, header.n_ref)
            return comp, frag

        def stage(payload):
            comp, frag = payload
            part_path = os.path.join(temp_dir, f"part-{k:05d}")
            fs.write_all(part_path, comp)
            return part_path, len(comp), frag

        return WriteShardTask(shard_id=k, encode=encode, deflate=deflate,
                              stage=stage,
                              retrier=write_retrier_for_storage(self._storage),
                              what="bam.part")

    def _merge(self, fs, header, path, temp_dir, parts, frags, write_bai):
        header_comp = compress_to_bgzf(header.to_bam_bytes(),
                                       with_terminator=False)
        header_path = os.path.join(temp_dir, "_header")
        fs.write_all(header_path, header_comp)
        term_path = os.path.join(temp_dir, "_terminator")
        fs.write_all(term_path, BGZF_EOF_MARKER)
        fs.concat([header_path] + [p for p, _ in parts] + [term_path], path)
        if write_bai:
            starts = np.zeros(len(parts) + 1, dtype=np.int64)
            np.cumsum([n for _, n in parts], out=starts[1:])
            starts = starts[:-1] + len(header_comp)
            merged = merge_bai_fragments(frags, [int(s) for s in starts])
            fs.write_all(path + ".bai", merged.to_bytes())
