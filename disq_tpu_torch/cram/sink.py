"""CramSink and CramSinkMultiple — single-file and multi-file CRAM writes.

Reference parity: ``impl/formats/cram/CramSink.java``: per-shard
container streams staged as parts, then the file definition + SAM-header
container prefix, the parts and the CRAM EOF container are concatenated,
and the per-part ``.crai`` fragments merge by shifting their container
offsets (htsjdk ``CRAIIndexMerger``). ``CramSinkMultiple`` writes a
directory of complete CRAMs instead (``part-r-NNNNN.cram``, each with
the file definition, the header container and the EOF container).

Shards run through the write pipeline (``run_cram_write_stage``): the
container encode, which compresses inside, on its encode workers, and
the part writes on its stage workers. A single file's shard numbers its
records from its absolute start (a part of a directory from 0), so the
bytes do not depend on how the shards run.
"""

from __future__ import annotations

import os
import struct
from typing import List, Sequence

import numpy as np

from disq_tpu_torch.bam.columnar import ReadBatch
from disq_tpu_torch.cram.codec import encode_container
from disq_tpu_torch.cram.crai import CraiEntry, CraiIndex
from disq_tpu_torch.cram.refsource import fetcher_for_storage
from disq_tpu_torch.cram.structure import (
    Block,
    ContainerHeader,
    EOF_CONTAINER,
    FILE_HEADER,
    RAW,
    file_definition,
)
from disq_tpu_torch.fsw.filesystem import resolve_path
from disq_tpu_torch.runtime.executor import (
    WriteShardTask,
    run_write_stage,
    write_retrier_for_storage,
    writer_for_storage,
)
from disq_tpu_torch.runtime.tracing import wrap_span
from disq_tpu_torch.util import shard_bounds

MAX_SLICE_RECORDS = 10_000


def run_cram_write_stage(storage, fs, batch, bounds, n_shards, ref_fetch,
                         part_path_for, assemble=None) -> List[dict]:
    """Every shard's containers, encoded on the write pipeline's encode
    workers and written to ``part_path_for(k)`` on its stage workers;
    ``assemble(part_bytes)`` wraps a shard's containers into a complete
    file (a directory's part). Returns each shard's ``{"part", "len",
    "crai"}`` in shard order."""

    def make_task(k):
        def encode():
            lo, hi = int(bounds[k]), int(bounds[k + 1])
            part_bytes, entries = encode_part(
                batch.slice(lo, hi), lo if assemble is None else 0,
                ref_fetch)
            if assemble is not None:
                part_bytes = assemble(part_bytes)
            return part_bytes, entries

        def stage(payload):
            part_bytes, entries = payload
            p = part_path_for(k)
            fs.write_all(p, part_bytes)
            return {"part": p, "len": len(part_bytes),
                    "crai": CraiIndex(entries)}

        return WriteShardTask(
            shard_id=k,
            encode=wrap_span("cram.write.encode", encode, shard=k),
            stage=wrap_span("cram.write.stage", stage, shard=k),
            retrier=write_retrier_for_storage(storage, part_path_for(k)),
            what="cram.part")

    return run_write_stage(writer_for_storage(storage), n_shards, make_task,
                           storage=storage, path=part_path_for(0))


def _header_container(header) -> bytes:
    """First container: the SAM header in a FILE_HEADER block."""
    text = header.text.encode()
    content = struct.pack("<i", len(text)) + text
    block = Block(FILE_HEADER, 0, content, RAW).to_bytes()
    hdr = ContainerHeader(
        length=len(block), ref_seq_id=0, ref_start=0, ref_span=0,
        n_records=0, record_counter=0, bases=0, n_blocks=1, landmarks=[],
    )
    return hdr.to_bytes() + block


def _ref_runs(batch: ReadBatch) -> List[tuple]:
    """Split a batch into (start, stop, refid) runs of equal refid, each
    capped at MAX_SLICE_RECORDS (single-ref slices)."""
    runs = []
    n = batch.count
    if n == 0:
        return runs
    refids = batch.refid
    change = np.nonzero(np.diff(refids))[0] + 1
    bounds = np.concatenate([[0], change, [n]])
    for a, b in zip(bounds[:-1], bounds[1:]):
        for s in range(int(a), int(b), MAX_SLICE_RECORDS):
            runs.append((s, min(s + MAX_SLICE_RECORDS, int(b)), int(refids[a])))
    return runs


def encode_part(
    batch: ReadBatch, record_counter_base: int, ref_fetch
) -> tuple[bytes, List[CraiEntry]]:
    """Encode a shard's batch into containers; crai entries carry
    part-relative container offsets."""
    out = bytearray()
    entries: List[CraiEntry] = []
    counter = record_counter_base
    for s, e, refid in _ref_runs(batch):
        part = batch.slice(s, e)
        container, info = encode_container(part, refid, counter, ref_fetch)
        entries.append(
            CraiEntry(
                seq_id=info["ref_seq_id"],
                start=info["ref_start"], span=info["ref_span"],
                container_offset=len(out),
                slice_offset=info["slice_offset"],
                slice_size=info["slice_size"],
            )
        )
        out += container
        counter += part.count
    return bytes(out), entries


class CramSink:
    """Single-file CRAM write."""

    def __init__(self, storage):
        self._storage = storage

    def save(self, dataset, path: str, options: Sequence = ()) -> None:
        from disq_tpu_torch.api import (
            CraiWriteOption,
            TempPartsDirectoryWriteOption,
            option_enabled,
        )
        from disq_tpu_torch.runtime.columnar import as_read_batch

        fs, path = resolve_path(path)
        header = dataset.header
        batch = as_read_batch(dataset.reads)
        write_crai = option_enabled(options, CraiWriteOption)
        ref_fetch = fetcher_for_storage(self._storage, header)
        temp_dir = next(
            (o.path for o in options
             if isinstance(o, TempPartsDirectoryWriteOption)),
            path + ".parts",
        )
        n_shards, bounds = shard_bounds(self._storage, batch.count)
        fs.mkdirs(temp_dir)
        try:
            prefix = file_definition() + _header_container(header)
            infos = run_cram_write_stage(
                self._storage, fs, batch, bounds, n_shards, ref_fetch,
                lambda k: os.path.join(temp_dir, f"part-{k:05d}"))
            part_paths = [i["part"] for i in infos]
            part_lens = [i["len"] for i in infos]
            frags = [i["crai"] for i in infos]
            # every durable write of the merge under the parts' retry budget
            merge = write_retrier_for_storage(self._storage, path)
            prefix_path = os.path.join(temp_dir, "_prefix")
            merge.call(fs.write_all, prefix_path, prefix,
                        what="cram.merge")
            eof_path = os.path.join(temp_dir, "_eof")
            merge.call(fs.write_all, eof_path, EOF_CONTAINER,
                        what="cram.merge")
            merge.call(fs.concat, [prefix_path] + part_paths + [eof_path],
                        path, what="cram.merge")
            if write_crai:
                part_starts = np.zeros(len(part_lens), dtype=np.int64)
                np.cumsum(part_lens[:-1], out=part_starts[1:])
                part_starts += len(prefix)
                merged = CraiIndex.merge(frags, list(part_starts))
                merge.call(fs.write_all, path + ".crai",
                            merged.to_bytes(), what="cram.merge")
        finally:
            fs.delete(temp_dir, recursive=True)


class CramSinkMultiple:
    """A directory of complete CRAMs, one per write shard
    (``FileCardinalityWriteOption.MULTIPLE``)."""

    def __init__(self, storage):
        self._storage = storage

    def save(self, dataset, path: str, options: Sequence = ()) -> None:
        from disq_tpu_torch.runtime.columnar import as_read_batch

        fs, path = resolve_path(path)
        header = dataset.header
        batch = as_read_batch(dataset.reads)
        ref_fetch = fetcher_for_storage(self._storage, header)
        n_shards, bounds = shard_bounds(self._storage, batch.count)
        fs.mkdirs(path)
        prefix = file_definition() + _header_container(header)
        run_cram_write_stage(
            self._storage, fs, batch, bounds, n_shards, ref_fetch,
            lambda k: os.path.join(path, f"part-r-{k:05d}.cram"),
            assemble=lambda part_bytes: prefix + part_bytes + EOF_CONTAINER)
