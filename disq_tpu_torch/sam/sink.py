"""SamSink — text SAM write paths.

Single file (``SamSink``): a header part, per-shard text parts and a
concat at the end; ``SamSinkMultiple``: a directory of complete
per-shard SAM files. Each shard's slice of the batch is a host
``ReadBatch`` (a device-backed ``ColumnarBatch`` materializes only that
slice), rendered as text on the write pipeline's encode workers and
written on its stage workers; SAM has no deflate step.
"""

from __future__ import annotations

import os
from typing import List, Sequence

from disq_tpu_torch.api import TempPartsDirectoryWriteOption, WriteOption
from disq_tpu_torch.fsw.filesystem import resolve_path
from disq_tpu_torch.runtime.executor import (
    WriteShardTask,
    run_write_stage,
    write_retrier_for_storage,
    writer_for_storage,
)
from disq_tpu_torch.runtime.tracing import wrap_span
from disq_tpu_torch.sam.text import batch_to_sam_lines
from disq_tpu_torch.util import shard_bounds


def _run_sam_shards(storage, fs, dataset, bounds, n_shards, prefix_bytes,
                    part_path_for) -> List[str]:
    """The shard fan-out of both SAM sinks: text rendering on the write
    pipeline's encode workers, part writes on its stage workers. Returns
    the part paths in shard order."""
    batch = dataset.reads

    def make_task(k):
        def encode():
            part = batch.slice(int(bounds[k]), int(bounds[k + 1]))
            lines = batch_to_sam_lines(part, dataset.header)
            return prefix_bytes + "".join(ln + "\n" for ln in lines).encode()

        def stage(body):
            p = part_path_for(k)
            fs.write_all(p, body)
            return p

        return WriteShardTask(
            shard_id=k,
            encode=wrap_span("sam.write.encode", encode, shard=k),
            stage=wrap_span("sam.write.stage", stage, shard=k),
            retrier=write_retrier_for_storage(storage, part_path_for(k)),
            what="sam.part",
        )

    return run_write_stage(writer_for_storage(storage), n_shards, make_task)


class SamSink:
    def __init__(self, storage=None):
        self._storage = storage

    def save(self, dataset, path: str, options: Sequence[WriteOption] = ()) -> None:
        fs, path = resolve_path(path)
        temp_dir = next(
            (o.path for o in options if isinstance(o, TempPartsDirectoryWriteOption)),
            path + ".parts",
        )
        batch = dataset.reads
        n_shards, bounds = shard_bounds(self._storage, batch.count)
        fs.mkdirs(temp_dir)
        try:
            merge = write_retrier_for_storage(self._storage, path)
            header_path = os.path.join(temp_dir, "_header")
            merge.call(fs.write_all, header_path,
                       dataset.header.text.encode(), what="sam.merge")
            part_paths = _run_sam_shards(
                self._storage, fs, dataset, bounds, n_shards, b"",
                lambda k: os.path.join(temp_dir, f"part-{k:05d}"),
            )
            merge.call(fs.concat, [header_path] + part_paths, path,
                       what="sam.merge")
        finally:
            fs.delete(temp_dir, recursive=True)


class SamSinkMultiple:
    def __init__(self, storage=None):
        self._storage = storage

    def save(self, dataset, path: str, options: Sequence[WriteOption] = ()) -> None:
        fs, path = resolve_path(path)
        batch = dataset.reads
        n_shards, bounds = shard_bounds(self._storage, batch.count)
        fs.mkdirs(path)
        _run_sam_shards(
            self._storage, fs, dataset, bounds, n_shards,
            dataset.header.text.encode(),
            lambda k: os.path.join(path, f"part-r-{k:05d}.sam"),
        )
