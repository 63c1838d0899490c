"""VcfSink — VCF write paths.

Single-file write (``VcfSink``): each shard stages its serialized (and,
by format, compressed) part; then the header prefix, the parts and, for
BGZF, the terminator are concatenated, and the per-part ``.tbi``
fragments merge when tabix indexing is on. ``VcfSinkMultiple`` writes a
directory of complete per-shard VCFs.

Compression follows ``VariantsFormatWriteOption`` (else the extension):
VCF (plain), VCF_GZ (whole-file gzip, not splittable), VCF_BGZ (BGZF
blocks: splittable, indexable). Every BGZF deflate goes through
``deflate_blob_for``: the canonical zlib-6 blocks by default, the device
coder (kernel W2) under ``device_deflate``. Plain and gzip writes stay
on the host.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import List, Sequence

import numpy as np

from disq_tpu_torch.api import (
    TabixIndexWriteOption,
    TempPartsDirectoryWriteOption,
    VariantsFormatWriteOption,
    WriteOption,
)
from disq_tpu_torch.bgzf.block import BGZF_EOF_MARKER, BGZF_MAX_PAYLOAD
from disq_tpu_torch.bgzf.codec import deflate_blob_for
from disq_tpu_torch.fsw.filesystem import resolve_path
from disq_tpu_torch.index.tbi import TbiIndex, build_tbi, merge_tbi_fragments
from disq_tpu_torch.runtime.executor import (
    WriteShardTask,
    run_write_stage,
    write_retrier_for_storage,
    writer_for_storage,
)
from disq_tpu_torch.runtime.tracing import wrap_span
from disq_tpu_torch.util import shard_bounds
from disq_tpu_torch.vcf.columnar import VariantBatch


def _format_for(path: str, options: Sequence[WriteOption]) -> VariantsFormatWriteOption:
    for o in options:
        if isinstance(o, VariantsFormatWriteOption):
            return o
    lowered = path.lower()
    if lowered.endswith(".vcf.bgz") or lowered.endswith(".bgz"):
        return VariantsFormatWriteOption.VCF_BGZ
    if lowered.endswith(".gz"):
        return VariantsFormatWriteOption.VCF_GZ
    return VariantsFormatWriteOption.VCF


def _tbi_enabled(options: Sequence[WriteOption]) -> bool:
    for o in options:
        if isinstance(o, TabixIndexWriteOption):
            return bool(o.value)
    return False


def _gzip(data: bytes) -> bytes:
    """Whole-buffer gzip, mtime pinned for deterministic output."""
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb", mtime=0) as z:
        z.write(data)
    return buf.getvalue()


class VcfSink:
    """Single-file VCF write."""

    def __init__(self, storage=None):
        self._storage = storage

    def save(self, dataset, path: str, options: Sequence[WriteOption] = ()) -> None:
        fs, path = resolve_path(path)
        fmt = _format_for(path, options)
        write_tbi = _tbi_enabled(options)
        if write_tbi and fmt is not VariantsFormatWriteOption.VCF_BGZ:
            raise ValueError("tabix (.tbi) requires block-compressed VCF (VCF_BGZ)")
        batch: VariantBatch = dataset.variants
        header_bytes = dataset.header.text.encode()
        temp_dir = next(
            (o.path for o in options if isinstance(o, TempPartsDirectoryWriteOption)),
            path + ".parts",
        )
        n_shards, bounds = shard_bounds(self._storage, batch.count)
        fs.mkdirs(temp_dir)
        try:
            self._write_parts(
                fs, path, temp_dir, fmt, write_tbi, batch, header_bytes,
                n_shards, bounds,
            )
        finally:
            fs.delete(temp_dir, recursive=True)

    def _encode_shard(self, batch, bounds, k):
        """Encode step: slice shard ``k`` and render its line blob."""
        part = batch.slice(int(bounds[k]), int(bounds[k + 1]))
        return part, _lines_blob(part)

    def _deflate_shard(self, fmt, write_tbi, payload):
        """Deflate step: compress per the format and, for BGZF parts,
        build the part-local tabix fragment from vectorized voffsets."""
        part, body = payload
        tbi_frag = None
        if fmt is VariantsFormatWriteOption.VCF_BGZ:
            comp, csizes = deflate_blob_for(self._storage, body)
            if write_tbi:
                lens = np.diff(part.line_offsets)
                line_starts = np.zeros(part.count + 1, dtype=np.int64)
                np.cumsum(lens + 1, out=line_starts[1:])
                block_comp_start = np.zeros(len(csizes) + 1, dtype=np.int64)
                np.cumsum(csizes, out=block_comp_start[1:])
                bidx = line_starts // BGZF_MAX_PAYLOAD
                within = line_starts % BGZF_MAX_PAYLOAD
                voffs = (
                    block_comp_start[bidx].astype(np.uint64) << np.uint64(16)
                ) | within.astype(np.uint64)
                tbi_frag = build_tbi(
                    part.contig_names, part.chrom, part.pos,
                    part.end, voffs[:-1], voffs[1:],
                )
            data = comp
        elif fmt is VariantsFormatWriteOption.VCF_GZ:
            data = _gzip(body)
        else:
            data = body
        return data, tbi_frag

    def _stage_shard(self, fs, temp_dir, k, payload):
        """Stage step: write the part."""
        data, tbi_frag = payload
        p = os.path.join(temp_dir, f"part-{k:05d}")
        fs.write_all(p, data)
        return {"part": p, "len": len(data), "tbi": tbi_frag}

    def _write_parts(
        self, fs, path, temp_dir, fmt, write_tbi, batch, header_bytes,
        n_shards, bounds,
    ) -> None:
        bgz = fmt is VariantsFormatWriteOption.VCF_BGZ
        plain_gz = fmt is VariantsFormatWriteOption.VCF_GZ

        def make_task(k):
            return WriteShardTask(
                shard_id=k,
                encode=wrap_span(
                    "vcf.write.encode",
                    lambda: self._encode_shard(batch, bounds, k), shard=k),
                deflate=wrap_span(
                    "vcf.write.deflate",
                    lambda p: self._deflate_shard(fmt, write_tbi, p),
                    shard=k),
                stage=wrap_span(
                    "vcf.write.stage",
                    lambda p: self._stage_shard(fs, temp_dir, k, p),
                    shard=k),
                retrier=write_retrier_for_storage(self._storage, temp_dir),
                what="vcf.part",
            )

        infos = run_write_stage(writer_for_storage(self._storage), n_shards,
                                make_task, storage=self._storage, path=path)
        part_paths = [i["part"] for i in infos]
        part_lens = [i["len"] for i in infos]
        tbi_frags: List[TbiIndex] = [
            i["tbi"] for i in infos if i["tbi"] is not None
        ]

        # the merge's writes retry transient faults as staged parts do
        # (the atomic create makes a retry safe)
        merge = write_retrier_for_storage(self._storage, path)
        header_path = os.path.join(temp_dir, "_header")
        if bgz:
            hdr, _ = deflate_blob_for(self._storage, header_bytes)
        elif plain_gz:
            hdr = _gzip(header_bytes)
        else:
            hdr = header_bytes
        merge.call(fs.write_all, header_path, hdr, what="vcf.merge")
        tail: List[str] = []
        if bgz:
            term_path = os.path.join(temp_dir, "_terminator")
            merge.call(fs.write_all, term_path, BGZF_EOF_MARKER,
                       what="vcf.merge")
            tail = [term_path]
        merge.call(fs.concat, [header_path] + part_paths + tail, path,
                   what="vcf.merge")

        if write_tbi and tbi_frags:
            part_starts = np.zeros(len(part_lens) + 1, dtype=np.int64)
            np.cumsum(part_lens, out=part_starts[1:])
            merged = merge_tbi_fragments(tbi_frags, list(part_starts[:-1] + len(hdr)))
            merge.call(fs.write_all, path + ".tbi", merged.to_bytes(),
                       what="vcf.merge")


class VcfSinkMultiple:
    """Directory of complete per-shard VCFs (``MULTIPLE`` cardinality)."""

    def __init__(self, storage=None):
        self._storage = storage

    def save(self, dataset, path: str, options: Sequence[WriteOption] = ()) -> None:
        fs, path = resolve_path(path)
        fmt = _format_for("", options)
        ext = {"vcf": ".vcf", "vcf.gz": ".vcf.gz", "vcf.bgz": ".vcf.bgz"}[fmt.value]
        batch = dataset.variants
        n_shards, bounds = shard_bounds(self._storage, batch.count)
        fs.mkdirs(path)
        header_bytes = dataset.header.text.encode()

        def deflate(payload):
            if fmt is VariantsFormatWriteOption.VCF_BGZ:
                comp, _ = deflate_blob_for(self._storage, payload)
                return comp + BGZF_EOF_MARKER
            if fmt is VariantsFormatWriteOption.VCF_GZ:
                return _gzip(payload)
            return payload

        def make_task(k):
            def encode():
                part = batch.slice(int(bounds[k]), int(bounds[k + 1]))
                return header_bytes + _lines_blob(part)

            def stage(data):
                p = os.path.join(path, f"part-r-{k:05d}{ext}")
                fs.write_all(p, data)
                return p

            return WriteShardTask(
                shard_id=k,
                encode=wrap_span("vcf.write.encode", encode, shard=k),
                deflate=wrap_span("vcf.write.deflate", deflate, shard=k),
                stage=wrap_span("vcf.write.stage", stage, shard=k),
                retrier=write_retrier_for_storage(self._storage, path),
                what="vcf.part",
            )

        run_write_stage(writer_for_storage(self._storage), n_shards,
                        make_task, storage=self._storage, path=path)


def _lines_blob(part: VariantBatch) -> bytes:
    """Part lines + newlines: one newline inserted after every line in
    a single vectorized pass."""
    if part.count == 0:
        return b""
    out = np.insert(
        np.asarray(part.lines, dtype=np.uint8),
        np.asarray(part.line_offsets[1:], dtype=np.int64), ord("\n"))
    return out.tobytes()
