"""BamSink and BamSinkMultiple — single-file and multi-file BAM writes.

Single-file protocol (the reference's): shards write headerless,
terminatorless BGZF parts to a temp dir, each with part-local BAI and
SBI fragments; then a header-only BGZF prefix, the parts and the 28-byte
terminator are concatenated, and the fragments merge by shifting each
part's virtual offsets by its absolute start (which includes the
header's compressed length). Per-record virtual offsets inside a part
are array arithmetic: canonical BGZF blocking puts 65280 payload bytes
in every block, so ``voffset(u) = (block_comp_start[u // 65280] << 16)
| (u % 65280)``.

Shards run through the write pipeline (``runtime/executor.py``):
encode (slice and record encode) → deflate (BGZF blocks, virtual
offsets, index fragments) → stage (the part's write, retried on
transient faults), then the merge in shard order. With ``writer_workers
> 1`` the steps of different shards overlap; the bytes are the same at
any width.

With a ``StageManifestWriteOption`` the write resumes: each staged
shard is recorded in the manifest (with its index fragments pickled
beside its part), staging survives a failure, and a write run again with
the same manifest and the same input re-runs only the missing shards.
A shard that still fails after its retry raises ``RuntimeError`` naming
it. The manifest goes at the commit point, before the staging dir.

``BamSinkMultiple`` writes a directory of complete per-shard BAMs
(``part-r-NNNNN.bam``, each with its header and terminator).

With ``DisqOptions.device_deflate`` armed every deflate (parts, header
block, directory parts) runs the device coder on the storage's device
(``ops/deflate.py``), and a sorted batch with an encode source gathers
each shard's records on the device too (``runtime/device_write.py``):
then the index fragments read host columns only when an index is asked
for (``_LazySlice``). The knob is part of the stage manifest's params,
so flipping it between a crash and the resume starts the staging afresh.
"""

from __future__ import annotations

import os
import pickle
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

from disq_tpu_torch.bam.codec import encode_records, encode_records_with_offsets
from disq_tpu_torch.bam.header import SamHeader
from disq_tpu_torch.bgzf.block import BGZF_EOF_MARKER, BGZF_MAX_PAYLOAD
from disq_tpu_torch.bgzf.codec import (
    compress_to_bgzf,
    deflate_blob,
    deflate_device_for,
)
from disq_tpu_torch.fsw.filesystem import resolve_path
from disq_tpu_torch.index.bai import build_bai, merge_bai_fragments
from disq_tpu_torch.index.sbi import SbiIndex
from disq_tpu_torch.runtime.executor import (
    WriteShardTask,
    run_write_stage,
    write_retrier_for_storage,
    writer_for_storage,
)
from disq_tpu_torch.runtime.tracing import trace_phase, wrap_span
from disq_tpu_torch.util import shard_bounds

SBI_GRANULARITY = 4096  # htsjdk SBIIndexWriter default


def _batch_digest(batch) -> int:
    """CRC32 over every column: a manifest written for one dataset must
    not adopt parts staged from another."""
    crc = 0
    for col in (batch.refid, batch.pos, batch.mapq, batch.flag, batch.tlen,
                batch.names, batch.cigars, batch.seqs, batch.quals,
                batch.tags):
        crc = zlib.crc32(np.ascontiguousarray(col).tobytes(), crc)
    return crc


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


def bgzf_compress_with_voffsets(blob: bytes, record_offsets: np.ndarray,
                                device=None
                                ) -> Tuple[bytes, np.ndarray, np.ndarray]:
    """Deflate ``blob`` into BGZF (no terminator): (compressed bytes,
    start voffsets, end voffsets) of the records at uncompressed offsets
    ``record_offsets``. ``device`` routes the deflate as in
    ``bgzf.codec.deflate_blob``."""
    comp, csizes = deflate_blob(blob, device=device)
    voffs, end_voffs = voffsets_from_csizes(csizes, record_offsets)
    return comp, voffs, end_voffs


class _LazySlice:
    """A shard's records for the index fragments of the device write
    path: host columns materialize only when an index reads them."""

    __slots__ = ("_batch", "_lo", "_hi", "_part")

    def __init__(self, batch, lo: int, hi: int) -> None:
        self._batch = batch
        self._lo, self._hi = lo, hi
        self._part = None

    @property
    def count(self) -> int:
        return self._hi - self._lo

    def _mat(self):
        if self._part is None:
            self._part = self._batch.slice(self._lo, self._hi)
        return self._part

    def __getattr__(self, name: str):
        return getattr(self._mat(), name)


class BamSink:
    """Single-file BAM write."""

    def __init__(self, storage):
        self._storage = storage
        # where the deflates run: None for the canonical host zlib
        self._device: Optional[object] = None

    def save(self, dataset, path: str, options: Sequence = ()) -> None:
        from disq_tpu_torch.api import (
            BaiWriteOption,
            SbiWriteOption,
            StageManifestWriteOption,
            TempPartsDirectoryWriteOption,
            option_enabled,
        )

        fs, path = resolve_path(path)
        header: SamHeader = dataset.header
        batch = dataset.reads
        write_bai = option_enabled(options, BaiWriteOption)
        write_sbi = option_enabled(options, SbiWriteOption)
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
        self._device = deflate_device_for(self._storage)
        resident = None
        if self._device is not None:
            from disq_tpu_torch.runtime import device_write

            resident = device_write.resident_encoder_for(self._storage, batch)
        manifest = None
        manifest_opt = next((o for o in options
                             if isinstance(o, StageManifestWriteOption)), None)
        if manifest_opt is not None:
            from disq_tpu_torch.runtime.manifest import StageManifest

            manifest = StageManifest(manifest_opt.path, params={
                "target": path,
                "records": int(batch.count),
                "digest": _batch_digest(batch),
                "n_shards": int(n_shards),
                "bai": write_bai,
                "sbi": write_sbi,
                # the device coder's bytes are not the zlib pin's: flipping
                # the knob between a crash and the resume resets staging
                "device_deflate": self._device is not None,
            })
        fs.mkdirs(temp_dir)
        try:
            self._write_parts_and_merge(fs, header, batch, path, temp_dir,
                                        n_shards, bounds, write_bai,
                                        write_sbi, manifest, resident)
        except BaseException:
            # the merge is the commit point: without a manifest staging
            # never outlives save(); with one, the staged parts survive
            # for the resume
            if manifest is None:
                fs.delete(temp_dir, recursive=True)
            raise
        # manifest first: a crash between the two leaves only a stale
        # staging dir, never a manifest naming parts that are gone
        if manifest is not None:
            manifest.finish()
        fs.delete(temp_dir, recursive=True)

    # -- the steps of one shard (encode → deflate → stage) ------------------

    def _encode_shard(self, batch, bounds, k, resident=None):
        """Slice shard ``k`` and encode its records: on the host, or, with
        the device write path's encoder, as a W1 gather on the device
        (the payload stays there for the deflate)."""
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        if resident is not None:
            enc = resident.encode_shard(lo, hi)
            return _LazySlice(batch, lo, hi), enc, enc.record_offsets
        part = batch.slice(lo, hi)
        return (part,) + encode_records_with_offsets(part)

    def _deflate_shard(self, header, write_bai, write_sbi, payload):
        """BGZF deflate, the records' virtual offsets, and the part's
        SBI and BAI fragments (part-local offsets). A shard encoded on
        the device deflates there from its payload."""
        part, blob, rec_offs = payload
        if hasattr(blob, "deflate"):  # runtime/device_write.EncodedShard
            comp, csizes = blob.deflate()
            voffs, end_voffs = voffsets_from_csizes(csizes, rec_offs)
        else:
            comp, voffs, end_voffs = bgzf_compress_with_voffsets(
                blob, rec_offs, device=self._device)
        sbi_frag = bai_frag = None
        if write_sbi:
            sbi_frag = SbiIndex.build(
                voffs, int(end_voffs[-1]) if part.count else 0, 0,
                granularity=SBI_GRANULARITY)
        if write_bai:
            bai_frag = build_bai(part.refid, part.pos, part.alignment_ends(),
                                 part.flag, voffs, end_voffs, header.n_ref)
        return comp, sbi_frag, bai_frag

    def _stage_shard(self, fs, temp_dir, k, frag_cache, payload) -> dict:
        """Write the part; returns the shard's manifest record. The
        fragments go to ``frag_cache``, or, when it is None (the
        manifest path, which resumes from disk), pickled beside the
        part."""
        comp, sbi_frag, bai_frag = payload
        part_path = os.path.join(temp_dir, f"part-{k:05d}")
        fs.write_all(part_path, comp)
        info = {"part": part_path, "len": len(comp), "sbi": None,
                "bai": None}
        for key, frag in (("sbi", sbi_frag), ("bai", bai_frag)):
            if frag is not None:
                info[key] = f"{part_path}.{key}-frag"
                if frag_cache is None:
                    fs.write_all(info[key], pickle.dumps(
                        frag, protocol=pickle.HIGHEST_PROTOCOL))
        if frag_cache is not None:
            frag_cache[k] = {"sbi": sbi_frag, "bai": bai_frag}
        return info

    @staticmethod
    def _part_byte_ranges(batch, bounds):
        """Each part's uncompressed byte range in the merged record
        stream (the record encoder's size arithmetic at the shard
        bounds): the write leases' locality hint, computed only when
        they are armed. None when the batch cannot tell cheaply (the
        leases then go in queue order)."""
        try:
            name_len = np.diff(batch.name_offsets)
            n_cigar = np.diff(batch.cigar_offsets)
            l_seq = np.diff(batch.seq_offsets)
            tag_len = np.diff(batch.tag_offsets)
        except Exception:  # noqa: BLE001 — a hint never fails a write
            return None
        sizes = (36 + (name_len + 1) + 4 * n_cigar + (l_seq + 1) // 2
                 + l_seq + tag_len).astype(np.int64)
        cum = np.zeros(len(sizes) + 1, np.int64)
        np.cumsum(sizes, out=cum[1:])
        return [(int(cum[int(bounds[k])]), int(cum[int(bounds[k + 1])]))
                for k in range(len(bounds) - 1)]

    def _make_write_task(self, fs, header, batch, temp_dir, bounds,
                         write_bai, write_sbi, k, frag_cache, resident=None,
                         byte_range=None):
        # the 3-argument encode call stays when the device path is off
        if resident is None:
            def encode():
                return self._encode_shard(batch, bounds, k)
        else:
            def encode():
                return self._encode_shard(batch, bounds, k, resident)
        return WriteShardTask(
            shard_id=k,
            encode=wrap_span("bam.write.encode", encode, shard=k),
            deflate=wrap_span(
                "bam.write.deflate",
                lambda p: self._deflate_shard(header, write_bai, write_sbi,
                                              p), shard=k),
            stage=wrap_span(
                "bam.write.stage",
                lambda p: self._stage_shard(fs, temp_dir, k, frag_cache, p),
                shard=k),
            retrier=write_retrier_for_storage(self._storage, temp_dir),
            what="bam.part", byte_range=byte_range)

    # -- the parts and the merge --------------------------------------------

    def _write_parts_and_merge(self, fs, header, batch, path, temp_dir,
                               n_shards, bounds, write_bai, write_sbi,
                               manifest=None, resident=None) -> None:
        from disq_tpu_torch.runtime.scheduler import write_leasing_armed

        frag_cache = None if manifest is not None else {}
        # the byte ranges feed the write leases' locality; an unleased
        # write skips the size walk
        ranges = (self._part_byte_ranges(batch, bounds)
                  if manifest is not None
                  and write_leasing_armed(self._storage) else None)
        try:
            with trace_phase("bam.write.parts"):
                infos = run_write_stage(
                    writer_for_storage(self._storage), n_shards,
                    lambda k: self._make_write_task(
                        fs, header, batch, temp_dir, bounds, write_bai,
                        write_sbi, k, frag_cache, resident,
                        ranges[k] if ranges else None),
                    manifest=manifest, stage_name="bam.parts",
                    storage=self._storage, path=path, fs=fs)
        finally:
            if resident is not None:
                # the uploaded record blob is done with the parts stage
                resident.release()
        with trace_phase("bam.write.merge"):
            self._merge(fs, header, path, temp_dir, n_shards, infos,
                        frag_cache, write_bai, write_sbi)

    def _merge(self, fs, header, path, temp_dir, n_shards, infos, frag_cache,
               write_bai, write_sbi) -> None:
        """The single-file commit: header block, parts and terminator
        concatenated, the index fragments merged. Every durable write of
        the merge runs under the transient retry budget the staged parts
        get (an atomic create makes a retried write or concat safe)."""
        def frags(key):
            if frag_cache is not None:
                return [frag_cache[k][key] for k in range(n_shards)]
            return [pickle.loads(fs.read_all(i[key])) for i in infos]

        merge = write_retrier_for_storage(self._storage, path)
        header_comp = compress_to_bgzf(header.to_bam_bytes(),
                                       with_terminator=False,
                                       device=self._device)
        header_path = os.path.join(temp_dir, "_header")
        merge.call(fs.write_all, header_path, header_comp, what="bam.merge")
        term_path = os.path.join(temp_dir, "_terminator")
        merge.call(fs.write_all, term_path, BGZF_EOF_MARKER,
                    what="bam.merge")
        merge.call(fs.concat,
                    [header_path] + [i["part"] for i in infos] + [term_path],
                    path, what="bam.merge")
        starts = np.zeros(n_shards + 1, dtype=np.int64)
        np.cumsum([i["len"] for i in infos], out=starts[1:])
        starts = [int(s) for s in starts[:-1] + len(header_comp)]
        if write_sbi:
            merged = SbiIndex.merge(frags("sbi"), starts,
                                    fs.get_file_length(path))
            merge.call(fs.write_all, path + ".sbi", merged.to_bytes(),
                        what="bam.merge")
        if write_bai:
            merged = merge_bai_fragments(frags("bai"), starts)
            merge.call(fs.write_all, path + ".bai", merged.to_bytes(),
                        what="bam.merge")


class BamSinkMultiple:
    """A directory of complete BAMs, one per write shard
    (``FileCardinalityWriteOption.MULTIPLE``)."""

    def __init__(self, storage):
        self._storage = storage

    def save(self, dataset, path: str, options: Sequence = ()) -> None:
        fs, path = resolve_path(path)
        batch = dataset.reads
        header_bytes = dataset.header.to_bam_bytes()
        n_shards, bounds = shard_bounds(self._storage, batch.count)
        fs.mkdirs(path)
        device = deflate_device_for(self._storage)

        def make_task(k):
            def encode():
                part = batch.slice(int(bounds[k]), int(bounds[k + 1]))
                return header_bytes + encode_records(part)

            def stage(data):
                part_path = os.path.join(path, f"part-r-{k:05d}.bam")
                fs.write_all(part_path, data)
                return part_path

            return WriteShardTask(
                shard_id=k,
                encode=wrap_span("bam.write.encode", encode, shard=k),
                deflate=wrap_span(
                    "bam.write.deflate",
                    lambda data: compress_to_bgzf(data, device=device),
                    shard=k),
                stage=wrap_span("bam.write.stage", stage, shard=k),
                retrier=write_retrier_for_storage(self._storage, path),
                what="bam.part")

        run_write_stage(writer_for_storage(self._storage), n_shards,
                        make_task)
