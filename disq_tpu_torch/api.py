"""Public API — ``ReadsStorage`` and ``ReadsDataset``, as in ``disq_tpu``.

Usage::

    storage = ReadsStorage.make_default().split_size(64 << 20)
    ds = storage.read("sample.bam")      # on cuda
    ds.count(); ds.flagstat()
    storage.write(ds, "sorted.bam", BaiWriteOption.ENABLE, sort=True)
    storage.write(ds.coordinate_sorted(), "out.cram", CraiWriteOption.ENABLE)
    cr = storage.read("out.cram")        # order-0 rANS on the card

    # corrupt blocks dropped and counted (or "quarantine"), splits read
    # on 4 threads, write shards encoded and deflated on 4 threads
    storage.error_policy("skip").executor_workers(4).writer_workers(4)
    ds = storage.read("sample.bam"); ds.counters.skipped_blocks

    # the splitting index, a directory of per-shard BAMs, a write that
    # resumes from its manifest, a read that resumes from its ledger
    storage.write(ds, "sorted.bam", BaiWriteOption.ENABLE,
                  SbiWriteOption.ENABLE, sort=True)
    storage.write(ds, "parts/", FileCardinalityWriteOption.MULTIPLE)
    storage.write(ds, "out.bam", StageManifestWriteOption("out.manifest"))
    ds = storage.read_ledger("ledger/").read("sample.bam")
    ds.depth(1024); ds.device_columns()
    ds.reads.filter(ds.reads.mapq >= 20)

    # the device write path: records gathered and literal-Huffman coded
    # on the card (valid BGZF, not the zlib-6 bytes)
    storage.device_deflate().write(ds, "sorted.bam", BaiWriteOption.ENABLE,
                                   sort=True)

    # operators: a read filter inside the decode, then a chain on the card
    ds = storage.read_filter("-F 0x904 -q 20").read("sample.bam")
    ds2, stats = ds.pipeline(("filter", "-F 0x400"), "sort", "markdup",
                             "rgstats", ("pileup", 0, 10_000, 20_000))

    # telemetry: per-shard spans to a JSONL file, and the registry
    ds = storage.span_log("spans.jsonl").read("sample.bam")
    ds.telemetry_report()["phases"]

Entry points run on ``cuda`` unless the caller asks for another device
(``make_default(device="cpu")`` or ``.device("cpu")``); without CUDA
and without an explicit CPU request, ``read`` and ``write`` raise. On
``cuda`` the device route (inflate and parse kernels, device-resident
columns) is the read path; on the CPU the host codec reads, unless
``.resident_decode()`` asks for the device route's plain versions.
A CRAM read decodes its order-0 rANS streams on the device and returns
a host ``ReadBatch``; reading reference-compressed CRAM needs
``reference_source_path``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from disq_tpu_torch.runtime.counters import PipelineCounters
from disq_tpu_torch.runtime.errors import DisqOptions, ErrorPolicy


def _telemetry_report(counters) -> dict:
    """The dataset's reduced shard counters with the process registry
    (labeled counters, gauges, phase-latency histograms), the phase and
    gauge views, the ``device.*`` rollup and the span-log location."""
    from disq_tpu_torch.runtime import tracing

    snapshot = tracing.telemetry_snapshot()

    def family(keep):
        return {name: series for kind in snapshot.values()
                for name, series in kind.items() if keep(name)}

    return {
        "run_id": tracing.RUN_ID,
        # one process: the port has no multi-process job yet (A8)
        "process_id": 0,
        "counters": counters.as_dict() if counters is not None else {},
        "metrics": snapshot,
        "device": family(lambda n: n.startswith("device.")),
        "resilience": family(lambda n: n.split(".", 1)[0] in (
            "hedge", "breaker", "budget", "deadline")),
        "phases": tracing.phase_report(),
        "gauges": tracing.gauge_report(),
        "span_log": tracing.span_log_path(),
        # no live introspection endpoint in the port (A13)
        "introspect": None,
    }


class WriteOption:
    """Marker base for varargs write options."""


class ReadsFormatWriteOption(WriteOption, enum.Enum):
    BAM = "bam"
    CRAM = "cram"
    SAM = "sam"


class FileCardinalityWriteOption(WriteOption, enum.Enum):
    SINGLE = "single"
    MULTIPLE = "multiple"


@dataclass(frozen=True)
class TempPartsDirectoryWriteOption(WriteOption):
    """Staging dir for headerless part files before the merge."""

    path: str


@dataclass(frozen=True)
class StageManifestWriteOption(WriteOption):
    """Resumable BAM write: each staged shard is recorded in the stage
    manifest at ``path`` and staged parts survive a failure, so a write
    run again with the same manifest re-runs only the missing shards
    (``runtime/manifest.py:StageManifest``)."""

    path: str


class BaiWriteOption(WriteOption, enum.Enum):
    ENABLE = True
    DISABLE = False


class SbiWriteOption(WriteOption, enum.Enum):
    ENABLE = True
    DISABLE = False


class CraiWriteOption(WriteOption, enum.Enum):
    ENABLE = True
    DISABLE = False


class ValidationStringency(enum.Enum):
    STRICT = "strict"
    LENIENT = "lenient"
    SILENT = "silent"


def option_enabled(options: Sequence[WriteOption], cls) -> bool:
    for o in options:
        if isinstance(o, cls):
            return bool(o.value)
    return False


def _opt(options, cls, default):
    found = [o for o in options if isinstance(o, cls)]
    if len(found) > 1:
        raise ValueError(f"duplicate {cls.__name__}")
    return found[0] if found else default


def _infer_cardinality(path: str) -> FileCardinalityWriteOption:
    """A file extension ⇒ one merged file; otherwise a directory of
    per-shard files."""
    if path.lower().endswith((".bam", ".cram", ".sam")):
        return FileCardinalityWriteOption.SINGLE
    return FileCardinalityWriteOption.MULTIPLE


@dataclass
class ReadsDataset:
    """Header + columnar read batch (a host ``ReadBatch`` or a
    device-backed ``ColumnarBatch``), and the read's counters (records,
    blocks, bytes, skipped and quarantined blocks, retried reads)."""

    header: "SamHeader"
    reads: object
    counters: PipelineCounters = field(default_factory=PipelineCounters)
    # the device of the storage that read it (None: ``cuda``)
    device: Optional[torch.device] = None

    def count(self) -> int:
        return int(self.reads.count)

    def telemetry_report(self) -> dict:
        """This dataset's counters and the process telemetry in one dict
        (``runtime/tracing.py``), with the reference's keys."""
        return _telemetry_report(self.counters)

    def flagstat(self) -> dict:
        """Per-category read counts; a device-backed dataset reduces its
        device flag column."""
        from disq_tpu_torch.ops.flagstat import flagstat_counts
        from disq_tpu_torch.runtime.columnar import ColumnarBatch

        if isinstance(self.reads, ColumnarBatch):
            return self.reads.flagstat()
        return flagstat_counts(np.asarray(self.reads.flag))

    def coordinate_sorted(self, keep_resident: bool = False
                          ) -> "ReadsDataset":
        """Coordinate-sort the dataset. ``keep_resident`` keeps a
        device-backed batch device-backed (fixed columns permuted on the
        device, host records not materialized) for the device write
        path; ``ReadsStorage.write(..., sort=True)`` arms it when
        ``device_deflate`` is on."""
        from disq_tpu_torch.sort.coordinate import coordinate_sort_batch

        return ReadsDataset(header=self.header.with_sort_order("coordinate"),
                            reads=coordinate_sort_batch(
                                self.reads, keep_resident=keep_resident),
                            device=self.device)

    def device_columns(self) -> dict:
        """The 8 fixed columns as int32 tensors on the dataset's device.
        A device-backed batch returns its own columns (no transfer); a
        host batch uploads each column once."""
        from disq_tpu_torch.bam.columnar import FIXED_COLUMNS
        from disq_tpu_torch.runtime.columnar import ColumnarBatch
        from disq_tpu_torch.runtime.device_pipeline import upload
        from disq_tpu_torch.util import resolve_device

        if isinstance(self.reads, ColumnarBatch) and self.reads.device_backed:
            return self.reads.device_columns()
        device = resolve_device(self.device)
        return {name: upload(np.asarray(getattr(self.reads, name),
                                        dtype=np.int32), device)
                for name in FIXED_COLUMNS}

    def depth(self, window: int = 1024) -> dict:
        """Windowed coverage depth of the mapped records per reference
        (``{refid: int32 array}``), the difference array summed on the
        batch's device (``ops/depth.py``)."""
        from disq_tpu_torch.ops.depth import window_depth

        return window_depth(self.reads,
                            [s.length for s in self.header.sequences],
                            window, self.device)

    def pipeline(self, *ops) -> "Tuple[ReadsDataset, dict]":
        """Run an operator chain (``runtime/oppipe.py``) over this
        dataset's batch and return ``(dataset, stats)``::

            ds2, stats = ds.pipeline(("filter", "-F 0x400 -q 20"),
                                     "sort", "markdup", "rgstats")

        Each op is an operator instance (``FilterOp`` and the others), a
        name, or a ``(name, *args)`` tuple. On a device-backed dataset
        the chain stays on the device: transforms compact, permute and
        patch the device columns, reductions bring back only result
        rows, and no host record is parsed; a host dataset runs the same
        operators' host paths with the same outputs. ``stats`` maps each
        op's name to its merged result (markdup counts, per-RG stats,
        pileup coverage). After a ``sort`` the header says
        ``SO:coordinate``."""
        from disq_tpu_torch.runtime.oppipe import OpPipeline

        pipe = ops[0] if len(ops) == 1 and isinstance(ops[0], OpPipeline) \
            else OpPipeline(*ops, device=self.device)
        res = pipe.run([self.reads])
        header = self.header
        if any(op.name == "sort" for op in pipe.ops):
            header = header.with_sort_order("coordinate")
        out = ReadsDataset(header=header, reads=res.batches[0],
                           counters=self.counters, device=self.device)
        return out, res.stats


class ReadsStorage:
    """Entry point for reads (builder-style config, then read/write)."""

    def __init__(self, device=None) -> None:
        self._split_size: int = 128 * 1024 * 1024
        self._num_shards: Optional[int] = None
        self._device = device
        self._resident_decode = False
        self._reference_source_path: Optional[str] = None
        self._stringency = ValidationStringency.STRICT
        self._options = DisqOptions()

    @classmethod
    def make_default(cls, device=None) -> "ReadsStorage":
        return cls(device)

    def split_size(self, n: int) -> "ReadsStorage":
        self._split_size = n
        return self

    def num_shards(self, n: int) -> "ReadsStorage":
        """Write-shard count override (default: visible CUDA devices)."""
        self._num_shards = n
        return self

    def error_policy(self, policy: "ErrorPolicy | str") -> "ReadsStorage":
        """Corrupt-block policy of BAM and CRAM reads: ``strict``
        (default — raise ``CorruptBlockError`` with coordinates),
        ``skip`` (drop and count) or ``quarantine`` (drop and copy to
        the quarantine sidecar). The unit is a BGZF block of a BAM and a
        container of a CRAM."""
        self._options = self._options.with_policy(policy)
        return self

    def options(self, opts: DisqOptions) -> "ReadsStorage":
        """Replace the whole option set (policy, retries, backoff,
        quarantine dir, executor and writer sizing) in one call."""
        self._options = opts
        return self

    def executor_workers(self, n: int,
                         prefetch_shards: Optional[int] = None
                         ) -> "ReadsStorage":
        """Size the BAM and CRAM reads' shard executor: ``n`` workers
        overlap range reads, inflate or container decode across splits,
        with at most ``prefetch_shards`` splits ahead of the ordered
        emit (None ⇒ ``2 × n``). ``n=1`` (the default) runs splits in
        order on the caller's thread. The result is identical for any
        ``n``."""
        self._options = self._options.with_executor(n, prefetch_shards)
        return self

    def writer_workers(self, n: int,
                       prefetch_shards: Optional[int] = None
                       ) -> "ReadsStorage":
        """Size the BAM write pipeline: ``n`` workers overlap record
        encode, BGZF deflate and part staging across write shards, with
        at most ``prefetch_shards`` shards ahead of the ordered emit
        (None ⇒ ``2 × n``). Written files and indexes are byte-identical
        for any ``n``."""
        self._options = self._options.with_writer(n, prefetch_shards)
        return self

    def read_ledger(self, path: str) -> "ReadsStorage":
        """Make BAM and CRAM reads resumable: each decoded split is
        spilled under ``path`` as it emits, and a read run again with
        the same ledger decodes only the unfinished splits
        (``runtime/manifest.py:ReadLedger``)."""
        self._options = self._options.with_read_ledger(path)
        return self

    def validation_stringency(self, s: ValidationStringency
                              ) -> "ReadsStorage":
        """Stored as the reference stores it; no read consults it."""
        self._stringency = s
        return self

    def device(self, device) -> "ReadsStorage":
        self._device = device
        return self

    def reference_source_path(self, p: str) -> "ReadsStorage":
        """FASTA (with or without ``.fai``) for CRAM reference-based
        compression: omitted on write, required to read such data."""
        self._reference_source_path = p
        return self

    def resident_decode(self, enable: bool = True) -> "ReadsStorage":
        """Take the device route on the CPU too (its kernels' plain
        versions); on ``cuda`` it is always taken."""
        self._resident_decode = enable
        return self

    def device_deflate(self, enable: bool = True) -> "ReadsStorage":
        """Arm the device write path: every BGZF deflate of this
        storage's sinks runs the literal-Huffman coder (kernel W2) on the
        storage's device, and ``write(..., sort=True)`` of a device-backed
        dataset keeps the sorted records resident and gathers each
        shard's records with kernel W1. The blocks are valid BGZF that
        decompresses to the same bytes, but not the canonical zlib-6
        bytes. Env equivalent: ``DISQ_TPU_TORCH_DEVICE_DEFLATE``."""
        self._options = self._options.with_device_deflate(enable)
        return self

    def read_filter(self, spec: str) -> "ReadsStorage":
        """Push a ``samtools view``-style predicate and subsample into
        the BAM decode (``ops/rfilter.py``): ``"-f INT"`` require flag
        bits, ``"-F INT"`` exclude flag bits, ``"-q INT"`` minimum MAPQ,
        ``"-s SEED.FRAC"`` keep FRAC of read names (hash-seeded: mates
        travel together). A device-backed split builds its mask on the
        device (kernel F1) and compacts before any column crosses d2h;
        a host split applies the same mask in numpy. The spec is
        validated here. Env equivalent: ``DISQ_TPU_TORCH_READ_FILTER``."""
        self._options = self._options.with_read_filter(spec)
        return self

    def span_log(self, path: str) -> "ReadsStorage":
        """Point the process-wide JSONL span sink at ``path`` when a read
        through this storage starts (the input of
        ``scripts/trace_report.py``); see ``DisqOptions.span_log``."""
        from dataclasses import replace

        self._options = replace(self._options, span_log=path)
        return self

    def _resolved_device(self) -> torch.device:
        from disq_tpu_torch.util import resolve_device

        return resolve_device(self._device)

    def read(self, path: str) -> ReadsDataset:
        from disq_tpu_torch.formats import sam_format_from_path

        self._resolved_device()
        return sam_format_from_path(path).make_source(self).get_reads(path)

    def write(self, dataset: ReadsDataset, path: str, *options: WriteOption,
              sort: bool = False) -> None:
        from disq_tpu_torch.formats import sam_format_from_write_options

        self._resolved_device()
        if sort:
            from disq_tpu_torch.bgzf.codec import device_deflate_enabled

            dataset = dataset.coordinate_sorted(
                keep_resident=device_deflate_enabled(self))
        fmt = sam_format_from_write_options(
            path, _opt(options, ReadsFormatWriteOption, None))
        cardinality = _opt(options, FileCardinalityWriteOption,
                           _infer_cardinality(path))
        fmt.make_sink(self, cardinality).save(dataset, path, options)
