"""Public API — ``ReadsStorage`` / ``ReadsDataset`` and ``VariantsStorage``
/ ``VariantsDataset``, as in ``disq_tpu``.

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

    # an interval read through the BAI (or CRAI), and a remote read
    tp = TraversalParameters([Interval("chr1", 1, 100_000)],
                             traverse_unplaced_unmapped=True)
    ds = storage.read("sorted.bam", traversal=tp)
    ds = storage.http_cache_blocks(64).read("https://host/sample.bam")

    # text SAM, read and written through the same storage
    storage.write(ds, "out.sam"); storage.read("out.sam").flagstat()

    # telemetry: per-shard spans to a JSONL file, and the registry
    ds = storage.span_log("spans.jsonl").read("sample.bam")
    ds.telemetry_report()["phases"]

    # resilience and live observability, each off until set
    storage.hedged_fetches(0.95).shard_deadline(30.0).retry_budget(20)
    storage.circuit_breaker(5, 1.0).postmortem_dir("postmortem/")
    storage.introspect_port(0).watchdog(10.0).progress_log("p.jsonl")
    ds = storage.profile_hz(99).read("sample.bam")
    ds.introspect_address()   # "127.0.0.1:<port>": /metrics, /healthz, ...

    # the shard scheduler: this process serves the queue of splits, and
    # others join it (DISQ_TPU_TORCH_SCHED=host:port) and lease from it
    ds = storage.scheduler("serve", lease_n=2, lease_s=10.0).read("x.bam")

    # the serving edge: region queries over HTTP, each cache-missing
    # block inflated on the card; a fleet router over such replicas
    handle = serve({"wgs": "sorted.bam", "calls": "v.vcf.bgz"}, port=0)
    fleet = serve_fleet(["127.0.0.1:8765", "127.0.0.1:8766"],
                        datasets={"wgs": "sorted.bam"})

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
    from disq_tpu_torch.runtime.introspect import introspect_address
    from disq_tpu_torch.runtime.multihost import process_id

    snapshot = tracing.telemetry_snapshot()

    def family(keep):
        return {name: series for kind in snapshot.values()
                for name, series in kind.items() if keep(name)}

    return {
        "run_id": tracing.RUN_ID,
        "process_id": process_id(),
        "counters": counters.as_dict() if counters is not None else {},
        "metrics": snapshot,
        "device": family(lambda n: n.startswith("device.")),
        "resilience": family(lambda n: n.split(".", 1)[0] in (
            "hedge", "breaker", "budget", "deadline")),
        "phases": tracing.phase_report(),
        "gauges": tracing.gauge_report(),
        "span_log": tracing.span_log_path(),
        "introspect": introspect_address(),
    }


def _introspect_address() -> "str | None":
    from disq_tpu_torch.runtime.introspect import introspect_address

    return introspect_address()


class _PlaneKnobs:
    """The resilience, observability and scheduler builders both
    storages share (``DisqOptions``' knobs of ``runtime/resilience.py``,
    ``introspect.py``, ``flightrec.py``, ``profiler.py`` and
    ``scheduler.py``)."""

    def introspect_port(self, port: int):
        """Serve the process-wide introspection endpoint (``/metrics``,
        ``/healthz``, ``/progress``, ``/spans``, ``/slo``, ``/debug/*``)
        on 127.0.0.1:``port`` when a pipeline built from this storage
        runs; 0 binds an ephemeral port (read it back with
        ``dataset.introspect_address()``). Env equivalent:
        ``DISQ_TPU_TORCH_INTROSPECT_PORT``."""
        from dataclasses import replace

        self._options = replace(self._options, introspect_port=int(port))
        return self

    def watchdog(self, stall_s: float, policy: str = "warn"):
        """Flag any shard whose active pipeline stage has been silent
        ``stall_s`` seconds (``watchdog.stalled_shards``, a
        ``watchdog.stall`` span, ``/healthz`` degraded);
        ``policy="abort"`` also cancels the run with a
        ``WatchdogStallError``."""
        self._options = self._options.with_watchdog(stall_s, policy)
        return self

    def progress_log(self, path: str):
        """Append periodic JSONL progress lines (shards done / in flight
        / total, records, rolling records/s, ETA) to ``path`` while
        pipelines run."""
        from dataclasses import replace

        self._options = replace(self._options, progress_log=path)
        return self

    def hedged_fetches(self, quantile: float = 0.95, min_s: float = 0.05):
        """Hedge split fetches: a fetch outliving the rolling
        ``quantile`` of this run's fetch latencies (never less than
        ``min_s``) races a duplicate, and the first result wins
        (``hedge.launched``, ``hedge.won``, ``hedge.wasted_bytes``). The
        result is the same either way; the decode kernels run once per
        split."""
        self._options = self._options.with_hedging(quantile, min_s)
        return self

    def shard_deadline(self, deadline_s: float):
        """Give every split a wall-clock budget: retry while young, a
        forced hedge past half of it, then ``DeadlineExceededError``,
        which skip and quarantine turn into one set-aside empty split."""
        self._options = self._options.with_shard_deadline(deadline_s)
        return self

    def retry_budget(self, tokens: int, refill_per_success: float = 0.1):
        """Install the process-wide retry token bucket: a retry spends a
        token, a success refills ``refill_per_success``, a dry bucket
        denies the retry (``budget.*``, the fill on ``/healthz``)."""
        self._options = self._options.with_retry_budget(
            tokens, refill_per_success)
        return self

    def circuit_breaker(self, window: int, cooldown_s: float = 1.0):
        """Arm the per-filesystem circuit breaker: ``window`` consecutive
        transient failures open it, calls then fail fast with
        ``BreakerOpenError`` until a probe after ``cooldown_s`` succeeds
        (``breaker.*``, the state on ``/healthz``)."""
        self._options = self._options.with_breaker(window, cooldown_s)
        return self

    def postmortem_dir(self, path: str):
        """Arm the flight recorder: recent decisions in a bounded ring,
        and a postmortem bundle under ``path`` on every abort (see
        ``runtime/flightrec.py``). Env equivalent:
        ``DISQ_TPU_TORCH_POSTMORTEM_DIR``."""
        self._options = self._options.with_postmortem(path)
        return self

    def profile_hz(self, hz: float):
        """Start the sampling profiler at ``hz``: stacks folded by
        thread role (``fetch``, ``decode``, ...), served on
        ``/debug/profile`` and kept in a postmortem bundle. Env
        equivalent: ``DISQ_TPU_TORCH_PROFILE_HZ``."""
        self._options = self._options.with_profile(hz)
        return self

    def scheduler(self, mode: str, lease_n: int = 2, lease_s: float = 10.0,
                  steal: bool = True, run_weight: float = 1.0,
                  failover_dir: Optional[str] = None):
        """Lease this storage's splits from the shard scheduler
        (``runtime/scheduler.py``): ``"serve"`` hosts the shared queue on
        this process's introspection endpoint and works, ``"host:port"``
        joins it, ``"auto"`` finds it through ``failover_dir``. A worker
        leases ``lease_n`` splits at a time, a lease unfinished after
        ``lease_s`` seconds goes back to the queue, ``steal`` lets an
        idle worker take a stale lease, ``run_weight`` is the run's
        share when runs contend, and ``failover_dir`` arms coordinator
        failover. A write with a ``StageManifestWriteOption`` leases its
        shards too. BCF reads keep the static split loop. Env
        equivalents: ``DISQ_TPU_TORCH_SCHED`` and
        ``DISQ_TPU_TORCH_SCHED_{LEASE_N,LEASE_S,STEAL,WEIGHT,FAILOVER}``."""
        self._options = self._options.with_scheduler(
            mode, lease_n, lease_s, steal, run_weight, failover_dir)
        return self


class WriteOption:
    """Marker base for varargs write options."""


class ReadsFormatWriteOption(WriteOption, enum.Enum):
    BAM = "bam"
    CRAM = "cram"
    SAM = "sam"


class VariantsFormatWriteOption(WriteOption, enum.Enum):
    VCF = "vcf"
    VCF_GZ = "vcf.gz"
    VCF_BGZ = "vcf.bgz"
    BCF = "bcf"


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


class TabixIndexWriteOption(WriteOption, enum.Enum):
    ENABLE = True
    DISABLE = False


class ValidationStringency(enum.Enum):
    STRICT = "strict"
    LENIENT = "lenient"
    SILENT = "silent"


@dataclass(frozen=True)
class Interval:
    """A 1-based closed genomic interval (htsjdk ``Locatable``)."""

    contig: str
    start: int  # 1-based inclusive
    end: int    # inclusive

    def overlaps(self, contig: str, start: int, end: int) -> bool:
        return self.contig == contig and self.start <= end and start <= self.end


@dataclass(frozen=True)
class TraversalParameters:
    """Interval and unplaced-unmapped traversal of an indexed read (BAM
    with its ``.bai``, CRAM with its ``.crai``; htsjdk's
    ``HtsjdkReadsTraversalParameters``)."""

    intervals: Optional[Sequence[Interval]] = None
    traverse_unplaced_unmapped: bool = False


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
    if path.lower().endswith((".bam", ".cram", ".sam", ".vcf", ".vcf.gz",
                              ".vcf.bgz", ".bcf")):
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

    def introspect_address(self) -> "str | None":
        """``host:port`` of the process's introspection endpoint, or None
        when it is off (``runtime/introspect.py``)."""
        return _introspect_address()

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


class ReadsStorage(_PlaneKnobs):
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

    def http_cache_blocks(self, n: int) -> "ReadsStorage":
        """Size the remote filesystem's block LRU (``fsw/http.py``;
        default 32 blocks of 4 MiB): applied to every registered HTTP
        wrapper when a split read through this storage starts, and the
        default for wrappers built later. Occupancy is the
        ``fsw.http.cache.blocks`` gauge. Env equivalent:
        ``DISQ_TPU_TORCH_HTTP_CACHE_BLOCKS``."""
        self._options = self._options.with_http_cache_blocks(n)
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

    def read(self, path: str,
             traversal: Optional[TraversalParameters] = None) -> ReadsDataset:
        """Read ``path`` (a local path or an ``http(s)://``, ``gs://`` or
        ``s3://`` URI). With ``traversal``, only the records overlapping
        its intervals (and the unplaced-unmapped ones, if asked for),
        through the file's BAI or CRAI."""
        from disq_tpu_torch.formats import sam_format_from_path
        from disq_tpu_torch.runtime import flightrec

        self._resolved_device()
        try:
            return sam_format_from_path(path).make_source(self).get_reads(
                path, traversal)
        except Exception as e:
            # the backstop for aborts outside the executor (split
            # planning, the header); an abort already bundled is not
            # bundled again
            flightrec.note_abort(e, where="read")
            raise

    def write(self, dataset: ReadsDataset, path: str, *options: WriteOption,
              sort: bool = False) -> None:
        from disq_tpu_torch.formats import sam_format_from_write_options

        self._resolved_device()
        if sort:
            from disq_tpu_torch.bgzf.codec import device_deflate_enabled

            dataset = dataset.coordinate_sorted(
                keep_resident=device_deflate_enabled(self))
        from disq_tpu_torch.runtime import flightrec

        fmt = sam_format_from_write_options(
            path, _opt(options, ReadsFormatWriteOption, None))
        cardinality = _opt(options, FileCardinalityWriteOption,
                           _infer_cardinality(path))
        try:
            fmt.make_sink(self, cardinality).save(dataset, path, options)
        except Exception as e:
            flightrec.note_abort(e, where="write")
            raise


@dataclass
class VariantsDataset:
    """Header + columnar variants (a host ``VariantBatch``), and the
    read's counters (records, blocks, skipped and quarantined blocks,
    retried reads)."""

    header: "VcfHeader"
    variants: "VariantBatch"
    counters: object = None

    def count(self) -> int:
        return int(self.variants.count)

    def telemetry_report(self) -> dict:
        """See ``ReadsDataset.telemetry_report``."""
        return _telemetry_report(self.counters)

    def introspect_address(self) -> "str | None":
        """See ``ReadsDataset.introspect_address``."""
        return _introspect_address()


class VariantsStorage(_PlaneKnobs):
    """Entry point for variants: VCF (plain, gzip, BGZF) and BCF, with
    the tabix index (chained configuration, then read/write)::

        storage = VariantsStorage.make_default().split_size(64 << 20)
        ds = storage.read("cohort.vcf.bgz")          # B1 on cuda
        storage.write(ds, "out.vcf.bgz", TabixIndexWriteOption.ENABLE)
        ds = storage.read("out.vcf.bgz", intervals=[Interval("chr1", 1, 10_000)])
        storage.write(ds, "out.bcf"); storage.read("out.bcf")

    It takes the device rule of ``ReadsStorage``: ``cuda`` unless asked
    for another device, and without CUDA ``read`` and ``write`` raise.
    On ``cuda`` every BGZF inflate of a VCF.bgz or BCF read runs the
    device inflate kernel, and the text comes back to the host for the
    line parse; on the CPU the host codec inflates, unless
    ``.resident_decode()`` asks for the device route's plain versions.
    """

    def __init__(self, device=None) -> None:
        self._split_size: int = 128 * 1024 * 1024
        self._num_shards: Optional[int] = None
        self._device = device
        self._resident_decode = False
        self._options = DisqOptions()

    @classmethod
    def make_default(cls, device=None) -> "VariantsStorage":
        return cls(device)

    def split_size(self, n: int) -> "VariantsStorage":
        self._split_size = n
        return self

    def num_shards(self, n: int) -> "VariantsStorage":
        """Write-shard count override (default: visible CUDA devices)."""
        self._num_shards = n
        return self

    def device(self, device) -> "VariantsStorage":
        self._device = device
        return self

    def error_policy(self, policy: "ErrorPolicy | str") -> "VariantsStorage":
        """Corrupt-block policy of VCF.bgz reads (see
        ``ReadsStorage.error_policy``): a skipped block's lines drop."""
        self._options = self._options.with_policy(policy)
        return self

    def options(self, opts: DisqOptions) -> "VariantsStorage":
        self._options = opts
        return self

    def executor_workers(self, n: int,
                         prefetch_shards: Optional[int] = None
                         ) -> "VariantsStorage":
        """Shard executor sizing for variant reads (VCF text, BGZF-split
        VCF, BCF block inflate); see ``ReadsStorage.executor_workers``."""
        self._options = self._options.with_executor(n, prefetch_shards)
        return self

    def writer_workers(self, n: int,
                       prefetch_shards: Optional[int] = None
                       ) -> "VariantsStorage":
        """Write pipeline sizing for variant writes (VCF plain, gzip,
        BGZF, BCF); see ``ReadsStorage.writer_workers``."""
        self._options = self._options.with_writer(n, prefetch_shards)
        return self

    def span_log(self, path: str) -> "VariantsStorage":
        """See ``ReadsStorage.span_log``."""
        from dataclasses import replace

        self._options = replace(self._options, span_log=path)
        return self

    def read_ledger(self, path: str) -> "VariantsStorage":
        """See ``ReadsStorage.read_ledger``."""
        self._options = self._options.with_read_ledger(path)
        return self

    def http_cache_blocks(self, n: int) -> "VariantsStorage":
        """See ``ReadsStorage.http_cache_blocks``."""
        self._options = self._options.with_http_cache_blocks(n)
        return self

    def resident_decode(self, enable: bool = True) -> "VariantsStorage":
        """Take the device inflate route on the CPU too (its kernels'
        plain versions); on ``cuda`` it is always taken."""
        self._resident_decode = enable
        return self

    def device_deflate(self, enable: bool = True) -> "VariantsStorage":
        """See ``ReadsStorage.device_deflate``: every BGZF deflate of
        this storage's sinks (VCF_BGZ parts and header, BCF blocks) runs
        the literal-Huffman coder (kernel W2) on the storage's device."""
        self._options = self._options.with_device_deflate(enable)
        return self

    def _resolved_device(self) -> torch.device:
        from disq_tpu_torch.util import resolve_device

        return resolve_device(self._device)

    def read(self, path: str,
             intervals: Optional[Sequence[Interval]] = None
             ) -> VariantsDataset:
        """Read a VCF (plain, gzip or BGZF) or a BCF; with ``intervals``,
        only the variants overlapping them (through the ``.tbi`` when a
        BGZF VCF has one)."""
        from disq_tpu_torch.runtime import flightrec

        self._resolved_device()
        try:
            if path.lower().endswith(".bcf"):
                from disq_tpu_torch.vcf.bcf import BcfSource

                return BcfSource(self).get_variants(path, intervals)
            from disq_tpu_torch.vcf.source import VcfSource

            return VcfSource(self).get_variants(path, intervals)
        except Exception as e:
            flightrec.note_abort(e, where="read")
            raise

    def write(self, dataset: VariantsDataset, path: str,
              *options: WriteOption) -> None:
        self._resolved_device()
        fmt_opt = _opt(options, VariantsFormatWriteOption, None)
        single = _opt(options, FileCardinalityWriteOption,
                      _infer_cardinality(path)) \
            is FileCardinalityWriteOption.SINGLE
        if fmt_opt is VariantsFormatWriteOption.BCF or (
                fmt_opt is None and path.lower().endswith(".bcf")):
            from disq_tpu_torch.vcf.bcf import BcfSink, BcfSinkMultiple

            sink = BcfSink(self) if single else BcfSinkMultiple(self)
        else:
            from disq_tpu_torch.vcf.sink import VcfSink, VcfSinkMultiple

            sink = VcfSink(self) if single else VcfSinkMultiple(self)
        from disq_tpu_torch.runtime import flightrec

        try:
            sink.save(dataset, path, options)
        except Exception as e:
            flightrec.note_abort(e, where="write")
            raise


class ServeHandle:
    """Handle on the serving plane started by :func:`serve`.

    ``address`` is the ``host:port`` of the HTTP endpoint now answering
    ``POST /query/reads``, ``/query/variants``, ``/query/stats``,
    ``/query/markdup-stats``, ``/query/pileup``, ``/query/filtered-count``,
    ``POST /serve/register`` and ``GET /serve/stats`` beside the
    introspection endpoints. ``close()`` stops the daemon (and the HTTP
    server, when :func:`serve` started it)."""

    def __init__(self, address: str, daemon, owns_server: bool) -> None:
        self.address = address
        self.daemon = daemon
        self._owns_server = owns_server

    def register(self, name: str, path: str, kind: str = None) -> dict:
        """Register a dataset by path; ``kind`` ('reads' | 'variants') is
        taken from the extension when omitted."""
        return self.daemon.register(name, path, kind)

    def stats(self) -> dict:
        return self.daemon.stats()

    def close(self) -> None:
        from disq_tpu_torch.runtime import serve as serve_mod
        from disq_tpu_torch.runtime.introspect import stop_introspect_server

        serve_mod.stop_serve()
        if self._owns_server:
            stop_introspect_server()

    def __enter__(self) -> "ServeHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def serve(datasets: dict = None, *, port: int = 0, options=None,
          device=None, tenant_slots: int = None, tenant_queue: int = None,
          compressed_cache_mb: int = None,
          decoded_cache_mb: int = None,
          parsed_cache_mb: int = None) -> ServeHandle:
    """Start the long-lived multi-tenant interval-query daemon
    (``runtime/serve.py``) on ``device`` (``cuda`` unless the caller
    asks for another; on the CPU it inflates with host zlib) and return
    a :class:`ServeHandle`.

    ``datasets`` maps name -> path to register at once; more can be
    added with ``handle.register`` or ``POST /serve/register``. Queries
    are answered over the HTTP endpoint with every cache-missing block of
    a request inflated in one device batch (coalesced across requests by
    the device service when ``DISQ_TPU_TORCH_DEVICE_SERVICE=1``), a
    shared hot cache (compressed blocks, decoded payloads, parsed chunk
    batches), and per-tenant admission (``tenant_slots`` concurrent
    requests per tenant and a ``tenant_queue``-deep wait queue; beyond
    that a tenant's requests are shed with 429)."""
    from disq_tpu_torch.runtime import serve as serve_mod
    from disq_tpu_torch.runtime.introspect import introspect_address

    kwargs = {"options": options, "device": device}
    for key, value in (("tenant_slots", tenant_slots),
                       ("tenant_queue", tenant_queue),
                       ("compressed_cache_mb", compressed_cache_mb),
                       ("decoded_cache_mb", decoded_cache_mb),
                       ("parsed_cache_mb", parsed_cache_mb)):
        if value is not None:
            kwargs[key] = value
    owns_server = introspect_address() is None
    address = serve_mod.start_serve(port, **kwargs)
    handle = ServeHandle(address, serve_mod.serve_if_running(),
                         owns_server)
    for name, path in (datasets or {}).items():
        handle.register(name, path)
    return handle


class FleetHandle:
    """Handle on the fleet routing tier started by :func:`serve_fleet`.

    ``address`` is the ``host:port`` of the HTTP endpoint now answering
    ``POST /fleet/query/*``, ``POST /fleet/register`` and
    ``GET /fleet/stats``. ``close()`` stops the router (and the HTTP
    server, when :func:`serve_fleet` started it)."""

    def __init__(self, address: str, router, owns_server: bool) -> None:
        self.address = address
        self.router = router
        self._owns_server = owns_server

    def register(self, name: str, path: str, kind: str = None) -> dict:
        """Fan a dataset registration out to every live replica (each
        bumps the dataset's epoch and drops its stale cache entries)."""
        status, doc = self.router.register(name, path, kind)
        if status != 200:
            raise RuntimeError(doc.get("error", f"HTTP {status}"))
        return doc

    def query(self, endpoint: str, doc: dict) -> tuple:
        """Route one query (``endpoint``: 'reads', 'variants', 'stats',
        ...) -> ``(status, body)``."""
        return self.router.query(f"/query/{endpoint}", doc)

    def stats(self) -> dict:
        return self.router.stats()

    def close(self) -> None:
        from disq_tpu_torch.runtime import fleet as fleet_mod
        from disq_tpu_torch.runtime.introspect import stop_introspect_server

        fleet_mod.stop_fleet()
        if self._owns_server:
            stop_introspect_server()

    def __enter__(self) -> "FleetHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


_FLEET_UNSET = object()  # None is meaningful (hedging off)


def serve_fleet(replicas, *, port: int = 0, datasets: dict = None,
                policy: str = "locality",
                hedge_quantile: float = _FLEET_UNSET,
                hedge_min_s: float = None,
                tenant_slots: int = None, tenant_queue: int = None,
                refresh_s: float = None,
                probe_s: float = None) -> FleetHandle:
    """Start the fleet routing tier (``runtime/fleet.py``) over
    ``replicas`` (``host:port`` serving endpoints) and return a
    :class:`FleetHandle`.

    A query sent to ``/fleet/query/*`` is forwarded to the replica whose
    hot-block cache already holds its blocks (digest overlap from each
    replica's ``/serve/cachemap``), hedged to the runner-up past the
    rolling latency quantile (``hedge_quantile``; None turns hedging
    off), and admitted against the fleet-wide sum of the replicas'
    tenant capacity. The router runs no kernel: its replicas do."""
    from disq_tpu_torch.runtime import fleet as fleet_mod
    from disq_tpu_torch.runtime.introspect import introspect_address

    kwargs = {"policy": policy}
    if hedge_quantile is not _FLEET_UNSET:
        kwargs["hedge_quantile"] = hedge_quantile
    for key, value in (("hedge_min_s", hedge_min_s),
                       ("tenant_slots", tenant_slots),
                       ("tenant_queue", tenant_queue),
                       ("refresh_s", refresh_s), ("probe_s", probe_s)):
        if value is not None:
            kwargs[key] = value
    owns_server = introspect_address() is None
    address = fleet_mod.start_fleet(list(replicas), port, **kwargs)
    handle = FleetHandle(address, fleet_mod.fleet_if_running(),
                         owns_server)
    for name, path in (datasets or {}).items():
        handle.register(name, path)
    return handle
