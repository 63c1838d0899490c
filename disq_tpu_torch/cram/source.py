"""CramSource — the split-parallel CRAM read path.

Reference parity: ``impl/formats/cram/CramSource.java``: container start
offsets are enumerated by walking container headers (payloads skipped);
containers are assigned to byte-range splits by the "container start in
[start, end)" first-owner rule; each split decodes its containers with
the reference supplied via ``reference_source_path`` (required for
reference-compressed data).

Splits run through the shard executor (``runtime/executor.py``), as the
BAM read's do: stage A range-reads every container a split owns (header
and payload in one read), stage B decodes them, and batches come back
in split order at any ``executor_workers``. Each split has its own
retrier and corrupt-container books (``ShardErrorContext.for_shard``),
and ``ReadsDataset.counters`` sums one ``ShardCounters`` per split.

On ``cuda`` (or with resident decode asked for on the CPU) a split
first parses and CRC-checks every block of its containers, then decodes
all their order-0 rANS streams in one launch (kernel B3, or B5 under
``DISQ_TPU_TORCH_DEVICE_RANS=legacy``); the other blocks decompress on
the host and the records assemble on the host, as in the reference.
Otherwise every block decodes with the host codec. The result is a host
``ReadBatch``.

Corrupt input follows the storage's ``ErrorPolicy``, one container at a
time: a container whose header, blocks, rANS streams or records fail
raises ``CorruptBlockError`` with its offset under strict, is dropped
under skip, and is also copied (header and payload) to the quarantine
sidecar under quarantine. A stream the kernel flags costs only its
container: the split's other streams keep what the one launch decoded,
and nothing is decoded again on the host. A missing reference raises
``MissingReferenceError``, and a CUDA build or launch failure raises,
under every policy.

With a read ledger (``ReadsStorage.read_ledger``) each split's batches
are spilled as they emit, with the split's counts; a read run again
loads the finished splits and fetches and decodes only the others (one
device launch each). Its counters equal those of an uninterrupted read.
"""

from __future__ import annotations

import functools
import struct
from typing import Dict, List, Tuple

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
from disq_tpu_torch.runtime.errors import (
    ErrorPolicy,
    MissingReferenceError,
    context_for_storage,
    is_transient,
)
from disq_tpu_torch.runtime.tracing import wrap_span

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
        from disq_tpu_torch.runtime.counters import (
            ShardCounters,
            reduce_counters,
        )
        from disq_tpu_torch.runtime.executor import (
            ShardTask,
            executor_for_storage,
            map_ordered_resumable,
            read_ledger_for_storage,
        )

        fs, path = resolve_path(path)
        ctx = context_for_storage(self._storage, path)
        header = ctx.retrier.call(read_cram_header, fs, path, what="header")
        ref_fetch = fetcher_for_storage(self._storage, header)
        containers = walk_container_offsets(fs, path, retrier=ctx.retrier,
                                            ctx=ctx)
        data_containers = [(off, hdr) for off, hdr in containers[1:]
                           if not hdr.is_eof]
        device = self._decode_device()
        tasks, owned_by_shard = [], []
        for i, s in enumerate(compute_path_splits(fs, path, self.split_size)):
            owned = [(off, hdr) for off, hdr in data_containers
                     if s.start <= off < s.end]
            shard_ctx = ctx.for_shard(i)
            owned_by_shard.append(owned)
            # per-split spans carrying the shard id, byte range and
            # owned-container count
            tasks.append(ShardTask(
                shard_id=i,
                fetch=wrap_span(
                    "cram.split.fetch",
                    functools.partial(self._fetch_split_containers, fs,
                                      path, owned, shard_ctx),
                    shard=i, start=s.start, end=s.end,
                    containers=len(owned)),
                decode=wrap_span(
                    "cram.split.decode",
                    functools.partial(self._decode_booked,
                                      ref_fetch=ref_fetch,
                                      shard_ctx=shard_ctx, device=device),
                    shard=i, containers=len(owned)),
                retrier=shard_ctx.retrier, what=f"cram-shard{i}"))
        ledger = read_ledger_for_storage(self._storage, path, len(tasks),
                                         device is not None)
        batches: List[ReadBatch] = []
        shard_counters = []
        for res in map_ordered_resumable(executor_for_storage(self._storage),
                                         tasks, ledger):
            shard_batches, (skipped, quarantined, retried) = res.value
            owned = owned_by_shard[res.shard_id]
            batches.extend(shard_batches)
            shard_counters.append(ShardCounters(
                shard_id=res.shard_id,
                records=sum(b.count for b in shard_batches),
                blocks=len(owned),
                bytes_compressed=sum(h.length for _, h in owned),
                wall_seconds=res.wall_seconds, skipped_blocks=skipped,
                quarantined_blocks=quarantined, retried_reads=retried))
        counters = reduce_counters(shard_counters)
        # the header read and the walk book on the read's own context,
        # outside every shard
        counters.retried_reads += ctx.retrier.retried
        counters.skipped_blocks += ctx.skipped_blocks
        counters.quarantined_blocks += ctx.quarantined_blocks
        return ReadsDataset(header=header, reads=ReadBatch.concat(batches),
                            counters=counters,
                            device=self._storage._resolved_device())

    # -- internals ----------------------------------------------------------

    def _fetch_split_containers(self, fs, path: str, owned, shard_ctx
                                ) -> List[Tuple[int, int, bytes]]:
        """Stage A: range-read every container this split owns, header
        and payload in one read: ``[(offset, header size, bytes), …]``.
        Transient faults propagate (the executor retries the fetch); a
        container whose header no longer parses goes to the policy and
        is left out."""
        # a retried attempt must not count the previous attempt's
        # corrupt containers again (sidecar writes are idempotent)
        shard_ctx.skipped_blocks = 0
        shard_ctx.quarantined_blocks = 0
        length = fs.get_file_length(path)
        items = []
        for off, hdr in owned:
            try:
                h, hdr_size = read_container_header_at(fs, path, off, length)
                raw = fs.read_range(path, off, hdr_size + h.length)
            except Exception as e:  # noqa: BLE001 — classified below
                if is_transient(e):
                    raise
                self._handle_corrupt_container(fs, path, off, hdr, e,
                                               shard_ctx)
                continue
            items.append((off, hdr_size, raw))
        return items

    def _decode_booked(self, items, ref_fetch, shard_ctx, device
                       ) -> Tuple[List[ReadBatch], Tuple[int, int, int]]:
        """Stage B with the split's books: (batches, (skipped,
        quarantined, retried)), final once the decode returns, and
        spilled with the batches under a read ledger."""
        batches = self._decode_split_containers(items, ref_fetch, shard_ctx,
                                                device)
        return batches, (shard_ctx.skipped_blocks,
                         shard_ctx.quarantined_blocks,
                         shard_ctx.retrier.retried)

    def _decode_split_containers(self, items, ref_fetch, shard_ctx,
                                 device) -> List[ReadBatch]:
        """Stage B: decode the staged containers under the shard's
        policy. Parse and CRC-check every block, decode every order-0
        rANS stream in one launch on ``device`` (when given), then
        decompress the rest and assemble the records container by
        container. A container that failed at any step goes to the
        policy in container order (strict raises ``CorruptBlockError``
        with its offset; quarantine copies header and payload)."""
        errors: Dict[int, BaseException] = {}
        stored: Dict[int, list] = {}
        for ci, (_off, hdr_size, raw) in enumerate(items):
            try:
                stored[ci] = read_stored_blocks(raw[hdr_size:])
            except Exception as e:  # noqa: BLE001 — classified below
                errors[ci] = _corruption(e)
        decoded: Dict[Tuple[int, int], bytes] = {}
        if device is not None:
            decoded = self._decode_rans0(stored, device, errors)
        batches = []
        for ci, (off, _hdr_size, raw) in enumerate(items):
            error = errors.get(ci)
            if error is None:
                try:
                    blocks = [b.decompress(decoded.get((ci, bi)))
                              for bi, b in enumerate(stored[ci])]
                    batches.append(records_from_blocks(blocks, ref_fetch))
                    continue
                except Exception as e:  # noqa: BLE001 — classified below
                    error = _corruption(e)
            shard_ctx.handle_corrupt_block(error, block_offset=off, raw=raw,
                                           kind="CRAM container")
        return batches

    @staticmethod
    def _decode_rans0(stored, device, errors
                      ) -> Dict[Tuple[int, int], bytes]:
        """Every order-0 rANS stream of the split's parsed containers,
        decoded in one launch: ``{(container index, block index):
        bytes}``. A stream that does not parse or that the kernel flags
        marks its container in ``errors`` (its lowest such stream's
        error); the other streams keep their output."""
        from disq_tpu_torch.cram.rans import rans0_decode_streams

        keys = [(ci, bi) for ci, blocks in stored.items()
                for bi, b in enumerate(blocks) if b.is_rans0]
        if not keys:
            return {}
        bad: Dict[int, BaseException] = {}
        outs = rans0_decode_streams(
            [stored[ci][bi].comp for ci, bi in keys], device, bad)
        for k in sorted(bad):
            errors.setdefault(keys[k][0], bad[k])
        return {key: out for key, out in zip(keys, outs) if out is not None}

    @staticmethod
    def _handle_corrupt_container(fs, path: str, offset: int, hdr, error,
                                  shard_ctx) -> None:
        """The policy for a container that failed before its bytes were
        staged: quarantine re-reads them best-effort (the walk's length
        plus 1 KiB); skip and strict read nothing."""
        raw = b""
        if shard_ctx.policy is ErrorPolicy.QUARANTINE:
            try:
                length = fs.get_file_length(path)
                raw = fs.read_range(path, offset,
                                    min(hdr.length + 1024,
                                        max(0, length - offset)))
            except Exception:  # noqa: BLE001 — forensics best-effort
                raw = b""
        shard_ctx.handle_corrupt_block(error, block_offset=offset, raw=raw,
                                       kind="CRAM container")


def _corruption(error: BaseException) -> BaseException:
    """``error`` if it marks a corrupt container; re-raised when it is
    not corruption (a missing reference, a CUDA build or launch failure)
    or is transient (the executor refetches the shard)."""
    if isinstance(error, _NOT_CORRUPTION) or is_transient(error):
        raise error
    return error
