"""BamSource — the split-parallel BAM read path.

The header is read on the host; the file is cut into byte-range splits;
each split resolves its first whole-record boundary — from the ``.sbi``
splitting index when present, else by the ``BgzfBlockGuesser`` +
``BamRecordGuesser`` chain — and decodes records from its own boundary
up to the next split's, reading past its byte-range end to finish the
straddling record.

Splits run through the shard executor (``runtime/executor.py``): stage
A range-reads and walks a split's compressed blocks, stage B inflates
and decodes them, and batches come back in split order, so with
``executor_workers > 1`` the reads of one split overlap the decode of
another while the result stays identical.

On ``cuda`` (or with resident decode asked for on the CPU) a split's
blocks inflate with the device kernel into one device blob (B1, or B4
under ``DISQ_TPU_TORCH_DEVICE_INFLATE=legacy``), the record offsets are
scanned on the blob's host copy, and the parse kernel turns the device
blob into device columns. Otherwise the split inflates and parses on
the host.

Corrupt input follows the storage's ``ErrorPolicy``: the fault-free
path is one batch inflate per split; only when it fails does the
per-block host salvage run (STRICT raises ``CorruptBlockError`` with
the block's coordinates, SKIP and QUARANTINE drop that block's records).
On the device route only the blocks the kernel flagged or whose CRC
failed inflate alone on the host; the good blocks keep the bytes the
kernel decoded, and their record runs are parsed on the device, so the
dataset stays device-backed. A block that inflates alone on the host
after the batch flagged it makes the read raise the batch's error: a
kernel fault is never served as a salvaged batch (on the host route,
the same holds when every block inflates alone).

An indexed read (``read(path, traversal=...)``) decodes only the BAI
chunks its intervals select (``traversal/bai_query.py``), each through
the same fetch and decode stages as a split (``_decode_range``), on the
same route and with the read filter applied; transient faults retry the
whole traversal, and a corrupt block raises under every policy.

With a read ledger (``ReadsStorage.read_ledger``) each split's batch is
spilled as it emits, with its counts; a read run again loads the
finished splits (a device-backed one parses its spilled bytes again on
the device with the parse kernel) and fetches and inflates only the
others. Its counters equal those of an uninterrupted read.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np

from disq_tpu_torch.bam.codec import (
    decode_records,
    scan_record_offsets,
    scan_record_offsets_tolerant,
)
from disq_tpu_torch.bam.columnar import ReadBatch
from disq_tpu_torch.bam.guesser import BamRecordGuesser
from disq_tpu_torch.bam.header import SamHeader
from disq_tpu_torch.bgzf.block import BGZF_EOF_MARKER, BgzfBlock, make_virtual_offset
from disq_tpu_torch.bgzf.codec import (
    BgzfReader,
    inflate_blocks,
    inflate_blocks_device,
)
from disq_tpu_torch.bgzf.guesser import (
    BgzfBlockGuesser,
    walk_blocks_collect,
    walk_blocks_salvage,
)
from disq_tpu_torch.fsw.filesystem import (
    FileSystemWrapper,
    PathSplit,
    compute_path_splits,
    resolve_path,
)
from disq_tpu_torch.index.sbi import SbiIndex
from disq_tpu_torch.runtime.columnar import (
    ColumnarBatch,
    DeviceParseFault,
    resident_decode_enabled,
)
from disq_tpu_torch.runtime.errors import (
    ErrorPolicy,
    FetchAttempt,
    FlaggedBlocksError,
    ShardErrorContext,
    TruncatedReadError,
    committed,
    context_for_storage,
    inflate_blocks_salvage,
    salvage_flagged,
)
from disq_tpu_torch.runtime.tracing import span, trace_phase


def read_header(fs: FileSystemWrapper, path: str) -> Tuple[SamHeader, int]:
    """(header, virtual offset of the first record)."""
    with fs.open(path) as raw:
        r = BgzfReader(raw)
        header = SamHeader.from_bam_stream(r)
        return header, r.tell_virtual()


class BamSource:
    def __init__(self, storage):
        self._storage = storage
        self._last_counters = []

    @property
    def split_size(self) -> int:
        return self._storage._split_size

    def get_reads(self, path: str, traversal=None):
        from disq_tpu_torch.api import ReadsDataset
        from disq_tpu_torch.runtime.counters import reduce_counters
        from disq_tpu_torch.runtime.debug import (
            check_read_batch,
            debug_enabled,
        )

        fs, path = resolve_path(path)
        ctx = context_for_storage(self._storage, path)
        device = self._storage._resolved_device()
        with trace_phase("bam.read.header"):
            header, first_voffset = ctx.retrier.call(read_header, fs, path,
                                                     what="header")
        if traversal is not None:
            from disq_tpu_torch.traversal.bai_query import read_with_traversal

            # an index-driven read retries transient faults whole-phase
            # (it is bounded by its intervals); a corrupt block inside
            # the traversal always raises, whatever the policy
            with trace_phase("bam.read.traversal"):
                batch = ctx.retrier.call(read_with_traversal, fs, path,
                                         header, traversal, self,
                                         what="traversal")
            totals = reduce_counters([])
            totals.retried_reads += ctx.retrier.retried
            return ReadsDataset(header=header, reads=batch, counters=totals,
                                device=device)
        with trace_phase("bam.read.splits"):
            batches = self.read_split_batches(fs, path, header,
                                              first_voffset, ctx=ctx)
            batch = ColumnarBatch.concat(batches)
        if debug_enabled():
            check_read_batch(batch, n_ref=header.n_ref)
        totals = reduce_counters(self._last_counters)
        # header and boundary reads retry outside any shard
        totals.retried_reads += ctx.retrier.retried
        return ReadsDataset(header=header, reads=batch, counters=totals,
                            device=device)

    # -- split machinery ----------------------------------------------------

    def read_split_batches(self, fs: FileSystemWrapper, path: str,
                           header: SamHeader, first_voffset: int,
                           split_size: Optional[int] = None,
                           ctx=None) -> List:
        """One batch per split (``split_size`` bytes, the source's own
        unless given), in split order, through the shard executor
        (resumable under the storage's read ledger); each shard gets its
        own retrier and corrupt-block books (``ctx.for_shard``; the
        storage's error context unless given). Under the shard
        scheduler, the batches of the splits this process won."""
        from disq_tpu_torch.runtime.counters import ShardCounters
        from disq_tpu_torch.runtime.errors import (
            DisqOptions,
            context_for_storage,
            deadline_fallback_for,
        )
        from disq_tpu_torch.runtime.executor import (
            ShardTask,
            executor_for_storage,
            read_ledger_for_storage,
        )
        from disq_tpu_torch.runtime.introspect import note_shard_counters
        from disq_tpu_torch.runtime.scheduler import scheduled_map_ordered

        opts = getattr(self._storage, "_options", None) or DisqOptions()
        # a hedged fetch may run twice at once on one shard: each attempt
        # notes its corrupt blocks, and the decode books the winner's
        fetch = self._fetch_attempt if opts.hedge_quantile is not None \
            else self._fetch_range
        if ctx is None:
            ctx = context_for_storage(self._storage, path)
        splits = compute_path_splits(fs, path, split_size or self.split_size)
        sbi = ctx.retrier.call(self._try_load_sbi, fs, path, what="sbi")
        bounds = self._split_boundaries(fs, path, header, first_voffset,
                                        splits, sbi, ctx)
        tasks = []
        for i in range(len(splits)):
            shard_ctx = ctx.for_shard(i)
            tasks.append(ShardTask(
                shard_id=i,
                fetch=functools.partial(fetch, fs, path, bounds[i],
                                        bounds[i + 1], shard_ctx),
                decode=functools.partial(self._decode_booked, header,
                                         ctx=shard_ctx),
                retrier=shard_ctx.retrier, what=f"shard{i}",
                # an over-budget split under skip/quarantine is set
                # aside as the empty batch an empty range decodes to
                deadline_fallback=deadline_fallback_for(
                    opts, shard_ctx, functools.partial(
                        _books_of_empty, shard_ctx)),
                # the compressed byte window: the scheduler's locality
                byte_range=(bounds[i] >> 16, (bounds[i + 1] >> 16) + 1)))
        ledger = read_ledger_for_storage(self._storage, path, len(tasks),
                                         self._resident())
        out = []
        self._last_counters = []
        # the scheduler off (the default): map_ordered_resumable; on: the
        # splits this process wins from the shared queue
        for res in scheduled_map_ordered(self._storage, fs, path,
                                         executor_for_storage(self._storage),
                                         tasks, ledger):
            batch, stats, (skipped, quarantined, retried) = res.value
            c = ShardCounters(
                shard_id=res.shard_id, records=batch.count, blocks=stats[0],
                bytes_compressed=stats[1], bytes_uncompressed=stats[2],
                wall_seconds=res.wall_seconds, skipped_blocks=skipped,
                quarantined_blocks=quarantined, retried_reads=retried)
            self._last_counters.append(c)
            note_shard_counters("read", c)  # the live /progress feed
            out.append(batch)
        return out

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
                          splits: List[PathSplit], sbi: Optional[SbiIndex],
                          ctx) -> List[int]:
        """Virtual offsets b[0..n]: split i decodes records in
        [b[i], b[i+1]); b[0] is the first record, b[n] the end of data.
        Each boundary guess retries on its own (a handful of reads), so
        the phase converges under a sustained fault rate."""
        end_vo = ctx.retrier.call(self._data_end_voffset, fs, path,
                                  what="data_end")
        bounds = [first_voffset]
        for s in splits[1:]:
            if sbi is not None:
                vo = sbi.first_offset_at_or_after(s.start)
            else:
                vo = ctx.retrier.call(self._guess_record_voffset, fs, path,
                                      header, s.start, ctx, what="boundary")
                if vo is None:
                    vo = end_vo
            bounds.append(max(min(vo, end_vo), bounds[-1]))
        bounds.append(end_vo)
        return bounds

    def _guess_record_voffset(self, fs, path, header: SamHeader,
                              file_offset: int, ctx) -> Optional[int]:
        """First record boundary at or after ``file_offset``: block
        guesser, then the record guesser over a decompressed window that
        grows until a boundary is found or the window reaches EOF. Under
        skip/quarantine a corrupt block in the window is stepped over
        silently (the shard that owns it books it when it decodes)."""
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
                raise  # a short range read: the boundary retrier re-reads
            except ValueError:
                # a malformed block header in the window: salvage-walk it
                # and search each good run
                blocks, data, gaps = walk_blocks_salvage(
                    fs, path, block_start, block_start + window_csize,
                    file_length, ctx, owned_until=block_start)
                if not blocks:
                    return None
                payloads = inflate_blocks_salvage(data, blocks, block_start,
                                                  ctx.silent())
                u_vo = self._search_payload_runs(g, blocks, payloads)
                if u_vo is not None:
                    return u_vo
                if blocks[-1].end >= file_length or (
                        gaps and gaps[-1][1] >= file_length):
                    return None
                window_csize *= 4
                continue
            if not blocks:
                return None
            try:
                window = inflate_blocks(data, blocks, base=block_start)
            except ValueError as e:
                payloads = inflate_blocks_salvage(data, blocks, block_start,
                                                  ctx.silent())
                if all(p is not None for p in payloads):
                    raise e  # a batch inflate bug, not corruption
                u_vo = self._search_payload_runs(g, blocks, payloads)
                if u_vo is not None:
                    return u_vo
                u = None
            else:
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

    def _search_payload_runs(self, g, blocks, payloads) -> Optional[int]:
        """First record boundary across the good runs of a salvaged
        window, each run searched on its own (never spliced across a
        corrupt hole, which could chain-validate a false boundary)."""
        for i, j in _good_runs([p is None for p in payloads]):
            blob = np.frombuffer(b"".join(payloads[i: j + 1]), dtype=np.uint8)
            u = g.find_first_record(blob)
            if u is not None:
                acc = 0
                for k in range(i, j + 1):
                    if u < acc + len(payloads[k]):
                        return make_virtual_offset(blocks[k].pos, u - acc)
                    acc += len(payloads[k])
        return None

    def _decode_range(self, fs, path: str, header: SamHeader,
                      lo_voffset: int, hi_voffset: int):
        return self._decode_range_with_stats(fs, path, header, lo_voffset,
                                             hi_voffset)[0]

    def _decode_range_with_stats(self, fs, path: str, header: SamHeader,
                                 lo_voffset: int, hi_voffset: int, ctx=None
                                 ) -> Tuple[object, Tuple[int, int, int]]:
        """Decode the records whose start lies in [lo, hi) virtual space
        (a BAI chunk): the split's fetch and decode stages in sequence,
        on the same route (the inflate and parse kernels on ``cuda``),
        with the read filter applied. Without ``ctx`` the policy is
        strict: a corrupt block raises."""
        if ctx is None:
            ctx = ShardErrorContext(policy=ErrorPolicy.STRICT, path=path)
        return self._decode_filtered(
            header, self._fetch_range(fs, path, lo_voffset, hi_voffset, ctx),
            ctx)

    def _fetch_range(self, fs, path: str, lo_voffset: int, hi_voffset: int,
                     ctx) -> Optional[Tuple]:
        """``_fetch_range_inner`` under a per-split ``bam.split.fetch``
        span carrying the shard id and virtual-offset range."""
        with span("bam.split.fetch", shard=ctx.shard_id, lo=lo_voffset,
                  hi=hi_voffset, path=path):
            return self._fetch_range_inner(fs, path, lo_voffset, hi_voffset,
                                           ctx)

    def _fetch_attempt(self, fs, path: str, lo_voffset: int,
                       hi_voffset: int, ctx) -> FetchAttempt:
        """``_fetch_range`` of a hedged read: the salvage walk books into
        ``ctx.attempt()``, and ``_decode_booked`` commits the books of the
        attempt whose payload it decodes."""
        actx = ctx.attempt()
        fetched = self._fetch_range(fs, path, lo_voffset, hi_voffset, actx)
        return FetchAttempt(fetched, actx,
                            0 if fetched is None else len(fetched[1]))

    def _fetch_range_inner(self, fs, path: str, lo_voffset: int,
                           hi_voffset: int, ctx) -> Optional[Tuple]:
        """Stage A: range-read and walk the compressed blocks covering
        [lo, hi) virtual space — from lo's block through hi's block, past
        the split's byte-range end when a record straddles it. A corrupt
        block header is salvage-walked under ``ctx``; a retried attempt
        starts the shard's corrupt-block counts again."""
        ctx.skipped_blocks = 0
        ctx.quarantined_blocks = 0
        if hi_voffset <= lo_voffset:
            return None
        lo_block = lo_voffset >> 16
        hi_block, hi_u = hi_voffset >> 16, hi_voffset & 0xFFFF
        length = fs.get_file_length(path)
        want_end = max(hi_block + (1 if hi_u > 0 else 0), lo_block + 1)
        gaps = []
        try:
            blocks, data = walk_blocks_collect(fs, path, lo_block, want_end,
                                               length)
        except TruncatedReadError:
            raise  # a short range read: the shard retrier re-reads
        except ValueError:
            blocks, data, gaps = walk_blocks_salvage(
                fs, path, lo_block, want_end, length, ctx,
                owned_until=hi_block)
        return blocks, data, gaps, lo_voffset, hi_voffset

    def _resident(self) -> bool:
        """The device route: always on ``cuda``; on the CPU only when
        resident decode was asked for."""
        return resident_decode_enabled(self._storage)

    def _decode_booked(self, header: SamHeader, fetched: Optional[Tuple],
                       ctx) -> Tuple[object, Tuple[int, int, int],
                                     Tuple[int, int, int]]:
        """Stage B with the shard's books: (batch, stats, (skipped,
        quarantined, retried)). The books are final once the decode
        returns (its fetch and every retry came before), and they travel
        with the batch into a read ledger's spill.

        A configured read filter (``DisqOptions.read_filter`` /
        ``DISQ_TPU_TORCH_READ_FILTER``) applies here, inside the decode
        span, to the batch of every route (device, host, salvage): a
        device-backed batch is masked by kernel F1 and compacted on its
        device before any column crosses d2h.

        A hedged fetch's payload comes with the books its attempt noted;
        they are booked here, once, for the attempt that won."""
        batch, stats = self._decode_filtered(header, committed(fetched, ctx),
                                             ctx)
        return batch, stats, (ctx.skipped_blocks, ctx.quarantined_blocks,
                              ctx.retrier.retried)

    def _decode_filtered(self, header: SamHeader, fetched: Optional[Tuple],
                         ctx) -> Tuple[object, Tuple[int, int, int]]:
        """Stage B under a ``bam.split.decode`` span, with the read
        filter applied to the batch of every route: the decode of a
        split and of a BAI chunk."""
        with span("bam.split.decode", shard=ctx.shard_id):
            batch, stats = self._decode_fetched(header, fetched, ctx)
            rf = self._read_filter()
            if rf is not None and batch.count:
                from disq_tpu_torch.ops.rfilter import apply_read_filter

                batch = apply_read_filter(batch, rf)
        return batch, stats

    def _read_filter(self):
        """The storage's parsed ``ReadFilter``, or None; the filter
        module is imported only once a spec is set."""
        import os

        opts = getattr(self._storage, "_options", None)
        spec = getattr(opts, "read_filter", None) if opts else None
        if spec is None:
            spec = os.environ.get("DISQ_TPU_TORCH_READ_FILTER") or None
        if not spec:
            return None
        from disq_tpu_torch.ops.rfilter import parse_read_filter

        return parse_read_filter(spec)

    def _decode_fetched(self, header: SamHeader, fetched: Optional[Tuple],
                        ctx) -> Tuple[object, Tuple[int, int, int]]:
        """Stage B: inflate and record-decode a staged range. Returns
        (batch, (blocks, compressed bytes, uncompressed bytes)), the
        stats counting only the blocks this range owns (``pos <
        hi_block``), so a straddling block is booked by one shard."""
        if fetched is None:
            return ReadBatch.empty(), (0, 0, 0)
        blocks, data, gaps, lo_voffset, hi_voffset = fetched
        lo_block, lo_u = lo_voffset >> 16, lo_voffset & 0xFFFF
        hi_block, hi_u = hi_voffset >> 16, hi_voffset & 0xFFFF
        if not blocks:
            return ReadBatch.empty(), (0, 0, 0)
        owned = [b for b in blocks if b.pos < hi_block]
        stats = (len(owned), sum(b.csize for b in owned),
                 sum(b.usize for b in owned))
        device = self._storage._resolved_device() if self._resident() else None
        runs = functools.partial(self._decode_runs, header, lo_u=lo_u,
                                 hi_block=hi_block, hi_u=hi_u, ctx=ctx,
                                 device=device)
        if gaps:
            # corrupt header spans, already handled by the salvage walk:
            # per-block inflate, with a hole at each gap so record runs
            # break there
            payloads = inflate_blocks_salvage(data, blocks, lo_block, ctx,
                                              owned_until=hi_block)
            merged = sorted(
                list(zip(blocks, payloads))
                + [(BgzfBlock(pos=lo, csize=hi - lo, usize=0), None)
                   for lo, hi in gaps],
                key=lambda bp: bp[0].pos)
            return runs([b for b, _ in merged],
                        *_joined([p for _, p in merged])), stats
        try:
            if device is not None:
                blob, dev_blob = inflate_blocks_device(
                    data, blocks, base=lo_block, device=device,
                    keep_device=True)
            else:
                blob, dev_blob = inflate_blocks(data, blocks,
                                                base=lo_block), None
        except FlaggedBlocksError as e:
            # the device batch flagged blocks: each inflates alone on the
            # host under the policy (one that inflates there was the
            # batch's fault, and raises); the other blocks keep the bytes
            # the batch decoded, where it decoded them
            lost = salvage_flagged(data, blocks, lo_block, ctx, e,
                                   owned_until=hi_block)
            return runs(blocks, e.blob, e.out_off, lost,
                        dev_blob=e.blob_dev), stats
        except ValueError as first_err:
            # at least one block is corrupt: per-block salvage under the
            # policy (STRICT raises with the block's coordinates)
            payloads = inflate_blocks_salvage(data, blocks, lo_block, ctx,
                                              owned_until=hi_block)
            if all(p is not None for p in payloads):
                # every block inflates alone: a fault of the batch route,
                # not of the data — raise it, never serve a salvage
                raise first_err
            return runs(blocks, *_joined(payloads)), stats
        if hi_u > 0:
            end_u = sum(b.usize for b in blocks if b.pos < hi_block) + hi_u
        else:
            end_u = len(blob)
        record_bytes = blob[lo_u:end_u]
        try:
            offsets = scan_record_offsets(record_bytes)
            if device is not None:
                # the mesh (runtime/mesh.py): with the knob armed each
                # shard parses its slice of the records and the batch
                # carries the mesh; two attribute reads when off
                from disq_tpu_torch.runtime.mesh import mesh_for_storage

                return ColumnarBatch.from_blob(
                    record_bytes, offsets, dev_blob, n_ref=header.n_ref,
                    origin=lo_u, mesh=mesh_for_storage(self._storage)), stats
            return decode_records(record_bytes, offsets,
                                  n_ref=header.n_ref), stats
        except ValueError as e:
            if isinstance(e, DeviceParseFault) and \
                    ctx.policy is not ErrorPolicy.STRICT:
                raise  # the device parse disagrees with the host: no salvage
            # record framing or content damage inside intact blocks: STRICT
            # raises with the shard's coordinates; skip/quarantine keep
            # the clean prefix the tolerant scan finds
            ctx.handle_corrupt_block(e, block_offset=lo_block,
                                     virtual_offset=lo_voffset,
                                     kind="record run")
            batches = []
            try:
                offsets = scan_record_offsets_tolerant(record_bytes)
                batches.append(_parse_run(record_bytes, offsets, lo_u, header,
                                          device, dev_blob))
            except DeviceParseFault:
                raise
            except ValueError:
                pass
            return ColumnarBatch.concat(batches), stats

    def _decode_runs(self, header: SamHeader, blocks, blob: np.ndarray,
                     out_off: np.ndarray, lost, *, lo_u: int, hi_block: int,
                     hi_u: int, ctx, device, dev_blob=None):
        """The split's batch from the runs of good blocks around lost
        corrupt ones: block ``k``'s bytes are ``blob[out_off[k]:
        out_off[k+1]]``, and at the same offsets of ``dev_blob`` when the
        split has one. A record straddling into a lost block is dropped
        (its tail is gone); after a gap, the first record boundary is
        found again with the ``BamRecordGuesser``. Record damage inside a
        good run goes to ``ctx``'s policy."""
        guesser = BamRecordGuesser(header.n_ref,
                                   [s.length for s in header.sequences])
        batches = []
        n = len(blocks)
        for i, j in _good_runs(lost):
            at = int(out_off[i])
            run = blob[at: int(out_off[j + 1])]
            start_u = lo_u if i == 0 else 0
            if hi_u > 0 and any(b.pos == hi_block for b in blocks[i: j + 1]):
                end_u = sum(int(out_off[k + 1] - out_off[k])
                            for k in range(i, j + 1)
                            if blocks[k].pos < hi_block) + hi_u
            else:
                end_u = len(run)
            seg, at = run[start_u:end_u], at + start_u
            if i > 0 and len(seg):
                first = guesser.find_first_record(seg)
                if first is None:
                    continue
                seg, at = seg[first:], at + first
            if len(seg) == 0:
                continue
            ends_at_gap = j + 1 < n
            try:
                offsets = (scan_record_offsets_tolerant(seg) if ends_at_gap
                           else scan_record_offsets(seg))
                batches.append(_parse_run(seg, offsets, at, header, device,
                                          dev_blob))
            except ValueError as e:
                if isinstance(e, DeviceParseFault) and \
                        ctx.policy is not ErrorPolicy.STRICT:
                    raise
                pos = int(blocks[i].pos)
                ctx.handle_corrupt_block(
                    e, block_offset=pos,
                    virtual_offset=make_virtual_offset(pos, 0),
                    kind="record run")
                try:
                    offsets = scan_record_offsets_tolerant(seg)
                    batches.append(_parse_run(seg, offsets, at, header,
                                              device, dev_blob))
                except DeviceParseFault:
                    raise
                except ValueError:
                    pass  # keep the other runs
        return ColumnarBatch.concat(batches)


def _books_of_empty(ctx):
    """A set-aside split's value: the empty batch an empty range decodes
    to on every route, and the books the deadline left on ``ctx``."""
    return ReadBatch.empty(), (0, 0, 0), (
        ctx.skipped_blocks, ctx.quarantined_blocks, ctx.retrier.retried)


def _good_runs(lost):
    """(first, last) index of each maximal run of blocks not lost."""
    n, i = len(lost), 0
    while i < n:
        if lost[i]:
            i += 1
            continue
        j = i
        while j + 1 < n and not lost[j + 1]:
            j += 1
        yield i, j
        i = j + 1


def _joined(payloads):
    """Per-block host payloads, None where lost, as (blob, out_off,
    lost)."""
    out_off = np.zeros(len(payloads) + 1, dtype=np.int64)
    np.cumsum([0 if p is None else len(p) for p in payloads],
              out=out_off[1:])
    blob = np.frombuffer(b"".join(p for p in payloads if p is not None),
                         dtype=np.uint8)
    return blob, out_off, [p is None for p in payloads]


def _parse_run(seg: np.ndarray, offsets: np.ndarray, at: int,
               header: SamHeader, device, dev_blob):
    """The records at ``offsets`` of ``seg``, which starts at ``at`` in
    the split's blob: a host ``ReadBatch``, or on the device route a
    device-backed ``ColumnarBatch`` parsed from ``dev_blob`` (from the
    records uploaded when the split has no device blob)."""
    if device is None:
        return decode_records(seg, offsets, n_ref=header.n_ref)
    if len(offsets) <= 1:
        return ReadBatch.empty()
    lo = int(offsets[0])
    records = seg[lo: int(offsets[-1])]
    if dev_blob is None:
        from disq_tpu_torch.runtime.device_pipeline import upload

        dev_blob, at = upload(records, device), -lo
    return ColumnarBatch.from_blob(records, offsets - lo, dev_blob,
                                   n_ref=header.n_ref, origin=at + lo)
