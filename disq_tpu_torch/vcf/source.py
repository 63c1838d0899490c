"""VcfSource — the VCF read path.

The header is parsed on the host; the body is read as text splits.
Compression dispatch mirrors ``BGZFEnhancedGzipCodec``: a ``.gz`` that
is really BGZF is *splittable* (per-split block-aligned line reading);
plain gzip falls back to a single split; plain text uses byte-range
line splits. Interval queries use ``.tbi`` chunk pruning when the index
exists, then an exact vectorized overlap filter either way.

On ``cuda`` (or with resident decode asked for on the CPU) every BGZF
inflate of a split, of its straddling-line neighbor blocks and of a
tabix chunk runs on the device route (``bgzf/codec.py::
inflate_blocks_device``: kernel B1, or B4 under
``DISQ_TPU_TORCH_DEVICE_INFLATE=legacy``); the decoded text comes back
to the host for the line split and parse, and no device copy is kept.
Corrupt blocks follow the storage's ``ErrorPolicy``: on the device route
only the blocks the kernel flagged (or whose CRC failed) inflate alone
on the host, and one that inflates there raises the batch's error.
"""

from __future__ import annotations

import functools
import gzip
from typing import List

import numpy as np

from disq_tpu_torch.bgzf.block import BGZF_MAX_PAYLOAD
from disq_tpu_torch.bgzf.codec import inflate_blocks, inflate_blocks_device
from disq_tpu_torch.bgzf.guesser import (
    BgzfBlockGuesser,
    walk_blocks_collect,
    walk_blocks_salvage,
)
from disq_tpu_torch.fsw.filesystem import compute_path_splits, resolve_path
from disq_tpu_torch.fsw.textsplit import lines_for_split
from disq_tpu_torch.runtime.columnar import device_route
from disq_tpu_torch.runtime.errors import (
    DisqOptions,
    FetchAttempt,
    FlaggedBlocksError,
    TruncatedReadError,
    committed,
    context_for_storage,
    deadline_fallback_for,
    inflate_blocks_salvage,
    salvage_flagged,
)
from disq_tpu_torch.runtime.tracing import span, wrap_span
from disq_tpu_torch.vcf.columnar import VariantBatch, parse_vcf_lines
from disq_tpu_torch.vcf.header import read_vcf_header, sniff_compression


def _filler(b) -> bytes:
    """NUL filler for a lost block: its claimed decompressed size, which
    comes from the block's own (untrusted) ISIZE footer, clamped to the
    BGZF maximum (a damaged high byte must not provoke a huge
    allocation) and to at least one NUL (an ISIZE damaged to 0 must
    still taint the lines on either side of the hole)."""
    return b"\x00" * min(max(b.usize, 1), BGZF_MAX_PAYLOAD)


class VcfSource:
    def __init__(self, storage=None):
        self._storage = storage
        self._last_counters = []

    @property
    def split_size(self) -> int:
        return getattr(self._storage, "_split_size", 128 * 1024 * 1024)

    # -- public -------------------------------------------------------------

    def get_variants(self, path: str, intervals=None):
        from disq_tpu_torch.api import VariantsDataset
        from disq_tpu_torch.runtime.counters import reduce_counters

        fs, path = resolve_path(path)
        ctx = context_for_storage(self._storage, path)
        self._last_counters = []
        header = ctx.retrier.call(read_vcf_header, fs, path, what="header")
        kind = sniff_compression(
            ctx.retrier.call(fs.read_range, path, 0, 18, what="sniff"))

        if intervals is not None and kind == "bgzf" and fs.exists(path + ".tbi"):
            batch = ctx.retrier.call(
                self._read_with_tabix, fs, path, header, intervals,
                what="tabix")
        elif kind == "plain":
            batch = self._read_plain(fs, path, header, ctx)
        elif kind == "gzip":
            batch = ctx.retrier.call(
                self._read_whole_gzip, fs, path, header, what="gzip")
        else:
            batch = self._read_bgzf(fs, path, header, ctx)
        if intervals is not None:
            batch = batch.filter(self._overlap_mask(batch, intervals))
        header = header.with_contigs(list(batch.contig_names))
        counters = reduce_counters(self._last_counters)
        counters.retried_reads += ctx.retrier.retried
        counters.skipped_blocks += ctx.skipped_blocks
        counters.quarantined_blocks += ctx.quarantined_blocks
        return VariantsDataset(header=header, variants=batch,
                               counters=counters)

    # -- plain text ---------------------------------------------------------

    def _read_plain(self, fs, path, header, ctx) -> VariantBatch:
        """Byte-range line splits through the shard executor: stage A
        reads and line-resolves a split, stage B parses its lines into a
        columnar batch, stage C concatenates in split order."""
        tasks, shard_ctxs = [], []
        for i, s in enumerate(compute_path_splits(fs, path, self.split_size)):
            shard_ctx = ctx.for_shard(i)
            shard_ctxs.append(shard_ctx)
            tasks.append(self._make_task(
                i, shard_ctx,
                functools.partial(lines_for_split, fs, path, s.start, s.end),
                header, start=s.start, end=s.end,
            ))
        return self._emit_batches(tasks, shard_ctxs, header, path, fs)

    def _make_task(self, shard_id, shard_ctx, fetch, header,
                   start=None, end=None):
        from disq_tpu_torch.runtime.executor import ShardTask

        def decode(lines):
            with span("vcf.split.decode", shard=shard_id):
                raw = [ln for ln in committed(lines, shard_ctx)
                       if ln and not ln.startswith(b"#")]
                return parse_vcf_lines(raw, header.contig_names)

        opts = getattr(self._storage, "_options", None) or DisqOptions()
        return ShardTask(
            shard_id=shard_id,
            # per-split timeline spans carrying shard id and byte range
            fetch=wrap_span("vcf.split.fetch", fetch,
                            shard=shard_id, start=start, end=end),
            decode=decode,
            retrier=shard_ctx.retrier,
            what=f"split{shard_id}",
            # an over-budget split under skip/quarantine is set aside as
            # one empty batch
            deadline_fallback=deadline_fallback_for(
                opts, shard_ctx,
                lambda: parse_vcf_lines([], header.contig_names)),
            # the split's byte window: the scheduler's locality
            byte_range=((start, end)
                        if start is not None and end is not None else None),
        )

    def _emit_batches(self, tasks, shard_ctxs, header, path,
                      fs) -> VariantBatch:
        """Run the split tasks through the storage's executor (resumable
        under its read ledger) and concatenate in split order; under the
        shard scheduler, the splits this process wins from the shared
        queue."""
        from disq_tpu_torch.runtime.executor import (
            executor_for_storage,
            read_ledger_for_storage,
        )
        from disq_tpu_torch.runtime.scheduler import scheduled_map_ordered

        ledger = read_ledger_for_storage(
            self._storage, path, len(tasks),
            device_route(self._storage) is not None)
        batches = []
        for res in scheduled_map_ordered(
                self._storage, fs, path, executor_for_storage(self._storage),
                tasks, ledger):
            batches.append(res.value)
            self._track(shard_ctxs[res.shard_id], res.shard_id, res.value)
        return (VariantBatch.concat(batches) if batches
                else VariantBatch.empty(header.contig_names))

    def _track(self, shard_ctx, shard_id: int, batch) -> None:
        from disq_tpu_torch.runtime.counters import ShardCounters
        from disq_tpu_torch.runtime.introspect import note_shard_counters

        c = ShardCounters(
            shard_id=shard_id,
            records=int(batch.count),
            skipped_blocks=shard_ctx.skipped_blocks,
            quarantined_blocks=shard_ctx.quarantined_blocks,
            retried_reads=shard_ctx.retrier.retried,
        )
        self._last_counters.append(c)
        note_shard_counters("read", c)  # the live /progress feed

    def _read_whole_gzip(self, fs, path, header) -> VariantBatch:
        # plain gzip is not splittable: one task reads the whole file
        with fs.open(path) as f:
            data = gzip.GzipFile(fileobj=f).read()
        raw = [
            ln for ln in data.split(b"\n") if ln and not ln.startswith(b"#")
        ]
        return parse_vcf_lines(raw, header.contig_names)

    # -- splittable bgzf ----------------------------------------------------

    def _read_bgzf(self, fs, path, header, ctx) -> VariantBatch:
        """Block-aligned splittable read through the shard executor:
        stage A walks and inflates the split's blocks into owned lines
        (the BGZF walk, the straddling-line extension and the inflate),
        stage B parses lines columnar, stage C concatenates in split
        order."""
        length = fs.get_file_length(path)
        opts = getattr(self._storage, "_options", None) or DisqOptions()
        # a hedged fetch may run twice at once on one split: each attempt
        # notes its corrupt blocks, and the decode books the winner's
        fetch = self._bgzf_attempt if opts.hedge_quantile is not None \
            else self._bgzf_split_lines
        tasks, shard_ctxs = [], []
        for i, s in enumerate(compute_path_splits(fs, path, self.split_size)):
            shard_ctx = ctx.for_shard(i)
            shard_ctxs.append(shard_ctx)
            tasks.append(self._make_task(
                i, shard_ctx,
                functools.partial(fetch, fs, path, s.start, s.end, length,
                                  ctx=shard_ctx),
                header, start=s.start, end=s.end,
            ))
        return self._emit_batches(tasks, shard_ctxs, header, path, fs)

    def _inflate_with_gaps(self, data, blocks, gaps, base: int, ctx):
        """``_inflate_with_policy`` when the block walk itself needed
        salvage: corrupt-header spans (``gaps``, already handled by the
        walk) contribute one NUL each (their true decompressed size is
        unknowable, and a single NUL taints the lines on either side of
        the hole without splicing them)."""
        if not gaps:
            return self._inflate_with_policy(data, blocks, base, ctx)
        payloads = inflate_blocks_salvage(data, blocks, base, ctx)
        items = sorted(
            [(b.pos, p if p is not None else _filler(b))
             for b, p in zip(blocks, payloads)]
            + [(lo, b"\x00") for lo, _hi in gaps]
        )
        return b"".join(p for _, p in items), True

    def _inflate_with_policy(self, data, blocks, base: int, ctx
                             ) -> "tuple[bytes, bool]":
        """Batched inflate with corrupt-block salvage for *text* data: a
        skipped or quarantined block is replaced by NUL filler of its
        claimed decompressed size, keeping every other block's line
        positions (and so split line ownership) stable; lines touching
        filler are dropped by the caller. NUL never occurs in
        well-formed VCF text. Returns (text, whether filler went in)."""
        device = device_route(self._storage)
        if device is not None:
            try:
                blob, _ = inflate_blocks_device(data, blocks, base, device)
                return blob.tobytes(), False
            except FlaggedBlocksError as e:
                # only the flagged blocks inflate alone on the host (one
                # that inflates there raises the batch's error); the
                # others keep the bytes the kernel decoded
                lost = salvage_flagged(data, blocks, base, ctx, e)
                off = e.out_off
                return b"".join(
                    _filler(b) if gone
                    else e.blob[int(off[i]): int(off[i + 1])].tobytes()
                    for i, (b, gone) in enumerate(zip(blocks, lost))
                ), any(lost)
        try:
            return inflate_blocks(data, blocks, base=base).tobytes(), False
        except ValueError:
            payloads = inflate_blocks_salvage(data, blocks, base, ctx)
            return b"".join(
                p if p is not None else _filler(b)
                for b, p in zip(blocks, payloads)
            ), any(p is None for p in payloads)

    def _bgzf_attempt(self, fs, path: str, start: int, end: int,
                      length: int, ctx) -> FetchAttempt:
        """``_bgzf_split_lines`` of a hedged read, booking into
        ``ctx.attempt()``; the decode commits the winner's books. This
        fetch inflates, so a duplicate inflates again."""
        actx = ctx.attempt()
        lines = self._bgzf_split_lines(fs, path, start, end, length,
                                       ctx=actx)
        return FetchAttempt(lines, actx, sum(len(ln) for ln in lines))

    def _bgzf_split_lines(
        self, fs, path: str, start: int, end: int, length: int, ctx
    ) -> List[bytes]:
        """Lines owned by this split under the Hadoop discard rule, in
        decompressed space: a split starting mid-stream discards through
        its first newline, so the previous split owns every line starting
        at any position ≤ its region length (including a line that begins
        exactly AT the region boundary: the neighbor discards it).
        Mirrors ``fsw.textsplit.lines_for_split``'s boundary handling."""
        # a retried attempt must not count corrupt blocks twice
        ctx.skipped_blocks = 0
        ctx.quarantined_blocks = 0
        g = BgzfBlockGuesser(fs, path)
        first = g.guess_block_start(start)
        if first is None or first >= end:
            return []
        gaps = []
        try:
            blocks, data = walk_blocks_collect(fs, path, first, end, length)
        except TruncatedReadError:
            raise  # a short range read: retried by the shard retrier
        except ValueError:
            # a malformed block header breaks the chain walk itself:
            # salvage-walk the split, handling each corrupt span by the
            # policy and re-syncing at the next verifiable block (STRICT
            # raises there with the span's coordinates)
            blocks, data, gaps = walk_blocks_salvage(
                fs, path, first, end, length, ctx, owned_until=end)
        if not blocks:
            return []
        owned, filled = self._inflate_with_gaps(
            data, blocks, gaps, first, ctx)
        owned_len = len(owned)
        # extend with neighbor blocks until a newline appears at or past
        # the owned region's end, completing the straddling line (or the
        # line that starts exactly at the boundary, which we also own)
        ext = bytearray(owned)
        ext_failed = False
        next_pos = blocks[-1].end
        while ext.find(b"\n", owned_len) < 0 and next_pos < length:
            try:
                nxt, ndata = walk_blocks_collect(
                    fs, path, next_pos, next_pos + 1, length,
                    chunk=2 * 0x10000,  # one max block + header slack
                )
            except TruncatedReadError:
                raise
            except ValueError:
                # a corrupt neighbor header: the straddling line cannot be
                # completed, so drop it (its owner books the corruption)
                ext_failed = True
                break
            # neighbor blocks belong to the NEXT split: salvage them
            # silently so a corrupt one is counted only by its owner
            chunk, chunk_filled = self._inflate_with_policy(
                ndata, nxt, next_pos,
                ctx.silent(),
            )
            ext += chunk
            filled = filled or chunk_filled
            next_pos = nxt[-1].end
        text = bytes(ext)
        begin = 0
        if first > 0:
            # discard through the first newline: that partial (or
            # boundary-starting) line belongs to the previous split
            nl = text.find(b"\n")
            if nl < 0 or nl + 1 > owned_len:
                return []
            begin = nl + 1
        out = []
        pos = begin
        # own every line starting at pos <= owned_len (boundary inclusive)
        while pos <= owned_len:
            if pos >= len(text):
                break
            nl = text.find(b"\n", pos)
            if nl < 0:
                tail = text[pos:]
                if tail and not ext_failed:
                    out.append(tail)
                break
            out.append(text[pos:nl])
            pos = nl + 1
        # lines touching a skipped corrupt block carry NUL filler (see
        # _inflate_with_policy): exactly that block's lines drop. Only
        # when filler went in: a (spec-invalid) NUL inside real data is
        # not dropped on the fault-free path.
        if filled:
            return [ln for ln in out if b"\x00" not in ln]
        return out

    # -- tabix pruning ------------------------------------------------------

    def _read_with_tabix(self, fs, path, header, intervals) -> VariantBatch:
        """Read only the BGZF chunks the ``.tbi`` selects for the
        intervals (merged where they overlap), each inflated in one batch
        on the read's route; a corrupt block raises."""
        from disq_tpu_torch.index.tbi import TbiIndex

        tbi = TbiIndex.from_bytes(fs.read_all(path + ".tbi"))
        chunks = []
        for iv in intervals:
            chunks += tbi.chunks_for_interval(iv.contig, iv.start - 1, iv.end)
        chunks.sort()
        merged = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
            else:
                merged.append((cb, ce))
        length = fs.get_file_length(path)
        device = device_route(self._storage)
        batches = []
        for cb, ce in merged:
            lo_block, lo_u = cb >> 16, cb & 0xFFFF
            hi_block, hi_u = ce >> 16, ce & 0xFFFF
            want_end = hi_block + (1 if hi_u > 0 else 0)
            blocks, data = walk_blocks_collect(
                fs, path, lo_block, max(want_end, lo_block + 1), length
            )
            if not blocks:
                continue
            if device is not None:
                blob = inflate_blocks_device(data, blocks, lo_block,
                                             device)[0].tobytes()
            else:
                blob = inflate_blocks(data, blocks, base=lo_block).tobytes()
            if hi_u > 0:
                acc = sum(b.usize for b in blocks if b.pos < hi_block)
                blob = blob[lo_u: acc + hi_u]
            else:
                blob = blob[lo_u:]
            raw = [
                ln for ln in blob.split(b"\n") if ln and not ln.startswith(b"#")
            ]
            # the final line may be cut by the chunk end; a cut line's
            # variant starts beyond the interval anyway (chunk ends are
            # line boundaries in these indexes), so parse defensively
            parsed = [ln for ln in raw if ln.count(b"\t") >= 7]
            batches.append(parse_vcf_lines(parsed, header.contig_names))
        if not batches:
            return VariantBatch.empty(header.contig_names)
        return VariantBatch.concat(batches)

    @staticmethod
    def _overlap_mask(batch: VariantBatch, intervals) -> np.ndarray:
        mask = np.zeros(batch.count, dtype=bool)
        name_to_id = {n: i for i, n in enumerate(batch.contig_names)}
        for iv in intervals:
            ci = name_to_id.get(iv.contig)
            if ci is None:
                continue
            mask |= (
                (batch.chrom == ci)
                & (batch.pos <= iv.end)
                & (batch.end >= iv.start)
            )
        return mask
