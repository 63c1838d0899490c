"""BGZF block-boundary guessing and block-chain walks.

Counterpart of ``disq_tpu/bgzf/guesser.py``: candidate header positions
come from a vectorized numpy compare over the staged window, then each
candidate is confirmed by following BSIZE to further plausible headers.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from disq_tpu_torch.bgzf.block import (
    BGZF_HEADER_SIZE,
    BGZF_MAX_BLOCK_SIZE,
    BgzfBlock,
    make_virtual_offset,
    parse_block_header,
)
from disq_tpu_torch.fsw.filesystem import FileSystemWrapper

# successor headers that must chain-validate before a candidate counts
CHAIN_DEPTH = 2

# a guess near a split boundary looks at most one maximal block past it
_OVERRUN = 2 * BGZF_MAX_BLOCK_SIZE


def _candidate_positions(buf: np.ndarray) -> np.ndarray:
    """Positions where the 4 fixed header bytes match."""
    if buf.size < BGZF_HEADER_SIZE:
        return np.empty(0, dtype=np.int64)
    m = (
        (buf[:-3] == 0x1F)
        & (buf[1:-2] == 0x8B)
        & (buf[2:-1] == 0x08)
        & (buf[3:] == 0x04)
    )
    return np.nonzero(m)[0].astype(np.int64)


def _chain_validate(data: bytes, pos: int, file_tail_known: bool,
                    depth: int = CHAIN_DEPTH) -> bool:
    """Follow BSIZE links from ``pos``; True iff ``depth`` links hold.
    ``file_tail_known``: ``data`` extends to EOF, so running out of
    bytes mid-header fails unless exactly at EOF."""
    p = pos
    for _ in range(depth + 1):
        if p == len(data) and file_tail_known:
            return True
        try:
            total = parse_block_header(data, p)
        except ValueError:
            # a bounded window that simply ended is accepted
            if p + BGZF_HEADER_SIZE > len(data) and not file_tail_known:
                return True
            return False
        p += total
        if p > len(data) and not file_tail_known:
            return True
    return True


class BgzfBlockGuesser:
    """Find the first true BGZF block at-or-after an arbitrary offset."""

    def __init__(self, fs: FileSystemWrapper, path: str):
        self.fs = fs
        self.path = path
        self.length = fs.get_file_length(path)

    def guess_block_start(self, offset: int) -> Optional[int]:
        if offset >= self.length:
            return None
        window_len = min(_OVERRUN + BGZF_HEADER_SIZE, self.length - offset)
        data = self.fs.read_range(self.path, offset, window_len)
        tail_known = offset + window_len >= self.length
        arr = np.frombuffer(data, dtype=np.uint8)
        for cand in _candidate_positions(arr):
            if _chain_validate(data, int(cand), tail_known):
                return offset + int(cand)
        return None

    def blocks_in_split(self, start: int, end: int) -> List[BgzfBlock]:
        """All blocks whose start lies in ``[start, end)``: the first
        owner rule of a split (a block straddling ``end`` belongs to this
        split)."""
        first = self.guess_block_start(start)
        if first is None or first >= end:
            return []
        return walk_blocks_collect(self.fs, self.path, first, end,
                                   self.length)[0]


def _walk_buffer(buf: bytes, stop: int) -> tuple[list, int]:
    """Walk complete blocks in ``buf`` whose start is ``< stop``:
    ([(rel_pos, csize, usize), …], consumed bytes). Native C walk when
    built; pure-Python header parse otherwise."""
    try:
        from disq_tpu_torch.native import walk_bgzf_blocks_native

        rel, cs, us = walk_bgzf_blocks_native(buf, stop)
        if len(rel) == 0:
            return [], 0
        return (
            list(zip(rel.tolist(), cs.tolist(), us.tolist())),
            int(rel[-1]) + int(cs[-1]),
        )
    except ImportError:
        pass
    entries = []
    p = 0
    while p < stop:
        # stop (do not raise) at a header that is not complete in the
        # buffer, so the caller re-reads from p
        if p + 12 > len(buf):
            break
        xlen = struct.unpack_from("<H", buf, p + 10)[0]
        if p + 12 + xlen > len(buf):
            break
        total = parse_block_header(buf, p)
        if p + total > len(buf):
            break
        isize = struct.unpack_from("<I", buf, p + total - 4)[0]
        entries.append((p, total, isize))
        p += total
    return entries, p


def walk_blocks_collect(
    fs: FileSystemWrapper, path: str, first: int, end: int, file_length: int,
    chunk: int = 8 * 1024 * 1024,
) -> tuple[List[BgzfBlock], bytes]:
    """Walk the BSIZE chain from a known block start, collecting blocks
    that start before ``end``, and return the staged compressed bytes
    covering exactly ``[first, last_block.end)``. Reads ahead in large
    chunks (one range read per ~8 MiB) and re-reads from the first
    block straddling a chunk."""
    from disq_tpu_torch.runtime.errors import TruncatedReadError

    blocks: List[BgzfBlock] = []
    parts: List[bytes] = []
    pos = first
    while pos < end and pos < file_length:
        want = min(max(chunk, 2 * BGZF_MAX_BLOCK_SIZE), file_length - pos)
        buf = fs.read_range(path, pos, want)
        entries, consumed = _walk_buffer(buf, min(end - pos, len(buf)))
        if not entries:
            if len(buf) == want and pos + len(buf) >= file_length:
                raise ValueError(
                    f"BGZF file ends mid-block at {pos} in {path}")
            raise TruncatedReadError(
                f"truncated BGZF block at {pos} in {path}")
        for rel, cs, us in entries:
            blocks.append(BgzfBlock(pos=pos + rel, csize=cs, usize=us))
        parts.append(buf[:consumed])
        pos += consumed
    if not blocks:
        return [], b""
    return blocks, b"".join(parts)


def walk_blocks_salvage(fs: FileSystemWrapper, path: str, start: int,
                        end: int, length: int, ctx, owned_until: int):
    """One-block-at-a-time walk, run only after the batched chain walk
    (``walk_blocks_collect``) raised on a malformed block header. Each
    corrupt span is handled by ``ctx`` (a ``runtime.errors.
    ShardErrorContext``; STRICT raises with the span's coordinates) and
    the walk re-syncs at the next chain-validated block start. Returns
    (blocks, data, gaps): ``data`` is contiguous from ``start``, corrupt
    spans included, so block offsets index it directly; ``gaps`` lists
    the corrupt [lo, hi) spans. Spans at or past ``owned_until`` are
    handled silently: their owner counts them. Each read is retried on
    its own and length-checked, so a short read is transient, never a
    corrupt header."""
    from disq_tpu_torch.runtime.errors import TruncatedReadError

    blocks: List[BgzfBlock] = []
    parts: List[bytes] = []
    gaps: List[tuple] = []
    guesser = BgzfBlockGuesser(fs, path)
    retry = ctx.retrier.call
    pos = start

    def read_exact(p, n):
        def attempt():
            b = fs.read_range(path, p, n)
            if len(b) < n:
                raise TruncatedReadError(
                    f"short read at {p} in {path}: {len(b)} < {n}")
            return b
        return retry(attempt, what="salvage_walk")

    while pos < end and pos < length:
        buf = read_exact(pos, min(BGZF_MAX_BLOCK_SIZE, length - pos))
        try:
            total = parse_block_header(buf, 0)
            if total > len(buf):
                raise ValueError(
                    f"BGZF file ends mid-block at {pos} in {path}")
            usize = struct.unpack_from("<I", buf, total - 4)[0]
        except ValueError as e:
            nxt = retry(guesser.guess_block_start, pos + 1,
                        what="salvage_resync")
            span_end = min(end, length)
            if nxt is not None and nxt < span_end:
                span_end = nxt
            # the sidecar holds the whole span, not the first 64 KiB
            gap_raw = buf[: span_end - pos]
            if len(gap_raw) < span_end - pos:
                gap_raw += read_exact(pos + len(gap_raw),
                                      span_end - pos - len(gap_raw))
            target = ctx.silent() if pos >= owned_until else ctx
            target.handle_corrupt_block(
                e, block_offset=pos, raw=bytes(gap_raw),
                virtual_offset=make_virtual_offset(pos, 0),
                kind="BGZF block header")
            parts.append(gap_raw)
            gaps.append((pos, span_end))
            if nxt is None or nxt >= min(end, length):
                break
            pos = span_end
            continue
        blocks.append(BgzfBlock(pos=pos, csize=total, usize=usize))
        parts.append(buf[:total])
        pos += total
    return blocks, b"".join(parts), gaps


def find_block_table(fs: FileSystemWrapper, path: str, start: int = 0,
                     end: Optional[int] = None) -> List[BgzfBlock]:
    """Full (or range-bounded) block table of a BGZF file."""
    length = fs.get_file_length(path)
    if end is None:
        end = length
    if start != 0:
        first = BgzfBlockGuesser(fs, path).guess_block_start(start)
        if first is None or first >= end:
            return []
        start = first
    if length == 0:
        return []
    return walk_blocks_collect(fs, path, start, end, length)[0]
