"""BAM record-boundary guessing inside decompressed BGZF data.

Reference parity: ``impl/formats/bam/BamRecordGuesser.java`` (descendant
of Hadoop-BAM's ``BAMSplitGuesser``): given an arbitrary position in
decompressed data, decide whether it begins a real BAM record by
structural validation — ``refID``/``next_refID`` ∈ [-1, n_ref), ``pos``
∈ [-1, ref_len), ``l_read_name`` ≥ 1 with NUL at the claimed length,
CIGAR op codes < 9, component lengths consistent with ``block_size`` —
then chain-check the following records so false positives die
geometrically.

The cheap per-candidate rejects run as one vectorized numpy pass over
all candidate offsets; only survivors pay the sequential chain check.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

_FIXED = 32
# A sane upper bound on one record's size (long-read BAMs stay far under
# this; disq bounds its scan window similarly).
MAX_BLOCK_SIZE = 1 << 26
CHAIN_RECORDS = 10


class BamRecordGuesser:
    def __init__(self, n_ref: int, ref_lengths: Optional[Sequence[int]] = None):
        self.n_ref = n_ref
        self.ref_lengths = (
            np.asarray(ref_lengths, dtype=np.int64) if ref_lengths is not None else None
        )

    # -- single-candidate validation ---------------------------------------

    def looks_like_record(
        self, buf: np.ndarray, c: int, allow_partial: bool = False
    ) -> bool:
        """Structural validation of a candidate record start at ``c``.

        With ``allow_partial`` (used for the record straddling the end of
        a bounded window), every *visible* byte must still satisfy its
        constraint — a partially visible record is never accepted blindly.
        """
        end = len(buf)
        if c + 4 + _FIXED > end:
            if not allow_partial:
                return False
            return self._visible_prefix_ok(buf, c)
        block_size = int(buf[c:c + 4].view("<i4")[0])
        if not (_FIXED <= block_size < MAX_BLOCK_SIZE):
            return False
        refid = int(buf[c + 4:c + 8].view("<i4")[0])
        pos = int(buf[c + 8:c + 12].view("<i4")[0])
        if not (-1 <= refid < self.n_ref) or pos < -1:
            return False
        if (
            self.ref_lengths is not None
            and 0 <= refid < len(self.ref_lengths)
            and pos >= int(self.ref_lengths[refid])
        ):
            return False
        l_read_name = int(buf[c + 12])
        if l_read_name < 1:
            return False
        n_cigar = int(buf[c + 16:c + 18].view("<u2")[0])
        l_seq = int(buf[c + 20:c + 24].view("<i4")[0])
        if l_seq < 0:
            return False
        next_refid = int(buf[c + 24:c + 28].view("<i4")[0])
        next_pos = int(buf[c + 28:c + 32].view("<i4")[0])
        if not (-1 <= next_refid < self.n_ref) or next_pos < -1:
            return False
        sections = _FIXED + l_read_name + 4 * n_cigar + (l_seq + 1) // 2 + l_seq
        if sections > block_size:
            return False
        if not allow_partial and c + 4 + block_size > end:
            return False
        # Name NUL-terminated exactly at its claimed length.
        name_end = c + 4 + _FIXED + l_read_name - 1
        if name_end < end and int(buf[name_end]) != 0:
            return False
        # CIGAR op codes must be < 9 (ops MIDNSHP=X).
        cig_start = c + 4 + _FIXED + l_read_name
        cig_end = min(cig_start + 4 * n_cigar, end)
        if cig_end > cig_start:
            ops = buf[cig_start:cig_end]
            n_whole = (cig_end - cig_start) // 4
            if n_whole and (ops[: 4 * n_whole].view("<u4") & 0xF > 8).any():
                return False
        return True

    def _visible_prefix_ok(self, buf: np.ndarray, c: int) -> bool:
        """Validate the visible bytes of a record whose 36-byte prefix is
        cut off by the window end. Checks every field whose bytes are
        fully visible; returns False on any contradiction."""
        end = len(buf)
        if c + 4 <= end:
            block_size = int(buf[c:c + 4].view("<i4")[0])
            if not (_FIXED <= block_size < MAX_BLOCK_SIZE):
                return False
        if c + 8 <= end:
            refid = int(buf[c + 4:c + 8].view("<i4")[0])
            if not (-1 <= refid < self.n_ref):
                return False
        if c + 12 <= end:
            pos = int(buf[c + 8:c + 12].view("<i4")[0])
            if pos < -1:
                return False
        if c + 13 <= end and int(buf[c + 12]) < 1:
            return False
        if c + 24 <= end and int(buf[c + 20:c + 24].view("<i4")[0]) < 0:
            return False
        if c + 28 <= end:
            next_refid = int(buf[c + 24:c + 28].view("<i4")[0])
            if not (-1 <= next_refid < self.n_ref):
                return False
        if c + 32 <= end and int(buf[c + 28:c + 32].view("<i4")[0]) < -1:
            return False
        return True

    def check_chain(self, buf: np.ndarray, c: int, depth: int = CHAIN_RECORDS) -> bool:
        """Validate ``depth`` successive records from ``c``. A chain that
        runs off the window is accepted only if the straddling record's
        visible bytes validate."""
        end = len(buf)
        pos = c
        for _ in range(depth):
            if pos == end:
                return True
            if not self.looks_like_record(buf, pos, allow_partial=True):
                return False
            if pos + 4 > end:
                return True  # block_size itself not visible; prefix held
            block_size = int(buf[pos:pos + 4].view("<i4")[0])
            if pos + 4 + block_size > end:
                return True  # straddles the window; visible bytes held
            pos += 4 + block_size
        return True

    # -- search -------------------------------------------------------------

    def find_first_record(self, buf: np.ndarray) -> Optional[int]:
        """Offset of the first real record boundary in ``buf``, or None.

        Vectorized prefilter: refID and next_refID windows, l_read_name,
        block_size bounds — then chain-validate survivors in order.
        """
        buf = np.ascontiguousarray(buf)
        n = len(buf)
        if n < 4 + _FIXED:
            return None
        limit = n - (4 + _FIXED) + 1
        i32 = np.lib.stride_tricks.sliding_window_view(buf, 4).view("<i4").ravel()

        def at(off):  # i32 value at byte offset c+off for all candidates
            return i32[off: off + limit]

        cand = (
            (at(4) >= -1) & (at(4) < self.n_ref)
            & (at(24) >= -1) & (at(24) < self.n_ref)
            & (at(8) >= -1) & (at(28) >= -1)
            & (at(0) >= _FIXED) & (at(0) < MAX_BLOCK_SIZE)
            & (buf[12:12 + limit] >= 1)
            & (at(20) >= 0)
        )
        for c in np.nonzero(cand)[0]:
            c = int(c)
            if self.looks_like_record(buf, c) and self.check_chain(buf, c):
                return c
        return None
