"""Record-by-record comparison of a written file with the reference's
sort of its input, in blocks of rows so that it fits in memory."""

from __future__ import annotations

import numpy as np

from benchmark.reference.bam import Decoded, _flat

BLOCK = 200_000


def _row_mismatch(ref_flat, ref_off, got_flat, got_off) -> np.ndarray:
    """Rows whose segment differs, by length or by content."""
    lr, lg = np.diff(ref_off), np.diff(got_off)
    bad = lr != lg
    ok = np.nonzero(~bad)[0]
    if len(ok):
        a = _flat(ref_flat, ref_off[ok], lr[ok])
        b = _flat(got_flat, got_off[ok], lr[ok])
        diff = np.nonzero(a != b)[0]
        if len(diff):
            seg = np.repeat(ok, lr[ok])
            bad[seg[diff]] = True
    return bad


def mismatched_sorted(src: Decoded, order: np.ndarray, out: Decoded) -> int:
    """Records of the written file ``out`` whose bytes differ from the
    input ``src``'s records taken in ``order``; a record one side lacks
    counts as a mismatch. The whole record stream is compared first;
    records are looked at one by one only where it differs."""
    if len(order) == out.count:
        raw = src.raw
        want = b"".join([raw[a:b] for a, b in zip(src.start[order].tolist(),
                                                   src.end[order].tolist())])
        got = out.raw[int(out.start[0]):int(out.end[-1])] if out.count \
            else b""
        if want == got:
            return 0
        del want, got
    n = min(len(order), out.count)
    bad_total = abs(len(order) - out.count)
    for lo in range(0, n, BLOCK):
        hi = min(n, lo + BLOCK)
        rows = order[lo:hi]
        ls = src.end[rows] - src.start[rows]
        lo_ = out.end[lo:hi] - out.start[lo:hi]
        ref_off = np.zeros(hi - lo + 1, np.int64)
        np.cumsum(ls, out=ref_off[1:])
        got_off = np.zeros(hi - lo + 1, np.int64)
        np.cumsum(lo_, out=got_off[1:])
        bad = _row_mismatch(_flat(src.blob, src.start[rows], ls), ref_off,
                            _flat(out.blob, out.start[lo:hi], lo_), got_off)
        bad_total += int(bad.sum())
    return bad_total

