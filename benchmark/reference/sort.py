"""The coordinate order: reference id, then position, the unplaced
(reference id -1) last, ties kept in input order. ``coordinate_keys`` is
a frozen copy of ``chip_smoke.py``'s."""

from __future__ import annotations

import numpy as np


def coordinate_keys(refid, pos) -> np.ndarray:
    rid = np.where(refid < 0, 0x7FFFFFFF, refid.astype(np.int64))
    return (rid.astype(np.uint64) << np.uint64(32)) | \
        ((pos.astype(np.int64) + 1).astype(np.uint64) & np.uint64(0xFFFFFFFF))


def stable_order(refid, pos) -> np.ndarray:
    """The permutation that coordinate-sorts the records, stably."""
    return np.argsort(coordinate_keys(refid, pos), kind="stable")
