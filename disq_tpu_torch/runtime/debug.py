"""Environment knobs and the debug invariant mode.

``DISQ_TPU_TORCH_DEBUG=1`` asserts shard-boundary invariants after a
read: consistent column lengths, monotone ragged offsets, strictly
increasing virtual file offsets (O(N) numpy passes on the host; off by
default).
"""

from __future__ import annotations

import os

import numpy as np


def env_flag(name: str, default: str = "0") -> bool:
    """Boolean env-var semantics: unset ⇒ ``default``; "", 0, false and
    off ⇒ False; anything else ⇒ True."""
    return os.environ.get(name, default).lower() not in (
        "", "0", "false", "off")


def debug_enabled() -> bool:
    return env_flag("DISQ_TPU_TORCH_DEBUG")


def _check_offsets(name: str, offsets: np.ndarray, n: int,
                   data_len: int) -> None:
    if offsets.shape != (n + 1,):
        raise AssertionError(
            f"{name}_offsets shape {offsets.shape} != ({n + 1},)")
    if len(offsets):
        if offsets[0] != 0:
            raise AssertionError(f"{name}_offsets[0] = {offsets[0]} != 0")
        if np.any(np.diff(offsets) < 0):
            raise AssertionError(f"{name}_offsets not monotone")
        if offsets[-1] != data_len:
            raise AssertionError(
                f"{name}_offsets[-1] = {offsets[-1]} != len = {data_len}")


def check_read_batch(batch, n_ref: int = None) -> None:
    """Assert the columnar invariants of a read batch (host or
    device-backed, whose ragged columns are parsed for it)."""
    n = batch.count
    for col in ("pos", "mapq", "bin", "flag", "next_refid", "next_pos",
                "tlen"):
        arr = getattr(batch, col)
        if len(arr) != n:
            raise AssertionError(f"column {col} length {len(arr)} != {n}")
    _check_offsets("name", batch.name_offsets, n, len(batch.names))
    _check_offsets("cigar", batch.cigar_offsets, n, len(batch.cigars))
    _check_offsets("seq", batch.seq_offsets, n, len(batch.seqs))
    _check_offsets("tag", batch.tag_offsets, n, len(batch.tags))
    if len(batch.quals) != len(batch.seqs):
        raise AssertionError("quals length != seqs length")
    if n_ref is not None and n:
        rid = np.asarray(batch.refid)
        if rid.min(initial=0) < -1 or rid.max(initial=-1) >= n_ref:
            raise AssertionError(f"refid outside [-1, {n_ref})")


def check_voffsets(voffsets: np.ndarray) -> None:
    """Virtual file offsets of successive records must strictly increase."""
    v = np.asarray(voffsets, dtype=np.uint64)
    if len(v) > 1 and np.any(v[1:] <= v[:-1]):
        bad = int(np.argmax(v[1:] <= v[:-1]))
        raise AssertionError(
            f"virtual offsets not strictly increasing at record {bad + 1}")
