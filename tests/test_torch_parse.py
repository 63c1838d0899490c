"""The port's parse (kernel B2's plain version) against the JAX package.

The same decoded record bytes, made from a seed with the BAM oracle, go
through ``disq_tpu``'s prefix gather + Pallas parse kernel (interpret
mode on the CPU) and through ``disq_tpu_torch.ops.parse`` on CPU
tensors. Every value is an integer, so every comparison is exact.
"""

import gzip
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
from disq_tpu.ops.parse import _FIELD_ORDER as REF_FIELDS
from disq_tpu.ops.parse import parse_fixed_words_pallas
from disq_tpu.runtime.device_pipeline import gather_record_words as ref_gather
from disq_tpu_torch.ops import parse as P
from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime.device_pipeline import gather_record_words


def _decoded(n, seed):
    """(decoded record bytes, record offsets) via an independent walk."""
    raw = gzip.decompress(make_bam_bytes(DEFAULT_REFS, synth_records(n, seed=seed)))
    (l_text,) = struct.unpack_from("<i", raw, 4)
    p = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", raw, p)
    p += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", raw, p)
        p += 8 + l_name
    offs = [p]
    while p < len(raw):
        p += 4 + struct.unpack_from("<i", raw, p)[0]
        offs.append(p)
    return np.frombuffer(raw, np.uint8), np.asarray(offs, np.int64)


def _reference(blob, starts):
    """disq_tpu's gather + Pallas parse (interpret mode)."""
    padded = np.zeros(-(-len(blob) // 4) * 4 + 4, np.uint8)
    padded[: len(blob)] = blob
    words = ref_gather(jnp.asarray(padded.view("<u4")),
                       jnp.asarray(starts.astype(np.int32)))
    out = parse_fixed_words_pallas(words, interpret=True)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def shard():
    # 1500 records: more than one 1024-record tile of the reference
    # kernel and not a multiple of it; record starts are unaligned
    blob, offs = _decoded(1500, seed=11)
    return blob, offs[:-1]


def test_field_order_matches_reference():
    assert P._FIELD_ORDER == REF_FIELDS


def test_starts_are_unaligned_and_not_tile_multiple(shard):
    _, starts = shard
    assert len(starts) % 1024 != 0 and len(starts) > 1024
    assert len(set((starts % 4).tolist())) > 1


@pytest.mark.parametrize("field", REF_FIELDS)
def test_plain_parse_equals_jax_kernel(shard, field):
    blob, starts = shard
    want = _reference(blob, starts)[field]
    got = P.columns(P.parse_records(torch.from_numpy(blob.copy()),
                                    torch.from_numpy(starts)))[field]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_gather_equals_jax_gather(shard):
    blob, starts = shard
    padded = np.zeros(-(-len(blob) // 4) * 4 + 4, np.uint8)
    padded[: len(blob)] = blob
    want = np.asarray(ref_gather(jnp.asarray(padded.view("<u4")),
                                 jnp.asarray(starts.astype(np.int32))))
    got = gather_record_words(torch.from_numpy(blob.copy()),
                              torch.from_numpy(starts))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_gather_equals_host_prefix_words(shard):
    blob, starts = shard
    offs = np.append(starts, 0)
    want = P.record_prefix_words(blob, offs)
    got = gather_record_words(torch.from_numpy(blob.copy()),
                              torch.from_numpy(starts))
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_starts_and_bytes_past_the_end():
    rng = np.random.default_rng(3)
    blob = rng.integers(0, 256, 4099, dtype=np.uint8)
    starts = np.sort(rng.integers(0, len(blob), 777)).astype(np.int64)
    starts[-1] = len(blob) - 5  # prefix runs past the end: zeros
    got = P.parse_records(torch.from_numpy(blob), torch.from_numpy(starts))
    padded = np.concatenate([blob, np.zeros(40, np.uint8)])
    words = P.record_prefix_words(padded, np.append(starts, 0))
    for i, k in enumerate(P._FIELD_ORDER):
        np.testing.assert_array_equal(got[i].numpy(),
                                      P._split_words(words)[k])


def _reference_zero_past_end(blob, starts):
    """The JAX function on ``blob`` followed by zeros, so that a prefix
    running past the end reads zero there as the port's rule says (the
    JAX gather clamps to the last word instead)."""
    return _reference(np.concatenate([blob, np.zeros(48, np.uint8)]), starts)


@pytest.mark.parametrize("view_offset", [0, 1, 2, 3, 5, 13])
def test_edge_starts_equal_jax_kernel(view_offset):
    """Starts at every residue mod 4 and mod 16, prefixes ending exactly
    at the blob's end, within 40 bytes of it and past it, in a blob that
    is a view at ``view_offset`` bytes into a larger tensor."""
    rng = np.random.default_rng(17 + view_offset)
    big = torch.from_numpy(rng.integers(0, 256, 1000, dtype=np.uint8))
    blob = big[view_offset: view_offset + 777]
    assert blob.is_contiguous() and blob.storage_offset() == view_offset
    starts = P.edge_starts(blob.numel())
    assert set((starts[:64] % 16).tolist()) == set(range(16))
    ends = starts + 36
    n = blob.numel()
    assert (ends == n).any() and ((ends > n - 40) & (ends < n)).any() \
        and (ends > n).any() and starts.max() == n
    want = _reference_zero_past_end(blob.numpy(), starts)
    got = P.columns(P.parse_records(blob, torch.from_numpy(starts)))
    for k in REF_FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), want[k].astype(np.int32),
                                      err_msg=k)


@pytest.mark.parametrize("residue", range(16))
def test_records_at_every_residue_equal_jax_kernel(residue):
    """The decoded records shifted to start ``residue`` bytes into a
    16-byte-aligned buffer, the last record ending at the blob's end."""
    blob, offs = _decoded(300, seed=residue)
    shifted = np.concatenate([np.zeros(residue, np.uint8), blob])
    starts = offs[:-1] + residue
    assert offs[-1] == len(blob)
    want = _reference(shifted, starts)
    got = P.columns(P.parse_records(torch.from_numpy(shifted),
                                    torch.from_numpy(starts)))
    for k in REF_FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), want[k].astype(np.int32),
                                      err_msg=k)


def test_cpu_parse_books_no_launch():
    before = counters.snapshot()["launches"].get("parse", 0)
    P.parse_records(torch.zeros(64, dtype=torch.uint8),
                    torch.zeros(1, dtype=torch.int64))
    assert counters.snapshot()["launches"].get("parse", 0) == before


def test_empty_starts():
    out = P.parse_records(torch.zeros(8, dtype=torch.uint8),
                          torch.zeros(0, dtype=torch.int64))
    assert out.shape == (12, 0) and out.dtype == torch.int32


@pytest.mark.parametrize("bad", ["blob_dtype", "starts_dtype", "blob_2d",
                                 "strided"])
def test_rejects_what_the_kernel_does_not_take(bad):
    blob = torch.zeros(64, dtype=torch.uint8)
    starts = torch.zeros(2, dtype=torch.int64)
    if bad == "blob_dtype":
        blob = blob.to(torch.int32)
    elif bad == "starts_dtype":
        starts = starts.to(torch.int32)
    elif bad == "blob_2d":
        blob = blob.view(8, 8)
    else:
        starts = torch.zeros(4, dtype=torch.int64)[::2]
    with pytest.raises(ValueError):
        P.parse_records(blob, starts)
