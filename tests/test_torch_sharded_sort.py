"""The port's sharded coordinate sort (``disq_tpu_torch/sort/sharded.py``)
held against the reference's on the same keys.

The reference runs on its 8 virtual CPU devices (``tests/conftest.py``);
the port runs on the CPU repeated 8 times
(``DISQ_TPU_TORCH_FORCE_DEVICE_COUNT``). Both return ``(sorted keys,
permutation)``; they must be equal exactly, at the reference's sizes,
on its skewed keys, with unmapped records last and duplicate keys in
input order, on the flat and on the two-level exchange.
"""

import jax
import numpy as np
import pytest
import torch

from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
import disq_tpu.api as R
from disq_tpu.sort import sharded as ref
from disq_tpu.sort.coordinate import coordinate_keys as ref_keys
import disq_tpu_torch as P
from disq_tpu_torch.runtime import mesh as M
from disq_tpu_torch.sort import sharded as port
from disq_tpu_torch.sort.coordinate import coordinate_keys


@pytest.fixture(autouse=True)
def _eight(monkeypatch):
    monkeypatch.setenv(M.FORCE_ENV, "8")
    yield
    M.reset_mesh()


@pytest.fixture(scope="module")
def ref_mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return ref.make_mesh(8)


def _port_mesh(n=8):
    return port.make_mesh(n, device="cpu")


def _ref_grid(dcn, ici):
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[: dcn * ici]).reshape(dcn, ici),
                ("dcn", "shards"))


def _port_grid(dcn, ici):
    arr = np.empty((dcn, ici), dtype=object)
    for idx in np.ndindex(arr.shape):
        arr[idx] = torch.device("cpu")
    return M.Mesh(arr, ("dcn", "shards"))


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.uint64 and got[1].dtype == np.int64


@pytest.mark.parametrize("n", [0, 1, 7, 1000, 65_536, 100_001])
def test_flat_sort_equals_reference(ref_mesh, n):
    keys = np.random.default_rng(n).integers(0, 1 << 62, n, dtype=np.uint64)
    got = port.sharded_coordinate_sort(keys, _port_mesh())
    want = ref.sharded_coordinate_sort(keys, ref_mesh)
    _same(got, want)
    np.testing.assert_array_equal(got[1], np.argsort(keys, kind="stable"))


def test_skewed_keys_equal_reference(ref_mesh):
    rng = np.random.default_rng(5)
    keys = np.where(rng.random(50_000) < 0.9, np.uint64(42),
                    rng.integers(0, 1 << 60, 50_000, dtype=np.uint64))
    _same(port.sharded_coordinate_sort(keys, _port_mesh()),
          ref.sharded_coordinate_sort(keys, ref_mesh))


def test_unmapped_sort_last(ref_mesh):
    refid = np.array([1, -1, 0, 2, -1, 0], dtype=np.int32)
    pos = np.array([5, -1, 100, 1, -1, 2], dtype=np.int32)
    keys = coordinate_keys(refid, pos)
    np.testing.assert_array_equal(keys, ref_keys(refid, pos))
    got = port.sharded_coordinate_sort(keys, _port_mesh())
    _same(got, ref.sharded_coordinate_sort(keys, ref_mesh))
    assert [(int(refid[i]), int(pos[i])) for i in got[1]] == \
        [(0, 2), (0, 100), (1, 5), (2, 1), (-1, -1), (-1, -1)]


@pytest.mark.parametrize("n,shards", [(10_000, 8), (5, 8), (1000, 3),
                                      (0, 4), (77, 1)])
def test_splitters_equal_reference(n, shards):
    keys = np.random.default_rng(n).integers(0, 1 << 40, n, dtype=np.uint64)
    got = port.sample_splitters(keys, shards)
    np.testing.assert_array_equal(got, ref.sample_splitters(keys, shards))
    np.testing.assert_array_equal(got, port.sample_splitters(keys, shards))
    for a, b in zip(port.split_u64_keys(keys), ref.split_u64_keys(keys)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 8)])
def test_hierarchical_sort_equals_reference(shape):
    keys = np.random.default_rng(0).integers(0, 1 << 48, 5000,
                                             dtype=np.uint64)
    _same(port.hierarchical_coordinate_sort(keys, _port_grid(*shape)),
          ref.hierarchical_coordinate_sort(keys, _ref_grid(*shape)))


def test_hierarchical_skew_and_tiny_equal_reference():
    rng = np.random.default_rng(1)
    keys = np.where(rng.random(4000) < 0.9, np.uint64(42),
                    rng.integers(0, 1 << 40, 4000, dtype=np.uint64))
    for k in (keys, np.zeros(0, np.uint64), np.array([7, 3, 5], np.uint64)):
        _same(port.hierarchical_coordinate_sort(k, _port_grid(2, 4)),
              ref.hierarchical_coordinate_sort(k, _ref_grid(2, 4)))


def test_duplicate_key_tie_order_matches_flat(ref_mesh):
    keys = np.random.default_rng(3).integers(0, 50, 3000, dtype=np.uint64)
    flat = port.sharded_coordinate_sort(keys, _port_mesh())
    hier = port.hierarchical_coordinate_sort(keys, _port_grid(2, 4))
    _same(flat, hier)
    _same(flat, ref.sharded_coordinate_sort(keys, ref_mesh))
    np.testing.assert_array_equal(flat[1], np.argsort(keys, kind="stable"))


def test_whole_records_through_both_exchanges_equal_reference(tmp_path,
                                                              ref_mesh):
    recs = synth_records(4000, seed=23, sorted_coord=False)
    p = tmp_path / "in.bam"
    p.write_bytes(make_bam_bytes(DEFAULT_REFS, recs))
    want_b, want_perm = ref.sharded_sort_read_batch(
        R.ReadsStorage.make_default().read(str(p)).reads, ref_mesh)
    batch = P.ReadsStorage.make_default(device="cpu").read(str(p)).reads
    for mesh in (_port_mesh(), _port_grid(2, 4)):
        got_b, got_perm = port.sharded_sort_read_batch(batch, mesh)
        np.testing.assert_array_equal(got_perm, want_perm)
        for f in ("refid", "pos", "mapq", "bin", "flag", "next_refid",
                  "next_pos", "tlen", "name_offsets", "names",
                  "cigar_offsets", "cigars", "seq_offsets", "seqs",
                  "quals", "tag_offsets", "tags"):
            np.testing.assert_array_equal(getattr(got_b, f),
                                          np.asarray(getattr(want_b, f)),
                                          err_msg=f)


def test_host_batch_sort_takes_the_mesh_and_equals_reference(tmp_path):
    from disq_tpu.sort.coordinate import coordinate_sort_batch as ref_sort
    from disq_tpu_torch.runtime import tracing
    from disq_tpu_torch.sort.coordinate import coordinate_sort_batch

    recs = synth_records(3000, seed=11, sorted_coord=False, unmapped_tail=9)
    p = tmp_path / "in.bam"
    p.write_bytes(make_bam_bytes(DEFAULT_REFS, recs))
    want = ref_sort(R.ReadsStorage.make_default().read(str(p)).reads)
    batch = P.ReadsStorage.make_default(device="cpu").read(str(p)).reads
    before = tracing.REGISTRY.counter("device.mesh.exchange_bytes").total()
    got = coordinate_sort_batch(batch)
    assert tracing.REGISTRY.counter("device.mesh.exchange_bytes").total() \
        > before
    for f in ("refid", "pos", "flag", "names", "tags"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("n,shards", [(10_001, 8), (3, 8), (500, 2)])
def test_resident_sort_equals_stable_argsort(n, shards):
    rng = np.random.default_rng(n)
    refid = rng.integers(-1, 3, n).astype(np.int32)
    pos = rng.integers(-1, 5000, n).astype(np.int32)
    pos[refid < 0] = -1
    want = np.argsort(ref_keys(refid, pos), kind="stable")
    mesh = M.get_mesh(shards, "cpu")
    got = port.resident_coordinate_sort(
        M.mesh_put(torch.from_numpy(refid), mesh),
        M.mesh_put(torch.from_numpy(pos), mesh), n, mesh)
    np.testing.assert_array_equal(got, want)


def test_psum_splitters_are_the_exact_quantiles():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 1 << 50, 9999, dtype=np.uint64)
    hi, lo = port.split_u64_keys(keys)
    mesh = M.get_mesh(8, "cpu")
    s_hi, s_lo = port._psum_splitters(
        M.mesh_put(torch.from_numpy(hi.astype(np.int64)), mesh),
        M.mesh_put(torch.from_numpy(lo.astype(np.int64)), mesh),
        len(keys), mesh, "batch", 8)
    got = (s_hi.astype(np.uint64) << np.uint64(32)) | s_lo.astype(np.uint64)
    srt = np.sort(keys)
    want = [srt[max(0, (c + 1) * len(keys) // 8 - 1)] for c in range(7)]
    np.testing.assert_array_equal(got, want)
