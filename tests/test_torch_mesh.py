"""The port's mesh (``disq_tpu_torch/runtime/mesh.py``) on the CPU.

``DISQ_TPU_TORCH_FORCE_DEVICE_COUNT`` repeats the CPU n times, as the
reference's conftest forces 8 virtual CPU devices, so the whole meshed
read (each shard's parse, the ``psum`` reductions, the sharded sort's
``all_to_all``) runs here at 2, 4 and 8 shards. Everything is held
exactly against the single-device reference ``disq_tpu`` (its own mesh
path fails on this jax) and against ``tests/bam_oracle.py``:

- knob resolution, the counterpart of
  ``tests/test_mesh_pipeline.py::TestKnobResolution``;
- the collectives' semantics and their byte books;
- off-path purity, in a fresh interpreter;
- a meshed resident read's columns, flagstat, depth, sort permutation,
  and sorted BAM + BAI bytes;
- the operator suite's markdup and pileup on the mesh, against the
  oracles of ``tests/test_operator_suite.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bam_oracle import (DEFAULT_REFS, make_bam_bytes, oracle_markdup,
                        oracle_pileup, synth_paired_records, synth_records)
import disq_tpu.api as R
from disq_tpu.sort.coordinate import coordinate_keys as ref_keys
import disq_tpu_torch as P
from disq_tpu_torch.runtime import mesh as M
from disq_tpu_torch.runtime import tracing
from disq_tpu_torch.runtime.columnar import ColumnarBatch
from disq_tpu_torch.util import shutdown_shared_host_pool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXED = ("refid", "pos", "mapq", "bin", "flag", "next_refid", "next_pos",
         "tlen")
MESH_COUNTERS = ("device.mesh.reshard_bytes", "device.mesh.exchange_bytes",
                 "device.mesh.batches")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DISQ_TPU_TORCH_MESH", raising=False)
    monkeypatch.setenv(M.FORCE_ENV, "8")
    tracing.stop_span_log()
    tracing.reset_telemetry()
    yield
    M.reset_mesh()
    tracing.stop_span_log()
    tracing.reset_telemetry()


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    yield
    shutdown_shared_host_pool()


def _bam_file(tmp_path, n=220, blocksize=900, seed=29, tail=7):
    recs = synth_records(n, seed=seed, unmapped_tail=tail)
    src = tmp_path / "in.bam"
    src.write_bytes(make_bam_bytes(DEFAULT_REFS, recs, blocksize=blocksize))
    return str(src)


def _mesh_storage(n_dev, workers=1):
    return (P.ReadsStorage.make_default(device="cpu").resident_decode()
            .executor_workers(workers).mesh(n_dev))


def _total(name):
    return tracing.REGISTRY.counter(name).total()


# -- knob resolution -----------------------------------------------------------


def test_pow2_floor_and_clamp():
    assert M.shard_count(M.get_mesh(0, "cpu")) == 8
    assert M.shard_count(M.get_mesh(8, "cpu")) == 8
    assert M.shard_count(M.get_mesh(6, "cpu")) == 4   # pow2 floor
    assert M.shard_count(M.get_mesh(3, "cpu")) == 2
    assert M.shard_count(M.get_mesh(100, "cpu")) == 8  # clamps
    assert M.get_mesh(1, "cpu") is None                # the off path
    mesh = M.get_mesh(4, "cpu")
    assert mesh.axis_names == (M.MESH_AXIS,) and mesh.shape == {"batch": 4}
    assert [d.type for d in mesh.devices.flat] == ["cpu"] * 4
    assert M.get_mesh(4, "cpu") is mesh                # cached
    assert M.mesh_if_built() is M.get_mesh(8, "cpu")   # the largest


def test_env_knob(monkeypatch):
    class _S:
        _options = None

    for raw, want in (("", None), ("0", None), ("off", None), ("no", None),
                      ("all", 0), ("auto", 0), ("4", 4)):
        monkeypatch.setenv("DISQ_TPU_TORCH_MESH", raw)
        assert M.mesh_devices_requested(_S()) == want, raw


def test_options_knob_wins_over_env(monkeypatch):
    monkeypatch.setenv("DISQ_TPU_TORCH_MESH", "2")
    st = P.ReadsStorage.make_default(device="cpu").mesh(4)
    assert M.mesh_devices_requested(st) == 4
    assert P.ReadsStorage.make_default().mesh(0)._options.mesh == 0
    assert P.VariantsStorage.make_default().mesh(2)._options.mesh == 2
    with pytest.raises(ValueError):
        P.DisqOptions().with_mesh(-1)


def test_off_by_default():
    assert M.mesh_devices_requested(P.ReadsStorage.make_default()) is None
    assert M.mesh_for_storage(P.ReadsStorage.make_default(device="cpu")) \
        is None
    assert M.mesh_if_built() is None


def test_local_devices_seam(monkeypatch):
    assert M.local_devices("cpu") == [torch.device("cpu")] * 8
    monkeypatch.delenv(M.FORCE_ENV)
    assert M.local_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        assert M.local_devices() == []
    # one device left: the knob is the off path, and the read is plain
    st = P.ReadsStorage.make_default(device="cpu").mesh(8)
    assert M.mesh_for_storage(st) is None


# -- the collectives -------------------------------------------------------------


def _grid_mesh(shape, names):
    arr = np.empty(shape, dtype=object)
    for idx in np.ndindex(shape):
        arr[idx] = torch.device("cpu")
    return M.Mesh(arr, names)


def test_psum_over_one_and_both_axes():
    mesh = _grid_mesh((2, 4), ("dcn", "shards"))
    parts = [torch.full((3,), float(i + 1)) for i in range(8)]
    rows = M.psum(parts, mesh, "shards")
    assert [int(r[0]) for r in rows] == [10] * 4 + [26] * 4
    cols = M.psum(parts, mesh, "dcn")
    assert [int(c[0]) for c in cols] == [6, 8, 10, 12] * 2
    both = M.psum(parts, mesh, ("dcn", "shards"))
    assert all(torch.equal(b, torch.full((3,), 36.0)) for b in both)
    flat = M.psum(parts[:4], _grid_mesh((4,), ("batch",)), "batch")
    assert [int(f[0]) for f in flat] == [10] * 4


def test_all_to_all_moves_bucket_j_of_shard_i_to_shard_j():
    mesh = _grid_mesh((4,), ("shards",))
    parts = [torch.arange(4 * 3).reshape(4, 3) + 100 * i for i in range(4)]
    got = M.all_to_all(parts, mesh, "shards")
    for j in range(4):
        want = torch.stack([parts[i][j] for i in range(4)])
        assert torch.equal(got[j], want)
    assert _total("device.mesh.exchange_bytes") == 4 * 12 * 8
    grid = _grid_mesh((2, 2), ("dcn", "shards"))
    parts = [torch.arange(4).reshape(2, 2) + 10 * i for i in range(4)]
    inner = M.all_to_all(parts, grid, "shards")
    assert torch.equal(inner[1], torch.stack([parts[0][1], parts[1][1]]))
    outer = M.all_to_all(parts, grid, "dcn")
    assert torch.equal(outer[2], torch.stack([parts[0][1], parts[2][1]]))
    with pytest.raises(ValueError):
        M.all_to_all([torch.zeros(3, 2)] * 4, mesh, "shards")


def test_mesh_put_splits_books_and_passes_placed_parts_through():
    mesh = M.get_mesh(4, "cpu")
    x = torch.arange(10, dtype=torch.int32)
    parts = M.mesh_put(x, mesh)
    assert [p.tolist() for p in parts] == [[0, 1, 2], [3, 4, 5], [6, 7, 8],
                                           [9]]
    assert M.shard_bounds(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    moved = _total("device.mesh.reshard_bytes")
    assert M.mesh_put(parts, mesh) is not parts
    assert all(a is b for a, b in zip(M.mesh_put(parts, mesh), parts))
    assert _total("device.mesh.reshard_bytes") == moved
    joined = M.mesh_put([x[:7], x[7:]], mesh)
    assert torch.equal(torch.cat(joined), x)
    rep = M.mesh_put(x, mesh, batch=False)
    assert len(rep) == 4 and all(torch.equal(r, x) for r in rep)
    assert _total("device.mesh.reshard_bytes") > moved
    assert torch.equal(M.mesh_gather(parts), x)
    assert M.batch_sharding(mesh) == M.batch_sharding(mesh)
    assert M.batch_sharding(mesh) != M.replicated(mesh)


# -- off-path purity -----------------------------------------------------------


def test_default_read_builds_no_mesh(tmp_path):
    """A fresh interpreter: the default path builds no mesh, reshards
    nothing and keeps one device-service queue."""
    code = f"""
import sys
sys.path[:0] = [{REPO!r}, {os.path.join(REPO, 'tests')!r}]
from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
open({str(tmp_path / 'off.bam')!r}, "wb").write(
    make_bam_bytes(DEFAULT_REFS, synth_records(80, seed=3)))
from disq_tpu_torch.api import ReadsStorage
from disq_tpu_torch.runtime import mesh
from disq_tpu_torch.runtime.tracing import REGISTRY
ds = ReadsStorage.make_default(device="cpu").resident_decode().read(
    {str(tmp_path / 'off.bam')!r})
assert ds.reads.device_backed and ds.reads.mesh is None
ds.flagstat()
ds.coordinate_sorted()
assert mesh.mesh_if_built() is None
assert mesh.service_devices("cpu") == [None]
for name in {MESH_COUNTERS!r}:
    assert REGISTRY.counter(name).total() == 0, name
print("OK")
"""
    env = {k: v for k, v in os.environ.items()
           if k not in ("DISQ_TPU_TORCH_MESH", M.FORCE_ENV)}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "OK" in r.stdout


# -- the meshed read against the single-device reference ----------------------


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_resident_read_carries_mesh_and_equals_reference(tmp_path, n_dev):
    path = _bam_file(tmp_path)
    want = R.ReadsStorage.make_default().read(path).reads
    cb = _mesh_storage(n_dev).read(path).reads
    assert isinstance(cb, ColumnarBatch) and cb.device_backed
    assert cb.mesh is not None and M.shard_count(cb.mesh) == n_dev
    shards = cb.shard_columns()["pos"]
    assert len(shards) == n_dev
    assert sum(s.numel() for s in shards) == cb.count == want.count
    for f in FIXED:
        got = getattr(cb, f)
        np.testing.assert_array_equal(got, np.asarray(getattr(want, f)),
                                      err_msg=f)
        assert got.dtype == np.asarray(getattr(want, f)).dtype, f
    assert _total("device.mesh.batches") > 0
    cb.release()


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_flagstat_psum_equals_reference(tmp_path, n_dev):
    path = _bam_file(tmp_path, n=260, seed=31, tail=9)
    want = R.ReadsStorage.make_default().read(path).flagstat()
    ds = _mesh_storage(n_dev).read(path)
    assert ds.reads.mesh is not None
    assert ds.flagstat() == want
    # the dataset's explicit mesh form over a host column
    mesh = M.get_mesh(n_dev, "cpu")
    host = P.ReadsStorage.make_default(device="cpu").read(path)
    assert host.flagstat(mesh=mesh, axis="batch") == want


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_depth_psum_equals_reference(tmp_path, n_dev):
    path = _bam_file(tmp_path, n=240, seed=37)
    want = R.ReadsStorage.make_default().read(path).depth(window=1024)
    got = _mesh_storage(n_dev).read(path).depth(window=1024)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=str(k))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_sort_permutation_equals_reference(tmp_path, n_dev):
    path = _bam_file(tmp_path, n=300, seed=41, tail=11)
    host = R.ReadsStorage.make_default().read(path).reads
    want = np.argsort(ref_keys(np.asarray(host.refid), np.asarray(host.pos)),
                      kind="stable")
    cb = _mesh_storage(n_dev).read(path).reads
    np.testing.assert_array_equal(cb.sort_permutation(), want)
    assert _total("device.mesh.exchange_bytes") > 0
    cb.release()


@pytest.mark.parametrize("n_dev,workers", [(2, 1), (4, 4), (8, 1), (8, 4)])
def test_sorted_bam_and_bai_equal_reference(tmp_path, n_dev, workers):
    path = _bam_file(tmp_path, n=280, seed=43, tail=8)
    ref = R.ReadsStorage.make_default().num_shards(3)
    ref_out = str(tmp_path / "ref.bam")
    ref.write(ref.read(path), ref_out, R.BaiWriteOption.ENABLE, sort=True)
    st = _mesh_storage(n_dev, workers=workers).num_shards(3)
    out = str(tmp_path / f"mesh{n_dev}w{workers}.bam")
    ds = st.read(path)
    assert ds.reads.mesh is not None
    st.write(ds, out, P.BaiWriteOption.ENABLE, sort=True)
    with open(ref_out, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()
    with open(ref_out + ".bai", "rb") as a, open(out + ".bai", "rb") as b:
        assert a.read() == b.read()


def test_mesh_carries_through_permute_filter_concat_and_flags(tmp_path):
    path = _bam_file(tmp_path, n=200, seed=5, tail=4)
    want = R.ReadsStorage.make_default().read(path).reads
    cb = _mesh_storage(4).read(path).reads
    n = cb.count
    order = np.random.default_rng(1).permutation(n)
    perm = cb.permuted(order)
    assert perm.mesh is cb.mesh
    np.testing.assert_array_equal(perm.pos, np.asarray(want.pos)[order])
    mask = np.asarray(want.flag) & 0x4 == 0
    kept = cb.filter(mask)
    assert kept.mesh is cb.mesh
    np.testing.assert_array_equal(kept.refid, np.asarray(want.refid)[mask])
    flags = np.asarray(want.flag).copy()
    marks = np.zeros(n, bool)
    marks[::7] = True
    kept2 = cb.filter(np.ones(n, bool))
    kept2.or_flags(marks, 0x400)
    flags[marks] |= 0x400
    np.testing.assert_array_equal(kept2.flag, flags)
    assert kept2.flagstat()["duplicates"] == int(marks.sum())
    halves = [cb.filter(np.arange(n) < n // 2),
              cb.filter(np.arange(n) >= n // 2)]
    joined = ColumnarBatch.concat(halves)
    assert joined.mesh is cb.mesh
    np.testing.assert_array_equal(joined.pos, np.asarray(want.pos))
    assert [len(p) for p in joined.shard_columns()["pos"]] == \
        [e - s for s, e in M.shard_bounds(n, 4)]


# -- the operator suite on the mesh ----------------------------------------------

PAIRED = synth_paired_records(120, seed=41)
ORACLE_DUPS = {
    (r.name, r.flag & ~0x400, r.refid, r.pos)
    for r, d in zip(PAIRED, oracle_markdup(PAIRED)) if d
}


@pytest.fixture(scope="module")
def paired_bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("meshops") / "paired.bam")
    with open(path, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS, PAIRED, blocksize=900))
    return path


def _marked_keys(batch):
    flag = np.asarray(batch.flag)
    out = set()
    for i in np.nonzero(flag & 0x400)[0]:
        out.add((batch.name(int(i)), int(flag[i]) & ~0x400,
                 int(batch.refid[i]), int(batch.pos[i])))
    return out


def _ops_storage(mesh):
    return (P.ReadsStorage.make_default(device="cpu").split_size(6000)
            .resident_decode().mesh(mesh))


@pytest.mark.parametrize("mesh", [2, 4, 8])
def test_markdup_on_the_mesh_equals_oracle(paired_bam, mesh):
    ds = _ops_storage(mesh).read(paired_bam)
    assert ds.reads.mesh is not None
    ds2, stats = ds.pipeline("markdup")
    assert _marked_keys(ds2.reads) == ORACLE_DUPS
    assert stats["markdup"]["duplicates"] == len(ORACLE_DUPS)


@pytest.mark.parametrize("mesh", [2, 4, 8])
def test_pileup_on_the_mesh_equals_oracle(paired_bam, mesh):
    from disq_tpu_torch.ops.pileup import region_pileup

    ds = _ops_storage(mesh).read(paired_bam)
    assert ds.reads.mesh is not None
    want = oracle_pileup(PAIRED, 0, 0, 20_000)
    np.testing.assert_array_equal(region_pileup(ds.reads, 0, 0, 20_000), want)


def test_rgstats_on_the_mesh_equals_single_device(paired_bam):
    from disq_tpu_torch.ops.rgstats import read_group_stats

    single = P.ReadsStorage.make_default(device="cpu").split_size(6000) \
        .resident_decode().read(paired_bam)
    meshed = _ops_storage(4).read(paired_bam)
    assert meshed.reads.mesh is not None
    assert read_group_stats(meshed.reads) == read_group_stats(single.reads)


def test_run_device_pipeline_on_the_mesh_equals_single_device(tmp_path):
    from disq_tpu_torch.bam.codec import scan_record_offsets
    from disq_tpu_torch.runtime.device_pipeline import run_device_pipeline

    recs = synth_records(150, seed=9, unmapped_tail=5)
    from bam_oracle import encode_record

    blob = np.frombuffer(b"".join(encode_record(r) for r in recs), np.uint8)
    offsets = scan_record_offsets(blob)
    k1, o1, s1 = run_device_pipeline(blob, offsets, device="cpu")
    k2, o2, s2 = run_device_pipeline(blob, offsets,
                                     mesh=M.get_mesh(4, "cpu"))
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(o1, o2)
    assert s1 == s2


def test_device_service_keeps_one_sub_queue_per_mesh_device(tmp_path,
                                                            monkeypatch):
    from disq_tpu_torch.runtime import device_service as DS

    path = _bam_file(tmp_path, n=300, seed=2)
    want = R.ReadsStorage.make_default().read(path)
    monkeypatch.setenv("DISQ_TPU_TORCH_MESH", "4")
    monkeypatch.setenv("DISQ_TPU_TORCH_DEVICE_SERVICE", "1")
    assert M.service_devices("cpu") == [torch.device("cpu")] * 4
    try:
        ds = (P.ReadsStorage.make_default(device="cpu").resident_decode()
              .split_size(4000).executor_workers(4).read(path))
        svc = DS.service_if_running()
        assert svc is not None and len(svc._devices) == 4
        assert len(svc._queues["inflate"]) == 4
    finally:
        DS.shutdown_service()
    assert ds.reads.mesh is not None
    for f in FIXED:
        np.testing.assert_array_equal(getattr(ds.reads, f),
                                      np.asarray(getattr(want.reads, f)))
    assert ds.flagstat() == want.flagstat()
