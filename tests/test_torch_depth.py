"""Depth, the device transforms of ``ColumnarBatch``, pickling and
``device_columns`` on the CPU, against the JAX package.

- ``ops/depth.py::window_depth`` and ``ReadsDataset.depth`` equal to
  ``disq_tpu.ops.depth.window_depth`` at windows 1, 100 and 1024, on a
  host batch and on a device-backed one, with placed-unmapped reads,
  unplaced reads and a mapped flag on ``refid = -1``; the int32 guard
  and the all-unmapped case.
- ``ColumnarBatch.filter`` (mapq >= 20), ``permuted`` (the coordinate
  order) and their compositions on a ``.resident_decode()`` read stay
  device-backed, and equal the reference's ``ColumnarBatch`` built from
  the same record bytes, column for column and record for record; so do
  pickling round trips.
- ``device_columns`` returns a device-backed batch's own tensors, with
  no transfer booked, equal to the reference's columns.
- ``validation_stringency`` is stored as the reference stores it.
"""

import pickle

import numpy as np
import pytest
import torch

from bam_oracle import DEFAULT_REFS, ORecord, encode_record, make_bam_bytes, synth_records
import disq_tpu.api as R
from disq_tpu.bam.codec import scan_record_offsets as ref_scan
from disq_tpu.ops.depth import window_depth as ref_window_depth
from disq_tpu.runtime.columnar import ColumnarBatch as RefColumnarBatch
import disq_tpu_torch as P
from disq_tpu_torch.ops.depth import window_depth
from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime.columnar import ColumnarBatch
from disq_tpu_torch.util import shutdown_shared_host_pool

FIELDS = ("refid", "pos", "mapq", "bin", "flag", "next_refid", "next_pos",
          "tlen", "name_offsets", "names", "cigar_offsets", "cigars",
          "seq_offsets", "seqs", "quals", "tag_offsets", "tags")
FIXED = FIELDS[:8]
SPLIT = 4096
REF_LENGTHS = [ln for _, ln in DEFAULT_REFS]


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    """Leave no idle pool threads behind for later tests in the process."""
    yield
    shutdown_shared_host_pool()


@pytest.fixture(scope="module")
def records():
    recs = synth_records(600, seed=11, unmapped_tail=5)
    for r in recs[10:600:37]:
        r.flag |= 0x4            # placed but unmapped
    recs.append(ORecord(name="unplaced_mapped", refid=-1, pos=-1, flag=0,
                        seq="ACGT", qual=b"\x10" * 4, bin=4680))
    return recs


@pytest.fixture(scope="module")
def bam(records, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("depth") / "in.bam")
    with open(path, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS, records, blocksize=1000))
    return path


@pytest.fixture(scope="module")
def ref_batch(records):
    """The reference's device-backed batch of the same record bytes."""
    blob = np.frombuffer(b"".join(encode_record(r) for r in records),
                         np.uint8)
    batch = RefColumnarBatch.from_blob(blob, ref_scan(blob),
                                       n_ref=len(DEFAULT_REFS))
    assert batch.device_backed
    return batch


def _resident(bam):
    ds = (P.ReadsStorage.make_default(device="cpu").split_size(SPLIT)
          .resident_decode().read(bam))
    assert ds.reads.device_backed and ds.counters.shards > 3
    return ds


def _same_reads(got, want):
    assert got.count == want.count
    for f in FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _same_depth(got, want):
    assert sorted(got) == sorted(want)
    for r in want:
        assert got[r].dtype == np.int32
        np.testing.assert_array_equal(got[r], np.asarray(want[r]))


# -- depth ---------------------------------------------------------------------


@pytest.mark.parametrize("route", ["host", "resident"])
@pytest.mark.parametrize("window", [1, 100, 1024])
def test_depth_equals_reference(bam, ref_batch, window, route):
    st = (P.ReadsStorage.make_default(device="cpu").split_size(SPLIT)
          .resident_decode(route == "resident"))
    ds = st.read(bam)
    want = ref_window_depth(ref_batch, REF_LENGTHS, window)
    _same_depth(ds.depth(window), want)
    _same_depth(window_depth(ds.reads, REF_LENGTHS, window, device="cpu"),
                want)
    rds = R.ReadsStorage.make_default().split_size(SPLIT).read(bam)
    _same_depth(ds.depth(window), rds.depth(window))


def test_depth_of_unmapped_reads_only(records):
    unmapped = [r for r in records if r.flag & 0x4 or r.refid < 0]
    blob = np.frombuffer(b"".join(encode_record(r) for r in unmapped),
                         np.uint8)
    from disq_tpu_torch.bam.codec import decode_records, scan_record_offsets

    batch = decode_records(blob, scan_record_offsets(blob))
    got = window_depth(batch, REF_LENGTHS, 100, device="cpu")
    want = ref_window_depth(RefColumnarBatch.from_blob(
        blob, ref_scan(blob), n_ref=3), REF_LENGTHS, 100)
    _same_depth(got, want)
    assert all(not v.any() for v in got.values())


def test_depth_window_count_guard(bam):
    ds = P.ReadsStorage.make_default(device="cpu").read(bam)
    with pytest.raises(ValueError, match="int32"):
        window_depth(ds.reads, [2 ** 31], 1, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        ref_window_depth(ds.reads, [2 ** 31], 1)


def test_depth_defaults_to_cuda(bam, monkeypatch):
    """Like every entry point of the port, ``window_depth`` runs on
    ``cuda`` unless the caller asks for another device, and raises
    rather than summing on the host when CUDA is absent; a device-backed
    batch sums on its own device whatever ``device`` says."""
    host = P.ReadsStorage.make_default(device="cpu").read(bam)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        window_depth(host.reads, REF_LENGTHS, 100)
    monkeypatch.undo()
    res = (P.ReadsStorage.make_default(device="cpu").resident_decode()
           .read(bam))
    assert res.reads.device_backed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _same_depth(window_depth(res.reads, REF_LENGTHS, 100),
                window_depth(host.reads, REF_LENGTHS, 100, device="cpu"))


# -- filter / permuted ------------------------------------------------------


def _order(batch):
    from disq_tpu_torch.sort.coordinate import coordinate_keys

    return np.argsort(coordinate_keys(batch.refid, batch.pos), kind="stable")


def _transform(batch, steps):
    for step in steps:
        if step == "filter":
            batch = batch.filter(batch.mapq >= 20)
        elif step == "permuted":
            batch = batch.permuted(_order(batch))
        else:
            batch = pickle.loads(pickle.dumps(batch))
    return batch


CHAINS = [("filter",), ("permuted",), ("permuted", "filter"),
          ("filter", "permuted"), ("permuted", "permuted"), ("pickle",),
          ("permuted", "pickle"), ("filter", "pickle"),
          ("permuted", "pickle", "filter")]


@pytest.mark.parametrize("steps", CHAINS, ids=["-".join(c) for c in CHAINS])
def test_transforms_equal_reference(bam, ref_batch, steps):
    got = _transform(_resident(bam).reads, steps)
    want = _transform(ref_batch, steps)
    assert isinstance(got, ColumnarBatch) and got.device_backed
    assert got.device.type == "cpu"
    for name, col in got.device_columns().items():
        assert col.dtype == torch.int32
        np.testing.assert_array_equal(
            col.numpy(), np.asarray(want.device_columns()[name])[: want.count],
            err_msg=name)
    _same_reads(got, want)               # lazily fetched columns
    _same_reads(got.to_read_batch(), want.to_read_batch())


def test_transforms_equal_host_read_batch(bam):
    """filter and permuted on the device equal the host ReadBatch's
    filter and take."""
    ds = _resident(bam)
    host = P.ReadsStorage.make_default(device="cpu").read(bam).reads
    mask = host.mapq >= 20
    _same_reads(ds.reads.filter(mask), host.filter(mask))
    order = _order(host)
    _same_reads(ds.reads.permuted(order), host.take(order))
    assert ds.reads.permuted(order).sort_permutation().tolist() == \
        list(range(host.count))


def test_host_backed_transforms(bam):
    host = P.ReadsStorage.make_default(device="cpu").read(bam).reads
    wrapped = ColumnarBatch.from_host(host)
    mask = host.mapq >= 20
    _same_reads(wrapped.filter(mask), host.filter(mask))
    order = _order(host)
    got = wrapped.permuted(order)
    assert not got.device_backed
    _same_reads(got, host.take(order))
    back = pickle.loads(pickle.dumps(wrapped))
    assert not back.device_backed
    _same_reads(back, host)


def test_permuted_rejects_a_short_order(bam):
    with pytest.raises(ValueError, match="permutation"):
        _resident(bam).reads.permuted(np.arange(3))


def test_concat_keeps_pending_orders(bam):
    """Shards concatenated after a permutation keep their order (the
    read path's concat of permuted shards)."""
    batch = _resident(bam).reads
    host = batch.to_read_batch()
    n = batch.count
    a = batch.filter(np.arange(n) < n // 2)
    b = batch.filter(np.arange(n) >= n // 2)
    ra, rb = np.arange(a.count)[::-1].copy(), np.arange(b.count)[::-1].copy()
    got = ColumnarBatch.concat([a.permuted(ra), b.permuted(rb)])
    assert got.device_backed
    want = np.concatenate([ra, n // 2 + rb])
    _same_reads(got, host.take(want))


def test_filter_to_nothing(bam):
    batch = _resident(bam).reads
    got = batch.filter(np.zeros(batch.count, bool))
    assert got.count == 0


# -- device_columns --------------------------------------------------------


def test_device_columns_are_the_resident_tensors(bam, ref_batch):
    ds = _resident(bam)
    counters.reset()
    cols = ds.device_columns()
    assert counters.snapshot()["transfer_bytes"] == {}
    own = ds.reads.device_columns()
    want = ref_batch.device_columns()
    for name in FIXED:
        assert cols[name].data_ptr() == own[name].data_ptr()
        np.testing.assert_array_equal(
            cols[name].numpy(), np.asarray(want[name])[: ref_batch.count])
    rds = R.ReadsStorage.make_default().read(bam)
    for name, col in rds.device_columns().items():
        np.testing.assert_array_equal(cols[name].numpy(),
                                      np.asarray(col).astype(np.int32))


def test_device_columns_of_a_host_dataset(bam):
    ds = P.ReadsStorage.make_default(device="cpu").read(bam)
    cols = ds.device_columns()
    assert sorted(cols) == sorted(FIXED)
    for name in FIXED:
        assert cols[name].dtype == torch.int32 and cols[name].device.type == "cpu"
        np.testing.assert_array_equal(cols[name].numpy(),
                                      getattr(ds.reads, name).astype(np.int32))


# -- validation stringency ---------------------------------------------------


@pytest.mark.parametrize("name", ["STRICT", "LENIENT", "SILENT"])
def test_validation_stringency_stored_like_reference(name):
    assert P.ValidationStringency[name].value == R.ValidationStringency[name].value
    st = P.ReadsStorage.make_default(device="cpu")
    ref = R.ReadsStorage.make_default()
    assert st._stringency.value == ref._stringency.value == "strict"
    assert st.validation_stringency(P.ValidationStringency[name]) is st
    ref.validation_stringency(R.ValidationStringency[name])
    assert st._stringency.value == ref._stringency.value
