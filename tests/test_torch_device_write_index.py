"""The device write's index fragments on the CPU, held byte for byte against the JAX package.

A sorted device-backed batch written with ``device_deflate()`` gathers
each shard on the device (W1's plain version) and deflates it there
(W2's plain version); the shard's BAI and SBI fragments then read
``refid``, ``pos``, ``flag`` and the CIGAR words from the host copy of
the shard's bytes (``EncodedShard.host_payload``, parsed by
``bam/codec.GatheredRecords.parse``), not from a host parse of the whole
sorted batch. Each write is compared with the reference's
``resident_decode().device_deflate()`` write, ``num_shards`` pinned on
both sides:

- sorted with BAI and SBI at 1, 3 and 8 shards and 1 and 4 writer
  workers: ``columnar.batch.materializations`` does not move and
  ``bam.write.index_fields{source=bytes}`` counts every shard; a write
  without an index counts none;
- edge cases: more shards asked for than records; a third of the reads
  unmapped (a shard of unplaced reads only); odd-length reads with a
  set pad nibble and names whose last byte is not NUL; an empty shard
  and partial shards, fragment by fragment against the reference's;
- the resident ``filter → sort → markdup`` chain under the knob: BAM
  and BAI equal to the same chain's host batch written under the knob,
  with no materialization;
- a host ``ReadBatch`` under the knob takes the ``encoded`` route and
  counts ``source=columns``.

Tolerance is 0: these are bytes.
"""

import numpy as np
import pytest

from bam_oracle import synth_paired_records, synth_records
import disq_tpu.api as R
import disq_tpu_torch as P
from disq_tpu_torch.bam.sink import BamSink
from disq_tpu_torch.runtime import tracing as PT
from disq_tpu_torch.util import shutdown_shared_host_pool
from test_torch_sorted_write_gather import _bam, _odd_bytes_bam

N_RECORDS = 2000


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    yield
    shutdown_shared_host_pool()


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    return _bam(tmp_path_factory.mktemp("dindex") / "in.bam",
                synth_records(N_RECORDS, seed=23, unmapped_tail=9))


def _files(path, exts=(".bai", ".sbi")):
    out = []
    for ext in ("",) + tuple(exts):
        with open(path + ext, "rb") as f:
            out.append(f.read())
    return out


def _ref_write(src, out, shards, *options):
    st = (R.ReadsStorage.make_default().num_shards(shards).resident_decode()
          .device_deflate())
    st.write(st.read(src), out, *options, sort=True)
    return out


def _port(shards, workers=1, resident=True):
    st = (P.ReadsStorage.make_default(device="cpu").split_size(30000)
          .num_shards(shards).writer_workers(workers))
    return (st.resident_decode() if resident else st).device_deflate()


def _fields():
    return PT.REGISTRY.counter("bam.write.index_fields")


def _port_write(st, src, out, *options, shards, source="bytes"):
    """Read ``src`` and write it sorted through ``st``; asserts that
    ``shards`` fragments read their fields from ``source`` and, for
    ``bytes``, that no record was parsed on the host during the write."""
    ds = st.read(src)
    assert getattr(ds.reads, "device_backed", False) == (source == "bytes")
    mats = PT.REGISTRY.counter("columnar.batch.materializations")
    base_mat = mats.total()
    other = "columns" if source == "bytes" else "bytes"
    base, base_other = _fields().value(source=source), \
        _fields().value(source=other)
    st.write(ds, out, *options, sort=True)
    assert _fields().value(source=source) - base == shards
    assert _fields().value(source=other) == base_other
    if source == "bytes":
        assert mats.total() == base_mat
    return out


@pytest.fixture(scope="module")
def ref_sorted(src, tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_dindex")
    return {n: _ref_write(src, str(d / f"ref{n}.bam"), n,
                          R.BaiWriteOption.ENABLE, R.SbiWriteOption.ENABLE)
            for n in (1, 3, 8)}


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("shards", [1, 3, 8])
def test_sorted_device_write_indexes_from_shard_bytes(src, ref_sorted,
                                                      tmp_path, shards,
                                                      workers):
    out = _port_write(_port(shards, workers), src, str(tmp_path / "o.bam"),
                      P.BaiWriteOption.ENABLE, P.SbiWriteOption.ENABLE,
                      shards=shards)
    assert _files(out) == _files(ref_sorted[shards])


def test_write_without_an_index_counts_no_fields(src, tmp_path):
    ref = _ref_write(src, str(tmp_path / "ref.bam"), 3)
    out = _port_write(_port(3, 2), src, str(tmp_path / "o.bam"), shards=0)
    assert _files(out, ()) == _files(ref, ())


def test_more_shards_than_records(tmp_path):
    small = _bam(tmp_path / "small.bam",
                 synth_records(5, seed=4, unmapped_tail=1))
    ref = _ref_write(small, str(tmp_path / "ref.bam"), 8,
                     R.BaiWriteOption.ENABLE, R.SbiWriteOption.ENABLE)
    # one shard per record when there are fewer records than shards
    out = _port_write(_port(8, 4), small, str(tmp_path / "o.bam"),
                      P.BaiWriteOption.ENABLE, P.SbiWriteOption.ENABLE,
                      shards=6)
    assert _files(out) == _files(ref)


def test_a_shard_of_unplaced_reads_only(tmp_path):
    tail = _bam(tmp_path / "tail.bam",
                synth_records(600, seed=8, unmapped_tail=200))
    ref = _ref_write(tail, str(tmp_path / "ref.bam"), 4,
                     R.BaiWriteOption.ENABLE, R.SbiWriteOption.ENABLE)
    out = _port_write(_port(4, 2), tail, str(tmp_path / "o.bam"),
                      P.BaiWriteOption.ENABLE, P.SbiWriteOption.ENABLE,
                      shards=4)
    assert _files(out) == _files(ref)


def test_odd_reads_and_unterminated_names(tmp_path):
    bam = _odd_bytes_bam(tmp_path / "odd.bam")
    ref = _ref_write(bam, str(tmp_path / "ref.bam"), 3,
                     R.BaiWriteOption.ENABLE, R.SbiWriteOption.ENABLE)
    out = _port_write(_port(3, 2), bam, str(tmp_path / "o.bam"),
                      P.BaiWriteOption.ENABLE, P.SbiWriteOption.ENABLE,
                      shards=3)
    assert _files(out) == _files(ref)


@pytest.fixture(scope="module")
def sorted_pair(src):
    """(reference dataset, its sorted batch, port dataset, its sorted
    batch), both device-backed and permuted by the same order."""
    rds = R.ReadsStorage.make_default().resident_decode().read(src)
    pds = _port(1).read(src)
    order = pds.reads.sort_permutation()
    assert np.array_equal(order, rds.reads.sort_permutation())
    return rds, rds.reads.permuted(order), pds, pds.reads.permuted(order)


@pytest.mark.parametrize("bounds", [(0, N_RECORDS + 9), (7, 1300), (40, 40),
                                    (N_RECORDS + 8, N_RECORDS + 9)])
def test_shard_fragments_equal_reference(sorted_pair, bounds):
    """One shard through the deflate step on its own, an empty one
    included: the device route's compressed bytes and fragments against
    the reference's, whose fragments read the sliced batch."""
    from disq_tpu.bam.sink import BamSink as RefSink, _LazySlice
    from disq_tpu.runtime.device_write import ResidentShardEncoder as RefEnc
    from disq_tpu_torch.runtime.device_write import ResidentShardEncoder

    rds, ref_perm, pds, perm = sorted_pair
    lo, hi = bounds
    ref_enc = RefEnc(ref_perm)
    try:
        shard = ref_enc.encode_shard(lo, hi)
        want = RefSink()._deflate_shard(
            rds.header, True, True,
            (_LazySlice(ref_perm, lo, hi), shard, shard.record_offsets))
    finally:
        ref_enc.release()
    enc = ResidentShardEncoder(perm, "cpu")
    mats = PT.REGISTRY.counter("columnar.batch.materializations")
    base_mat, base = mats.total(), _fields().value(source="bytes")
    shard = enc.encode_shard(lo, hi)
    got = BamSink(_port(1))._deflate_shard(
        pds.header, True, True, 0, (None, shard, shard.record_offsets))
    enc.release()
    assert got[0] == want[0]
    assert got[1].to_bytes() == want[1].to_bytes()
    assert got[2].to_bytes() == want[2].to_bytes()
    assert mats.total() == base_mat
    assert _fields().value(source="bytes") - base == 1


def test_resident_chain_under_the_knob(tmp_path):
    path = _bam(tmp_path / "paired.bam", synth_paired_records(120, seed=41),
                blocksize=900)
    chain = (("filter", "-F 0x800 -q 0"), "sort", "markdup")
    st = (P.ReadsStorage.make_default(device="cpu").split_size(4000)
          .num_shards(3).writer_workers(2))
    mats = PT.REGISTRY.counter("columnar.batch.materializations")
    base_mat, base = mats.total(), _fields().value(source="bytes")
    res_ds, res_stats = st.resident_decode().read(path).pipeline(*chain)
    assert res_ds.reads.device_backed
    assert res_stats["markdup"]["duplicates"] > 0
    res_out = str(tmp_path / "res.bam")
    st.device_deflate().write(res_ds, res_out, P.BaiWriteOption.ENABLE)
    assert mats.total() == base_mat
    assert _fields().value(source="bytes") - base == 3
    host_ds, host_stats = st.read(path).pipeline(*chain)
    assert host_stats == res_stats
    host_out = str(tmp_path / "host.bam")
    st.device_deflate().write(host_ds, host_out, P.BaiWriteOption.ENABLE)
    assert _files(res_out, (".bai",)) == _files(host_out, (".bai",))
    res_ds.reads.release()


def test_host_batch_counts_columns(src, ref_sorted, tmp_path):
    routes = PT.REGISTRY.counter("bam.write.shards")
    base = routes.value(route="encoded")
    out = _port_write(_port(3, 4, resident=False), src,
                      str(tmp_path / "o.bam"), P.BaiWriteOption.ENABLE,
                      P.SbiWriteOption.ENABLE, shards=3, source="columns")
    assert routes.value(route="encoded") - base == 3
    # the reference's host batch under the knob: host encode, device
    # deflate; its bytes are the resident write's (the records are
    # NUL-terminated, even reads unpadded)
    assert _files(out) == _files(ref_sorted[3])
