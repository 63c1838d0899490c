"""The BAM sink's gathered route on the CPU, held byte for byte against the JAX package.

A device-backed batch (``resident_decode()``, the plain versions of the
card's kernels) sorted for a BAM write keeps the sort's permutation
(``ColumnarBatch.permuted``), and each writer gathers its shard's record
bytes from the read's decoded blob (``bam/codec.gather_records``) in
place of a host decode, take and re-encode. Each write here is compared
with the reference's host zlib-6 write of the same input, ``num_shards``
pinned on both sides, BAM, BAI and SBI:

- sorted, at 1, 3 and 8 shards and 1 and 4 writer workers, with an
  unmapped tail; more shards asked for than records; a third of
  the reads unmapped (a shard of unplaced reads only); on a mesh;
  unsorted; a directory of per-shard BAMs;
- an odd-length read whose pad nibble is set and a name whose last byte
  is not NUL: the reference's decode drops both bytes and its encode
  writes 0, and so does the gather;
- ``bam.write.shards{route=gathered}`` counts every shard, and
  ``columnar.batch.materializations`` does not move; a host
  ``ReadBatch`` write counts ``route=encoded`` and its bytes are the
  reference's;
- ``gather_records`` against ``encode_records(decode_records(...))`` on
  its own, also without the native library, and on a malformed record.

Tolerance is 0: these are bytes.
"""

import os
import struct

import numpy as np
import pytest

from bam_oracle import (DEFAULT_REFS, encode_record, make_bam_bytes,
                        make_header_bytes, o_bgzf_compress, synth_records)
import disq_tpu.api as R
import disq_tpu_torch as P
from disq_tpu_torch.bam import codec as C
from disq_tpu_torch.runtime import mesh as M
from disq_tpu_torch.runtime import tracing as PT
from disq_tpu_torch.util import shutdown_shared_host_pool

N_RECORDS = 2000


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    yield
    shutdown_shared_host_pool()


def _bam(path, records, blocksize=20000):
    with open(path, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS, records, blocksize=blocksize))
    return str(path)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    return _bam(tmp_path_factory.mktemp("gather") / "in.bam",
                synth_records(N_RECORDS, seed=21, unmapped_tail=7))


def _files(path, exts=(".bai", ".sbi")):
    out = []
    for ext in ("",) + tuple(exts):
        with open(path + ext, "rb") as f:
            out.append(f.read())
    return out


def _ref_write(src, out, shards, *options, sort=True):
    st = R.ReadsStorage.make_default().num_shards(shards)
    st.write(st.read(src), out, *options, sort=sort)
    return out


def _port(shards, workers=1, resident=True):
    st = (P.ReadsStorage.make_default(device="cpu").split_size(30000)
          .num_shards(shards).writer_workers(workers))
    return st.resident_decode() if resident else st


def _routes():
    return PT.REGISTRY.counter("bam.write.shards")


def _port_write(st, src, out, *options, sort=True, route="gathered",
                shards=None):
    """Read ``src`` and write it through ``st``; asserts the shards'
    route and, on the gathered route, that no record was parsed on the
    host during the write."""
    ds = st.read(src)
    if route == "gathered":
        assert ds.reads.device_backed
    mats = PT.REGISTRY.counter("columnar.batch.materializations")
    base_mat = mats.total()
    base = _routes().value(route=route)
    other = _routes().value(route="encoded" if route == "gathered"
                            else "gathered")
    st.write(ds, out, *options, sort=sort)
    if shards is not None:
        assert _routes().value(route=route) - base == shards
    assert _routes().value(route="encoded" if route == "gathered"
                           else "gathered") == other
    if route == "gathered":
        assert mats.total() == base_mat
    return out


@pytest.fixture(scope="module")
def ref_sorted(src, tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_sorted")
    return {n: _ref_write(src, str(d / f"ref{n}.bam"), n,
                          R.BaiWriteOption.ENABLE, R.SbiWriteOption.ENABLE)
            for n in (1, 3, 8)}


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("shards", [1, 3, 8])
def test_sorted_write_equals_reference(src, ref_sorted, tmp_path, shards,
                                       workers):
    out = _port_write(_port(shards, workers), src, str(tmp_path / "o.bam"),
                      P.BaiWriteOption.ENABLE, P.SbiWriteOption.ENABLE,
                      shards=shards)
    assert _files(out) == _files(ref_sorted[shards])


def test_more_shards_than_records(tmp_path):
    small = _bam(tmp_path / "small.bam",
                 synth_records(5, seed=4, unmapped_tail=1))
    ref = _ref_write(small, str(tmp_path / "ref.bam"), 8,
                     R.BaiWriteOption.ENABLE, R.SbiWriteOption.ENABLE)
    # the sink writes one shard per record when it has fewer records
    # than shards (``util.shard_bounds``)
    out = _port_write(_port(8, 4), small, str(tmp_path / "o.bam"),
                      P.BaiWriteOption.ENABLE, P.SbiWriteOption.ENABLE,
                      shards=6)
    assert _files(out) == _files(ref)


def test_unmapped_tail(tmp_path):
    # a third of the reads unplaced: the last shard holds nothing else
    tail = _bam(tmp_path / "tail.bam",
                synth_records(600, seed=8, unmapped_tail=200))
    ref = _ref_write(tail, str(tmp_path / "ref.bam"), 4,
                     R.BaiWriteOption.ENABLE, R.SbiWriteOption.ENABLE)
    out = _port_write(_port(4, 2), tail, str(tmp_path / "o.bam"),
                      P.BaiWriteOption.ENABLE, P.SbiWriteOption.ENABLE,
                      shards=4)
    assert _files(out) == _files(ref)


def test_mesh_route(src, ref_sorted, tmp_path, monkeypatch):
    monkeypatch.delenv("DISQ_TPU_TORCH_MESH", raising=False)
    monkeypatch.setenv(M.FORCE_ENV, "4")
    try:
        st = _port(3, 4).mesh(4)
        ds = st.read(src)
        assert ds.reads.mesh is not None
        base = _routes().value(route="gathered")
        out = str(tmp_path / "o.bam")
        st.write(ds, out, P.BaiWriteOption.ENABLE, P.SbiWriteOption.ENABLE,
                 sort=True)
        assert _routes().value(route="gathered") - base == 3
        assert _files(out) == _files(ref_sorted[3])
    finally:
        M.reset_mesh()


def test_unsorted_write(src, tmp_path):
    ref = _ref_write(src, str(tmp_path / "ref.bam"), 3,
                     R.SbiWriteOption.ENABLE, sort=False)
    out = _port_write(_port(3, 2), src, str(tmp_path / "o.bam"),
                      P.SbiWriteOption.ENABLE, sort=False, shards=3)
    assert _files(out, (".sbi",)) == _files(ref, (".sbi",))


def test_directory_of_parts(src, tmp_path):
    ref = _ref_write(src, str(tmp_path / "ref"), 3,
                     R.FileCardinalityWriteOption.MULTIPLE,
                     R.ReadsFormatWriteOption.BAM)
    out = _port_write(_port(3, 2), src, str(tmp_path / "o"),
                      P.FileCardinalityWriteOption.MULTIPLE,
                      P.ReadsFormatWriteOption.BAM, shards=3)
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(out)) and len(names) == 3
    for name in names:
        assert _files(os.path.join(out, name), ()) == \
            _files(os.path.join(ref, name), ())


def _odd_bytes_bam(path, n=300, seed=31):
    """Oracle records, every odd-length read's pad nibble set and every
    fifth read name's NUL replaced: bytes a decode drops."""
    recs = synth_records(n, seed=seed, unmapped_tail=3)
    rng = np.random.default_rng(seed)
    raw = bytearray()
    odd = 0
    for i, r in enumerate(recs):
        rec = bytearray(encode_record(r))
        l_name, n_cig, l_seq = rec[12], struct.unpack_from("<H", rec, 16)[0], \
            struct.unpack_from("<i", rec, 20)[0]
        if l_seq % 2:
            pad = 36 + l_name + 4 * n_cig + (l_seq - 1) // 2
            rec[pad] |= int(rng.integers(1, 16))
            odd += 1
        if i % 5 == 0:
            rec[36 + l_name - 1] = ord("x")
        raw += rec
    assert odd > 50
    with open(path, "wb") as f:
        f.write(o_bgzf_compress(
            make_header_bytes(DEFAULT_REFS) + bytes(raw), 20000))
    return str(path)


def test_set_pad_nibbles_and_names_are_written_as_the_reference_does(
        tmp_path):
    bam = _odd_bytes_bam(tmp_path / "odd.bam")
    ref = _ref_write(bam, str(tmp_path / "ref.bam"), 3,
                     R.BaiWriteOption.ENABLE, R.SbiWriteOption.ENABLE)
    out = _port_write(_port(3, 2), bam, str(tmp_path / "o.bam"),
                      P.BaiWriteOption.ENABLE, P.SbiWriteOption.ENABLE,
                      shards=3)
    assert _files(out) == _files(ref)


def test_host_batch_keeps_the_encoded_route(src, ref_sorted, tmp_path):
    out = _port_write(_port(3, 4, resident=False), src,
                      str(tmp_path / "o.bam"), P.BaiWriteOption.ENABLE,
                      P.SbiWriteOption.ENABLE, route="encoded", shards=3)
    assert _files(out) == _files(ref_sorted[3])


# -- the gather on its own --------------------------------------------------


def _blob(tmp_path):
    """The decoded records of ``_odd_bytes_bam``: (blob, offsets)."""
    import gzip

    raw = gzip.decompress(open(_odd_bytes_bam(tmp_path / "x.bam"),
                               "rb").read())
    head = len(make_header_bytes(DEFAULT_REFS))
    blob = np.frombuffer(raw[head:], dtype=np.uint8)
    return blob, C.scan_record_offsets(blob)


@pytest.mark.parametrize("native", [True, False])
def test_gather_equals_decode_take_encode(tmp_path, monkeypatch, native):
    if not native:
        import disq_tpu_torch.native as N

        def unavailable(*a, **k):
            raise ImportError("no native library")

        monkeypatch.setattr(N, "fixed_columns_native", unavailable)
    blob, offs = _blob(tmp_path)
    n = len(offs) - 1
    order = np.random.default_rng(5).permutation(n)
    rb = C.decode_records(blob, offs).take(order)
    for lo, hi in ((0, n), (7, 151), (40, 40), (n - 1, n)):
        got = C.gather_records(blob, offs, order, lo, hi)
        want, want_off = C.encode_records_with_offsets(rb.slice(lo, hi))
        assert got.data.tobytes() == want
        assert np.array_equal(got.offsets, want_off)
        part = rb.slice(lo, hi)
        for col in ("refid", "pos", "flag"):
            assert np.array_equal(getattr(got, col), getattr(part, col))
        assert np.array_equal(got.alignment_ends(), part.alignment_ends())
    ident = C.gather_records(blob, offs, None, 3, 90)
    assert ident.data.tobytes() == C.encode_records(
        C.decode_records(blob, offs).slice(3, 90))


@pytest.mark.parametrize("native", [True, False])
def test_gather_rejects_what_decode_rejects(monkeypatch, native):
    if not native:
        import disq_tpu_torch.native as N

        def unavailable(*a, **k):
            raise ImportError("no native library")

        monkeypatch.setattr(N, "fixed_columns_native", unavailable)
        monkeypatch.setattr(N, "decode_records_native", unavailable)
    recs = synth_records(4, seed=2)
    rec = bytearray(encode_record(recs[1]))
    rec[12] = 0                                   # l_read_name 0
    blob = np.frombuffer(encode_record(recs[0]) + bytes(rec), np.uint8)
    offs = C.scan_record_offsets(blob)
    if native:
        with pytest.raises(ValueError):
            C.decode_records(blob, offs)
    with pytest.raises(ValueError, match="record 1"):
        C.gather_records(blob, offs, np.array([0, 1]), 0, 2)
