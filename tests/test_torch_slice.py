"""The port's main path on the CPU against the JAX package.

The same BAM bytes, made from a seed with the BAM oracle, are read, counted,
flagstat-ed, coordinate-sorted and written with a BAI by ``disq_tpu`` and by
``disq_tpu_torch`` with ``device="cpu"``:

- the host path at a few thousand records, split sizes 1000 and 64K, with
  and without an ``.sbi`` beside the BAM;
- the device route at a tiny size: the reference's resident decode with its
  SIMD inflate kernel (interpret mode) against the port's device route
  through its kernels' plain versions.

Counts, flagstat dicts, every column with its dtype, the sort permutation
and the written sorted BAM and BAI bytes must be identical, with the write
shard count pinned on both sides.
"""

import copy
import shutil

import numpy as np
import pytest

from bam_oracle import DEFAULT_REFS, make_bam_bytes, parse_bam, synth_records
import disq_tpu.api as R
from disq_tpu.runtime.errors import CorruptBlockError as RefCorruptBlockError
from disq_tpu.sort.coordinate import coordinate_keys as ref_coordinate_keys
import disq_tpu_torch as P
from disq_tpu_torch import interop
from disq_tpu_torch.ops import inflate_simd as B1
from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime.columnar import ColumnarBatch
from disq_tpu_torch.runtime.errors import CorruptBlockError
from disq_tpu_torch.util import shutdown_shared_host_pool

FIXED = ("refid", "pos", "mapq", "bin", "flag", "next_refid", "next_pos",
         "tlen")
RAGGED = ("name_offsets", "names", "cigar_offsets", "cigars", "seq_offsets",
          "seqs", "quals", "tag_offsets", "tags")

_FLAGS = (0x1 | 0x2 | 0x20 | 0x40, 0x1 | 0x2 | 0x10 | 0x80, 0x1 | 0x8 | 0x40,
          0x1 | 0x4 | 0x80, 0x0, 0x10)


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    """Leave no idle pool threads behind for later tests in the process
    (the port's host pool, and the reference's, which its reads start)."""
    yield
    shutdown_shared_host_pool()
    from disq_tpu import util as ref_util

    with ref_util._HOST_POOL_LOCK:
        pool, ref_util._HOST_POOL = ref_util._HOST_POOL, None
    if pool is not None:
        pool.shutdown(wait=True)


def _records(n, seed, tail):
    """Oracle records in unsorted order, with paired/unmapped/duplicate/
    secondary/QC flags, an unmapped tail and duplicate coordinate keys."""
    rng = np.random.default_rng(seed)
    recs = synth_records(n, seed=seed, unmapped_tail=tail)
    for r in recs[:n]:
        r.flag = (int(rng.choice(_FLAGS)) | 0x400 * int(rng.random() < 0.05)
                  | 0x100 * int(rng.random() < 0.02)
                  | 0x200 * int(rng.random() < 0.01)
                  | 0x800 * int(rng.random() < 0.01))
    for j in range(0, n, max(1, n // 25)):
        dup = copy.deepcopy(recs[j])
        dup.name += "_dup"
        recs.append(dup)
    return [recs[i] for i in rng.permutation(len(recs))]


@pytest.fixture(scope="module")
def host_bam(tmp_path_factory):
    """A few thousand records, 60000-byte BGZF blocks; ``with_sbi`` holds
    the same records as written by the reference with an ``.sbi``."""
    d = tmp_path_factory.mktemp("slice")
    recs = _records(3000, seed=5, tail=25)
    plain = d / "plain.bam"
    plain.write_bytes(make_bam_bytes(DEFAULT_REFS, recs))
    ds = R.ReadsStorage.make_default().read(str(plain))
    with_sbi = d / "with_sbi.bam"
    R.ReadsStorage.make_default().num_shards(3).write(
        ds, str(with_sbi), R.SbiWriteOption.ENABLE)
    assert (d / "with_sbi.bam.sbi").exists()
    return {"plain": str(plain), "with_sbi": str(with_sbi), "n": len(recs)}


@pytest.fixture(scope="module")
def tiny_bam(tmp_path_factory):
    """About 120 records in 320-byte blocks: small enough for the
    reference's interpret-mode inflate kernel."""
    d = tmp_path_factory.mktemp("tiny")
    path = d / "tiny.bam"
    path.write_bytes(make_bam_bytes(DEFAULT_REFS, _records(110, seed=9, tail=6),
                                    blocksize=320))
    return str(path)


def _port_storage():
    return P.ReadsStorage.make_default(device="cpu")


def _assert_same_reads(got, want):
    for f in FIXED + RAGGED:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


def _ref_permutation(reads):
    if hasattr(reads, "sort_permutation"):
        return np.asarray(reads.sort_permutation())
    return np.argsort(ref_coordinate_keys(reads.refid, reads.pos),
                      kind="stable")


def _port_permutation(reads):
    if isinstance(reads, ColumnarBatch):
        return reads.sort_permutation()
    from disq_tpu_torch.sort.coordinate import coordinate_keys

    return np.argsort(coordinate_keys(reads.refid, reads.pos), kind="stable")


def _assert_same_writes(ref_ds, port_ds, tmp_path, num_shards):
    ref_out, port_out = tmp_path / "ref.bam", tmp_path / "port.bam"
    R.ReadsStorage.make_default().num_shards(num_shards).write(
        ref_ds, str(ref_out), R.BaiWriteOption.ENABLE, sort=True)
    _port_storage().num_shards(num_shards).write(
        port_ds, str(port_out), P.BaiWriteOption.ENABLE, sort=True)
    assert port_out.read_bytes() == ref_out.read_bytes()
    assert (tmp_path / "port.bam.bai").read_bytes() == \
        (tmp_path / "ref.bam.bai").read_bytes()
    return port_out


# -- the host path ------------------------------------------------------------


@pytest.mark.parametrize("which", ["plain", "with_sbi"])
@pytest.mark.parametrize("split_size", [1000, 64 << 10])
def test_host_read_equals_reference(host_bam, which, split_size):
    path = host_bam[which]
    ref = R.ReadsStorage.make_default().split_size(split_size).read(path)
    got = _port_storage().split_size(split_size).read(path)
    assert got.count() == ref.count() == host_bam["n"]
    assert got.flagstat() == ref.flagstat()
    _assert_same_reads(got.reads, ref.reads)
    np.testing.assert_array_equal(_port_permutation(got.reads),
                                  _ref_permutation(ref.reads))
    assert got.header.to_bam_bytes() == ref.header.to_bam_bytes()


def test_sbi_and_guesser_boundaries_agree(host_bam, tmp_path):
    """The SBI fast path and the guesser chain cut the same records."""
    bare = tmp_path / "bare.bam"
    shutil.copy(host_bam["with_sbi"], bare)
    a = _port_storage().split_size(1000).read(host_bam["with_sbi"])
    b = _port_storage().split_size(1000).read(str(bare))
    _assert_same_reads(a.reads, b.reads)


@pytest.mark.parametrize("num_shards", [1, 4])
def test_host_sorted_write_equals_reference(host_bam, tmp_path, num_shards):
    path = host_bam["plain"]
    ref = R.ReadsStorage.make_default().split_size(64 << 10).read(path)
    got = _port_storage().split_size(64 << 10).read(path)
    out = _assert_same_writes(ref, got, tmp_path, num_shards)
    text, _, recs = parse_bam(out.read_bytes())
    assert "SO:coordinate" in text and len(recs) == host_bam["n"]


def test_port_rereads_its_sorted_write(host_bam, tmp_path):
    src = _port_storage().read(host_bam["plain"])
    out = str(tmp_path / "sorted.bam")
    _port_storage().num_shards(2).write(src, out, P.BaiWriteOption.ENABLE,
                                        sort=True)
    back = _port_storage().split_size(1000).read(out)
    assert back.header.sort_order == "coordinate"
    _assert_same_reads(back.reads, src.coordinate_sorted().reads)


@pytest.mark.parametrize("num_shards", [1, 4])
def test_interop_state_writes_like_reference(host_bam, tmp_path, num_shards):
    """Decoded state carried over from the reference (numpy columns, the
    header text and refs) sorts and writes to the reference's bytes."""
    ref = R.ReadsStorage.make_default().read(host_bam["plain"])
    port_ds = interop.dataset_from_state(
        ref.header.text, [(s.name, s.length) for s in ref.header.sequences],
        interop.columns_of(ref.reads))
    _assert_same_writes(ref, port_ds, tmp_path, num_shards)


# -- the device route (plain versions on the CPU) -----------------------------


@pytest.fixture(scope="module")
def resident_pair(tiny_bam):
    mp = pytest.MonkeyPatch()
    mp.setenv("DISQ_TPU_DEVICE_INFLATE", "1")
    try:
        ref = (R.ReadsStorage.make_default().split_size(16000)
               .resident_decode().read(tiny_bam))
    finally:
        mp.undo()
    counters.reset()
    before = dict(B1.last_stats)
    got = _port_storage().split_size(16000).resident_decode().read(tiny_bam)
    stats = {k: B1.last_stats[k] - before[k] for k in before}
    return ref, got, stats, counters.snapshot()


def test_resident_read_equals_reference(resident_pair):
    ref, got, stats, snap = resident_pair
    assert type(ref.reads).__name__ == "ColumnarBatch"
    assert isinstance(got.reads, ColumnarBatch) and got.reads.device_backed
    assert got.reads.device.type == "cpu"
    assert got.count() == ref.count()
    assert got.flagstat() == ref.flagstat()
    _assert_same_reads(got.reads, ref.reads)
    np.testing.assert_array_equal(got.reads.sort_permutation(),
                                  _ref_permutation(ref.reads))
    # every block went through the inflate kernel's plain version, and
    # the plain versions book no kernel launch
    assert stats["device_lanes"] > 1 and stats["host_big"] == 0
    assert stats["host_fallback"] == 0
    assert snap["launches"] == {} and snap["host_fallback_blocks"] == {}


def test_resident_columns_are_int32_tensors(resident_pair):
    _, got, _, _ = resident_pair
    cols = got.reads.device_columns()
    assert set(cols) == set(FIXED)
    assert all(c.dtype.itemsize == 4 and c.numel() == got.count()
               for c in cols.values())


@pytest.mark.parametrize("num_shards", [1, 4])
def test_resident_sorted_write_equals_reference(resident_pair, tmp_path,
                                                num_shards):
    ref, got, _, _ = resident_pair
    _assert_same_writes(ref, got, tmp_path, num_shards)


def test_resident_and_host_routes_agree(host_bam):
    """The port's two routes over full 60000-byte blocks."""
    a = _port_storage().split_size(64 << 10).read(host_bam["plain"])
    b = (_port_storage().split_size(64 << 10).resident_decode()
         .read(host_bam["plain"]))
    assert b.reads.device_backed
    _assert_same_reads(b.reads, a.reads)
    assert b.flagstat() == a.flagstat()


# -- corrupt input (strict policy) --------------------------------------------


@pytest.mark.parametrize("where", ["payload", "crc"])
@pytest.mark.parametrize("resident", [False, True])
def test_corrupt_block_raises_like_reference(tiny_bam, tmp_path, where,
                                             resident):
    data = bytearray(open(tiny_bam, "rb").read())
    # the fourth block: past the header, inside the records
    pos = 0
    for _ in range(3):
        pos += int.from_bytes(data[pos + 16: pos + 18], "little") + 1
    size = int.from_bytes(data[pos + 16: pos + 18], "little") + 1
    data[pos + (size - 8 if where == "crc" else 20)] ^= 0x5A
    bad = tmp_path / "bad.bam"
    bad.write_bytes(bytes(data))
    with pytest.raises(RefCorruptBlockError, match=f"block_offset={pos}"):
        R.ReadsStorage.make_default().split_size(16000).read(str(bad))
    storage = _port_storage().split_size(16000).resident_decode(resident)
    with pytest.raises(CorruptBlockError, match=f"block_offset={pos}"):
        storage.read(str(bad))


@pytest.mark.parametrize("resident", [False, True])
def test_corrupt_record_raises_like_reference(tmp_path, resident):
    """A record with an impossible refID: the device route's record
    check flags it and the read raises, as the host parser and the
    reference do; no route serves a host batch instead."""
    recs = _records(110, seed=9, tail=6)
    recs[40].refid = len(DEFAULT_REFS) + 3
    bad = tmp_path / "bad_record.bam"
    bad.write_bytes(make_bam_bytes(DEFAULT_REFS, recs, blocksize=320))
    with pytest.raises(RefCorruptBlockError, match="record run"):
        R.ReadsStorage.make_default().split_size(16000).read(str(bad))
    storage = _port_storage().split_size(16000).resident_decode(resident)
    with pytest.raises(CorruptBlockError, match="record run"):
        storage.read(str(bad))


def test_record_check_disagreeing_with_host_parser_raises(tiny_bam,
                                                          monkeypatch):
    """When the device record check flags a shard that the host parser
    accepts, the read raises rather than serving the host parse."""
    from disq_tpu_torch.runtime import columnar

    monkeypatch.setattr(columnar, "record_check", lambda *a: True)
    storage = _port_storage().split_size(16000).resident_decode()
    with pytest.raises(CorruptBlockError, match="host parser accepts"):
        storage.read(tiny_bam)


# -- host pieces of the slice ---------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1000, 1 << 20])
def test_bucket_pow2_equals_reference(n):
    from disq_tpu.util import bucket_pow2 as ref_bucket_pow2
    from disq_tpu_torch.util import bucket_pow2

    assert bucket_pow2(n) == ref_bucket_pow2(n)
    assert bucket_pow2(n, lo=8) == ref_bucket_pow2(n, lo=8)


def test_default_shard_count_is_the_cuda_device_count():
    import torch

    from disq_tpu_torch.util import resolve_num_shards

    assert resolve_num_shards(_port_storage()) == \
        max(1, torch.cuda.device_count())
    assert resolve_num_shards(_port_storage().num_shards(3)) == 3


def test_bgzf_writer_equals_reference(tmp_path):
    import io

    from disq_tpu.bgzf.codec import BgzfWriter as RefWriter
    from disq_tpu_torch.bgzf.codec import BgzfReader, BgzfWriter

    payload = np.random.default_rng(2).integers(
        0, 4, 200_000, dtype=np.uint8).tobytes()
    outs, voffs = [], []
    for cls in (RefWriter, BgzfWriter):
        buf = io.BytesIO()
        with cls(buf) as w:
            w.write(payload[:70_000])
            voffs.append(w.tell_virtual())
            w.write(payload[70_000:])
        outs.append(buf.getvalue())
    assert outs[1] == outs[0] and voffs[1] == voffs[0]
    r = BgzfReader(io.BytesIO(outs[1]))
    r.seek_virtual(voffs[1])
    assert r.read() == payload[70_000:]


def test_write_options_by_name():
    assert interop.write_options(["BaiWriteOption.ENABLE",
                                  "ReadsFormatWriteOption.BAM"]) == (
        P.BaiWriteOption.ENABLE, P.ReadsFormatWriteOption.BAM)
    with pytest.raises(KeyError):
        interop.write_options(["NoSuchOption.ENABLE"])


def test_interop_rejects_a_wrong_dtype(host_bam):
    cols = interop.columns_of(_port_storage().read(host_bam["plain"]).reads)
    cols["pos"] = cols["pos"].astype(np.int64)
    with pytest.raises(TypeError, match="pos"):
        interop.read_batch_from_columns(cols)
