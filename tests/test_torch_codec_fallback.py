"""The port's numpy / zlib host paths with its native library made
unavailable, the counterpart of ``tests/test_codec_fallback.py``: every
host helper that ``disq_tpu_torch/native`` serves (record decode and
encode, the offset scan, the segment gather, BGZF deflate, inflate and
the block walk, rANS) falls back to its numpy / zlib path, and that
path is byte-identical to the native one (and to the reference)."""

import sys

import numpy as np
import pytest

from bam_oracle import DEFAULT_REFS, encode_record, make_bam_bytes, \
    synth_records
import disq_tpu.api as R

FIELDS = ("refid", "pos", "mapq", "bin", "flag", "next_refid", "next_pos",
          "tlen", "name_offsets", "names", "cigar_offsets", "cigars",
          "seq_offsets", "seqs", "quals", "tag_offsets", "tags")


def _native_available() -> bool:
    try:
        from disq_tpu_torch.native import decode_records_native  # noqa: F401
    except ImportError:
        return False
    return True


@pytest.fixture()
def no_native(monkeypatch):
    """Block the native import so every ``try``/``ImportError`` takes
    the numpy / zlib path."""
    monkeypatch.setitem(sys.modules, "disq_tpu_torch.native", None)


def _same_batch(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


def test_native_blocked_raises_import_error(no_native):
    with pytest.raises(ImportError):
        from disq_tpu_torch.native import decode_records_native  # noqa: F401


def test_decode_encode_roundtrip_without_native(no_native):
    from disq_tpu_torch.bam.codec import (decode_records, encode_records,
                                          scan_record_offsets)

    blob = b"".join(encode_record(r) for r in synth_records(
        200, seed=4, unmapped_tail=3))
    arr = np.frombuffer(blob, np.uint8)
    batch = decode_records(arr, scan_record_offsets(arr),
                           n_ref=len(DEFAULT_REFS))
    assert encode_records(batch) == blob


def test_host_paths_equal_native(monkeypatch):
    """Each helper, native then blocked: equal outputs."""
    if not _native_available():
        pytest.skip("the native host library does not build here, so "
                    "this would compare the fallback to itself")
    from disq_tpu_torch.bam.codec import (decode_records, encode_records,
                                          scan_record_offsets)
    from disq_tpu_torch.bam.columnar import segment_gather
    from disq_tpu_torch.bgzf.codec import compress_to_bgzf, inflate_blocks
    from disq_tpu_torch.cram.rans import (rans_decode, rans_encode_order0,
                                          rans_encode_order1)

    blob = np.frombuffer(b"".join(encode_record(r) for r in synth_records(
        150, seed=5)), np.uint8)
    payload = b"the same bytes either way" * 9000
    rng = np.random.default_rng(6)
    text = rng.integers(60, 70, 20_000, dtype=np.uint8).tobytes()

    def run():
        offsets = scan_record_offsets(blob)
        batch = decode_records(blob, offsets)
        order = np.arange(batch.count)[::-1].copy()
        bgzf = compress_to_bgzf(payload)
        from disq_tpu_torch.bgzf.guesser import find_block_table
        from disq_tpu_torch.fsw.filesystem import MemoryFileSystemWrapper

        fs = MemoryFileSystemWrapper()
        fs.write_all("/x.bgz", bgzf)
        blocks = find_block_table(fs, "/x.bgz")
        enc0, enc1 = rans_encode_order0(text), rans_encode_order1(text)
        return {
            "offsets": offsets, "batch": batch,
            "encoded": encode_records(batch),
            "gather": segment_gather(blob, offsets, order),
            "bgzf": bgzf, "blocks": [(b.pos, b.csize, b.usize)
                                     for b in blocks],
            "inflated": inflate_blocks(bgzf, blocks).tobytes(),
            "rans": (enc0, enc1, rans_decode(enc0), rans_decode(enc1)),
        }

    native = run()
    monkeypatch.setitem(sys.modules, "disq_tpu_torch.native", None)
    host = run()
    np.testing.assert_array_equal(native["offsets"], host["offsets"])
    _same_batch(native["batch"], host["batch"])
    for key in ("encoded", "bgzf", "blocks", "inflated", "rans"):
        assert native[key] == host[key], key
    for a, b in zip(native["gather"], host["gather"]):
        np.testing.assert_array_equal(a, b)
    assert host["inflated"] == payload and host["rans"][2] == text


def test_end_to_end_read_and_write_without_native(no_native, tmp_path):
    """A read and a sorted write with BAI, all on the host paths, equal
    the reference's byte for byte."""
    import disq_tpu_torch as P

    recs = synth_records(100, seed=6, sorted_coord=False)
    p = str(tmp_path / "f.bam")
    with open(p, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS, recs, blocksize=700))
    st = P.ReadsStorage.make_default(device="cpu").split_size(2000) \
        .num_shards(2)
    ds = st.read(p)
    assert ds.count() == 100
    ref = R.ReadsStorage.make_default().split_size(2000).num_shards(2)
    _same_batch(ds.reads, ref.read(p).reads)
    st.write(ds, str(tmp_path / "port.bam"), P.BaiWriteOption.ENABLE,
             sort=True)
    ref.write(ref.read(p), str(tmp_path / "ref.bam"),
              R.BaiWriteOption.ENABLE, sort=True)
    for ext in (".bam", ".bam.bai"):
        assert (tmp_path / f"port{ext}").read_bytes() == \
            (tmp_path / f"ref{ext}").read_bytes()
