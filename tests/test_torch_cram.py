"""The port's CRAM read and write on the CPU against the JAX package.

Fixtures as the reference's own CRAM tests build them: oracle records whose
M-runs come from a numpy-seeded FASTA (a fraction with mismatches and soft
clips) plus unmapped reads, in a coordinate-sorted BAM. Both packages read
that BAM and write CRAM with a CRAI, with the write shard count and the
QS rANS order pinned on both sides: the bytes must be identical. The port
reads the reference's CRAM to the reference's columns on its host route
and, with ``.resident_decode()``, through the rANS kernels' plain versions;
corrupt input raises ``CorruptBlockError`` naming the container.
"""

import os
import struct

import numpy as np
import pytest

from bam_oracle import DEFAULT_REFS, ORecord, make_bam_bytes
import disq_tpu.api as R
from disq_tpu.cram.refsource import write_fasta as ref_write_fasta
from disq_tpu.fsw import PosixFileSystemWrapper
from disq_tpu.runtime.errors import CorruptBlockError as RefCorruptBlockError
import disq_tpu_torch as P
from disq_tpu_torch.cram.codec import read_stored_blocks
from disq_tpu_torch.cram.rans import rans_encode_order0
from disq_tpu_torch.cram.structure import (
    RANS,
    ContainerHeader,
    StoredBlock,
    read_container_header_at,
    walk_container_offsets,
)
from disq_tpu_torch.cram.io import write_itf8
from disq_tpu_torch.fsw.filesystem import PosixFileSystemWrapper as PortFS
from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime.errors import (
    CorruptBlockError,
    MissingReferenceError,
)

FIELDS = ("refid", "pos", "mapq", "bin", "flag", "next_refid", "next_pos",
          "tlen", "name_offsets", "names", "cigar_offsets", "cigars",
          "seq_offsets", "seqs", "quals", "tag_offsets", "tags")
QS_KNOBS = ("DISQ_TPU_CRAM_RANS_O1", "DISQ_TPU_TORCH_CRAM_RANS_O1")


@pytest.fixture(scope="module")
def ref_fasta(tmp_path_factory):
    """A FASTA (+ .fai) matching DEFAULT_REFS contig sizes."""
    d = tmp_path_factory.mktemp("ref")
    rng = np.random.default_rng(99)
    contigs = [
        (name, rng.choice(list(b"ACGT"), size).astype(np.uint8).tobytes())
        for name, size in DEFAULT_REFS
    ]
    path = str(d / "ref.fa")
    ref_write_fasta(PosixFileSystemWrapper(), path, contigs)
    return path, dict(contigs)


def _synth_ref_matched(ref_seqs, n=240, seed=5, mismatch_rate=0.2):
    """Records whose M-run bases come from the reference (so a writer with
    the reference omits them), a fraction carrying mismatches, soft
    clips, deletions and NM tags, then unmapped reads."""
    rng = np.random.default_rng(seed)
    recs = []
    names = [n_ for n_, _ in DEFAULT_REFS]
    for i in range(n):
        ci = int(rng.integers(0, len(names)))
        seq_ref = ref_seqs[names[ci]]
        readlen = int(rng.integers(30, 120))
        pos = int(rng.integers(0, len(seq_ref) - readlen - 20))
        bases = bytearray(seq_ref[pos: pos + readlen])
        cigar = [(readlen, "M")]
        r = rng.random()
        if r < 0.3:
            sc = int(rng.integers(1, 8))
            cigar = [(sc, "S"), (readlen - sc, "M")]
            bases[:sc] = rng.choice(list(b"ACGT"), sc).astype(np.uint8).tobytes()
        elif r < 0.4:
            at, dl = readlen // 2, int(rng.integers(1, 5))
            cigar = [(at, "M"), (dl, "D"), (readlen - at, "M")]
            bases[at:] = seq_ref[pos + at + dl: pos + readlen + dl]
        if rng.random() < mismatch_rate:
            k = int(rng.integers(0, readlen))
            bases[k] = ord("A") if bases[k] != ord("A") else ord("C")
        recs.append(ORecord(
            name=f"cr{i:05d}", refid=ci, pos=pos,
            mapq=int(rng.integers(0, 60)), flag=int(rng.choice([0, 16, 1024])),
            cigar=cigar, seq=bytes(bases).decode(),
            qual=bytes(rng.integers(0, 40, readlen, dtype=np.uint8).tolist()),
            tags=b"NMC\x01" if rng.random() < 0.5 else b""))
    recs.sort(key=lambda r: (r.refid, r.pos))
    for i in range(6):
        recs.append(ORecord(name=f"unm{i}", refid=-1, pos=-1, flag=4,
                            seq="ACGTA", qual=b"\x11" * 5))
    return recs


@pytest.fixture(scope="module")
def bam_input(tmp_path_factory, ref_fasta):
    _, ref_seqs = ref_fasta
    path = str(tmp_path_factory.mktemp("cram") / "in.bam")
    with open(path, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS, _synth_ref_matched(ref_seqs),
                               sort_order="coordinate"))
    return path


def _qs_order(monkeypatch, qs):
    for knob in QS_KNOBS:
        monkeypatch.setenv(knob, "1" if qs == "o1" else "0")


def _ref_storage(ref):
    st = R.ReadsStorage.make_default()
    return st.reference_source_path(ref) if ref else st


def _port_storage(ref=None):
    st = P.ReadsStorage.make_default(device="cpu")
    return st.reference_source_path(ref) if ref else st


def _write_both(bam, out_dir, ref, shards):
    """The same BAM written as CRAM + CRAI by both packages."""
    ref_out, port_out = str(out_dir / "ref.cram"), str(out_dir / "port.cram")
    st = _ref_storage(ref).num_shards(shards)
    st.write(st.read(bam), ref_out, R.CraiWriteOption.ENABLE)
    pst = _port_storage(ref).num_shards(shards)
    pst.write(pst.read(bam), port_out, P.CraiWriteOption.ENABLE)
    return ref_out, port_out


def _assert_same_reads(got, want):
    assert got.count == want.count
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("qs", ["o1", "o0"])
@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("with_ref", [True, False], ids=["ref", "noref"])
def test_cram_and_crai_bytes_identical(bam_input, ref_fasta, tmp_path,
                                       monkeypatch, with_ref, shards, qs):
    _qs_order(monkeypatch, qs)
    ref = ref_fasta[0] if with_ref else None
    ref_out, port_out = _write_both(bam_input, tmp_path, ref, shards)
    assert open(port_out, "rb").read() == open(ref_out, "rb").read()
    assert open(port_out + ".crai", "rb").read() == \
        open(ref_out + ".crai", "rb").read()


def test_core_profile_bytes_identical(bam_input, ref_fasta, tmp_path,
                                      monkeypatch):
    monkeypatch.setenv("DISQ_TPU_CRAM_CORE", "1")
    monkeypatch.setenv("DISQ_TPU_TORCH_CRAM_CORE", "1")
    ref_out, port_out = _write_both(bam_input, tmp_path, ref_fasta[0], 2)
    assert open(port_out, "rb").read() == open(ref_out, "rb").read()
    want = _ref_storage(ref_fasta[0]).read(ref_out).reads
    _assert_same_reads(_port_storage(ref_fasta[0]).read(ref_out).reads, want)


@pytest.fixture(scope="module")
def ref_crams(bam_input, ref_fasta, tmp_path_factory):
    """The reference's CRAMs of the fixture: with the reference at 4 write
    shards, QS order-1 and order-0."""
    d = tmp_path_factory.mktemp("refcram")
    ref = ref_fasta[0]
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for qs in ("o1", "o0"):
            _qs_order(mp, qs)
            st = _ref_storage(ref).num_shards(4)
            out[qs] = str(d / f"{qs}.cram")
            st.write(st.read(bam_input), out[qs], R.CraiWriteOption.ENABLE)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("qs", ["o1", "o0"])
@pytest.mark.parametrize("split_size", [2000, 10**9])
def test_port_reads_reference_cram(ref_crams, ref_fasta, split_size, qs):
    path, ref = ref_crams[qs], ref_fasta[0]
    want = _ref_storage(ref).split_size(split_size).read(path)
    got = _port_storage(ref).split_size(split_size).read(path)
    assert got.header.text == want.header.text
    assert got.count() == want.count()
    assert got.flagstat() == want.flagstat()
    _assert_same_reads(got.reads, want.reads)


@pytest.mark.parametrize("split_size", [2000, 10**9])
def test_resident_decode_equals_host_route(ref_crams, ref_fasta, split_size):
    path, ref = ref_crams["o0"], ref_fasta[0]
    counters.reset()
    host = _port_storage(ref).split_size(split_size).read(path)
    assert counters.snapshot()["host_rans_streams"].get("rans0", 0) > 0
    counters.reset()
    dev = _port_storage(ref).split_size(split_size).resident_decode() \
        .read(path)
    snap = counters.snapshot()
    # every order-0 stream went through the kernels' plain versions
    assert snap["host_rans_streams"] == {} and snap["launches"] == {}
    _assert_same_reads(dev.reads, host.reads)


def test_resident_decode_legacy_route(ref_crams, ref_fasta, monkeypatch):
    from disq_tpu_torch.ops import rans as B5
    from disq_tpu_torch.ops import rans_simd as B3

    path, ref = ref_crams["o0"], ref_fasta[0]
    before = (B3.last_stats["device_lanes"], B5.last_stats["device_lanes"])
    monkeypatch.setenv("DISQ_TPU_TORCH_DEVICE_RANS", "legacy")
    got = _port_storage(ref).resident_decode().read(path)
    assert B3.last_stats["device_lanes"] == before[0]
    assert B5.last_stats["device_lanes"] > before[1]
    _assert_same_reads(got.reads, _ref_storage(ref).read(path).reads)


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_reference_compressed_cram_needs_the_reference(ref_crams, resident):
    st = _port_storage().resident_decode(resident)
    with pytest.raises(MissingReferenceError, match="reference"):
        st.read(ref_crams["o1"])


def _data_container(path, index=1):
    """(offset, header size, payload) of data container ``index``."""
    fs = PortFS()
    off, _hdr = walk_container_offsets(fs, path)[1 + index]
    h, hdr_size = read_container_header_at(fs, path, off,
                                           fs.get_file_length(path))
    return off, hdr_size, fs.read_range(path, off + hdr_size, h.length)


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_flipped_byte_raises_crc_error(ref_crams, ref_fasta, tmp_path,
                                       resident):
    src, ref = ref_crams["o0"], ref_fasta[0]
    off, hdr_size, payload = _data_container(src)
    data = bytearray(open(src, "rb").read())
    data[off + hdr_size + len(payload) // 2] ^= 0x5A
    bad = tmp_path / "flipped.cram"
    bad.write_bytes(bytes(data))
    with pytest.raises(RefCorruptBlockError, match="CRC mismatch"):
        _ref_storage(ref).read(str(bad))
    with pytest.raises(CorruptBlockError, match="CRC mismatch") as got:
        _port_storage(ref).resident_decode(resident).read(str(bad))
    assert got.value.block_offset == off


def _block_bytes(b: StoredBlock) -> bytes:
    import zlib

    body = (bytes([b.method, b.content_type]) + write_itf8(b.content_id)
            + write_itf8(len(b.comp)) + write_itf8(b.raw_size) + b.comp)
    return body + struct.pack("<I", zlib.crc32(body))


def _truncate_qs_stream(src, dst, cut=40):
    """Copy ``src`` with data container 1's order-0 QS stream short of
    ``cut`` renorm bytes (comp_size and every CRC rewritten, so only the
    rANS decode can notice); returns the container's offset."""
    off, hdr_size, payload = _data_container(src)
    fs = PortFS()
    hdr, _ = read_container_header_at(fs, src, off, fs.get_file_length(src))
    blocks = read_stored_blocks(payload)
    qs = max((b for b in blocks if b.method == RANS and b.is_rans0),
             key=lambda b: b.raw_size)
    comp_size = struct.unpack_from("<I", qs.comp, 1)[0] - cut
    qs.comp = qs.comp[:1] + struct.pack("<I", comp_size) + \
        qs.comp[5: 9 + comp_size]
    new_payload = b"".join(_block_bytes(b) for b in blocks)
    hdr.length = len(new_payload)
    data = open(src, "rb").read()
    rest = off + hdr_size + len(payload)
    with open(dst, "wb") as f:
        f.write(data[:off] + hdr.to_bytes() + new_payload + data[rest:])
    return off


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_truncated_rans_stream_raises(ref_crams, ref_fasta, tmp_path,
                                      resident):
    ref = ref_fasta[0]
    bad = str(tmp_path / "short_qs.cram")
    off = _truncate_qs_stream(ref_crams["o0"], bad)
    with pytest.raises(RefCorruptBlockError, match="corrupt CRAM container"):
        _ref_storage(ref).read(bad)
    msg = "overran stream" if resident else "rANS decode failed"
    with pytest.raises(CorruptBlockError, match=msg) as got:
        _port_storage(ref).resident_decode(resident).read(bad)
    assert got.value.block_offset == off


@pytest.mark.parametrize("qs", ["o1", "o0"])
def test_cram_to_bam_round_trip_equals_reference(ref_crams, ref_fasta,
                                                 tmp_path, qs):
    path, ref = ref_crams[qs], ref_fasta[0]
    ref_out, port_out = str(tmp_path / "ref.bam"), str(tmp_path / "port.bam")
    st = _ref_storage(ref).num_shards(2)
    st.write(st.read(path), ref_out, R.BaiWriteOption.ENABLE, sort=True)
    pst = _port_storage(ref).num_shards(2).resident_decode(qs == "o0")
    pst.write(pst.read(path), port_out, P.BaiWriteOption.ENABLE, sort=True)
    assert open(port_out, "rb").read() == open(ref_out, "rb").read()
    assert open(port_out + ".bai", "rb").read() == \
        open(ref_out + ".bai", "rb").read()
    assert os.path.getsize(port_out) > 0
