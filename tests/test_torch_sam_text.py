"""The port's text SAM codec, read and write against the reference's, on
the CPU: the cases of ``tests/test_sam_text.py`` and
``tests/test_write_pipeline.py::test_sam_single``, each run through both
``disq_tpu`` and ``disq_tpu_torch`` (``device="cpu"``) on the same input
with equal columns and byte-identical files (``num_shards`` pinned on
both sides); and BAM → SAM → BAM from a port BAM read, host and
resident (a device-backed ``ColumnarBatch``), whose SAM text equals the
reference's for the same records."""

import os

import numpy as np
import pytest

import disq_tpu as R
from bam_oracle import DEFAULT_REFS, encode_record, make_bam_bytes, synth_records
from disq_tpu.bam.codec import decode_records as ref_decode
from disq_tpu.bam.header import SamHeader as RHeader
from disq_tpu.sam import text as rtext

import disq_tpu_torch as P
from disq_tpu_torch import interop
from disq_tpu_torch.bam.codec import decode_records
from disq_tpu_torch.bam.header import SamHeader
from disq_tpu_torch.runtime.columnar import ColumnarBatch
from disq_tpu_torch.sam import text

COLUMNS = tuple(interop.columns_of(decode_records(np.zeros(0, np.uint8))))


def same_reads(got, want):
    g, w = interop.columns_of(got), interop.columns_of(want)
    for name in COLUMNS:
        assert g[name].dtype == w[name].dtype, name
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def _batch(n, seed, **kw):
    blob = b"".join(encode_record(r) for r in synth_records(n, seed=seed, **kw))
    return decode_records(np.frombuffer(blob, np.uint8)), ref_decode(blob)


def _ref_st():
    return R.ReadsStorage.make_default()


def _port_st():
    return P.ReadsStorage.make_default(device="cpu")


def _both_read(path, split_size=None):
    ref, port = _ref_st(), _port_st()
    if split_size:
        ref, port = ref.split_size(split_size), port.split_size(split_size)
    want, got = ref.read(path), port.read(path)
    same_reads(got.reads, want.reads)
    assert got.header.text == want.header.text
    return want, got


class TestTagCodec:
    @pytest.mark.parametrize(
        "tag",
        ["NM:i:5", "XX:A:Q", "XF:f:3.25", "RG:Z:sample1", "XH:H:1AFF",
         "XB:B:c,1,-2,3", "XI:B:I,100000,2", "XF:B:f,1.5,-2.25", "XE:B:c"],
    )
    def test_text_round_trip(self, tag):
        binary = text.text_to_tags([tag])
        assert binary == rtext.text_to_tags([tag])
        assert text.tags_to_text(binary) == [tag]

    def test_binary_small_ints_canonicalize(self):
        import struct

        raw = b"XAc" + struct.pack("<b", -5) + b"XBS" + struct.pack("<H", 40000)
        assert text.tags_to_text(raw) == rtext.tags_to_text(raw) == \
            ["XA:i:-5", "XB:i:40000"]

    def test_cigar(self):
        for s in ("*", "5M", "3S10M2I1D"):
            assert text.parse_cigar(s) == rtext.parse_cigar(s)
        assert text.parse_cigar("3S10M2I1D") == [
            (3 << 4) | 4, (10 << 4), (2 << 4) | 1, (1 << 4) | 2]
        with pytest.raises(ValueError):
            text.parse_cigar("xyz")


class TestLineRoundTrip:
    def test_batch_to_lines_to_batch(self):
        header, rheader = SamHeader.build(DEFAULT_REFS), RHeader.build(DEFAULT_REFS)
        batch, rbatch = _batch(100, 8, unmapped_tail=4)
        lines = text.batch_to_sam_lines(batch, header)
        assert lines == rtext.batch_to_sam_lines(rbatch, rheader)
        back = text.sam_lines_to_batch(lines, header)
        same_reads(back, rtext.sam_lines_to_batch(lines, rheader))
        for col in ("refid", "pos", "flag", "cigars", "seqs"):
            np.testing.assert_array_equal(getattr(back, col),
                                          getattr(batch, col))
        for i in (0, 1, 2, 50, 99):
            assert back.name(i) == batch.name(i)

    def test_mate_equals_shorthand(self):
        line = ["r1\t99\tchr1\t100\t60\t4M\t=\t200\t104\tACGT\tIIII"]
        b = text.sam_lines_to_batch(line, SamHeader.build(DEFAULT_REFS))
        same_reads(b, rtext.sam_lines_to_batch(line,
                                               RHeader.build(DEFAULT_REFS)))
        assert b.next_refid[0] == 0 and b.next_pos[0] == 199


@pytest.fixture(scope="module")
def sam_file(tmp_path_factory):
    header = SamHeader.build(DEFAULT_REFS)
    records = synth_records(300, seed=12, unmapped_tail=6)
    batch = decode_records(np.frombuffer(
        b"".join(encode_record(r) for r in records), np.uint8))
    path = str(tmp_path_factory.mktemp("sam") / "in.sam")
    with open(path, "w") as f:
        f.write(header.text)
        f.write("".join(ln + "\n" for ln in
                        text.batch_to_sam_lines(batch, header)))
    return path, records


class TestSamEndToEnd:
    @pytest.mark.parametrize("split_size", [501, 4096, 10**9])
    def test_split_invariance(self, sam_file, split_size):
        path, records = sam_file
        _, ds = _both_read(path, split_size)
        assert ds.count() == len(records)
        np.testing.assert_array_equal(ds.reads.pos, [r.pos for r in records])
        assert ds.header.sequences[0].name == "chr1"

    @pytest.mark.parametrize("workers", [1, 4])
    def test_sam_write_single(self, sam_file, tmp_path, workers):
        path, records = sam_file
        want, ds = _both_read(path)
        _ref_st().num_shards(3).write(want, str(tmp_path / "r.sam"))
        out = str(tmp_path / "out.sam")
        _port_st().num_shards(3).writer_workers(workers).write(ds, out)
        with open(out) as f:
            content = f.read()
        assert content == open(tmp_path / "r.sam").read()
        assert content.startswith("@HD")
        body = [ln for ln in content.splitlines() if not ln.startswith("@")]
        assert len(body) == len(records)
        _, ds2 = _both_read(out)
        np.testing.assert_array_equal(ds2.reads.pos, ds.reads.pos)

    def test_sam_write_multiple(self, sam_file, tmp_path):
        path, records = sam_file
        want, ds = _both_read(path)
        _ref_st().num_shards(3).write(
            want, str(tmp_path / "r"), R.FileCardinalityWriteOption.MULTIPLE,
            R.ReadsFormatWriteOption.SAM)
        out = str(tmp_path / "outdir")
        _port_st().num_shards(3).write(ds, out,
                                       P.FileCardinalityWriteOption.MULTIPLE,
                                       P.ReadsFormatWriteOption.SAM)
        parts = sorted(os.listdir(out))
        assert parts == sorted(os.listdir(tmp_path / "r"))
        assert len(parts) == 3 and all(p.endswith(".sam") for p in parts)
        total = 0
        for p in parts:
            assert open(os.path.join(out, p)).read() == \
                open(tmp_path / "r" / p).read()
            total += _both_read(os.path.join(out, p))[1].count()
        assert total == len(records)

    def test_traversal_raises(self, sam_file):
        tp = P.TraversalParameters([P.Interval("chr1", 1, 100)])
        with pytest.raises(ValueError, match="indexed format"):
            _port_st().read(sam_file[0], traversal=tp)

    @pytest.mark.parametrize("route", ["host", "resident"])
    def test_bam_to_sam_to_bam_identity(self, tmp_path, route):
        """BAM → SAM → BAM preserves every record, from a port BAM read
        on the host route and on the device route (a device-backed
        batch, whose slices are host batches); the SAM text and the
        final BAM equal the reference's."""
        bam_in = str(tmp_path / "x.bam")
        with open(bam_in, "wb") as f:
            f.write(make_bam_bytes(DEFAULT_REFS, synth_records(80, seed=13)))
        st = _port_st().num_shards(2)
        if route == "resident":
            st = st.resident_decode()
        ds = st.read(bam_in)
        assert isinstance(ds.reads, ColumnarBatch) == (route == "resident")
        ref = R.ReadsStorage.make_default().num_shards(2)
        want = ref.read(bam_in)
        sam_mid = str(tmp_path / "x.sam")
        st.write(ds, sam_mid)
        ref.write(want, str(tmp_path / "r.sam"))
        assert open(sam_mid).read() == open(tmp_path / "r.sam").read()
        ds2 = st.read(sam_mid)
        assert type(ds2.reads).__name__ == "ReadBatch"
        assert ds2.count() == ds.count() == 80
        assert ds2.flagstat() == want.flagstat()
        bam_out = str(tmp_path / "y.bam")
        st.write(ds2, bam_out)
        ref.write(ref.read(str(tmp_path / "r.sam")), str(tmp_path / "r.bam"))
        assert open(bam_out, "rb").read() == \
            open(tmp_path / "r.bam", "rb").read()
        ds3 = st.read(bam_out)
        same_reads(ds3.reads, ref.read(str(tmp_path / "r.bam")).reads)
        # SAM text holds every field; binary tag widths canonicalize to i
        for col in ("pos", "cigars", "seqs", "quals", "names"):
            np.testing.assert_array_equal(getattr(ds3.reads, col),
                                          getattr(want.reads, col))
        for i in (0, 40, 79):
            assert ds3.reads.name(i) == want.reads.name(i)
