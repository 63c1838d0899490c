"""The port's BCF 2.2 codec, read and write against the reference's, on
the CPU: the cases of ``tests/test_bcf.py``, each run through both
``disq_tpu.vcf.bcf`` and ``disq_tpu_torch.vcf.bcf`` on the same input,
with equal dictionaries, equal encoded bytes, equal decoded columns and
byte-identical files (``num_shards`` pinned on both sides). The storage
reads also run the device inflate route's plain version
(``.resident_decode()``: B1 once per split)."""

import gzip
import os
import struct

import numpy as np
import pytest

import disq_tpu as R
from disq_tpu.api import Interval as RInterval
from disq_tpu.api import VariantsDataset as RDataset
from disq_tpu.vcf import bcf as rbcf
from disq_tpu.vcf.columnar import parse_vcf_lines as ref_parse
from disq_tpu.vcf.header import VcfHeader as RHeader

import disq_tpu_torch as P
from disq_tpu_torch.vcf import bcf
from disq_tpu_torch.vcf.columnar import parse_vcf_lines
from disq_tpu_torch.vcf.header import VcfHeader

HDR = (
    "##fileformat=VCFv4.3\n"
    '##contig=<ID=chr1,length=1000000>\n'
    '##contig=<ID=chr2,length=500000>\n'
    '##FILTER=<ID=q10,Description="low qual">\n'
    '##INFO=<ID=DP,Number=1,Type=Integer,Description="depth">\n'
    '##INFO=<ID=AF,Number=A,Type=Float,Description="freq">\n'
    '##INFO=<ID=DB,Number=0,Type=Flag,Description="dbsnp">\n'
    '##INFO=<ID=CSQ,Number=.,Type=String,Description="csq">\n'
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="genotype">\n'
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="depth">\n'
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="qual">\n'
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\ts2\n"
)

LINES = [
    "chr1\t100\trs1\tA\tT\t29.5\tPASS\tDP=14;AF=0.5;DB\tGT:DP:GQ\t0|1:12:99\t1/1:.:7",
    "chr1\t200\t.\tAC\tA,ACT\t.\tq10\tDP=7;CSQ=x|y\tGT:DP\t0/1:3\t./.:.",
    "chr2\t300\t.\tG\t.\t10\t.\t.\tGT\t0/0\t1|1",
]
NO_SAMPLES = (
    "##fileformat=VCFv4.3\n"
    '##contig=<ID=c1,length=100>\n'
    '##INFO=<ID=DP,Number=1,Type=Integer,Description="d">\n'
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
)


def _pair(text=HDR, lines=LINES):
    """(reference (header, batch), port (header, batch)) of the lines."""
    rh, ph = RHeader.from_text(text), VcfHeader.from_text(text)
    enc = [ln.encode() for ln in lines]
    return ((rh, ref_parse(enc, rh.contig_names)),
            (ph, parse_vcf_lines(enc, ph.contig_names)))


def same_batch(got, want):
    for col in ("chrom", "pos", "end", "line_offsets", "lines"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col))
    assert got.contig_names == want.contig_names


def _lines(batch):
    return [batch.line(i) for i in range(batch.count)]


def _storages(resident=False):
    port = P.VariantsStorage.make_default(device="cpu").num_shards(8)
    if resident:
        port = port.resident_decode()
    return R.VariantsStorage.make_default().num_shards(8), port


def _write_both(tmp_path, name, text=HDR, lines=LINES, *opts):
    """Write the lines with both packages; the files must be equal."""
    (rh, rb), (ph, pb) = _pair(text, lines)
    ref, port = _storages()
    r_path, p_path = str(tmp_path / ("r-" + name)), str(tmp_path / name)
    ref.write(RDataset(header=rh, variants=rb), r_path,
              *[getattr(R, type(o).__name__)[o.name] for o in opts])
    port.write(P.VariantsDataset(header=ph, variants=pb), p_path, *opts)
    if os.path.isdir(p_path):
        assert sorted(os.listdir(p_path)) == sorted(os.listdir(r_path))
        for f in os.listdir(p_path):
            assert open(os.path.join(p_path, f), "rb").read() == \
                open(os.path.join(r_path, f), "rb").read()
    else:
        assert open(p_path, "rb").read() == open(r_path, "rb").read()
    return p_path


def _read_both(path, resident=False, **kw):
    ref, port = _storages(resident)
    want = ref.read(path, **{k: [RInterval(*iv) for iv in v]
                             for k, v in kw.items()})
    got = port.read(path, **{k: [P.Interval(*iv) for iv in v]
                             for k, v in kw.items()})
    same_batch(got.variants, want.variants)
    assert got.header.text == want.header.text
    assert got.counters.records == want.counters.records
    assert got.counters.blocks == want.counters.blocks
    return got


class TestDictionaries:
    def test_pass_is_zero_and_order(self):
        d = bcf.BcfDictionaries(VcfHeader.from_text(HDR))
        r = rbcf.BcfDictionaries(RHeader.from_text(HDR))
        assert d.strings == r.strings and d.contigs == r.contigs
        assert d.strings[0] == "PASS"
        assert d.string_index["q10"] == 1
        assert d.string_index["DP"] == 2  # the first DP declaration wins
        assert d.contig_index == {"chr1": 0, "chr2": 1}

    def test_idx_respected(self):
        text = ("##fileformat=VCFv4.3\n"
                '##contig=<ID=cX,IDX=3>\n'
                '##FILTER=<ID=PASS,Description="ok",IDX=0>\n'
                '##INFO=<ID=DP,Number=1,Type=Integer,Description="d",IDX=7>\n'
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        d = bcf.BcfDictionaries(VcfHeader.from_text(text))
        r = rbcf.BcfDictionaries(RHeader.from_text(text))
        assert d.strings == r.strings and d.contigs == r.contigs
        assert d.strings[7] == "DP"
        assert d.contig(3) == "cX"


class TestRoundTrip:
    def test_text_binary_text(self):
        (rh, rb), (ph, pb) = _pair()
        blob = bcf.encode_bcf_records(pb, ph)
        assert blob == rbcf.encode_bcf_records(rb, rh)
        back = bcf.decode_bcf_records(b"\x00" * 4 + blob, ph, 4)
        same_batch(back, rbcf.decode_bcf_records(b"\x00" * 4 + blob, rh, 4))
        assert _lines(back) == LINES
        np.testing.assert_array_equal(back.chrom, pb.chrom)
        np.testing.assert_array_equal(back.pos, pb.pos)
        np.testing.assert_array_equal(back.end, pb.end)

    def test_header_block(self):
        block = bcf.build_bcf_header_block(VcfHeader.from_text(HDR))
        assert block == rbcf.build_bcf_header_block(RHeader.from_text(HDR))
        h, off = bcf.read_bcf_header_block(block)
        assert off == rbcf.read_bcf_header_block(block)[1]
        assert h.contig_names == ("chr1", "chr2")
        assert h.samples == ("s1", "s2")

    def test_no_samples(self):
        lines = ["c1\t5\t.\tA\tC\t1\tPASS\tDP=2", "c1\t7\t.\tT\t.\t.\t.\t."]
        (rh, rb), (ph, pb) = _pair(NO_SAMPLES, lines)
        blob = bcf.encode_bcf_records(pb, ph)
        assert blob == rbcf.encode_bcf_records(rb, rh)
        back = bcf.decode_bcf_records(blob, ph, 0)
        same_batch(back, rbcf.decode_bcf_records(blob, rh, 0))
        assert _lines(back) == lines


class TestHandConstructedRecord:
    def test_decode_known_bytes(self):
        text = ("##fileformat=VCFv4.3\n"
                '##contig=<ID=chr9,length=1000>\n'
                '##INFO=<ID=DP,Number=1,Type=Integer,Description="d">\n'
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        shared = bytearray()
        shared += struct.pack("<iii", 0, 41, 1)        # CHROM chr9, POS0 41, rlen 1
        shared += struct.pack("<f", 50.0)              # QUAL
        shared += struct.pack("<II", (2 << 16) | 1, 0)  # 2 alleles, 1 info, 0 fmt
        shared += bytes([0x27]) + b"id"                # ID "id"
        shared += bytes([0x17]) + b"C"                 # REF "C"
        shared += bytes([0x17]) + b"G"                 # ALT "G"
        shared += bytes([0x11, 0x00])                  # FILTER [0] = PASS
        shared += bytes([0x11, 0x01])                  # key idx 1 = DP
        shared += bytes([0x11, 0x2A])                  # DP=42 (int8)
        rec = struct.pack("<II", len(shared), 0) + bytes(shared)
        batch = bcf.decode_bcf_records(rec, VcfHeader.from_text(text), 0)
        same_batch(batch, rbcf.decode_bcf_records(
            rec, RHeader.from_text(text), 0))
        assert batch.count == 1
        assert batch.line(0) == "chr9\t42\tid\tC\tG\t50\tPASS\tDP=42"
        assert int(batch.pos[0]) == 42 and int(batch.end[0]) == 42


class TestStorageApi:
    @pytest.mark.parametrize("resident", [False, True])
    def test_write_read_bcf(self, tmp_path, resident):
        path = _write_both(tmp_path, "x.bcf")
        with open(path, "rb") as f:
            assert gzip.decompress(f.read())[:5] == bcf.BCF_MAGIC
        back = _read_both(path, resident)
        assert back.count() == len(LINES)
        assert _lines(back.variants) == LINES
        assert back.header.samples == ("s1", "s2")

    def test_format_write_option_dispatch(self, tmp_path):
        path = _write_both(tmp_path, "weird.ext", HDR, LINES,
                           P.VariantsFormatWriteOption.BCF,
                           P.FileCardinalityWriteOption.SINGLE)
        with open(path, "rb") as f:
            assert gzip.decompress(f.read())[:5] == bcf.BCF_MAGIC

    def test_interval_filter(self, tmp_path):
        path = _write_both(tmp_path, "x.bcf")
        got = _read_both(path, intervals=[("chr1", 150, 250)])
        assert got.count() == 1
        assert got.variants.line(0) == LINES[1]

    def test_undeclared_contig_auto_added(self, tmp_path):
        # the sink appends ##contig lines for contigs present only in the
        # data, so the round trip succeeds
        text = ("##fileformat=VCFv4.3\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        path = _write_both(tmp_path, "x.bcf", text,
                           ["chrZ\t1\t.\tA\tC\t1\tPASS\t."])
        back = _read_both(path)
        assert back.count() == 1
        assert back.variants.line(0) == "chrZ\t1\t.\tA\tC\t1\tPASS\t."
        assert "##contig=<ID=chrZ>" in back.header.text

    def test_multiple_cardinality(self, tmp_path):
        d = _write_both(tmp_path, "parts", HDR, LINES,
                        P.VariantsFormatWriteOption.BCF,
                        P.FileCardinalityWriteOption.MULTIPLE)
        parts = sorted(os.listdir(d))
        assert parts and all(p.endswith(".bcf") for p in parts)
        got = []
        for p in parts:
            got += _lines(_read_both(os.path.join(d, p)).variants)
        assert got == LINES

    def test_gt_wide_alleles_promote_to_int16(self):
        # allele index 63 → (63+1)<<1 = 128 does not fit int8
        alt = ",".join("A" * (k % 5 + 2) for k in range(70))
        text = ("##fileformat=VCFv4.3\n"
                '##contig=<ID=c1,length=100>\n'
                '##FORMAT=<ID=GT,Number=1,Type=String,Description="g">\n'
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\n")
        line = f"c1\t5\t.\tG\t{alt}\t1\tPASS\t.\tGT\t0/70"
        (rh, rb), (ph, pb) = _pair(text, [line])
        blob = bcf.encode_bcf_records(pb, ph)
        assert blob == rbcf.encode_bcf_records(rb, rh)
        assert bcf.decode_bcf_records(blob, ph, 0).line(0) == line

    def test_inf_nan_floats_survive(self):
        text = ("##fileformat=VCFv4.3\n"
                '##contig=<ID=c1,length=100>\n'
                '##INFO=<ID=AF,Number=1,Type=Float,Description="f">\n'
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        line = "c1\t5\t.\tA\tC\tinf\tPASS\tAF=-inf"
        (rh, rb), (ph, pb) = _pair(text, [line])
        blob = bcf.encode_bcf_records(pb, ph)
        assert blob == rbcf.encode_bcf_records(rb, rh)
        assert bcf.decode_bcf_records(blob, ph, 0).line(0) == line

    def test_truncated_header_block_raises(self):
        bad = b"BCF\x02\x02" + struct.pack("<I", 10_000) + b"short\x00"
        for mod in (bcf, rbcf):
            with pytest.raises(ValueError, match="truncated BCF header"):
                mod.read_bcf_header_block(bad)

    def test_not_bcf_magic(self, tmp_path):
        from disq_tpu_torch.bgzf.codec import compress_to_bgzf

        p = str(tmp_path / "fake.bcf")
        with open(p, "wb") as f:
            f.write(compress_to_bgzf(b"not a bcf at all"))
        for st in _storages() + (_storages(True)[1],):
            with pytest.raises(ValueError, match="magic|BCF"):
                st.read(p)


def test_truncated_typed_value_raises():
    # a typed scalar cut off at the buffer end must raise, not decode a
    # short slice to a small int
    for mod in (bcf, rbcf):
        r = mod._Reader(b"\x01", 0)  # 1 byte left, INT16 needs 2
        r_t = mod._Reader(bytes([0x12, 0x01]), 0)  # INT16 x1, 1 byte
        with pytest.raises(ValueError, match="truncated"):
            r._scalar_int(mod._T_INT16)
        with pytest.raises(ValueError, match="truncated"):
            r_t.typed_int()
        r2 = mod._Reader(bytes([0x13, 0x01, 0x02]), 0)  # INT32 x1, 2 bytes
        with pytest.raises(ValueError, match="truncated"):
            r2.typed_values()
        assert mod._Reader(bytes([0x13, 1, 0, 0, 0]), 0).typed_int() == 1


def test_split_read_launches_b1_once_per_split(tmp_path, monkeypatch):
    """A BCF of several splits read on the device route: the plain B1
    runs once per split (the kernel's launches on the card), and a
    device deflate write inflates to the zlib-6 write's stream and reads
    back equal."""
    from disq_tpu_torch.ops import inflate_simd as B1

    lines = [f"chr1\t{10 + 7 * i}\t.\tA\tG\t50\tPASS\tDP={i % 11}"
             f"\tGT:DP:GQ\t0|1:{i % 30}:{i % 99}\t1/1:.:7"
             for i in range(3000)]
    path = _write_both(tmp_path, "big.bcf", HDR, lines)
    calls, real = [], B1.inflate_plain
    monkeypatch.setattr(B1, "inflate_plain",
                        lambda *a: calls.append(1) or real(*a))
    size = os.path.getsize(path)
    ref, _ = _storages()
    want = ref.split_size(4096).read(path)
    got = (P.VariantsStorage.make_default(device="cpu").resident_decode()
           .split_size(4096).executor_workers(3).read(path))
    same_batch(got.variants, want.variants)
    assert _lines(got.variants) == lines
    from disq_tpu_torch.bgzf.block import parse_block_header

    data, starts, pos = open(path, "rb").read(), [], 0
    while pos < size:
        starts.append(pos)
        pos += parse_block_header(data, pos)
    owning = {s // 4096 for s in starts}  # splits that own a block start
    assert len(calls) == len(owning) > 2
    assert got.counters.shards == -(-size // 4096)
    dev = str(tmp_path / "dev.bcf")
    P.VariantsStorage.make_default(device="cpu").num_shards(3) \
        .device_deflate().write(got, dev)
    assert open(dev, "rb").read() != open(path, "rb").read()
    assert gzip.decompress(open(dev, "rb").read()) == \
        gzip.decompress(open(path, "rb").read())
