"""The port's VCF read and write paths against the reference's, on the CPU.

The same seeded inputs go through ``disq_tpu.VariantsStorage`` and
``disq_tpu_torch.VariantsStorage.make_default(device="cpu")``; every
read must give equal columns, header and counters, and every write the
same bytes (``num_shards`` pinned on both sides, as the two packages
default to different device counts). The cases are the reference's own
(``tests/test_vcf.py``, the VCF cases of ``test_fault_injection.py``,
``test_executor.py`` and ``test_write_pipeline.py``), plus a TBI
byte-identity case, the device inflate route's plain versions
(``.resident_decode()``: B1, B4 under ``legacy``) with a flagged block
salvaged to NUL filler, and the "no hidden fallback" probe.
"""

import gzip
import os
from dataclasses import fields

import numpy as np
import pytest

import disq_tpu as R
from bam_oracle import o_bgzf_compress
from disq_tpu.api import Interval as RInterval
from disq_tpu.runtime.errors import DisqOptions as RDisqOptions
from disq_tpu.runtime.errors import ErrorPolicy as RErrorPolicy

import disq_tpu_torch as P
from disq_tpu_torch import interop
from disq_tpu_torch.bgzf.block import parse_block_header
from disq_tpu_torch.runtime.errors import CorruptBlockError

CONTIGS = [("chr1", 100_000), ("chr2", 50_000)]
HEAD = (b"##fileformat=VCFv4.2\n"
        b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")


def _make_vcf_text(n=500, seed=0, sorted_=True, with_end_info=True):
    rng = np.random.default_rng(seed)
    header = (
        "##fileformat=VCFv4.2\n"
        + "".join(f"##contig=<ID={c},length={l}>\n" for c, l in CONTIGS)
        + '##INFO=<ID=END,Number=1,Type=Integer,Description="End">\n'
        + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n"
    )
    recs = []
    for i in range(n):
        ci = int(rng.integers(0, len(CONTIGS)))
        pos = int(rng.integers(1, CONTIGS[ci][1] - 100))
        ref = "ACGT"[: int(rng.integers(1, 5))]
        alt = "T" if ref[0] != "T" else "C"
        info = "."
        if with_end_info and i % 37 == 0:
            info = f"END={pos + 499}"
        recs.append((ci, pos, f"{CONTIGS[ci][0]}\t{pos}\tid{i}\t{ref}\t{alt}"
                              f"\t50\tPASS\t{info}\tGT\t0/1"))
    if sorted_:
        recs.sort(key=lambda t: (t[0], t[1]))
    body = "".join(line + "\n" for _, _, line in recs)
    return header, body, recs


def _ref(**kw):
    return R.VariantsStorage.make_default()


def _port():
    return P.VariantsStorage.make_default(device="cpu")


def _counters(c):
    return {f.name: getattr(c, f.name) for f in fields(c)
            if f.name != "wall_seconds"}


def same_batch(got, want):
    for col in ("chrom", "pos", "end", "line_offsets", "lines"):
        g, w = getattr(got, col), getattr(want, col)
        assert g.dtype == w.dtype, col
        np.testing.assert_array_equal(g, w, err_msg=col)
    assert got.contig_names == want.contig_names


def same_dataset(got, want):
    same_batch(got.variants, want.variants)
    assert got.header.text == want.header.text
    assert got.header.contigs == want.header.contigs
    assert got.header.samples == want.header.samples
    if want.counters is not None:
        assert _counters(got.counters) == _counters(want.counters)


def both_read(path, ref=None, port=None, **kw):
    """(reference dataset, port dataset) of one read, held equal."""
    want = (ref or _ref()).read(path, **kw)
    got = (port or _port()).read(path, **kw)
    same_dataset(got, want)
    return want, got


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for fn in files:
            p = os.path.join(d, fn)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _block_layout(data):
    """[(start, total size)] of every BGZF block, in file order."""
    out, pos = [], 0
    while pos < len(data):
        total = parse_block_header(data, pos)
        out.append((pos, total))
        pos += total
    return out


@pytest.fixture(scope="module")
def vcf_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("vcf")
    header, body, recs = _make_vcf_text(500, seed=1)
    plain = str(d / "a.vcf")
    open(plain, "w").write(header + body)
    bgz = str(d / "a.vcf.bgz")
    open(bgz, "wb").write(o_bgzf_compress((header + body).encode(),
                                          blocksize=777))
    gz = str(d / "a.vcf.gz")
    open(gz, "wb").write(gzip.compress((header + body).encode()))
    return plain, bgz, gz, recs


# -- tests/test_vcf.py --------------------------------------------------------


class TestRead:
    def test_header(self, vcf_files):
        plain = vcf_files[0]
        _, ds = both_read(plain)
        assert ds.header.contig_names == ("chr1", "chr2")
        assert ds.header.samples == ("S1",)

    @pytest.mark.parametrize("which", [0, 1, 2])
    def test_all_compressions_agree(self, vcf_files, which):
        recs = vcf_files[3]
        _, ds = both_read(vcf_files[which])
        assert ds.count() == len(recs)
        np.testing.assert_array_equal(ds.variants.pos, [p for _, p, _ in recs])
        np.testing.assert_array_equal(ds.variants.chrom,
                                      [c for c, _, _ in recs])

    @pytest.mark.parametrize("split_size", [997, 5000, 10**9])
    def test_bgzf_split_invariance(self, vcf_files, split_size):
        bgz, recs = vcf_files[1], vcf_files[3]
        _, ds = both_read(bgz, _ref().split_size(split_size),
                          _port().split_size(split_size))
        assert ds.count() == len(recs)
        np.testing.assert_array_equal(ds.variants.pos, [p for _, p, _ in recs])

    @pytest.mark.parametrize("split_size", [800, 10**9])
    def test_plain_split_invariance(self, vcf_files, split_size):
        plain, recs = vcf_files[0], vcf_files[3]
        _, ds = both_read(plain, _ref().split_size(split_size),
                          _port().split_size(split_size))
        assert ds.count() == len(recs)

    def test_end_info_respected(self, vcf_files):
        _, ds = both_read(vcf_files[0])
        v = ds.variants
        has_end = [i for i in range(v.count) if "END=" in v.line(i)]
        assert has_end
        for i in has_end:
            assert v.end[i] == v.pos[i] + 499

    def test_interval_filter(self, vcf_files):
        want = _ref().read(vcf_files[0],
                           intervals=[RInterval("chr1", 1, 10_000)])
        ds = _port().read(vcf_files[0],
                          intervals=[P.Interval("chr1", 1, 10_000)])
        same_dataset(ds, want)
        v = ds.variants
        assert v.count > 0
        assert np.all(v.chrom == 0)
        assert np.all(v.pos <= 10_000)


class TestWrite:
    def test_round_trip_plain(self, vcf_files, tmp_path):
        want, ds = both_read(vcf_files[0])
        R.VariantsStorage.make_default().num_shards(3).write(
            want, str(tmp_path / "r.vcf"))
        st = _port().num_shards(3)
        out = str(tmp_path / "o.vcf")
        st.write(ds, out)
        content = open(out).read()
        assert content.startswith("##fileformat")
        assert content == open(tmp_path / "r.vcf").read()
        _, ds2 = both_read(out)
        np.testing.assert_array_equal(ds2.variants.pos, ds.variants.pos)
        assert ds2.variants.line(0) == ds.variants.line(0)

    def test_round_trip_bgz_with_tabix(self, vcf_files, tmp_path):
        recs = vcf_files[3]
        want, ds = both_read(vcf_files[1])
        R.VariantsStorage.make_default().num_shards(4).write(
            want, str(tmp_path / "r.vcf.bgz"), R.TabixIndexWriteOption.ENABLE)
        st = _port().num_shards(4)
        out = str(tmp_path / "o.vcf.bgz")
        st.write(ds, out, P.TabixIndexWriteOption.ENABLE)
        assert open(out, "rb").read() == open(tmp_path / "r.vcf.bgz", "rb").read()
        assert open(out + ".tbi", "rb").read() == \
            open(tmp_path / "r.vcf.bgz.tbi", "rb").read()
        # gzip oracle: the written file is valid multi-member gzip
        raw = gzip.decompress(open(out, "rb").read()).decode()
        lines = raw.split("\n")
        chrom_at = next(i for i, ln in enumerate(lines)
                        if ln.startswith("#CHROM"))
        assert raw.count("\n") == len(recs) + chrom_at + 1
        # read back through the tabix-pruned interval query
        want2 = _ref().read(out, intervals=[RInterval("chr2", 1, 25_000)])
        ds2 = st.read(out, intervals=[P.Interval("chr2", 1, 25_000)])
        same_dataset(ds2, want2)
        brute = st.read(out)
        mask = (brute.variants.chrom == 1) & (brute.variants.pos <= 25_000)
        expect = brute.variants.filter(mask)
        np.testing.assert_array_equal(np.sort(ds2.variants.pos),
                                      np.sort(expect.pos))

    def test_round_trip_gz(self, vcf_files, tmp_path):
        recs = vcf_files[3]
        want, ds = both_read(vcf_files[0])
        R.VariantsStorage.make_default().num_shards(2).write(
            want, str(tmp_path / "r.vcf.gz"))
        out = str(tmp_path / "o.vcf.gz")
        _port().num_shards(2).write(ds, out)
        assert open(out, "rb").read() == open(tmp_path / "r.vcf.gz", "rb").read()
        _, ds2 = both_read(out)
        assert ds2.count() == len(recs)

    def test_multiple(self, vcf_files, tmp_path):
        recs = vcf_files[3]
        want, ds = both_read(vcf_files[0])
        R.VariantsStorage.make_default().num_shards(3).write(
            want, str(tmp_path / "r"), R.FileCardinalityWriteOption.MULTIPLE)
        out = str(tmp_path / "parts")
        _port().num_shards(3).write(ds, out,
                                    P.FileCardinalityWriteOption.MULTIPLE)
        parts = sorted(os.listdir(out))
        assert len(parts) == 3
        assert _tree(out) == _tree(str(tmp_path / "r"))
        total = sum(_port().read(os.path.join(out, p)).count() for p in parts)
        assert total == len(recs)

    def test_tbi_requires_bgz(self, vcf_files, tmp_path):
        want, ds = both_read(vcf_files[0])
        with pytest.raises(ValueError, match="VCF_BGZ"):
            _ref().write(want, str(tmp_path / "r.vcf"),
                         R.TabixIndexWriteOption.ENABLE)
        with pytest.raises(ValueError, match="VCF_BGZ"):
            _port().write(ds, str(tmp_path / "x.vcf"),
                          P.TabixIndexWriteOption.ENABLE)


class TestBlockBoundaryOwnership:
    def test_newline_at_block_boundary_not_lost(self, tmp_path):
        """A BGZF block boundary falling exactly after a newline must not
        drop the next line at any split size."""
        header = (
            "##fileformat=VCFv4.2\n##contig=<ID=chr1,length=100000>\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        )
        lines = [f"chr1\t{p}\t.\tA\tG\t9\tPASS\t." for p in range(1, 201)]
        payload = (header + "\n".join(lines) + "\n").encode()
        comp = o_bgzf_compress(payload, blocksize=len(lines[0]) + 1)
        p = str(tmp_path / "b.vcf.bgz")
        open(p, "wb").write(comp)
        for split_size in range(300, 420, 7):
            _, ds = both_read(p, _ref().split_size(split_size),
                              _port().split_size(split_size))
            assert ds.count() == 200, f"split_size={split_size} lost records"


# -- fault injection, executor and write pipeline cases -----------------------


def _skip_opts(port=True):
    if port:
        return P.DisqOptions(error_policy=P.ErrorPolicy.SKIP,
                             retry_backoff_s=0.0)
    return RDisqOptions(error_policy=RErrorPolicy.SKIP, retry_backoff_s=0.0)


def _expected_positions(text, ulo, uhi):
    """POS of every body line not overlapping [ulo, uhi)."""
    expected, off = [], 0
    for ln in text.splitlines(keepends=True):
        s, e = off, off + len(ln)
        off = e
        if not ln.startswith(b"#") and (e <= ulo or s >= uhi):
            expected.append(int(ln.split(b"\t")[1]))
    return expected


@pytest.fixture(scope="module")
def corrupt_vcfs(tmp_path_factory):
    """The fault-injection inputs: (path, text, bad block index) for a
    flipped payload bit (``extension``), a flipped ISIZE bit (``isize``)
    and a broken gzip magic (``header``), each at 600-byte blocks."""
    d = tmp_path_factory.mktemp("corrupt")
    out = {}
    for kind, ref_allele, n, at in (
            ("extension", b"ACGTACGTACGT", 400, lambda s, t: s + 20),
            ("isize", b"A", 300, lambda s, t: s + t - 2),
            ("header", b"ACGT", 400, lambda s, t: s + 1)):
        alt = b"C" if kind == "isize" else b"A"
        text = HEAD + b"".join(
            b"chr1\t%d\t.\t%s\t%s\t50\tPASS\tDP=%d\n" % (i + 1, ref_allele,
                                                       alt, i)
            for i in range(n))
        data = o_bgzf_compress(text, blocksize=600)
        layout = _block_layout(data)
        blk_i = len(layout) // 2
        start, total = layout[blk_i]
        bad = bytearray(data)
        bad[at(start, total)] ^= {"extension": 0x04, "isize": 0x80,
                                  "header": 0x01}[kind]
        path = str(d / f"{kind}.vcf.gz")
        open(path, "wb").write(bytes(bad))
        out[kind] = (path, text, blk_i, start)
    return out


def test_vcf_extension_block_counted_once(corrupt_vcfs):
    """The split boundary sits exactly at the corrupt block: the previous
    split's straddling-line extension reads it silently, the next split
    owns it and counts it once."""
    path, text, blk_i, start = corrupt_vcfs["extension"]
    want = _ref().split_size(start).options(_skip_opts(False)).read(path)
    ds = _port().split_size(start).options(_skip_opts()).read(path)
    same_dataset(ds, want)
    assert ds.counters.skipped_blocks == 1
    assert list(ds.variants.pos) == _expected_positions(
        text, blk_i * 600, (blk_i + 1) * 600)


def test_vcf_corrupt_isize_filler_is_clamped(corrupt_vcfs):
    """A bit flip in a block's ISIZE footer must not balloon the skip
    policy's NUL filler."""
    path = corrupt_vcfs["isize"][0]
    want = _ref().options(_skip_opts(False)).read(path)
    ds = _port().options(_skip_opts()).read(path)
    same_dataset(ds, want)
    assert ds.counters.skipped_blocks == 1
    assert 300 - 40 < ds.count() < 300


def test_nul_byte_in_vcf_data_survives(tmp_path):
    """The corrupt-block NUL filter must not run on the fault-free path:
    real (spec-hostile) NUL bytes in a record are kept."""
    lines = [b"chr1\t%d\t.\tA\tC\t50\tPASS\tDP=1\n" % (i + 1)
             for i in range(50)]
    lines[25] = b"chr1\t26\t.\tA\tC\t50\tPASS\tXX=a\x00b\n"
    path = str(tmp_path / "n.vcf.gz")
    open(path, "wb").write(o_bgzf_compress(HEAD + b"".join(lines),
                                           blocksize=300))
    _, ds = both_read(path, _ref().split_size(400), _port().split_size(400))
    assert ds.count() == 50


def test_skip_resyncs_instead_of_dropping_split(corrupt_vcfs):
    """A corrupt block HEADER loses only that block's lines (salvage walk
    and re-sync), not the whole split."""
    path, text, blk_i, _ = corrupt_vcfs["header"]
    want = _ref().options(_skip_opts(False)).read(path)
    ds = _port().options(_skip_opts()).read(path)
    same_dataset(ds, want)
    assert ds.counters.skipped_blocks == 1
    assert list(ds.variants.pos) == _expected_positions(
        text, blk_i * 600, (blk_i + 1) * 600)


@pytest.mark.parametrize("workers", [2, 8])
def test_vcf_bgzf_identical(tmp_path, workers):
    header = ("##fileformat=VCFv4.3\n"
              "##contig=<ID=chr1,length=248956422>\n"
              '##INFO=<ID=DP,Number=1,Type=Integer,Description="d">\n'
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    body = "".join(f"chr1\t{100 + i * 3}\t.\tA\tG\t50\tPASS\tDP={i % 40}\n"
                   for i in range(3000))
    p = str(tmp_path / "v.vcf.bgz")
    open(p, "wb").write(o_bgzf_compress((header + body).encode(),
                                        blocksize=777))
    want = _ref().split_size(4096).executor_workers(workers).read(p)
    base = _port().split_size(4096).read(p)
    ds = _port().split_size(4096).executor_workers(workers).read(p)
    same_dataset(ds, want)
    same_dataset(base, want)
    assert ds.count() == 3000


@pytest.mark.parametrize("workers", [2, 8])
def test_bcf_identical(tmp_path, workers):
    header = ("##fileformat=VCFv4.3\n"
              "##contig=<ID=chr1,length=248956422>\n"
              '##INFO=<ID=DP,Number=1,Type=Integer,Description="d">\n'
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    lines = [f"chr1\t{10 + 5 * i}\t.\tA\tG\t50\tPASS\tDP={i % 9}"
             for i in range(2500)]
    ds0 = interop.variants_dataset_from_state(
        header, interop.columns_of(_parse(header, lines)))
    p = str(tmp_path / "d.bcf")
    _port().write(ds0, p)
    want = _ref().split_size(2048).executor_workers(workers).read(p)
    base = _port().split_size(2048).read(p)
    ds = _port().split_size(2048).executor_workers(workers).read(p)
    for got in (ds, base):
        same_batch(got.variants, want.variants)
        assert got.header.text == want.header.text
    assert ds.count() == 2500


def _parse(header, lines):
    from disq_tpu_torch.vcf.columnar import parse_vcf_lines
    from disq_tpu_torch.vcf.header import VcfHeader

    return parse_vcf_lines([ln.encode() for ln in lines],
                           VcfHeader.from_text(header).contig_names)


@pytest.fixture(scope="module")
def variants_pair():
    """The write pipeline's dataset, built once in each package."""
    from disq_tpu.vcf.columnar import parse_vcf_lines as ref_parse
    from disq_tpu.vcf.header import VcfHeader as RHeader

    header = ("##fileformat=VCFv4.3\n"
              "##contig=<ID=chr1,length=248956422>\n"
              '##INFO=<ID=DP,Number=1,Type=Integer,Description="d">\n'
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    lines = [f"chr1\t{10 + 5 * i}\t.\tA\tG\t50\tPASS\tDP={i % 9}"
             for i in range(2400)]
    h = RHeader.from_text(header)
    ref = R.api.VariantsDataset(
        header=h, variants=ref_parse([ln.encode() for ln in lines],
                                     h.contig_names))
    port = interop.variants_dataset_from_state(
        header, interop.columns_of(ref.variants))
    return ref, port


@pytest.mark.parametrize("workers", [4, 8])
@pytest.mark.parametrize("ext", [".vcf", ".vcf.bgz"])
def test_vcf_single(variants_pair, tmp_path, workers, ext):
    ref, port = variants_pair
    r_opts = (R.TabixIndexWriteOption.ENABLE,) if ext == ".vcf.bgz" else ()
    p_opts = (P.TabixIndexWriteOption.ENABLE,) if ext == ".vcf.bgz" else ()
    names = ("ref", "seq", "par")
    R.VariantsStorage.make_default().num_shards(6).write(
        ref, str(tmp_path / ("ref" + ext)), *r_opts)
    _port().num_shards(6).write(port, str(tmp_path / ("seq" + ext)), *p_opts)
    _port().num_shards(6).writer_workers(workers).write(
        port, str(tmp_path / ("par" + ext)), *p_opts)
    files = [(tmp_path / (n + ext)).read_bytes() for n in names]
    assert files[0] == files[1] == files[2]
    if p_opts:
        tbis = [(tmp_path / (n + ext + ".tbi")).read_bytes() for n in names]
        assert tbis[0] == tbis[1] == tbis[2]


# -- the tabix index ----------------------------------------------------------


def test_tbi_byte_identity_and_queries(tmp_path):
    """A three-contig write with symbolic END alleles: the TBI built and
    merged by the port equals the reference's byte for byte, parses to
    the same index, and serves the same chunks and interval reads."""
    from disq_tpu.index.tbi import TbiIndex as RTbi

    from disq_tpu_torch.index.tbi import TbiIndex

    rng = np.random.default_rng(9)
    contigs = [("chr1", 5_000_000), ("chr2", 3_000_000), ("chr3", 1_000_000)]
    header = ("##fileformat=VCFv4.2\n"
              + "".join(f"##contig=<ID={c},length={n}>\n" for c, n in contigs)
              + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    lines = []
    for ci, (c, n) in enumerate(contigs):
        for p in np.sort(rng.integers(1, n - 20_000, 700)):
            info = (f"END={p + int(rng.integers(100, 20_000))};SVTYPE=DEL"
                    if rng.random() < 0.05 else f"DP={int(rng.integers(99))}")
            alt = "<DEL>" if info.startswith("END") else "T"
            lines.append(f"{c}\t{p}\t.\tA\t{alt}\t50\tPASS\t{info}")
    src = str(tmp_path / "in.vcf")
    open(src, "w").write(header + "".join(ln + "\n" for ln in lines))
    want, ds = both_read(src)
    r_out, p_out = str(tmp_path / "r.vcf.bgz"), str(tmp_path / "p.vcf.bgz")
    R.VariantsStorage.make_default().num_shards(5).write(
        want, r_out, R.TabixIndexWriteOption.ENABLE)
    _port().num_shards(5).write(ds, p_out, P.TabixIndexWriteOption.ENABLE)
    assert open(p_out, "rb").read() == open(r_out, "rb").read()
    raw = open(p_out + ".tbi", "rb").read()
    assert raw == open(r_out + ".tbi", "rb").read()
    got, ref = TbiIndex.from_bytes(raw), RTbi.from_bytes(raw)
    assert got.to_bytes() == raw and got.names == ref.names
    for c, beg, end in (("chr1", 0, 200_000), ("chr2", 1_000_000, 1_500_000),
                        ("chr3", 0, 1_000_000), ("chrX", 0, 10)):
        assert got.chunks_for_interval(c, beg, end) == \
            ref.chunks_for_interval(c, beg, end)
    ivs = [("chr1", 100_000, 400_000), ("chr3", 500_000, 510_000)]
    for st in (_port(), _port().resident_decode()):
        same_dataset(st.read(p_out, intervals=[P.Interval(*iv) for iv in ivs]),
                     _ref().read(p_out, intervals=[RInterval(*iv) for iv in ivs]))


# -- the device route's plain versions, and no hidden fallback ----------------


@pytest.fixture()
def b1_calls(monkeypatch):
    """Count the B1 plain version's calls (the launches on the card)."""
    from disq_tpu_torch.ops import inflate_simd as B1

    calls = []
    real = B1.inflate_plain

    def counting(*args):
        calls.append(int(args[1].numel()))
        return real(*args)

    monkeypatch.setattr(B1, "inflate_plain", counting)
    return calls


def _split_launches(path, split_size):
    """B1 launches of a VCF.bgz split read: one for each split's own
    blocks, and one for the neighbor block that finishes its straddling
    line (every block of these files holds a newline; the last split's
    neighbor is the EOF block)."""
    data = open(path, "rb").read()
    layout = _block_layout(data)
    n = 0
    for s in range(0, len(data), split_size):
        owned = [(b, t) for b, t in layout if s <= b < s + split_size]
        if owned:
            n += 1 + (owned[-1][0] + owned[-1][1] < len(data))
    return n


@pytest.mark.parametrize("route", ["b1", "legacy"])
def test_device_route_reads_equal_reference(vcf_files, route, b1_calls,
                                            monkeypatch):
    """``.resident_decode()`` on the CPU takes the device route through
    the kernels' plain versions: split reads (B1 once per split and once
    per neighbor extension), the 4-worker read and the tabix read equal
    the reference's host reads."""
    if route == "legacy":
        monkeypatch.setenv("DISQ_TPU_TORCH_DEVICE_INFLATE", "legacy")
    bgz, recs = vcf_files[1], vcf_files[3]
    for workers in (1, 4):
        both_read(bgz, _ref().split_size(5000),
                  _port().split_size(5000).resident_decode()
                  .executor_workers(workers))
    assert len(b1_calls) == (0 if route == "legacy"
                             else 2 * _split_launches(bgz, 5000))


def test_device_route_salvages_flagged_block_to_filler(corrupt_vcfs,
                                                      b1_calls, monkeypatch):
    """On the device route the flagged block alone inflates on the host
    (and fails there): it becomes NUL filler, its lines drop, the other
    blocks keep the kernel's bytes, and everything equals the
    reference's host salvage; under STRICT the read raises with the
    block's coordinates."""
    from disq_tpu_torch.bgzf import codec

    path, text, blk_i, start = corrupt_vcfs["extension"]
    real, alone = codec.inflate_block, []

    def counting(data, offset=None, verify_crc=True):
        if offset is not None:  # a block of a batch, inflated alone
            alone.append(offset)
        return real(data, offset or 0, verify_crc)

    monkeypatch.setattr(codec, "inflate_block", counting)
    for split in (start, 10**9):
        want = _ref().split_size(split).options(_skip_opts(False)).read(path)
        alone.clear()
        ds = (_port().split_size(split).options(_skip_opts())
              .resident_decode().read(path))
        same_dataset(ds, want)
        assert ds.counters.skipped_blocks == 1
        # the owner's salvage tries the flagged block alone (the previous
        # split's extension salvages it silently too, when it reads it)
        assert 1 <= len(alone) <= 2
    assert b1_calls
    with pytest.raises(CorruptBlockError, match="BGZF block"):
        _port().resident_decode().read(path)


def test_kernel_fault_is_raised_not_salvaged(vcf_files, monkeypatch):
    """A kernel that flags valid data: every flagged block then inflates
    alone on the host, so the read raises the batch's error under any
    policy, never a salvaged batch."""
    import torch

    from disq_tpu_torch.ops import inflate_simd as B1

    real = B1.inflate

    def flagging(*args):
        out, out_len, status = real(*args)
        return out, out_len, torch.full_like(status, 3)

    monkeypatch.setattr(B1, "inflate", flagging)
    for policy in ("skip", "quarantine", "strict"):
        st = (_port().resident_decode().error_policy(policy)
              .options(P.DisqOptions(error_policy=P.ErrorPolicy.coerce(policy),
                                     retry_backoff_s=0.0,
                                     quarantine_dir=vcf_files[1] + ".q")))
        with pytest.raises(ValueError, match="device inflate failed") as e:
            st.read(vcf_files[1])
        assert not isinstance(e.value, CorruptBlockError)


def test_entry_points_raise_without_cuda(vcf_files, monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = _port().read(vcf_files[0])
    for call in (lambda: P.VariantsStorage.make_default().read(vcf_files[0]),
                 lambda: P.VariantsStorage.make_default().write(
                     ds, str(tmp_path / "x.vcf"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not os.path.exists(tmp_path / "x.vcf")


def test_interop_variants_round_trip(vcf_files, tmp_path):
    """The reference's decoded state carried across: its batch's columns
    and header text build the port's dataset, whose columns build the
    reference's batch back; both write the same bytes."""
    from disq_tpu.vcf.columnar import VariantBatch as RBatch

    want = _ref().read(vcf_files[0])
    cols = interop.columns_of(want.variants)
    assert set(cols) == {"chrom", "pos", "end", "line_offsets", "lines",
                         "contig_names"}
    ds = interop.variants_dataset_from_state(want.header.text, cols)
    same_batch(ds.variants, want.variants)
    assert ds.header == interop.vcf_header_from_text(want.header.text)
    assert ds.header.contigs == want.header.contigs
    back = RBatch(**interop.columns_of(ds.variants))
    same_batch(back, want.variants)
    with pytest.raises(TypeError, match="pos"):
        interop.variant_batch_from_columns(
            {**cols, "pos": cols["pos"].astype(np.int64)})
    opts = interop.write_options(["TabixIndexWriteOption.ENABLE",
                                  "VariantsFormatWriteOption.VCF_BGZ"])
    assert opts == (P.TabixIndexWriteOption.ENABLE,
                    P.VariantsFormatWriteOption.VCF_BGZ)
    R.VariantsStorage.make_default().num_shards(2).write(
        want, str(tmp_path / "r.vcf.bgz"), R.TabixIndexWriteOption.ENABLE,
        R.VariantsFormatWriteOption.VCF_BGZ)
    _port().num_shards(2).write(ds, str(tmp_path / "p.vcf.bgz"), *opts)
    for ext in ("", ".tbi"):
        assert (tmp_path / ("p.vcf.bgz" + ext)).read_bytes() == \
            (tmp_path / ("r.vcf.bgz" + ext)).read_bytes()
