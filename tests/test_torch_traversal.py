"""Indexed (interval) reads of the port (``traversal/bai_query.py``, the
traversal branches of ``bam/source.py`` and ``cram/source.py``) on the
CPU, against ``disq_tpu`` on the same files and against the brute-force
overlap oracle over ``tests/bam_oracle.py``'s records, exactly:

- the reference's ``tests/test_traversal.py`` cases (four intervals, an
  empty one, unplaced-unmapped only, intervals plus unmapped, a missing
  BAI), on the host route and on the device route (``resident_decode``:
  the kernels' plain versions), every column equal to the reference's;
  on the device route each BAI chunk decoded books one inflate and one
  parse call, and no block inflates on the host;
- a read filter inside the traversal (the reference applies it in the
  chunk decode), with its mask call once per chunk on the device route;
- the CRAM cases of ``tests/test_cram.py`` (an interval through the
  CRAI, the unmapped traversal), with the order-0 rANS streams of the
  chosen containers decoded in one call on the device route;
- the transient-retry case of ``tests/test_fault_injection.py``: the
  same seeded fault fires on the same call as in the reference, and the
  whole-phase retry books it;
- the resident-decode traversal of ``tests/test_resident_decode.py``;
- interval reads over ``http://`` from an in-process server equal the
  local ones.
"""

import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from bam_oracle import (
    DEFAULT_REFS, make_bam_bytes, parse_bam, ref_span, synth_records)
import disq_tpu.api as R
from disq_tpu.fsw import faultfs as ref_faultfs
from disq_tpu.fsw import filesystem as ref_filesystem
from disq_tpu.runtime.errors import DisqOptions as RefDisqOptions
import disq_tpu_torch as P
from disq_tpu_torch.bam import source as bam_source
from disq_tpu_torch.fsw import faultfs, filesystem
from disq_tpu_torch.fsw.http import HttpFileSystemWrapper
from disq_tpu_torch.index.bai import BaiIndex
from disq_tpu_torch.ops import inflate_simd, parse, rans_simd, rfilter
from disq_tpu_torch.runtime.columnar import ColumnarBatch
from disq_tpu_torch.runtime.errors import DisqOptions
from disq_tpu_torch.traversal import bai_query
from disq_tpu_torch.util import shutdown_shared_host_pool
from test_torch_cram import QS_KNOBS, _synth_ref_matched
from test_torch_http_fsw import _RangeHandler

FIELDS = ("refid", "pos", "mapq", "bin", "flag", "next_refid", "next_pos",
          "tlen", "name_offsets", "names", "cigar_offsets", "cigars",
          "seq_offsets", "seqs", "quals", "tag_offsets", "tags")
INTERVALS = [("chr1", 1, 5000), ("chr1", 40_000, 60_000),
             ("chr2", 1, 50_000), ("chrM", 1, 16_569)]
NAMES = [n for n, _ in DEFAULT_REFS]
FILTER = "-F 0x904 -q 20"


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    yield
    shutdown_shared_host_pool()


@pytest.fixture(scope="module")
def indexed_bam(tmp_path_factory):
    """A coordinate-sorted BAM with BAI and SBI written by the reference
    (``tests/test_traversal.py``'s fixture); the port's write of the
    same input is byte-identical."""
    d = tmp_path_factory.mktemp("trav")
    records = synth_records(1500, seed=11, unmapped_tail=12)
    raw = str(d / "raw.bam")
    with open(raw, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS, records, blocksize=700))
    out = str(d / "sorted.bam")
    st = R.ReadsStorage.make_default().num_shards(4)
    st.write(st.read(raw), out, R.BaiWriteOption.ENABLE,
             R.SbiWriteOption.ENABLE, sort=True)
    port_out = str(d / "port_sorted.bam")
    pst = P.ReadsStorage.make_default(device="cpu").num_shards(4)
    pst.write(pst.read(raw), port_out, P.BaiWriteOption.ENABLE,
              P.SbiWriteOption.ENABLE, sort=True)
    for ext in ("", ".bai", ".sbi"):
        assert open(out + ext, "rb").read() == \
            open(port_out + ext, "rb").read(), ext
    with open(out, "rb") as f:
        _, _, sorted_recs = parse_bam(f.read())
    return out, sorted_recs


def _expect_overlapping(records, contig_id, beg0, end0):
    return [r.name for r in records if r.refid == contig_id
            and r.pos < end0 and r.pos + max(ref_span(r), 1) > beg0]


def _assert_same(got, want):
    assert got.count == want.count
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def _names(batch):
    return [batch.name(i) for i in range(batch.count)]


def _port(route):
    st = P.ReadsStorage.make_default(device="cpu")
    return st.resident_decode() if route == "resident" else st


def _calls(monkeypatch, module, name):
    """Wrap ``module.name`` to count its calls."""
    seen = []
    fn = getattr(module, name)

    def counted(*a, **k):
        seen.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return seen


def _no_host_inflate(monkeypatch):
    """The chunk decode must not reach a host inflate route."""
    def refuse(*a, **k):
        raise AssertionError("a block was inflated on the host")

    for name in ("inflate_blocks", "inflate_blocks_salvage",
                 "salvage_flagged"):
        monkeypatch.setattr(bam_source, name, refuse)


def _chunks(path, tp):
    """The BAI chunks the traversal decodes (the unmapped tail included)."""
    fs = filesystem.PosixFileSystemWrapper()
    header, _ = bam_source.read_header(fs, path)
    bai = BaiIndex.from_bytes(open(path + ".bai", "rb").read())
    n = len(bai_query.chunks_for_intervals(header, bai, tp.intervals or []))
    return n + (1 if tp.traverse_unplaced_unmapped else 0)


def _traverse(monkeypatch, path, route, intervals, unmapped=False,
              spec=None):
    """(port dataset, reference dataset) of one traversal; on the device
    route the inflate, parse and (with ``spec``) mask calls are checked
    against the chunks decoded."""
    tp = P.TraversalParameters(
        intervals=[P.Interval(*iv) for iv in intervals],
        traverse_unplaced_unmapped=unmapped)
    rtp = R.TraversalParameters(
        intervals=[R.Interval(*iv) for iv in intervals],
        traverse_unplaced_unmapped=unmapped)
    st, rst = _port(route), R.ReadsStorage.make_default()
    if spec is not None:
        st, rst = st.read_filter(spec), rst.read_filter(spec)
    want = rst.read(path, rtp)
    if route == "resident":
        _no_host_inflate(monkeypatch)
        calls = {name: _calls(monkeypatch, mod, fn) for name, mod, fn in (
            ("inflate", inflate_simd, "inflate_plain"),
            ("parse", parse, "parse_records_plain"),
            ("mask", rfilter, "mask_plain"))}
    got = st.read(path, traversal=tp)
    if route == "resident":
        if got.count():
            assert isinstance(got.reads, ColumnarBatch)
            assert got.reads.device_backed
        chunks = _chunks(path, tp)
        assert len(calls["inflate"]) == len(calls["parse"]) == chunks
        assert len(calls["mask"]) == (chunks if spec else 0)
    assert got.counters.as_dict() == want.counters.as_dict() | {
        "wall_seconds": got.counters.wall_seconds}
    _assert_same(got.reads, want.reads)
    return got, want


ROUTES = ["host", "resident"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("contig,start,end", INTERVALS)
def test_interval_query_matches_reference_and_brute_force(
        indexed_bam, monkeypatch, route, contig, start, end):
    path, sorted_recs = indexed_bam
    got, _ = _traverse(monkeypatch, path, route, [(contig, start, end)])
    expect = _expect_overlapping(sorted_recs, NAMES.index(contig),
                                 start - 1, end)
    assert sorted(_names(got.reads)) == sorted(expect)
    assert got.count() > 0


@pytest.mark.parametrize("route", ROUTES)
def test_empty_interval(indexed_bam, monkeypatch, route):
    path, sorted_recs = indexed_bam
    got, _ = _traverse(monkeypatch, path, route, [("chr2", 49_990, 49_999)])
    assert np.all(got.reads.refid == 1) or got.count() == 0
    assert sorted(_names(got.reads)) == sorted(
        _expect_overlapping(sorted_recs, 1, 49_989, 49_999))


@pytest.mark.parametrize("route", ROUTES)
def test_unplaced_unmapped_only(indexed_bam, monkeypatch, route):
    path, sorted_recs = indexed_bam
    got, _ = _traverse(monkeypatch, path, route, [], unmapped=True)
    expect = [r.name for r in sorted_recs if r.refid == -1]
    assert sorted(_names(got.reads)) == sorted(expect)
    assert got.count() == 12


@pytest.mark.parametrize("route", ROUTES)
def test_intervals_plus_unmapped(indexed_bam, monkeypatch, route):
    path, sorted_recs = indexed_bam
    got, _ = _traverse(monkeypatch, path, route, [("chr1", 1, 100_000)],
                       unmapped=True)
    expect = [r.name for r in sorted_recs if r.refid in (0, -1)]
    assert sorted(_names(got.reads)) == sorted(expect)


@pytest.mark.parametrize("route", ROUTES)
def test_missing_bai_raises(tmp_path, route):
    p = str(tmp_path / "noidx.bam")
    with open(p, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS,
                               synth_records(10, with_edge_cases=False)))
    tp = P.TraversalParameters(intervals=[P.Interval("chr1", 1, 10)])
    with pytest.raises(FileNotFoundError, match="bai"):
        _port(route).read(p, tp)


@pytest.mark.parametrize("route", ROUTES)
def test_read_filter_inside_traversal(indexed_bam, monkeypatch, route):
    """The filter applies to every chunk's batch, as in the reference;
    the result is the unfiltered traversal under the same mask."""
    path, sorted_recs = indexed_bam
    ivs = [("chr1", 1, 100_000), ("chr2", 10_000, 30_000)]
    got, _ = _traverse(monkeypatch, path, route, ivs, unmapped=True,
                       spec=FILTER)
    monkeypatch.undo()
    whole, _ = _traverse(monkeypatch, path, "host", ivs, unmapped=True)
    keep = ((whole.reads.flag & 0x904) == 0) & (whole.reads.mapq >= 20)
    assert 0 < got.count() < whole.count()
    _assert_same(got.reads, whole.reads.filter(keep))


def test_resident_traversal_decodes_only_selected_chunks(tmp_path,
                                                         monkeypatch):
    """``tests/test_resident_decode.py``'s interval read: a genuine
    subset, equal to the host path, each chunk parsed on its own."""
    raw = str(tmp_path / "in.bam")
    with open(raw, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS, synth_records(300, seed=17)))
    st = P.ReadsStorage.make_default(device="cpu")
    sorted_path = str(tmp_path / "sorted.bam")
    st.write(st.read(raw).coordinate_sorted(), sorted_path,
             P.BaiWriteOption.ENABLE)
    tp = P.TraversalParameters(intervals=(
        P.Interval(DEFAULT_REFS[0][0], 1, 20_000),))
    host = st.read(sorted_path, traversal=tp)
    parsed = _calls(monkeypatch, parse, "parse_records_plain")
    res = st.resident_decode().read(sorted_path, traversal=tp)
    assert 0 < res.count() < 300
    assert res.reads.device_backed
    _assert_same(res.reads, host.reads)
    ref = R.ReadsStorage.make_default().read(
        sorted_path, traversal=R.TraversalParameters(intervals=(
            R.Interval(DEFAULT_REFS[0][0], 1, 20_000),)))
    _assert_same(res.reads, ref.reads)
    assert len(parsed) == _chunks(sorted_path, tp) >= 1


def test_traversal_read_retries_transients(tmp_path):
    """``tests/test_fault_injection.py``'s case on both packages: the
    seeded transient fault on the sorted BAM's second read fires once,
    is retried whole-phase and counted; the records are the fault-free
    traversal's."""
    path = str(tmp_path / "in.bam")
    with open(path, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS,
                               synth_records(500, seed=7, unmapped_tail=6),
                               blocksize=4000))
    sorted_path = str(tmp_path / "sorted.bam")
    st = R.ReadsStorage.make_default().num_shards(2)
    st.write(st.read(path), sorted_path, R.BaiWriteOption.ENABLE, sort=True)
    out = {}
    for pkg, ff, fsmod, opts in (
            (R, ref_faultfs, ref_filesystem, RefDisqOptions),
            (P, faultfs, filesystem, DisqOptions)):
        faults = [ff.FaultSpec(kind="transient", path_substr="sorted.bam",
                               call_index=2, times=1)]
        fsw = ff.FaultInjectingFileSystemWrapper(
            fsmod.PosixFileSystemWrapper(), faults, seed=5)
        fsmod.register_filesystem("fault", fsw)
        tp = pkg.TraversalParameters(
            intervals=[pkg.Interval("chr1", 1, 100_000)])
        storage = pkg.ReadsStorage.make_default(
            **({"device": "cpu"} if pkg is P else {}))
        ds = storage.options(opts(retry_backoff_s=0.0)).read(
            "fault://" + sorted_path, traversal=tp)
        assert fsw.fired_counts()[0][1] == 1
        assert ds.counters.retried_reads > 0
        assert ds.count() > 0
        out[pkg] = (ds, fsw.injected)
    (got, got_log), (want, want_log) = out[P], out[R]
    fields = ("kind", "op", "path", "start", "length", "call")
    assert [tuple(getattr(i, f) for f in fields) for i in got_log] == \
        [tuple(getattr(i, f) for f in fields) for i in want_log]
    assert got.counters.retried_reads == want.counters.retried_reads
    _assert_same(got.reads, want.reads)
    clean = P.ReadsStorage.make_default(device="cpu").read(
        sorted_path, traversal=P.TraversalParameters(
            intervals=[P.Interval("chr1", 1, 100_000)]))
    _assert_same(got.reads, clean.reads)


# -- CRAM through the CRAI -----------------------------------------------------

@pytest.fixture(scope="module")
def cram_files(tmp_path_factory):
    """The reference's CRAM + CRAI (QS order-0 rANS, 3 write shards) of
    ``tests/test_torch_cram.py``'s reference-matched records, and its
    FASTA; the port writes the same bytes."""
    from disq_tpu.cram.refsource import write_fasta

    mp = pytest.MonkeyPatch()
    for knob in QS_KNOBS:
        mp.setenv(knob, "0")
    try:
        d = tmp_path_factory.mktemp("cramtrav")
        rng = np.random.default_rng(99)
        contigs = [(name, rng.choice(list(b"ACGT"), size).astype(np.uint8)
                    .tobytes()) for name, size in DEFAULT_REFS]
        fa = str(d / "ref.fa")
        write_fasta(ref_filesystem.PosixFileSystemWrapper(), fa, contigs)
        bam = str(d / "in.bam")
        with open(bam, "wb") as f:
            f.write(make_bam_bytes(DEFAULT_REFS,
                                   _synth_ref_matched(dict(contigs)),
                                   sort_order="coordinate"))
        out, port_out = str(d / "t.cram"), str(d / "port.cram")
        st = R.ReadsStorage.make_default().reference_source_path(fa) \
            .num_shards(3)
        st.write(st.read(bam), out, R.CraiWriteOption.ENABLE)
        pst = P.ReadsStorage.make_default(device="cpu") \
            .reference_source_path(fa).num_shards(3)
        pst.write(pst.read(bam), port_out, P.CraiWriteOption.ENABLE)
        for ext in ("", ".crai"):
            assert open(out + ext, "rb").read() == \
                open(port_out + ext, "rb").read(), ext
        whole = st.read(bam).reads
    finally:
        mp.undo()
    return out, fa, whole


def _cram_traverse(monkeypatch, cram_files, route, tp_args):
    path, fa, _ = cram_files
    rst = R.ReadsStorage.make_default().reference_source_path(fa)
    want = rst.read(path, R.TraversalParameters(
        intervals=[R.Interval(*iv) for iv in tp_args[0]],
        traverse_unplaced_unmapped=tp_args[1]))
    st = _port(route).reference_source_path(fa)
    streams = _calls(monkeypatch, rans_simd, "rans0_decode_plain")
    got = st.read(path, P.TraversalParameters(
        intervals=[P.Interval(*iv) for iv in tp_args[0]],
        traverse_unplaced_unmapped=tp_args[1]))
    _assert_same(got.reads, want.reads)
    assert got.counters.as_dict() == want.counters.as_dict() | {
        "wall_seconds": got.counters.wall_seconds}
    # one decode call per container group on the device route: the
    # interval's containers, then the unmapped ones
    groups = int(bool(tp_args[0])) + int(tp_args[1])
    assert len(streams) == (groups if route == "resident" else 0)
    return got


@pytest.mark.parametrize("route", ROUTES)
def test_cram_interval_query_via_crai(cram_files, monkeypatch, route):
    whole = cram_files[2]
    got = _cram_traverse(monkeypatch, cram_files, route,
                         ([("chr1", 1, 50_000)], False))
    ends = whole.alignment_ends()
    mask = (whole.refid == 0) & (whole.pos < 50_000) & (ends > 0)
    assert got.count() == int(mask.sum()) > 0
    kept = whole.filter(mask)
    # CRAM stores no bin (the reader derives it), the rest is the BAM's
    for f in FIELDS:
        if f != "bin":
            np.testing.assert_array_equal(getattr(got.reads, f),
                                          getattr(kept, f), err_msg=f)


@pytest.mark.parametrize("route", ROUTES)
def test_cram_unmapped_traversal(cram_files, monkeypatch, route):
    whole = cram_files[2]
    got = _cram_traverse(monkeypatch, cram_files, route, ([], True))
    assert got.count() == int((whole.refid == -1).sum()) == 6
    got = _cram_traverse(monkeypatch, cram_files, route,
                         ([("chr2", 1, 50_000), ("chrM", 100, 9_000)], True))
    assert np.all(np.isin(got.reads.refid, (1, 2, -1)))


# -- over http:// ---------------------------------------------------------------

def test_interval_reads_over_http(indexed_bam, cram_files, monkeypatch):
    path, _ = indexed_bam
    cram, fa, _ = cram_files
    for name, local in (("/t.bam", path), ("/t.bam.bai", path + ".bai"),
                        ("/t.cram", cram), ("/t.cram.crai", cram + ".crai")):
        _RangeHandler.files[name] = open(local, "rb").read()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _RangeHandler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    fs = HttpFileSystemWrapper()
    monkeypatch.setitem(filesystem._SCHEME_REGISTRY, "http", fs)
    try:
        ivs = [("chr1", 1, 60_000), ("chrM", 1, 16_569)]
        tp = P.TraversalParameters(
            intervals=[P.Interval(*iv) for iv in ivs],
            traverse_unplaced_unmapped=True)
        want = R.ReadsStorage.make_default().read(
            path, R.TraversalParameters(
                intervals=[R.Interval(*iv) for iv in ivs],
                traverse_unplaced_unmapped=True))
        for route in ROUTES:
            local = _port(route).read(path, traversal=tp)
            remote = _port(route).read(base + "/t.bam", traversal=tp)
            assert remote.count() > 0
            _assert_same(remote.reads, local.reads)
            _assert_same(remote.reads, want.reads)
            local = _port(route).reference_source_path(fa).read(cram,
                                                                 traversal=tp)
            remote = _port(route).reference_source_path(fa).read(
                base + "/t.cram", traversal=tp)
            _assert_same(remote.reads, local.reads)
        assert fs.stats.range_requests > 0 and fs.stats.cache_hits > 0
    finally:
        srv.shutdown()
        srv.server_close()
