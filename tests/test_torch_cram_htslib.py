"""The port's CRAM read of files in htslib's layout: attached mates,
every read feature (``X`` through the SM substitution matrix), rANS
order-0 and order-1 blocks, single-symbol HUFFMAN constants. The files
come from the benchmark's generator (``benchmark/generators/
cram_htslib.py``), which also gives the BAM records they stand for (the
truth); the benchmark's plain decoder (``benchmark/reference/cram.py``)
is held to the same truth. The port's column-by-column slice decode is
held against its record-by-record one, and a file of the port's own
writer still decodes as it did."""

import os

import numpy as np
import pytest

import disq_tpu_torch as P
from benchmark.generators import cram_htslib as G
from benchmark.generators import reads_bam
from benchmark.reference import bam as ref_bam
from benchmark.reference import cram as ref_cram
from disq_tpu_torch.cram import assemble, codec
from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime.tracing import REGISTRY

SMALL = {"references": [["chr20", 64444167]], "region_end": 60_000,
         "reads": 3000, "snv_rate": 0.001, "indel_rate": 0.0003,
         "error_rate": 0.002, "insert": [350, 60], "slice_records": 500}
REF_LEN = 4000
CIGAR_OPS = "MIDNSHP=X"


def _storage(ref):
    return P.ReadsStorage.make_default(device="cpu") \
        .reference_source_path(ref).split_size(1 << 16)


def _port_records(path, ref, tmp_path):
    """The port's read of ``path`` written as BAM by the port: the
    records' bytes, and the read's dataset."""
    st = _storage(ref)
    ds = st.read(path)
    out = str(tmp_path / "port.bam")
    st.write(ds, out, P.BaiWriteOption.ENABLE)
    dec = ref_bam.decode_path(out)
    return dec.raw[int(dec.start[0]):int(dec.end[-1])], ds


def _truth_bytes(info):
    return G.bam_records(info["truth"])[0].tobytes()


def _fasta(path):
    with open(path, "rb") as f:
        head = f.readline()
        return {head[1:].split()[0].decode(): f.read().replace(b"\n", b"")}


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    out = {}
    for seed in (7, 2 ** 31 + 99):
        work = str(tmp_path_factory.mktemp(f"gen{seed}"))
        out[seed] = G.make(SMALL, seed, work)
    return out


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 99])
def test_port_decodes_generated_file_to_the_truth(generated, seed, tmp_path):
    info = generated[seed]
    got, ds = _port_records(info["path"], info["reference"], tmp_path)
    assert ds.count() == SMALL["reads"]
    assert got == _truth_bytes(info)


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 99])
def test_plain_decoder_decodes_generated_file_to_the_truth(generated, seed):
    info = generated[seed]
    dec = ref_cram.decode(info["path"], _fasta(info["reference"]))
    assert b"".join(dec["records"]) == _truth_bytes(info)
    assert dec["header_text"] == info["header_text"]


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 99])
def test_columnar_and_record_paths_agree(generated, seed, monkeypatch):
    info = generated[seed]
    st = _storage(info["reference"])
    fast = st.read(info["path"]).reads
    monkeypatch.setattr(assemble, "assemble_slice", lambda *a, **k: None)
    slow = st.read(info["path"]).reads
    for f in ("refid", "pos", "mapq", "bin", "flag", "next_refid",
              "next_pos", "tlen", "name_offsets", "names", "cigar_offsets",
              "cigars", "seq_offsets", "seqs", "quals", "tag_offsets",
              "tags"):
        a, b = getattr(fast, f), getattr(slow, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_generated_file_has_htslib_layout(generated):
    """Most records attached; X features and both rANS orders present;
    QS order-1, RN gzip, the rest order-0; a constant series as a
    single-symbol HUFFMAN."""
    info = generated[7]
    assert info["attached"] > 0.9 * info["records"]
    assert info["features"]["X"] > 0
    blocks = [b for c in ref_cram.walk(info["path"]) for b in c["block_list"]
              if b["type"] == 4]
    by_cid = {}
    for b in blocks:
        by_cid.setdefault(b["cid"], set()).add((b["method"], b["order"]))
    assert by_cid[G.CID["QS"]] == {(4, 1)}
    assert by_cid[G.CID["RN"]] == {(1, None)}
    assert all(m == {(4, 0)} for cid, m in by_cid.items()
               if cid not in (G.CID["QS"], G.CID["RN"]))
    assert G.CID["RL"] not in by_cid          # 150 everywhere: a constant


def test_counters_book_features_mates_and_streams(generated, tmp_path):
    info = generated[7]
    counters.reset()
    REGISTRY.counter("cram.features")._reset()
    REGISTRY.counter("cram.mates")._reset()
    _port_records(info["path"], info["reference"], tmp_path)
    feats = REGISTRY.counter("cram.features")
    for code, n in info["features"].items():
        assert feats.value(code=code) == n, code
    mates = REGISTRY.counter("cram.mates")
    assert mates.value(kind="attached") == info["attached"]
    assert mates.value(kind="detached") == info["records"] - info["attached"]
    snap = counters.snapshot()["host_rans_streams"]
    assert snap["rans1"] == info["containers"]
    assert snap["rans0"] > 0


# -- crafted records, one feature code each ----------------------------------

def _reference(seed=3):
    rng = np.random.default_rng(seed)
    ref = G.BASES[rng.integers(0, 4, REF_LEN)].copy()
    ref[2000:2010] = np.frombuffer(b"NNNNNNNNNN", np.uint8)
    ref[1000:1010] = np.frombuffer(b"AACCGGTTNN", np.uint8)
    return ref


def _cigar(text):
    out, num = [], ""
    for ch in text:
        if ch.isdigit():
            num += ch
        else:
            out.append((int(num) << 4) | CIGAR_OPS.index(ch))
            num = ""
    return out


def _seq_for(ref, pos, cigar, rng):
    """Read bases: the reference through M, random in I and S."""
    seq = []
    at = pos
    for w in cigar:
        op, ln = CIGAR_OPS[w & 0xF], w >> 4
        if op == "M":
            seq += list(ref[at:at + ln])
            at += ln
        elif op in "IS":
            seq += list(G.BASES[rng.integers(0, 4, ln)])
        elif op in "DN":
            at += ln
    return np.array(seq, np.uint8)


def _records(ref, rows, seed=0):
    """Truth columns from ``(pos, cigar, edits, style)`` rows: unpaired
    mapped reads at ``pos`` with the reference's bases but where
    ``edits`` ({read index: base}) say."""
    rng = np.random.default_rng(seed)
    cols = {k: [] for k in ("refid", "pos", "mapq", "bin", "flag",
                            "next_refid", "next_pos", "tlen", "mate",
                            "style")}
    names, cigars, seqs, quals, ncig = [], [], [], [], []
    for i, (pos, cig, edits, style) in enumerate(rows):
        cigar = _cigar(cig)
        seq = _seq_for(ref, pos, cigar, rng)
        for k, b in edits.items():
            seq[k] = ord(b)
        span = sum(w >> 4 for w in cigar if CIGAR_OPS[w & 0xF] in "MDN=X")
        cols["refid"].append(0)
        cols["pos"].append(pos)
        cols["mapq"].append(30 + i)
        cols["bin"].append(int(G.reg2bin(np.array([pos]),
                                         np.array([pos + max(span, 1)]))[0]))
        cols["flag"].append(0x10 if i % 2 else 0)
        cols["next_refid"].append(-1)
        cols["next_pos"].append(-1)
        cols["tlen"].append(0)
        cols["mate"].append(-1)
        cols["style"].append(style)
        names.append(f"r{i:03d}".encode())
        cigars += cigar
        ncig.append(len(cigar))
        seqs.append(seq)
        quals.append(rng.choice(G.QUALS, len(seq)).astype(np.uint8))
    n = len(rows)
    tag = np.frombuffer(b"RGZ" + G.RG_NAME + b"\x00", np.uint8)
    r = {k: np.array(v) for k, v in cols.items()}
    r.update(
        refid=r["refid"].astype(np.int32), pos=r["pos"].astype(np.int32),
        mapq=r["mapq"].astype(np.uint8), bin=r["bin"].astype(np.uint16),
        flag=r["flag"].astype(np.uint16),
        next_refid=r["next_refid"].astype(np.int32),
        next_pos=r["next_pos"].astype(np.int32),
        tlen=r["tlen"].astype(np.int32), style=r["style"].astype(np.uint8),
        names=np.frombuffer(b"".join(names), np.uint8),
        name_off=G.offsets([len(x) for x in names]),
        cigars=np.array(cigars, np.uint32), cig_off=G.offsets(ncig),
        seqs=np.concatenate(seqs), seq_off=G.offsets([len(x) for x in seqs]),
        quals=np.concatenate(quals), tags=np.tile(tag, n),
        tag_off=G.offsets(np.full(n, len(tag))))
    return r


FEATURE_ROWS = {
    "b": [(100, "50M", {}, G.STYLE_B), (300, "10S40M", {}, G.STYLE_B)],
    # B: a base neither A, C, G, T nor N, and an N over an IUPAC code
    "B": [(1995, "30M", {1: "R", 8: "Y"}, 0)],
    # every substitution X can carry: over A, C, G, T (to the other three
    # and to N) and over N (to A, C, G, T)
    "X": [(1000, "10M", {0: "C", 1: "N", 2: "A", 3: "T", 4: "T", 5: "N",
                          6: "G", 7: "N", 8: "A", 9: "C"}, 0),
          (1000, "10M", {0: "G", 1: "T", 2: "G", 3: "N", 4: "A", 5: "C",
                         6: "A", 7: "C", 8: "G", 9: "T"}, 0),
          (1000, "10M", {0: "N", 2: "T", 4: "C", 6: "C"}, 0)],
    "I": [(500, "20M5I25M", {}, 0)],
    "i": [(600, "20M1I29M", {}, 0)],
    "D": [(700, "20M3D30M", {}, 0)],
    "N": [(800, "20M100N30M", {}, 0)],
    "S": [(900, "5S40M5S", {}, 0)],
    "H": [(1100, "7H50M3H", {}, 0)],
    "P": [(1200, "25M2P25M", {}, 0)],
    "q": [(1300, "40M", {}, G.STYLE_LOSSY)],
    "Q": [(1400, "50M", {}, G.STYLE_LOSSY)],
}


@pytest.mark.parametrize("code", list(FEATURE_ROWS))
def test_each_feature_code_decodes_to_the_truth(code, tmp_path):
    ref = _reference()
    r = _records(ref, sorted(FEATURE_ROWS[code] + [(50, "60M", {3: "G"}, 0)],
                             key=lambda row: row[0]))
    path = str(tmp_path / "f.cram")
    fa = str(tmp_path / "ref.fa")
    G.write_fasta(fa, "chr20", ref)
    info = G.write_cram(path, [("chr20", REF_LEN)], {"chr20": ref}, r)
    assert info["features"].get(code, 0) > 0, info["features"]
    got, _ = _port_records(path, fa, tmp_path)
    truth = _truth_bytes(info)
    assert got == truth
    dec = ref_cram.decode(path, {"chr20": ref.tobytes()})
    assert b"".join(dec["records"]) == truth


def test_x_over_every_reference_base_and_n(tmp_path):
    """The X rows' substitutions cover each reference base's row of the
    matrix, N's included, and every code of each row is used."""
    ref = _reference()
    r = _records(ref, FEATURE_ROWS["X"])
    f = G.features(r, ref)
    x = f["code"] == ord("X")
    pairs = {(int(v) // 256, int(v) % 256) for v in f["val"][x]}
    for row, base in enumerate(b"ACGTN"):
        subs = {s for rr, s in pairs if rr == row}
        assert subs == set(b"ACGTN") - {base}, (chr(base), subs)


def test_substitution_matrix_not_in_identity_order(tmp_path):
    """A forced SM whose codes run backwards: the port reads the SM
    entry as that table and decodes the X bases through it."""
    sm = np.zeros((5, 5), np.int64)
    for row in range(5):
        others = [s for s in range(5) if s != row]
        for code, s in enumerate(reversed(others)):
            sm[row, s] = code
    raw = G.sm_bytes(sm)
    assert raw != G.sm_bytes(G.sm_by_frequency(np.zeros((5, 5))))
    table = codec.substitution_table(raw)
    for row, base in enumerate(b"ACGTN"):
        others = [b for b in b"ACGTN" if b != base]
        assert table[row].tolist() == list(reversed(others))
    ref = _reference()
    r = _records(ref, FEATURE_ROWS["X"])
    path = str(tmp_path / "sm.cram")
    fa = str(tmp_path / "ref.fa")
    G.write_fasta(fa, "chr20", ref)
    info = G.write_cram(path, [("chr20", REF_LEN)], {"chr20": ref}, r, sm=sm)
    got, _ = _port_records(path, fa, tmp_path)
    assert got == _truth_bytes(info)


# -- mates --------------------------------------------------------------------

def test_pairs_across_a_slice_edge_are_detached(tmp_path):
    """Slices of 97 records: pairs whose mates fall in two slices are
    detached, the rest attached, among them pairs with one mate unmapped
    and placed at its partner; the port rebuilds every mate field."""
    cfg = dict(SMALL, reads=2000, slice_records=97, region_end=30_000)
    info = G.make(cfg, 11, str(tmp_path))
    r = info["truth"]
    slice_of = np.searchsorted(info["slices"], np.arange(len(r["refid"])),
                               side="right") - 1
    lay = G.mate_layout(r, slice_of)
    mate = r["mate"]
    across = slice_of != slice_of[mate]
    assert across.any() and not lay["attached"][across].any()
    placed = ((r["flag"] & 4) != 0) & (r["refid"] >= 0)
    assert (lay["attached"] & placed).any()
    assert (lay["attached"] & (r["tlen"] != 0)).any()
    got, _ = _port_records(info["path"], info["reference"], tmp_path)
    assert got == _truth_bytes(info)


def test_attached_mate_past_the_slice_is_corrupt():
    n = 2
    with pytest.raises(ValueError, match="past the end of its slice"):
        assemble._mates(np.array([1]), np.array([3]), n, np.zeros(n),
                        np.zeros(n), np.ones(n), np.zeros(n, np.int64),
                        np.zeros(n), np.zeros(n), np.zeros(n))


# -- the port's own files and other layouts -----------------------------------

@pytest.fixture(scope="module")
def port_cram(tmp_path_factory):
    """A CRAM of the port's own writer, with the reference, from a small
    paired BAM (unmapped and unplaced reads included)."""
    d = tmp_path_factory.mktemp("own")
    refs = [("chr20", 300_000)]
    ref = _reference(5)
    ref = np.resize(ref, 300_000)
    ref[ref == ord("N")] = ord("A")
    fa = str(d / "ref.fa")
    G.write_fasta(fa, "chr20", ref)
    info = reads_bam.make({"references": refs, "reads": 1200,
                           "sort_order": "coordinate", "region_end": 250_000},
                          4, str(d))
    st = _storage(fa)
    out = str(d / "own.cram")
    st.write(st.read(info["path"]), out)
    return out, fa


@pytest.mark.parametrize("core", [False, True], ids=["external", "core"])
def test_port_writer_file_decodes_as_before(port_cram, tmp_path, monkeypatch,
                                            core):
    """Column by column (the external layout) or record by record (CORE
    bit codecs, which the columnar decode declines), a file of the
    port's writer reads as the record-by-record decode reads it, and
    writes back byte for byte."""
    path, fa = port_cram
    if core:
        monkeypatch.setenv("DISQ_TPU_TORCH_CRAM_CORE", "1")
        st = _storage(fa)
        path = str(tmp_path / "core.cram")
        st.write(st.read(port_cram[0]), path)
    st = _storage(fa)
    calls = []
    real = assemble.assemble_slice

    def spy(*a, **k):
        got = real(*a, **k)
        calls.append(got is not None)
        return got

    monkeypatch.setattr(assemble, "assemble_slice", spy)
    fast = st.read(path)
    assert calls and all(c != core for c in calls)
    monkeypatch.setattr(assemble, "assemble_slice", lambda *a, **k: None)
    slow = st.read(path)
    for f in ("flag", "tlen", "next_pos", "bin", "cigars", "seqs", "quals",
              "tags", "names"):
        np.testing.assert_array_equal(getattr(fast.reads, f),
                                      getattr(slow.reads, f), err_msg=f)
    again = str(tmp_path / "again.cram")
    st.write(fast, again)
    redo = str(tmp_path / "redo.cram")
    st.write(slow, redo)
    assert open(again, "rb").read() == open(redo, "rb").read()


@pytest.mark.parametrize("values", [
    [0, 1, 127], [128, 16383, 16384, 2 ** 21 - 1, 2 ** 21],
    [2 ** 28 - 1, 2 ** 28, 2 ** 31 - 1, -1, -5, -(2 ** 31)],
    list(range(0, 300000, 7))])
def test_itf8_values_equal_the_scalar_reader(values):
    from disq_tpu_torch.cram.io import Cursor, write_itf8

    data = b"".join(write_itf8(v) for v in values)
    got = assemble.itf8_values(data, len(values))
    cur = Cursor(data)
    assert got.tolist() == [cur.itf8() for _ in values] == values
    with pytest.raises(assemble._Decline):
        assemble.itf8_values(data, len(values) - 1)
    with pytest.raises(assemble._Decline):
        assemble.itf8_values(data + b"\x01", len(values))


def test_missing_reference_raises(generated):
    info = generated[7]
    st = P.ReadsStorage.make_default(device="cpu")
    with pytest.raises(Exception, match="reference"):
        st.read(info["path"])
    assert os.path.exists(info["path"])
