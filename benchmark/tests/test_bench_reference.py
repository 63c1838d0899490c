"""The plain reference against the generator and against the program's
own BAI, at small sizes on the CPU."""

import os
import struct
import zlib

import numpy as np
import pytest

from benchmark.generators import reads_bam
from benchmark.reference import bai, bam, compare, sort

REFS = [("chr1", 248956422), ("chr2", 242193529), ("chr3", 198295559)]
N = 6000


@pytest.fixture(scope="module")
def unsorted(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("unsorted"))
    g = reads_bam.draw_bases(reads_bam.synthesize(N, 11, REFS), 11)
    path = os.path.join(work, "in.bam")
    reads_bam.write_bam(path, g, N, REFS)
    return g, path


def test_decode_equals_generator_columns(unsorted):
    g, path = unsorted
    dec = bam.decode_path(path)
    assert dec.count == N and dec.refs == REFS
    for c in bam.FIXED:
        assert np.array_equal(dec.fixed[c], g[c]), c
    rag = dec.ragged(0, N)
    assert np.array_equal(rag["names"].reshape(N, -1), g["names"])
    assert np.array_equal(rag["seqs"].reshape(N, -1), g["seq"])
    assert np.array_equal(rag["quals"].reshape(N, -1), g["qual"])
    assert np.array_equal(rag["tags"].reshape(N, -1), g["tags"])
    want = g["cig"][np.arange(3)[None, :] < g["ncig"][:, None]]
    assert np.array_equal(rag["cigars"], want)
    assert np.array_equal(np.diff(rag["cigar_offsets"]), g["ncig"])


def test_odd_read_length_drops_the_pad_nibble():
    seq = bytes([0x12, 0x34, 0x50])            # 5 bases: 1 2 3 4 5
    name = b"r\0"
    body = struct.pack("<iiBBHHHiiii", 0, 0, len(name), 0, 4680, 0, 4, 5,
                       -1, -1, 0) + name + seq + bytes([30] * 5)
    rec = struct.pack("<i", len(body)) + body
    raw = rec + rec
    start = np.array([0, len(rec)], np.int64)
    pre = bam._flat(np.frombuffer(raw, np.uint8), start,
                    np.full(2, 36)).view(bam.PREFIX)
    fixed = {k: pre[k] for k in bam.PREFIX.names}
    rag = bam.ragged_columns(raw, start, start + len(rec), fixed)
    assert rag["seqs"].tolist() == [1, 2, 3, 4, 5] * 2
    assert rag["names"].tobytes() == b"rr"


def test_bad_crc_raises(unsorted):
    _, path = unsorted
    data = bytearray(open(path, "rb").read())
    blocks = bam.walk_blocks(data)
    p, total, _ = blocks[1]
    data[p + total - 8] ^= 0xFF               # the block's CRC32
    with pytest.raises(ValueError, match="CRC"):
        bam.decode_file(bytes(data))


def test_sort_equals_stable_lexsort(unsorted):
    g, _ = unsorted
    rid = np.where(g["refid"] < 0, np.iinfo(np.int64).max,
                   g["refid"].astype(np.int64))
    want = np.lexsort((g["pos"].astype(np.int64), rid))
    assert np.array_equal(sort.stable_order(g["refid"], g["pos"]), want)


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_bai_and_records_equal_the_programs_write(unsorted, tmp_path, shards):
    """The program's sorted write on the CPU: its records are the
    reference's stable sort of the input, and its BAI passes the
    reference's check and counts the file's records."""
    import disq_tpu_torch as port

    _, path = unsorted
    out = str(tmp_path / "out.bam")
    st = port.ReadsStorage.make_default(device="cpu").split_size(1 << 18) \
        .num_shards(shards)
    st.write(st.read(path), out, port.BaiWriteOption.ENABLE, sort=True)
    src = bam.decode_path(path)
    dec = bam.decode_path(out)
    order = sort.stable_order(src.fixed["refid"], src.fixed["pos"])
    assert compare.mismatched_sorted(src, order, dec) == 0
    index = open(out + ".bai", "rb").read()
    assert bai.violations(dec, index) == 0
    assert bai.record_counts(index) == (
        [int((dec.fixed["refid"] == r).sum()) for r in range(len(REFS))],
        int((dec.fixed["refid"] < 0).sum()))


def _faulty_indexes(dec, index):
    """``index`` with one fault each, as a reader would suffer it."""
    refs, no_coor = bai.parse(index)
    bins, meta, linear = refs[0]
    b = max(bins, key=lambda k: len(bins[k]))
    dropped = dict(bins)
    dropped[b] = bins[b][1:]
    late = linear.copy()
    on0 = np.nonzero(dec.fixed["refid"] == 0)[0]
    late[int(dec.fixed["pos"][on0[len(on0) // 2]]) >> 14] = \
        dec.start_voffsets()[on0[-1]]             # ref 0's last record
    counted = (meta[0], meta[1], meta[2] - 1, meta[3])
    return {
        "chunk_dropped": _encode([(dropped, meta, linear)] + refs[1:],
                                 no_coor),
        "linear_entry_late": _encode([(bins, meta, late)] + refs[1:],
                                     no_coor),
        "mapped_count_wrong": _encode([(bins, counted, linear)] + refs[1:],
                                      no_coor),
        "unplaced_count_wrong": _encode(refs, no_coor + 1),
        "reference_missing": _encode(refs[:-1], no_coor),
        "truncated": index[:len(index) // 2],
    }


def _encode(refs, no_coor) -> bytes:
    out = bytearray(b"BAI\x01" + struct.pack("<i", len(refs)))
    for bins, meta, linear in refs:
        out += struct.pack("<i", len(bins) + (meta is not None))
        for b in sorted(bins):
            out += struct.pack("<Ii", b, len(bins[b]))
            out += np.asarray(bins[b], "<u8").tobytes()
        if meta is not None:
            out += struct.pack("<IiQQQQ", bai.METADATA_BIN, 2, *meta)
        out += struct.pack("<i", len(linear)) + linear.astype("<u8").tobytes()
    return bytes(out + struct.pack("<Q", no_coor))


@pytest.mark.parametrize("fault", ["chunk_dropped", "linear_entry_late",
                                   "mapped_count_wrong",
                                   "unplaced_count_wrong",
                                   "reference_missing", "truncated"])
def test_bai_check_finds_each_fault(unsorted, tmp_path, fault):
    """The program's 3-part index passes; the same index with one fault
    does not, and ``_encode`` gives the index back unchanged."""
    import disq_tpu_torch as port

    _, path = unsorted
    out = str(tmp_path / "out.bam")
    st = port.ReadsStorage.make_default(device="cpu").split_size(1 << 18) \
        .num_shards(3)
    st.write(st.read(path), out, port.BaiWriteOption.ENABLE, sort=True)
    dec = bam.decode_path(out)
    index = open(out + ".bai", "rb").read()
    assert _encode(*bai.parse(index)) == index
    assert bai.violations(dec, index) == 0
    assert bai.violations(dec, _faulty_indexes(dec, index)[fault]) > 0


def test_sorted_config_is_sorted_and_indexes_soundly(tmp_path):
    """A coordinate-sorted configuration's file is in the reference's
    stable order, its reads lie before ``region_end``, and the
    reference's BAI of it, and the program's of the same records written
    in one part, pass the reference's check."""
    import disq_tpu_torch as port

    cfg = {"references": [["chr20", 64444167]], "region_end": 10_000_000,
           "reads": N, "sort_order": "coordinate"}
    info = reads_bam.make(cfg, 3, str(tmp_path))
    dec_in = bam.decode_path(info["path"])
    order = sort.stable_order(dec_in.fixed["refid"], dec_in.fixed["pos"])
    assert (order == np.arange(N)).all()
    assert dec_in.fixed["pos"].max() < 10_000_000
    assert bai.violations(dec_in, bai.build(dec_in)) == 0
    out = str(tmp_path / "again.bam")
    st = port.ReadsStorage.make_default(device="cpu").num_shards(1)
    st.write(st.read(info["path"]), out, port.BaiWriteOption.ENABLE)
    dec_out = bam.decode_path(out)
    assert bai.violations(dec_out, open(out + ".bai", "rb").read()) == 0


def test_generator_is_deterministic(tmp_path):
    cfg = {"references": REFS, "reads": 2000}
    a = reads_bam.make(cfg, 42, str(tmp_path))
    first = open(a["path"], "rb").read()
    b = reads_bam.make(cfg, 42, str(tmp_path))
    assert open(b["path"], "rb").read() == first
    c = reads_bam.make(cfg, 43, str(tmp_path))
    assert open(c["path"], "rb").read() != first


def test_every_block_inflates_with_zlib(unsorted):
    _, path = unsorted
    data = open(path, "rb").read()
    for p, total, hdr in bam.walk_blocks(data):
        raw = zlib.decompress(data[p + hdr: p + total - 8], -15)
        assert len(raw) <= reads_bam.MAX_PAYLOAD
