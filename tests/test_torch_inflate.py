"""The port's inflate (kernel B1's plain version) against the JAX package.

The same raw-DEFLATE payloads go through ``disq_tpu``'s 128-lane Pallas
inflate kernel (interpret mode on the CPU) and through
``disq_tpu_torch.ops.inflate_simd.inflate`` on CPU tensors: decoded bytes
on well-formed payloads, and status codes (the reference kernel's meta
row 1) on payloads built to fail. Blocks of about 60 KB, above the
reference kernel's device cap, are held against zlib alone. Every value
is a byte or an integer, so every comparison is exact.
"""

import re
import zlib

import numpy as np
import pytest
import torch

from bam_oracle import encode_record, synth_records
from disq_tpu.ops import inflate as ref_tables
from disq_tpu.ops import inflate_simd as ref_simd
from disq_tpu_torch.ops import cuda_build
from disq_tpu_torch.ops import inflate_cases as cases
from disq_tpu_torch.ops import inflate_simd as B1
from disq_tpu_torch.runtime import counters


def _args(payloads, usizes):
    """CPU kernel inputs for ``payloads`` laid end to end."""
    pay_len = np.array([len(p) for p in payloads], np.int64)
    pay_off = np.concatenate([[0], np.cumsum(pay_len)[:-1]]).astype(np.int64)
    out_off = np.concatenate([[0], np.cumsum(usizes)]).astype(np.int64)
    comp = torch.frombuffer(bytearray(b"".join(payloads) or b"\0"),
                            dtype=torch.uint8)
    return (comp, torch.from_numpy(pay_off), torch.from_numpy(pay_len),
            torch.from_numpy(out_off)), int(out_off[-1])


def _port(payloads, usizes):
    """(per-payload bytes, out_len, status) from the port's plain path."""
    args, total = _args(payloads, usizes)
    out, out_len, status = B1.inflate(*args, total)
    oo = args[3].numpy()
    got = [out[oo[i]: oo[i] + int(out_len[i])].numpy().tobytes()
           for i in range(len(payloads))]
    return got, out_len.numpy(), status.numpy()


# -- constant tables ----------------------------------------------------------


@pytest.mark.parametrize("name", ["_LBASE", "_LEXT", "_DBASE", "_DEXT",
                                  "_CLORDER", "_FIXED_LENS"])
def test_tables_equal_reference(name):
    np.testing.assert_array_equal(getattr(B1, name),
                                  getattr(ref_tables, name))


@pytest.mark.parametrize("table,name,n", [
    ("c_lbase", "_LBASE", 29), ("c_lext", "_LEXT", 29),
    ("c_dbase", "_DBASE", 30), ("c_dext", "_DEXT", 30),
    ("c_clorder", "_CLORDER", 19)])
def test_cuda_source_tables_equal_reference(table, name, n):
    """The kernel's __constant__ tables, read from the text of its source
    and the headers it includes."""
    src = ""
    for path in cuda_build.sources("inflate"):
        with open(path) as f:
            src += f.read()
    body = re.search(table + r"\[\d+\]\s*=\s*\{([^}]*)\}", src).group(1)
    got = [int(v) for v in body.replace("\n", " ").split(",") if v.strip()]
    np.testing.assert_array_equal(got, getattr(ref_tables, name)[:n])


# -- against the JAX kernel ---------------------------------------------------


@pytest.fixture(scope="module")
def good():
    return cases.good_cases(seed=4)


@pytest.fixture(scope="module")
def jax_good(good):
    payloads = [p for _, p, _ in good]
    return ref_simd.inflate_payloads_simd(
        payloads, usizes=[len(d) for _, _, d in good], interpret=True)


@pytest.fixture(scope="module")
def jax_status():
    """Per-case status from the JAX kernel's meta row 1 (status 8, the
    ISIZE check, is the reference's host step after the kernel)."""
    bad = cases.status_cases()
    payloads = [p for _, p, _, _ in bad]
    cw, ow = ref_simd.buckets_for(payloads, max(u for _, _, u, _ in bad))
    comp, clen = ref_simd._pack_chunk(payloads, cw)
    _words, meta = ref_simd._compiled(cw, ow, True)(
        comp, clen, *ref_simd._CONST_TABLES)
    meta = np.asarray(meta)
    out = []
    for j, (_, _, usize, _) in enumerate(bad):
        st = int(meta[1, j])
        if st == 0 and int(meta[0, j]) != usize:
            st = B1.ISIZE_MISMATCH
        out.append(st)
    return out


def test_good_payloads_decode_like_jax_kernel(good, jax_good):
    got, out_len, status = _port([p for _, p, _ in good],
                                 [len(d) for _, _, d in good])
    assert status.tolist() == [0] * len(good)
    for (name, _, data), g, j in zip(good, got, jax_good):
        assert g == j == data, name
    assert out_len.tolist() == [len(d) for _, _, d in good]


def test_good_cases_cover_every_block_type(good):
    names = {n.rsplit("_", 1)[1] for n, _, _ in good if "_" in n}
    assert {"l1", "l6", "l9", "fixed", "stored"} <= names


def test_status_codes_equal_jax_kernel(jax_status):
    bad = cases.status_cases()
    _, _, status = _port([p for _, p, _, _ in bad],
                         [u for _, _, u, _ in bad])
    assert status.tolist() == jax_status
    assert status.tolist() == [e for _, _, _, e in bad]
    assert set(status.tolist()) == set(range(1, 9))


@pytest.mark.parametrize("i", range(len(cases.status_cases())))
def test_each_status_case_alone(i):
    """Faults do not depend on the neighbouring blocks of a launch."""
    name, payload, usize, want = cases.status_cases()[i]
    _, _, status = _port([payload], [usize])
    assert int(status[0]) == want, name


# -- the edges of a table-driven, warp-cooperative decoder --------------------


EDGE = cases.edge_cases()


@pytest.fixture(scope="module")
def jax_edges():
    """The JAX kernel on every edge case in one launch: (decoded bytes,
    status from its meta row 1, its lane capacity in bytes)."""
    payloads = [p for _, p, _, _ in EDGE]
    cw, ow = ref_simd.buckets_for(payloads, max(u for _, _, u, _ in EDGE))
    comp, clen = ref_simd._pack_chunk(payloads, cw)
    words, meta = ref_simd._compiled(cw, ow, True)(
        comp, clen, *ref_simd._CONST_TABLES)
    words, meta = np.asarray(words), np.asarray(meta)
    return [(words[:, j].astype("<u4").tobytes()[: int(meta[0, j])],
             int(meta[1, j]), 4 * ow) for j in range(len(EDGE))]


@pytest.mark.parametrize("i", range(len(EDGE)))
def test_edge_case_status(i):
    """Each edge case decodes to its expected status; a well-formed one
    decodes to zlib's bytes."""
    name, payload, usize, want = EDGE[i]
    (got,), out_len, status = _port([payload], [usize])
    assert int(status[0]) == want, name
    assert int(out_len[0]) == len(got)
    if want == 0 and name != "oversubscribed":   # zlib rejects that set
        assert got == zlib.decompress(payload, -15), name


def test_edge_cases_equal_jax_kernel(jax_edges):
    """The plain version equals the JAX kernel on every edge case at the
    JAX kernel's capacity (its lane buffer, where the port's capacity is
    the block's ISIZE; the kernel leaves the ISIZE check, status 8, to
    its host side); at the true ISIZE it sees the same bytes."""
    for (name, payload, usize, _), (j_bytes, j_status, lane_cap) in zip(
            EDGE, jax_edges):
        got, status = B1.inflate_raw(payload, lane_cap)
        assert got == j_bytes, name
        assert status == j_status or (status, j_status) == (8, 0), name
        at_isize, _ = B1.inflate_raw(payload, usize)
        assert j_bytes[: len(at_isize)] == at_isize, name


def test_edge_cases_in_one_launch():
    """The edge cases beside each other decode as they do alone, and
    cover the lit/len and distance codes longer than a table width."""
    got, out_len, status = _port([p for _, p, _, _ in EDGE],
                                 [u for _, _, u, _ in EDGE])
    assert status.tolist() == [w for _, _, _, w in EDGE]
    for (name, payload, usize, _), g in zip(EDGE, got):
        assert g == B1.inflate_raw(payload, usize)[0], name
    assert {"long_codes", "gap_above_width", "oversubscribed"} <= \
        {n for n, _, _, _ in EDGE}


# -- large blocks against zlib ------------------------------------------------


@pytest.fixture(scope="module")
def bam_like():
    raw = b"".join(encode_record(r) for r in synth_records(450, seed=6))
    return raw[:60000]


def test_60kb_blocks_equal_zlib(bam_like):
    """Full-size BGZF payloads (over the reference kernel's 32,752-byte
    device cap) at zlib levels 1, 6, 9 and stored, in one launch."""
    payloads = []
    for level in (1, 6, 9, 0):
        c = zlib.compressobj(level, zlib.DEFLATED, -15, 8)
        payloads.append(c.compress(bam_like) + c.flush())
    assert max(len(p) for p in payloads) > ref_simd.MAX_DEVICE_CSIZE
    got, out_len, status = _port(payloads, [len(bam_like)] * 4)
    assert status.tolist() == [0] * 4
    for p, g in zip(payloads, got):
        assert g == zlib.decompress(p, -15) == bam_like


def test_each_block_lands_at_its_offset(bam_like):
    parts = [bam_like[:7000], b"", bam_like[7000:7001], bam_like[100:30000]]
    payloads = []
    for k, data in enumerate(parts):
        c = zlib.compressobj(1 + 4 * (k % 3), zlib.DEFLATED, -15, 8)
        payloads.append(c.compress(data) + c.flush())
    args, total = _args(payloads, [len(d) for d in parts])
    out, _, status = B1.inflate(*args, total)
    assert status.tolist() == [0] * len(parts)
    assert out.numpy().tobytes() == b"".join(parts)


# -- the wrapper --------------------------------------------------------------


def test_cpu_inflate_books_no_launch(good):
    before = counters.snapshot()["launches"].get("inflate", 0)
    _port([good[0][1]], [len(good[0][2])])
    assert counters.snapshot()["launches"].get("inflate", 0) == before


@pytest.mark.parametrize("bad", ["comp_dtype", "off_dtype", "count",
                                 "strided", "device"])
def test_rejects_what_the_kernel_does_not_take(bad, good):
    args, total = _args([good[0][1]], [len(good[0][2])])
    comp, po, pl, oo = args
    if bad == "comp_dtype":
        comp = comp.to(torch.int32)
    elif bad == "off_dtype":
        po = po.to(torch.int32)
    elif bad == "count":
        oo = oo[:1].contiguous()
    elif bad == "strided":
        comp = torch.zeros(2 * comp.numel(), dtype=torch.uint8)[::2]
    else:
        comp, po, pl, oo = (t.to("meta") for t in (comp, po, pl, oo))
    with pytest.raises(ValueError):
        B1.inflate(comp, po, pl, oo, total)


def test_device_route_raises_on_a_flagged_block(bam_like):
    """The host side of the device route: a block the kernel flags is
    corrupt input and raises, naming the block and its status."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 8)
    good_p = c.compress(bam_like[:5000]) + c.flush()
    bad_p = good_p[: len(good_p) // 3]
    data = np.frombuffer(good_p + bad_p, np.uint8)
    pay_off = np.array([0, len(good_p)], np.int64)
    pay_len = np.array([len(good_p), len(bad_p)], np.int64)
    before = dict(B1.last_stats)
    with pytest.raises(ValueError, match="block 1: status 6"):
        B1.inflate_payloads_device(data, pay_off, pay_len,
                                   np.array([5000, 5000]), "cpu")
    assert B1.last_stats["host_fallback"] == before["host_fallback"] + 1
    assert B1.last_stats["host_big"] == before["host_big"]


def test_device_route_blob_and_offsets(bam_like):
    parts = [bam_like[:20000], bam_like[20000:]]
    payloads = [zlib.compress(d, 6)[2:-4] for d in parts]
    data = np.frombuffer(b"".join(payloads), np.uint8)
    blob, out_off = B1.inflate_payloads_device(
        data, np.array([0, len(payloads[0])], np.int64),
        np.array([len(p) for p in payloads], np.int64),
        np.array([len(d) for d in parts]), "cpu")
    assert blob.dtype == torch.uint8 and blob.device.type == "cpu"
    assert out_off.tolist() == [0, 20000, len(bam_like)]
    assert blob.numpy().tobytes() == bam_like
