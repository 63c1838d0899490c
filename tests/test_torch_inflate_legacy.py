"""Kernel B4 (``disq_tpu_torch/ops/inflate.py``) and the legacy read route
against the JAX package, on the CPU.

- The plain version against ``disq_tpu.ops.inflate.inflate_stacked`` in
  interpret mode on every payload of ``ops/inflate_cases.py`` (status,
  good, B4-specific and B4-edge cases, and the edge cases of B1's
  design, whose statuses under B4's rules only the reference says), at
  most 8 per call: bytes, length and status equal; the wrappers' raised
  messages equal.
- The plain version against zlib on 60 KB BGZF-like blocks.
- The legacy read (``DISQ_TPU_DEVICE_INFLATE=legacy`` on the reference,
  ``DISQ_TPU_TORCH_DEVICE_INFLATE=legacy`` with ``.resident_decode()`` on
  the port) column for column, and the CRC-mismatch probe.
- The wrapper's launch rules that the CPU can show: inputs are checked,
  an oversized payload raises before any launch, no other device falls
  back to the plain version.
"""

import gzip
import zlib

import numpy as np
import pytest
import torch

import disq_tpu.api as R
import jax.numpy as jnp
from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
from disq_tpu.ops import inflate as ref_inflate
import disq_tpu_torch as P
from disq_tpu_torch.ops import inflate as B4
from disq_tpu_torch.ops import inflate_cases
from disq_tpu_torch.runtime import counters
from disq_tpu_torch.util import shutdown_shared_host_pool

FIELDS = ("refid", "pos", "mapq", "bin", "flag", "next_refid", "next_pos",
          "tlen", "name_offsets", "names", "cigar_offsets", "cigars",
          "seq_offsets", "seqs", "quals", "tag_offsets", "tags")

# (name, payload, usize, B4's status or None when only the reference says)
CASES = (
    [(n, p, u, None) for n, p, u, _ in inflate_cases.status_cases()]
    + [(n, p, len(d), 0) for n, p, d in inflate_cases.good_cases(3)]
    + [(n + "_unchecked", p, -1, 0) for n, p, d in inflate_cases.good_cases(4)[::3]]
    + inflate_cases.legacy_cases()
    + [(n, p, u, None) for n, p, u, _ in inflate_cases.edge_cases()]
    + inflate_cases.legacy_edge_cases()
)


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


def _ref_stacked(chunk):
    """The JAX kernel (interpret mode) on up to 8 payloads: (out, meta)."""
    comp = np.zeros((8, ref_inflate.CMAX), np.int32)
    cs = np.full(8, 2, np.int32)
    us = np.zeros(8, np.int32)
    comp[:, 0] = 0x03  # empty final fixed block in the unused rows
    for i, (_, p, u, _) in enumerate(chunk):
        comp[i, 0] = 0
        comp[i, :len(p)] = np.frombuffer(p, np.uint8)
        cs[i], us[i] = len(p), u
    out, meta = ref_inflate.inflate_stacked(
        jnp.asarray(comp), jnp.asarray(cs), jnp.asarray(us), interpret=True)
    return np.asarray(out), np.asarray(meta)


@pytest.fixture(scope="module")
def reference_rows():
    """Each case's (bytes, len, status) from the JAX kernel."""
    rows = {}
    for lo in range(0, len(CASES), 8):
        chunk = CASES[lo: lo + 8]
        out, meta = _ref_stacked(chunk)
        for i, (name, *_rest) in enumerate(chunk):
            n = int(meta[i, 0])
            rows[name] = (out[i, :n].astype(np.uint8).tobytes(), n,
                          int(meta[i, 1]))
    return rows


def _port_stacked(cases):
    payloads = [p for _, p, _, _ in cases]
    lens = np.array([len(p) for p in payloads], np.int64)
    off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    blob = np.frombuffer(b"".join(payloads) or b"\0", np.uint8)
    return B4.inflate_stacked(*B4.stage_payloads(
        blob, off, lens, [u for _, _, u, _ in cases], "cpu"))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_equals_jax_kernel(reference_rows, case):
    name, payload, usize, want_status = case
    out, meta = _port_stacked([case])
    n, status = int(meta[0, 0]), int(meta[0, 1])
    ref_bytes, ref_n, ref_status = reference_rows[name]
    assert (n, status) == (ref_n, ref_status)
    assert out[0, :n].numpy().tobytes() == ref_bytes
    assert not out[0, n:].any()  # the rest of the row stays zero
    if want_status is not None:
        assert status == want_status


def test_batched_plain_equals_one_by_one():
    out, meta = _port_stacked(CASES)
    for i, case in enumerate(CASES):
        o1, m1 = _port_stacked([case])
        assert torch.equal(meta[i], m1[0]) and torch.equal(out[i], o1[0])


@pytest.mark.parametrize("which", ["fixed_len_286", "isize_short",
                                   "row_overflow"])
def test_wrapper_raises_the_reference_message(which):
    good = [c for c in CASES if c[3] == 0][:3]
    bad = next(c for c in CASES if c[0] == which)
    batch = good + [bad]
    payloads = [p for _, p, _, _ in batch]
    usizes = [u for _, _, u, _ in batch]
    with pytest.raises(ValueError) as ref_e:
        ref_inflate.inflate_payloads(payloads, usizes=usizes, interpret=True)
    with pytest.raises(ValueError) as got_e:
        B4.inflate_payloads(payloads, usizes=usizes, device="cpu")
    assert str(got_e.value) == str(ref_e.value)
    assert str(got_e.value).startswith("device inflate failed for block 3: ")


def test_payloads_equal_zlib_on_60k_blocks():
    """BGZF-sized payloads: BAM-like, random and low-entropy data at
    zlib levels 0, 1, 6 and 9."""
    rng = np.random.default_rng(11)
    bam = gzip.decompress(make_bam_bytes(DEFAULT_REFS,
                                         synth_records(400, seed=3)))
    raws = [
        bam[-60000:],
        rng.integers(0, 256, 60000, dtype=np.uint8).tobytes(),
        rng.choice(np.frombuffer(b"ACGT", np.uint8), 61000,
                   p=[0.7, 0.1, 0.1, 0.1]).astype(np.uint8).tobytes(),
        bytes(range(256)) * 240,
    ]
    payloads = []
    for raw, level in zip(raws, (6, 0, 9, 1)):
        c = zlib.compressobj(level, zlib.DEFLATED, -15, 8)
        payloads.append(c.compress(raw) + c.flush())
    assert B4.inflate_payloads(payloads, usizes=[len(r) for r in raws],
                               device="cpu") == raws


def test_oversized_payload_raises_before_any_launch():
    big = b"\0" * (B4.CMAX - 7)
    with pytest.raises(ValueError, match="payload 0 exceeds BGZF bound"):
        B4.inflate_payloads([big], device="cpu")
    with pytest.raises(ValueError, match="payload 0 exceeds BGZF bound"):
        ref_inflate.inflate_payloads([big], interpret=True)
    comp, off, cs, us = B4.stage_payloads(
        np.frombuffer(big, np.uint8), [0], [len(big)], None, "cpu")
    with pytest.raises(ValueError, match="exceeds BGZF bound"):
        B4.inflate_stacked(comp, off, cs, us)


def test_inputs_are_checked_and_no_other_device_falls_back():
    comp, off, cs, us = B4.stage_payloads(
        np.frombuffer(b"\x03\x00", np.uint8), [0], [2], [0], "cpu")
    with pytest.raises(ValueError, match="csizes"):
        B4.inflate_stacked(comp, off, cs.long(), us)
    meta_dev = torch.device("meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        B4.inflate_stacked(*(t.to(meta_dev) for t in (comp, off, cs, us)))


# -- the legacy read ------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_bam(tmp_path_factory):
    """About 120 records in 320-byte blocks."""
    path = tmp_path_factory.mktemp("legacy") / "tiny.bam"
    path.write_bytes(make_bam_bytes(
        DEFAULT_REFS, synth_records(120, seed=9, unmapped_tail=6),
        blocksize=320))
    return str(path)


@pytest.fixture(scope="module")
def legacy_pair(tiny_bam):
    mp = pytest.MonkeyPatch()
    mp.setenv("DISQ_TPU_DEVICE_INFLATE", "legacy")
    mp.setenv("DISQ_TPU_TORCH_DEVICE_INFLATE", "legacy")
    try:
        ref = R.ReadsStorage.make_default().split_size(10**9).read(tiny_bam)
        counters.reset()
        got = (P.ReadsStorage.make_default(device="cpu").split_size(10**9)
               .resident_decode().read(tiny_bam))
        snap = counters.snapshot()
    finally:
        mp.undo()
    return ref, got, snap


def test_legacy_read_equals_reference(legacy_pair):
    ref, got, snap = legacy_pair
    assert got.count() == ref.count() > 100
    assert got.reads.device_backed
    for f in FIELDS:
        a, b = getattr(got.reads, f), getattr(ref.reads, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.flagstat() == ref.flagstat()
    # plain versions on the CPU book no launch, and nothing was flagged
    assert snap["launches"] == {} and snap["host_fallback_blocks"] == {}


@pytest.mark.parametrize("split_size", [700, 16000])
def test_legacy_read_is_split_invariant(tiny_bam, legacy_pair, monkeypatch,
                                        split_size):
    _, whole, _ = legacy_pair
    monkeypatch.setenv("DISQ_TPU_TORCH_DEVICE_INFLATE", "legacy")
    got = (P.ReadsStorage.make_default(device="cpu").split_size(split_size)
           .resident_decode().read(tiny_bam))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got.reads, f),
                                      getattr(whole.reads, f), err_msg=f)


def test_legacy_route_crc_mismatch(monkeypatch):
    """The reference's probe: a corrupt CRC byte of the first block."""
    from disq_tpu_torch.bgzf.codec import inflate_blocks_device
    from disq_tpu_torch.bgzf.guesser import find_block_table
    from disq_tpu_torch.fsw.filesystem import MemoryFileSystemWrapper

    monkeypatch.setenv("DISQ_TPU_TORCH_DEVICE_INFLATE", "legacy")
    data = bytearray(make_bam_bytes(DEFAULT_REFS, synth_records(100, seed=9)))
    fs = MemoryFileSystemWrapper()
    fs.write_all("x.bam", bytes(data))
    blocks = [b for b in find_block_table(fs, "x.bam") if b.usize > 0]
    data[blocks[0].pos + blocks[0].csize - 8] ^= 0xFF
    with pytest.raises(ValueError, match="CRC mismatch"):
        inflate_blocks_device(bytes(data), blocks, 0, "cpu")
