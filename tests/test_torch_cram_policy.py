"""The port's CRAM read as users configure it, on the CPU, against the JAX package.

The fixture is ``tests/test_torch_cram.py``'s, at 2,000 mapped reads
plus 6 unmapped: the reference writes them as CRAM with the FASTA at 3
write shards, quality scores as order-0 rANS, and both packages read it
at 4 KiB splits (34 splits, 6 data containers). Each case runs on the
port's host route and on its resident route (the rANS kernels' plain
versions) and holds the port to the reference:

- the clean file's ``ds.counters``, field by field (``wall_seconds``
  aside);
- one byte flipped mid-payload in data container 1: ``strict`` raises
  ``CorruptBlockError`` with the container's offset, ``skip`` drops that
  container and counts it, ``quarantine`` also writes the same manifest
  entry and sidecar bytes (the container's header and payload);
- an order-0 QS stream cut short (its CRCs rewritten): only the rANS
  decode notices, and ``skip`` drops exactly that container;
- a container header that no longer parses, in the walk or at the
  split's own read: it goes to the policy;
- ``.executor_workers(4)`` equal to ``(1)``; seeded transient read
  faults retried, counted and leaving the records unchanged.
"""

import json
import os

import numpy as np
import pytest

from bam_oracle import DEFAULT_REFS, make_bam_bytes
import disq_tpu.api as R
from disq_tpu.cram.refsource import write_fasta as ref_write_fasta
from disq_tpu.fsw import FaultInjectingFileSystemWrapper as RefFaultFS
from disq_tpu.fsw import FaultSpec as RefFaultSpec
from disq_tpu.fsw import PosixFileSystemWrapper as RefPosix
from disq_tpu.fsw import register_filesystem as ref_register
from disq_tpu.runtime.errors import CorruptBlockError as RefCorruptBlockError
from disq_tpu.runtime.errors import DisqOptions as RefOptions
from disq_tpu.runtime.errors import ErrorPolicy as RefPolicy
import disq_tpu_torch as P
from disq_tpu_torch.cram.rans import rans0_decode_streams, rans_encode_order0
from disq_tpu_torch.fsw.faultfs import FaultInjectingFileSystemWrapper, FaultSpec
from disq_tpu_torch.fsw.filesystem import PosixFileSystemWrapper, register_filesystem
from disq_tpu_torch.ops import rans_cases
from disq_tpu_torch.runtime.errors import CorruptBlockError, DisqOptions, ErrorPolicy
from test_torch_rans import _with_state
from test_torch_cram import (
    _assert_same_reads,
    _data_container,
    _qs_order,
    _synth_ref_matched,
    _truncate_qs_stream,
)

SPLIT = 4096
ROUTES = ["host", "resident"]
POLICIES = ["strict", "skip", "quarantine"]


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """A FASTA (+ .fai) matching DEFAULT_REFS, as ``test_torch_cram``'s."""
    rng = np.random.default_rng(99)
    contigs = [
        (name, rng.choice(list(b"ACGT"), size).astype(np.uint8).tobytes())
        for name, size in DEFAULT_REFS
    ]
    path = str(tmp_path_factory.mktemp("ref") / "ref.fa")
    ref_write_fasta(RefPosix(), path, contigs)
    return path, dict(contigs)


@pytest.fixture(scope="module")
def cram(fasta, tmp_path_factory):
    """The reference's CRAM of 2,006 records (3 write shards, QS order-0)."""
    d = tmp_path_factory.mktemp("cram_policy")
    bam, out = str(d / "in.bam"), str(d / "in.cram")
    with open(bam, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS, _synth_ref_matched(fasta[1], n=2000),
                               sort_order="coordinate"))
    mp = pytest.MonkeyPatch()
    try:
        _qs_order(mp, "o0")
        st = R.ReadsStorage.make_default().reference_source_path(fasta[0]) \
            .num_shards(3)
        st.write(st.read(bam), out, R.CraiWriteOption.ENABLE)
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def flipped(cram, tmp_path_factory):
    """``cram`` with one byte flipped mid-payload in data container 1:
    (path, container offset, the container's bytes as flipped)."""
    off, hdr_size, payload = _data_container(cram)
    data = bytearray(open(cram, "rb").read())
    data[off + hdr_size + len(payload) // 2] ^= 0x5A
    path = str(tmp_path_factory.mktemp("flipped") / "flipped.cram")
    with open(path, "wb") as f:
        f.write(bytes(data))
    return path, off, bytes(data[off: off + hdr_size + len(payload)])


def _options(cls, policy_cls, policy, qdir=None, workers=1, retries=3):
    kw = dict(error_policy=policy_cls.coerce(policy), max_retries=retries,
              retry_backoff_s=0.0, quarantine_dir=qdir)
    if workers != 1:
        kw["executor_workers"] = workers
    return cls(**kw)


def _ref_read(path, fasta, policy="strict", qdir=None):
    return (R.ReadsStorage.make_default().reference_source_path(fasta[0])
            .split_size(SPLIT)
            .options(_options(RefOptions, RefPolicy, policy, qdir))
            .read(path))


def _port_read(path, fasta, route, policy="strict", qdir=None, workers=1,
               retries=3):
    return (P.ReadsStorage.make_default(device="cpu")
            .reference_source_path(fasta[0]).split_size(SPLIT)
            .options(_options(DisqOptions, ErrorPolicy, policy, qdir,
                              workers, retries))
            .resident_decode(route == "resident").read(path))


def _counts(ds):
    d = ds.counters.as_dict()
    del d["wall_seconds"]
    return d


def _names(batch):
    off = batch.name_offsets
    return [batch.names[off[i]: off[i + 1]].tobytes()
            for i in range(batch.count)]


def _manifest(qdir):
    with open(os.path.join(qdir, "MANIFEST.jsonl")) as f:
        return [json.loads(ln) for ln in f.read().splitlines()]


def _comparable(entry, qdir):
    e = dict(entry)
    del e["run_id"]
    e["sidecar"] = os.path.relpath(e["sidecar"], qdir)
    return e


def _same_quarantine(port_q, ref_q):
    """Both manifests hold the same entries (run ids and the directory
    aside) and each sidecar the same bytes; returns the port's entries."""
    got, want = _manifest(port_q), _manifest(ref_q)
    assert got[0] == want[0] == {"version": 1}
    assert [_comparable(e, port_q) for e in got[1:]] == \
        [_comparable(e, ref_q) for e in want[1:]]
    for g, w in zip(got[1:], want[1:]):
        assert open(g["sidecar"], "rb").read() == open(w["sidecar"], "rb").read()
    return got[1:]


@pytest.mark.parametrize("route", ROUTES)
def test_clean_counters_equal_reference(cram, fasta, route):
    want = _ref_read(cram, fasta)
    got = _port_read(cram, fasta, route)
    _assert_same_reads(got.reads, want.reads)
    assert _counts(got) == _counts(want)
    c = got.counters
    assert (c.shards, c.records, c.blocks, c.bytes_compressed) == \
        (34, 2006, 6, 138646)
    assert c.wall_seconds > 0


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("route", ROUTES)
def test_flipped_payload_byte_like_reference(flipped, fasta, route, policy,
                                             tmp_path):
    path, off, container = flipped
    if policy == "strict":
        with pytest.raises(RefCorruptBlockError, match="CRC mismatch") as want:
            _ref_read(path, fasta)
        with pytest.raises(CorruptBlockError, match="CRC mismatch") as got:
            _port_read(path, fasta, route)
        assert got.value.block_offset == want.value.block_offset == off
        assert str(got.value) == str(want.value)
        return
    rq, pq = str(tmp_path / "ref_q"), str(tmp_path / "port_q")
    want = _ref_read(path, fasta, policy, rq)
    got = _port_read(path, fasta, route, policy, pq)
    _assert_same_reads(got.reads, want.reads)
    assert got.count() == 2003
    assert _counts(got) == _counts(want)
    counted = "skipped_blocks" if policy == "skip" else "quarantined_blocks"
    assert getattr(got.counters, counted) == 1
    if policy == "quarantine":
        [entry] = _same_quarantine(pq, rq)
        assert entry["block_offset"] == off and entry["kind"] == "CRAM container"
        assert open(entry["sidecar"], "rb").read() == container


@pytest.mark.parametrize("route", ROUTES)
def test_truncated_rans_stream_drops_only_its_container(cram, fasta, route,
                                                        tmp_path):
    bad = str(tmp_path / "short_qs.cram")
    off = _truncate_qs_stream(cram, bad)
    want = _ref_read(bad, fasta, "skip")
    got = _port_read(bad, fasta, route, "skip")
    _assert_same_reads(got.reads, want.reads)
    assert _counts(got) == _counts(want)
    assert got.counters.skipped_blocks == 1
    # exactly that container's records are gone: one run of the clean
    # read's records, the rest in order
    clean = _names(_port_read(cram, fasta, route).reads)
    kept = _names(got.reads)
    lost = [i for i, name in enumerate(clean) if name not in set(kept)]
    assert lost == list(range(lost[0], lost[0] + len(lost)))
    assert kept == clean[:lost[0]] + clean[lost[-1] + 1:]
    msg = "overran stream" if route == "resident" else "rANS decode failed"
    with pytest.raises(CorruptBlockError, match=msg) as e:
        _port_read(bad, fasta, route)
    assert e.value.block_offset == off


def test_flagged_and_unparsed_streams_mark_only_themselves():
    """The device route's batch under skip or quarantine: a stream that
    fails its host parse stays out of the launch, a stream the kernel
    flags is reported, and every other stream keeps its output."""
    raws = [bytes(range(200)) * 7, b"abcd" * 50, b"", b"abc" * 500]
    streams = [rans_encode_order0(r) for r in raws]
    streams[1] = _with_state(100)   # a state word below 2^23
    streams.append(rans_cases.truncated(rans_encode_order0(raws[0]), 40))
    for legacy in (False, True):
        mp = pytest.MonkeyPatch()
        if legacy:
            mp.setenv("DISQ_TPU_TORCH_DEVICE_RANS", "legacy")
        try:
            bad = {}
            out = rans0_decode_streams(streams, "cpu", bad)
            with pytest.raises(ValueError, match="stream 1") as strict:
                rans0_decode_streams(streams, "cpu")
        finally:
            mp.undo()
        assert out == [raws[0], None, b"", raws[3], None]
        assert sorted(bad) == [1, 4]
        assert str(bad[1]) == str(strict.value)
        assert "overran stream 4" in str(bad[4]) and bad[4].stream == 4


def _header_fill(cram, dst, index=2):
    """``cram`` with data container ``index``'s leading header varints
    0xFF-filled (the walk's parse overruns and raises); its offset."""
    off = _data_container(cram, index)[0]
    data = bytearray(open(cram, "rb").read())
    data[off: off + 8] = b"\xff" * 8
    with open(dst, "wb") as f:
        f.write(bytes(data))
    return off


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("route", ROUTES)
def test_unreadable_container_header_goes_to_policy(cram, fasta, route,
                                                    policy, tmp_path):
    bad = str(tmp_path / "bad_header.cram")
    off = _header_fill(cram, bad)
    if policy == "strict":
        with pytest.raises(RefCorruptBlockError) as want:
            _ref_read(bad, fasta)
        with pytest.raises(CorruptBlockError) as got:
            _port_read(bad, fasta, route)
        assert got.value.block_offset == off
        assert str(got.value) == str(want.value)
        return
    rq, pq = str(tmp_path / "ref_q"), str(tmp_path / "port_q")
    want = _ref_read(bad, fasta, policy, rq)
    got = _port_read(bad, fasta, route, policy, pq)
    _assert_same_reads(got.reads, want.reads)
    assert _counts(got) == _counts(want)
    counted = "skipped_blocks" if policy == "skip" else "quarantined_blocks"
    assert getattr(got.counters, counted) == 1
    # the walk stops at the broken header: the containers before it stay
    assert 0 < got.count() < 2006
    if policy == "quarantine":
        [entry] = _same_quarantine(pq, rq)
        assert entry["kind"] == "CRAM container header"


def _fault_reads(path, specs, seed):
    """Register both packages' fault filesystems for ``path``."""
    ref_fs = RefFaultFS(RefPosix(), [RefFaultSpec(**s) for s in specs],
                        seed=seed)
    ref_register("fault", ref_fs)
    port_fs = FaultInjectingFileSystemWrapper(
        PosixFileSystemWrapper(), [FaultSpec(**s) for s in specs], seed=seed)
    register_filesystem("fault", port_fs)
    return "fault://" + path, ref_fs, port_fs


@pytest.mark.parametrize("route", ROUTES)
def test_header_corrupt_at_the_split_read_goes_to_policy(cram, fasta, route,
                                                         tmp_path):
    """A header byte that reads corrupt only at the split's own read:
    the file header's 1 MiB read and the walk read it clean (matched
    calls 0 and 1), every window of the split's header read (calls 2-7,
    256 bytes growing 4x until it covers the rest of the file) reads it
    flipped. The split's stage A sends the container to the policy, and
    the quarantine copy re-reads its bytes clean (call 8)."""
    off = _data_container(cram, 2)[0]
    specs = [dict(kind="bitflip", offset=off + 2, bit=1, call_index=k)
             for k in range(2, 8)]
    path, _, port_fs = _fault_reads(cram, specs, seed=0)
    rq, pq = str(tmp_path / "ref_q"), str(tmp_path / "port_q")
    want = _ref_read(path, fasta, "quarantine", rq)
    got = _port_read(path, fasta, route, "quarantine", pq)
    assert len(port_fs.injected) == 6
    _assert_same_reads(got.reads, want.reads)
    assert _counts(got) == _counts(want)
    assert got.counters.quarantined_blocks == 1
    [entry] = _same_quarantine(pq, rq)
    assert entry["block_offset"] == off and entry["kind"] == "CRAM container"


@pytest.mark.parametrize("route", ROUTES)
def test_four_workers_equal_one(flipped, fasta, route):
    path = flipped[0]
    one = _port_read(path, fasta, route, "skip")
    four = _port_read(path, fasta, route, "skip", workers=4)
    _assert_same_reads(four.reads, one.reads)
    assert _counts(four) == _counts(one)
    assert four.counters.skipped_blocks == 1


@pytest.mark.parametrize("route", ROUTES)
def test_transient_faults_are_retried(cram, fasta, route):
    specs = [dict(kind="transient", path_substr="in.cram", probability=0.15)]
    path, ref_fs, port_fs = _fault_reads(cram, specs, seed=5)
    clean = _port_read(cram, fasta, route)
    got = _port_read(path, fasta, route, retries=8)
    fired = sum(1 for i in port_fs.injected if i.kind == "transient")
    assert fired > 0
    assert got.counters.retried_reads == fired
    _assert_same_reads(got.reads, clean.reads)
    c = dict(_counts(got), retried_reads=0)
    assert c == _counts(clean)
