"""Error policies of the port's BAM read against the JAX package, on the CPU.

Both packages read the same BAM through their fault-injecting
filesystems with the same seeded ``FaultSpec`` schedules (the contracts
of ``tests/test_fault_injection.py``):

- a bit flipped inside a mid-file block's DEFLATE payload: ``strict``
  raises ``CorruptBlockError`` with the same coordinates and message
  (also when the boundary search meets it first), ``skip`` loses only
  that block's records and counts one skipped block, ``quarantine``
  writes the same manifest entry and sidecar bytes;
- a bit flipped in a block header (the salvage walk), a wrecked record
  chain (the tolerant scan), a file cut mid-block;
- transient, truncated and stalled reads recover to identical output.

The port runs each corrupt-block case on the host route and on the
device route (its kernels' plain versions, B1 and the legacy B4); a
salvaged split on the device route stays device-backed. A kernel that
flags valid data makes the read raise its own error, never a salvage.
"""

import json
import os

import numpy as np
import pytest

import disq_tpu.api as R
from bam_oracle import (
    DEFAULT_REFS,
    encode_record,
    make_bam_bytes,
    make_header_bytes,
    o_bgzf_compress,
    synth_records,
)
from disq_tpu.bgzf.block import parse_block_header
from disq_tpu.fsw import FaultInjectingFileSystemWrapper as RefFaultFS
from disq_tpu.fsw import FaultSpec as RefFaultSpec
from disq_tpu.fsw import PosixFileSystemWrapper as RefPosix
from disq_tpu.fsw import register_filesystem as ref_register
from disq_tpu.runtime.errors import CorruptBlockError as RefCorruptBlockError
from disq_tpu.runtime.errors import DisqOptions as RefOptions
from disq_tpu.runtime.errors import ErrorPolicy as RefPolicy
import disq_tpu_torch as P
from disq_tpu_torch import interop
from disq_tpu_torch.fsw.faultfs import FaultInjectingFileSystemWrapper, FaultSpec
from disq_tpu_torch.fsw.filesystem import PosixFileSystemWrapper, register_filesystem
from disq_tpu_torch.runtime.errors import CorruptBlockError, DisqOptions, ErrorPolicy
from disq_tpu_torch.util import shutdown_shared_host_pool

BLOCKSIZE = 600
SPLIT = 4096
FIELDS = ("refid", "pos", "mapq", "bin", "flag", "next_refid", "next_pos",
          "tlen", "name_offsets", "names", "cigar_offsets", "cigars",
          "seq_offsets", "seqs", "quals", "tag_offsets", "tags")
ROUTES = ["host", "resident", "legacy"]


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    """Leave no idle pool threads behind for later tests in the process."""
    yield
    shutdown_shared_host_pool()


@pytest.fixture(scope="module")
def bam_file(tmp_path_factory):
    records = synth_records(500, seed=7, unmapped_tail=6)
    data = make_bam_bytes(DEFAULT_REFS, records, blocksize=BLOCKSIZE)
    path = str(tmp_path_factory.mktemp("policy") / "in.bam")
    with open(path, "wb") as f:
        f.write(data)
    return path, records, data


def _layout(data):
    out, pos = [], 0
    while pos < len(data):
        total = parse_block_header(data, pos)
        out.append((pos, total))
        pos += total
    return out


def _surviving(records, blk_i):
    """Names of the records with no byte in block ``blk_i``'s span."""
    p = len(make_header_bytes(DEFAULT_REFS))
    ulo, uhi = blk_i * BLOCKSIZE, (blk_i + 1) * BLOCKSIZE
    out = []
    for r in records:
        n = len(encode_record(r))
        if p + n <= ulo or p >= uhi:
            out.append(r.name)
        p += n
    return out


def _ref_read(path, specs, seed=0, policy="strict", qdir=None, split=SPLIT,
              max_retries=3):
    fsw = RefFaultFS(RefPosix(), [RefFaultSpec(**s) for s in specs], seed=seed)
    ref_register("fault", fsw)
    opts = RefOptions(error_policy=RefPolicy.coerce(policy),
                      max_retries=max_retries, retry_backoff_s=0.0,
                      quarantine_dir=qdir)
    return (R.ReadsStorage.make_default().split_size(split).options(opts)
            .read("fault://" + path), fsw)


def _port_read(path, specs, seed=0, policy="strict", qdir=None, split=SPLIT,
               max_retries=3, route="host", monkeypatch=None, workers=1):
    fsw = FaultInjectingFileSystemWrapper(
        PosixFileSystemWrapper(), [FaultSpec(**s) for s in specs], seed=seed)
    register_filesystem("fault", fsw)
    opts = DisqOptions(error_policy=ErrorPolicy.coerce(policy),
                       max_retries=max_retries, retry_backoff_s=0.0,
                       quarantine_dir=qdir, executor_workers=workers)
    storage = (P.ReadsStorage.make_default(device="cpu").split_size(split)
               .options(opts).resident_decode(route != "host"))
    if route == "legacy":
        monkeypatch.setenv("DISQ_TPU_TORCH_DEVICE_INFLATE", "legacy")
    else:
        monkeypatch.delenv("DISQ_TPU_TORCH_DEVICE_INFLATE", raising=False)
    return storage.read("fault://" + path), fsw


def _names(ds):
    rb = ds.reads.to_read_batch() if hasattr(ds.reads, "to_read_batch") \
        else ds.reads
    return [rb.name(i) for i in range(int(rb.count))]


def _assert_same_reads(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture(scope="module")
def target(bam_file):
    """A mid-file block, and the records that must survive its loss."""
    _, records, data = bam_file
    layout = _layout(data)
    blk_i = len(layout) // 2
    start, total = layout[blk_i]
    surviving = _surviving(records, blk_i)
    assert len(surviving) < len(records)
    return start, total, surviving


def _payload_flip(start):
    # +20 lands inside the DEFLATE payload (18-byte BGZF header)
    return [dict(kind="bitflip", path_substr="in.bam", offset=start + 20,
                 bit=3)]


def _header_flip(start):
    # +1 hits the gzip magic's second byte: the header is malformed
    return [dict(kind="bitflip", path_substr="in.bam", offset=start + 1,
                 bit=0)]


# -- corrupt payload ---------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
def test_strict_names_the_block_like_reference(bam_file, target, route,
                                               monkeypatch):
    path, _, _ = bam_file
    start, _, _ = target
    with pytest.raises(RefCorruptBlockError) as ref_e:
        _ref_read(path, _payload_flip(start), split=10**9)
    with pytest.raises(CorruptBlockError) as got_e:
        _port_read(path, _payload_flip(start), split=10**9, route=route,
                   monkeypatch=monkeypatch)
    e = got_e.value
    assert (e.block_offset, e.shard_id, e.path) == (
        ref_e.value.block_offset, ref_e.value.shard_id, ref_e.value.path)
    assert e.block_offset == start and e.shard_id == 0
    assert str(e) == str(ref_e.value)


@pytest.mark.parametrize("route", ROUTES)
def test_strict_from_boundary_search_like_reference(bam_file, target, route,
                                                    monkeypatch):
    path, _, _ = bam_file
    start, _, _ = target
    with pytest.raises(RefCorruptBlockError) as ref_e:
        _ref_read(path, _payload_flip(start))
    with pytest.raises(CorruptBlockError) as got_e:
        _port_read(path, _payload_flip(start), route=route,
                   monkeypatch=monkeypatch)
    assert got_e.value.block_offset == ref_e.value.block_offset == start
    assert str(got_e.value) == str(ref_e.value)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("split", [SPLIT, 10**9])
def test_skip_loses_only_that_block_like_reference(bam_file, target, route,
                                                   split, monkeypatch):
    path, _, _ = bam_file
    start, _, surviving = target
    ref, _ = _ref_read(path, _payload_flip(start), policy="skip", split=split)
    got, _ = _port_read(path, _payload_flip(start), policy="skip",
                        split=split, route=route, monkeypatch=monkeypatch)
    assert _names(got) == surviving == _names(ref)
    _assert_same_reads(got.reads, ref.reads)
    assert got.counters.skipped_blocks == ref.counters.skipped_blocks == 1
    assert got.counters.quarantined_blocks == 0
    assert got.counters.records == ref.counters.records == len(surviving)
    assert got.counters.blocks == ref.counters.blocks
    if route != "host":
        assert got.reads.device_backed  # the salvaged split stays on the device


def _manifest(qdir):
    with open(os.path.join(qdir, "MANIFEST.jsonl")) as f:
        return [json.loads(ln) for ln in f.read().splitlines()]


def _comparable(entry, qdir):
    e = dict(entry)
    del e["run_id"]
    e["sidecar"] = os.path.relpath(e["sidecar"], qdir)
    return e


@pytest.mark.parametrize("route", ROUTES)
def test_quarantine_matches_reference(bam_file, target, route, tmp_path,
                                      monkeypatch):
    path, _, data = bam_file
    start, total, surviving = target
    rq, pq = str(tmp_path / "ref_q"), str(tmp_path / "port_q")
    ref, _ = _ref_read(path, _payload_flip(start), policy="quarantine",
                       qdir=rq)
    got, _ = _port_read(path, _payload_flip(start), policy="quarantine",
                        qdir=pq, route=route, monkeypatch=monkeypatch)
    assert got.counters.quarantined_blocks == 1
    assert got.counters.skipped_blocks == 0
    assert _names(got) == surviving
    _assert_same_reads(got.reads, ref.reads)
    ref_lines, got_lines = _manifest(rq), _manifest(pq)
    assert got_lines[0] == ref_lines[0] == {"version": 1}
    assert [_comparable(e, pq) for e in got_lines[1:]] == \
        [_comparable(e, rq) for e in ref_lines[1:]]
    [entry] = got_lines[1:]
    assert entry["block_offset"] == start and entry["kind"] == "BGZF block"
    raw = open(entry["sidecar"], "rb").read()
    assert raw == open(ref_lines[1]["sidecar"], "rb").read()
    expected = bytearray(data[start:start + total])
    expected[20] ^= 1 << 3
    assert raw == bytes(expected) and entry["length"] == len(raw)


# -- corrupt header ----------------------------------------------------------


@pytest.mark.parametrize("route", ["host", "resident"])
@pytest.mark.parametrize("policy", ["strict", "skip", "quarantine"])
def test_header_corruption_like_reference(bam_file, route, policy, tmp_path,
                                          monkeypatch):
    path, records, data = bam_file
    layout = _layout(data)
    blk_i = len(layout) // 2
    start, _ = layout[blk_i]
    qdirs = [str(tmp_path / "rq"), str(tmp_path / "pq")]
    if policy == "strict":
        with pytest.raises(RefCorruptBlockError) as ref_e:
            _ref_read(path, _header_flip(start), split=10**9)
        with pytest.raises(CorruptBlockError) as got_e:
            _port_read(path, _header_flip(start), split=10**9, route=route,
                       monkeypatch=monkeypatch)
        assert got_e.value.block_offset == start
        assert "header" in str(got_e.value)
        assert str(got_e.value) == str(ref_e.value)
        return
    ref, _ = _ref_read(path, _header_flip(start), policy=policy,
                       qdir=qdirs[0], split=10**9)
    got, _ = _port_read(path, _header_flip(start), policy=policy,
                        qdir=qdirs[1], split=10**9, route=route,
                        monkeypatch=monkeypatch)
    assert _names(got) == _surviving(records, blk_i) == _names(ref)
    _assert_same_reads(got.reads, ref.reads)
    counted = ("quarantined_blocks" if policy == "quarantine"
               else "skipped_blocks")
    assert getattr(got.counters, counted) == 1
    if policy == "quarantine":
        [g], [r] = _manifest(qdirs[1])[1:], _manifest(qdirs[0])[1:]
        assert _comparable(g, qdirs[1]) == _comparable(r, qdirs[0])
        assert g["kind"] == "BGZF block header"
        assert open(g["sidecar"], "rb").read() == \
            open(r["sidecar"], "rb").read()


def test_file_cut_mid_block_is_corrupt_not_transient(bam_file, tmp_path):
    path, records, data = bam_file
    cut = str(tmp_path / "cut.bam")
    with open(cut, "wb") as f:
        f.write(data[:-40])
    ref = (R.ReadsStorage.make_default()
           .options(RefOptions(error_policy=RefPolicy.SKIP,
                               retry_backoff_s=0.0)).read(cut))
    got = (P.ReadsStorage.make_default(device="cpu")
           .options(DisqOptions(error_policy=ErrorPolicy.SKIP,
                                retry_backoff_s=0.0)).read(cut))
    assert got.counters.retried_reads == 0
    assert got.counters.skipped_blocks == ref.counters.skipped_blocks >= 1
    assert got.count() == ref.count()
    _assert_same_reads(got.reads, ref.reads)


# -- record framing ----------------------------------------------------------


@pytest.fixture(scope="module")
def framed_bam(tmp_path_factory):
    """Intact BGZF blocks around an impossible record chain: record
    120's block_size is wrecked."""
    records = synth_records(200, seed=3)
    payload = bytearray(make_header_bytes(DEFAULT_REFS))
    extents = []
    for r in records:
        b = encode_record(r)
        extents.append(len(payload))
        payload += b
    lo = extents[120]
    payload[lo: lo + 4] = (0x7FFFFFF0).to_bytes(4, "little")
    path = str(tmp_path_factory.mktemp("framed") / "in.bam")
    with open(path, "wb") as f:
        f.write(o_bgzf_compress(bytes(payload), blocksize=600))
    return path, records


@pytest.mark.parametrize("route", ["host", "resident"])
def test_record_framing_like_reference(framed_bam, route):
    path, records = framed_bam
    with pytest.raises(RefCorruptBlockError, match="record run") as ref_e:
        R.ReadsStorage.make_default().options(
            RefOptions(retry_backoff_s=0.0)).read(path)
    port = P.ReadsStorage.make_default(device="cpu").resident_decode(
        route == "resident")
    with pytest.raises(CorruptBlockError, match="record run") as got_e:
        port.options(DisqOptions(retry_backoff_s=0.0)).read(path)
    assert str(got_e.value) == str(ref_e.value)
    ref = R.ReadsStorage.make_default().options(
        RefOptions(error_policy=RefPolicy.SKIP, retry_backoff_s=0.0)).read(path)
    got = port.options(DisqOptions(error_policy=ErrorPolicy.SKIP,
                                   retry_backoff_s=0.0)).read(path)
    assert got.counters.skipped_blocks == ref.counters.skipped_blocks == 1
    assert _names(got) == [r.name for r in records[:120]] == _names(ref)
    _assert_same_reads(got.reads, ref.reads)


# -- transient faults --------------------------------------------------------


@pytest.fixture(scope="module")
def baseline(bam_file):
    path, _, _ = bam_file
    return P.ReadsStorage.make_default(device="cpu").split_size(SPLIT).read(path)


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("spec,seed", [
    (dict(kind="transient", probability=0.05, path_substr="in.bam"), 1234),
    (dict(kind="truncate", probability=0.10, truncate_bytes=37,
          path_substr="in.bam"), 99),
    (dict(kind="stall", call_index=1, stall_s=0.0, times=1,
          path_substr="in.bam"), 0),
], ids=["transient", "truncate", "stall"])
def test_transient_faults_recover_identically(bam_file, baseline, spec, seed,
                                              workers, monkeypatch):
    path, records, _ = bam_file
    got, fsw = _port_read(path, [spec], seed=seed, monkeypatch=monkeypatch,
                          workers=workers)
    assert fsw.fired_counts()[0][1] > 0, "the schedule injected nothing"
    assert got.count() == len(records)
    _assert_same_reads(got.reads, baseline.reads)
    if spec["kind"] == "transient":
        assert got.counters.retried_reads > 0


def test_transient_schedule_replays_like_reference(bam_file, monkeypatch):
    """The same seeded schedule fires on the same calls in both
    packages: the port's read issues the reference's range reads."""
    path, _, _ = bam_file
    spec = dict(kind="transient", probability=0.05, path_substr="in.bam")
    ref, ref_fsw = _ref_read(path, [spec], seed=1234)
    got, fsw = _port_read(path, [spec], seed=1234, monkeypatch=monkeypatch)
    assert [(i.kind, i.start, i.length, i.call) for i in fsw.injected] == \
        [(i.kind, i.start, i.length, i.call) for i in ref_fsw.injected]
    assert got.counters.retried_reads == ref.counters.retried_reads


def test_persistent_transient_fault_raises(bam_file, monkeypatch):
    path, _, _ = bam_file
    spec = dict(kind="transient", probability=1.0, path_substr="in.bam")
    with pytest.raises(IOError):
        _port_read(path, [spec], max_retries=2, monkeypatch=monkeypatch)


# -- no hidden fallback -------------------------------------------------------


@pytest.mark.parametrize("route", ["resident", "legacy"])
def test_kernel_fault_is_raised_not_salvaged(bam_file, route, monkeypatch):
    """A kernel that flags valid data: every block then inflates alone on
    the host, so the read raises the batch's error under any policy."""
    import torch

    from disq_tpu_torch.ops import inflate as B4
    from disq_tpu_torch.ops import inflate_simd as B1

    path, _, _ = bam_file
    if route == "resident":
        real = B1.inflate

        def flagging(*args):
            out, out_len, status = real(*args)
            return out, out_len, torch.full_like(status, 3)

        monkeypatch.setattr(B1, "inflate", flagging)
        match = "device inflate failed at block 0: status 3"
    else:
        real = B4.inflate_stacked

        def flagging(*args):
            out, meta = real(*args)
            meta[:, 1] = 4
            return out, meta

        monkeypatch.setattr(B4, "inflate_stacked", flagging)
        match = "device inflate failed for block 0: error 4"
    for policy in ("skip", "quarantine", "strict"):
        with pytest.raises(ValueError, match=match) as e:
            _port_read(path, [], policy=policy, route=route,
                       monkeypatch=monkeypatch)
        assert not isinstance(e.value, CorruptBlockError)


@pytest.mark.parametrize("route", ["resident", "legacy"])
def test_device_salvage_inflates_only_the_flagged_block(bam_file, target,
                                                        route, monkeypatch):
    """On the device route only the block the kernel flagged inflates
    alone on the host; the good blocks keep the kernel's output and
    their records are parsed on the device, with no host record
    decode."""
    from disq_tpu_torch.bam import source
    from disq_tpu_torch.bgzf import codec

    path, _, _ = bam_file
    start, _, surviving = target
    real, alone = codec.inflate_block, []

    def counting(data, offset=None, verify_crc=True):
        if offset is not None:
            alone.append(offset)
        return real(data, offset or 0, verify_crc)

    def no_host_decode(*args, **kwargs):
        raise AssertionError("host record decode on the device route")

    monkeypatch.setattr(codec, "inflate_block", counting)
    monkeypatch.setattr(source, "decode_records", no_host_decode)
    got, _ = _port_read(path, _payload_flip(start), policy="skip",
                        split=10**9, route=route, monkeypatch=monkeypatch)
    assert len(alone) == 1
    assert _names(got) == surviving
    assert got.counters.skipped_blocks == 1
    assert got.reads.device_backed


@pytest.mark.parametrize("route", ["resident", "legacy"])
def test_kernel_fault_beside_a_corrupt_block_is_raised(bam_file, target,
                                                       route, monkeypatch):
    """The batch flags the corrupt block and also decodes a good block
    wrong (its CRC fails): that block inflates alone on the host, so the
    read raises the batch's error rather than serving a salvage."""
    from disq_tpu_torch.ops import inflate as B4
    from disq_tpu_torch.ops import inflate_simd as B1

    path, _, _ = bam_file
    start, _, _ = target
    if route == "resident":
        real = B1.inflate

        def wrong(*args):
            out, out_len, status = real(*args)
            out[0] ^= 1
            return out, out_len, status

        monkeypatch.setattr(B1, "inflate", wrong)
        match = "device inflate failed at block"
    else:
        real = B4.inflate_stacked

        def wrong(*args):
            out, meta = real(*args)
            out[0, 0] ^= 1
            return out, meta

        monkeypatch.setattr(B4, "inflate_stacked", wrong)
        match = "device inflate failed for block"
    with pytest.raises(ValueError, match=match) as e:
        _port_read(path, _payload_flip(start), policy="skip", split=10**9,
                   route=route, monkeypatch=monkeypatch)
    assert not isinstance(e.value, CorruptBlockError)


def test_interop_carries_options_and_policy():
    ref = RefOptions(error_policy=RefPolicy.QUARANTINE, max_retries=5,
                     retry_backoff_s=0.25, quarantine_dir="/q",
                     executor_workers=4, prefetch_shards=6, writer_workers=3,
                     writer_prefetch_shards=2)
    assert interop.options_from(ref) == DisqOptions(
        error_policy=ErrorPolicy.QUARANTINE, max_retries=5,
        retry_backoff_s=0.25, quarantine_dir="/q", executor_workers=4,
        prefetch_shards=6, writer_workers=3, writer_prefetch_shards=2)
    assert interop.options_from({}) == DisqOptions()
    for p in RefPolicy:
        assert interop.error_policy(p).value == p.value
    with pytest.raises(ValueError, match="unknown error policy"):
        interop.error_policy("lenient")
