"""The port's device write path on the CPU, held byte for byte against the JAX package.

Both packages read the same unsorted BAM (oracle records) with the
device route (``resident_decode``) and write it sorted with the device
deflate armed, ``num_shards`` pinned on both sides:

- ``ResidentShardEncoder.encode_shard`` gathers exactly the host record
  encode of the sorted slice, and ``EncodedShard.deflate`` writes the
  reference's blocks;
- the sorted BAM + BAI + SBI is byte-identical to the reference's at 1
  and 3 shards and 1 and 4 writer workers, armed by `device_deflate()` or by
  ``DISQ_TPU_TORCH_DEVICE_DEFLATE``; so is a host-read batch (host
  encode, device deflate) and a directory of per-shard BAMs;
- every output block inflates with zlib to the default write's
  uncompressed stream;
- a stage manifest whose ``device_deflate`` flips between the crash and
  the resume starts afresh;
- a quarantined read followed by a device write loses only the
  quarantined block's records;
- with the knob off nothing of the device write path is imported or
  launched and the bytes are the zlib-6 ones; without CUDA and without
  a request for the CPU the device route raises.

Tolerance is 0: these are bytes.
"""

import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
import disq_tpu.api as R
from disq_tpu.runtime.errors import DisqOptions as RefOptions
import disq_tpu_torch as P
from disq_tpu_torch.bam.sink import BamSink
from disq_tpu_torch.bgzf.block import parse_block_header
from disq_tpu_torch.ops import deflate as DF
from disq_tpu_torch.runtime import counters
from disq_tpu_torch.util import shutdown_shared_host_pool
from test_torch_cram import _assert_same_reads

N_RECORDS = 2500
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    yield
    shutdown_shared_host_pool()


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dwrite") / "in.bam")
    with open(path, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS, synth_records(
            N_RECORDS, seed=11, unmapped_tail=5)))
    return path


def _ref(shards):
    return (R.ReadsStorage.make_default().num_shards(shards)
            .resident_decode().device_deflate())


def _port(shards, workers=1, knob=True):
    st = (P.ReadsStorage.make_default(device="cpu").num_shards(shards)
          .writer_workers(workers).resident_decode())
    return st.device_deflate() if knob else st


def _files(path, exts=("", ".bai", ".sbi")):
    out = []
    for ext in exts:
        with open(path + ext, "rb") as f:
            out.append(f.read())
    return out


def _blocks(data):
    """(uncompressed stream, block count), each block inflated by zlib
    alone with its CRC and ISIZE checked."""
    out, pos, n = bytearray(), 0, 0
    while pos < len(data):
        total = parse_block_header(data, pos)
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        crc, isize = struct.unpack_from("<II", data, pos + total - 8)
        payload = zlib.decompress(data[pos + 12 + xlen: pos + total - 8], -15)
        assert len(payload) == isize and zlib.crc32(payload) == crc
        out += payload
        pos += total
        n += 1
    return bytes(out), n


@pytest.fixture(scope="module")
def ref_sorted(src, tmp_path_factory):
    """The reference's device-deflate sorted BAM + BAI + SBI at 1 and 3
    shards."""
    d = tmp_path_factory.mktemp("ref_sorted")
    out = {}
    for shards in (1, 3):
        st = _ref(shards)
        out[shards] = str(d / f"ref{shards}.bam")
        st.write(st.read(src), out[shards], R.BaiWriteOption.ENABLE,
                 R.SbiWriteOption.ENABLE, sort=True)
    return out


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("shards", [1, 3])
def test_sorted_device_write_equals_reference(src, ref_sorted, tmp_path,
                                              shards, workers):
    st = _port(shards, workers)
    ds = st.read(src)
    assert ds.reads.device_backed
    counters.reset()
    before = dict(DF.device_stats)
    out = str(tmp_path / "port.bam")
    st.write(ds, out, P.BaiWriteOption.ENABLE, P.SbiWriteOption.ENABLE,
             sort=True)
    assert _files(out) == _files(ref_sorted[shards])
    # on the CPU the plain versions run: no launch is booked
    assert DF.device_stats["launches"] == before["launches"]
    assert counters.snapshot()["launches"] == {}


def test_env_knob_in_place_of_the_storage_option(src, ref_sorted,
                                                 tmp_path, monkeypatch):
    monkeypatch.setenv("DISQ_TPU_TORCH_DEVICE_DEFLATE", "1")
    st = _port(3, knob=False)
    out = str(tmp_path / "port.bam")
    st.write(st.read(src), out, P.BaiWriteOption.ENABLE,
             P.SbiWriteOption.ENABLE, sort=True)
    assert _files(out) == _files(ref_sorted[3])


def test_device_write_decompresses_to_the_default_stream(src, ref_sorted,
                                                         tmp_path):
    st = _port(3, knob=False)
    out = str(tmp_path / "zlib6.bam")
    st.write(st.read(src), out, P.BaiWriteOption.ENABLE, sort=True)
    dev_bytes = _files(ref_sorted[3], ("",))[0]
    want, n_default = _blocks(_files(out, ("",))[0])
    got, n_device = _blocks(dev_bytes)
    assert got == want and n_device == n_default
    assert dev_bytes != _files(out, ("",))[0]


def test_host_read_batch_takes_host_encode_and_device_deflate(
        src, tmp_path):
    """A host-read dataset has no encode source: its records encode on
    the host and only its deflate runs the device coder (the reference's
    route too)."""
    ref_out, out = str(tmp_path / "ref.bam"), str(tmp_path / "port.bam")
    rst = R.ReadsStorage.make_default().num_shards(3).device_deflate()
    rst.write(rst.read(src), ref_out, R.BaiWriteOption.ENABLE, sort=True)
    st = P.ReadsStorage.make_default(device="cpu").num_shards(3) \
        .device_deflate()
    ds = st.read(src)
    from disq_tpu_torch.runtime.device_write import resident_encoder_for

    assert resident_encoder_for(st, ds.reads) is None
    st.write(ds, out, P.BaiWriteOption.ENABLE, sort=True)
    assert _files(out, ("", ".bai")) == _files(ref_out, ("", ".bai"))


def _sorted_pair(src):
    rds = _ref(1).read(src)
    pds = _port(1).read(src)
    order = pds.reads.sort_permutation()
    assert np.array_equal(order, rds.reads.sort_permutation())
    return rds.reads.permuted(order), pds.reads.permuted(order)


@pytest.mark.parametrize("bounds", [(0, N_RECORDS), (0, 1), (7, 1300),
                                    (1300, N_RECORDS), (40, 40)])
def test_encoded_shard_equals_host_encode_and_reference(src, bounds):
    from disq_tpu.runtime.device_write import ResidentShardEncoder as RefEnc
    from disq_tpu_torch.bam.codec import encode_records_with_offsets
    from disq_tpu_torch.runtime.device_write import ResidentShardEncoder

    ref_perm, perm = _sorted_pair(src)
    assert perm.device_backed and perm.encode_source() is not None
    lo, hi = bounds
    want_blob, want_off = encode_records_with_offsets(perm.slice(lo, hi))
    enc = ResidentShardEncoder(perm, "cpu")
    shard = enc.encode_shard(lo, hi)
    if hi > lo:
        assert shard._payload.numpy().tobytes() == bytes(want_blob)
    assert shard.host_payload().tobytes() == bytes(want_blob)
    assert np.array_equal(shard.record_offsets, want_off)
    ref_enc = RefEnc(ref_perm)
    try:
        want = ref_enc.encode_shard(lo, hi).deflate()
    finally:
        ref_enc.release()
    got = shard.deflate()
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    assert _blocks(got[0])[0] == bytes(want_blob)
    assert shard._payload is None  # released after the deflate


def test_multiple_parts_under_the_knob(src, tmp_path, monkeypatch):
    rst = R.ReadsStorage.make_default().num_shards(3).device_deflate()
    rst.write(rst.read(src), str(tmp_path / "ref"),
              R.FileCardinalityWriteOption.MULTIPLE,
              R.ReadsFormatWriteOption.BAM)
    monkeypatch.setenv("DISQ_TPU_TORCH_DEVICE_DEFLATE", "1")
    st = P.ReadsStorage.make_default(device="cpu").num_shards(3)
    st.write(st.read(src), str(tmp_path / "port"),
             P.FileCardinalityWriteOption.MULTIPLE,
             P.ReadsFormatWriteOption.BAM)
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    for name in names:
        assert _files(str(tmp_path / "port" / name), ("",)) == \
            _files(str(tmp_path / "ref" / name), ("",))


_ENCODE_SHARD = BamSink._encode_shard


def test_manifest_device_flag_flip_resets_staging(src, ref_sorted, tmp_path,
                                                  monkeypatch):
    """A write crashes at shard 2 with the knob off; the resume with the
    knob on must not adopt the zlib-6 parts already staged."""
    out, mpath = str(tmp_path / "out.bam"), str(tmp_path / "w.manifest")
    opts = (P.StageManifestWriteOption(mpath), P.BaiWriteOption.ENABLE,
            P.SbiWriteOption.ENABLE)

    def failing(self, batch, bounds, k, resident=None):
        if k == 2:
            raise IOError("injected")
        return _ENCODE_SHARD(self, batch, bounds, k, resident)

    monkeypatch.setattr(BamSink, "_encode_shard", failing)
    st = _port(3, knob=False)
    with pytest.raises(RuntimeError, match="shard 2"):
        st.write(st.read(src), out, *opts, sort=True)
    from disq_tpu_torch.runtime.manifest import StageManifest

    assert StageManifest(mpath).completed_shards("bam.parts") == [0, 1]
    ran = []

    def logging(self, batch, bounds, k, resident=None):
        ran.append(k)
        return _ENCODE_SHARD(self, batch, bounds, k, resident)

    monkeypatch.setattr(BamSink, "_encode_shard", logging)
    st = _port(3)
    st.write(st.read(src), out, *opts, sort=True)
    assert sorted(ran) == [0, 1, 2]
    assert not os.path.exists(mpath)
    assert _files(out) == _files(ref_sorted[3])


def test_quarantined_read_then_device_write(src, tmp_path):
    """The reference's ``TestFaultInterplay``: a corrupt block
    quarantined on read loses only its own records, and the device
    write of the rest equals the reference's."""
    data = open(src, "rb").read()
    layout, pos = [], 0
    while pos < len(data):
        layout.append(pos)
        pos += parse_block_header(data, pos)
    bad = bytearray(data)
    bad[layout[3] + 20] ^= 0xFF
    bad_path = str(tmp_path / "bad.bam")
    with open(bad_path, "wb") as f:
        f.write(bytes(bad))
    outs, counts = {}, {}
    for name, pkg, opts in (
            ("ref", R, RefOptions(error_policy="quarantine",
                                  quarantine_dir=str(tmp_path / "rq"),
                                  device_deflate=True)),
            ("port", P, P.DisqOptions(error_policy="quarantine",
                                      quarantine_dir=str(tmp_path / "pq"),
                                      device_deflate=True))):
        st = (pkg.ReadsStorage.make_default(device="cpu") if pkg is P
              else pkg.ReadsStorage.make_default())
        st = st.num_shards(3).options(opts).resident_decode()
        ds = st.read(bad_path)
        assert ds.counters.quarantined_blocks == 1
        counts[name] = ds.count()
        assert 0 < counts[name] < N_RECORDS + 5
        outs[name] = str(tmp_path / f"{name}.bam")
        st.write(ds, outs[name], pkg.BaiWriteOption.ENABLE, sort=True)
    assert counts["port"] == counts["ref"]
    assert _files(outs["port"], ("", ".bai")) == \
        _files(outs["ref"], ("", ".bai"))
    back = P.ReadsStorage.make_default(device="cpu").read(outs["port"])
    want = P.ReadsStorage.make_default(device="cpu").options(
        P.DisqOptions(error_policy="skip")).read(bad_path)
    _assert_same_reads(back.reads,
                       want.coordinate_sorted().reads)


def test_knob_off_imports_and_launches_nothing(src, tmp_path):
    out = str(tmp_path / "off.bam")
    code = (
        "import json, sys\n"
        "import disq_tpu_torch as P\n"
        f"st = P.ReadsStorage.make_default(device='cpu').num_shards(3)"
        f".resident_decode()\n"
        f"st.write(st.read({src!r}), {out!r}, P.BaiWriteOption.ENABLE,"
        f" sort=True)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m in (\n"
        "    'disq_tpu_torch.ops.deflate', 'disq_tpu_torch.ops.record_gather',"
        "\n    'disq_tpu_torch.runtime.device_write'))))\n")
    env = dict(os.environ)
    env.pop("DISQ_TPU_TORCH_DEVICE_DEFLATE", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    # the zlib-6 bytes of the reference's default sorted write
    ref_out = str(tmp_path / "ref.bam")
    rst = R.ReadsStorage.make_default().num_shards(3)
    rst.write(rst.read(src), ref_out, R.BaiWriteOption.ENABLE, sort=True)
    assert _files(out, ("", ".bai")) == _files(ref_out, ("", ".bai"))


def test_device_route_raises_without_cuda(monkeypatch):
    from disq_tpu_torch.bgzf.codec import deflate_blob_for, deflate_device_for

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    armed = P.ReadsStorage.make_default().device_deflate()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deflate_device_for(armed)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deflate_blob_for(armed, b"abc" * 100)
    assert deflate_device_for(P.ReadsStorage.make_default()) is None
    cpu = P.ReadsStorage.make_default(device="cpu").device_deflate()
    assert deflate_device_for(cpu) == torch.device("cpu")
    assert deflate_blob_for(cpu, b"abc" * 100)[0] == \
        DF.deflate_blob_device(b"abc" * 100, "cpu")[0]
