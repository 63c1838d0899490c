"""The port's stage manifest and read ledger on the CPU, against the JAX package.

- ``StageManifest``: the unit contracts of the reference's
  ``tests/test_runtime.py`` (record and resume, partial failure, retry,
  params reset, finish), plus a damaged file, the run id of each shard,
  marks from many threads, and a manifest the reference wrote resumed
  by the port.
- ``ReadLedger``: the contracts of ``tests/test_resilience.py``'s
  ``TestReadLedger`` (params reset, options that change what a split
  decodes to, a missing spill), with the route in the fingerprint.
- A BAM read that crashes at split 4's fetch and is run again decodes
  only splits 4 onwards, on the host route and the resident route, at 1
  and 4 executor workers; its records equal the reference's read, its
  counters (a skipped block in a spilled split included) equal the
  uninterrupted read's, and the ledger is gone. The same for CRAM.
- A spilled device-backed batch parses again on its own device, and a
  spill from ``cuda`` raises where CUDA is absent.
"""

import json
import os
import pickle
import threading

import numpy as np
import pytest

from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
import disq_tpu.api as R
from disq_tpu.runtime.manifest import StageManifest as RefStageManifest
import disq_tpu_torch as P
from disq_tpu_torch.bam.source import BamSource
from disq_tpu_torch.bgzf.block import parse_block_header
from disq_tpu_torch.cram.source import CramSource
from disq_tpu_torch.runtime import columnar
from disq_tpu_torch.runtime.errors import DisqOptions
from disq_tpu_torch.runtime.executor import read_ledger_for_storage
from disq_tpu_torch.runtime.manifest import RUN_ID, ReadLedger, StageManifest
from disq_tpu_torch.util import shutdown_shared_host_pool
from test_torch_cram import _synth_ref_matched

SPLIT = 4096
FIELDS = ("refid", "pos", "mapq", "bin", "flag", "next_refid", "next_pos",
          "tlen", "name_offsets", "names", "cigar_offsets", "cigars",
          "seq_offsets", "seqs", "quals", "tag_offsets", "tags")
COUNTS = ("shards", "records", "blocks", "bytes_compressed",
          "bytes_uncompressed", "skipped_blocks", "quarantined_blocks",
          "retried_reads")


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    """Leave no idle pool threads behind for later tests in the process."""
    yield
    shutdown_shared_host_pool()


# -- StageManifest -----------------------------------------------------------


def test_manifest_records_and_resumes(tmp_path):
    m = StageManifest(str(tmp_path / "m.json"), params={"a": 1})
    calls = []

    def work(k):
        calls.append(k)
        return {"k": k * 10}

    assert [o["k"] for o in m.run_stage("s", 4, work)] == [0, 10, 20, 30]
    assert calls == [0, 1, 2, 3]
    calls.clear()
    again = StageManifest(str(tmp_path / "m.json"), params={"a": 1})
    assert [o["k"] for o in again.run_stage("s", 4, work)] == [0, 10, 20, 30]
    assert calls == []


def test_manifest_partial_failure_then_resume(tmp_path):
    path = str(tmp_path / "m.json")
    ran = []

    def flaky(k):
        ran.append(k)
        if k == 2:
            raise IOError("disk on fire")
        return k

    with pytest.raises(RuntimeError, match="shard 2"):
        StageManifest(path).run_stage("s", 4, flaky, retries=0)
    assert ran == [0, 1, 2]
    ran.clear()
    assert StageManifest(path).run_stage("s", 4, flaky_free(ran)) == \
        [0, 1, 2, 3]
    assert ran == [2, 3]


def flaky_free(ran):
    def fn(k):
        ran.append(k)
        return k
    return fn


def test_manifest_retry_succeeds(tmp_path):
    attempts = []

    def flaky_once(k):
        attempts.append(k)
        if len(attempts) == 1:
            raise IOError("transient")
        return "ok"

    m = StageManifest(str(tmp_path / "m.json"))
    assert m.run_stage("s", 1, flaky_once, retries=1) == ["ok"]
    assert attempts == [0, 0]


def test_manifest_params_mismatch_resets(tmp_path):
    path = str(tmp_path / "m.json")
    StageManifest(path, params={"target": "a.bam"}).mark_done("s", 0, "x")
    assert StageManifest(path, params={"target": "a.bam"}).is_done("s", 0)
    assert not StageManifest(path, params={"target": "b.bam"}).is_done("s", 0)
    # params=None inspects whatever is stored
    assert StageManifest(path).is_done("s", 0)


def test_manifest_finish_removes_file(tmp_path):
    path = str(tmp_path / "m.json")
    m = StageManifest(path)
    m.mark_done("s", 0)
    assert os.path.exists(path)
    m.finish()
    assert not os.path.exists(path)
    m.finish()  # a second commit is harmless


def test_damaged_manifest_starts_fresh(tmp_path):
    path = str(tmp_path / "m.json")
    with open(path, "w") as f:
        f.write('{"version": 1, "stages": {"s": {"sha')
    m = StageManifest(path)
    assert m.completed_shards("s") == []
    m.mark_done("s", 3, {"len": 7})
    with open(path) as f:
        assert json.load(f)["stages"]["s"]["shards"] == {"3": {"len": 7}}


def test_manifest_records_the_run_of_each_shard(tmp_path):
    path = str(tmp_path / "m.json")
    m = StageManifest(path)
    m.mark_done("s", 1, "x")
    assert m.shard_run_id("s", 1) == RUN_ID
    assert m.shard_run_id("s", 2) is None
    with open(path) as f:
        doc = json.load(f)
    assert doc["run_id"] == RUN_ID and doc["version"] == 1


def test_mark_done_from_many_threads(tmp_path):
    """More marking threads than cores, with short switch intervals: no
    completion is lost from the file."""
    import sys

    path = str(tmp_path / "m.json")
    m = StageManifest(path)
    n_threads = 2 * (os.cpu_count() or 1) + 2

    def mark(t):
        for i in range(40):
            m.mark_done("s", t * 40 + i, {"t": t})

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=mark, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert StageManifest(path).completed_shards("s") == \
        list(range(40 * n_threads))


def test_reference_manifest_resumes_in_the_port(tmp_path):
    """The file layout is the reference's: a manifest it wrote is read
    by the port with the same params."""
    path = str(tmp_path / "m.json")
    params = {"target": "x.bam", "n_shards": 4}
    ref = RefStageManifest(path, params=params)
    ref.mark_done("bam.parts", 0, {"part": "p0", "len": 3})
    ref.mark_done("bam.parts", 2, {"part": "p2", "len": 5})
    port = StageManifest(path, params=params)
    assert port.completed_shards("bam.parts") == [0, 2]
    assert port.shard_info("bam.parts", 2) == {"part": "p2", "len": 5}
    ran = []
    port.run_stage("bam.parts", 4, flaky_free(ran))
    assert ran == [1, 3]
    assert RefStageManifest(path, params=params).completed_shards(
        "bam.parts") == [0, 1, 2, 3]


# -- ReadLedger --------------------------------------------------------------


class _Storage:
    def __init__(self, opts):
        self._options = opts


def test_ledger_param_mismatch_resets(tmp_path):
    d = str(tmp_path / "lg")
    ReadLedger(d, params={"path": "x", "shards": 4}).record(0, "payload")
    assert ReadLedger(d, params={"path": "x", "shards": 4}).is_done(0)
    assert ReadLedger(d, params={"path": "x", "shards": 4}).load(0) == \
        "payload"
    assert not ReadLedger(d, params={"path": "y", "shards": 4}).is_done(0)


@pytest.mark.parametrize("change", ["path", "shards", "policy", "route"])
def test_decode_affecting_options_reset_ledger(tmp_path, change):
    d = str(tmp_path / "lg")
    base = DisqOptions(error_policy="skip").with_read_ledger(d)
    read_ledger_for_storage(_Storage(base), "p", 4, False).record(0, "v")
    assert read_ledger_for_storage(_Storage(base), "p", 4, False).is_done(0)
    opts = DisqOptions().with_read_ledger(d) if change == "policy" else base
    lg = read_ledger_for_storage(
        _Storage(opts), "q" if change == "path" else "p",
        5 if change == "shards" else 4, change == "route")
    assert not lg.is_done(0)


def test_interop_carries_the_ledger_option(tmp_path):
    from disq_tpu.runtime.errors import DisqOptions as RefOptions
    from disq_tpu_torch import interop

    d = str(tmp_path / "lg")
    opts = interop.options_from(RefOptions(error_policy="skip")
                                .with_read_ledger(d))
    assert opts.read_ledger == d and opts.error_policy.value == "skip"


def test_no_ledger_without_the_option():
    assert read_ledger_for_storage(_Storage(DisqOptions()), "p", 4,
                                   False) is None


def test_missing_spill_reruns_shard(tmp_path):
    d = str(tmp_path / "lg")
    lg = ReadLedger(d)
    lg.record(2, {"v": 1})
    os.unlink(os.path.join(d, "shard-2.pkl"))
    assert not lg.is_done(2)
    assert lg.completed_shards() == []


def test_ledger_finish_drops_manifest_and_spills(tmp_path):
    d = str(tmp_path / "lg")
    lg = ReadLedger(d)
    lg.record(0, 1)
    lg.record(1, 2)
    assert lg.shard_run_id(1) == RUN_ID
    lg.finish()
    assert sorted(os.listdir(d)) == []


# -- crashed reads resume --------------------------------------------------


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """~9 splits of 4 KiB; a copy with one flipped bit in split 1."""
    d = tmp_path_factory.mktemp("resume")
    data = make_bam_bytes(DEFAULT_REFS, synth_records(500, seed=7,
                                                      unmapped_tail=6),
                          blocksize=600)
    path, bad = str(d / "in.bam"), str(d / "bad.bam")
    with open(path, "wb") as f:
        f.write(data)
    pos = 0
    while pos < SPLIT:  # the first block starting in split 1
        pos += parse_block_header(data, pos)
    flipped = bytearray(data)
    flipped[pos + 20] ^= 1 << 3
    with open(bad, "wb") as f:
        f.write(flipped)
    return {"strict": path, "skip": bad}


_FETCHES = {(cls, name): getattr(cls, name) for cls, name in (
    (BamSource, "_fetch_range"), (CramSource, "_fetch_split_containers"))}


def _crash_at(monkeypatch, cls, name, shard, log):
    """Make ``cls.<name>`` (a split's fetch) raise on split ``shard`` (or
    never, for None), logging the splits it fetches."""
    orig = _FETCHES[(cls, name)]

    def wrapped(self, *args):
        ctx = args[-1]
        log.append(ctx.shard_id)
        if ctx.shard_id == shard:
            raise RuntimeError("simulated crash")
        return orig(self, *args)

    monkeypatch.setattr(cls, name, wrapped)


def _storage(ledger, route, workers, policy="strict"):
    return (P.ReadsStorage.make_default(device="cpu").split_size(SPLIT)
            .error_policy(policy).executor_workers(workers)
            .resident_decode(route == "resident").read_ledger(ledger))


def _device_backed(ds):
    return isinstance(ds.reads, columnar.ColumnarBatch) and \
        ds.reads.device_backed


def _same_reads(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("policy", ["strict", "skip"])
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("route", ["host", "resident"])
def test_crashed_bam_read_resumes_only_unfinished_splits(
        bam, tmp_path, monkeypatch, route, workers, policy):
    path = bam[policy]
    ledger = str(tmp_path / "ledger")
    fetched = []
    _crash_at(monkeypatch, BamSource, "_fetch_range", 4, fetched)
    with pytest.raises(RuntimeError, match="simulated crash"):
        _storage(ledger, route, workers, policy).read(path)
    assert ReadLedger(ledger).completed_shards() == [0, 1, 2, 3]

    fetched.clear()
    _crash_at(monkeypatch, BamSource, "_fetch_range", None, fetched)
    ds = _storage(ledger, route, workers, policy).read(path)
    n_splits = ds.counters.shards
    assert n_splits > 5
    assert sorted(fetched) == list(range(4, n_splits))
    assert _device_backed(ds) == (route == "resident")
    assert not os.path.exists(os.path.join(ledger, "MANIFEST.json"))
    assert ReadLedger(ledger).completed_shards() == []

    want = (R.ReadsStorage.make_default().split_size(SPLIT)
            .error_policy(policy).read(path))
    _same_reads(columnar.as_read_batch(ds.reads), want.reads)
    clean = (P.ReadsStorage.make_default(device="cpu").split_size(SPLIT)
             .error_policy(policy).resident_decode(route == "resident")
             .read(path))
    assert [getattr(ds.counters, k) for k in COUNTS] == \
        [getattr(clean.counters, k) for k in COUNTS]
    assert ds.counters.skipped_blocks == (policy == "skip")


@pytest.mark.parametrize("first,second", [("host", "resident"),
                                          ("resident", "host")])
def test_ledger_keyed_by_the_route_taken(bam, tmp_path, monkeypatch, first,
                                         second):
    ledger = str(tmp_path / "ledger")
    fetched = []
    _crash_at(monkeypatch, BamSource, "_fetch_range", 4, fetched)
    with pytest.raises(RuntimeError):
        _storage(ledger, first, 1).read(bam["strict"])
    fetched.clear()
    _crash_at(monkeypatch, BamSource, "_fetch_range", None, fetched)
    ds = _storage(ledger, second, 1).read(bam["strict"])
    assert fetched == list(range(ds.counters.shards))
    assert _device_backed(ds) == (second == "resident")


@pytest.fixture(scope="module")
def cram(tmp_path_factory):
    """The reference's CRAM of 606 records without a reference, 3 write
    shards: several containers, spread over 4 KiB splits."""
    d = tmp_path_factory.mktemp("resume_cram")
    rng = np.random.default_rng(99)
    contigs = {name: rng.choice(list(b"ACGT"), size).astype(np.uint8)
               .tobytes() for name, size in DEFAULT_REFS}
    src, out = str(d / "in.bam"), str(d / "in.cram")
    with open(src, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS,
                               _synth_ref_matched(contigs, n=600),
                               sort_order="coordinate"))
    st = R.ReadsStorage.make_default().num_shards(3)
    st.write(st.read(src), out)
    return out


@pytest.mark.parametrize("route", ["host", "resident"])
def test_crashed_cram_read_resumes_only_unfinished_splits(
        cram, tmp_path, monkeypatch, route):
    ledger = str(tmp_path / "ledger")
    clean = (P.ReadsStorage.make_default(device="cpu").split_size(SPLIT)
             .resident_decode(route == "resident").read(cram))
    n_splits = clean.counters.shards
    crash = n_splits // 2
    fetched = []
    _crash_at(monkeypatch, CramSource, "_fetch_split_containers", crash,
              fetched)
    with pytest.raises(RuntimeError, match="simulated crash"):
        _storage(ledger, route, 1).read(cram)
    assert ReadLedger(ledger).completed_shards() == list(range(crash))

    fetched.clear()
    _crash_at(monkeypatch, CramSource, "_fetch_split_containers", None,
              fetched)
    ds = _storage(ledger, route, 1).read(cram)
    assert fetched == list(range(crash, n_splits))
    assert not os.path.exists(os.path.join(ledger, "MANIFEST.json"))
    want = R.ReadsStorage.make_default().split_size(SPLIT).read(cram)
    _same_reads(ds.reads, want.reads)
    assert [getattr(ds.counters, k) for k in COUNTS] == \
        [getattr(clean.counters, k) for k in COUNTS]


# -- spills of device-backed batches ------------------------------------------


def test_spilled_resident_batch_parses_again_on_its_device(bam):
    ds = (P.ReadsStorage.make_default(device="cpu").split_size(SPLIT)
          .resident_decode().read(bam["strict"]))
    batch = ds.reads
    assert batch.device_backed and batch.device.type == "cpu"
    back = pickle.loads(pickle.dumps(batch))
    assert back.device_backed and back.device.type == "cpu"
    for name, col in batch.device_columns().items():
        assert col.dtype == back.device_columns()[name].dtype
        assert bool((col == back.device_columns()[name]).all()), name
    _same_reads(back.to_read_batch(), batch.to_read_batch())


def test_cuda_spill_never_rebuilds_on_the_cpu(bam):
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is present: a cuda spill loads there")
    ds = (P.ReadsStorage.make_default(device="cpu").split_size(SPLIT)
          .resident_decode().read(bam["strict"]))
    fn, args = ds.reads.__reduce__()
    assert fn is columnar._rebuild_from_blob and args[-1] == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(*args[:-1], "cuda")
