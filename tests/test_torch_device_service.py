"""The port's cross-shard device service
(``disq_tpu_torch/runtime/device_service.py``) on the CPU, replaying the
contracts of ``tests/test_device_service.py`` and
``tests/test_device_write.py::TestServiceRoutedDeflate``.

The engines run the kernels' plain versions (``device="cpu"``), with the
chunk cap patched to the reference's 128 lanes. Flushes are made
deterministic: the services here wait 30 s before a timeout flush, so
only ``full`` and ``close()``'s ``drain`` flush them. End to end, the
BAM and CRAM reads through the service equal ``disq_tpu``'s at 1 and 4
executor workers, and a one-submission service deflate is byte for byte
the reference service's.
"""

import threading
import time
import zlib

import numpy as np
import pytest

from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
import disq_tpu.api as R
import disq_tpu_torch as P
from disq_tpu_torch.ops import inflate_simd as B1
from disq_tpu_torch.runtime import device_service as DS
from disq_tpu_torch.runtime.tracing import REGISTRY
from disq_tpu_torch.util import shutdown_shared_host_pool

SERVICE = "DISQ_TPU_TORCH_DEVICE_SERVICE"


def deflate(data: bytes, level: int = 6) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8)
    return c.compress(data) + c.flush()


def text_like(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"the", b"quick", b"brown", b"fox", b"!", b"\n"]
    out = b" ".join(words[i % 6] for i in rng.integers(0, 6, max(1, n // 3)))
    return (out + b"x" * n)[:n]


@pytest.fixture(scope="module", autouse=True)
def _join_threads():
    yield
    DS.shutdown_service()
    shutdown_shared_host_pool()


@pytest.fixture()
def lanes128(monkeypatch):
    monkeypatch.setattr(DS, "LANES", 128)


@pytest.fixture()
def service(lanes128):
    svc = DS.DeviceDecodeService("cpu", flush_timeout_s=30.0)
    yield svc
    svc.close()


def _flushes():
    return dict(REGISTRY.counter("device.batch.flush")._snapshot())


def _delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def test_arena_pool_checkout_is_exclusive():
    key_a, a = B1.ARENAS.acquire("test", 100, pinned=False)
    key_b, b = B1.ARENAS.acquire("test", 100, pinned=False)
    assert a is not b and key_a == key_b and a.numel() == 1 << 20
    B1.ARENAS.release(key_a, a)
    key_c, c = B1.ARENAS.acquire("test", 1 << 20, pinned=False)
    assert c is a  # a returned arena is reused, not reallocated
    B1.ARENAS.release(key_b, b)
    B1.ARENAS.release(key_c, c)
    assert REGISTRY.gauge("device.arena_bytes").state()["last"] > 0


def test_staged_arrays_round_trip():
    arrays = [[b"ab", memoryview(b"cde")], np.arange(3, dtype=np.int64),
              np.array([[1, 2], [3, 4]], dtype=np.int32)]
    staged = B1.Staged("test", arrays, "cpu")
    raw, idx, mat = staged.tensors
    assert bytes(raw.numpy()) == b"abcde"
    assert idx.tolist() == [0, 1, 2] and mat.tolist() == [[1, 2], [3, 4]]
    staged.release()


def test_per_split_route_stages_through_one_arena(monkeypatch):
    """The per-split B1 route packs its inputs with ``Staged``: one arena
    checked out per call and returned, on a flagged block too."""
    pool = B1.ArenaPool()
    monkeypatch.setattr(B1, "ARENAS", pool)
    raws = [text_like(3000 + 100 * i, seed=i) for i in range(3)]
    payloads = [deflate(r) for r in raws]
    data = np.frombuffer(b"".join(payloads), np.uint8)
    pay_len = np.array([len(p) for p in payloads], np.int64)
    pay_off = np.concatenate([[0], np.cumsum(pay_len)[:-1]]).astype(np.int64)
    usizes = np.array([len(r) for r in raws])
    for _ in range(2):
        blob, out_off = B1.inflate_payloads_device(data, pay_off, pay_len,
                                                   usizes, "cpu")
        assert blob.numpy().tobytes() == b"".join(raws)
        assert list(np.diff(out_off)) == list(usizes)
    with pytest.raises(ValueError, match="block 1"):
        B1.inflate_payloads_device(data, pay_off,
                                   pay_len - np.array([0, 40, 0]),
                                   usizes, "cpu")
    assert pool.resident_bytes() == 1 << 20  # one arena, reused
    assert [len(v) for v in pool._free.values()] == [1]


def test_traced_owners_book_their_share_of_a_launch(service):
    """Two traced submissions coalesced into one launch: the launch books
    ``device.batch.requests{requests=2}`` and one
    ``device.batch.share`` span under each owner's trace."""
    from disq_tpu_torch.runtime import tracing as T

    before = REGISTRY.counter("device.batch.requests").value(requests="2")
    T.reset_spans()
    subs = []
    for k in range(2):
        raws = [text_like(100 + j, seed=10 * k + j) for j in range(3 + k)]
        with T.trace_scope(T.TraceContext(f"t{k}", f"s{k}", "lab")):
            assert T.current_trace().trace_id == f"t{k}"
            subs.append((raws, service.submit_inflate(
                [deflate(r) for r in raws], [len(r) for r in raws])))
    assert T.current_trace() is None
    service.close()
    for raws, sub in subs:
        assert sub.result(timeout=60)[0].tobytes() == b"".join(raws)
    assert REGISTRY.counter("device.batch.requests").value(
        requests="2") == before + 1
    shares = sorted((s["trace"], s["parent"], s["labels"]["lanes"],
                     s["labels"]["batch_lanes"]) for s in T.spans()
                    if s["name"] == "device.batch.share")
    assert shares == [("t0", "s0", 3, 7), ("t1", "s1", 4, 7)]


def test_coalesces_lanes_across_submissions(service):
    """Three shards' 30 lanes each: one 90-lane launch, not three."""
    before = _flushes()
    shard_raws = [[text_like(80 + 5 * i + 60 * s, seed=10 * s + i)
                   for i in range(30)] for s in range(3)]
    subs = [service.submit_inflate([deflate(r) for r in raws],
                                   [len(r) for r in raws])
            for raws in shard_raws]
    service.close()
    for raws, sub in zip(shard_raws, subs):
        blob, offsets = sub.result(timeout=60)
        assert blob.tobytes() == b"".join(raws)
        assert list(np.diff(offsets)) == [len(r) for r in raws]
    assert _delta(before, _flushes()) == {"reason=drain": 1}
    fill = REGISTRY.gauge("device.lane_fill").state()
    assert abs(fill["last"] - 90 / 128) < 1e-12


def test_full_chunk_flushes_without_timeout(service):
    """130 queued lanes: one full chunk of 128 at once, the other 2 at
    close."""
    before = _flushes()
    raws = [text_like(60 + i % 9, seed=i) for i in range(130)]
    sub = service.submit_inflate([deflate(r) for r in raws],
                                 [len(r) for r in raws])
    for _ in range(600):
        if _delta(before, _flushes()).get("reason=full"):
            break
        time.sleep(0.05)
    assert _delta(before, _flushes()) == {"reason=full": 1}
    service.close()
    blob, _ = sub.result(timeout=60)
    assert blob.tobytes() == b"".join(raws)
    assert _delta(before, _flushes()) == {"reason=full": 1,
                                          "reason=drain": 1}


def test_corrupt_lane_fails_its_owner_only(service):
    good_raws = [text_like(150 + 4 * i, seed=40 + i) for i in range(8)]
    good = service.submit_inflate([deflate(r) for r in good_raws],
                                  [len(r) for r in good_raws])
    bad_raw = text_like(400, seed=99)
    truncated = deflate(bad_raw)[: len(deflate(bad_raw)) // 2]
    owner = service.submit_inflate([deflate(good_raws[0]), truncated],
                                   [len(good_raws[0]), len(bad_raw)])
    service.close()
    with pytest.raises(ValueError, match="corrupt DEFLATE"):
        owner.result(timeout=60)
    (blob, offsets), errors = owner.outcome(timeout=60)
    assert list(errors) == [1]
    assert blob[: offsets[1]].tobytes() == good_raws[0]
    blob, _ = good.result(timeout=60)
    assert blob.tobytes() == b"".join(good_raws)


def test_lane_accounting_invariant(service, monkeypatch):
    """device_lanes + host_fallback + host_big == submitted; a lane the
    kernel flags that host zlib inflates is delivered all the same."""
    real = B1.inflate

    def flag_third(*args):
        out, out_len, status = real(*args)
        status[3] = 3
        return out, out_len, status

    monkeypatch.setattr(B1, "inflate", flag_third)
    snap, fb = dict(B1.last_stats), REGISTRY.counter(
        "device.host_fallback_blocks").value(reason="flagged")
    raws = [text_like(100 + 7 * i, seed=60 + i) for i in range(12)]
    sub = service.submit_inflate([deflate(r) for r in raws],
                                 [len(r) for r in raws])
    service.close()
    blob, _ = sub.result(timeout=60)
    assert blob.tobytes() == b"".join(raws)
    delta = {k: B1.last_stats[k] - snap[k] for k in snap}
    assert delta == {"device_lanes": 11, "host_big": 0, "host_fallback": 1}
    assert sum(delta.values()) == len(raws)
    assert REGISTRY.counter("device.host_fallback_blocks").value(
        reason="flagged") - fb == 1


def test_rans_streams_coalesce_and_roundtrip(service):
    from disq_tpu_torch.cram.rans import rans_encode_order0

    before = _flushes()
    shard_raws = [[bytes((7 * i + s + j) % 251 for j in range(96 + 8 * i))
                   for i in range(6)] for s in range(2)]
    subs = [service.submit_rans([rans_encode_order0(r) for r in raws])
            for raws in shard_raws]
    # a stream that does not parse fails its own lane, on this thread
    owner = service.submit_rans([rans_encode_order0(b"abc" * 50),
                                 b"\x01" + bytes(8)])
    service.close()
    for raws, sub in zip(shard_raws, subs):
        assert sub.result(timeout=60) == raws
    parts, errors = owner.outcome(timeout=60)
    assert parts[0] == b"abc" * 50 and list(errors) == [1]
    assert errors[1].stream == 1
    assert _delta(before, _flushes()) == {"reason=drain": 1}


def test_close_drains_a_partial_chunk(lanes128):
    svc = DS.DeviceDecodeService("cpu", flush_timeout_s=30.0)
    raws = [text_like(90 + i, seed=i) for i in range(5)]
    sub = svc.submit_inflate([deflate(r) for r in raws],
                             [len(r) for r in raws])
    svc.close()
    blob, _ = sub.result(timeout=10)
    assert blob.tobytes() == b"".join(raws)
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit_inflate([deflate(b"x")], [1])


def test_timeout_flush(lanes128):
    svc = DS.DeviceDecodeService("cpu", flush_timeout_s=0.01)
    try:
        before = _flushes()
        sub = svc.submit_inflate([deflate(b"abc" * 30)], [90])
        assert sub.result(timeout=30)[0].tobytes() == b"abc" * 30
        assert _delta(before, _flushes()) == {"reason=timeout": 1}
    finally:
        svc.close()


def test_submit_deflate_rejects_an_oversize_payload(service):
    with pytest.raises(ValueError, match="too large"):
        service.submit_deflate([b"x" * 65281])


def test_service_deflate_bytes_equal_reference(service):
    """One submission of at most the cap, flushed by close: the chunk's
    table, and so every block, is the reference service's."""
    from disq_tpu.runtime.device_service import DeviceDecodeService

    rng = np.random.default_rng(1)
    blob = (b"quality-run " * 9000
            + rng.integers(0, 16, 70_000, np.uint8).tobytes())
    payloads = [blob[o: o + 65280] for o in range(0, len(blob), 65280)]
    payloads.append(rng.integers(0, 256, 3000, np.uint8).tobytes())
    sub = service.submit_deflate(payloads)
    service.close()
    ref_svc = DeviceDecodeService(flush_timeout_s=30.0, interpret=True)
    ref_sub = ref_svc.submit_deflate(payloads)
    ref_svc.close()
    got, want = sub.result(timeout=60), ref_sub.result(timeout=60)
    assert got == want
    for block, p in zip(got, payloads):
        assert zlib.decompress(block[18:-8], -15) == p


def test_cross_shard_deflate_submissions_stay_isolated(monkeypatch):
    from concurrent.futures import ThreadPoolExecutor

    from disq_tpu_torch.bgzf.codec import deflate_blob

    monkeypatch.setenv(SERVICE, "1")
    blobs = [bytes([65 + i]) * (30_000 + 1000 * i) + text_like(70_000, i)
             for i in range(6)]
    try:
        with ThreadPoolExecutor(max_workers=6) as pool:
            outs = list(pool.map(lambda b: deflate_blob(b, device="cpu"),
                                 blobs))
    finally:
        DS.shutdown_service()
    for blob, (comp, sizes) in zip(blobs, outs):
        assert int(sizes.sum()) == len(comp)
        walked, at = [], 0
        for size in sizes:
            walked.append(zlib.decompress(comp[at + 18: at + size - 8], -15))
            at += int(size)
        assert b"".join(walked) == blob


def test_disabled_path_runs_no_service(monkeypatch, tmp_path):
    """Knob unset: no service, no dispatcher thread, no arena, after a
    resident BAM read and a CRAM read."""
    monkeypatch.delenv(SERVICE, raising=False)
    DS.shutdown_service()
    assert not DS.enabled()
    path = tmp_path / "in.bam"
    path.write_bytes(make_bam_bytes(DEFAULT_REFS, synth_records(60, seed=3),
                                    blocksize=2000))
    storage = P.ReadsStorage.make_default(device="cpu").resident_decode()
    ds = storage.read(str(path))
    cram = str(tmp_path / "out.cram")
    storage.write(ds.coordinate_sorted(), cram)
    assert storage.read(cram).count() == 60
    assert DS.service_if_running() is None
    assert not [t for t in threading.enumerate()
                if t.name.startswith("disq-device")]


# -- end to end through the read and write paths ------------------------------


@pytest.fixture(scope="module")
def small_bam(tmp_path_factory):
    path = tmp_path_factory.mktemp("svc") / "in.bam"
    path.write_bytes(make_bam_bytes(DEFAULT_REFS, synth_records(150, seed=21),
                                    blocksize=1500))
    return str(path)


def _same_reads(got, want):
    for col in ("refid", "pos", "mapq", "bin", "flag", "next_refid",
                "next_pos", "tlen", "names", "cigars", "seqs", "quals",
                "tags"):
        np.testing.assert_array_equal(getattr(got, col), getattr(want, col),
                                      err_msg=col)


@pytest.mark.parametrize("workers", [1, 4])
def test_bam_read_through_the_service_equals_reference(small_bam,
                                                       monkeypatch, workers):
    want = R.ReadsStorage.make_default().read(small_bam)
    monkeypatch.setenv(SERVICE, "1")
    before = _flushes()
    try:
        got = (P.ReadsStorage.make_default(device="cpu").split_size(6000)
               .resident_decode().executor_workers(workers).read(small_bam))
        assert DS.service_if_running() is not None
    finally:
        DS.shutdown_service()
    assert got.reads.device_backed and got.count() == want.count() == 150
    _same_reads(got.reads, want.reads)
    assert sum(_delta(before, _flushes()).values()) >= 1


def test_bam_read_through_the_service_salvages_like_reference(
        small_bam, tmp_path, monkeypatch):
    """One payload byte flipped: the block both B1 and host zlib reject
    is skipped on the service route as on the reference's host route."""
    from disq_tpu_torch.bgzf.guesser import walk_blocks_collect
    from disq_tpu_torch.fsw.filesystem import resolve_path

    fs, path = resolve_path(small_bam)
    blocks, _ = walk_blocks_collect(fs, path, 0, fs.get_file_length(path),
                                    fs.get_file_length(path))
    victim = [b for b in blocks if b.usize > 0][len(blocks) // 2]
    data = bytearray(open(small_bam, "rb").read())
    data[victim.pos + 24] ^= 1 << 5
    bad = tmp_path / "bad.bam"
    bad.write_bytes(bytes(data))
    want = (R.ReadsStorage.make_default().split_size(6000)
            .error_policy("skip").read(str(bad)))
    monkeypatch.setenv(SERVICE, "1")
    try:
        got = (P.ReadsStorage.make_default(device="cpu").split_size(6000)
               .resident_decode().error_policy("skip").executor_workers(4)
               .read(str(bad)))
    finally:
        DS.shutdown_service()
    assert got.counters.skipped_blocks == want.counters.skipped_blocks == 1
    assert got.count() == want.count() < 150
    _same_reads(got.reads, want.reads)


@pytest.mark.parametrize("workers", [1, 4])
def test_cram_read_through_the_service_equals_reference(small_bam, tmp_path,
                                                        monkeypatch, workers):
    from disq_tpu_torch.ops import rans_simd as B3

    monkeypatch.setenv("DISQ_TPU_TORCH_CRAM_RANS_O1", "0")
    storage = P.ReadsStorage.make_default(device="cpu")
    cram = str(tmp_path / "out.cram")
    storage.num_shards(3).write(storage.read(small_bam).coordinate_sorted(),
                                cram)
    want = R.ReadsStorage.make_default().read(cram)
    monkeypatch.setenv(SERVICE, "1")
    lanes = B3.last_stats["device_lanes"]
    try:
        got = (storage.split_size(4000).resident_decode()
               .executor_workers(workers).read(cram))
    finally:
        DS.shutdown_service()
    assert B3.last_stats["device_lanes"] - lanes >= 3
    assert got.count() == want.count() == 150
    _same_reads(got.reads, want.reads)


def test_device_write_through_the_service_rereads(small_bam, tmp_path,
                                                  monkeypatch):
    want = R.ReadsStorage.make_default().read(small_bam)
    out = str(tmp_path / "dev.bam")
    monkeypatch.setenv(SERVICE, "1")
    storage = P.ReadsStorage.make_default(device="cpu")
    ds = storage.read(small_bam)
    blocks = REGISTRY.counter("device.deflate.blocks").total()
    try:
        storage.num_shards(5).device_deflate().writer_workers(4).write(ds, out)
    finally:
        DS.shutdown_service()
    assert REGISTRY.counter("device.deflate.blocks").total() > blocks
    _same_reads(storage.read(out).reads, want.reads)
