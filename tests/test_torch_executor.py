"""The port's shard executor and write pipeline, on the CPU.

- The unit contracts of the reference's ``tests/test_executor.py`` and
  ``tests/test_write_pipeline.py``, on the port's classes: order, empty
  input, inline ``workers=1``, bounded window, overlap past a stalled
  shard, error propagation, transient retry, sizing from the storage,
  invalid widths rejected.
- A BAM read at ``executor_workers`` 1 and 4 (host route and the device
  route's plain versions) equal to each other and to ``disq_tpu``'s.
- A sorted BAM + BAI at ``writer_workers`` 1 and 4 byte-identical to each
  other and to ``disq_tpu``'s, with ``num_shards`` pinned on both sides.
- The kernels' books under 4 decode threads: the same launch and lane
  counts as with 1.
"""

import threading
import time

import numpy as np
import pytest

import disq_tpu.api as R
from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
import disq_tpu_torch as P
from disq_tpu_torch.ops import inflate_simd as B1
from disq_tpu_torch.runtime import counters
from disq_tpu_torch.runtime.errors import ShardRetrier, TransientIOError
from disq_tpu_torch.runtime.executor import (
    ShardPipelineExecutor,
    ShardTask,
    ShardWritePipeline,
    WriteShardTask,
    executor_for_storage,
    run_write_stage,
    writer_for_storage,
)
from disq_tpu_torch.util import shutdown_shared_host_pool

FIELDS = ("refid", "pos", "mapq", "bin", "flag", "next_refid", "next_pos",
          "tlen", "name_offsets", "names", "cigar_offsets", "cigars",
          "seq_offsets", "seqs", "quals", "tag_offsets", "tags")


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    """Leave no idle pool threads behind for later tests in the process."""
    yield
    shutdown_shared_host_pool()


# -- the read executor ---------------------------------------------------------


def _read_tasks(n, fetch_log=None, sleep=0.0):
    def mk(i):
        def fetch():
            if sleep:
                time.sleep(sleep)
            if fetch_log is not None:
                fetch_log.append(i)
            return i * 10

        return ShardTask(shard_id=i, fetch=fetch, decode=lambda p: p + 1)

    return [mk(i) for i in range(n)]


@pytest.mark.parametrize("workers", [1, 2, 8])
def test_ordered_results(workers):
    ex = ShardPipelineExecutor(workers=workers)
    results = list(ex.map_ordered(_read_tasks(23, sleep=0.001)))
    assert [r.shard_id for r in results] == list(range(23))
    assert [r.value for r in results] == [i * 10 + 1 for i in range(23)]
    assert ex.stats.shards == 23


def test_empty_tasks():
    assert list(ShardPipelineExecutor(workers=4).map_ordered([])) == []


def test_sequential_runs_inline_in_order():
    log = []
    for res in ShardPipelineExecutor(workers=1).map_ordered(
            _read_tasks(5, fetch_log=log)):
        assert log == list(range(res.shard_id + 1))


def test_bounded_in_flight_window():
    ex = ShardPipelineExecutor(workers=2, prefetch_shards=3)
    release = threading.Event()

    def mk(i):
        def fetch():
            if i == 0:
                release.wait(timeout=30)
            return i

        return ShardTask(shard_id=i, fetch=fetch, decode=lambda p: p)

    it = iter(ex.map_ordered([mk(i) for i in range(12)]))
    time.sleep(0.2)
    assert ex.stats.max_in_flight <= ex.stats.window == 3
    release.set()
    assert [r.value for r in it] == list(range(12))


def test_stalled_shard_does_not_block_window_peers():
    ex = ShardPipelineExecutor(workers=2, prefetch_shards=4)
    release = threading.Event()
    decoded = []

    def mk(i):
        def fetch():
            if i == 0:
                release.wait(timeout=30)
            return i

        def decode(p):
            decoded.append(i)
            return p

        return ShardTask(shard_id=i, fetch=fetch, decode=decode)

    it = iter(ex.map_ordered([mk(i) for i in range(6)]))
    deadline = time.time() + 10
    while len([d for d in decoded if d != 0]) < 2:
        assert time.time() < deadline, "no overlap while shard 0 stalled"
        time.sleep(0.01)
    release.set()
    assert [r.shard_id for r in it] == list(range(6))


@pytest.mark.parametrize("workers", [1, 4])
def test_error_propagates(workers):
    def boom(_):
        raise ValueError("decode broke")

    tasks = [ShardTask(shard_id=0, fetch=lambda: 1, decode=lambda p: p),
             ShardTask(shard_id=1, fetch=lambda: 1, decode=boom)]
    it = ShardPipelineExecutor(workers=workers).map_ordered(tasks)
    assert next(it).shard_id == 0
    with pytest.raises(ValueError, match="decode broke"):
        list(it)


@pytest.mark.parametrize("workers", [1, 4])
def test_transient_fetch_retried(workers):
    fails = {"n": 2}

    def fetch():
        if fails["n"] > 0:
            fails["n"] -= 1
            raise TransientIOError("blip")
        return 7

    retrier = ShardRetrier(max_retries=4, backoff_s=0.0)
    tasks = [ShardTask(shard_id=0, fetch=fetch, decode=lambda p: p,
                       retrier=retrier)]
    out = list(ShardPipelineExecutor(workers=workers).map_ordered(tasks))
    assert out[0].value == 7 and retrier.retried == 2


def test_transient_decode_reruns_from_fetch():
    fetched, failed = [], {"n": 1}

    def fetch():
        fetched.append(1)
        return len(fetched)

    def decode(p):
        if failed["n"] > 0:
            failed["n"] -= 1
            raise TransientIOError("mid-decode blip")
        return p

    retrier = ShardRetrier(max_retries=3, backoff_s=0.0)
    tasks = [ShardTask(shard_id=0, fetch=fetch, decode=decode,
                       retrier=retrier)]
    out = list(ShardPipelineExecutor(workers=2).map_ordered(tasks))
    assert out[0].value == 2 and len(fetched) == 2 and retrier.retried >= 1


def test_executor_sized_from_storage():
    assert executor_for_storage(P.ReadsStorage.make_default()).workers == 1
    ex = executor_for_storage(P.ReadsStorage.make_default()
                              .executor_workers(6, 9))
    assert ex.workers == 6 and ex.prefetch_shards == 9
    with pytest.raises(ValueError, match="executor_workers"):
        P.ReadsStorage.make_default().executor_workers(0)


# -- the write pipeline --------------------------------------------------------


def _write_tasks(n, log=None, sleep=0.0):
    def mk(i):
        def encode():
            if sleep:
                time.sleep(sleep)
            return i * 10

        def stage(p):
            if log is not None:
                log.append(i)
            return p * 2

        return WriteShardTask(shard_id=i, encode=encode,
                              deflate=lambda p: p + 1, stage=stage)

    return [mk(i) for i in range(n)]


@pytest.mark.parametrize("workers", [1, 4, 8])
def test_write_ordered_results(workers):
    pipe = ShardWritePipeline(workers=workers)
    results = list(pipe.map_ordered(_write_tasks(17, sleep=0.001)))
    assert [r.shard_id for r in results] == list(range(17))
    assert [r.value for r in results] == [(i * 10 + 1) * 2 for i in range(17)]


def test_write_empty_and_optional_stages():
    assert list(ShardWritePipeline(workers=4).map_ordered([])) == []
    for workers in (1, 4):
        tasks = [WriteShardTask(shard_id=0, encode=lambda: 7)]
        out = list(ShardWritePipeline(workers=workers).map_ordered(tasks))
        assert out[0].value == 7


def test_write_sequential_runs_inline_in_order():
    log = []
    for res in ShardWritePipeline(workers=1).map_ordered(
            _write_tasks(5, log=log)):
        assert log == list(range(res.shard_id + 1))


def test_write_bounded_in_flight_window():
    pipe = ShardWritePipeline(workers=2, prefetch_shards=3)
    release = threading.Event()

    def mk(i):
        def encode():
            if i == 0:
                release.wait(timeout=30)
            return i

        return WriteShardTask(shard_id=i, encode=encode)

    it = iter(pipe.map_ordered([mk(i) for i in range(12)]))
    time.sleep(0.2)
    assert pipe.stats.max_in_flight <= pipe.stats.window == 3
    release.set()
    assert [r.value for r in it] == list(range(12))
    assert pipe.stats.shards == 12


@pytest.mark.parametrize("workers", [1, 4])
def test_write_error_propagates(workers):
    def boom(_):
        raise ValueError("stage broke")

    tasks = [WriteShardTask(shard_id=0, encode=lambda: 1),
             WriteShardTask(shard_id=1, encode=lambda: 1, stage=boom)]
    it = ShardWritePipeline(workers=workers).map_ordered(tasks)
    assert next(it).shard_id == 0
    with pytest.raises(ValueError, match="stage broke"):
        list(it)


@pytest.mark.parametrize("workers", [1, 4])
def test_transient_stage_retried(workers):
    fails = {"n": 2}

    def stage(p):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise TransientIOError("blip")
        return p

    retrier = ShardRetrier(max_retries=4, backoff_s=0.0)
    tasks = [WriteShardTask(shard_id=0, encode=lambda: 5, stage=stage,
                            retrier=retrier)]
    out = list(ShardWritePipeline(workers=workers).map_ordered(tasks))
    assert out[0].value == 5 and retrier.retried == 2


def test_run_write_stage_orders_by_shard():
    pipe = ShardWritePipeline(workers=3)
    assert run_write_stage(pipe, 7, lambda k: WriteShardTask(
        shard_id=k, encode=lambda k=k: k * k)) == [k * k for k in range(7)]


def test_writer_sized_from_storage():
    assert writer_for_storage(P.ReadsStorage.make_default()).workers == 1
    pipe = writer_for_storage(P.ReadsStorage.make_default()
                              .writer_workers(6, 9))
    assert pipe.workers == 6 and pipe.prefetch_shards == 9
    with pytest.raises(ValueError, match="writer_workers"):
        P.ReadsStorage.make_default().writer_workers(0)


# -- the read and the write at several widths ---------------------------------


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    path = tmp_path_factory.mktemp("executor") / "in.bam"
    path.write_bytes(make_bam_bytes(
        DEFAULT_REFS, synth_records(1500, seed=21, unmapped_tail=12),
        blocksize=2000))
    return str(path)


def _assert_same_reads(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_read_identical_at_any_width(bam, resident):
    ref = R.ReadsStorage.make_default().split_size(6000).read(bam)
    counts = {}
    for workers in (1, 4):
        got = (P.ReadsStorage.make_default(device="cpu").split_size(6000)
               .resident_decode(resident).executor_workers(workers).read(bam))
        assert got.count() == ref.count()
        _assert_same_reads(got.reads, ref.reads)
        assert getattr(got.reads, "device_backed", False) == resident
        c = got.counters
        counts[workers] = (c.shards, c.records, c.blocks, c.bytes_compressed,
                           c.bytes_uncompressed)
    rc = ref.counters
    assert counts[1] == counts[4] == (rc.shards, rc.records, rc.blocks,
                                      rc.bytes_compressed,
                                      rc.bytes_uncompressed)


@pytest.mark.parametrize("num_shards", [1, 4])
def test_sorted_write_identical_at_any_width(bam, tmp_path, num_shards):
    ref_ds = R.ReadsStorage.make_default().read(bam)
    ref_out = tmp_path / "ref.bam"
    R.ReadsStorage.make_default().num_shards(num_shards).writer_workers(4) \
        .write(ref_ds, str(ref_out), R.BaiWriteOption.ENABLE, sort=True)
    port_ds = P.ReadsStorage.make_default(device="cpu").read(bam)
    for workers in (1, 4):
        out = tmp_path / f"port{workers}.bam"
        (P.ReadsStorage.make_default(device="cpu").num_shards(num_shards)
         .writer_workers(workers)
         .write(port_ds, str(out), P.BaiWriteOption.ENABLE, sort=True))
        assert out.read_bytes() == ref_out.read_bytes()
        assert (tmp_path / f"port{workers}.bam.bai").read_bytes() == \
            (tmp_path / "ref.bam.bai").read_bytes()


def test_books_exact_under_decode_threads(bam):
    """4 decode threads on the device route's plain versions book the
    same B1 lanes as 1 thread; the counters' lock keeps every add."""
    lanes = {}
    for workers in (1, 4):
        before = B1.last_stats["device_lanes"]
        (P.ReadsStorage.make_default(device="cpu").split_size(3000)
         .resident_decode().executor_workers(workers).read(bam))
        lanes[workers] = B1.last_stats["device_lanes"] - before
    assert lanes[1] == lanes[4] > 10

    stats = {"n": 0}

    def bump():
        for _ in range(2000):
            counters.add_stats(stats, n=1)
            counters.book_launch("test_kernel")

    counters.reset()
    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert stats["n"] == 16000
    assert counters.snapshot()["launches"] == {"test_kernel": 16000}
    counters.reset()
