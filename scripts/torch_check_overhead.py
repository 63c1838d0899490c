#!/usr/bin/env python
"""The port's zero-overhead guard: with nothing armed, a read and a
write of ``disq_tpu_torch`` build nothing they do not use, and the
per-shard hooks stay cheap. The counterpart of
``scripts/check_overhead.py`` sections 1d, 1f and 2-4, over
``disq_tpu_torch`` alone, on the CPU.

1d. **The mesh off is free.** With no mesh knob, a default device-route
    read (``resident_decode`` on the CPU) and its flagstat build no
    mesh (``mesh_if_built() is None``), the read's batch carries none,
    ``service_devices()`` is ``[None]``, and no ``device.mesh.*``
    counter moves.
1f. **The operator suite off is free.** After a default read and write
    no operator module (``runtime/oppipe``, ``ops/rfilter``,
    ``ops/markdup``, ``ops/pileup``, ``ops/rgstats``) is imported,
    ``BamSource._read_filter()`` is None, and no ``ops.*`` counter
    moves.
2.  The inline executor (one worker, trivial tasks) costs at most
    ``SHARD_BUDGET_US`` a shard.
3.  ``note_shard_counters`` with nothing watching costs at most
    ``NOTE_BUDGET_US`` a call.
4.  ``flightrec.record_event`` with the recorder off costs at most
    ``NOTE_BUDGET_US`` a call and allocates no recorder.

The timings are medians of ``ROUNDS`` rounds against generous absolute
budgets: the guard is against accidental O(ms) work on the disabled
path, not against the microseconds a span inherently costs.

Run it in a fresh interpreter (the planes are process-global):
``python scripts/torch_check_overhead.py`` prints ``OK`` and exits 0.
"""

from __future__ import annotations

import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHARD_BUDGET_US = 500.0      # per-shard inline-executor overhead
NOTE_BUDGET_US = 5.0         # per-call note_shard_counters / record_event
ROUNDS = 5
SHARDS = 400
NOTE_CALLS = 20000

KNOBS = ("DISQ_TPU_TORCH_MESH", "DISQ_TPU_TORCH_FORCE_DEVICE_COUNT",
         "DISQ_TPU_TORCH_READ_FILTER", "DISQ_TPU_TORCH_RESIDENT_DECODE")
OP_MODULES = ("disq_tpu_torch.runtime.oppipe", "disq_tpu_torch.ops.rfilter",
              "disq_tpu_torch.ops.markdup", "disq_tpu_torch.ops.pileup",
              "disq_tpu_torch.ops.rgstats")
OP_COUNTERS = ("ops.filter.records_in", "ops.filter.records_kept",
               "ops.markdup.duplicates", "ops.markdup.boundary_flips",
               "ops.pileup.records")
MESH_COUNTERS = ("device.mesh.reshard_bytes", "device.mesh.exchange_bytes",
                 "device.mesh.batches")


def _median_per_unit_us(fn, units: int, rounds: int = ROUNDS) -> float:
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) / units * 1e6)
    return statistics.median(times)


def _small_bam(path: str) -> None:
    """A seeded 120-record BAM of two references, written by the port's
    own host route."""
    import numpy as np

    from disq_tpu_torch.api import ReadsDataset, ReadsStorage
    from disq_tpu_torch.bam.columnar import ReadBatch
    from disq_tpu_torch.bam.header import SamHeader

    rng = np.random.default_rng(7)
    n = 120
    header = SamHeader.build([("chr1", 100_000), ("chr2", 50_000)])
    refid = np.sort(rng.integers(0, 2, n)).astype(np.int32)
    pos = rng.integers(0, 40_000, n).astype(np.int32)
    l_seq = 20
    cig = np.full(n, (l_seq << 4) | 0, dtype=np.uint32)
    names = np.frombuffer(b"".join(b"r%04d" % i for i in range(n)), np.uint8)
    batch = ReadBatch(
        refid=refid, pos=pos, mapq=np.full(n, 60, np.uint8),
        bin=np.zeros(n, np.uint16), flag=np.zeros(n, np.uint16),
        next_refid=np.full(n, -1, np.int32), next_pos=np.full(n, -1, np.int32),
        tlen=np.zeros(n, np.int32),
        name_offsets=np.arange(n + 1, dtype=np.int64) * 5, names=names,
        cigar_offsets=np.arange(n + 1, dtype=np.int64), cigars=cig,
        seq_offsets=np.arange(n + 1, dtype=np.int64) * l_seq,
        seqs=rng.integers(1, 16, n * l_seq).astype(np.uint8),
        quals=rng.integers(0, 40, n * l_seq).astype(np.uint8),
        tag_offsets=np.zeros(n + 1, dtype=np.int64),
        tags=np.zeros(0, np.uint8))
    st = ReadsStorage.make_default(device="cpu")
    st.write(ReadsDataset(header=header, reads=batch), path)


def main() -> int:
    errors = []
    for knob in KNOBS:
        if os.environ.get(knob):
            errors.append(f"{knob} leaked into the guard's env — the "
                          "default path must run with it unset")

    from disq_tpu_torch.api import ReadsStorage
    from disq_tpu_torch.runtime import flightrec
    from disq_tpu_torch.runtime import mesh as mesh_mod
    from disq_tpu_torch.runtime.counters import ShardCounters
    from disq_tpu_torch.runtime.executor import (
        ShardPipelineExecutor, ShardTask)
    from disq_tpu_torch.runtime.introspect import note_shard_counters
    from disq_tpu_torch.runtime.tracing import REGISTRY

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "in.bam")
        _small_bam(path)
        st = ReadsStorage.make_default(device="cpu").resident_decode()
        ds = st.read(path)
        ds.flagstat()
        st.write(ds, os.path.join(tmp, "out.bam"), sort=True)

        # -- 1d. the mesh off ----------------------------------------------
        if mesh_mod.mesh_devices_requested(st) is not None:
            errors.append("mesh_devices_requested(default storage) is not "
                          "None — reads would take the mesh by default")
        if getattr(ds.reads, "mesh", None) is not None:
            errors.append("a default read's batch carries a mesh")
        if mesh_mod.mesh_if_built() is not None:
            errors.append("a Mesh exists with no mesh knob set — a default "
                          "code path built one")
        if mesh_mod.service_devices("cpu") != [None]:
            errors.append("service_devices() is not [None] with the mesh "
                          "off — the device service must keep one queue")
        for name in MESH_COUNTERS:
            if REGISTRY.counter(name).total() != 0:
                errors.append(f"{name} is nonzero on the mesh-off path")

        # -- 1f. the operator suite off ------------------------------------
        from disq_tpu_torch.bam.source import BamSource

        class _FilterlessSource(BamSource):
            def __init__(self):  # probe _read_filter without a file
                self._storage = st

        if _FilterlessSource()._read_filter() is not None:
            errors.append("BamSource._read_filter() built a filter with "
                          "no spec configured")
        loaded = [m for m in OP_MODULES if m in sys.modules]
        if loaded:
            errors.append(f"operator modules imported on the suite-off "
                          f"path: {loaded}")
        for name in OP_COUNTERS:
            if REGISTRY.counter(name).total() != 0:
                errors.append(f"{name} is nonzero on the suite-off path")

    # -- 2. per-shard inline-executor overhead -----------------------------
    def run_executor():
        tasks = [ShardTask(shard_id=i, fetch=lambda: 0,
                           decode=lambda payload: payload)
                 for i in range(SHARDS)]
        for _ in ShardPipelineExecutor(workers=1).map_ordered(tasks):
            pass

    run_executor()  # warm-up
    per_shard_us = _median_per_unit_us(run_executor, SHARDS)
    if per_shard_us > SHARD_BUDGET_US:
        errors.append(f"inline executor costs {per_shard_us:.1f} us/shard "
                      f"(budget {SHARD_BUDGET_US} us)")

    # -- 3. note_shard_counters with nothing watching ----------------------
    counters = ShardCounters(shard_id=0)

    def run_notes():
        for _ in range(NOTE_CALLS):
            note_shard_counters("read", counters)

    run_notes()  # warm-up
    per_note_us = _median_per_unit_us(run_notes, NOTE_CALLS)
    if per_note_us > NOTE_BUDGET_US:
        errors.append(f"note_shard_counters costs {per_note_us:.2f} us/call "
                      f"(budget {NOTE_BUDGET_US} us)")

    # -- 4. record_event with the recorder off -----------------------------
    def run_events():
        for _ in range(NOTE_CALLS):
            flightrec.record_event("retry", what="x")

    run_events()  # warm-up
    per_event_us = _median_per_unit_us(run_events, NOTE_CALLS)
    if per_event_us > NOTE_BUDGET_US:
        errors.append(f"flightrec.record_event costs {per_event_us:.2f} "
                      f"us/call (budget {NOTE_BUDGET_US} us)")
    if flightrec.recorder() is not None:
        errors.append("record_event on the disabled path allocated a "
                      "recorder")

    if errors:
        print(f"torch_check_overhead: {len(errors)} problem(s)")
        for e in errors:
            print(f"  - {e}")
        return 1
    print("torch_check_overhead: OK "
          f"(executor {per_shard_us:.1f} us/shard, "
          f"note_shard_counters {per_note_us:.3f} us/call, "
          f"record_event {per_event_us:.3f} us/call)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
