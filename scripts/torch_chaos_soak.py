#!/usr/bin/env python
"""Randomized fault-injection soak over the port's BAM read pipeline.

The port's counterpart of ``scripts/chaos_soak.py``, over
``disq_tpu_torch`` alone. Each iteration draws a fresh seed, builds a
randomized fault schedule (transient faults, truncated range reads,
latency stalls — plus, in policy iterations, a bit flip in one randomly
chosen BGZF block), runs an end-to-end read through the public API, and
checks the recovery contract:

- transient/truncate/stall schedules must yield output byte-identical
  to the fault-free baseline;
- a bit flip under ``skip``/``quarantine`` must lose records only from
  the corrupted block, and under ``strict`` must raise
  ``CorruptBlockError`` naming that block;
- whatever dataset came back, writing it through the parallel write
  pipeline (``--writer-workers``) under injected *write-side*
  transients must produce bytes identical to a fault-free sequential
  write of the same dataset.

The same seed draws the same schedule, policy, block, offset and bit as
``scripts/chaos_soak.py`` (every ``random.Random`` draw in its order).

**Device.** ``--device cuda`` (the default; without CUDA the script
raises) runs every read, write, chain and daemon of the soak on the
card: a ``cuda`` storage always takes the device route, so every split
goes through the inflate (B1) and parse (B2) kernels, a flipped block
through B1's flag-and-salvage, the operator chain through the read
filter (F1) and the device write through the record gather (W1) and
deflate (W2). Everything it is compared against — the baseline, the
fault-free sequential write, the fault-free chains, the serving truth —
runs on the host route on the CPU (host zlib and the host parse), so
every leg holds the kernels against the host. ``--device cpu`` runs the
main loop and the breaker, crash and scheduler legs on the host route,
as the reference does, and the resident, ops, device-write and serve
legs on the device route's plain versions (``resident_decode``).

Usage::

    python scripts/torch_chaos_soak.py --iterations 50
    python scripts/torch_chaos_soak.py --device cpu --iterations 5 \\
        --records 200 --seed 7

Exit status is non-zero if any iteration violates the contract, so CI
can run this as a single command. ``RESULTS`` holds the last ``main``
run's seeds, policies, leg seconds and failures for a caller that
imports the script.
"""

import argparse
import os
import random
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

BLOCKSIZE = 600
SPLIT = 4096
#: the kernels the soak's legs launch on the card, built before any leg
KERNELS = ("inflate", "parse", "read_filter", "record_gather", "deflate")

#: the last ``main`` run: ``policies`` (it_seed → policy), ``legs`` (leg
#: → seconds, ``main`` for the iteration loop), ``launches`` (leg → the
#: kernel launches this process booked in it), ``failures``
RESULTS: dict = {}


def build_fixture(tmp_dir: str, n_records: int, seed: int):
    from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records

    records = synth_records(n_records, seed=seed, unmapped_tail=4)
    data = make_bam_bytes(DEFAULT_REFS, records, blocksize=BLOCKSIZE)
    path = os.path.join(tmp_dir, f"soak-{seed}.bam")
    with open(path, "wb") as f:
        f.write(data)
    return path, data, len(records)


def random_schedule(rng: random.Random, watchdog: bool = False,
                    hedge: bool = False):
    from disq_tpu_torch.fsw import FaultSpec

    faults = [
        FaultSpec(kind="transient", probability=rng.uniform(0.01, 0.08)),
    ]
    if rng.random() < 0.5:
        faults.append(FaultSpec(
            kind="truncate", probability=rng.uniform(0.01, 0.05),
            truncate_bytes=rng.randint(1, 200)))
    if rng.random() < 0.3:
        faults.append(FaultSpec(
            kind="stall", probability=0.02, stall_s=0.0))
    if hedge:
        # --hedge leg: a seeded slow tail on reads so the hedge timer
        # actually fires (threshold floors at 5ms below); recovery
        # contract unchanged — hedged output must stay byte-identical.
        faults.append(FaultSpec(
            kind="slow", probability=0.25, slow_s=0.05))
    # Write-side blips (op="write" never fires on reads): the staged
    # parts' write_all/concat calls, which the writer's per-shard
    # retrier must absorb without changing a byte.
    faults.append(FaultSpec(
        kind="transient", probability=rng.uniform(0.02, 0.10), op="write"))
    if rng.random() < 0.3:
        faults.append(FaultSpec(
            kind="stall", probability=0.02, stall_s=0.0, op="write"))
    if watchdog:
        # --watchdog leg: one REAL stall on the first write-side call —
        # that call is always a part staged from a heartbeating stage
        # worker (the merge on the calling thread runs after the parts),
        # so the watchdog must flag it within its window. Deterministic:
        # probability 1.0, once.
        faults.append(FaultSpec(
            kind="stall", probability=1.0, stall_s=0.3, times=1,
            op="write"))
    return faults


def pick_block(data: bytes, rng: random.Random) -> int:
    """File offset of a random non-terminal BGZF block."""
    from disq_tpu_torch.bgzf.block import parse_block_header

    layout = []
    pos = 0
    while pos < len(data):
        total = parse_block_header(data, pos)
        layout.append(pos)
        pos += total
    # skip block 0 (header) and the EOF terminator
    return layout[rng.randint(1, max(1, len(layout) - 2))]


def draw_iteration(data: bytes, it_seed: int, watchdog: bool = False,
                   hedge: bool = False) -> dict:
    """The iteration's draws from ``random.Random(it_seed)``, in
    ``run_iteration``'s order: the fault schedule, the policy and, unless
    it is ``recover``, the corrupted block, the offset into it (+1 damages
    the gzip magic, the block *header*, and exercises the chain-walk
    salvage; +20 damages the DEFLATE payload) and the flipped bit, whose
    ``bitflip`` leads ``faults`` (alone under ``strict``)."""
    from disq_tpu_torch.fsw import FaultSpec

    rng = random.Random(it_seed)
    faults = random_schedule(rng, watchdog=watchdog, hedge=hedge)
    policy = rng.choice(["strict", "skip", "quarantine", "recover"])
    corrupt_at = rel = bit = None
    if policy != "recover":
        corrupt_at = pick_block(data, rng)
        rel = rng.choice([1, 20])
        bit = rng.randint(0, 7)
        faults = [FaultSpec(kind="bitflip", offset=corrupt_at + rel,
                            bit=bit)] + (faults if policy != "strict" else [])
    return {"faults": faults, "policy": policy, "corrupt_at": corrupt_at,
            "rel": rel, "bit": bit}


def _storage(device: str):
    from disq_tpu_torch import ReadsStorage

    return ReadsStorage.make_default(device=device)


def _host():
    """A storage on the host route: host zlib and the host parse."""
    return _storage("cpu")


def _host_batch(batch):
    """``batch`` on the host: a device-backed batch after d2h."""
    return batch.to_read_batch() if hasattr(batch, "to_read_batch") \
        else batch


def _host_dataset(ds):
    """``ds`` with its records on the host, for a host-route write."""
    import torch

    from disq_tpu_torch import ReadsDataset

    return ReadsDataset(header=ds.header, reads=_host_batch(ds.reads),
                        counters=ds.counters, device=torch.device("cpu"))


def _device_parse_error(batch, want=None) -> str:
    """On a device-backed batch, the first fixed column whose device copy
    (what the parse kernel B2 wrote) differs from ``want``'s (by default
    the batch's own host parse, which ``to_read_batch`` serves); "" if
    they all agree or the batch is on the host. Read before
    ``to_read_batch``, which fills the column cache from the host
    parse."""
    import numpy as np

    if not getattr(batch, "device_backed", False) or batch.count == 0:
        return ""
    dev = {k: v.cpu().numpy() for k, v in batch.device_columns().items()}
    want = batch.to_read_batch() if want is None else want
    for name, col in dev.items():
        if not np.array_equal(col.astype(np.int64),
                              np.asarray(getattr(want, name), np.int64)):
            return f"device column {name} differs from the host parse"
    return ""


def _to_numpy(value):
    import numpy as np

    return value.cpu().numpy() if hasattr(value, "cpu") \
        else np.asarray(value)


def soak_write(ds, path, it_seed: int, writer_workers: int,
               watchdog: bool = False, device: str = "cuda") -> str:
    """Write ``ds`` through the registered fault fs with the parallel
    writer on ``device``, and sequentially fault-free on the host route;
    the bytes must match. With ``watchdog``, the schedule carries a
    guaranteed write-side stall (see ``random_schedule``) and the leg
    additionally asserts the heartbeat watchdog flagged it — detection
    is part of the recovery contract, not a side effect."""
    out_par = path + f".par-{it_seed}.bam"
    out_seq = path + f".seq-{it_seed}.bam"
    try:
        from disq_tpu_torch import DisqOptions

        opts = DisqOptions(max_retries=8, retry_backoff_s=0.0)
        if watchdog:
            opts = opts.with_watchdog(0.08, "warn")
            writer_workers = max(2, writer_workers)
        par_st = (_storage(device).num_shards(6)
                  .options(opts)
                  .writer_workers(writer_workers))
        if watchdog:
            from disq_tpu_torch.runtime.tracing import counter

            stalled_before = counter("watchdog.stalled_shards").total()
        par_st.write(ds, "fault://" + out_par)
        if watchdog:
            stalled_after = counter("watchdog.stalled_shards").total()
            if stalled_after <= stalled_before:
                return ("watchdog missed the injected write-side stall "
                        f"(counter {stalled_before} -> {stalled_after})")
        _host().num_shards(6).write(_host_dataset(ds), out_seq)
        with open(out_par, "rb") as f:
            par = f.read()
        with open(out_seq, "rb") as f:
            seq = f.read()
        if par != seq:
            return (f"parallel write (w={writer_workers}) differs from "
                    f"sequential fault-free write")
        return ""
    finally:
        for p in (out_par, out_seq):
            if os.path.exists(p):
                os.unlink(p)


def run_iteration(path, data, n_records, baseline, it_seed: int,
                  executor_workers: int = 1,
                  writer_workers: int = 1,
                  watchdog: bool = False,
                  hedge: bool = False,
                  device: str = "cuda") -> str:
    """One soak iteration; returns "" on success, else a description."""
    import numpy as np

    from disq_tpu_torch import (
        CorruptBlockError,
        DisqOptions,
        ErrorPolicy,
    )
    from disq_tpu_torch.fsw import (
        FaultInjectingFileSystemWrapper,
        PosixFileSystemWrapper,
        register_filesystem,
    )

    plan = draw_iteration(data, it_seed, watchdog=watchdog, hedge=hedge)
    faults, policy = plan["faults"], plan["policy"]
    corrupt_at = plan["corrupt_at"]

    fsw = FaultInjectingFileSystemWrapper(
        PosixFileSystemWrapper(), faults, seed=it_seed)
    register_filesystem("fault", fsw)
    opts = DisqOptions(
        error_policy=ErrorPolicy.coerce(
            policy if policy != "recover" else "strict"),
        max_retries=6, retry_backoff_s=0.0,
        quarantine_dir=path + f".quarantine-{it_seed}",
        executor_workers=executor_workers,
    )
    if watchdog:
        # Arm the read-side watchdog too (warn): the randomized read
        # stalls are zero-length so nothing should be flagged, but
        # every heartbeat path runs under chaos.
        opts = opts.with_watchdog(0.25, "warn")
    if hedge:
        # --hedge leg: hedge aggressively (median quantile, 5ms floor)
        # against the injected slow tail; the iteration's byte-identity
        # / bounded-loss checks below ARE the hedging contract, and
        # main() additionally asserts launched == won accounting.
        opts = opts.with_hedging(0.5, 0.005)
    storage = _storage(device).split_size(SPLIT).options(opts)

    try:
        ds = storage.read("fault://" + path)
    except CorruptBlockError as e:
        if policy == "strict" and e.block_offset == corrupt_at:
            return ""
        return (f"policy={policy}: unexpected CorruptBlockError "
                f"at {e.block_offset} (corrupted {corrupt_at})")
    except Exception as e:  # noqa: BLE001 — any other escape is a failure
        return f"policy={policy}: {type(e).__name__}: {e}"

    if policy == "strict":
        return f"strict read of corrupt block {corrupt_at} did not raise"
    perr = _device_parse_error(
        ds.reads, baseline.reads if policy == "recover" else None)
    if perr:
        return f"policy={policy}: {perr}"
    werr = soak_write(ds, path, it_seed, writer_workers,
                      watchdog=watchdog, device=device)
    if werr:
        return f"policy={policy}: {werr}"
    if policy == "recover":
        if ds.count() != n_records:
            return (f"recover: {ds.count()} != {n_records} records "
                    f"(faults fired: {fsw.fired_counts()})")
        got = _host_batch(ds.reads)
        if not np.array_equal(got.pos, baseline.reads.pos) or \
                not np.array_equal(got.names, baseline.reads.names):
            return "recover: output differs from fault-free baseline"
        return ""
    # skip / quarantine: bounded loss, correct counters
    lost = n_records - ds.count()
    dropped = (ds.counters.skipped_blocks
               + ds.counters.quarantined_blocks)
    if dropped != 1:
        return f"{policy}: dropped {dropped} blocks, expected 1"
    # one 600-byte block holds at most ~18 minimum-size records
    if not (0 < lost <= 20):
        return f"{policy}: lost {lost} records from one block"
    return ""


def resident_leg(path, baseline, device: str = "cuda") -> str:
    """--resident leg: the device route (``runtime/columnar.py``; B1 and
    B2 at two executor workers) read through a transient-fault schedule
    must produce a device-backed batch whose every column, after d2h,
    is byte-identical to the fault-free host-path baseline."""
    from dataclasses import fields as dc_fields

    import numpy as np

    from disq_tpu_torch import DisqOptions
    from disq_tpu_torch.fsw import (
        FaultInjectingFileSystemWrapper,
        FaultSpec,
        PosixFileSystemWrapper,
        register_filesystem,
    )
    from disq_tpu_torch.runtime.columnar import ColumnarBatch

    faults = [
        FaultSpec(kind="transient", probability=0.08),
        FaultSpec(kind="truncate", probability=0.04, truncate_bytes=80),
    ]
    fsw = FaultInjectingFileSystemWrapper(
        PosixFileSystemWrapper(), faults, seed=4242)
    register_filesystem("fault", fsw)
    opts = DisqOptions(max_retries=8, retry_backoff_s=0.0,
                       executor_workers=2, resident_decode=True)
    try:
        ds = (_storage(device).split_size(SPLIT)
              .options(opts).read("fault://" + path))
    except Exception as e:  # noqa: BLE001 — any escape is a failure
        return f"resident: {type(e).__name__}: {e}"
    if not isinstance(ds.reads, ColumnarBatch) or not ds.reads.device_backed:
        return "resident: read did not produce a device-backed batch"
    if ds.count() != baseline.count():
        return (f"resident: {ds.count()} records != baseline "
                f"{baseline.count()}")
    perr = _device_parse_error(ds.reads, baseline.reads)
    if perr:
        return f"resident: {perr}"
    got = ds.reads.to_read_batch()
    for f in dc_fields(got):
        if not np.array_equal(getattr(got, f.name),
                              getattr(baseline.reads, f.name)):
            return f"resident: column {f.name} differs from host path"
    ds.reads.release()
    return ""


def ops_leg(path, baseline, device: str = "cuda") -> str:
    """--ops leg: the chained operator pipeline (filter → sort →
    markdup → pileup → rgstats, ``runtime/oppipe.py``) over a device
    read through a transient-fault schedule must produce stats — and
    marked flag columns — identical to the same chain over a fault-free
    host-route read. Duplicate marking is the sharpest probe here: a
    retried/salvaged shard that dropped or reordered records would shift
    the (refid, unclipped-pos, orientation) groups and change the
    count."""
    import numpy as np

    from disq_tpu_torch import DisqOptions
    from disq_tpu_torch.fsw import (
        FaultInjectingFileSystemWrapper,
        FaultSpec,
        PosixFileSystemWrapper,
        register_filesystem,
    )

    chain = (("filter", "-F 0x800"), "sort", "markdup",
             ("pileup", 0, 0, 10_000), "rgstats")
    faults = [
        FaultSpec(kind="transient", probability=0.08),
        FaultSpec(kind="truncate", probability=0.04, truncate_bytes=80),
    ]
    register_filesystem("fault", FaultInjectingFileSystemWrapper(
        PosixFileSystemWrapper(), faults, seed=2424))
    opts = DisqOptions(max_retries=8, retry_backoff_s=0.0,
                       executor_workers=2, resident_decode=True)
    try:
        ds = (_storage(device).split_size(SPLIT)
              .options(opts).read("fault://" + path))
        got_ds, got = ds.pipeline(*chain)
        # fault-free host-path truth: a fresh read (NOT `baseline` —
        # markdup patches 0x400 into the batch it is handed)
        want_src = _host().split_size(SPLIT).read(path)
        want_ds, want = want_src.pipeline(*chain)
    except Exception as e:  # noqa: BLE001 — any escape is a failure
        return f"ops: {type(e).__name__}: {e}"
    got_cov = got.get("pileup", {}).pop("coverage", None)
    want_cov = want.get("pileup", {}).pop("coverage", None)
    if got_cov is None or want_cov is None or not np.array_equal(
            _to_numpy(got_cov), _to_numpy(want_cov)):
        return "ops: pileup coverage differs from the fault-free chain"
    if got != want:
        return (f"ops: chained stats differ from the fault-free chain "
                f"(got {got}, want {want})")
    if got_ds.count() != want_ds.count():
        return (f"ops: {got_ds.count()} records != fault-free "
                f"{want_ds.count()}")
    if not np.array_equal(_host_batch(got_ds.reads).flag,
                          _host_batch(want_ds.reads).flag):
        return "ops: marked flag column differs from the fault-free chain"
    if hasattr(got_ds.reads, "release"):
        got_ds.reads.release()
    return ""


def device_write_leg(path, baseline, device: str = "cuda") -> str:
    """--device-write leg: the symmetric device write path (resident
    sort, the record gather W1 and the deflate W2 fed by the device
    service) under injected write-side faults must produce a file the
    port's own host reader decodes to records identical to a fault-free
    host-path write of the same dataset. Byte-VALIDITY, not
    byte-identity, is the contract — the device coder's streams
    legitimately differ from the zlib pin — so the comparison is
    record-level after a full re-read."""
    from dataclasses import fields as dc_fields

    import numpy as np

    from disq_tpu_torch import BaiWriteOption, DisqOptions
    from disq_tpu_torch.fsw import (
        FaultInjectingFileSystemWrapper,
        FaultSpec,
        PosixFileSystemWrapper,
        register_filesystem,
    )
    from disq_tpu_torch.runtime import device_service

    faults = [
        FaultSpec(kind="transient", probability=0.10, op="write"),
        FaultSpec(kind="stall", probability=0.05, stall_s=0.0,
                  op="write"),
    ]
    register_filesystem("fault", FaultInjectingFileSystemWrapper(
        PosixFileSystemWrapper(), faults, seed=777))
    out_dev = path + ".device-write.bam"
    out_host = path + ".host-write.bam"
    prev = os.environ.get("DISQ_TPU_TORCH_DEVICE_SERVICE")
    os.environ["DISQ_TPU_TORCH_DEVICE_SERVICE"] = "1"
    try:
        # device path: resident-decoded read, sorted device write with
        # BAI, through the fault fs with the parallel writer
        opts = DisqOptions(max_retries=8, retry_backoff_s=0.0,
                           resident_decode=True, device_deflate=True,
                           writer_workers=2)
        st = (_storage(device).split_size(SPLIT)
              .num_shards(5).options(opts))
        ds = st.read(path)
        st.write(ds, "fault://" + out_dev, BaiWriteOption.ENABLE,
                 sort=True)
        # fault-free host-path baseline of the same dataset
        _host().num_shards(5).write(
            baseline, out_host, BaiWriteOption.ENABLE, sort=True)
        got = _host().read(out_dev)
        want = _host().read(out_host)
        if got.count() != want.count():
            return (f"device-write: {got.count()} records re-read, "
                    f"host path wrote {want.count()}")
        got_rb, want_rb = got.reads, want.reads
        for f in dc_fields(want_rb):
            if not np.array_equal(getattr(got_rb, f.name),
                                  getattr(want_rb, f.name)):
                return (f"device-write: column {f.name} differs from "
                        "the fault-free host-path baseline")
        if not os.path.exists(out_dev + ".bai"):
            return "device-write: BAI sidecar missing"
        return ""
    except Exception as e:  # noqa: BLE001 — any escape is a failure
        return f"device-write: {type(e).__name__}: {e}"
    finally:
        if prev is None:
            os.environ.pop("DISQ_TPU_TORCH_DEVICE_SERVICE", None)
        else:
            os.environ["DISQ_TPU_TORCH_DEVICE_SERVICE"] = prev
        device_service.shutdown_service()
        for p in (out_dev, out_host, out_dev + ".bai",
                  out_host + ".bai"):
            if os.path.exists(p):
                os.unlink(p)


def breaker_leg(path, baseline, device: str = "cuda") -> str:
    """Deterministic circuit-breaker scenario: a total fault storm must
    trip the breaker within its window, rejected calls must fail fast
    (<10ms each), and after the storm clears a half-open probe must
    reclose it with output byte-identical to the baseline."""
    import time as _time

    import numpy as np

    from disq_tpu_torch import BreakerOpenError, DisqOptions
    from disq_tpu_torch.fsw import (
        FaultInjectingFileSystemWrapper,
        FaultSpec,
        PosixFileSystemWrapper,
        register_filesystem,
    )
    from disq_tpu_torch.runtime import reset_resilience
    from disq_tpu_torch.runtime.resilience import breakers_snapshot
    from disq_tpu_torch.runtime.tracing import counter

    reset_resilience()
    try:
        storm = FaultInjectingFileSystemWrapper(
            PosixFileSystemWrapper(),
            [FaultSpec(kind="transient", probability=1.0)])
        register_filesystem("fault", storm)
        opts = DisqOptions(max_retries=8, retry_backoff_s=0.0,
                           ).with_breaker(3, cooldown_s=0.2)
        st = _storage(device).split_size(SPLIT).options(opts)
        trips0 = counter("breaker.transitions").value(key="fault",
                                                      to="open")
        try:
            st.read("fault://" + path)
            return "breaker: storm read unexpectedly succeeded"
        except BreakerOpenError:
            pass  # the expected fast failure
        except Exception as e:  # noqa: BLE001 — storm may surface first
            if counter("breaker.transitions").value(
                    key="fault", to="open") <= trips0:
                return (f"breaker: storm surfaced {type(e).__name__} "
                        "without tripping the breaker")
        snap = breakers_snapshot().get("fault")
        if snap is None or snap["state"] != "open":
            return f"breaker: expected open after the storm, got {snap}"
        # While open: rejections must be immediate (<10ms per call).
        t0 = _time.perf_counter()
        try:
            st.read("fault://" + path)
            return "breaker: open breaker admitted a read"
        except BreakerOpenError:
            pass
        per_call = (_time.perf_counter() - t0)
        if per_call > 0.25:
            return (f"breaker: open-state read took {per_call:.3f}s — "
                    "not failing fast")
        if counter("breaker.rejected").value(key="fault") <= 0:
            return "breaker: no breaker.rejected bookings while open"
        # Storm over: after the cooldown a probe must reclose it.
        storm.faults.clear()
        _time.sleep(0.25)
        ds = st.read("fault://" + path)
        snap = breakers_snapshot().get("fault")
        if snap is None or snap["state"] != "closed":
            return (f"breaker: expected reclose after probe, got {snap}")
        if ds.count() != baseline.count() or not np.array_equal(
                _host_batch(ds.reads).pos, baseline.reads.pos):
            return "breaker: post-reclose read differs from baseline"
        return ""
    finally:
        reset_resilience()


# The child processes below import only disq_tpu_torch, and take their
# device from the parent. On ``cuda`` each makes its CUDA context before
# the timed work, and loads the kernels the parent built.

_ABORT_CHILD = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
import torch
from disq_tpu_torch import ReadsStorage, WatchdogStallError
from disq_tpu_torch.fsw import (FaultInjectingFileSystemWrapper, FaultSpec,
                                PosixFileSystemWrapper, register_filesystem)

if {device!r} == "cuda":
    torch.zeros(1, device="cuda")  # the CUDA context, before the watchdog
# Started early, so that this interpreter's and CUDA context's startup
# overlap the parent's other work: read once the gate opens.
deadline = time.monotonic() + 300
while not os.path.exists({gate!r}) and time.monotonic() < deadline:
    time.sleep(0.01)
# Wedge one mid-file range fetch for 30s: the watchdog (abort policy)
# must cancel the w=4 read, and the armed flight recorder must leave a
# postmortem bundle behind before the process dies.
register_filesystem("fault", FaultInjectingFileSystemWrapper(
    PosixFileSystemWrapper(),
    [FaultSpec(kind="stall", offset={target}, stall_s=30.0, times=1)]))
st = (ReadsStorage.make_default(device={device!r}).split_size(96 * 1024)
      .executor_workers(4)
      .watchdog(0.15, "abort")
      .postmortem_dir({pmdir!r}))
try:
    st.read("fault://" + {path!r})
except WatchdogStallError:
    # The bundle is written synchronously before the abort surfaces;
    # _exit skips the interpreter's pool join (a fetch worker is still
    # inside the injected 30s stall).
    os._exit(17)
os._exit(3)
"""


def start_abort_child(tmp, device: str = "cuda"):
    """The postmortem fixture and the abort child (``_ABORT_CHILD``),
    started and waiting at its gate: ``(process, gate, postmortem dir)``,
    or a description of what failed."""
    import subprocess
    import sys as _sys

    from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records

    from disq_tpu_torch import SbiWriteOption

    pm_dir = os.path.join(tmp, "postmortem")
    raw = os.path.join(tmp, "postmortem-raw.bam")
    big = os.path.join(tmp, "postmortem.bam")
    gate = os.path.join(tmp, "postmortem.go")
    # Big enough that a mid-file byte lies past the 256 KiB header
    # readahead, and written WITH its .sbi so split boundaries come
    # from the index: the stall then fires inside a heartbeated split
    # fetch, not a guess read on the calling thread.
    with open(raw, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS, synth_records(5000, seed=5)))
    ds = _host().read(raw)
    _host().num_shards(6).write(ds, big, SbiWriteOption.ENABLE)
    size = os.path.getsize(big)
    target = max(size * 3 // 5, 256 * 1024 + 32 * 1024)
    if target >= size:
        return ("postmortem: fixture too small for a mid-file stall "
                f"({size} bytes)")
    child = subprocess.Popen(
        [_sys.executable, "-c", _ABORT_CHILD.format(
            repo=REPO, path=big, pmdir=pm_dir, target=target,
            device=device, gate=gate)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    return child, gate, pm_dir


def postmortem_check(tmp, device: str = "cuda", started=None) -> str:
    """A chaos-induced watchdog abort (w=4) must leave a complete
    postmortem bundle that ``trace_report.py --postmortem`` renders
    into a verdict naming the stalled shard. ``started``: what
    ``start_abort_child`` returned, if it ran earlier."""
    import subprocess
    import sys as _sys

    started = started or start_abort_child(tmp, device)
    if isinstance(started, str):
        return started
    child, gate, pm_dir = started
    open(gate, "w").close()
    try:
        _, err = child.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        child.kill()
        child.communicate()
        return "postmortem: abort child ran past 120s"
    if child.returncode != 17:
        return ("postmortem: abort child exited "
                f"{child.returncode} (wanted 17 = WatchdogStallError): "
                + err[-500:])
    bundles = sorted(
        d for d in (os.listdir(pm_dir) if os.path.isdir(pm_dir) else [])
        if d.startswith("bundle-"))
    if not bundles:
        return "postmortem: watchdog abort left no bundle directory"
    bundle = os.path.join(pm_dir, bundles[-1])
    required = {"MANIFEST.json", "stacks.txt", "metrics.prom",
                "spans.jsonl", "events.jsonl"}
    missing = required - set(os.listdir(bundle))
    if missing:
        return f"postmortem: bundle missing artifacts {sorted(missing)}"
    rep = subprocess.run(
        [_sys.executable,
         os.path.join(REPO, "scripts", "trace_report.py"),
         "--postmortem", bundle],
        capture_output=True, text=True, timeout=60)
    if rep.returncode != 0:
        return f"postmortem: trace_report failed: {rep.stderr[-300:]}"
    if "verdict: shard" not in rep.stdout:
        return ("postmortem: report did not name the stalled shard:\n"
                + rep.stdout[:500])
    return ""


_STEAL_CHILD = r"""
import hashlib, json, os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from disq_tpu_torch import ReadsStorage
from disq_tpu_torch.bam.source import BamSource, read_header
from disq_tpu_torch.fsw import (FaultInjectingFileSystemWrapper, FaultSpec,
                                PosixFileSystemWrapper, register_filesystem)
from disq_tpu_torch.fsw.filesystem import resolve_path

if {device!r} == "cuda":
    torch.zeros(1, device="cuda")
if {gate!r}:
    # Started before the straggler: say so, and read only once the
    # parent has seen the straggler holding leases, so that this
    # interpreter's startup is not part of the race.
    open({gate!r} + ".ready", "w").close()
    deadline = time.monotonic() + 120
    while not os.path.exists({gate!r}) and time.monotonic() < deadline:
        time.sleep(0.01)
# Worker 0 is the deliberate straggler: every read_range draws a
# seeded latency from [0, slow_s) — the faultfs "slow" tail.
faults = []
if {slow_s} > 0:
    faults = [FaultSpec(kind="slow", probability=1.0, slow_s={slow_s})]
register_filesystem("fault", FaultInjectingFileSystemWrapper(
    PosixFileSystemWrapper(), faults, seed=11))
src = BamSource(ReadsStorage.make_default(device={device!r})
                .split_size({split}))
fs, p = resolve_path("fault://" + {path!r})
header, fv = read_header(fs, p)
t0 = time.perf_counter()
batches = src.read_split_batches(fs, p, header, fv)
wall = time.perf_counter() - t0
digests = {{}}
for c, b in zip(src._last_counters, batches):
    if hasattr(b, "to_read_batch"):
        b = b.to_read_batch()
    h = hashlib.sha1()
    for f in ("refid", "pos", "flag", "seqs", "quals", "names"):
        h.update(np.ascontiguousarray(getattr(b, f)).tobytes())
    digests[str(c.shard_id)] = h.hexdigest()
print(json.dumps({{"host": os.environ.get("DISQ_TPU_TORCH_SCHED_HOST"),
                   "wall": round(wall, 3), "shards": digests}}))
"""


def _split_digests(path: str) -> dict:
    """Fault-free single-host truth on the host route: split id → sha1
    of the split's columns."""
    import hashlib

    import numpy as np

    from disq_tpu_torch.bam.source import BamSource, read_header
    from disq_tpu_torch.fsw.filesystem import resolve_path

    src = BamSource(_host().split_size(SPLIT))
    fs, p = resolve_path(path)
    header, fv = read_header(fs, p)
    want = {}
    batches = src.read_split_batches(fs, p, header, fv)
    for c, b in zip(src._last_counters, batches):
        h = hashlib.sha1()
        for f in ("refid", "pos", "flag", "seqs", "quals", "names"):
            h.update(np.ascontiguousarray(getattr(b, f)).tobytes())
        want[str(c.shard_id)] = h.hexdigest()
    return want


def _child_env(**extra) -> dict:
    """This process's environment without its scheduler knobs, plus
    ``extra``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DISQ_TPU_TORCH_SCHED")}
    env.update(extra)
    return env


def steal_leg(path, tmp, device: str = "cuda") -> str:
    """--steal leg: a 2-worker scheduled read with one deliberately
    slowed worker.  The coordinator (this process) must route the
    drained queue's stale leases to the fast worker (``sched.steals``
    ≥ 1), every shard must be emitted by exactly one worker, and the
    union of the workers' per-shard digests must equal a fault-free
    single-host read's."""
    from disq_tpu_torch.runtime import scheduler
    from disq_tpu_torch.runtime.introspect import reset_introspection

    want = _split_digests(path)
    addr = scheduler.serve_coordinator(lease_s=8.0, steal_after_s=0.1)
    try:
        return _steal_leg_body(addr, path, want, device, tmp)
    finally:
        # every return path (failure included) must drop the
        # coordinator — a stale unfinished "chaos-steal" run would
        # poison later seeds' legs
        scheduler.stop_coordinator()
        reset_introspection()


def _steal_leg_body(addr, path, want, device: str, tmp: str) -> str:
    import json
    import subprocess
    import sys as _sys
    import time as _time

    from disq_tpu_torch.runtime import scheduler

    def spawn(i, slow_s, gate=""):
        env = _child_env(DISQ_TPU_TORCH_SCHED=addr,
                         DISQ_TPU_TORCH_SCHED_HOST=f"h{i}",
                         DISQ_TPU_TORCH_SCHED_LEASE_N="2",
                         DISQ_TPU_TORCH_SCHED_STEAL="1",
                         DISQ_TPU_TORCH_SCHED_SALT="chaos-steal")
        return subprocess.Popen(
            [_sys.executable, "-c", _STEAL_CHILD.format(
                repo=REPO, path=path, split=SPLIT, slow_s=slow_s,
                device=device, gate=gate)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env)

    # The straggler must be seen HOLDING leases before the fast worker
    # reads — otherwise the fast worker drains the queue before the slow
    # one even joins, and there is nothing to steal. The fast worker
    # starts first and waits at a gate, so its interpreter's (and
    # CUDA context's) startup is over when the gate opens: otherwise
    # the straggler can finish every shard while it starts.
    # slow_s=0.6 per read keeps each of the straggler's shards in
    # flight well past steal_after_s, so the fast worker's steal is a
    # wide-open window, not a race
    gate = os.path.join(tmp, "steal.go")
    fast = spawn(1, 0.0, gate)
    procs = [fast]
    try:
        deadline = _time.monotonic() + 120
        while not os.path.exists(gate + ".ready"):
            if fast.poll() is not None:
                return ("steal: fast worker exited before its gate: "
                        + fast.communicate()[1][-500:])
            if _time.monotonic() > deadline:
                return "steal: fast worker never reached its gate"
            _time.sleep(0.02)
        slow = spawn(0, 0.6)
        procs.insert(0, slow)
        deadline = _time.monotonic() + 120
        while _time.monotonic() < deadline:
            if slow.poll() is not None:
                return ("steal: slow worker exited before leasing: "
                        + slow.communicate()[1][-500:])
            stats = scheduler.active_coordinator().stats()
            run = next((r for k, r in stats["runs"].items()
                        if "chaos-steal" in k), None)
            if run is not None and any(
                    lease["host"] == "h0"
                    for lease in run["leases"].values()):
                break
            _time.sleep(0.02)
        else:
            return "steal: slow worker never leased a shard"
        open(gate, "w").close()
        outs = []
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                return f"steal: worker failed: {err[-500:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    got = {}
    for doc in outs:
        for sid, dig in doc["shards"].items():
            if sid in got:
                return f"steal: shard {sid} emitted by two workers"
            got[sid] = dig
    if got != want:
        missing = sorted(set(want) - set(got), key=int)
        wrong = sorted((k for k in got if want.get(k) != got[k]), key=int)
        return (f"steal: shard digests diverge (missing={missing}, "
                f"wrong={wrong})")
    stats = scheduler.active_coordinator().stats()
    run = next((r for k, r in stats["runs"].items()
                if "chaos-steal" in k), None)
    if run is None:
        return "steal: coordinator never registered the run"
    if not run["finished"]:
        return f"steal: run not finished: {run}"
    if not run["stolen"]:
        return ("steal: the fast worker never stole from the slowed "
                f"one ({run})")
    return ""


_KILL_CHILD = r"""
import os, sys
sys.path.insert(0, {repo!r})
from disq_tpu_torch import DisqOptions, ReadsStorage, StageManifestWriteOption
from disq_tpu_torch.fsw import (FaultInjectingFileSystemWrapper, FaultSpec,
                                PosixFileSystemWrapper, register_filesystem)

# Wedge the 4th write-side call for 120s: a couple of parts land, the
# manifest records them, then the writer hangs until SIGKILL.
register_filesystem("fault", FaultInjectingFileSystemWrapper(
    PosixFileSystemWrapper(),
    [FaultSpec(kind="stall", op="write", stall_s=120.0, call_index=3,
               times=1)]))
ds = (ReadsStorage.make_default(device={device!r}).split_size({split})
      .read({path!r}))
st = (ReadsStorage.make_default(device={device!r}).num_shards(6)
      .options(DisqOptions(retry_backoff_s=0.0))
      .writer_workers(2))
st.write(ds, "fault://" + {out!r}, StageManifestWriteOption({mpath!r}))
"""


def kill_leg(path, tmp, device: str = "cuda") -> str:
    """SIGKILL a writer subprocess mid-run, then resume from its
    ``StageManifest``: only unfinished shards may re-run (asserted via
    the ledger's completed set against the resumed process's write
    log), and the final bytes must match a fault-free run."""
    # the postmortem's abort child starts first and waits at its gate,
    # so that its startup overlaps the writer's
    abort = start_abort_child(tmp, device)
    try:
        err = _kill_resume(path, tmp, device)
        if err:
            return err
        # Crash-leg postmortem contract: a chaos-induced abort must
        # leave a renderable bundle (runtime/flightrec.py), not just a
        # ledger.
        return postmortem_check(tmp, device, abort)
    finally:
        if not isinstance(abort, str) and abort[0].poll() is None:
            abort[0].kill()
            abort[0].communicate()


def _kill_resume(path, tmp, device: str) -> str:
    import json
    import signal
    import subprocess
    import sys as _sys
    import time as _time

    from disq_tpu_torch import (
        DisqOptions, StageManifest, StageManifestWriteOption)
    from disq_tpu_torch.fsw import (
        FaultInjectingFileSystemWrapper,
        PosixFileSystemWrapper,
        register_filesystem,
    )

    out = os.path.join(tmp, "kill-out.bam")
    mpath = os.path.join(tmp, "kill.manifest")
    child = subprocess.Popen(
        [_sys.executable, "-c", _KILL_CHILD.format(
            repo=REPO, split=SPLIT, path=path, out=out, mpath=mpath,
            device=device)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    # Wait until the child's manifest records >= 2 staged shards, then
    # kill -9 mid-run (one stage worker is wedged on the injected
    # stall, so the process is alive and mid-write when it dies).
    deadline = _time.monotonic() + 120
    done = []
    try:
        while _time.monotonic() < deadline:
            if child.poll() is not None:
                return ("kill: writer child exited early: "
                        + child.stderr.read().decode(
                            errors="replace")[-500:])
            try:
                with open(mpath) as f:
                    state = json.load(f)
                done = sorted(
                    int(k) for k in state.get("stages", {})
                    .get("bam.parts", {}).get("shards", {}))
            except (OSError, json.JSONDecodeError, ValueError):
                done = []
            if len(done) >= 2:
                break
            _time.sleep(0.05)
    finally:
        child.send_signal(signal.SIGKILL)
        child.wait()
        child.stderr.close()
    if len(done) < 2:
        return "kill: child never staged 2 shards before the deadline"

    # Ledger snapshot before resuming: which shards the killed run
    # completed, stamped with ITS run id. Every shard seen done before
    # the kill is still there; one more may have landed between that
    # look and the signal.
    manifest = StageManifest(mpath)
    pre_done = manifest.completed_shards("bam.parts")
    child_runs = {k: manifest.shard_run_id("bam.parts", k)
                  for k in pre_done}
    if not set(done) <= set(pre_done) or None in child_runs.values():
        return f"kill: torn ledger after SIGKILL: {pre_done} vs {done}"

    # Resume fault-free through a write-logging fs: completed shards
    # must NOT be re-staged; the rest must.
    class _Counting(PosixFileSystemWrapper):
        writes = []

        def write_all(self, p, data):
            _Counting.writes.append(p)
            super().write_all(p, data)

    register_filesystem("fault", FaultInjectingFileSystemWrapper(
        _Counting(), []))
    ds = _storage(device).split_size(SPLIT).read(path)
    st = (_storage(device).num_shards(6)
          .options(DisqOptions(retry_backoff_s=0.0))
          .writer_workers(2))
    st.write(ds, "fault://" + out, StageManifestWriteOption(mpath))
    staged = {int(p.rsplit("part-", 1)[1][:5])
              for p in _Counting.writes if "part-" in p}
    if staged & set(pre_done):
        return (f"kill: resume re-staged completed shards "
                f"{sorted(staged & set(pre_done))} (ledger said done)")
    if staged != set(range(6)) - set(pre_done):
        return (f"kill: resume staged {sorted(staged)}, expected exactly "
                f"the unfinished {sorted(set(range(6)) - set(pre_done))}")
    if os.path.exists(mpath):
        return "kill: manifest survived the commit point"

    clean = os.path.join(tmp, "kill-clean.bam")
    _host().num_shards(6).write(_host_dataset(ds), clean)
    with open(out, "rb") as fa, open(clean, "rb") as fb:
        if fa.read() != fb.read():
            return "kill: resumed output differs from a fault-free run"
    return ""


_COORD_KILL_CHILD = r"""
import hashlib, json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from disq_tpu_torch import ReadsStorage
from disq_tpu_torch.bam.source import BamSource, read_header
from disq_tpu_torch.fsw import (FaultInjectingFileSystemWrapper, FaultSpec,
                                PosixFileSystemWrapper, register_filesystem)
from disq_tpu_torch.fsw.filesystem import resolve_path
from disq_tpu_torch.runtime import scheduler

if {device!r} == "cuda":
    torch.zeros(1, device="cuda")
# A uniform slow tail on every range read keeps the pass in flight
# long enough for the parent to SIGKILL the coordinator mid-pass.
register_filesystem("fault", FaultInjectingFileSystemWrapper(
    PosixFileSystemWrapper(),
    [FaultSpec(kind="slow", probability=1.0, slow_s={slow_s})], seed=5))
if os.environ["DISQ_TPU_TORCH_SCHED"] == "serve":
    # The coordinator host pre-serves and waits for the full
    # electorate before decoding — otherwise interpreter-startup skew
    # lets it drain the queue alone and there is no mid-pass to kill.
    import time as _t
    addr = scheduler.serve_coordinator(lease_s=2.0,
                                       failover_dir={fdir!r})
    scheduler.register_member({fdir!r}, "w0", addr)
    mdir = os.path.join({fdir!r}, "members")
    deadline = _t.monotonic() + 60
    while _t.monotonic() < deadline:
        try:
            n = len([f for f in os.listdir(mdir)
                     if f.endswith(".json")])
        except OSError:
            n = 0
        if n >= 4:
            break
        _t.sleep(0.02)
st = (ReadsStorage.make_default(device={device!r}).split_size({split})
      .read_ledger({ledger!r}))
src = BamSource(st)
fs, p = resolve_path("fault://" + {path!r})
header, fv = read_header(fs, p)
batches = src.read_split_batches(fs, p, header, fv)
digests = {{}}
for c, b in zip(src._last_counters, batches):
    if hasattr(b, "to_read_batch"):
        b = b.to_read_batch()
    h = hashlib.sha1()
    for f in ("refid", "pos", "flag", "seqs", "quals", "names"):
        h.update(np.ascontiguousarray(getattr(b, f)).tobytes())
    digests[str(c.shard_id)] = h.hexdigest()
print(json.dumps({{"host": os.environ.get("DISQ_TPU_TORCH_SCHED_HOST"),
                   "took_over": scheduler.active_coordinator() is not None,
                   "shards": digests}}))
"""


def coord_kill_leg(path, tmp, device: str = "cuda") -> str:
    """--coord-kill leg: a 4-worker scheduled read (w0 hosts the
    coordinator, w1..w3 discover it via the failover directory) whose
    coordinator process is SIGKILLed mid-pass.  Contract: the lowest
    live process id (w1) must win the election, replay the journal and
    resume the SAME epoch's complement — no ``run`` re-registration,
    no shard emitted by two survivors, no journal-done shard decoded
    again — and every surviving shard digest must match a fault-free
    single-host read's."""
    import json
    import signal
    import subprocess
    import sys as _sys
    import time as _time

    from disq_tpu_torch.runtime import scheduler
    from disq_tpu_torch.runtime.manifest import SchedJournal

    ck_tmp = os.path.join(tmp, "coord-kill")
    os.makedirs(ck_tmp, exist_ok=True)
    # A bigger fixture than the shared one: the kill window needs
    # enough shards that "some done, most still pending" is a wide
    # target, not a race (~26 splits at SPLIT=4096).
    ck_path, _, _ = build_fixture(ck_tmp, 700, seed=23)
    fdir = os.path.join(ck_tmp, "failover")
    ldir = os.path.join(ck_tmp, "ledger")
    os.makedirs(fdir, exist_ok=True)
    jpath = os.path.join(fdir, "journal.jsonl")

    want = _split_digests(ck_path)

    def spawn(i):
        env = _child_env(
            DISQ_TPU_TORCH_SCHED="serve" if i == 0 else "auto",
            DISQ_TPU_TORCH_SCHED_FAILOVER=fdir,
            DISQ_TPU_TORCH_SCHED_HOST=f"w{i}",
            DISQ_TPU_TORCH_PROCESS_ID=str(i),
            DISQ_TPU_TORCH_SCHED_LEASE_N="1",
            DISQ_TPU_TORCH_SCHED_LEASE_S="2.0",
            DISQ_TPU_TORCH_SCHED_STEAL="0",
            DISQ_TPU_TORCH_SCHED_SALT="chaos-coord")
        return subprocess.Popen(
            [_sys.executable, "-c", _COORD_KILL_CHILD.format(
                repo=REPO, path=ck_path, split=SPLIT, ledger=ldir,
                fdir=fdir, slow_s=0.25, device=device)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env)

    coord = spawn(0)
    procs = [coord]
    try:
        # The coordinator must advertise before "auto" workers can
        # discover it (they would wait 10s, but fail fast on a dead w0).
        deadline = _time.monotonic() + 60
        addr_path = os.path.join(fdir, "coordinator.addr")
        while not os.path.exists(addr_path):
            if coord.poll() is not None:
                return ("coord-kill: coordinator child died before "
                        "advertising: " + coord.communicate()[1][-800:])
            if _time.monotonic() > deadline:
                return "coord-kill: coordinator never advertised"
            _time.sleep(0.02)
        workers = [spawn(i) for i in (1, 2, 3)]
        procs += workers

        # Kill window: all three survivors joined (they can rejoin and
        # host an adopted coordinator) and the pass is genuinely
        # mid-flight — some shards journaled done, most still pending.
        total = 0
        deadline = _time.monotonic() + 120
        while _time.monotonic() < deadline:
            if coord.poll() is not None:
                out, err = coord.communicate()
                return ("coord-kill: coordinator child exited before "
                        f"the kill window (rc={coord.returncode}): "
                        + (err or out)[-800:])
            recs = SchedJournal.load(jpath) \
                if os.path.exists(jpath) else []
            run = next((r for r in recs if r.get("op") == "run"), None)
            total = len(run["shards"]) if run else 0
            joined = {r.get("host") for r in recs
                      if r.get("op") == "join"}
            done_n = sum(1 for r in recs if r.get("op") == "done")
            if (total >= 16 and {"w1", "w2", "w3"} <= joined
                    and 3 <= done_n <= total - 8):
                break
            _time.sleep(0.02)
        else:
            return (f"coord-kill: never reached the kill window "
                    f"(total={total})")
        coord.send_signal(signal.SIGKILL)
        coord.wait()

        outs = []
        for proc in workers:
            out, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                return f"coord-kill: worker failed: {err[-800:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    recs = SchedJournal.load(jpath)
    # Same-epoch resume: replay preserved the run — a second "run"
    # record would mean the survivors re-registered from scratch (and
    # re-decoded the dead coordinator's finished shards).
    if sum(1 for r in recs if r.get("op") == "run") != 1:
        return ("coord-kill: run re-registered after the failover — "
                "journal replay lost the pass")
    # The FIRST takeover must be the election winner (lowest live
    # process id = w1).  Later takeovers are legitimate: the adopting
    # worker exits when its own read drains, and a still-working
    # survivor re-elects — the rejoin flag keeps those no-ops (the
    # run-count check above proves no takeover restarted the pass).
    takeovers = [r.get("host") for r in recs
                 if r.get("op") == "takeover"]
    if not takeovers or takeovers[0] != "w1":
        return (f"coord-kill: first takeover should be w1 "
                f"(lowest live process id), got {takeovers}")
    adopters = sorted(o["host"] for o in outs if o["took_over"])
    if "w1" not in adopters:
        return "coord-kill: w1 never adopted the coordinator"

    # Exactly-once over the complement: shards the dead coordinator
    # journaled done stay done; everything else is emitted by exactly
    # one survivor with a truth-identical digest.
    w0_done = {str(r["shard"]) for r in recs
               if r.get("op") == "done" and r.get("host") == "w0"}
    got = {}
    for doc in outs:
        for sid, dig in doc["shards"].items():
            if sid in got:
                return (f"coord-kill: shard {sid} emitted by two "
                        f"survivors")
            got[sid] = dig
    expect = {sid: dig for sid, dig in want.items()
              if sid not in w0_done}
    if got != expect:
        missing = sorted(set(expect) - set(got), key=int)
        redone = sorted(set(got) & w0_done, key=int)
        wrong = sorted((k for k in got if expect.get(k) != got[k]
                        and k in expect), key=int)
        return (f"coord-kill: complement digests diverge "
                f"(missing={missing}, redecoded-done={redone}, "
                f"wrong={wrong})")

    # The final journal must replay to a drained queue: every shard
    # done, nothing pending or leased — the state a fresh standby
    # would inherit.
    fp = scheduler.replay_journal(recs, lease_s=2.0).state_fingerprint()
    run_fp = next((r for k, r in fp["runs"].items()
                   if "chaos-coord" in k), None)
    if run_fp is None:
        return "coord-kill: replayed journal lost the run"
    if run_fp["pending"] or run_fp["leases"] \
            or len(run_fp["done"]) != len(want):
        return (f"coord-kill: replayed end state not drained "
                f"(pending={run_fp['pending']}, "
                f"leases={sorted(run_fp['leases'])}, "
                f"done={len(run_fp['done'])}/{len(want)})")
    return ""


#: the serve leg's filtered count: the read filter's grammar (F1 on the
#: device route) and the same predicate in numpy for the truth
SERVE_FILTER = "-F 0x10 -q 20"


def serve_leg(path, tmp, device: str = "cuda") -> str:
    """Tenant storm against the serving plane (runtime/serve.py): four
    good tenants issue concurrent region queries — read counts, and
    filtered counts under ``SERVE_FILTER`` — through injected transient
    read faults; then the abusive tenant's 2 slots + 2-deep queue are
    pinned full and its further requests must shed. Contract: every
    good tenant's query answers 200 with counts matching a fault-free
    host-route traversal read (even while the abuser is being shed),
    the abusive tenant gets 429s, and ``serve.admission{result=shed}``
    is booked."""
    import json
    import threading as _threading
    import urllib.error
    import urllib.request

    import numpy as np

    from disq_tpu_torch import (
        BaiWriteOption, DisqOptions, Interval, TraversalParameters)
    from disq_tpu_torch.fsw import (
        FaultInjectingFileSystemWrapper,
        FaultSpec,
        PosixFileSystemWrapper,
        register_filesystem,
    )
    from disq_tpu_torch.runtime import serve as serve_mod
    from disq_tpu_torch.runtime.introspect import stop_introspect_server
    from disq_tpu_torch.runtime.tracing import counter

    indexed = os.path.join(tmp, "serve-indexed.bam")
    st = _host().num_shards(4)
    st.write(st.read(path), indexed, BaiWriteOption.ENABLE, sort=True)

    regions = [("chr1", 1, 5000), ("chr1", 40_000, 60_000),
               ("chr2", 1, 50_000), ("chrM", 1, 16_569)]
    truth, matched = {}, {}
    for contig, start, end in regions:
        ds = _host().read(
            indexed,
            TraversalParameters(intervals=[Interval(contig, start, end)]))
        truth[(contig, start, end)] = ds.count()
        flag = np.asarray(ds.reads.flag).astype(np.int64)
        mapq = np.asarray(ds.reads.mapq).astype(np.int64)
        matched[(contig, start, end)] = int(
            (((flag & 0x10) == 0) & (mapq >= 20)).sum())

    register_filesystem("fault", FaultInjectingFileSystemWrapper(
        PosixFileSystemWrapper(),
        [FaultSpec(kind="transient", probability=0.15)], seed=77))
    try:
        addr = serve_mod.start_serve(
            options=DisqOptions(max_retries=8, retry_backoff_s=0.0),
            tenant_slots=2, tenant_queue=2, device=device,
            resident_decode=True)
        daemon = serve_mod.serve_if_running()
        daemon.register("soak", "fault://" + indexed)

        def query(tenant, region, timeout=30, endpoint="/query/reads",
                  **extra):
            contig, start, end = region
            body = json.dumps({
                "dataset": "soak", "tenant": tenant, "limit": 0,
                "intervals": [
                    {"contig": contig, "start": start, "end": end}],
                **extra,
            }).encode()
            req = urllib.request.Request(
                f"http://{addr}{endpoint}", data=body,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=timeout) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read() or b"{}")

        # Warm the header+index cache (the index build path is not
        # retried; a transient during warm-up just retries the query).
        warm_err = None
        for _ in range(8):
            code, body = query("warm", regions[0])
            if code == 200:
                warm_err = None
                break
            warm_err = f"warm-up answered {code}: {body}"
        if warm_err:
            return f"serve: {warm_err}"
        daemon.cache.clear()  # the storm must fetch through the faults

        # Good tenants: all queries must succeed with truthful counts.
        errors = []

        def good(k):
            tenant = f"good-{k}"
            for region in regions:
                code, body = query(tenant, region)
                if code != 200:
                    errors.append(
                        f"tenant {tenant} got {code} for {region}: "
                        f"{body.get('error')}")
                elif body["count"] != truth[region]:
                    errors.append(
                        f"tenant {tenant} count {body['count']} != "
                        f"truth {truth[region]} for {region}")
                code, body = query(tenant, region,
                                   endpoint="/query/filtered-count",
                                   filter=SERVE_FILTER)
                if code != 200:
                    errors.append(
                        f"tenant {tenant} filtered count got {code} for "
                        f"{region}: {body.get('error')}")
                elif body["matched"] != matched[region]:
                    errors.append(
                        f"tenant {tenant} filtered count "
                        f"{body['matched']} != truth {matched[region]} "
                        f"for {region}")

        threads = [_threading.Thread(target=good, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            return "serve: " + "; ".join(errors[:3])

        # Abusive tenant: pin the storm's worst case deterministically —
        # occupy both of the abuser's slots and park two more acquires
        # in its 2-deep wait queue through the daemon's admission
        # object, then every further HTTP request from that tenant MUST
        # shed with 429 while the good tenants' own slots are untouched.
        import time as _time

        adm = daemon.admission
        for _ in range(2):
            adm.acquire("abuser")
        parked = [_threading.Thread(target=adm.acquire, args=("abuser",))
                  for _ in range(2)]
        for t in parked:
            t.start()
        deadline = _time.time() + 10.0
        while _time.time() < deadline:
            ten = adm.stats()["tenants"].get("abuser", {})
            if ten.get("queued", 0) >= 2:
                break
            _time.sleep(0.01)
        try:
            codes = [query("abuser", regions[2])[0] for _ in range(8)]
            good_code, good_body = query("good-0", regions[0])
        finally:
            for _ in range(2):
                adm.release("abuser")
            for t in parked:
                t.join()
            for _ in range(2):
                adm.release("abuser")
        shed_seen = codes.count(429)
        if shed_seen != len(codes):
            return (f"serve: abuser with full slots+queue answered "
                    f"{codes}, expected all 429")
        if good_code != 200 or good_body["count"] != truth[regions[0]]:
            return (f"serve: good tenant degraded during the abuser "
                    f"storm ({good_code}, {good_body.get('count')})")
        if counter("serve.admission").value(
                result="shed", tenant="abuser") <= 0:
            return ("serve: 429s answered but serve.admission"
                    "{result=shed,tenant=abuser} not booked")
        return ""
    finally:
        serve_mod.stop_serve()
        stop_introspect_server()
        register_filesystem("fault", FaultInjectingFileSystemWrapper(
            PosixFileSystemWrapper(), [], seed=0))


# Replica subprocess for the fleet leg: one real serving daemon in its
# own interpreter on the parent's device, registered at startup. Prints
# its address then holds on stdin (the leg SIGKILLs one of these
# mid-storm).
_FLEET_REPLICA_CODE = r"""
import json, os, sys
cfg = json.loads(sys.argv[1])
sys.path.insert(0, cfg["repo"])
import torch
from disq_tpu_torch.runtime import serve as serve_mod
if cfg["device"] == "cuda":
    torch.zeros(1, device="cuda")
addr = serve_mod.start_serve(port=0, tenant_slots=8, tenant_queue=32,
                             device=cfg["device"])
serve_mod.serve_if_running().register("soak", cfg["bam"])
print("ADDR", addr, flush=True)
sys.stdin.readline()
"""


def fleet_leg(path, tmp, device: str = "cuda") -> str:
    """SIGKILL one replica mid-storm behind the fleet router
    (runtime/fleet.py): two serving subprocesses answer region queries
    through the in-process routing tier (locality + hedging armed)
    while four tenant threads storm it. Contract: a hedged pre-storm
    request stitches into ONE trace_report waterfall spanning the
    router and both replicas; the kill is detected on the query path
    (``fleet.replica_lost`` in the flight recorder, no liveness
    thread); every storm response — before, during and after the kill
    — answers 200 with a digest identical to the single-replica truth;
    and the router's stats show one live replica at the end."""
    import json
    import subprocess
    import threading as _threading
    import urllib.error
    import urllib.request

    from disq_tpu_torch import BaiWriteOption
    from disq_tpu_torch.runtime import flightrec
    from disq_tpu_torch.runtime.introspect import stop_introspect_server
    from disq_tpu_torch.runtime.tracing import (
        activate_trace, counter, deactivate_trace, mint_trace)

    indexed = os.path.join(tmp, "fleet-indexed.bam")
    st = _host().num_shards(4)
    st.write(st.read(path), indexed, BaiWriteOption.ENABLE, sort=True)

    regions = [("chr1", 1, 5000), ("chr1", 40_000, 60_000),
               ("chr2", 1, 50_000), ("chrM", 1, 16_569)]

    def query(addr, qpath, region, tenant, timeout=30):
        contig, start, end = region
        body = json.dumps({
            "dataset": "soak", "tenant": tenant, "limit": 0,
            "intervals": [
                {"contig": contig, "start": start, "end": end}],
        }).encode()
        req = urllib.request.Request(
            f"http://{addr}{qpath}", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")

    procs = []

    def spawn_replica():
        cfg = json.dumps({"repo": REPO, "bam": indexed, "device": device})
        proc = subprocess.Popen(
            [sys.executable, "-c", _FLEET_REPLICA_CODE, cfg],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        procs.append(proc)
        line = proc.stdout.readline()
        if not line.startswith("ADDR"):
            raise RuntimeError(f"fleet replica failed to start: {line!r}")
        return line.split()[1]

    from disq_tpu_torch.runtime import fleet as fleet_mod

    recorder_was_on = flightrec.enabled()
    flightrec.enable(os.path.join(tmp, "fleet-flightrec"))
    try:
        addrs = [spawn_replica() for _ in range(2)]
        router_addr = fleet_mod.start_fleet(
            addrs, policy="locality", hedge_quantile=0.9,
            hedge_min_s=0.001, refresh_s=0.2, probe_s=600.0)
        router = fleet_mod.fleet_if_running()

        # Registration fans out (epoch bump on both replicas) and gives
        # the router its name->path mapping for locality resolution.
        status, doc = router.register("soak", indexed)
        if status != 200:
            return f"fleet: register fan-out answered {status}: {doc}"

        # Single-replica truth: each region straight off replica 0.
        truth = {}
        for region in regions:
            code, body = query(addrs[0], "/query/reads", region, "truth")
            if code != 200 or "digest" not in body:
                return (f"fleet: truth query {region} answered {code}: "
                        f"{body.get('error')}")
            truth[region] = (body["count"], body["digest"])

        # -- hedged request, stitched across all three processes ----------
        # Cold regions + a ~1ms hedge floor: the primary's decode
        # out-runs the timer, so the duplicate launches and both
        # replicas participate in one trace. A primary that beats the
        # floor (the truth queries warmed replica 0) raises the rolling
        # threshold to its own latency, so the regions go round up to 3
        # times until one primary outlives the window's quantile.
        trace_id = None
        for contig, start, end in regions * 3:
            ctx = mint_trace("t-trace")
            token = activate_trace(ctx)
            launched0 = counter("fleet.hedge.launched").total()
            try:
                # In-process through the router so the activated
                # context is current_trace() on the query path; the
                # router injects X-Disq-Trace-* and both hedge legs'
                # replicas adopt it.
                code, body = router.query("/query/reads", {
                    "dataset": "soak", "tenant": "t-trace", "limit": 0,
                    "intervals": [{"contig": contig, "start": start,
                                   "end": end}]})
            finally:
                deactivate_trace(token)
            if code != 200:
                return (f"fleet: hedged query {(contig, start, end)} "
                        f"answered {code}: {body.get('error')}")
            if counter("fleet.hedge.launched").total() > launched0:
                trace_id = ctx.trace_id
                break
        if trace_id is None:
            return "fleet: no hedge launched across any cold region"
        report = subprocess.run(
            [sys.executable,
             os.path.join(REPO, "scripts", "trace_report.py"),
             router_addr, addrs[0], addrs[1], "--request", trace_id],
            capture_output=True, text=True, timeout=60)
        if report.returncode != 0:
            return f"fleet: trace_report failed: {report.stderr[:300]}"
        stitched = report.stdout
        if "3 processes" not in stitched.splitlines()[0]:
            return ("fleet: hedged trace did not stitch router + both "
                    f"replicas: {stitched.splitlines()[0]}")
        if "fleet.request.trace" not in stitched \
                or "serve.request.trace" not in stitched:
            return ("fleet: stitched waterfall is missing the router "
                    "or replica root spans")

        # -- the storm: 4 tenants loop the regions, one replica dies ------
        errors = []
        done = _threading.Event()
        count = [0]
        lock = _threading.Lock()

        def tenant(k):
            name = f"storm-{k}"
            for loop in range(6):
                for region in regions:
                    code, body = query(router_addr, "/fleet/query/reads",
                                       region, name)
                    if code != 200:
                        errors.append(
                            f"tenant {name} got {code} for {region}: "
                            f"{body.get('error')}")
                        return
                    got = (body.get("count"), body.get("digest"))
                    if got != truth[region]:
                        errors.append(
                            f"tenant {name} {region} answered {got}, "
                            f"truth {truth[region]}")
                        return
                    with lock:
                        count[0] += 1
                        if count[0] >= 24:
                            done.set()

        threads = [_threading.Thread(target=tenant, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        # SIGKILL the *truth* replica about a third of the way in: the
        # survivors' answers must still match its pre-storm digests.
        done.wait(timeout=60)
        procs[0].kill()
        procs[0].wait()
        for t in threads:
            t.join()
        if errors:
            return "fleet: " + "; ".join(errors[:3])

        stats = router.stats()
        if stats["live"] != 1:
            return (f"fleet: router sees {stats['live']} live replicas "
                    "after the kill, expected 1")
        rec = flightrec.recorder()
        events = rec.events() if rec is not None else []
        if not any(e.get("kind") == "fleet.replica_lost" for e in events):
            return ("fleet: replica SIGKILLed but no fleet.replica_lost "
                    "event in the flight recorder ring")
        return ""
    finally:
        fleet_mod.stop_fleet()
        for proc in procs:
            proc.kill()
            proc.wait()
            for pipe in (proc.stdin, proc.stdout):
                pipe.close()
        stop_introspect_server()
        if not recorder_was_on:
            flightrec.reset_flightrec()


def _launches() -> dict:
    """The kernel launches this process has booked so far, by kernel."""
    from disq_tpu_torch.runtime import counters

    return dict(counters.snapshot()["launches"])


def _booked_since(before: dict) -> dict:
    after = _launches()
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def _build_kernels() -> None:
    """On the card: the CUDA context and every kernel the legs launch,
    built once here, before any leg starts a child process (the children
    load what this process built)."""
    import torch

    from disq_tpu_torch.ops import cuda_build

    torch.zeros(1, device="cuda")
    cuda_build.build(list(KERNELS))


def _restore_process_state(fault_fs) -> None:
    """Leave the process-global planes as a caller that imports the soak
    had them: no daemon, fleet, coordinator, endpoint or device service,
    fresh resilience books, and its own ``fault`` filesystem (or none)."""
    from disq_tpu_torch.fsw import filesystem
    from disq_tpu_torch.runtime import (
        device_service, fleet, introspect, resilience, scheduler, serve)

    serve.stop_serve()
    fleet.stop_fleet()
    scheduler.stop_coordinator()
    introspect.reset_introspection()
    resilience.reset_resilience()
    device_service.shutdown_service()
    if fault_fs is None:
        filesystem._SCHEME_REGISTRY.pop("fault", None)
    else:
        filesystem._SCHEME_REGISTRY["fault"] = fault_fs


#: the legs after the iteration loop, in the reference's order: the flag
#: (its ``args`` attribute) and the function, which takes ``(path,
#: baseline | tmp, device)``
LEGS = (
    ("breaker", "breaker", breaker_leg, False),
    ("resident", "resident", resident_leg, False),
    ("ops", "ops", ops_leg, False),
    ("device-write", "device_write", device_write_leg, False),
    ("steal", "steal", steal_leg, True),
    ("coord-kill", "coord_kill", coord_kill_leg, True),
    ("kill", "kill", kill_leg, True),
    ("serve", "serve", serve_leg, True),
    ("fleet", "fleet", fleet_leg, True),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--records", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0,
                    help="master seed; each iteration derives its own")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the soaked reads, writes, chains and "
                         "daemons run (default cuda, the device route "
                         "through the kernels; without CUDA the script "
                         "raises). The baselines they are held against "
                         "always run on the host route on the CPU")
    ap.add_argument("--work-dir", default=None,
                    help="where the fixture and the outputs go, in a "
                         "temporary directory removed at the end "
                         "(default: the system's)")
    ap.add_argument("--executor-workers", type=int, default=1,
                    help="shard-pipeline executor width: >1 soaks the "
                         "parallel read path (fault firing order becomes "
                         "thread-dependent, but the recovery contract — "
                         "byte identity / bounded loss / strict raise — "
                         "must hold regardless)")
    ap.add_argument("--writer-workers", type=int, default=1,
                    help="shard write-pipeline width for the write-back "
                         "leg: every recovered dataset is re-written "
                         "through the fault fs (write-side transients "
                         "injected) and must match a fault-free "
                         "sequential write byte for byte")
    ap.add_argument("--watchdog", action="store_true",
                    help="arm the heartbeat watchdog on both directions "
                         "and inject one guaranteed write-side stall per "
                         "write-back leg: the iteration FAILS unless "
                         "watchdog.stalled_shards flags it within the "
                         "window (stall-kind legs assert detection, not "
                         "just recovery)")
    ap.add_argument("--hedge", action="store_true",
                    help="arm hedged fetches and inject a seeded slow "
                         "tail on reads: every iteration's byte-identity "
                         "contract must hold under racing duplicates, "
                         "and hedge accounting (launched == won) is "
                         "asserted at the end")
    ap.add_argument("--breaker", action="store_true",
                    help="run the deterministic circuit-breaker leg: a "
                         "total fault storm must trip the breaker within "
                         "its window, open-state reads must fail fast, "
                         "and a half-open probe must reclose it with "
                         "byte-identical output")
    ap.add_argument("--resident", action="store_true",
                    help="run the device-route leg: a resident read at "
                         "2 executor workers through a transient-fault "
                         "schedule must yield a device-backed batch "
                         "byte-identical (after d2h) to the fault-free "
                         "host path")
    ap.add_argument("--ops", action="store_true",
                    help="run the operator-suite leg: the chained "
                         "filter → sort → markdup → pileup → rgstats "
                         "pipeline through a transient-fault schedule "
                         "must produce stats and marked flag columns "
                         "identical to the fault-free chain")
    ap.add_argument("--device-write", action="store_true",
                    help="run the symmetric device write leg: a "
                         "resident-encoded, service-routed device "
                         "deflate write under injected write faults must "
                         "re-read to records identical to the "
                         "fault-free host-path output (byte-validity, "
                         "not byte-identity)")
    ap.add_argument("--steal", action="store_true",
                    help="run the work-stealing leg: a 2-subprocess "
                         "scheduled read with one worker slowed by a "
                         "faultfs slow tail must steal at least one "
                         "lease to the fast worker, emit every shard "
                         "exactly once, and match a fault-free "
                         "single-host read digest for digest")
    ap.add_argument("--serve", action="store_true",
                    help="run the serving-plane leg: a tenant storm "
                         "(four good tenants + one abusive tenant) "
                         "through injected transient read faults; good "
                         "tenants' region queries and filtered counts "
                         "must all succeed with truthful counts, the "
                         "abusive tenant must shed with 429s, and "
                         "serve.admission{result=shed} must be booked")
    ap.add_argument("--coord-kill", action="store_true",
                    help="run the coordinator-failover leg: a 4-worker "
                         "scheduled read whose coordinator process is "
                         "SIGKILLed mid-pass; the lowest live process "
                         "id must take over by replaying the journal "
                         "and the survivors must finish the same "
                         "epoch's complement exactly once, digest-"
                         "identical to a single-host read")
    ap.add_argument("--fleet", action="store_true",
                    help="run the fleet-failover leg: two serving "
                         "replicas behind the locality/hedging router, "
                         "one SIGKILLed mid-storm; a hedged request "
                         "must stitch into one trace across all three "
                         "processes, fleet.replica_lost must land in "
                         "the flight recorder, and every tenant "
                         "response must stay digest-identical to the "
                         "dead replica's pre-storm truth")
    ap.add_argument("--kill", action="store_true",
                    help="run the crash-resume leg: SIGKILL a writer "
                         "subprocess mid-run, resume from its "
                         "StageManifest, assert only unfinished shards "
                         "re-ran (via the ledger) and the final bytes "
                         "match a fault-free run")
    args = ap.parse_args(argv)

    from disq_tpu_torch.util import resolve_device

    device = resolve_device(args.device).type  # raises without CUDA
    if device == "cuda":
        _build_kernels()

    # DISQ_TPU_TORCH_POSTMORTEM_DIR arms the flight recorder for the soak
    # itself and wires faulthandler into the dir, so a native-extension
    # crash under chaos dumps tracebacks instead of dying silently.
    if os.environ.get("DISQ_TPU_TORCH_POSTMORTEM_DIR"):
        from disq_tpu_torch.runtime import flightrec

        flightrec.enable(os.environ["DISQ_TPU_TORCH_POSTMORTEM_DIR"])

    from disq_tpu_torch.fsw import filesystem
    from disq_tpu_torch.runtime.tracing import counter

    fault_fs = filesystem._SCHEME_REGISTRY.get("fault")
    RESULTS.clear()
    RESULTS.update(device=device, policies={}, legs={}, launches={},
                   failures=[])
    hedge0 = (counter("hedge.launched").total(),
              counter("hedge.won").total())
    try:
        with tempfile.TemporaryDirectory(prefix="chaos-soak-",
                                         dir=args.work_dir) as tmp:
            path, data, n_records = build_fixture(tmp, args.records,
                                                  args.seed)
            baseline = _host().split_size(SPLIT).read(path)
            failures = RESULTS["failures"]
            t0, booked = time.perf_counter(), _launches()
            for i in range(args.iterations):
                it_seed = args.seed * 1_000_003 + i
                RESULTS["policies"][it_seed] = draw_iteration(
                    data, it_seed, watchdog=args.watchdog,
                    hedge=args.hedge)["policy"]
                err = run_iteration(path, data, n_records, baseline,
                                    it_seed,
                                    executor_workers=args.executor_workers,
                                    writer_workers=args.writer_workers,
                                    watchdog=args.watchdog,
                                    hedge=args.hedge, device=device)
                status = "ok" if not err else f"FAIL: {err}"
                print(f"[{i + 1}/{args.iterations}] seed={it_seed} "
                      f"{status}", flush=True)
                if err:
                    failures.append((it_seed, err))
            RESULTS["legs"]["main"] = time.perf_counter() - t0
            RESULTS["launches"]["main"] = _booked_since(booked)
            if args.hedge:
                launched = counter("hedge.launched").total() - hedge0[0]
                won = counter("hedge.won").total() - hedge0[1]
                if launched != won:
                    failures.append((args.seed, (
                        f"hedge accounting out of balance: {launched} "
                        f"launched, {won} won bookings")))
                print(f"[hedge] {int(launched)} launched, all accounted",
                      flush=True)
            for flag, attr, leg, takes_tmp in LEGS:
                if not getattr(args, attr):
                    continue
                t0, booked = time.perf_counter(), _launches()
                err = leg(path, tmp if takes_tmp else baseline, device)
                RESULTS["legs"][flag] = time.perf_counter() - t0
                RESULTS["launches"][flag] = _booked_since(booked)
                print(f"[{flag}] {'ok' if not err else 'FAIL: ' + err}",
                      flush=True)
                if err:
                    failures.append((args.seed, err))
            print(f"{len(failures)} mismatches in {args.iterations} "
                  "iterations")
            for it_seed, err in failures:
                print(f"  seed={it_seed}: {err}")
            return 1 if failures else 0
    finally:
        _restore_process_state(fault_fs)


if __name__ == "__main__":
    sys.exit(main())
