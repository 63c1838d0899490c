"""The port's chaos soak (``scripts/torch_chaos_soak.py``) against the
reference's (``scripts/chaos_soak.py``), on the CPU.

- The same iteration seed draws the same fault schedule, policy, block,
  offset and bit in both scripts.
- With the same schedule, a ``fault://`` read through each package gives
  the same outcome, at 1 and 4 executor workers, on the port's host
  route and on its device route (the plain versions of B1 and B2).
- Every leg of the soak passes on the CPU, and a planted defect in the
  main loop, the device route, the operator chain or the device write
  makes the soak fail and name the seed.

The subprocess legs (``--kill``, ``--steal``, ``--coord-kill``,
``--fleet``) are in ``tests/test_torch_chaos_soak_procs.py``.
"""

import dataclasses
import importlib.util
import json
import os
import random

import numpy as np
import pytest

import disq_tpu.api as R
from disq_tpu.fsw import FaultInjectingFileSystemWrapper as RefFaultFS
from disq_tpu.fsw import FaultSpec as RefFaultSpec
from disq_tpu.fsw import PosixFileSystemWrapper as RefPosix
from disq_tpu.fsw import register_filesystem as ref_register
from disq_tpu.runtime.errors import CorruptBlockError as RefCorruptBlockError
from disq_tpu.runtime.errors import DisqOptions as RefOptions
from disq_tpu.runtime.errors import ErrorPolicy as RefPolicy
import disq_tpu_torch as P
from disq_tpu_torch.fsw import (
    FaultInjectingFileSystemWrapper,
    PosixFileSystemWrapper,
    register_filesystem,
)
from disq_tpu_torch.util import shutdown_shared_host_pool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name: str, module: str):
    spec = importlib.util.spec_from_file_location(
        module, os.path.join(REPO, "scripts", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


soak = _load_script("torch_chaos_soak.py", "torch_chaos_soak")
ref_soak = _load_script("chaos_soak.py", "reference_chaos_soak")

# 200 iteration seeds, as main() derives them from master seeds 0 and 7
SCHEDULE_SEEDS = [s * 1_000_003 + i for s in (0, 7) for i in range(100)]
# master seed 7's first 20 iterations: every policy, both offsets
OUTCOME_SEEDS = [7 * 1_000_003 + i for i in range(20)]
POLICIES = ("strict", "skip", "quarantine", "recover")
FIELDS = ("refid", "pos", "mapq", "bin", "flag", "next_refid", "next_pos",
          "tlen", "name_offsets", "names", "cigar_offsets", "cigars",
          "seq_offsets", "seqs", "quals", "tag_offsets", "tags")


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    """Leave no idle pool threads behind for later tests in the process."""
    yield
    shutdown_shared_host_pool()


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The soak's 200-record BAM at master seed 7, and its host read."""
    tmp = str(tmp_path_factory.mktemp("soak"))
    path, data, n = soak.build_fixture(tmp, 200, 7)
    baseline = P.ReadsStorage.make_default(device="cpu").split_size(
        soak.SPLIT).read(path)
    return path, data, n, baseline


def reference_draw(data, it_seed, watchdog, hedge):
    """The draws of ``scripts/chaos_soak.py::run_iteration`` (lines
    178-189 there), through that script's own functions."""
    rng = random.Random(it_seed)
    faults = ref_soak.random_schedule(rng, watchdog=watchdog, hedge=hedge)
    policy = rng.choice(["strict", "skip", "quarantine", "recover"])
    corrupt_at = rel = bit = None
    if policy != "recover":
        corrupt_at = ref_soak.pick_block(data, rng)
        rel = rng.choice([1, 20])
        bit = rng.randint(0, 7)
        faults = [RefFaultSpec(kind="bitflip", offset=corrupt_at + rel,
                               bit=bit)] + (
            faults if policy != "strict" else [])
    return {"faults": faults, "policy": policy, "corrupt_at": corrupt_at,
            "rel": rel, "bit": bit}


# -- (a) the schedule ----------------------------------------------------


@pytest.mark.parametrize("chunk", range(4))
@pytest.mark.parametrize("watchdog,hedge",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_schedule_equals_reference(fixture, watchdog, hedge, chunk):
    _, data, _, _ = fixture
    for it_seed in SCHEDULE_SEEDS[chunk * 50:(chunk + 1) * 50]:
        want = reference_draw(data, it_seed, watchdog, hedge)
        got = soak.draw_iteration(data, it_seed, watchdog=watchdog,
                                  hedge=hedge)
        for key in ("policy", "corrupt_at", "rel", "bit"):
            assert got[key] == want[key], (it_seed, key)
        assert len(got["faults"]) == len(want["faults"]), it_seed
        for g, w in zip(got["faults"], want["faults"]):
            assert [f.name for f in dataclasses.fields(g)] == \
                [f.name for f in dataclasses.fields(w)]
            assert dataclasses.asdict(g) == dataclasses.asdict(w), it_seed


def test_schedule_seeds_cover_every_policy_and_offset(fixture):
    _, data, _, _ = fixture
    plans = [soak.draw_iteration(data, s) for s in OUTCOME_SEEDS]
    assert {p["policy"] for p in plans} == set(POLICIES)
    for policy in ("strict", "skip", "quarantine"):
        assert any(p["policy"] == policy for p in plans)
    assert {p["rel"] for p in plans if p["rel"]} == {1, 20}
    assert len(OUTCOME_SEEDS) >= 16


# -- (b) the outcome ----------------------------------------------------


def _manifest_offsets(qdir):
    path = os.path.join(qdir, "MANIFEST.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        lines = f.read().splitlines()[1:]
    return sorted(json.loads(line)["block_offset"] for line in lines)


def _outcome(read, qdir, corrupt_error):
    try:
        ds = read()
    except corrupt_error as e:
        return {"raised": e.block_offset}
    rb = ds.reads.to_read_batch() if hasattr(ds.reads, "to_read_batch") \
        else ds.reads
    return {"count": ds.count(),
            "columns": {f: np.asarray(getattr(rb, f)) for f in FIELDS},
            "skipped": ds.counters.skipped_blocks,
            "quarantined": ds.counters.quarantined_blocks,
            "manifest": _manifest_offsets(qdir)}


def reference_outcome(path, data, it_seed, workers, qdir):
    plan = reference_draw(data, it_seed, False, False)
    ref_register("fault", RefFaultFS(RefPosix(), plan["faults"],
                                     seed=it_seed))
    policy = plan["policy"]
    opts = RefOptions(
        error_policy=RefPolicy.coerce(
            policy if policy != "recover" else "strict"),
        max_retries=6, retry_backoff_s=0.0, quarantine_dir=qdir,
        executor_workers=workers)
    storage = R.ReadsStorage.make_default().split_size(
        soak.SPLIT).options(opts)
    return _outcome(lambda: storage.read("fault://" + path), qdir,
                    RefCorruptBlockError)


def port_outcome(path, data, it_seed, workers, route, qdir):
    plan = soak.draw_iteration(data, it_seed)
    register_filesystem("fault", FaultInjectingFileSystemWrapper(
        PosixFileSystemWrapper(), plan["faults"], seed=it_seed))
    policy = plan["policy"]
    opts = P.DisqOptions(
        error_policy=P.ErrorPolicy.coerce(
            policy if policy != "recover" else "strict"),
        max_retries=6, retry_backoff_s=0.0, quarantine_dir=qdir,
        executor_workers=workers)
    storage = (P.ReadsStorage.make_default(device="cpu")
               .split_size(soak.SPLIT).options(opts)
               .resident_decode(route == "resident"))

    def read():
        ds = storage.read("fault://" + path)
        if route == "resident" and ds.count():
            assert ds.reads.device_backed
        return ds

    return _outcome(read, qdir, P.CorruptBlockError)


@pytest.mark.parametrize("route", ["host", "resident"])
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("it_seed", OUTCOME_SEEDS)
def test_outcome_equals_reference(fixture, tmp_path, it_seed, workers,
                                  route):
    path, data, n, baseline = fixture
    plan = soak.draw_iteration(data, it_seed)
    policy = plan["policy"]
    want = reference_outcome(path, data, it_seed, workers,
                             str(tmp_path / "ref-q"))
    got = port_outcome(path, data, it_seed, workers, route,
                       str(tmp_path / "port-q"))
    if policy == "strict":
        assert got == want == {"raised": plan["corrupt_at"]}
        return
    assert "raised" not in got and "raised" not in want, (got, want)
    assert got["count"] == want["count"]
    for f in FIELDS:
        assert np.array_equal(got["columns"][f], want["columns"][f]), f
    for key in ("skipped", "quarantined", "manifest"):
        assert got[key] == want[key], key
    if policy == "recover":
        assert got["count"] == n
        for f in FIELDS:
            assert np.array_equal(got["columns"][f],
                                  getattr(baseline.reads, f)), f
    else:
        assert got["skipped"] + got["quarantined"] == 1
        assert 0 < n - got["count"] <= 20
        if policy == "quarantine":
            assert got["manifest"] == [plan["corrupt_at"]]


# -- (c) every leg on the CPU --------------------------------------------

LEG_ARGS = {
    "main-w4": ["--executor-workers", "4", "--writer-workers", "4",
                "--watchdog", "--hedge"],
    "hedge": ["--hedge"],
    "watchdog": ["--watchdog"],
    "breaker": ["--breaker"],
    "resident": ["--resident"],
    "ops": ["--ops"],
    "device-write": ["--device-write"],
    "serve": ["--serve"],
}
BASE_ARGS = ["--device", "cpu", "--iterations", "1", "--records", "200",
             "--seed", "7"]


def run_soak(capsys, extra):
    rc = soak.main(BASE_ARGS + extra)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("leg", sorted(LEG_ARGS))
def test_leg_passes_on_cpu(capsys, leg):
    rc, out = run_soak(capsys, LEG_ARGS[leg])
    assert rc == 0, out
    assert "0 mismatches in 1 iterations" in out
    assert "[1/1] seed=7000021 ok" in out
    if "--hedge" in LEG_ARGS[leg]:
        assert "launched, all accounted" in out
    if leg not in ("main-w4", "hedge", "watchdog"):
        assert f"[{leg}] ok" in out


def test_soak_raises_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        soak.main(["--iterations", "1", "--records", "200"])


def test_soak_leaves_process_state_as_it_found_it(capsys):
    from disq_tpu_torch.fsw import filesystem
    from disq_tpu_torch.runtime import device_service, scheduler, serve

    before = filesystem._SCHEME_REGISTRY.get("fault")
    rc, out = run_soak(capsys, ["--serve", "--device-write"])
    assert rc == 0, out
    assert filesystem._SCHEME_REGISTRY.get("fault") is before
    assert serve.serve_if_running() is None
    assert scheduler.active_coordinator() is None
    assert not device_service.enabled()
    assert soak.RESULTS["policies"] == {7000021: "recover"}
    assert set(soak.RESULTS["legs"]) == {"main", "serve", "device-write"}


# -- (d) planted defects -------------------------------------------------


def _assert_caught(capsys, extra, seed_line):
    rc, out = run_soak(capsys, extra)
    assert rc == 1, out
    assert "0 mismatches" not in out
    assert seed_line in out, out


def test_defect_in_salvage_caught_by_main_loop(monkeypatch, capsys):
    """The host salvage drops a second, intact block beside the corrupt
    one: the skip and quarantine iterations among master seed 7's first
    9 must fail."""
    from disq_tpu_torch.bam import source

    real = source.inflate_blocks_salvage

    def drop_two(data, blocks, base, ctx, owned_until=None):
        payloads = real(data, blocks, base, ctx, owned_until=owned_until)
        if None in payloads:
            j = next((j for j, p in enumerate(payloads) if p is not None
                      and (owned_until is None
                           or blocks[j].pos < owned_until)), None)
            if j is not None:
                ctx.handle_corrupt_block(
                    ValueError("planted"), block_offset=blocks[j].pos,
                    kind="BGZF block")
                payloads[j] = None
        return payloads

    monkeypatch.setattr(source, "inflate_blocks_salvage", drop_two)
    _assert_caught(capsys, ["--iterations", "9"],
                   "dropped 2 blocks, expected 1")


def test_defect_in_device_parse_caught_by_resident_leg(monkeypatch, capsys):
    """B2's plain version shifts one decoded ``pos``."""
    from disq_tpu_torch.ops import parse

    real = parse.parse_records_plain

    def shifted(*args, **kwargs):
        cols = real(*args, **kwargs)
        if cols.shape[-1] > 0:
            cols = cols.clone()
            cols[parse._FIELD_ORDER.index("pos"), 0] += 1
        return cols

    monkeypatch.setattr(parse, "parse_records_plain", shifted)
    _assert_caught(capsys, ["--resident"], "seed=7: resident:")


def test_defect_in_read_filter_caught_by_ops_leg(monkeypatch, capsys):
    """F1's plain version drops the first kept record of each batch."""
    from disq_tpu_torch.ops import rfilter

    real = rfilter.mask_plain

    def leaky(*args, **kwargs):
        keep = real(*args, **kwargs)
        if keep.numel():
            keep = keep.clone()
            keep[0] = False
        return keep

    monkeypatch.setattr(rfilter, "mask_plain", leaky)
    _assert_caught(capsys, ["--ops"], "seed=7: ops:")


def test_defect_in_record_gather_caught_by_device_write_leg(monkeypatch,
                                                            capsys):
    """W1's plain version puts a wrong byte in a gathered record."""
    from disq_tpu_torch.ops import record_gather

    real = record_gather.gather_plain

    def corrupt(*args, **kwargs):
        out = real(*args, **kwargs)
        if out.numel() > 40:
            out = out.clone()
            out[40] ^= 0x01
        return out

    monkeypatch.setattr(record_gather, "gather_plain", corrupt)
    _assert_caught(capsys, ["--device-write"], "seed=7: device-write:")


# -- (e) the slow soak ----------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("executor_workers", [1, 4])
def test_chaos_soak_smoke(capsys, executor_workers):
    """The counterpart of ``tests/test_fault_injection.py::
    test_chaos_soak_smoke``: 3 iterations and every leg, at 1 and 4
    workers, with ``--watchdog`` at 4."""
    rc, out = run_soak(
        capsys,
        ["--iterations", "3", "--executor-workers", str(executor_workers),
         "--writer-workers", str(executor_workers), "--hedge", "--breaker",
         "--resident", "--device-write", "--steal", "--kill", "--coord-kill",
         "--serve", "--fleet", "--ops"]
        + (["--watchdog"] if executor_workers > 1 else []))
    assert rc == 0, out
    assert "0 mismatches in 3 iterations" in out
