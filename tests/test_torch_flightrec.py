"""The port's flight recorder (``disq_tpu_torch/runtime/flightrec.py``)
against ``disq_tpu``'s, on the CPU.

The cases of ``tests/test_flightrec.py``: the bounded event ring, the
disabled default that allocates and writes nothing, bundles (their
artifacts, the ledger tails, the per-process cap, the abort dedupe),
``faulthandler`` wiring, the abort paths (a strict corrupt block inline,
a watchdog abort at 4 workers whose bundle ``scripts/trace_report.py
--postmortem`` renders into a verdict naming the stalled split), the
``/debug/bundle`` and ``/debug/stacks`` endpoints, and the options and
``DISQ_TPU_TORCH_POSTMORTEM_DIR`` knobs. Where the two packages take the
same steps, the rings, the bundles' artifact names and the abort reasons
are held equal.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

import disq_tpu.api as R
from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
from disq_tpu.bgzf.block import parse_block_header
from disq_tpu.runtime import flightrec as ref_flightrec
from disq_tpu.runtime.introspect import reset_introspection as ref_reset_introspection
import disq_tpu_torch as P
from disq_tpu_torch.api import SbiWriteOption
from disq_tpu_torch.fsw.faultfs import FaultInjectingFileSystemWrapper, FaultSpec
from disq_tpu_torch.fsw.filesystem import PosixFileSystemWrapper, register_filesystem
from disq_tpu_torch.runtime import flightrec
from disq_tpu_torch.runtime.errors import (
    CorruptBlockError,
    DisqOptions,
    WatchdogStallError,
)
from disq_tpu_torch.runtime.introspect import (
    reset_introspection,
    start_introspect_server,
)
from disq_tpu_torch.runtime.tracing import RUN_ID, counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_REPORT = os.path.join(REPO, "scripts", "trace_report.py")
# a stall past the header's readahead fires inside a split's fetch
HEADER_READAHEAD = 256 * 1024
ARTIFACTS = {"MANIFEST.json", "stacks.txt", "metrics.prom", "spans.jsonl",
             "events.jsonl", "healthz.json", "progress.json", "options.json"}


@pytest.fixture(autouse=True)
def _clean_flightrec():
    for reset in (flightrec.reset_flightrec, reset_introspection,
                  ref_flightrec.reset_flightrec, ref_reset_introspection):
        reset()
    yield
    for reset in (flightrec.reset_flightrec, reset_introspection,
                  ref_flightrec.reset_flightrec, ref_reset_introspection):
        reset()


@pytest.fixture(scope="module")
def big_bam(tmp_path_factory):
    """Written by the port with its ``.sbi``, so split boundaries come
    from the index and no boundary read covers the stall target."""
    tmp = tmp_path_factory.mktemp("flightrec")
    raw = tmp / "raw.bam"
    raw.write_bytes(make_bam_bytes(DEFAULT_REFS,
                                   synth_records(5000, seed=21)))
    storage = P.ReadsStorage.make_default(device="cpu")
    ds = storage.read(str(raw))
    path = tmp / "big.bam"
    storage.num_shards(6).write(ds, str(path), SbiWriteOption.ENABLE)
    assert os.path.exists(str(path) + ".sbi")
    size = os.path.getsize(path)
    assert size > HEADER_READAHEAD + 64 * 1024, size
    return str(path), size


@pytest.fixture(scope="module")
def small_bam(tmp_path_factory):
    path = tmp_path_factory.mktemp("flightrec-small") / "small.bam"
    path.write_bytes(make_bam_bytes(DEFAULT_REFS,
                                    synth_records(400, seed=9),
                                    blocksize=600))
    return str(path)


def _bundles(pm):
    return sorted(d for d in os.listdir(pm) if d.startswith("bundle-"))


def _events(bundle):
    with open(os.path.join(bundle, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def _stable(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "mono")}
            for e in events]


# -- the ring -------------------------------------------------------------------


def test_ring_bounded_and_counted_like_reference(tmp_path):
    rings = []
    for mod in (flightrec, ref_flightrec):
        rec = mod.enable(str(tmp_path / mod.__name__), capacity=32)
        for i in range(100):
            mod.record_event("retry", what="t", attempt=i)
        rings.append(_stable(rec.events()))
    assert rings[0] == rings[1]
    assert [e["attempt"] for e in rings[0]] == list(range(68, 100))
    before = counter("flightrec.events").value(kind="retry")
    flightrec.record_event("retry", what="t", attempt=0)
    assert counter("flightrec.events").value(kind="retry") == before + 1


def test_disabled_path_records_and_writes_nothing(tmp_path):
    target = tmp_path / "never"
    assert flightrec.recorder() is None
    flightrec.record_event("retry", what="x")
    flightrec.note_artifact("ledger", str(target / "l.jsonl"))
    flightrec.note_abort(ValueError("boom"))
    assert flightrec.dump("explicit") is None
    assert flightrec.recorder() is None and not flightrec.enabled()
    assert not target.exists()


def test_events_carry_clock_and_fields(tmp_path):
    rec = flightrec.enable(str(tmp_path / "pm"))
    flightrec.record_event("breaker_transition", key="http", to="open",
                           kind="ignored")
    e = rec.events()[-1]
    assert e["kind"] == "breaker_transition"
    assert e["key"] == "http" and e["to"] == "open"
    assert e["ts"] > 0 and e["mono"] > 0


# -- bundles ----------------------------------------------------------------------


def test_explicit_dump_artifacts_equal_reference(tmp_path):
    ledger = tmp_path / "quarantine.jsonl"
    ledger.write_text('{"version": 1}\n{"block_offset": 7}\n')
    names = []
    for mod in (flightrec, ref_flightrec):
        rec = mod.enable(str(tmp_path / mod.__name__))
        rec.note_artifact("quarantine_manifest", str(ledger))
        mod.record_event("retry", what="t", attempt=1)
        bundle = mod.dump("explicit")
        assert bundle is not None and os.path.isdir(bundle)
        names.append(set(os.listdir(bundle)))
    assert names[0] == names[1]
    assert ARTIFACTS <= names[0]
    bundle = _bundles(str(tmp_path / flightrec.__name__))[-1]
    root = os.path.join(str(tmp_path / flightrec.__name__), bundle)
    manifest = json.load(open(os.path.join(root, "MANIFEST.json")))
    assert manifest["run_id"] == RUN_ID and manifest["reason"] == "explicit"
    [tail] = [n for n in os.listdir(root) if n.startswith("ledger-")]
    assert '"block_offset": 7' in open(os.path.join(root, tail)).read()
    assert "MainThread" in open(os.path.join(root, "stacks.txt")).read()
    assert any(e["kind"] == "retry" for e in _events(root))
    assert counter("flightrec.dumps").value(reason="explicit") >= 1


def test_faulthandler_wired_into_dir(tmp_path):
    import faulthandler

    pm = str(tmp_path / "pm")
    flightrec.enable(pm)
    assert faulthandler.is_enabled()
    assert os.path.exists(os.path.join(pm, f"crash-{os.getpid()}.log"))


def test_abort_dedupes_one_exception(tmp_path):
    pm = str(tmp_path / "pm")
    flightrec.enable(pm)
    exc = ValueError("same object")
    flightrec.note_abort(exc)
    flightrec.note_abort(exc)
    assert len(_bundles(pm)) == 1


def test_bundle_cap_bounds_abort_storms(tmp_path):
    flightrec.enable(str(tmp_path / "pm"))
    paths = [flightrec.dump("explicit")
             for _ in range(flightrec.MAX_BUNDLES + 5)]
    assert flightrec.MAX_BUNDLES == ref_flightrec.MAX_BUNDLES
    assert len([p for p in paths if p is not None]) == flightrec.MAX_BUNDLES
    assert paths[-1] is None


# -- abort paths --------------------------------------------------------------------


def _damaged_copy(small_bam, tmp_path):
    data = bytearray(open(small_bam, "rb").read())
    layout, pos = [], 0
    while pos < len(data):
        layout.append(pos)
        pos += parse_block_header(bytes(data), pos)
    data[layout[len(layout) // 2] + 20] ^= 0x10  # inside the payload
    bad = tmp_path / "bad.bam"
    bad.write_bytes(bytes(data))
    return str(bad)


def test_strict_corrupt_abort_writes_bundle_like_reference(small_bam,
                                                           tmp_path):
    bad = _damaged_copy(small_bam, tmp_path)
    pms = [str(tmp_path / "ppm"), str(tmp_path / "rpm")]
    with pytest.raises(CorruptBlockError):
        P.ReadsStorage.make_default(device="cpu").split_size(4096) \
            .postmortem_dir(pms[0]).read(bad)
    with pytest.raises(ValueError):
        R.ReadsStorage.make_default().split_size(4096) \
            .postmortem_dir(pms[1]).read(bad)
    docs = []
    for pm in pms:
        [bundle] = _bundles(pm)
        root = os.path.join(pm, bundle)
        manifest = json.load(open(os.path.join(root, "MANIFEST.json")))
        last = _events(root)[-1]
        docs.append((manifest["reason"], last["kind"], last["reason"],
                     last["where"], last["error"].split(":")[0]))
    assert docs[0] == docs[1]
    assert docs[0][:3] == ("pipeline_abort", "abort", "pipeline_abort")


def test_watchdog_abort_bundle_names_stalled_shard(big_bam, tmp_path):
    path, size = big_bam
    pm = str(tmp_path / "pm")
    target = max(size * 3 // 5, HEADER_READAHEAD + 32 * 1024)
    register_filesystem("pmfault", FaultInjectingFileSystemWrapper(
        PosixFileSystemWrapper(),
        [FaultSpec(kind="stall", offset=target, stall_s=8.0, times=1)],
        scheme="pmfault"))
    st = (P.ReadsStorage.make_default(device="cpu").split_size(96 * 1024)
          .executor_workers(4).watchdog(1.0, "abort").postmortem_dir(pm))
    with pytest.raises(WatchdogStallError) as ei:
        st.read("pmfault://" + path)
    stalled = ei.value.shard_id
    assert stalled >= 0
    bundle = os.path.join(pm, _bundles(pm)[-1])
    assert {"stacks.txt", "metrics.prom", "spans.jsonl", "events.jsonl",
            "MANIFEST.json"} <= set(os.listdir(bundle))
    events = _events(bundle)
    stalls = [e for e in events if e["kind"] == "watchdog_stall"]
    assert stalls and stalls[-1]["shard"] == stalled
    assert stalls[-1]["stage"] == "fetch"
    aborts = [e for e in events if e["kind"] == "abort"]
    assert aborts and aborts[-1]["reason"] == "watchdog_abort"
    prom = open(os.path.join(bundle, "metrics.prom")).read()
    assert "disq_tpu_watchdog_stalled_shards" in prom
    assert "disq-torch-fetch" in open(os.path.join(bundle,
                                                   "stacks.txt")).read()
    proc = subprocess.run([sys.executable, TRACE_REPORT, "--postmortem",
                           bundle], capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert f"verdict: shard {stalled} stalled in fetch" in proc.stdout


def test_options_json_captures_resolved_options(big_bam, tmp_path,
                                                monkeypatch):
    path, _ = big_bam
    pm = str(tmp_path / "pm")
    monkeypatch.setenv("DISQ_TPU_TORCH_READ_FILTER", "")
    P.ReadsStorage.make_default(device="cpu").split_size(96 * 1024) \
        .executor_workers(2).postmortem_dir(pm).read(path)
    assert not _bundles(pm), "a clean run must not dump"
    doc = json.load(open(os.path.join(flightrec.dump("explicit"),
                                      "options.json")))
    assert doc["options"]["executor_workers"] == 2
    assert doc["options"]["postmortem_dir"] == pm
    assert doc["run_id"] == RUN_ID
    assert "DISQ_TPU_TORCH_READ_FILTER" in doc["env"]


# -- endpoints and knobs ---------------------------------------------------------------


def test_debug_bundle_endpoint(tmp_path):
    addr = start_introspect_server(0)
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"http://{addr}/debug/bundle", timeout=5)
    assert ei.value.code == 409
    flightrec.enable(str(tmp_path / "pm"))
    with urllib.request.urlopen(f"http://{addr}/debug/bundle",
                                timeout=5) as resp:
        doc = json.loads(resp.read())
    assert os.path.isdir(doc["bundle"]) and doc["run_id"] == RUN_ID
    assert counter("flightrec.dumps").value(reason="endpoint") >= 1


def test_debug_stacks_endpoint():
    addr = start_introspect_server(0)
    with urllib.request.urlopen(f"http://{addr}/debug/stacks",
                                timeout=5) as resp:
        body = resp.read().decode()
    assert "MainThread" in body and "disq-introspect" in body


def test_option_validation_and_env_knob(tmp_path, monkeypatch):
    with pytest.raises(ValueError):
        DisqOptions().with_postmortem("")
    st = P.ReadsStorage.make_default(device="cpu") \
        .postmortem_dir(str(tmp_path))
    assert st._options.postmortem_dir == str(tmp_path)
    monkeypatch.setenv("DISQ_TPU_TORCH_POSTMORTEM_DIR", str(tmp_path / "env"))
    flightrec.configure_from_options(DisqOptions())
    rec = flightrec.recorder()
    assert rec is not None and rec.postmortem_dir == str(tmp_path / "env")
