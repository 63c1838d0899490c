"""The port's sampling profiler (``disq_tpu_torch/runtime/profiler.py``)
against ``disq_tpu``'s, on the CPU.

The cases of ``tests/test_profiler.py``, on what is deterministic rather
than on timing: the role table (the reference's names map as the
reference maps them, the port's ``disq-torch-*`` pools map to the same
roles), samples per role taken by explicit sampling sweeps over threads
of known names, ``profile.dropped`` under an injected clock (equal to the
reference's under the same clock), the collapsed-text and speedscope
formats, the zero-thread default, the ``profile_hz`` and
``DISQ_TPU_TORCH_PROFILE_HZ`` lifecycles, the ``/debug/profile`` endpoint
and the cluster's collection, and ``scripts/trace_report.py --flame``.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
from disq_tpu.runtime import profiler as ref_profiler
import disq_tpu_torch as P
from disq_tpu_torch.runtime import profiler
from disq_tpu_torch.runtime.errors import DisqOptions
from disq_tpu_torch.runtime.executor import ShardPipelineExecutor, ShardTask
from disq_tpu_torch.runtime.introspect import (
    reset_introspection,
    start_introspect_server,
)
from disq_tpu_torch.runtime.profiler import SamplingProfiler, role_of
from disq_tpu_torch.runtime.tracing import counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_REPORT = os.path.join(REPO, "scripts", "trace_report.py")


@pytest.fixture(autouse=True)
def _clean_profiler():
    profiler.reset_profiler()
    reset_introspection()
    yield
    profiler.reset_profiler()
    reset_introspection()


@pytest.fixture(scope="module")
def bam_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("profbam") / "in.bam")
    with open(path, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS, synth_records(3000, seed=13)))
    return path


def _burn(seconds: float) -> int:
    t0 = time.perf_counter()
    x = 0
    while time.perf_counter() - t0 < seconds:
        x += 1
    return x


def _quiesce(timeout: float = 10.0) -> None:
    """Wait for the pool threads an earlier test left winding down (a
    pipeline's pools shut down without waiting), so the only threads of
    a pipeline role are the ones a test parks."""
    t0 = time.monotonic()
    while [t for t in threading.enumerate()
           if role_of(t.name) in ("fetch", "decode", "encode", "deflate",
                                  "stage")]:
        assert time.monotonic() - t0 < timeout, "pool threads still alive"
        time.sleep(0.01)


class _Parked:
    """Threads of the given names parked on an event, for sampling."""

    def __init__(self, names, target=None):
        self.go = threading.Event()
        self.ready = threading.Barrier(len(names) + 1)

        def park():
            self.ready.wait()
            (target or self.go.wait)()

        self.threads = [threading.Thread(target=park, name=n, daemon=True)
                        for n in names]

    def __enter__(self):
        _quiesce()
        for t in self.threads:
            t.start()
        self.ready.wait()
        return self

    def __exit__(self, *exc):
        self.go.set()
        for t in self.threads:
            t.join(5)


def test_role_table_maps_reference_names_like_reference():
    names = ["disq-fetch_0", "disq-decode_3", "disq-encode_1",
             "disq-deflate_0", "disq-stage_1", "disq-device-dispatch",
             "disq-hedge_0", "disq-hostwork_2", "disq-http-prefetch_0",
             "disq-watchdog", "disq-introspect", "disq-introspect-req",
             "disq-cluster", "disq-cluster-req", "disq-profiler",
             "MainThread", "Thread-7"]
    assert [role_of(n) for n in names] == \
        [ref_profiler.role_of(n) for n in names]
    assert role_of("Thread-7") == "other"


@pytest.mark.parametrize("name,role", [
    ("disq-torch-fetch_0", "fetch"), ("disq-torch-decode_3", "decode"),
    ("disq-torch-encode_1", "encode"), ("disq-torch-deflate_2", "deflate"),
    ("disq-torch-stage_0", "stage"), ("disq-torch-hostwork_5", "hostwork"),
    ("disq-slo", "slo"),
])
def test_port_thread_names_map_to_reference_roles(name, role):
    assert role_of(name) == role
    assert role in {r for _, r in ref_profiler.THREAD_ROLES} | {"slo"}


def test_zero_profiler_thread_when_off():
    tasks = [ShardTask(shard_id=i, fetch=lambda: 0, decode=lambda p: p)
             for i in range(16)]
    list(ShardPipelineExecutor(workers=4).map_ordered(tasks))
    assert profiler.active_profiler() is None
    assert not [t for t in threading.enumerate()
                if t.name.startswith("disq-profiler")]


def test_sample_counts_per_role_are_exact():
    names = ["disq-torch-fetch_0", "disq-torch-fetch_1",
             "disq-torch-decode_0", "Thread-x"]
    before = {r: counter("profile.samples").value(thread_role=r)
              for r in ("fetch", "decode", "other")}
    prof = SamplingProfiler(hz=100)
    samples = profiler.REGISTRY.counter("profile.samples")
    with _Parked(names):
        for _ in range(7):
            prof._sample_once(samples)
    by_role = prof.by_role()
    assert by_role["fetch"] == 14 and by_role["decode"] == 7
    assert by_role["other"] >= 7  # the parked Thread-x, and pytest's own
    for role, n in (("fetch", 14), ("decode", 7)):
        assert counter("profile.samples").value(thread_role=role) \
            - before[role] == n
    assert prof.samples == sum(by_role.values())


def test_a_burning_named_thread_is_sampled_under_its_role():
    prof = SamplingProfiler(hz=100)
    stop, running = threading.Event(), threading.Event()

    def burn():
        running.set()
        while not stop.is_set():
            _burn(0.001)

    with _Parked(["disq-torch-decode_0"], target=burn) as parked:
        assert running.wait(5)
        for _ in range(20):
            prof._sample_once()
        stop.set()
        parked.go.set()
    decode = {k: n for k, n in prof.folded().items()
              if k.startswith("decode;")}
    assert sum(decode.values()) == prof.by_role()["decode"] == 20
    assert all("test_torch_profiler.py:burn" in k for k in decode)


def _dropped_under(mod, monkeypatch, step, ticks):
    """``profile.dropped`` of a profiler whose each sampling sweep takes
    ``step`` intervals on an injected clock, stopped after ``ticks``."""
    now = [0.0]

    class Clock:
        @staticmethod
        def perf_counter():
            return now[0]

        sleep = staticmethod(time.sleep)

    monkeypatch.setattr(mod, "time", Clock)

    class Prof(mod.SamplingProfiler):
        def _sample_once(self, samples_counter=None):
            now[0] += step / self.hz
            self.samples += 1
            if self.samples >= ticks:
                self._stop.set()

    before = mod.REGISTRY.counter("profile.dropped").total()
    prof = Prof(hz=100)
    prof._run()
    return prof.dropped, mod.REGISTRY.counter("profile.dropped").total() \
        - before


@pytest.mark.parametrize("step,ticks", [(3.5, 6), (1.25, 9), (0.5, 5)])
def test_dropped_ticks_equal_reference(monkeypatch, step, ticks):
    got = _dropped_under(profiler, monkeypatch, step, ticks)
    want = _dropped_under(ref_profiler, monkeypatch, step, ticks)
    assert got == want
    assert got[0] == got[1]
    if step < 1:
        assert got[0] == 0


def test_collapsed_and_speedscope_formats():
    prof = SamplingProfiler(hz=100)
    with _Parked(["disq-torch-fetch_0", "disq-torch-decode_0"]):
        for _ in range(5):
            prof._sample_once()
    for key in prof.folded():
        assert re.match(r"^[a-z_]+(;[^;]+)+$", key), key
    for line in prof.collapsed().splitlines():
        assert re.match(r"^\S.* \d+$", line), line
    doc = prof.speedscope()
    assert doc["$schema"].endswith("file-format-schema.json")
    assert doc["exporter"] == "disq_tpu_torch.runtime.profiler"
    names = {p["name"] for p in doc["profiles"]}
    assert {"fetch", "decode"} <= names  # the sampling thread skips itself
    nframes = len(doc["shared"]["frames"])
    for p in doc["profiles"]:
        assert p["type"] == "sampled"
        assert len(p["samples"]) == len(p["weights"])
        assert p["endValue"] == sum(p["weights"])
        assert all(0 <= i < nframes for s in p["samples"] for i in s)


def test_profile_hz_option_starts_continuous_profiler(bam_file):
    P.ReadsStorage.make_default(device="cpu").split_size(32 * 1024) \
        .profile_hz(200).read(bam_file)
    active = profiler.active_profiler()
    assert active is not None and active.running
    assert [t for t in threading.enumerate() if t.name == "disq-profiler"]
    stopped = profiler.stop_profiler()
    assert stopped is active
    assert profiler.active_profiler() is None
    assert not [t for t in threading.enumerate()
                if t.name == "disq-profiler"]


def test_env_knob_starts_the_profiler(monkeypatch):
    monkeypatch.setenv("DISQ_TPU_TORCH_PROFILE_HZ", "150")
    profiler.configure_from_options(DisqOptions())
    active = profiler.active_profiler()
    assert active is not None and active.hz == 150.0
    profiler.stop_profiler()


def test_profile_for_window():
    prof = profiler.profile_for(0.2, hz=300)
    assert not prof.running
    assert prof.samples > 0
    assert prof.stopped_at is not None


def test_option_validation():
    with pytest.raises(ValueError):
        DisqOptions().with_profile(0)
    with pytest.raises(ValueError):
        SamplingProfiler(hz=-1)


def test_debug_profile_endpoint_collapsed_and_speedscope():
    addr = start_introspect_server(0)
    with urllib.request.urlopen(
            f"http://{addr}/debug/profile?seconds=0.3&hz=300",
            timeout=30) as resp:
        body = resp.read().decode()
    assert body.strip()
    for line in body.splitlines():
        assert re.match(r"^\S.* \d+$", line), line
    # no pipeline frame samples as ``other``
    assert not [ln for ln in body.splitlines() if ln.startswith("other;")
                and "executor.py" in ln]
    with urllib.request.urlopen(
            f"http://{addr}/debug/profile?seconds=0.2&hz=300"
            "&format=speedscope", timeout=30) as resp:
        doc = json.loads(resp.read())
    assert doc["profiles"]
    # the request thread itself is named: it samples as introspect
    assert "introspect" in {p["name"] for p in doc["profiles"]} or \
        "main" in {p["name"] for p in doc["profiles"]}


def test_cluster_collects_stacks_and_profiles():
    from disq_tpu_torch.runtime.cluster import ClusterAggregator

    addr = start_introspect_server(0)
    agg = ClusterAggregator([addr])
    stacks = agg.debug_stacks()
    assert stacks["cluster"] is True
    (pid, doc), = stacks["processes"].items()
    assert doc["ok"] and "MainThread" in doc["body"]
    merged = agg.debug_profile(seconds=0.3)
    assert merged.strip()
    for line in merged.splitlines():
        assert line.startswith(f"process={pid};"), line


def test_flame_renders_collapsed(tmp_path):
    prof = SamplingProfiler(hz=100)
    stop, running = threading.Event(), threading.Event()

    def burn():
        running.set()
        while not stop.is_set():
            _burn(0.001)

    with _Parked(["disq-torch-decode_0"], target=burn) as parked:
        assert running.wait(5)
        for _ in range(30):
            prof._sample_once()
        stop.set()
        parked.go.set()
    collapsed = tmp_path / "profile.collapsed"
    collapsed.write_text(prof.collapsed())
    proc = subprocess.run([sys.executable, TRACE_REPORT, str(collapsed),
                           "--flame", "--top", "3"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "flame:" in proc.stdout and "samples" in proc.stdout
    assert re.search(r"^  decode\b", proc.stdout, re.M), proc.stdout


def test_flame_empty_input(tmp_path):
    empty = tmp_path / "empty.collapsed"
    empty.write_text("")
    proc = subprocess.run([sys.executable, TRACE_REPORT, str(empty),
                           "--flame"], capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0
    assert "no samples" in proc.stdout
