"""Faults of the port against the reference (``ROADMAP.md`` Queue C), each
held against ``disq_tpu`` on the same input, on the CPU:

- C-P3: the per-record accessors (``name``, ``sequence``,
  ``cigar_string``, ``qual_string``, ``reference_lengths``,
  ``alignment_ends``) of a host ``ReadBatch``, of a device-backed
  ``ColumnarBatch`` (resident read, and ``ColumnarBatch.from_blob``)
  equal the reference's for every record;
- C-P4: every name a reference package ``__init__`` exports from a
  module the port has is importable from the port at the same path (but
  the names listed with the slice that ports them), and importing every
  module of the port calls neither ``cuda_build.build`` nor ``load``;
- C-P5: ``is_directory``, ``first_file_in_directory``,
  ``_AtomicWriteFile.abort`` and ``BgzfWriter.compressed_bytes_written``
  behave as the reference's, and the fault injector's ``is_directory``
  works over the posix and the in-memory wrapper;
- C-P6: every thread the port starts, with every plane armed (hedged
  4-worker read, 4-worker write, watchdog, progress log, endpoint,
  profiler, SLO evaluator, cluster aggregator, remote read, device
  service, host pool), has a name the profiler books under one of the
  reference's roles, never ``other``.
"""

import ast
import importlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bam_oracle import make_bam_bytes, synth_records
import disq_tpu.api as R
from disq_tpu.bgzf import codec as ref_codec
from disq_tpu.fsw import filesystem as ref_fs
import disq_tpu_torch as P
from disq_tpu_torch.bam.codec import scan_record_offsets
from disq_tpu_torch.bgzf import codec
from disq_tpu_torch.fsw import filesystem
from disq_tpu_torch.fsw.faultfs import FaultInjectingFileSystemWrapper
from disq_tpu_torch.runtime.columnar import ColumnarBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFS = [("chr1", 100000), ("chr2", 50000)]


# -- C-P3 ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cp3") / "f.bam")
    with open(path, "wb") as f:
        f.write(make_bam_bytes(REFS, synth_records(50, REFS, seed=1)))
    ref = R.ReadsStorage.make_default().read(path).reads
    return path, ref


def _from_blob(path):
    """The file's records parsed into a device-backed ``ColumnarBatch``
    on the CPU, from the decoded blob past the header."""
    raw = codec.decompress_bgzf(open(path, "rb").read())
    l_text = int.from_bytes(raw[4:8], "little")
    at = 8 + l_text
    n_ref = int.from_bytes(raw[at:at + 4], "little")
    at += 4
    for _ in range(n_ref):
        at += 4 + int.from_bytes(raw[at:at + 4], "little") + 4
    blob = np.frombuffer(raw[at:], dtype=np.uint8).copy()
    offsets = scan_record_offsets(blob)
    return ColumnarBatch.from_blob(blob, offsets, torch.from_numpy(blob),
                                   n_ref=n_ref)


@pytest.mark.parametrize("route", ["host", "resident", "from_blob"])
def test_cp3_per_record_accessors_equal_reference(fixture_bam, route):
    path, ref = fixture_bam
    storage = P.ReadsStorage.make_default(device="cpu")
    if route == "host":
        got = storage.read(path).reads
        assert type(got).__name__ == "ReadBatch"
    elif route == "resident":
        got = storage.resident_decode().read(path).reads
        assert isinstance(got, ColumnarBatch) and got.device_backed
    else:
        got = _from_blob(path)
        assert got.device_backed
    assert got.count == ref.count == 50
    for i in range(ref.count):
        for acc in ("name", "sequence", "cigar_string", "qual_string"):
            assert getattr(got, acc)(i) == getattr(ref, acc)(i), (acc, i)
    np.testing.assert_array_equal(got.reference_lengths(),
                                  ref.reference_lengths())
    np.testing.assert_array_equal(got.alignment_ends(), ref.alignment_ends())


def test_cp3_absent_quality_is_a_star(fixture_bam):
    path, ref = fixture_bam
    got = P.ReadsStorage.make_default(device="cpu").read(path).reads
    absent = [i for i in range(ref.count)
              if ref.quals[ref.seq_offsets[i]:ref.seq_offsets[i + 1]][:1]
              .tolist() in ([], [0xFF])]
    assert absent, "the fixture holds a record without qualities"
    assert all(got.qual_string(i) == "*" for i in absent)


# -- C-P4 ---------------------------------------------------------------------

# names a reference ``__init__`` exports from a module the port has, that
# arrive with a later slice (ROADMAP.md Queue A): none left
DEFERRED = {}
PACKAGES = ("", "bgzf", "bam", "index", "fsw", "runtime", "sort", "ops",
            "traversal", "cram", "vcf", "sam")


def _port_has(module: str) -> bool:
    rel = module.replace("disq_tpu", "disq_tpu_torch", 1).replace(".", "/")
    return os.path.exists(os.path.join(REPO, rel + ".py")) or \
        os.path.exists(os.path.join(REPO, rel, "__init__.py"))


def _reference_exports(pkg: str):
    """(module, name) of every ``from disq_tpu... import name`` in the
    reference package's ``__init__``."""
    path = os.path.join(REPO, "disq_tpu", pkg, "__init__.py")
    tree = ast.parse(open(path).read())
    return [(node.module, a.name) for node in tree.body
            if isinstance(node, ast.ImportFrom)
            and node.module.startswith("disq_tpu") for a in node.names]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cp4_reference_exports_importable_at_same_path(pkg):
    port = importlib.import_module(
        "disq_tpu_torch" + (f".{pkg}" if pkg else ""))
    missing = [f"{mod}.{name}" for mod, name in _reference_exports(pkg)
               if _port_has(mod) and name not in DEFERRED
               and not hasattr(port, name)]
    assert not missing, missing
    if not pkg:
        assert P.__version__ == importlib.import_module("disq_tpu").__version__
        assert P.Interval is P.api.Interval


@pytest.mark.parametrize("module", ["serve", "fleet"])
def test_cp4_plane_module_names_equal_reference(module):
    """The serving plane and the fleet router define every public name
    (class, function, constant) of the reference's module."""
    path = os.path.join(REPO, "disq_tpu", "runtime", f"{module}.py")
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    port = importlib.import_module(f"disq_tpu_torch.runtime.{module}")
    missing = sorted(n for n in names
                     if not n.startswith("_") and not hasattr(port, n))
    assert not missing, missing


def test_cp4_deferred_names_are_still_absent():
    """The deferred list holds only names the port lacks, so a slice
    that ports one must take it off the list."""
    present = []
    for pkg in PACKAGES:
        port = importlib.import_module(
            "disq_tpu_torch" + (f".{pkg}" if pkg else ""))
        present += [n for n in DEFERRED if hasattr(port, n)]
    assert not present, present


def test_cp4_bgzf_decompress_equals_reference():
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 8, 200_000, dtype=np.uint8).tobytes()
    data = ref_codec.compress_to_bgzf(payload)
    assert codec.decompress_bgzf(data) == ref_codec.decompress_bgzf(data) \
        == payload
    assert codec.compress_to_bgzf(payload) == data


def test_cp4_parse_fixed_words_equal_reference():
    from disq_tpu.ops.parse import parse_fixed_words as ref_words

    from disq_tpu_torch.ops import parse_fixed_words, parse_fixed_words_pallas

    rng = np.random.default_rng(4)
    words = rng.integers(-2**31, 2**31, (64, 9), dtype=np.int64) \
        .astype(np.int32)
    want = {k: np.asarray(v) for k, v in ref_words(words).items()}
    for fn in (parse_fixed_words, parse_fixed_words_pallas):
        got = fn(torch.from_numpy(words))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_cp4_importing_every_module_builds_no_kernel():
    """In a fresh interpreter, ``cuda_build.build`` and ``load`` are
    replaced by recorders before anything of the port is imported; then
    every module of the package is imported."""
    code = (
        "import importlib, importlib.util, json, pkgutil, sys\n"
        f"path = {os.path.join(REPO, 'disq_tpu_torch', 'ops', 'cuda_build.py')!r}\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    'disq_tpu_torch.ops.cuda_build', path)\n"
        "cb = importlib.util.module_from_spec(spec)\n"
        "sys.modules[spec.name] = cb\n"
        "spec.loader.exec_module(cb)\n"
        "calls = []\n"
        "cb.build = lambda *a, **k: calls.append(('build', a))\n"
        "cb.load = lambda *a, **k: calls.append(('load', a))\n"
        "import disq_tpu_torch\n"
        "names = []\n"
        "for m in pkgutil.walk_packages(disq_tpu_torch.__path__,\n"
        "                               'disq_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    names.append(m.name)\n"
        "assert sys.modules['disq_tpu_torch.ops.cuda_build'] is cb\n"
        "print(json.dumps({'calls': [list(c) for c in calls],\n"
        "                  'modules': names}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["calls"] == []
    for pkg in PACKAGES[1:]:
        assert f"disq_tpu_torch.{pkg}" in out["modules"]
    assert "disq_tpu_torch.fsw.http" in out["modules"]
    assert "disq_tpu_torch.traversal.bai_query" in out["modules"]


# -- C-P5 ---------------------------------------------------------------------

def _mem_pair():
    pair = []
    for mod in (ref_fs, filesystem):
        fs = mod.MemoryFileSystemWrapper()
        for p in ("/d/a.bam", "/d/b.bai", "/d/.hidden", "/d/sub/c.bam",
                  "/top.bam"):
            fs.write_all(p, b"x")
        pair.append(fs)
    return pair


def _posix_tree(tmp_path):
    (tmp_path / "d" / "sub").mkdir(parents=True)
    for p in ("d/a.bam", "d/b.bai", "d/.hidden", "d/_tmp", "d/sub/c.bam",
              "top.bam"):
        (tmp_path / p).write_bytes(b"x")
    return str(tmp_path)


@pytest.mark.parametrize("kind", ["posix", "memory"])
def test_cp5_is_directory_and_first_file_equal_reference(kind, tmp_path):
    if kind == "posix":
        root = _posix_tree(tmp_path)
        ref, port = ref_fs.PosixFileSystemWrapper(), \
            filesystem.PosixFileSystemWrapper()
    else:
        root = ""
        ref, port = _mem_pair()
    paths = [root + p for p in ("/d", "/d/", "/d/sub", "/d/a.bam",
                                "/top.bam", "/nope", "/d/su")]
    for p in paths:
        assert port.is_directory(p) == ref.is_directory(p), p
        assert port.exists(p) == ref.exists(p), p
    for suffix in ("", ".bam", ".bai"):
        assert port.first_file_in_directory(root + "/d", suffix) == \
            ref.first_file_in_directory(root + "/d", suffix)
    for w in (ref, port):
        with pytest.raises(FileNotFoundError, match="suffix"):
            w.first_file_in_directory(root + "/d", ".cram")
    with pytest.raises(NotImplementedError):
        filesystem.FileSystemWrapper().is_directory("/")


@pytest.mark.parametrize("kind", ["posix", "memory"])
def test_cp5_fault_injector_is_directory(kind, tmp_path):
    if kind == "posix":
        root = _posix_tree(tmp_path)
        inner = filesystem.PosixFileSystemWrapper()
    else:
        root = ""
        inner = _mem_pair()[1]
    fsw = FaultInjectingFileSystemWrapper(inner, [], seed=1)
    assert fsw.is_directory("fault://" + root + "/d") is True
    assert fsw.is_directory("fault://" + root + "/d/a.bam") is False
    assert fsw.is_directory(root + "/nope") is False


def test_cp5_atomic_write_abort_publishes_nothing(tmp_path):
    for mod, name in ((ref_fs, "ref.bin"), (filesystem, "port.bin")):
        target = tmp_path / name
        f = mod.PosixFileSystemWrapper().create(str(target))
        f.write(b"partial bytes")
        f.abort()
        assert f.closed
        assert not target.exists()
        f.close()  # a second close after abort is a no-op
        assert not target.exists()
    assert os.listdir(tmp_path) == []  # no staged file left behind
    f = filesystem.PosixFileSystemWrapper().create(str(tmp_path / "ok.bin"))
    f.write(b"whole")
    f.close()
    assert (tmp_path / "ok.bin").read_bytes() == b"whole"


def test_cp5_bgzf_writer_compressed_bytes_written():
    rng = np.random.default_rng(5)
    chunks = [rng.integers(0, 4, int(n), dtype=np.uint8).tobytes()
              for n in rng.integers(1, 90_000, 12)]
    outs, seen = [], []
    for cls in (ref_codec.BgzfWriter, codec.BgzfWriter):
        buf = io.BytesIO()
        w = cls(buf)
        trace = [w.compressed_bytes_written]
        for c in chunks:
            w.write(c)
            trace.append(w.compressed_bytes_written)
            assert w.compressed_bytes_written == len(buf.getvalue())
        w.flush()
        trace.append(w.compressed_bytes_written)
        w.close()
        outs.append(buf.getvalue())
        seen.append(trace)
    assert seen[0] == seen[1]
    assert outs[0] == outs[1]


# -- C-P6 ---------------------------------------------------------------------


def test_cp6_every_port_thread_maps_to_a_reference_role(tmp_path,
                                                        monkeypatch):
    """The threads are recorded as they start and their names read at
    the end (a request thread renames itself once it runs)."""
    import threading
    import urllib.request

    import chip_smoke
    from disq_tpu.runtime.profiler import THREAD_ROLES as REF_ROLES
    from disq_tpu_torch.runtime import device_service, introspect, slo
    from disq_tpu_torch.runtime.cluster import ClusterAggregator
    from disq_tpu_torch.runtime.profiler import role_of, stop_profiler
    from disq_tpu_torch.runtime.resilience import reset_resilience
    from disq_tpu_torch.util import shared_host_pool, shutdown_shared_host_pool

    path = str(tmp_path / "in.bam")
    with open(path, "wb") as f:
        f.write(make_bam_bytes(REFS, synth_records(600, REFS, seed=6),
                               blocksize=600))
    srv = chip_smoke.range_server(str(tmp_path))
    monkeypatch.setattr(filesystem, "_SCHEME_REGISTRY",
                        dict(filesystem._SCHEME_REGISTRY))
    shutdown_shared_host_pool()
    started = []
    real_start = threading.Thread.start

    def recording_start(self):
        # the target goes when the thread ends: keep whose it was
        started.append((self, getattr(getattr(self, "_target", None),
                                      "__self__", None)))
        return real_start(self)

    monkeypatch.setattr(threading.Thread, "start", recording_start)
    try:
        storage = (P.ReadsStorage.make_default(device="cpu")
                   .split_size(8192).executor_workers(4).writer_workers(4)
                   .hedged_fetches(0.5, 0.0).watchdog(30.0)
                   .progress_log(str(tmp_path / "p.jsonl"))
                   .introspect_port(0).profile_hz(50))
        storage.options(storage._options.with_slo("*:500:95"))
        ds = storage.read(path)
        storage.num_shards(4).write(ds, str(tmp_path / "out.bam"))
        from disq_tpu_torch.fsw.http import HttpFileSystemWrapper

        # small blocks, so a read runs past the first and prefetches
        filesystem.register_filesystem("http",
                                       HttpFileSystemWrapper(block_size=4096))
        url = f"http://127.0.0.1:{srv.server_address[1]}/in.bam"
        assert storage.read(url).count() == ds.count()
        addr = ds.introspect_address()
        with urllib.request.urlopen(f"http://{addr}/healthz",
                                    timeout=10) as resp:
            resp.read()
        agg = ClusterAggregator([addr])
        agg_addr = agg.serve(0)
        with urllib.request.urlopen(f"http://{agg_addr}/healthz",
                                    timeout=10) as resp:
            resp.read()
        agg.close()
        monkeypatch.setenv("DISQ_TPU_TORCH_DEVICE_SERVICE", "1")
        P.ReadsStorage.make_default(device="cpu").resident_decode() \
            .read(path)
        shared_host_pool().submit(int).result()
    finally:
        monkeypatch.undo()
        device_service.shutdown_service()
        stop_profiler()
        slo.reset_slo()
        introspect.reset_introspection()
        reset_resilience()
        srv.shutdown()
        srv.server_close()
    ours = [t for t, owner in started if owner is not srv]
    names = sorted({t.name for t in ours})
    for prefix in ("disq-torch-fetch", "disq-torch-decode",
                   "disq-torch-encode", "disq-torch-deflate",
                   "disq-torch-stage", "disq-hedge", "disq-watchdog",
                   "disq-introspect", "disq-profiler", "disq-slo",
                   "disq-cluster", "disq-http-prefetch",
                   "disq-device-dispatch", "disq-torch-hostwork"):
        assert any(n.startswith(prefix) for n in names), (prefix, names)
    ref_roles = {role for _, role in REF_ROLES} | {"slo"}
    unmapped = [n for n in names if role_of(n) not in ref_roles
                or role_of(n) == "other"]
    assert not unmapped, unmapped
