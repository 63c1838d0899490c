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
  reference's roles, never ``other``;
- C-P4 widened (with C-P8): every module of the reference has its
  counterpart, which defines every public name, class member and
  parameter name of it but an explicit list of TPU-layout names;
- C-P7: ``DisqOptions`` has the reference's fields, and
  ``resident_decode`` by the options, the env knob or the storage's
  ``.resident_decode()`` takes the device route on the CPU;
- C-P8: the reference's public entry points the port lacked
  (``run_device_pipeline``, ``decode_container_records``,
  ``inflate_payloads_simd``, ``blocks_in_split``, the stage seconds of
  the executors, ``retries=``, ``split_size=``, ``as_array=``,
  ``to_columnar=`` …) equal the reference's on the same input;
- C-P10: a transient fault on any durable write of the single-file
  BAM and CRAM merge (header, terminator, concat, index) is retried
  under the parts' budget, as the reference's merge is, and the file
  equals a fault-free write's.
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


# The reference's names the port leaves out on purpose: the TPU's layout
# (128-lane chunks and their buckets, VMEM rings, u32 word blobs, the
# stacked (rows, 128) operands of the legacy rANS kernel, the dispatch
# window of chunk launches) and Pallas's interpret mode. The port's
# kernels take a whole split in one launch and parse bytes in place
# (ROADMAP.md, Intended differences). Nothing of the mesh is here.
TPU_ONLY_MODULES = {"ops.tpu_ci"}
TPU_LAYOUT_NAMES = {
    "ops.deflate": {"LANES", "bucket_for", "launch_chunk", "fetch_chunk",
                    "launch_resident", "release_chunk_arena"},
    "ops.inflate_simd": {"LANES", "RING_W", "RING_SAFE", "MAX_DEVICE_CSIZE",
                         "buckets_for", "dispatch_window"},
    "ops.rans_simd": {"MAX_DEVICE_CSIZE", "MAX_DEVICE_RAW",
                      "kernel_geometry", "pack_lane_tables"},
    "ops.rans": {"rans0_decode_stacked"},
    "runtime.device_pipeline": {"assemble_device_words", "upload_blob_words",
                                "pad_starts"},
    "runtime.device_write": {"BLOCK_WORDS"},
}
TPU_LAYOUT_PARAMS = {
    ("runtime.columnar", "ColumnarBatch.from_blob"): {"device_words"},
    ("runtime.device_pipeline", "gather_record_words"): {"blob_words"},
    ("runtime.device_pipeline", "parse_columns_resident"): {"blob",
                                                            "words_dev"},
    ("runtime.device_pipeline", "DevicePipelineResult.__init__"): {
        "hi", "lo", "hbm_bytes"},
    ("runtime.device_write", "EncodedShard.__init__"): {"words"},
}
# every function's ``interpret`` (Pallas's interpret mode)
TPU_LAYOUT_PARAM = "interpret"


def _reference_modules():
    out = []
    root = os.path.join(REPO, "disq_tpu")
    for base, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py") and f != "__init__.py":
                rel = os.path.relpath(os.path.join(base, f[:-3]), root)
                out.append(rel.replace(os.sep, "."))
    return sorted(out)


def _args(node) -> list:
    a = node.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _public_surface(path: str):
    """(functions → parameter names, classes → {member → parameter names
    or None}, constants) of a module's public top level."""
    tree = ast.parse(open(path).read())
    funcs, classes, consts = {}, {}, set()
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            funcs[node.name] = _args(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            members = {}
            for b in node.body:
                if isinstance(b, ast.FunctionDef) and (
                        not b.name.startswith("_") or b.name == "__init__"):
                    members[b.name] = _args(b)
                elif isinstance(b, ast.AnnAssign) and isinstance(
                        b.target, ast.Name) and not b.target.id.startswith("_"):
                    members[b.target.id] = None
                elif isinstance(b, ast.Assign):
                    members.update((t.id, None) for t in b.targets
                                   if isinstance(t, ast.Name)
                                   and not t.id.startswith("_"))
            classes[node.name] = members
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            consts.update(t.id for t in targets if isinstance(t, ast.Name)
                          and not t.id.startswith("_"))
    return funcs, classes, consts


def _params_of(obj):
    import inspect

    try:
        return set(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return None


_SHORT = {"serve": "runtime.serve", "fleet": "runtime.fleet"}
_MODULES = ["serve", "fleet"] + [m for m in _reference_modules()
                                 if m not in _SHORT.values()]


@pytest.mark.parametrize("module", _MODULES)
def test_cp4_plane_module_names_equal_reference(module):
    """Every module of the reference has its counterpart at the same path
    in the port, which defines every public function, class, constant
    and class member of it and takes every parameter name it takes, but
    the TPU-layout names listed above."""
    module = _SHORT.get(module, module)
    if module in TPU_ONLY_MODULES:
        assert not _port_has(f"disq_tpu.{module}")
        return
    funcs, classes, consts = _public_surface(
        os.path.join(REPO, "disq_tpu", *module.split(".")) + ".py")
    port = importlib.import_module(f"disq_tpu_torch.{module}")
    skip = TPU_LAYOUT_NAMES.get(module, set())
    missing = sorted(n for n in set(funcs) | set(classes) | consts
                     if n not in skip and not hasattr(port, n))

    def params_missing(where, obj, want):
        got = _params_of(obj)
        if got is None or want is None:
            return
        allowed = TPU_LAYOUT_PARAMS.get((module, where), set()) \
            | {TPU_LAYOUT_PARAM}
        lost = [p for p in want if p not in got and p not in allowed]
        if lost:
            missing.append(f"{where}({', '.join(lost)})")

    for name, want in funcs.items():
        if name not in skip and hasattr(port, name):
            params_missing(name, getattr(port, name), want)
    for cname, members in classes.items():
        cls = getattr(port, cname, None)
        if cls is None:
            continue
        fields = getattr(cls, "__dataclass_fields__", {})
        for m, want in members.items():
            if m == "__init__":
                params_missing(f"{cname}.__init__",
                               cls.__dict__.get("__init__", cls), want)
            elif not hasattr(cls, m) and m not in fields:
                missing.append(f"{cname}.{m}")
            elif hasattr(cls, m):
                params_missing(f"{cname}.{m}", getattr(cls, m), want)
    assert not missing, missing


def test_cp4_tpu_layout_names_are_absent_from_the_port():
    """The intended absences hold only names the port lacks."""
    present = [f"{m}.{n}" for m, names in TPU_LAYOUT_NAMES.items()
               for n in names
               if hasattr(importlib.import_module(f"disq_tpu_torch.{m}"), n)]
    assert not present, present


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


# -- C-P7 ---------------------------------------------------------------------

def test_cp7_disq_options_fields_equal_reference():
    import dataclasses

    from disq_tpu.runtime.errors import DisqOptions as RefOptions

    ours = {f.name for f in dataclasses.fields(P.DisqOptions)}
    theirs = {f.name for f in dataclasses.fields(RefOptions)}
    assert ours == theirs, (sorted(ours ^ theirs))
    opts = P.DisqOptions().with_resident_decode()
    assert opts.resident_decode and not opts.with_resident_decode(
        False).resident_decode


@pytest.mark.parametrize("how", ["options", "env", "method"])
def test_cp7_resident_decode_by_options_and_env(fixture_bam, monkeypatch,
                                                how):
    from disq_tpu_torch.runtime.columnar import resident_decode_enabled

    path, ref = fixture_bam
    monkeypatch.delenv("DISQ_TPU_TORCH_RESIDENT_DECODE", raising=False)
    st = P.ReadsStorage.make_default(device="cpu")
    assert not resident_decode_enabled(st)
    if how == "options":
        st = st.options(P.DisqOptions(resident_decode=True))
    elif how == "env":
        monkeypatch.setenv("DISQ_TPU_TORCH_RESIDENT_DECODE", "1")
    else:
        st = st.resident_decode()
        assert st._options.resident_decode
    assert resident_decode_enabled(st)
    got = st.read(path).reads
    assert isinstance(got, ColumnarBatch) and got.device_backed
    host = P.ReadsStorage.make_default(device="cpu").read(path).reads
    for f in ("refid", "pos", "mapq", "bin", "flag", "next_refid",
              "next_pos", "tlen", "names", "cigars", "seqs", "quals",
              "tags"):
        np.testing.assert_array_equal(getattr(got, f), getattr(host, f))
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(ref, f)))


# -- C-P8 ---------------------------------------------------------------------

def _record_blob(n=300, seed=3):
    from bam_oracle import encode_record

    blob = np.frombuffer(b"".join(encode_record(r) for r in synth_records(
        n, seed=seed, unmapped_tail=6)), np.uint8)
    return blob, scan_record_offsets(blob)


def test_cp8_run_device_pipeline_equals_reference():
    from disq_tpu.runtime.device_pipeline import \
        run_device_pipeline as ref_run
    from disq_tpu_torch.runtime import tracing
    from disq_tpu_torch.runtime.device_pipeline import (
        DevicePipelineResult, run_device_pipeline)

    blob, offsets = _record_blob()
    want_keys, want_order, want_stats = ref_run(blob, offsets,
                                                interpret=True)
    keys, order, stats = run_device_pipeline(blob, offsets, device="cpu")
    np.testing.assert_array_equal(keys, want_keys)
    np.testing.assert_array_equal(order, want_order)
    assert stats == want_stats
    lazy = run_device_pipeline(blob, offsets, device="cpu")
    assert isinstance(lazy, DevicePipelineResult)
    assert lazy.stats == want_stats
    before = tracing.REGISTRY.counter("device.d2h_avoided_bytes").total()
    lazy.release()
    assert tracing.REGISTRY.counter("device.d2h_avoided_bytes").total() \
        > before
    with pytest.raises(RuntimeError):
        lazy.order
    empty = run_device_pipeline(blob[:0], offsets[:1], device="cpu")
    assert empty.stats == ref_run(blob[:0], offsets[:1]).stats


def test_cp8_decode_container_records_equals_reference():
    from disq_tpu.bam.codec import decode_records as ref_decode
    from disq_tpu.cram.codec import (
        decode_container_records as ref_container, encode_container)
    from disq_tpu.cram.io import Cursor
    from disq_tpu.cram.structure import ContainerHeader
    from disq_tpu_torch.cram.codec import decode_container_records

    blob, offsets = _record_blob(120, seed=41)
    batch = ref_decode(blob.tobytes())
    one = batch.take(np.flatnonzero(np.asarray(batch.refid) == 0))
    data, _ = encode_container(one, 0, 0)
    cur = Cursor(data)
    ContainerHeader.read(cur)
    body = bytes(data[cur.off:])
    got, want = decode_container_records(body), ref_container(body)
    for f in ("refid", "pos", "flag", "names", "cigars", "seqs", "quals",
              "tags"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)))


def test_cp8_inflate_payloads_simd_family():
    import zlib

    from disq_tpu.ops.inflate_simd import assemble_blob as ref_assemble
    from disq_tpu_torch.ops.inflate_simd import (
        DeviceBlobHandle, assemble_blob, inflate_payloads_simd)

    def raw(b):
        c = zlib.compressobj(6, zlib.DEFLATED, -15, 8)
        return c.compress(b) + c.flush()

    rng = np.random.default_rng(8)
    datas = [rng.integers(65, 70, n, dtype=np.uint8).tobytes()
             for n in (0, 17, 3000, 20_000)]
    payloads = [raw(d) for d in datas]
    usizes = [len(d) for d in datas]
    assert inflate_payloads_simd(payloads, device="cpu") == datas
    assert inflate_payloads_simd(payloads, usizes, device="cpu") == datas
    blob, off = inflate_payloads_simd(payloads, usizes, as_array=True,
                                      device="cpu")
    want_blob, want_off = ref_assemble(datas)
    np.testing.assert_array_equal(blob, want_blob)
    np.testing.assert_array_equal(off, want_off)
    got = assemble_blob(datas)
    np.testing.assert_array_equal(got[0], want_blob)
    blob, off, handle = inflate_payloads_simd(
        payloads, usizes, as_array=True, keep_device=True, device="cpu")
    assert isinstance(handle, DeviceBlobHandle)
    assert handle.assemble().numpy().tobytes() == b"".join(datas)
    assert handle.assemble() is None  # released by the first
    with pytest.raises(ValueError, match="corrupt DEFLATE"):
        inflate_payloads_simd([b"\xff\xfe\xfd"], [10], device="cpu")


def test_cp8_columnar_build_counter_and_parse_fields(fixture_bam):
    from disq_tpu.runtime.columnar import PARSE_FIELDS as REF_FIELDS
    from disq_tpu_torch.ops.parse import _FIELD_ORDER
    from disq_tpu_torch.runtime.columnar import (
        PARSE_FIELDS, device_batches_built)

    assert PARSE_FIELDS == REF_FIELDS == _FIELD_ORDER
    before = device_batches_built()
    P.ReadsStorage.make_default(device="cpu").read(fixture_bam[0])
    assert device_batches_built() == before
    P.ReadsStorage.make_default(device="cpu").resident_decode() \
        .read(fixture_bam[0])
    assert device_batches_built() > before


def test_cp8_blocks_in_split_equals_reference(tmp_path):
    from disq_tpu.bgzf.guesser import BgzfBlockGuesser as RefGuesser
    from disq_tpu.fsw.filesystem import resolve_path as ref_resolve
    from disq_tpu_torch.bgzf.guesser import BgzfBlockGuesser
    from disq_tpu_torch.fsw.filesystem import resolve_path

    payload = np.random.default_rng(2).integers(0, 64, 300_000,
                                                dtype=np.uint8).tobytes()
    p = tmp_path / "f.bgz"
    p.write_bytes(codec.compress_to_bgzf(payload))
    size = p.stat().st_size
    ours = BgzfBlockGuesser(*resolve_path(str(p)))
    theirs = RefGuesser(*ref_resolve(str(p)))
    for lo, hi in ((0, size), (1, 5000), (4000, 90_000), (size - 3, size),
                   (size, size + 10)):
        got = [(b.pos, b.csize, b.usize) for b in ours.blocks_in_split(lo, hi)]
        want = [(b.pos, b.csize, b.usize)
                for b in theirs.blocks_in_split(lo, hi)]
        assert got == want, (lo, hi)


def test_cp8_executor_and_writer_stage_seconds(fixture_bam, tmp_path):
    from disq_tpu.runtime.executor import (
        ExecutorStats as RefExec, WriterStats as RefWriter)
    from disq_tpu_torch.runtime.executor import (
        ExecutorStats, ShardPipelineExecutor, ShardTask, ShardWritePipeline,
        WriterStats, WriteShardResult, WriteShardTask)

    assert ExecutorStats().as_dict().keys() == RefExec().as_dict().keys()
    assert WriterStats().as_dict().keys() == RefWriter().as_dict().keys()
    for workers in (1, 3):
        ex = ShardPipelineExecutor(workers=workers)
        tasks = [ShardTask(shard_id=i, fetch=lambda: sum(range(20_000)),
                           decode=lambda x: x + 1) for i in range(6)]
        res = list(ex.map_ordered(tasks))
        assert [r.value for r in res] == [sum(range(20_000)) + 1] * 6
        d = ex.stats.as_dict()
        assert d["shards"] == 6 and d["fetch_seconds"] > 0
        assert ex.stats.decode_seconds > 0
        pipe = ShardWritePipeline(workers=workers)
        wtasks = [WriteShardTask(shard_id=i, encode=lambda: b"x" * 100,
                                 deflate=lambda b: b[:10],
                                 stage=lambda b: len(b)) for i in range(5)]
        out = list(pipe.map_ordered(wtasks))
        assert all(isinstance(r, WriteShardResult) and r.value == 10
                   for r in out)
        assert all(r.wall_seconds >= r.encode_seconds > 0 for r in out)
        assert pipe.stats.stage_seconds > 0 and pipe.stats.as_dict()[
            "shards"] == 5


def test_cp8_write_stage_retries(tmp_path):
    from disq_tpu_torch.runtime.executor import (
        ShardWritePipeline, WriteShardTask, run_write_stage)
    from disq_tpu_torch.runtime.manifest import StageManifest

    def flaky_task(failures):
        left = {"n": failures}

        def stage(payload):
            if left["n"]:
                left["n"] -= 1
                raise OSError("transient")
            return payload

        return lambda k: WriteShardTask(shard_id=k, encode=lambda: k,
                                        stage=stage)

    def manifest(name):
        return StageManifest(str(tmp_path / name), {"run": name})

    assert run_write_stage(ShardWritePipeline(), 1, flaky_task(2),
                           manifest=manifest("a"), retries=2) == [0]
    with pytest.raises(RuntimeError):
        run_write_stage(ShardWritePipeline(), 1, flaky_task(2),
                        manifest=manifest("b"), retries=1)


def test_cp8_read_split_batches_reference_signature(fixture_bam):
    from disq_tpu_torch.bam.source import BamSource, read_header
    from disq_tpu_torch.fsw.filesystem import resolve_path

    path, ref = fixture_bam
    src = BamSource(P.ReadsStorage.make_default(device="cpu")
                    .split_size(2048))
    fs, p = resolve_path(path)
    header, fv = read_header(fs, p)
    whole = src.read_split_batches(fs, p, header, fv)
    small = src.read_split_batches(fs, p, header, fv, 512)
    assert len(small) > len(whole) >= 1
    for batches in (whole, small):
        got = np.concatenate([np.asarray(b.pos) for b in batches])
        np.testing.assert_array_equal(got, np.asarray(ref.pos))


def test_cp8_inflate_blocks_as_array_and_to_columnar(fixture_bam):
    from disq_tpu.bgzf.codec import inflate_blocks as ref_inflate
    from disq_tpu_torch.bgzf.codec import (
        inflate_blocks, inflate_blocks_device)
    from disq_tpu_torch.bgzf.guesser import find_block_table
    from disq_tpu_torch.fsw.filesystem import resolve_path

    path, ref = fixture_bam
    data = open(path, "rb").read()
    blocks = find_block_table(*resolve_path(path))
    want = ref_inflate(data, blocks)
    assert inflate_blocks(data, blocks, as_array=False) == want
    assert inflate_blocks(data, blocks).tobytes() == want
    blob, none = inflate_blocks(data, blocks, keep_device=True)
    assert none is None and blob.tobytes() == want
    dev = inflate_blocks_device(data, blocks, 0, "cpu", as_array=False)
    assert dev[0] == want and dev[1] is None
    raw = codec.decompress_bgzf(data)
    l_text = int.from_bytes(raw[4:8], "little")
    at = 8 + l_text
    n_ref = int.from_bytes(raw[at:at + 4], "little")
    at += 4
    for _ in range(n_ref):
        at += 4 + int.from_bytes(raw[at:at + 4], "little") + 4
    cb = inflate_blocks_device(data, blocks, 0, "cpu", to_columnar={
        "n_ref": n_ref, "lo_u": at, "end_u": len(want)})
    assert isinstance(cb, ColumnarBatch) and cb.device_backed
    np.testing.assert_array_equal(cb.pos, np.asarray(ref.pos))


def test_cp8_lesser_names_equal_reference(fixture_bam):
    from disq_tpu.ops import rans as ref_rans
    from disq_tpu_torch.ops import rans
    from disq_tpu_torch.ops.flagstat import flagstat_resident
    from disq_tpu_torch.runtime.device_write import ResidentShardEncoder

    assert (rans.RANS_LOW, rans.TF_SHIFT) == (ref_rans.RANS_LOW,
                                              ref_rans.TF_SHIFT)
    path, ref = fixture_bam
    ds = P.ReadsStorage.make_default(device="cpu").resident_decode() \
        .read(path)
    want = R.ReadsStorage.make_default().read(path).flagstat()
    flag = ds.reads.device_columns()["flag"]
    assert flagstat_resident(flag, ds.count()) == want
    enc = ResidentShardEncoder(ds.reads, "cpu")
    assert enc.count == ds.count() == 50


@pytest.mark.parametrize("fmt,target", [
    ("bam", "_header"), ("bam", "_terminator"), ("bam", "out.bam"),
    ("bam", ".bai"), ("bam", ".sbi"), ("cram", "_prefix"),
    ("cram", "_eof"), ("cram", "out.cram"), ("cram", ".crai")])
def test_cp10_merge_writes_retry_transient_faults(fixture_bam, tmp_path,
                                                  fmt, target):
    """Two transient faults on one merge write (``concat`` for the
    output's own name; the parts are staged in a directory of their own,
    so no part write matches): the reference's merge retries them, and so
    must the port's, writing the fault-free bytes."""
    from disq_tpu.fsw import FaultInjectingFileSystemWrapper as RefFaultFS
    from disq_tpu.fsw import FaultSpec as RefFaultSpec
    from disq_tpu.fsw import PosixFileSystemWrapper as RefPosix
    from disq_tpu.runtime.errors import DisqOptions as RefOptions
    from disq_tpu_torch.fsw import FaultSpec, PosixFileSystemWrapper

    path, _ = fixture_bam
    opts = (P.BaiWriteOption.ENABLE, P.SbiWriteOption.ENABLE) \
        if fmt == "bam" else (P.CraiWriteOption.ENABLE,)
    ref_opts = (R.BaiWriteOption.ENABLE, R.SbiWriteOption.ENABLE) \
        if fmt == "bam" else (R.CraiWriteOption.ENABLE,)
    exts = ("", ".bai", ".sbi") if fmt == "bam" else ("", ".crai")
    out = f"out.{fmt}"
    kw = {"sort": True} if fmt == "bam" else {}

    def spec(cls):
        return cls(kind="transient", op="write", path_substr=target,
                   probability=1.0, times=2)

    port_fs = FaultInjectingFileSystemWrapper(PosixFileSystemWrapper(),
                                              [spec(FaultSpec)])
    filesystem.register_filesystem("fault", port_fs)
    ref_fs.register_filesystem("fault", RefFaultFS(
        RefPosix(), [spec(RefFaultSpec)]))
    st = P.ReadsStorage.make_default(device="cpu").num_shards(2).options(
        P.DisqOptions(max_retries=4, retry_backoff_s=0.0))
    ds = st.read(path)
    st.write(ds, "fault://" + str(tmp_path / "port" / out), *opts,
             P.TempPartsDirectoryWriteOption(str(tmp_path / "port_parts")),
             **kw)
    assert [i.path for i in port_fs.injected] == \
        [port_fs.injected[0].path] * 2
    assert target in port_fs.injected[0].path
    assert "part-" not in port_fs.injected[0].path
    st.write(ds, str(tmp_path / "clean" / out), *opts, **kw)
    rst = R.ReadsStorage.make_default().num_shards(2).options(
        RefOptions(max_retries=4, retry_backoff_s=0.0))
    rst.write(rst.read(path), "fault://" + str(tmp_path / "ref" / out),
              *ref_opts,
              R.TempPartsDirectoryWriteOption(str(tmp_path / "ref_parts")),
              **kw)
    for ext in exts:
        got = open(tmp_path / "port" / (out + ext), "rb").read()
        assert got == open(tmp_path / "clean" / (out + ext), "rb").read()
        assert got == open(tmp_path / "ref" / (out + ext), "rb").read()
