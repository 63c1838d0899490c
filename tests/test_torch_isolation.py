"""The port stands alone: no JAX, nothing of ``disq_tpu``, no silent CPU.

- importing ``disq_tpu_torch`` (every module of it, the resilience and
  observability planes included) pulls in neither ``jax`` nor any
  ``disq_tpu`` module, and no source file of the port, ``chip_smoke.py``
  or the port's scripts (``scripts/torch_*.py``) names one in an import,
  nor starts a line with such an import in a string of child-process
  code;
- with no CUDA, an entry point that was not asked for the CPU raises;
- importing the kernel modules builds nothing, and a build without
  ``nvcc`` raises instead of falling back;
- ``chip_smoke.py`` fails, printing no result, without a card and when it
  stands alone in a directory.
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

import disq_tpu_torch as P
from disq_tpu_torch.ops import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "disq_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _run(code, env=None, cwd=REPO):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


PLANE_MODULES = ("multihost", "flightrec", "resilience", "profiler", "slo",
                 "introspect", "cluster", "scheduler", "serve", "fleet")


def _port_sources():
    out = [SMOKE] + [os.path.join(REPO, "scripts", f)
                     for f in os.listdir(os.path.join(REPO, "scripts"))
                     if f.startswith("torch_") and f.endswith(".py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module):
    return module == "jax" or module.startswith("jax.") or \
        module == "disq_tpu" or module.startswith("disq_tpu.")


def test_import_pulls_in_no_jax_and_no_reference():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import disq_tpu_torch\n"
        "for m in pkgutil.walk_packages(disq_tpu_torch.__path__,\n"
        "                               'disq_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(json.dumps(sorted(k for k in sys.modules if k == 'jax'\n"
        "    or k.startswith(('jax.', 'jaxlib', 'disq_tpu.'))\n"
        "    or k == 'disq_tpu')))\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("module", PLANE_MODULES)
def test_plane_module_imports_alone(module):
    """Each resilience and observability module imports in a fresh
    interpreter with neither ``jax`` nor ``disq_tpu`` loaded after it,
    and starts no thread."""
    code = (
        "import importlib, json, sys, threading\n"
        f"importlib.import_module('disq_tpu_torch.runtime.{module}')\n"
        "print(json.dumps([sorted(k for k in sys.modules if k == 'jax'\n"
        "    or k.startswith(('jax.', 'jaxlib', 'disq_tpu.'))\n"
        "    or k == 'disq_tpu'), threading.active_count()]))\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == [[], 1]
    assert os.path.join(PKG, "runtime", f"{module}.py") in _port_sources()


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_imports_jax_or_the_reference(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno)


IMPORT_LINE = re.compile(r"^\s*(from|import)\s+(jax|disq_tpu)(\.|\s|$)")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_line_imports_jax_or_the_reference(path):
    """The line-level twin of the AST check: it also sees the code of a
    child process held in a string literal (the chaos soak's children,
    ``chip_smoke.py``'s workers)."""
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            assert not IMPORT_LINE.match(line), (path, lineno, line)


def test_import_line_pattern_catches_child_code():
    for line in ("import jax", "    from disq_tpu import ReadsStorage",
                 "from disq_tpu.fsw import FaultSpec", "import jax.numpy",
                 "import disq_tpu"):
        assert IMPORT_LINE.match(line), line
    for line in ("import disq_tpu_torch", "from disq_tpu_torch import x",
                 "import jaxlib_free", "# import jax in a comment"):
        assert not IMPORT_LINE.match(line), line
    assert os.path.join(REPO, "scripts", "torch_chaos_soak.py") in \
        _port_sources()


@pytest.mark.parametrize("ext", ["bam", "cram"])
def test_entry_points_raise_without_cuda(monkeypatch, tmp_path, ext):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / f"x.{ext}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.ReadsStorage.make_default().read(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.ReadsStorage.make_default().device("cuda").write(None, path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.ReadsStorage.make_default().write(None, path,
                                            P.CraiWriteOption.ENABLE)


def test_cpu_is_taken_only_when_asked(monkeypatch, tmp_path):
    from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
    from disq_tpu_torch.util import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError):
        resolve_device(None)
    # the CRAM write and read run on the CPU when asked for it
    bam, cram = str(tmp_path / "x.bam"), str(tmp_path / "x.cram")
    with open(bam, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS, synth_records(50, seed=1)))
    st = P.ReadsStorage.make_default(device="cpu")
    st.write(st.read(bam), cram, P.CraiWriteOption.ENABLE)
    assert st.read(cram).count() == 50
    assert st.resident_decode().read(cram).count() == 50


def test_importing_kernel_modules_builds_nothing(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path))
    code = (
        "from disq_tpu_torch.ops import cuda_build, inflate_simd, parse\n"
        "from disq_tpu_torch.ops import inflate, rans, rans_simd\n"
        "from disq_tpu_torch.bam import source, sink\n"
        "from disq_tpu_torch.runtime import executor\n"
        "from disq_tpu_torch.runtime import device_pipeline, columnar\n"
        "from disq_tpu_torch.bgzf import codec\n"
        "from disq_tpu_torch.cram import rans, source, sink\n"
        "assert not cuda_build._libs\n")
    before = _kernel_libs()
    res = _run(code, env=env)
    assert res.returncode == 0, res.stderr
    assert _kernel_libs() == before


def _kernel_libs():
    if not os.path.isdir(cuda_build.BUILD_DIR):
        return set()
    return {f for f in os.listdir(cuda_build.BUILD_DIR)
            if f.startswith(("libinflate", "libparse", "librans"))}


@pytest.mark.parametrize("kernel", ["parse", "inflate_legacy"])
def test_build_without_nvcc_raises(monkeypatch, tmp_path, kernel):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load(kernel)
    assert cuda_build._libs == {}
    assert os.listdir(tmp_path / "build") == []


@pytest.mark.parametrize("header,users", [
    ("inflate_core.cuh", {"inflate", "inflate_legacy"}),
    ("rans_core.cuh", {"rans", "rans_simd"})])
def test_library_path_digests_the_headers_a_source_includes(
        monkeypatch, tmp_path, header, users):
    """An edit to a shared header renames the libraries of exactly the
    kernels that include it, so no stale library is loaded (on a copy of
    csrc/; the path is a digest, so no nvcc is needed)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    kernels = ("inflate", "inflate_legacy", "parse", "rans", "rans_simd")
    before = {k: cuda_build.library_path(k) for k in kernels}
    for k in users:
        assert str(csrc / header) in cuda_build.sources(k)
    with open(csrc / header, "a") as f:
        f.write("// an edit\n")
    after = {k: cuda_build.library_path(k) for k in kernels}
    assert {k for k in kernels if after[k] != before[k]} == users


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, SMOKE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
