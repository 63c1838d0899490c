"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use — when a CUDA tensor first reaches a kernel
wrapper, or when ``build()`` is called — never at import, so importing
the kernel modules on a machine without ``nvcc`` builds nothing. The
output goes to the package's git-ignored ``_build`` directory, named by
a digest of the source, every ``csrc`` header it includes and the
flags, so a stale library is never loaded.
A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# where the CUDA toolkit installs nvcc when it is not on PATH
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(NVCC_DEFAULT):
        return NVCC_DEFAULT
    raise RuntimeError("nvcc not found: cannot build the CUDA kernels")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and every header of ``csrc`` it includes with
    ``#include "..."``, directly or through another header, in the order
    first reached."""
    order, todo = [], [source_path(name)]
    while todo:
        path = todo.pop(0)
        if path in order:
            continue
        order.append(path)
        with open(path, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                todo.append(os.path.join(CSRC_DIR, inc.decode()))
    return order


def library_path(name: str) -> str:
    """Where kernel ``name``'s library is built: named by a digest of its
    sources (``sources``) and the flags."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names: Sequence[str]) -> Dict[str, float]:
    """Compile every named kernel library that is not built yet, all
    ``nvcc`` processes started together; returns the seconds each took
    (0.0 for one already built). Raises with the compiler's output when
    any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            seconds[name] = 0.0
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, target, time.perf_counter())
    errors = []
    for name, (proc, tmp, target, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{out.decode(errors='replace')}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, target)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
    return lib


def geometry(name: str, n: int) -> Dict[str, int]:
    """The launch geometry kernel ``name`` uses for ``n`` items, from its
    C entry ``disq_<name>_geometry``: threads per block, items
    (payloads or streams) per block, shared memory per block in bytes,
    and blocks."""
    fn = getattr(load(name), f"disq_{name}_geometry")
    fn.restype = None
    fn.argtypes = [ctypes.c_int64, ctypes.c_void_p]
    out = (ctypes.c_int64 * 4)()
    fn(n, ctypes.addressof(out))
    keys = ("threads_per_block", "items_per_block", "smem_bytes_per_block",
            "blocks")
    return dict(zip(keys, (int(v) for v in out)))


def check_launch(name: str, rc: int) -> None:
    """Raise when a kernel's C entry reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name!r} launch failed: "
                           f"cudaError {rc}")
