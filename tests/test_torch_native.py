"""The port's host library is keyed by what built it.

``disq_tpu_torch/native`` names its ``_build/libdisq_host-<digest>.so``
by the source, the build variant's flags (with or without libdeflate),
the compiler and the host, so a library that another machine, compiler
or variant built is never loaded. The paths are digests: no build is
needed to check them.
"""

import os

import pytest

from disq_tpu_torch import native as N

FLAGS = N._FLAGS + N.VARIANTS[0]
COMPILER = "g++ (GCC) 13.2.0\nx86_64-linux-gnu"
HOST = "builder x86_64 Linux-6.1-x86_64-with-glibc2.39"


@pytest.fixture()
def source(tmp_path, monkeypatch):
    src = tmp_path / "disq_host.cpp"
    src.write_bytes(b"// the source\n")
    monkeypatch.setattr(N, "_SRC", str(src))
    return src


@pytest.mark.parametrize("part", ["source", "flags", "compiler", "host"])
def test_a_changed_key_gives_a_new_path(source, part):
    base = N.library_path(FLAGS, COMPILER, HOST)
    assert base == N.library_path(FLAGS, COMPILER, HOST)
    assert os.path.dirname(base) == N.BUILD_DIR
    assert os.path.basename(base).startswith("libdisq_host-")
    key = dict(flags=FLAGS, compiler=COMPILER, host=HOST)
    if part == "source":
        source.write_bytes(b"// the source, edited\n")
    elif part == "flags":
        key["flags"] = N._FLAGS + N.VARIANTS[1]
    elif part == "compiler":
        key["compiler"] = "clang version 17.0.6\nx86_64-linux-gnu"
    else:
        key["host"] = "card x86_64 Linux-5.15-x86_64-with-glibc2.35"
    assert N.library_path(key["flags"], key["compiler"], key["host"]) != base


def test_the_loaded_library_is_this_machines_build():
    try:
        lib = N._load()
    except ImportError as e:
        pytest.skip(f"no host toolchain here: {e}")
    want = {N.library_path(N._FLAGS + v, N.compiler_id(), N.host_id())
            for v in N.VARIANTS}
    assert lib._name in want
    # the old unkeyed name is never read
    assert not lib._name.endswith("libdisq_host.so")
