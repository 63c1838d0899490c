"""The port's job bootstrap and global mesh
(``disq_tpu_torch/runtime/multihost.py``: ``initialize``,
``global_mesh``, ``_local_ordinals``), the counterpart of
``tests/test_multihost.py::TestGlobalMesh``.

One process gives a ``(1, n_local)`` mesh over its local devices (the
CPU repeated by ``DISQ_TPU_TORCH_FORCE_DEVICE_COUNT`` here). Two gloo
processes on 127.0.0.1 give a ``(2, 1)`` mesh whose ``dcn`` axis crosses
them: ``psum`` and ``all_to_all`` over it run on ``torch.distributed``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from disq_tpu_torch.runtime import mesh as M
from disq_tpu_torch.runtime.multihost import (
    _local_ordinals,
    global_mesh,
    initialize,
    process_count,
    process_id,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _eight(monkeypatch):
    for k in ("DISQ_TPU_TORCH_PROCESS_ID", "DISQ_TPU_TORCH_PROCESS_COUNT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv(M.FORCE_ENV, "8")


def test_single_process_shape_and_axes():
    mesh = global_mesh(device="cpu")
    assert mesh.axis_names == ("dcn", "shards")
    assert mesh.shape == {"dcn": 1, "shards": 8}
    assert np.asarray(mesh.devices).shape == (1, 8)
    assert set(mesh.devices.flat) == {torch.device("cpu")}
    assert not mesh.distributed and mesh.local_devices == \
        [torch.device("cpu")] * 8
    custom = global_mesh(dcn_axis="hosts", ici_axis="local", device="cpu")
    assert custom.axis_names == ("hosts", "local")
    assert custom.shape["hosts"] == 1


def test_local_ordinals_rank_each_process_by_id():
    class Dev:
        def __init__(self, pid, did):
            self.process_index = pid
            self.id = did

    devs = [Dev(1, 7), Dev(0, 5), Dev(1, 2), Dev(0, 9), Dev(0, 1)]
    ords = _local_ordinals(devs)
    assert ords[devs[4]] == 0 and ords[devs[1]] == 1 and ords[devs[3]] == 2
    assert ords[devs[2]] == 0 and ords[devs[0]] == 1


def test_ordinal_placement_with_a_process_count(monkeypatch):
    """Under a declared two-process job, row p holds the local devices in
    ordinal order and this process is row ``process_id()``."""
    monkeypatch.setenv(M.FORCE_ENV, "3")
    monkeypatch.setenv("DISQ_TPU_TORCH_PROCESS_COUNT", "2")
    monkeypatch.setenv("DISQ_TPU_TORCH_PROCESS_ID", "1")
    mesh = global_mesh(device="cpu")
    assert mesh.shape == {"dcn": 2, "shards": 3}
    assert mesh.process_index == 1 and mesh.distributed
    assert len(mesh.local_devices) == 3


def test_initialize_single_process_is_a_noop():
    initialize(num_processes=1)
    assert not torch.distributed.is_initialized()
    assert process_id() == 0 and process_count() == 1


def test_collective_over_both_axes():
    mesh = global_mesh(device="cpu")
    n = mesh.shape["dcn"] * mesh.shape["shards"]
    parts = [torch.ones(4) for _ in range(n)]
    inner = M.psum(parts, mesh, "shards")
    out = M.psum(inner, mesh, "dcn")
    assert all(torch.equal(o, torch.full((4,), float(n))) for o in out)


_WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist
from disq_tpu_torch.runtime import mesh as M
from disq_tpu_torch.runtime.multihost import global_mesh, initialize, process_id
from disq_tpu_torch.sort.sharded import hierarchical_coordinate_sort

rank = int(sys.argv[1])
initialize("127.0.0.1:{port}", num_processes=2, process_id=rank,
           device="cpu")
assert dist.get_backend() == "gloo" and process_id() == rank
mesh = global_mesh(device="cpu")
assert mesh.shape == {{"dcn": 2, "shards": 1}}, mesh.shape
assert mesh.distributed and mesh.process_index == rank
total = M.psum([torch.full((4,), float(rank + 1))], mesh, "dcn")
assert torch.equal(total[0], torch.full((4,), 3.0)), total
both = M.psum([torch.full((2,), float(rank + 1))], mesh, ("dcn", "shards"))
assert torch.equal(both[0], torch.full((2,), 3.0)), both
send = torch.arange(6, dtype=torch.int64).reshape(2, 3) + 100 * rank
recv = M.all_to_all([send], mesh, "dcn")[0]
want = torch.stack([torch.arange(3) + 3 * rank,
                    torch.arange(3) + 3 * rank + 100])
assert torch.equal(recv, want), recv
keys = np.random.default_rng(5).integers(0, 1 << 40, 3001, dtype=np.uint64)
got, perm = hierarchical_coordinate_sort(keys, mesh)
assert (perm == np.argsort(keys, kind="stable")).all()
assert (got == np.sort(keys)).all()
dist.destroy_process_group()
print("OK", rank)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_share_the_dcn_axis(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=REPO, port=_free_port()))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DISQ_TPU_TORCH_")}
    procs = [subprocess.Popen([sys.executable, str(script), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err
        assert f"OK {r}" in out
