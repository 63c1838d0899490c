"""The port's zero-overhead guard (``scripts/torch_check_overhead.py``),
the counterpart of ``tests/test_overhead.py``: with nothing armed, a
default read and write build no mesh and load no operator module, and
the per-shard hooks stay under their budgets. The script runs in a fresh
interpreter: it asserts on process-global state."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_check_overhead.py")
KNOBS = ("DISQ_TPU_TORCH_MESH", "DISQ_TPU_TORCH_FORCE_DEVICE_COUNT",
         "DISQ_TPU_TORCH_READ_FILTER", "DISQ_TPU_TORCH_RESIDENT_DECODE")


def _run(**extra):
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env.update(extra)
    return subprocess.run([sys.executable, SCRIPT], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)


def test_overhead_guard_passes():
    proc = _run()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK" in proc.stdout


def test_guard_fires_when_the_mesh_is_armed():
    """The mesh section is live: with the knob set and 4 devices the
    default read shards, and the guard names what moved."""
    proc = _run(DISQ_TPU_TORCH_MESH="4",
                DISQ_TPU_TORCH_FORCE_DEVICE_COUNT="4")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    out = proc.stdout
    assert "DISQ_TPU_TORCH_MESH leaked" in out
    assert "a default read's batch carries a mesh" in out
    assert "device.mesh.batches is nonzero" in out


def test_guard_fires_when_a_read_filter_is_armed():
    proc = _run(DISQ_TPU_TORCH_READ_FILTER="-q 1")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "operator modules imported" in proc.stdout
    assert "ops.filter.records_in is nonzero" in proc.stdout
