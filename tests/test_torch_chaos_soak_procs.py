"""The subprocess legs of the port's chaos soak
(``scripts/torch_chaos_soak.py``), on the CPU: ``--kill`` (a writer
killed mid-run and resumed from its manifest, then a watchdog abort's
postmortem bundle), ``--steal`` (work stealing between two scheduled
processes), ``--coord-kill`` (the coordinator killed mid-pass and its
journal replayed by the survivors) and ``--fleet`` (a serving replica
killed behind the router). Each child process imports only
``disq_tpu_torch``. The other legs are in ``tests/test_torch_chaos_soak.py``.
"""

import importlib.util
import os

import pytest

from disq_tpu_torch.util import shutdown_shared_host_pool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_chaos_soak", os.path.join(REPO, "scripts", "torch_chaos_soak.py"))
soak = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(soak)


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    """Leave no idle pool threads behind for later tests in the process."""
    yield
    shutdown_shared_host_pool()


@pytest.mark.parametrize("leg", ["kill", "steal", "coord-kill", "fleet"])
def test_process_leg_passes_on_cpu(capsys, leg):
    rc = soak.main(["--device", "cpu", "--iterations", "1", "--records",
                    "200", "--seed", "7", f"--{leg}"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert f"[{leg}] ok" in out
    assert "0 mismatches in 1 iterations" in out
    assert soak.RESULTS["legs"][leg] > 0


@pytest.mark.parametrize("code", ["_ABORT_CHILD", "_STEAL_CHILD",
                                  "_KILL_CHILD", "_COORD_KILL_CHILD",
                                  "_FLEET_REPLICA_CODE"])
def test_child_code_imports_only_the_port(code):
    text = getattr(soak, code)
    assert "disq_tpu_torch" in text
    assert "JAX_PLATFORMS" not in text
    for line in text.splitlines():
        words = line.replace(",", " ").split()
        if words[:1] in (["import"], ["from"]):
            assert not any(w == "jax" or w.startswith(("jax.", "disq_tpu."))
                           or w == "disq_tpu" for w in words[1:2]), line
