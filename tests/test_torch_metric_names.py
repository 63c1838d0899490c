"""The metric-name lint (``scripts/check_metrics.py``) over the port:
every metric and span name literal in ``disq_tpu_torch/`` follows the
dotted taxonomy and the README's metric tables (the main one and the
port's own, ``port-metrics``) list exactly the names the port books,
with no exclusion (the mesh's four ``device.mesh.*`` series
included)."""

import os

import pytest

from port_metric_tables import lint_module, read_both_tables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def lint(monkeypatch):
    cm = lint_module()
    monkeypatch.setattr(cm, "CODE_ROOT", os.path.join(REPO, "disq_tpu_torch"))
    read_both_tables(cm, monkeypatch)
    return cm


def test_port_metric_names_equal_the_readme_table(lint, capsys):
    assert lint.main() == 0, capsys.readouterr().out
    assert "OK" in capsys.readouterr().out


def test_port_books_the_four_mesh_series(lint):
    kinds, _sites = lint.scan_code()
    for name in ("device.mesh.batches", "device.mesh.devices",
                 "device.mesh.exchange_bytes", "device.mesh.reshard_bytes"):
        assert name in kinds, name
    assert kinds["device.mesh.devices"] == {"gauge"}


def test_lint_catches_an_undocumented_port_name(lint, tmp_path,
                                                monkeypatch, capsys):
    code = tmp_path / "disq_tpu_torch"
    code.mkdir()
    (code / "mod.py").write_text(
        "from disq_tpu_torch.runtime.tracing import counter\n"
        'counter("device.mesh.not_in_readme").inc()\n')
    (tmp_path / "README.md").write_text(
        "<!-- metrics:begin -->\n| `device.mesh.batches` |\n"
        "<!-- metrics:end -->\n")
    monkeypatch.setattr(lint, "CODE_ROOT", str(code))
    monkeypatch.setattr(lint, "README", str(tmp_path / "README.md"))
    assert lint.main() == 1
    assert "device.mesh.not_in_readme" in capsys.readouterr().out
