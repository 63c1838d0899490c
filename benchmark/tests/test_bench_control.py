"""The controls of ``correct`` at a small size on the CPU: each comes
out not correct, and the same path with the broken guarantee restored
comes out correct (so the failure is the broken guarantee's)."""

import numpy as np
import pytest

from benchmark import control

READS = 20_000


@pytest.mark.parametrize("cell", ["bam-sort-write"])
def test_control_is_not_correct(root, manifest, cell):
    res = control.run(root, cell, 2 ** 33 + 7, READS, manifest)
    assert not res["correct"], res
    assert max(c["value"] for c in res["checks"].values()) > 0


def test_sort_control_when_stable_is_correct(root, monkeypatch):
    real = np.argsort

    def argsort(a, kind=None, **kw):
        return real(a, kind="stable", **kw)

    monkeypatch.setattr(np, "argsort", argsort)
    assert control.run(root, "bam-sort-write", 5, READS)["correct"]
