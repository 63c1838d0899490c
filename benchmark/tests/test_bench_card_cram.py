"""The cells that came with the CRAM configuration on the card for a short
window: ``correct`` and every end-to-end metric the manifest asks of
them. Run on a machine with an NVIDIA card: ``python -m pytest
benchmark/tests -m card``."""

import pytest

from benchmark.harness import core


@pytest.mark.card
@pytest.mark.parametrize("cell", ["cram-to-bam", "bam-sort-write-device"])
def test_cell_on_the_card(root, manifest, card, cell):
    res = core.run_cell(root, cell, 2 ** 31 + 99, 2.0, False,
                        manifest=manifest)
    assert res["correct"], res["checks"]
    assert {m["name"] for m in manifest.end_to_end(cell)} == \
        set(res["metrics"])
    assert res["device"]["platform"] == "gpu"
