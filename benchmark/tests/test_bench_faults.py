"""A whole run of each cell on the CPU at a small size, the harness's
look for a card skipped, with the program's timed path broken
underneath: ``correct`` has to come out false for each fault the cell
can have, and true with nothing broken. One card only, so no exchange
between cards can be left out."""

import dataclasses

import numpy as np
import pytest

import disq_tpu_torch as port
from benchmark.harness import core

SMALL = {"reads": 20_000, "split_size": 1 << 20}
SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold


@pytest.fixture
def run(root, manifest):
    def go(cell):
        return core.run_cell(root, cell, SEED, 1.0, False, device="cpu",
                             config_overrides=SMALL, manifest=manifest)
    return go


def _host(ds):
    reads = ds.reads
    return reads.to_read_batch() if hasattr(reads, "to_read_batch") else reads


def _patch_read(monkeypatch, change):
    orig = port.ReadsStorage.read

    def read(self, path, traversal=None):
        ds = orig(self, path, traversal)
        return dataclasses.replace(ds, reads=change(_host(ds)))

    monkeypatch.setattr(port.ReadsStorage, "read", read)


def _half(rb):
    return rb.take(np.arange(rb.count // 2))


def _altered(rb):
    quals = rb.quals.copy()
    quals[7] ^= 1
    return dataclasses.replace(rb, quals=quals)


@pytest.mark.parametrize("cell", ["bam-sort-write"])
def test_sound_run_is_correct(run, cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", ["bam-sort-write"])
@pytest.mark.parametrize("fault", [_half, _altered],
                         ids=["half_left_out", "record_altered"])
def test_broken_read_is_not_correct(run, monkeypatch, cell, fault):
    _patch_read(monkeypatch, fault)
    res = run(cell)
    assert not res["correct"], res["checks"]
    assert res["checks"]["records_mismatched"]["value"] > 0


def test_sort_that_leaves_positions_unordered_is_not_correct(
        run, monkeypatch):
    """The sort step returns its records in their old order within each
    reference (the header still says coordinate)."""
    def coordinate_sorted(self, keep_resident=False):
        rb = _host(self)
        rid = np.where(rb.refid < 0, np.iinfo(np.int64).max,
                       rb.refid.astype(np.int64))
        return port.ReadsDataset(
            header=self.header.with_sort_order("coordinate"),
            reads=rb.take(np.argsort(rid, kind="stable")), device=self.device)

    monkeypatch.setattr(port.ReadsDataset, "coordinate_sorted",
                        coordinate_sorted)
    res = run("bam-sort-write")
    assert not res["correct"], res["checks"]
    assert res["checks"]["records_mismatched"]["value"] > 0


def test_record_altered_in_the_sort_is_not_correct(run, monkeypatch):
    orig = port.ReadsDataset.coordinate_sorted

    def coordinate_sorted(self, keep_resident=False):
        ds = orig(self, keep_resident)
        return dataclasses.replace(ds, reads=_altered(_host(ds)))

    monkeypatch.setattr(port.ReadsDataset, "coordinate_sorted",
                        coordinate_sorted)
    res = run("bam-sort-write")
    assert not res["correct"], res["checks"]
    assert res["checks"]["records_mismatched"]["value"] == 1


def _on_call(monkeypatch, cls, name, k, change):
    """``cls.name`` with its ``k``-th call (from 1) given ``change``."""
    orig = getattr(cls, name)
    calls = []

    def patched(self, *a, **kw):
        calls.append(1)
        if len(calls) == k:
            return change(orig, self, *a, **kw)
        return orig(self, *a, **kw)

    monkeypatch.setattr(cls, name, patched)
    return calls


def test_one_job_writing_half_its_records_is_not_correct(run, monkeypatch):
    """Only the window's first job is broken (half of its records left
    out of the write), whichever job the seed draws."""
    def change(orig, self, ds, path, *options, sort=False):
        half = dataclasses.replace(ds, reads=_half(_host(ds)))
        return orig(self, half, path, *options, sort=sort)

    calls = _on_call(monkeypatch, port.ReadsStorage, "write", 2, change)
    res = run("bam-sort-write")
    assert len(calls) > 2
    assert not res["correct"], res["checks"]
    assert res["checks"]["indexes_wrong_count"]["value"] == 1
