"""The operator suite of the port (``ops/{rfilter,markdup,pileup,rgstats}``,
``runtime/oppipe.py``, ``ReadsStorage.read_filter``, ``ReadsDataset.
pipeline``) on the CPU, against ``disq_tpu`` and the record-at-a-time
oracles of ``tests/bam_oracle.py``, exactly (integers and bytes):

- the filter grammar and its eager validation; the FNV-1a name hashes
  from the blob and from the columns; ``host_mask`` and the plain
  version of kernel F1 against the reference's ``host_mask`` and its
  jitted ``_mask_kernel`` over a set of specs (no ``-s``, thresholds 0
  and 0xFFFFFFFF), with mates travelling together under ``-s``;
- reads with ``.read_filter(spec)`` on the resident and host routes:
  records and ``ds.counters`` equal to the reference's;
- markdup at 1 and 4 workers on both routes, the device group scan
  against the reference's host scan and jitted kernel, and the
  boundary seam; pileup and its region bound; rgstats and the untagged
  file;
- the resident chain ``filter → sort → markdup → rgstats``: the
  reference's stats, a written BAM byte-identical to the reference's,
  no host materialization, ``device.d2h_avoided_bytes`` grown, and the
  reference's ``ops.*`` counters;
- the new modules import neither ``jax`` nor ``disq_tpu``, build
  nothing at import, and F1 raises without ``nvcc``.
"""

import copy
import json
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from bam_oracle import (
    DEFAULT_REFS, make_bam_bytes, oracle_markdup, oracle_pileup,
    oracle_rgstats, parse_bam, synth_paired_records, synth_records)
import disq_tpu.api as R
from disq_tpu.ops import markdup as ref_markdup
from disq_tpu.ops import rfilter as ref_rfilter
from disq_tpu.runtime import tracing as ref_tracing
import disq_tpu_torch as P
from disq_tpu_torch.ops import cuda_build, markdup, rfilter
from disq_tpu_torch.runtime import tracing
from disq_tpu_torch.runtime.columnar import ColumnarBatch
from disq_tpu_torch.util import shutdown_shared_host_pool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("refid", "pos", "mapq", "bin", "flag", "next_refid", "next_pos",
          "tlen", "name_offsets", "names", "cigar_offsets", "cigars",
          "seq_offsets", "seqs", "quals", "tag_offsets", "tags")
OPS_COUNTERS = ("ops.filter.records_in", "ops.filter.records_kept",
                "ops.markdup.duplicates", "ops.markdup.boundary_flips",
                "ops.pileup.records")
PAIRED = synth_paired_records(120, seed=41)
ORACLE_DUPS = {
    (r.name, r.flag & ~0x400, r.refid, r.pos)
    for r, d in zip(PAIRED, oracle_markdup(PAIRED)) if d
}


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for t in (tracing, ref_tracing):
        t.stop_span_log()
        t.reset_telemetry()
    yield
    for t in (tracing, ref_tracing):
        t.stop_span_log()
        t.reset_telemetry()


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    yield
    shutdown_shared_host_pool()


@pytest.fixture(scope="module")
def paired_bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ops") / "paired.bam")
    with open(path, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS, PAIRED, blocksize=900))
    return path


def _port(resident=True, workers=1, split=6000):
    st = (P.ReadsStorage.make_default(device="cpu").split_size(split)
          .executor_workers(workers))
    return st.resident_decode() if resident else st


def _ref(workers=1, split=6000):
    return (R.ReadsStorage.make_default().split_size(split)
            .executor_workers(workers))


def _cols(batch):
    return {f: np.asarray(getattr(batch, f)) for f in FIELDS}


def _assert_same_records(got, want):
    a, b = _cols(got), _cols(want)
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        assert a[f].dtype == b[f].dtype, f


def _counts(ds):
    d = ds.counters.as_dict()
    del d["wall_seconds"]
    return d


def _marked_keys(batch):
    """{(name, flag sans 0x400, refid, pos)} of the records flagged
    0x400: a mate-safe identity to compare against the oracle."""
    flag = np.asarray(batch.flag)
    off = batch.name_offsets
    out = set()
    for i in np.nonzero(flag & 0x400)[0]:
        name = batch.names[off[i]: off[i + 1]].tobytes().decode()
        out.add((name, int(flag[i]) & ~0x400, int(batch.refid[i]),
                 int(batch.pos[i])))
    return out


def _ops_counters(registry):
    return {k: registry.counter(k).total() for k in OPS_COUNTERS}


# -- the grammar -------------------------------------------------------------

SPECS = ["-F 0x904 -q 20", "-f 0x1 -F 0x904 -q 30 -s 7.25", "-s 5.4",
         "-f 0x40 -q 30 -s 2.5", "-s 3.0", "-s 1.99999999999",
         "-F 0x400", "-q 0", ""]
BAD = ["-z 3", "-q", "-q x", "-s 3", "-s -1.5", "oops", "-f 0xZZ"]


@pytest.mark.parametrize("spec", SPECS)
def test_grammar_equals_reference(spec):
    got = rfilter.parse_read_filter(spec)
    want = ref_rfilter.parse_read_filter(spec)
    for f in ("require_flags", "exclude_flags", "min_mapq", "subsample",
              "seed", "threshold", "needs_name_hash"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("spec", BAD)
def test_grammar_rejects_what_the_reference_rejects(spec):
    with pytest.raises(ValueError):
        ref_rfilter.parse_read_filter(spec)
    with pytest.raises(ValueError):
        rfilter.parse_read_filter(spec)


def test_thresholds_at_their_edges():
    assert rfilter.parse_read_filter("-s 3.0").threshold == 0
    assert rfilter.parse_read_filter("-s 1.99999999999").threshold \
        == 0xFFFFFFFF
    assert rfilter.parse_read_filter("-q 5").threshold == 0xFFFFFFFF


def test_storage_options_validate_eagerly():
    from disq_tpu_torch.runtime.errors import DisqOptions

    with pytest.raises(ValueError):
        DisqOptions().with_read_filter("-q nope")
    with pytest.raises(ValueError):
        P.ReadsStorage.make_default(device="cpu").read_filter("-s 3")
    st = P.ReadsStorage.make_default(device="cpu").read_filter("-q 10")
    assert st._options.read_filter == "-q 10"


# -- hashes and masks ----------------------------------------------------------


def _blob_and_offsets(records):
    from bam_oracle import encode_record

    parts = [encode_record(r) for r in records]
    off = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=off[1:])
    return np.frombuffer(b"".join(parts), np.uint8), off


def test_name_hashes_equal_reference():
    recs = PAIRED + synth_records(50, seed=9)
    blob, off = _blob_and_offsets(recs)
    order = np.random.default_rng(3).permutation(len(recs))
    got = rfilter.name_hashes_from_blob(blob, off)
    np.testing.assert_array_equal(
        got, ref_rfilter.name_hashes_from_blob(blob, off))
    np.testing.assert_array_equal(
        rfilter.name_hashes_from_blob(blob, off, order), got[order])
    names = [r.name.encode() for r in recs]
    flat = np.frombuffer(b"".join(names), np.uint8)
    noff = np.zeros(len(names) + 1, np.int64)
    np.cumsum([len(x) for x in names], out=noff[1:])
    np.testing.assert_array_equal(
        rfilter.name_hashes_from_columns(flat, noff), got)
    np.testing.assert_array_equal(
        ref_rfilter.name_hashes_from_columns(flat, noff), got)


def _mask_inputs(n=4096, seed=5):
    rng = np.random.default_rng(seed)
    flag = rng.integers(0, 1 << 12, n).astype(np.int32)
    mapq = rng.integers(0, 256, n).astype(np.int32)
    nh = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    nh[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    return flag, mapq, nh


@pytest.mark.parametrize("spec", SPECS)
def test_masks_equal_reference(spec):
    """host_mask and F1's plain version against the reference's numpy
    mask and its jitted ``_mask_kernel`` (jax on the CPU)."""
    import jax.numpy as jnp

    flag, mapq, nh = _mask_inputs()
    rf = rfilter.parse_read_filter(spec)
    ref_rf = ref_rfilter.parse_read_filter(spec)
    want = ref_rfilter.host_mask(ref_rf, flag, mapq,
                                 nh if ref_rf.needs_name_hash else None)
    got = rfilter.host_mask(rf, flag, mapq,
                            nh if rf.needs_name_hash else None)
    np.testing.assert_array_equal(got, want)
    nh_dev = nh if rf.needs_name_hash else np.zeros_like(nh)
    scalars = [jnp.asarray(np.uint32(v)) for v in (
        ref_rf.require_flags, ref_rf.exclude_flags, ref_rf.min_mapq,
        (ref_rf.seed * ref_rfilter._SEED_MIX) & 0xFFFFFFFF,
        ref_rf.threshold)]
    kernel = np.asarray(ref_rfilter._mask_kernel()(
        jnp.asarray(flag), jnp.asarray(mapq), jnp.asarray(nh_dev),
        *scalars, jnp.asarray(np.int32(len(flag)))))
    plain = rfilter.build_mask(
        torch.from_numpy(flag), torch.from_numpy(mapq),
        torch.from_numpy(nh.view(np.int32)) if rf.needs_name_hash else None,
        rf.require_flags, rf.exclude_flags, rf.min_mapq, rf.seed_mix,
        rf.threshold)
    assert plain.dtype == torch.uint8
    np.testing.assert_array_equal(plain.numpy().astype(bool), kernel)
    np.testing.assert_array_equal(kernel, want)


def test_build_mask_checks_its_inputs():
    flag, mapq, nh = _mask_inputs(16)
    with pytest.raises(ValueError, match="mapq"):
        rfilter.build_mask(torch.from_numpy(flag),
                           torch.from_numpy(mapq.astype(np.int64)), None,
                           0, 0, 0, 0, 0xFFFFFFFF)
    with pytest.raises(ValueError, match="name_hash"):
        rfilter.build_mask(torch.from_numpy(flag), torch.from_numpy(mapq),
                           torch.from_numpy(nh[:8].view(np.int32)),
                           0, 0, 0, 0, 0xFFFFFFFF)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: F1's library cannot be had without nvcc, and the
    failure raises (a CUDA tensor reaches only the kernel)."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        rfilter._lib()
    assert cuda_build._libs == {}


# -- reads with a filter -------------------------------------------------------

READ_SPECS = ["-F 0x904 -q 20", "-s 5.4", "-f 0x40 -q 30 -s 2.5"]


@pytest.mark.parametrize("spec", READ_SPECS)
@pytest.mark.parametrize("resident", [False, True])
def test_filtered_read_equals_reference(paired_bam, spec, resident):
    got = _port(resident, split=3000).read_filter(spec).read(paired_bam)
    port_ops = _ops_counters(tracing.REGISTRY)
    want = _ref(split=3000).read_filter(spec).read(paired_bam)
    assert isinstance(got.reads, ColumnarBatch) == resident
    if resident:
        assert got.reads.device_backed
    assert 0 < got.count() < len(PAIRED)
    _assert_same_records(got.reads, want.reads)
    assert _counts(got) == _counts(want)
    assert port_ops == _ops_counters(ref_tracing.REGISTRY)


def test_subsample_keeps_mates_together(paired_bam):
    ds = _port(True).read_filter("-s 5.4").read(paired_bam)
    rb = ds.reads.to_read_batch()
    names = [rb.names[rb.name_offsets[i]: rb.name_offsets[i + 1]]
             .tobytes().decode() for i in range(rb.count)]
    by = Counter(n for n, f in zip(names, rb.flag) if f & 0x1)
    orig = Counter(r.name for r in PAIRED if r.flag & 0x1)
    for n in by:
        if n.startswith("p"):
            assert by[n] == orig[n], f"pair {n} was split by -s"


def test_env_knob_filters_the_read(paired_bam, monkeypatch):
    monkeypatch.setenv("DISQ_TPU_TORCH_READ_FILTER", "-q 30")
    got = _port(True).read(paired_bam)
    monkeypatch.delenv("DISQ_TPU_TORCH_READ_FILTER")
    want = _ref().read_filter("-q 30").read(paired_bam)
    _assert_same_records(got.reads, want.reads)


def test_resident_filter_compacts_on_the_device(paired_bam):
    mat = tracing.REGISTRY.counter("columnar.batch.materializations")
    m0 = mat.total()
    ds = _port(True).read_filter("-q 30").read(paired_bam)
    assert mat.total() == m0
    assert any(s["name"] == "columnar.batch.compact"
               for s in tracing.spans())
    assert any(s["name"] == "device.kernel"
               and s["labels"].get("kernel") == "read_filter"
               for s in tracing.spans())
    assert ds.count() == int((np.array([r.mapq for r in PAIRED]) >= 30)
                             .sum())


# -- markdup -------------------------------------------------------------------


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("resident", [False, True])
def test_markdup_equals_oracle_and_reference(paired_bam, workers, resident):
    ds = _port(resident, workers, split=3000).read(paired_bam)
    ds2, stats = ds.pipeline("markdup")
    ref2, ref_stats = _ref(workers, split=3000).read(
        paired_bam).pipeline("markdup")
    assert _marked_keys(ds2.reads) == ORACLE_DUPS == _marked_keys(ref2.reads)
    assert stats == ref_stats
    assert stats["markdup"]["duplicates"] == len(ORACLE_DUPS)
    assert isinstance(ds2.reads, ColumnarBatch) == resident


def _scan_inputs(n, seed):
    rng = np.random.default_rng(seed)
    refid = rng.integers(-1, 3, n)
    upos = rng.integers(-40, 30, n)          # unclipped upos below 0 too
    orient = rng.integers(0, 2, n).astype(np.int8)
    score = rng.integers(0, 6, n) * 100      # ties in score
    valid = (refid >= 0) & (rng.random(n) < 0.85)
    return refid, upos, orient, score, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_scan_equals_reference(seed):
    """The device scan (torch ops) against the reference's numpy scan
    and its jitted ``_markdup_kernel``, with many ties, excluded
    records and negative unclipped positions."""
    import jax.numpy as jnp

    refid, upos, orient, score, valid = _scan_inputs(3000, seed)
    want = ref_markdup._mark_dups_host(refid, upos, orient, score, valid)
    dup, examined, dups = markdup.group_scan(
        *(torch.from_numpy(np.asarray(a, np.int64))
          for a in (refid, upos, orient, score)), torch.from_numpy(valid))
    np.testing.assert_array_equal(dup.numpy(), want)
    np.testing.assert_array_equal(
        markdup._mark_dups_host(refid, upos, orient, score, valid), want)
    kdup, kex, kdups = ref_markdup._markdup_kernel()(
        jnp.asarray(refid.astype(np.int32)), jnp.asarray(upos.astype(np.int32)),
        jnp.asarray(orient.astype(np.int32)),
        jnp.asarray((-score).astype(np.int32)), jnp.asarray(valid),
        jnp.asarray(np.int32(len(refid))))
    np.testing.assert_array_equal(np.asarray(kdup), want)
    assert (int(examined), int(dups)) == (int(kex), int(kdups)) \
        == (int(valid.sum()), int(want.sum()))


def test_boundary_seam_resolves_exactly(paired_bam):
    """Shards cut inside clusters: per-shard markdup under-marks and
    the seam merge restores the global truth, as in the reference."""
    from disq_tpu.runtime.oppipe import OpPipeline as RefPipeline
    from disq_tpu_torch.runtime.oppipe import MarkdupOp, OpPipeline

    def shards(rb):
        # cut right before three duplicate copies ("d...a", at their
        # cluster's position), so each cut splits a cluster
        n = rb.count
        off = rb.name_offsets
        at = [i for i in range(n) if rb.names[off[i]] == ord("d")
              and rb.names[off[i + 1] - 1] == ord("a")]
        cuts = [0] + [at[len(at) * k // 4] for k in (1, 2, 3)] + [n]
        out = []
        for lo, hi in zip(cuts, cuts[1:]):
            m = np.zeros(n, bool)
            m[lo:hi] = True
            out.append(rb.filter(m))
        return out

    rb = _port(True, split=3000).read(paired_bam).reads.to_read_batch()
    res = OpPipeline(MarkdupOp()).run(shards(rb))
    ref_rb = _ref(split=3000).read(paired_bam).reads
    ref_res = RefPipeline("markdup").run(shards(ref_rb))
    got = set()
    for b in res.batches:
        got |= _marked_keys(b)
    assert got == ORACLE_DUPS
    assert res.stats == ref_res.stats
    assert res.stats["markdup"]["boundary_flips"] > 0
    for b, rb_ in zip(res.batches, ref_res.batches):
        np.testing.assert_array_equal(b.flag, rb_.flag)


# -- pileup and rgstats ----------------------------------------------------------


@pytest.mark.parametrize("region", [(0, 0, 20_000), (1, 500, 9_000)])
@pytest.mark.parametrize("resident", [False, True])
def test_pileup_equals_oracle_and_reference(paired_bam, resident, region):
    from disq_tpu.ops.pileup import region_pileup as ref_pileup
    from disq_tpu_torch.ops.pileup import region_pileup

    ds = _port(resident).read(paired_bam)
    got = region_pileup(ds.reads, *region, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, oracle_pileup(PAIRED, *region))
    np.testing.assert_array_equal(
        got, ref_pileup(_ref().read(paired_bam).reads, *region))


def test_pileup_region_bound(paired_bam):
    from disq_tpu_torch.ops.pileup import MAX_REGION_BP, region_pileup

    ds = _port(False).read(paired_bam)
    with pytest.raises(ValueError, match="bound"):
        region_pileup(ds.reads, 0, 0, MAX_REGION_BP + 1, device="cpu")
    assert region_pileup(ds.reads, 0, 10, 10, device="cpu").shape == (0,)


@pytest.mark.parametrize("resident", [False, True])
def test_rgstats_equals_oracle_and_reference(paired_bam, resident):
    from disq_tpu.ops.rgstats import read_group_stats as ref_stats
    from disq_tpu_torch.ops.rgstats import read_group_stats

    ds = _port(resident).read(paired_bam)
    got = read_group_stats(ds.reads)
    assert got == oracle_rgstats(PAIRED)
    assert got == ref_stats(_ref().read(paired_bam).reads)


def test_untagged_file_is_one_none_group(tmp_path):
    from disq_tpu_torch.ops.rgstats import read_group_stats

    recs = synth_records(40, seed=3)
    p = tmp_path / "plain.bam"
    p.write_bytes(make_bam_bytes(DEFAULT_REFS, recs))
    got = read_group_stats(_port(True).read(str(p)).reads)
    assert list(got) == ["(none)"]
    assert got == oracle_rgstats(recs)


# -- the resident chain --------------------------------------------------------

CHAIN = (("filter", "-F 0x800 -q 0"), "sort", "markdup", "rgstats")


def test_resident_chain_equals_reference(paired_bam, tmp_path):
    mat = tracing.REGISTRY.counter("columnar.batch.materializations")
    avoided = tracing.REGISTRY.counter("device.d2h_avoided_bytes")
    m0, a0 = mat.total(), avoided.total()
    res_ds, res_stats = _port(True, split=4000).read(paired_bam).pipeline(
        *CHAIN)
    assert isinstance(res_ds.reads, ColumnarBatch)
    assert res_ds.reads.device_backed
    assert res_ds.header.sort_order == "coordinate"
    # the resident chain never host-parsed a record, and the columns it
    # used on the device never crossed to the host
    assert mat.total() == m0
    assert avoided.total() > a0
    port_ops = _ops_counters(tracing.REGISTRY)
    ref_ds, ref_stats = _ref(split=4000).read(paired_bam).pipeline(*CHAIN)
    assert port_ops == _ops_counters(ref_tracing.REGISTRY)
    assert res_stats == ref_stats
    assert res_stats["markdup"]["duplicates"] > 0
    host_ds, host_stats = _port(False, split=4000).read(
        paired_bam).pipeline(*CHAIN)
    assert host_stats == res_stats
    outs = {}
    for name, st, ds in (
            ("res", P.ReadsStorage.make_default(device="cpu"), res_ds),
            ("host", P.ReadsStorage.make_default(device="cpu"), host_ds),
            ("ref", R.ReadsStorage.make_default(), ref_ds)):
        path = str(tmp_path / f"{name}.bam")
        st.num_shards(1).write(ds, path)
        outs[name] = open(path, "rb").read()
    assert outs["res"] == outs["ref"] == outs["host"]
    _text, _refs, recs = parse_bam(outs["res"])
    assert sum((r.flag >> 10) & 1 for r in recs) \
        == res_stats["markdup"]["duplicates"]
    res_ds.reads.release()


def test_chain_equals_composed_oracles(paired_bam):
    """The chained stats equal the oracles composed the same way:
    filter, then markdup over the kept records, then rgstats of the
    marked set; and pileup after them."""
    _ds, stats = _port(True, split=4000).read(paired_bam).pipeline(
        *CHAIN, ("pileup", 0, 0, 20_000))
    keep = [copy.deepcopy(r) for r in PAIRED if not (r.flag & 0x800)]
    keep.sort(key=lambda r: (r.refid if r.refid >= 0 else 1 << 30, r.pos))
    for r, d in zip(keep, oracle_markdup(keep)):
        if d:
            r.flag |= 0x400
    assert stats["rgstats"] == oracle_rgstats(keep)
    assert stats["markdup"]["duplicates"] == sum(
        (r.flag >> 10) & 1 for r in keep)
    np.testing.assert_array_equal(stats["pileup"]["coverage"],
                                  oracle_pileup(keep, 0, 0, 20_000))


def test_or_flags_patches_three_views(paired_bam):
    """or_flags changes the device column, the blob (copy-on-write for a
    permuted batch, whose blob is shared) and the host caches."""
    ds = _port(True).read(paired_bam)
    order = np.arange(ds.count())[::-1].copy()
    perm = ds.reads.permuted(order)
    before = np.asarray(ds.reads.flag).copy()
    flag0 = np.asarray(perm.flag).copy()
    mask = np.zeros(ds.count(), bool)
    mask[::3] = True
    perm.or_flags(mask, 0x400)
    want = np.where(mask, flag0 | 0x400, flag0)
    np.testing.assert_array_equal(perm.flag, want)
    np.testing.assert_array_equal(
        perm.device_columns()["flag"].numpy(), want)
    np.testing.assert_array_equal(perm.to_read_batch().flag, want)
    # the source batch's blob and columns are untouched
    np.testing.assert_array_equal(ds.reads.to_read_batch().flag, before)


# -- isolation -------------------------------------------------------------------

NEW_MODULES = ("disq_tpu_torch.ops.rfilter", "disq_tpu_torch.ops.markdup",
               "disq_tpu_torch.ops.pileup", "disq_tpu_torch.ops.rgstats",
               "disq_tpu_torch.runtime.oppipe")


def test_new_modules_import_no_jax_and_build_nothing(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path))
    code = (
        "import importlib, json, sys\n"
        f"for m in {NEW_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from disq_tpu_torch.ops import cuda_build\n"
        "assert not cuda_build._libs\n"
        "print(json.dumps(sorted(k for k in sys.modules if k == 'jax'\n"
        "    or k.startswith(('jax.', 'jaxlib', 'disq_tpu.'))\n"
        "    or k == 'disq_tpu')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
