"""The port's write options on the CPU, held byte for byte against the JAX package.

Both packages read the same coordinate-sorted BAM (oracle records) and
write it with ``num_shards`` pinned on both sides:

- SBI + BAI + BAM at 1, 3 and 4 shards, writer workers 1 and 4;
- ``FileCardinalityWriteOption.MULTIPLE`` directories of BAM, of CRAM
  without a reference and of CRAM against a FASTA, part by part, each
  part re-read equal to its slice;
- ``TempPartsDirectoryWriteOption``: the parts are staged there;
- ``StageManifestWriteOption``: shard 2 of 4 fails, the manifest and the
  staged parts survive, the resume runs shards 2 and 3 only, the output
  is the reference's uninterrupted write and the manifest is gone; on
  the 4-worker pipeline, shards that staged while an earlier shard
  stalled stay recorded; a manifest whose target, records, digest,
  shard count, BAI or SBI differ starts afresh.
"""

import os

import numpy as np
import pytest

from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records
import disq_tpu.api as R
import disq_tpu_torch as P
from disq_tpu_torch.bam.sink import BamSink
from disq_tpu_torch.fsw.filesystem import PosixFileSystemWrapper
from disq_tpu_torch.runtime.manifest import StageManifest
from disq_tpu_torch.util import shutdown_shared_host_pool
from test_torch_cram import _assert_same_reads, _synth_ref_matched

N_RECORDS = 3000


@pytest.fixture(scope="module", autouse=True)
def _join_host_threads():
    """Leave no idle pool threads behind for later tests in the process."""
    yield
    shutdown_shared_host_pool()


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("wopt") / "in.bam")
    with open(path, "wb") as f:
        f.write(make_bam_bytes(
            DEFAULT_REFS, synth_records(N_RECORDS, seed=5, sorted_coord=True,
                                        unmapped_tail=4),
            sort_order="coordinate"))
    return path


def _port(shards, workers=1):
    return (P.ReadsStorage.make_default(device="cpu").num_shards(shards)
            .writer_workers(workers))


def _same_files(a, b, exts=("",)):
    for ext in exts:
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext


@pytest.fixture(scope="module")
def ref_indexed(src, tmp_path_factory):
    """The reference's BAM + BAI + SBI at each shard count."""
    d = tmp_path_factory.mktemp("ref_indexed")
    out = {}
    for shards in (1, 3, 4):
        st = R.ReadsStorage.make_default().num_shards(shards)
        out[shards] = str(d / f"ref{shards}.bam")
        st.write(st.read(src), out[shards], R.BaiWriteOption.ENABLE,
                 R.SbiWriteOption.ENABLE)
    return out


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("shards", [1, 3, 4])
def test_sbi_bai_bam_equal_reference(src, ref_indexed, tmp_path, shards,
                                     workers):
    st = _port(shards, workers)
    out = str(tmp_path / "port.bam")
    st.write(st.read(src), out, P.BaiWriteOption.ENABLE,
             P.SbiWriteOption.ENABLE)
    _same_files(out, ref_indexed[shards], ("", ".bai", ".sbi"))
    # the SBI plans the splits of a re-read: equal to the source
    back = _port(1).split_size(4096).read(out)
    _assert_same_reads(back.reads,
                       _port(1).read(src).reads)


def test_sbi_alone_equal_reference(src, ref_indexed, tmp_path):
    """SBI without BAI leaves the BAM bytes unchanged."""
    st = _port(3)
    out = str(tmp_path / "port.bam")
    st.write(st.read(src), out, P.SbiWriteOption.ENABLE)
    _same_files(out, ref_indexed[3], ("", ".sbi"))
    assert not os.path.exists(out + ".bai")


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """A FASTA (+ .fai) matching DEFAULT_REFS, as ``test_torch_cram``'s."""
    from disq_tpu_torch.cram.refsource import write_fasta

    rng = np.random.default_rng(99)
    contigs = [(name, rng.choice(list(b"ACGT"), size).astype(np.uint8)
                .tobytes()) for name, size in DEFAULT_REFS]
    path = str(tmp_path_factory.mktemp("ref") / "ref.fa")
    write_fasta(PosixFileSystemWrapper(), path, contigs)
    return path, dict(contigs)


@pytest.fixture(scope="module")
def cram_src(fasta, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cram_src") / "in.bam")
    with open(path, "wb") as f:
        f.write(make_bam_bytes(DEFAULT_REFS, _synth_ref_matched(fasta[1]),
                               sort_order="coordinate"))
    return path


@pytest.mark.parametrize("fmt,with_ref", [("bam", False), ("cram", False),
                                          ("cram", True)])
def test_multiple_equal_reference_part_by_part(src, cram_src, fasta, tmp_path,
                                               fmt, with_ref):
    source = cram_src if fmt == "cram" else src
    ref = fasta[0] if with_ref else None
    rst = R.ReadsStorage.make_default().num_shards(3)
    pst = _port(3)
    if ref:
        rst, pst = rst.reference_source_path(ref), pst.reference_source_path(ref)
    rdir, pdir = str(tmp_path / "ref"), str(tmp_path / "port")
    rst.write(rst.read(source), rdir, R.FileCardinalityWriteOption.MULTIPLE,
              R.ReadsFormatWriteOption[fmt.upper()])
    ds = pst.read(source)
    pst.write(ds, pdir, P.FileCardinalityWriteOption.MULTIPLE,
              P.ReadsFormatWriteOption[fmt.upper()])
    parts = sorted(os.listdir(rdir))
    assert parts == sorted(os.listdir(pdir))
    assert parts == [f"part-r-{k:05d}.{fmt}" for k in range(3)]
    bounds = np.linspace(0, ds.count(), 4).astype(np.int64)
    for k, name in enumerate(parts):
        _same_files(os.path.join(pdir, name), os.path.join(rdir, name))
        back = pst.read(os.path.join(pdir, name)).reads
        want = ds.reads.slice(int(bounds[k]), int(bounds[k + 1]))
        if fmt == "cram":
            # CRAM stores no bin: its reader computes it, as the
            # reference's does
            _assert_same_reads(back, rst.read(os.path.join(rdir, name)).reads)
            want.bin = back.bin
        _assert_same_reads(back, want)


@pytest.mark.parametrize("fmt", ["bam", "cram"])
def test_temp_parts_directory_honoured(src, tmp_path, monkeypatch, fmt):
    staged = []
    inner = PosixFileSystemWrapper.write_all

    def recording(self, path, data):
        staged.append(path)
        return inner(self, path, data)

    monkeypatch.setattr(PosixFileSystemWrapper, "write_all", recording)
    stage = str(tmp_path / "staging")
    out = str(tmp_path / f"out.{fmt}")
    st = _port(3)
    st.write(st.read(src), out, P.TempPartsDirectoryWriteOption(stage))
    parts = [p for p in staged if os.path.basename(p).startswith("part-")]
    assert sorted(parts) == [os.path.join(stage, f"part-{k:05d}")
                             for k in range(3)]
    assert not os.path.exists(stage) and not os.path.exists(out + ".parts")
    rst = R.ReadsStorage.make_default().num_shards(3)
    ref_out = str(tmp_path / f"ref.{fmt}")
    rst.write(rst.read(src), ref_out)
    _same_files(out, ref_out)


# -- resume from a stage manifest --------------------------------------------


_ENCODE_SHARD = BamSink._encode_shard


def _sabotage(monkeypatch, fail_at, ran=None):
    """Make ``BamSink._encode_shard`` raise on shard ``fail_at`` and log
    the shards it runs."""
    orig = _ENCODE_SHARD

    def wrapped(self, batch, bounds, k):
        if ran is not None:
            ran.append(k)
        if k == fail_at:
            raise IOError("injected")
        return orig(self, batch, bounds, k)

    monkeypatch.setattr(BamSink, "_encode_shard", wrapped)


@pytest.fixture(scope="module")
def ref_clean(src, tmp_path_factory):
    st = R.ReadsStorage.make_default().num_shards(4)
    out = str(tmp_path_factory.mktemp("ref_clean") / "clean.bam")
    st.write(st.read(src), out, R.BaiWriteOption.ENABLE,
             R.SbiWriteOption.ENABLE)
    return out


@pytest.mark.parametrize("workers", [1, 4])
def test_write_resumes_from_manifest(src, ref_clean, tmp_path, monkeypatch,
                                     workers):
    """Shard 2 fails at every attempt: the write raises naming it, and
    the resume runs exactly the shards not recorded. In order (one
    worker) that is shards 2 and 3; with four, shard 3 may have staged
    before the failure surfaced, and then it is kept."""
    st = _port(4, workers=workers)
    ds = st.read(src)
    out, mpath = str(tmp_path / "out.bam"), str(tmp_path / "write.manifest")
    opts = (P.StageManifestWriteOption(mpath), P.BaiWriteOption.ENABLE,
            P.SbiWriteOption.ENABLE)
    _sabotage(monkeypatch, 2)
    with pytest.raises(RuntimeError, match="shard 2") as crash:
        st.write(ds, out, *opts)
    assert "injected" in str(crash.value.__cause__)
    assert os.path.exists(mpath)
    assert os.path.exists(out + ".parts/part-00000")
    assert os.path.exists(out + ".parts/part-00001.sbi-frag")
    done = StageManifest(mpath).completed_shards("bam.parts")
    assert done[:2] == [0, 1] and 2 not in done
    if workers == 1:
        assert done == [0, 1]

    ran = []
    _sabotage(monkeypatch, None, ran)
    st.write(ds, out, *opts)
    assert sorted(ran) == [k for k in range(4) if k not in done]
    assert not os.path.exists(mpath)
    assert not os.path.exists(out + ".parts")
    _same_files(out, ref_clean, ("", ".bai", ".sbi"))


def test_pipeline_keeps_shards_staged_past_a_straggler(src, ref_clean,
                                                       tmp_path, monkeypatch):
    """writer_workers(4): shard 0 stalls in its stage step until shards
    1-3 are recorded, then fails; the resume re-runs shard 0 alone."""
    import time

    st = _port(4, workers=4)
    ds = st.read(src)
    out, mpath = str(tmp_path / "out.bam"), str(tmp_path / "write.manifest")
    opts = (P.StageManifestWriteOption(mpath), P.BaiWriteOption.ENABLE,
            P.SbiWriteOption.ENABLE)
    orig_stage, orig_encode = BamSink._stage_shard, BamSink._encode_shard

    def straggler(self, fs, temp_dir, k, frag_cache, payload):
        if k == 0:
            deadline = time.monotonic() + 30
            while (StageManifest(mpath).completed_shards("bam.parts")
                   != [1, 2, 3] and time.monotonic() < deadline):
                time.sleep(0.01)
            raise IOError("straggler died")
        return orig_stage(self, fs, temp_dir, k, frag_cache, payload)

    monkeypatch.setattr(BamSink, "_stage_shard", straggler)
    with pytest.raises(RuntimeError, match="shard 0") as crash:
        st.write(ds, out, *opts)
    assert "straggler died" in str(crash.value.__cause__)
    assert StageManifest(mpath).completed_shards("bam.parts") == [1, 2, 3]

    ran = []

    def counting(self, batch, bounds, k):
        ran.append(k)
        return orig_encode(self, batch, bounds, k)

    monkeypatch.setattr(BamSink, "_stage_shard", orig_stage)
    monkeypatch.setattr(BamSink, "_encode_shard", counting)
    st.write(ds, out, *opts)
    assert ran == [0]
    assert not os.path.exists(mpath)
    _same_files(out, ref_clean, ("", ".bai", ".sbi"))


def _changed(ds, change):
    """The dataset, options, target and shard count of a resumed write
    that differs from the crashed one in ``change``."""
    reads = ds.reads
    if change == "records":
        reads = reads.slice(0, reads.count - 1)
    elif change == "digest":
        reads = reads.slice(0, reads.count)
        reads.mapq[5] ^= 1
    opts = [P.BaiWriteOption.ENABLE, P.SbiWriteOption.ENABLE]
    if change == "bai":
        opts = opts[1:]
    elif change == "sbi":
        opts = opts[:1]
    return (P.ReadsDataset(ds.header, reads), opts,
            "other.bam" if change == "target" else "out.bam",
            3 if change == "n_shards" else 4)


@pytest.mark.parametrize("change", ["target", "records", "digest",
                                    "n_shards", "bai", "sbi"])
def test_changed_params_reset_the_manifest(src, tmp_path, monkeypatch,
                                           change):
    ds = _port(4).read(src)
    mpath = str(tmp_path / "write.manifest")
    _sabotage(monkeypatch, 2)
    with pytest.raises(RuntimeError, match="shard 2"):
        _port(4).write(ds, str(tmp_path / "out.bam"),
                       P.StageManifestWriteOption(mpath),
                       P.BaiWriteOption.ENABLE, P.SbiWriteOption.ENABLE)

    ds2, opts, target, shards = _changed(ds, change)
    ran = []
    _sabotage(monkeypatch, None, ran)
    out = str(tmp_path / target)
    _port(shards).write(ds2, out, P.StageManifestWriteOption(mpath), *opts)
    assert ran == list(range(shards))
    assert not os.path.exists(mpath)

    # the reference's clean write of the same dataset and options
    ref_out = str(tmp_path / "ref.bam")
    rst = R.ReadsStorage.make_default().num_shards(shards)
    rds = rst.read(src)
    if change in ("records", "digest"):
        rds = R.ReadsDataset(rds.header, rds.reads.slice(0, ds2.count()))
        if change == "digest":
            rds.reads.mapq[5] ^= 1
    ref_opts = [getattr(R, type(o).__name__).ENABLE for o in opts]
    rst.write(rds, ref_out, *ref_opts)
    exts = [""] + [".bai"] * (P.BaiWriteOption.ENABLE in opts) \
        + [".sbi"] * (P.SbiWriteOption.ENABLE in opts)
    _same_files(out, ref_out, exts)
