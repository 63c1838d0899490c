"""The CRAM configuration's pieces on the CPU at small sizes: the
generator's vectorised rANS encoders against the plain decoder, the
``cram-to-bam`` cell run whole with its timed path broken (a decoder
that drops X, one that zeroes TLEN), its control, the new cells' sound
runs, and the new per-layer readers on recorded windows."""

import numpy as np
import pytest

from benchmark import control
from benchmark.generators import cram_htslib as G
from benchmark.harness import core
from benchmark.harness.core import Manifest, Measure
from benchmark.reference import cram as ref_cram

SMALL = {"cram-to-bam": {"reads": 20_000, "region_end": 100_000,
                         "split_size": 1 << 18},
         "bam-sort-write-device": {"reads": 20_000, "split_size": 1 << 20}}
SEED = 2 ** 31 + 4321


def _streams(rng):
    out = [bytes(range(1, 1 + n)) for n in range(1, 8)]
    out += [b"\x07" * 1000, bytes(range(256)) * 3,
            rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes(),
            rng.choice(np.array([2, 12, 23, 37], np.uint8), 50_003,
                       p=[0.02, 0.05, 0.08, 0.85]).tobytes(),
            (rng.geometric(0.3, 4097) % 256).astype(np.uint8).tobytes()]
    return out


@pytest.mark.parametrize("order", [0, 1])
def test_rans_encoders_round_trip_through_the_plain_decoder(order):
    """All streams coded in one call (lengths 1-50,003: one step loop
    per length group), each decoded alone by ``reference/cram.py``."""
    streams = _streams(np.random.default_rng(order))
    coded = G.rans_encode(streams, order)
    for raw, comp in zip(streams, coded):
        assert comp[0] == order
        assert ref_cram.rans(comp) == raw


def test_rans_streams_decode_in_the_program(monkeypatch):
    from disq_tpu_torch.cram import rans

    streams = _streams(np.random.default_rng(5))
    for order in (0, 1):
        for raw, comp in zip(streams, G.rans_encode(streams, order)):
            assert rans.rans_decode(comp) == raw


@pytest.fixture
def run(root, manifest):
    def go(cell):
        return core.run_cell(root, cell, SEED, 1.0, False, device="cpu",
                             config_overrides=SMALL[cell], manifest=manifest)
    return go


@pytest.mark.parametrize("cell", ["cram-to-bam", "bam-sort-write-device"])
def test_sound_run_is_correct(run, cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s", "write_rate",
                                   "write_size_ratio"}


def _drop_x(monkeypatch):
    """X features decode to the reference base (the matrix ignored)."""
    from disq_tpu_torch.cram import codec

    def table(sm):
        return np.repeat(np.frombuffer(b"ACGTN", np.uint8)[:, None], 4, 1)

    monkeypatch.setattr(codec, "substitution_table", table)


def _zero_tlen(monkeypatch):
    """Attached mates resolved, their TLEN then left at 0."""
    from disq_tpu_torch.cram import assemble

    real = assemble._mates

    def mates(ups, downs, n, refid, pos, end, flag, nref, npos, tlen):
        got = real(ups, downs, n, refid, pos, end, flag, nref, npos, tlen)
        tlen[:] = 0
        return got

    monkeypatch.setattr(assemble, "_mates", mates)


@pytest.mark.parametrize("fault", [_drop_x, _zero_tlen],
                         ids=["x_dropped", "tlen_zeroed"])
def test_broken_decode_is_not_correct(run, monkeypatch, fault):
    fault(monkeypatch)
    res = run("cram-to-bam")
    assert not res["correct"], res["checks"]
    assert res["checks"]["records_mismatched"]["value"] > 0


def test_cram_control_is_not_correct(root, manifest):
    res = control.run(root, "cram-to-bam", 2 ** 33 + 3, 20_000, manifest)
    assert not res["correct"], res
    assert res["checks"]["records_mismatched"]["value"] > 0


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_span_readers_per_million_records():
    man = Manifest(core.os.path.dirname(core.BENCH_DIR))
    spans = [{"name": n, "ts": 0.0, "dur": d} for n, d in (
        ("cram.rans0.batch", 0.5), ("cram.rans0.batch", 0.25),
        ("cram.rans1", 1.0), ("cram.records.assemble", 3.0),
        ("bam.write.deflate", 4.0))]
    m = Measure(spans=spans, facts={"records": 2_000_000})
    assert man.reader("rans0_batch_s.cram").read(m) == pytest.approx(0.375)
    assert man.reader("rans1_s.cram").read(m) == pytest.approx(0.5)
    assert man.reader("cram_assemble_s.cram").read(m) == pytest.approx(1.5)
    assert man.reader("deflate_s.cram").read(m) == pytest.approx(2.0)
    empty = Measure(facts={"records": 10})
    for name in ("rans0_batch_s.cram", "rans1_s.cram",
                 "cram_assemble_s.cram", "deflate_s.cram",
                 "device_idle.cram"):
        assert man.reader(name).read(empty) is None
    busy = Measure(events=[{}], window_s=50.0, busy_s=1.0)
    assert man.reader("device_idle.cram").read(busy) == pytest.approx(98.0)


@pytest.mark.parametrize("metric,kernel,launch,fact", [
    ("rans_roofline", "rans_simd_kernel(unsigned char const*)", "rans_simd",
     "rans0_bytes"),
    ("gather_roofline", "record_gather_kernel(unsigned char const*)",
     "record_gather", "gather_bytes"),
    ("device_deflate_roofline", "deflate_kernel(unsigned char const*)",
     "deflate", "deflate_bytes")])
def test_rooflines_count_bytes_per_job_against_the_kernels(metric, kernel,
                                                          launch, fact):
    man = Manifest(core.os.path.dirname(core.BENCH_DIR))
    events = [_ev(kernel, 0, 400), _ev(kernel, 1000, 600),
              _ev("inflate_kernel(x)", 2000, 100),
              _ev("Memcpy HtoD", 3000, 900, "gpu_memcpy")]
    m = Measure(events=events, launches={launch: 2},
                facts={"passes": 3, fact: 4_000_000})
    least = 3 * 4_000_000 / core.HBM_BYTES_PER_S
    assert man.reader(metric).read(m) == pytest.approx(100 * least / 1000e-6)
    off = Measure(events=events, launches={launch: 3},
                  facts={"passes": 3, fact: 4_000_000})
    assert man.reader(metric).read(off) is None and "left out" in off.notes[0]
    assert man.reader(metric).read(Measure(facts={"passes": 1})) is None
