"""The per-layer readers and the trace arithmetic against small
hand-built traces and span lists."""

import json

import pytest

from benchmark.harness import core
from benchmark.harness import trace as T
from benchmark.harness.core import Manifest, Measure


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_is_a_union_of_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 50)]
    assert T.union(iv, 0, 45) == [(0, 15), (20, 30), (40, 45)]
    assert sum(b - a for a, b in T.union(iv, 0, 100)) == 15 + 10 + 10
    m = Measure(events=[{}], window_s=100.0, busy_s=35.0)
    man = Manifest(core.os.path.dirname(core.BENCH_DIR))
    assert man.reader("device_idle.write").read(m) == pytest.approx(65.0)
    assert man.reader("device_idle.write").read(Measure()) is None


def _roofline(events, launches):
    man = Manifest(core.os.path.dirname(core.BENCH_DIR))
    m = Measure(events=events, launches=launches,
                facts={"passes": 3, "payload_bytes": 2_000_000,
                       "decoded_bytes": 5_000_000})
    return man.reader("inflate_roofline").read(m), m


def test_roofline_counts_each_byte_once_per_pass():
    name = "inflate_kernel(unsigned char const*, long const*)"
    events = [_ev(name, 0, 500), _ev(name, 1000, 1500),
              _ev("inflate_legacy_kernel(x)", 3000, 100),
              _ev("Memcpy DtoH", 4000, 900, "gpu_memcpy")]
    value, _ = _roofline(events, {"inflate": 2, "parse": 2})
    least = 3 * 7_000_000 / core.HBM_BYTES_PER_S
    assert value == pytest.approx(100 * least / 2000e-6)


def test_roofline_is_null_when_the_kernel_count_disagrees():
    events = [_ev("inflate_kernel(x)", 0, 500)]
    value, m = _roofline(events, {"inflate": 2})
    assert value is None and "left out" in m.notes[0]
    value, _ = _roofline([], {})
    assert value is None


def test_nested_inflate_spans_are_subtracted_once():
    spans = [
        {"name": "bam.split.decode", "ts": 0.0, "dur": 10.0},
        {"name": "bam.split.decode", "ts": 5.0, "dur": 10.0},   # overlaps
        {"name": "codec.inflate.batch", "ts": 1.0, "dur": 3.0},
        {"name": "codec.inflate.batch", "ts": 6.0, "dur": 3.0},  # in both
        {"name": "codec.inflate.batch", "ts": 20.0, "dur": 4.0},  # outside
    ]
    assert T.nested_sum(spans, "bam.split.decode",
                        "codec.inflate.batch") == 6.0
    man = Manifest(core.os.path.dirname(core.BENCH_DIR))
    m = Measure(spans=spans, facts={"records": 2_000_000})
    assert man.reader("record_decode_s.write").read(m) == \
        pytest.approx((20.0 - 6.0) / 2)
    assert man.reader("inflate_batch_s.write").read(m) == pytest.approx(5.0)
    assert man.reader("fetch_s.write").read(m) is None


def test_measure_reads_window_breakdown_and_gaps(tmp_path):
    """The first and last device events mark the window; the longest idle
    gaps are named by the innermost host span over their middle."""
    events = [_ev("fill (marker)", 1000, 1),
              _ev("inflate_kernel(x)", 2000, 1000),
              _ev("Memcpy DtoH", 2500, 1500, "gpu_memcpy"),
              _ev("parse_kernel(x)", 9000, 500),
              _ev("fill (marker)", 20000, 1),
              {"ph": "X", "cat": "cpu_op", "name": "aten::x", "ts": 0,
               "dur": 99999}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t_mark = 1.0           # host seconds at the first marker
    spans = [{"name": "bam.split.fetch", "ts": 1.0045, "dur": 0.004},
             {"name": "executor.fetch", "ts": 1.004, "dur": 0.005},
             {"name": "bam.split.decode", "ts": 1.0095, "dur": 0.0106}]
    m = core._measure(str(path), spans, {"inflate": 1}, {"inflate": 2}, {},
                      {"serve.cache.hits": 3.0}, t_mark, 0.019001,
                      {"records": 5})
    assert m.window_s == pytest.approx(19001e-6)
    assert m.busy_s == pytest.approx((2000 + 500) / 1e6)
    assert m.launches["inflate"] == 1 and m.counters["serve.cache.hits"] == 3
    gaps = m.facts["breakdown"]["idle_gaps"]
    assert gaps[0] == ["bam.split.decode", pytest.approx(10501e-6)]
    assert gaps[1] == ["bam.split.fetch", pytest.approx(5000e-6)]
    ops = dict(m.facts["breakdown"]["device_ops"])
    assert ops == {"Memcpy DtoH": pytest.approx(1500e-6),
                   "inflate_kernel(x)": pytest.approx(1000e-6),
                   "parse_kernel(x)": pytest.approx(500e-6)}
    assert len(m.facts["breakdown"]["idle_gaps"]) <= 10


def test_window_holds_without_the_end_marker(tmp_path):
    """A trace that lost its end marker still spans the host's window."""
    events = [_ev("fill (marker)", 1000, 1), _ev("inflate_kernel(x)", 2000, 500)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    m = core._measure(str(path), [], {}, {}, {}, {}, 0.0, 0.05, {})
    assert m.window_s == pytest.approx(0.05)
    assert m.busy_s == pytest.approx(500e-6)
