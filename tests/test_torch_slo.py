"""The port's per-tenant SLOs (``disq_tpu_torch/runtime/slo.py``) against
``disq_tpu``'s, on the CPU.

The non-serving cases of ``tests/test_tracing_slo.py``: the spec grammar
(the same objectives and the same refusals as the reference's parser),
the burn rates over the same ``serve.request`` histogram samples and
``serve.request.errors`` counts fed to both packages' registries under
the same injected clock (the evaluators' documents equal, exactly), the
structurally-off default, ``/healthz`` degrading on a fast burn, the
``/slo`` endpoint, the ``DisqOptions.slo`` and ``DISQ_TPU_TORCH_SLO``
knobs, and the trace context's stamp on spans and flight-recorder
events. The serving plane that books those series is not ported yet, so
the tests feed the histogram directly.
"""

import json
import threading
import urllib.request

import pytest

from disq_tpu.runtime import slo as ref_slo
from disq_tpu.runtime import tracing as ref_tracing
import disq_tpu_torch as P
from disq_tpu_torch.runtime import flightrec, slo, tracing
from disq_tpu_torch.runtime.errors import DisqOptions
from disq_tpu_torch.runtime.introspect import (
    HEALTH,
    reset_introspection,
    start_introspect_server,
)
from disq_tpu_torch.runtime.tracing import TraceContext, current_trace, trace_scope


@pytest.fixture(autouse=True)
def _clean_state():
    for mod, tr in ((slo, tracing), (ref_slo, ref_tracing)):
        mod.reset_slo()
        tr.reset_telemetry()
    yield
    for mod, tr in ((slo, tracing), (ref_slo, ref_tracing)):
        mod.reset_slo()
        tr.reset_telemetry()
    reset_introspection()


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _feed(tr, samples):
    """``(n, seconds, tenant, errors)`` rows into a registry."""
    h = tr.histogram("serve.request")
    for n, seconds, tenant, errors in samples:
        for _ in range(n):
            h.observe(seconds, endpoint="reads", tenant=tenant)
        if errors:
            tr.counter("serve.request.errors").inc(errors, endpoint="reads",
                                                   tenant=tenant)


def _evaluate(mod, tr, spec, phases):
    """Docs of an evaluator fed ``phases`` of samples, one evaluation per
    phase after advancing the clock."""
    clock = _Clock()
    ev = mod.SloEvaluator(mod.parse_slo_spec(spec), interval_s=3600.0,
                          clock=clock)
    docs = []
    try:
        for advance, samples in phases:
            _feed(tr, samples)
            clock.t += advance
            doc = ev.evaluate_now()
            doc.pop("run_id")
            docs.append((doc, ev.health_fragment(), ev.fast_burn_tenants()))
    finally:
        ev.stop()
    return docs


# -- the grammar ------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["t0:250:99, *:500:95:99.9", "a:1:50",
                                  "x:0.5:99.99:99.5,y:1000:1"])
def test_parse_equals_reference(spec):
    got, want = slo.parse_slo_spec(spec), ref_slo.parse_slo_spec(spec)
    assert {t: o.as_doc() for t, o in got.items()} == \
        {t: o.as_doc() for t, o in want.items()}
    assert {t: (o.latency_s, o.target, o.availability)
            for t, o in got.items()} == \
        {t: (o.latency_s, o.target, o.availability)
         for t, o in want.items()}


@pytest.mark.parametrize("bad", ["t0:250", "t0:250:99:99.9:extra",
                                 ":250:99", "t0:zero:99", "t0:-5:99",
                                 "t0:250:0", "t0:250:100", "", " , "])
def test_parse_rejects_malformed_like_reference(bad):
    with pytest.raises(ValueError) as got:
        slo.parse_slo_spec(bad)
    with pytest.raises(ValueError) as want:
        ref_slo.parse_slo_spec(bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        DisqOptions().with_slo(bad)


# -- burn rates ---------------------------------------------------------------------


CASES = {
    "all_bad": ("t0:100:99", [(61, [(50, 0.5, "t0", 0)])]),
    "all_good": ("t0:100:99", [(61, [(50, 0.001, "t0", 0)])]),
    "availability": ("*:1000:50:99", [(61, [(100, 0.001, "tx", 10)])]),
    "windows": ("t0:250:99,*:500:95:99.9", [
        (30, [(40, 0.3, "t0", 1), (20, 0.05, "t1", 0)]),
        (45, [(10, 0.01, "t0", 0), (30, 2.0, "t1", 3)]),
        (400, [(5, 0.2, "t0", 0)]),
        (4000, [(7, 0.6, "t2", 7)]),
    ]),
    "unmatched": ("t0:100:99", [(61, [(9, 0.5, "other", 2)])]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_burn_rates_equal_reference(case):
    spec, phases = CASES[case]
    got = _evaluate(slo, tracing, spec, phases)
    want = _evaluate(ref_slo, ref_tracing, spec, phases)
    assert got == want


def test_burn_rate_values():
    [(doc, frag, fast)] = _evaluate(slo, tracing, *CASES["all_bad"])
    w60 = doc["tenants"]["t0"]["windows"]["60"]
    assert w60["total"] == 50 and w60["good"] == 0
    assert w60["burn"] == pytest.approx(100.0)
    assert fast == ["t0"] and frag["worst_burn"]["t0"] == pytest.approx(100.0)
    [(doc, _, fast)] = _evaluate(slo, tracing, *CASES["all_good"])
    assert doc["tenants"]["t0"]["windows"]["60"]["burn"] == 0.0 and not fast
    [(doc, _, _)] = _evaluate(slo, tracing, *CASES["availability"])
    w60 = doc["tenants"]["tx"]["windows"]["60"]
    assert w60["errors"] == 10
    assert w60["availability_burn"] == pytest.approx(10.0)


# -- arming ---------------------------------------------------------------------------


def test_unconfigured_is_structurally_off(tmp_path):
    assert slo.evaluator_if_running() is None
    doc = slo.slo_doc()
    assert doc["enabled"] is False and doc["tenants"] == {}
    assert not [t for t in threading.enumerate()
                if t.name.startswith("disq-slo")]


def test_options_and_env_knob_arm_the_evaluator(tmp_path, monkeypatch):
    from bam_oracle import DEFAULT_REFS, make_bam_bytes, synth_records

    path = str(tmp_path / "in.bam")
    open(path, "wb").write(make_bam_bytes(DEFAULT_REFS,
                                          synth_records(50, seed=2)))
    storage = P.ReadsStorage.make_default(device="cpu")
    storage.options(storage._options.with_slo("t0:100:99")).read(path)
    ev = slo.evaluator_if_running()
    assert ev is not None and set(ev.objectives) == {"t0"}
    assert [t for t in threading.enumerate() if t.name == "disq-slo"]
    slo.reset_slo()
    monkeypatch.setenv("DISQ_TPU_TORCH_SLO", "*:500:95")
    assert slo.configure_from_options(DisqOptions()) is not None
    assert set(slo.evaluator_if_running().objectives) == {"*"}


def test_fast_burn_degrades_healthz():
    clock = _Clock()
    slo.configure("t0:100:99", interval_s=3600.0, clock=clock)
    _feed(tracing, [(50, 0.5, "t0", 0)])
    clock.t += 61
    slo.evaluator_if_running().evaluate_now()
    doc = HEALTH.healthz()
    assert doc["status"] == "degraded"
    assert doc["slo"]["fast_burn_tenants"] == ["t0"]
    slo.reset_slo()
    assert "slo" not in HEALTH.healthz()


def test_slo_endpoint():
    clock = _Clock()
    slo.configure("t0:100:99", interval_s=3600.0, clock=clock)
    addr = start_introspect_server(0)
    _feed(tracing, [(20, 0.5, "t0", 0)])
    clock.t += 61
    slo.evaluator_if_running().evaluate_now()
    with urllib.request.urlopen(f"http://{addr}/slo", timeout=10) as r:
        doc = json.loads(r.read())
    assert doc["enabled"] is True
    assert doc["tenants"]["t0"]["fast_burn"] is True
    assert doc["process_id"] == 0


# -- the trace context ------------------------------------------------------------------


def test_inject_and_scope_are_noops_without_context():
    assert current_trace() is None
    assert tracing.inject_trace_headers({"Range": "bytes=0-9"}) == \
        {"Range": "bytes=0-9"}
    with trace_scope(None):
        assert current_trace() is None


def test_flightrec_events_stamped_under_a_trace(tmp_path):
    flightrec.enable(str(tmp_path))
    try:
        with trace_scope(TraceContext("0ddba11", "03", "lab")):
            flightrec.record_event("retry", what="x", tenant="t9")
        flightrec.record_event("retry", what="y")
        stamped, bare = flightrec.recorder().events()[-2:]
        assert stamped["trace"] == "0ddba11"
        assert stamped["tenant"] == "t9"  # the event's own field wins
        assert "trace" not in bare
    finally:
        flightrec.reset_flightrec()
