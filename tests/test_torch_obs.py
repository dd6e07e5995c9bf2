"""The port's attribution reports and trace exporters (``repro_torch.obs``)
against the JAX package's ``repro.obs``, on the CPU.

Each package traces the same seeded run (``test_torch_sim.py`` and
``test_torch_stream.py`` hold those runs and their spans equal); the
reports built from the two traces must be equal, compared through ``repr``
so that a numpy or torch scalar where the reference has a Python float
fails too, and the exported Chrome/Perfetto JSON equal string for string.
"""
import json

import pytest

import repro.api as ref_api
import repro.core.batched as ref_batched
import repro.obs as ref_obs
import repro_torch.api as api
import repro_torch.obs as obs
from test_torch_sim import SMALL, spans

# name: (scheme, run_one's SimConfig fields), traced: the paper's mixed
# fleet; correlated churn with salvage (a lost instance, salvage spans) and
# with replan (recovery waits); the streaming service with admission (queue
# spans, shed instances)
CHURN = dict(scenario="correlated_churn", salvage=1, n_devices=24, n_cycles=2,
             instances_per_cycle=60)
TRACED = {
    "mix": ("ibdash", dict(scenario="mix", **SMALL)),
    "correlated-churn-salvage": ("random", CHURN),
    "correlated-churn-replan": ("round_robin", dict(CHURN, recovery="replan")),
    "stream": ("ibdash", dict(scenario="stream", n_devices=24, n_cycles=1, cycle_len=10.0,
                              stream_rate=60.0, stream_queue_cap=40, stream_wave=8)),
}


@pytest.fixture(autouse=True)
def reference_numpy_path(monkeypatch):
    monkeypatch.setattr(ref_batched, "HAVE_JAX", False)


def traced(name):
    """The same traced run through each package: (port's, reference's)."""
    scheme, cfg = TRACED[name]
    got = api.run_one(scheme, api.SimConfig(device="cpu", trace=True, **cfg))
    want = ref_api.run_one(scheme, ref_api.SimConfig(trace=True, **cfg))
    assert spans(got.trace) == spans(want.trace)
    return got, want


@pytest.mark.parametrize("name", list(TRACED))
def test_reports_equal_reference(name):
    got, want = traced(name)
    tp, tr = got.trace, want.trace
    report = obs.attribution_report(tp, top_k=4)
    assert repr(report) == repr(ref_obs.attribution_report(tr, top_k=4))
    assert repr(obs.calibration(tp)) == repr(ref_obs.calibration(tr))
    assert repr(obs.slow_instances(tp, 3)) == repr(ref_obs.slow_instances(tr, 3))
    assert repr(obs.lost_instances(tp)) == repr(ref_obs.lost_instances(tr))
    assert obs.format_report(report) == ref_obs.format_report(ref_obs.attribution_report(tr,
                                                                                          top_k=4))
    for inst in list(tp.instances())[::17]:
        assert repr(obs.instance_breakdown(tp, inst.tid)) == repr(
            ref_obs.instance_breakdown(tr, inst.tid))
    assert report["critical_path"]["n"] > 0
    kinds = {span.kind for span in tp.spans}
    if name == "correlated-churn-salvage":
        assert report["lost"] and report["ledger"]["lost"] > 0 and "salvage" in kinds
    if name == "correlated-churn-replan":
        assert {"replan", "recovery_wait"} <= kinds
    if name == "stream":
        assert report["ledger"]["shed"] == got.stream.stats["shed"] > 0
        assert report["critical_path"]["n"] == got.stream.stats["completed"]


# the span kinds each traced run emits, named here so that each kind the port
# emits has a pin in its own suite (the span-parity rule of
# ``python -m repro_torch.analysis`` checks that): a kind that stops being
# emitted fails here
EMITTED = {
    "mix": {"instance", "plan", "model_upload", "parent_transfer", "exec"},
    "correlated-churn-salvage": {"device_down", "device_up", "salvage"},
    "correlated-churn-replan": {"device_down", "device_up", "recovery_wait", "replan"},
    "stream": {"admission_queue", "shed"},
}


@pytest.mark.parametrize("name", list(TRACED))
def test_traced_runs_emit_their_span_kinds(name):
    scheme, cfg = TRACED[name]
    got = api.run_one(scheme, api.SimConfig(device="cpu", trace=True, **cfg))
    assert EMITTED[name] <= {span.kind for span in got.trace.spans}

@pytest.mark.parametrize("name", list(TRACED))
def test_chrome_trace_equals_reference(name, tmp_path):
    """The exported JSON equals the reference's string for string, passes
    validation, and rebuilds the run's instance ledger on its own."""
    got, want = traced(name)
    path = tmp_path / "trace.json"
    doc = obs.to_chrome_trace(got.trace, str(path))
    text = json.dumps(doc)
    assert text == json.dumps(ref_obs.to_chrome_trace(want.trace))
    assert path.read_text() == text
    n = obs.validate_chrome_trace(json.loads(text))
    assert n == len(doc["traceEvents"]) == ref_obs.validate_chrome_trace(doc)
    ledger = obs.ledger_from_trace(json.loads(text))
    assert ledger == ref_obs.ledger_from_trace(json.loads(text))
    stats = got.stream.stats if name == "stream" else got.trace.outcome_counts()
    assert ledger["admitted"] == ledger["completed"] + ledger["lost"] + ledger["shed"]
    for key in ("completed", "lost", "shed"):
        assert ledger[key] == stats.get(key, 0)
    summary = obs.json_summary(got.trace, path=str(tmp_path / "summary.json"))
    assert json.dumps(summary) == json.dumps(ref_obs.json_summary(want.trace))
    assert json.loads((tmp_path / "summary.json").read_text()) == summary


def test_exporter_refuses_open_spans_and_bad_documents():
    tracer = obs.Tracer()
    tid = tracer.begin_instance("app", 0.0)
    with pytest.raises(ValueError, match="open"):
        obs.to_chrome_trace(tracer)
    tracer.end_instance(tid, 1.0, outcome="completed")
    doc = obs.to_chrome_trace(tracer)
    assert obs.ledger_from_trace(doc) == {"admitted": 1, "completed": 1, "lost": 0, "shed": 0}
    with pytest.raises(ValueError):
        obs.validate_chrome_trace({"traceEvents": []})
    with pytest.raises(ValueError):
        obs.validate_chrome_trace([{"name": "x", "ph": "X", "pid": 0, "tid": 0, "ts": -1.0,
                                    "dur": 1.0}])
    with pytest.raises(ValueError):
        obs.ledger_from_trace([{"cat": "instance", "ph": "X", "name": "a", "args": {}}])
