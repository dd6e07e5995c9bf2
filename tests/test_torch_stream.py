"""The port's streaming service (``repro_torch.stream``) against the JAX
package's ``repro.stream``, bit for bit, on the CPU.

The same seeds build the fleet, the profile and the arrivals in both
packages; each test first holds the inputs equal, then the results: every
instance record, the shed log, the engine's counters and every metric but
the two read off the host's clock (``without_wall_clock``).  As in
``test_torch_sim.py``, the JAX package decides through its numpy twins
(``repro.core.batched.HAVE_JAX`` patched to False) and the port runs its
float64 torch decision kernels on ``device="cpu"``.
"""
import dataclasses
import json

import numpy as np
import pytest

import repro.api as ref_api
import repro.core.batched as ref_batched
import repro.stream as ref_stream
import repro_torch.api as api
import repro_torch.core.batched as batched
import repro_torch.stream as stream
from repro_torch.stream import without_wall_clock
from test_torch_sim import launches, same_result  # noqa: F401

CPU = dict(device="cpu")
REF = (ref_api, ref_stream, {})
PORT = (api, stream, CPU)
N_DEVICES = 24


@pytest.fixture(autouse=True)
def reference_numpy_path(monkeypatch):
    monkeypatch.setattr(ref_batched, "HAVE_JAX", False)


def arrival_rows(arrivals):
    """The inputs a stream run sees: time, uid, kind, class and deadline."""
    return [(a.t, a.uid, a.kind, a.slo.name, a.slo.deadline, a.slo.critical, a.deadline)
            for a in arrivals]


def metrics_json(metrics):
    return json.dumps(without_wall_clock(metrics), sort_keys=True)


def same_stream(a, b):
    """Two StreamResults (one from each package) agree exactly."""
    assert a.n_arrivals == b.n_arrivals
    assert a.stats == b.stats
    assert [dataclasses.astuple(r) for r in a.shed_log] == [
        dataclasses.astuple(r) for r in b.shed_log]
    same_result(a.result, b.result)
    assert metrics_json(a.metrics) == metrics_json(b.metrics)


# -- arrival processes ------------------------------------------------------------
ARRIVALS = {
    "poisson": lambda s, streams: s.poisson_arrivals(streams, 60.0, 10.0, seed=3, t0=1.5),
    "diurnal": lambda s, streams: s.diurnal_arrivals(streams, 10.0, 80.0, 12.0, period=5.0,
                                                     phase=0.5, seed=4),
    "trace_replay": lambda s, streams: s.trace_replay(
        [(3.0, "video"), (0.5, "matrix", 2.0), (0.5, "lightgbm"), (7.25, "mapreduce", 40.0),
         (1.0, "video")], streams),
}


@pytest.mark.parametrize("process", sorted(ARRIVALS))
def test_arrivals_equal_reference(process):
    """The keyed numpy streams draw the same times, uids, kinds and deadlines;
    the lazy DAGs instantiate to the same task names."""
    got = ARRIVALS[process](stream, stream.default_streams(slo_critical=4.0))
    want = ARRIVALS[process](ref_stream, ref_stream.default_streams(slo_critical=4.0))
    assert len(got) > 4
    assert arrival_rows(got) == arrival_rows(want)
    for a, b in zip(got[:8], want[:8]):
        assert list(a.instantiate().tasks) == list(b.instantiate().tasks)


# -- the admission controller -----------------------------------------------------
class StubEstimator:
    """A fixed idle-fleet estimate per workload kind."""

    def __init__(self, ests, n_alive=3):
        self.ests, self._n = ests, n_alive

    def estimate(self, a):
        return self.ests[a.kind]

    def n_alive(self, t):
        return self._n


def admission_trace(pkg, cap, safety):
    """Offer a seeded stream tick by tick and pop small waves: the waves'
    uids, the shed log and the ledger."""
    streams = pkg.default_streams(slo_critical=2.0, slo_best_effort=5.0)
    arrivals = pkg.poisson_arrivals(streams, 40.0, 6.0, seed=11)
    ests = {"video": 1.5, "matrix": 1.2, "lightgbm": 3.5, "mapreduce": 0.5}
    ctl = pkg.AdmissionController(pkg.AdmissionConfig(queue_cap=cap, safety=safety),
                                  StubEstimator(ests))
    waves, idx, now = [], 0, 0.0
    while idx < len(arrivals) or len(ctl):
        while idx < len(arrivals) and arrivals[idx].t <= now:
            ctl.offer(arrivals[idx], now)
            idx += 1
        waves.append([a.uid for a in ctl.pop_wave(now, 3)])
        now += 0.25
    ctl.assert_drained()
    return (arrival_rows(arrivals), waves,
            [dataclasses.astuple(r) for r in ctl.shed_log],
            (ctl.offered, ctl.dispatched, ctl.shed))


@pytest.mark.parametrize("cap,safety", [(8, 1.0), (5, 1.3), (None, 1.0)])
def test_admission_controller_sheds_the_same(cap, safety):
    """The same instances are shed for the same reasons with the same
    predicate inputs, and the same waves leave the queue (heap ties broken
    by arrival order in both packages)."""
    got, want = admission_trace(stream, cap, safety), admission_trace(ref_stream, cap, safety)
    assert got == want
    reasons = {row[3] for row in got[2]}
    assert {"deadline", "stale"} <= reasons
    if cap is not None:
        assert {"capacity", "evicted"} <= reasons


def test_estimator_plans_the_idle_fleet_like_reference():
    """The idle-fleet estimate of every paper app, planned on the fleet's
    device, equals the reference's (one app a plan: its pools are below the
    kernels' row threshold and take the scalar rule in both packages)."""
    def estimates(pkg):
        api_, st, kw = pkg
        profile = api_.make_profile(seed=0, **kw)
        cluster = api_.make_cluster(profile, scenario="stream", n_devices=N_DEVICES, seed=0,
                                    horizon=60.0)
        policy = api_.make_policy("ibdash", lats_model=profile.lats_model, **kw)
        est = st.PlacementLatencyEstimator(cluster, policy)
        arrivals = st.poisson_arrivals(st.default_streams(), 20.0, 2.0, seed=1)
        return [est.estimate(a) for a in arrivals], est._idle.device if kw else None

    got, idle_device = estimates(PORT)
    want, _ = estimates(REF)
    assert got == want and np.isfinite(got).all()
    assert str(idle_device) == "cpu"


# -- the service loop -------------------------------------------------------------
def kind_streams(pkg_dag, st, n=12):
    """``n`` single-task streams of distinct task types and memory sizes:
    a wave of them plans ``n`` distinct context rows at one instant, enough
    for the batched decision kernels (the paper apps collapse to at most
    five distinct rows a stage)."""
    def builder(i):
        return lambda: pkg_dag.AppDAG.from_tasks(
            f"k{i}", [pkg_dag.TaskSpec("t0", ttype=i % 4, mem_bytes=(i + 1) * 40e6)])

    return [st.AppStream(f"k{i}", builder(i),
                         slo=st.LATENCY_CRITICAL if i % 2 else st.BEST_EFFORT)
            for i in range(n)]


# name: the keywords of service_run
SERVICE_RUNS = {
    "admitted": dict(rate=60.0, cap=48, wave=10),
    "admitted-tight-slo": dict(rate=60.0, cap=48, wave=10, slo=(2.0, 4.0)),
    "no-admission-baseline": dict(rate=40.0, cap=None, wave=None, horizon=6.0),
    "no-degrade": dict(rate=60.0, cap=48, wave=10, degrade=None),
    "churn-replan-salvage": dict(
        rate=60.0, cap=48, wave=8, recovery="replan", salvage=1,
        churn=[(1.0, 3, "leave"), (1.2, 7, "leave"), (2.0, 11, "leave"), (2.5, 3, "join"),
               (3.1, 5, "leave"), (4.0, 13, "leave"), (5.5, 7, "join"), (6.0, 17, "leave")]),
    "many-kinds": dict(rate=160.0, cap=48, wave=24, horizon=6.0, kinds=True),
}


def count_pools(policy, sizes):
    """Record the distinct-row count of every ``decide_batch`` call."""
    inner = policy.decide_batch

    def decide_batch(batch):
        sizes.append(batch.n_distinct)
        return inner(batch)

    policy.decide_batch = decide_batch


def service_run(pkg, rate, cap, wave, horizon=10.0, slo=(6.0, 30.0), churn=None,
                recovery="fail_fast", salvage=0, degrade="auto", kinds=False):
    """One open-loop run through ``StreamingOrchestrator`` on the paper's
    mixed fleet; returns the arrivals, the result and the pool size of
    every ``decide_batch`` call (main and degraded policy)."""
    api_, st, kw = pkg
    profile = api_.make_profile(seed=0, **kw)
    cluster = api_.make_cluster(profile, scenario="stream", n_devices=N_DEVICES, seed=0,
                                horizon=horizon * 6.0 + 60.0)
    policy = api_.make_policy("ibdash", alpha=0.5, beta=0.1, gamma=3,
                              lats_model=profile.lats_model, **kw)
    pools = []
    count_pools(policy, pools)
    orch = api_.Orchestrator(
        cluster, policy, churn=api_.deterministic_churn(churn) if churn else None,
        recovery=recovery, salvage=salvage)
    streams = (kind_streams(api_, st) if kinds else
               st.default_streams(slo_critical=slo[0], slo_best_effort=slo[1]))
    arrivals = st.poisson_arrivals(streams, rate, horizon, seed=7)
    service = st.StreamingOrchestrator(
        orch, admission=st.AdmissionConfig(queue_cap=cap) if cap else None,
        wave_cap=wave, tick=0.25, degrade_policy=degrade)
    if service.degrade_policy is not None:
        count_pools(service.degrade_policy, pools)
    return arrivals, service.run(arrivals), pools


@pytest.mark.parametrize("name", list(SERVICE_RUNS))
def test_streaming_orchestrator_equals_reference(name, launches):
    """Records, shed log, counters and metrics equal the reference's; every
    ``decide_batch`` pool of at least ``BATCH_KERNEL_MIN_ROWS`` rows ran the
    port's queue and scan kernels once, smaller pools the scalar rule, as in
    the reference."""
    kw = SERVICE_RUNS[name]
    arr_p, got, pools_p = service_run(PORT, **kw)
    arr_r, want, pools_r = service_run(REF, **kw)
    assert arrival_rows(arr_p) == arrival_rows(arr_r)
    same_stream(got, want)
    assert pools_p == pools_r
    big = sum(g >= batched.BATCH_KERNEL_MIN_ROWS for g in pools_p)
    assert launches()["ibdash_scan_kernel"] == launches()["select_queue"] == big
    if kw.get("kinds"):
        assert big > 0
    counters, stats = got.metrics["counters"], got.stats
    assert stats["admitted"] == stats["completed"] + stats["lost"] + stats["shed"] == len(arr_p)
    assert got.metrics["gauges"]["placements_per_sec"] > 0
    if kw["cap"] is None:
        assert stats["shed"] == 0
    else:
        assert stats["shed"] > 0
    if name == "admitted-tight-slo":
        assert counters.get("shed_reason_deadline", 0) + counters.get("shed_reason_stale", 0) > 0
    if name in ("admitted", "admitted-tight-slo", "churn-replan-salvage"):
        assert counters.get("degraded", 0) > 0
    if kw.get("degrade", "auto") is None:
        assert "degraded" not in counters
    if kw.get("churn"):
        assert stats["device_down"] > 0 and stats["replica_deaths"] > 0


def test_auto_degrade_keeps_the_device():
    from repro_torch.core.policy import IBDASHPolicy, make_policy
    from repro_torch.stream.service import _auto_degrade

    d = _auto_degrade(IBDASHPolicy(gamma=3, device="cpu"))
    assert isinstance(d, IBDASHPolicy) and d.cfg.gamma == 0 and str(d.device) == "cpu"
    assert _auto_degrade(make_policy("random", device="cpu")) is None
    assert _auto_degrade(IBDASHPolicy(gamma=0, device="cpu")) is None


def test_without_wall_clock_drops_only_the_clock():
    _, res, _ = service_run(PORT, rate=30.0, cap=32, wave=6, horizon=3.0)
    m = res.metrics
    kept = without_wall_clock(m)
    assert "wave_plan_s" in m["histograms"] and "placements_per_sec" in m["gauges"]
    assert "wave_plan_s" not in kept["histograms"]
    assert "placements_per_sec" not in kept["gauges"]
    assert not any("placements_per_sec" in row for row in kept["samples"])
    assert kept["counters"] == m["counters"]
    assert len(kept["samples"]) == len(m["samples"])
    assert set(m["histograms"]) - set(kept["histograms"]) == {"wave_plan_s"}


# -- run_one(scenario="stream") ---------------------------------------------------
STREAM_CONFIGS = [
    dict(stream_process="poisson", stream_rate=50.0, stream_queue_cap=40, stream_wave=8),
    dict(stream_process="diurnal", stream_rate=20.0, stream_peak_rate=70.0,
         stream_period=5.0, stream_queue_cap=40, stream_wave=8),
    dict(stream_process="poisson", stream_rate=30.0, stream_admission=False, cycle_len=6.0),
]


@pytest.mark.parametrize("cfg", STREAM_CONFIGS,
                         ids=["poisson", "diurnal", "poisson-no-admission"])
def test_run_one_stream_equals_reference(cfg):
    cfg = {**dict(scenario="stream", n_devices=N_DEVICES, n_cycles=1, cycle_len=10.0), **cfg}
    got = api.run_one("ibdash", api.SimConfig(device="cpu", **cfg))
    want = ref_api.run_one("ibdash", ref_api.SimConfig(**cfg))
    assert got.scenario == "stream"
    same_result(got, want)
    same_stream(got.stream, want.stream)
    assert got.stream.stats["admitted"] == got.stream.n_arrivals
    assert str(got.stream.result.scenario) == "stream"
