"""The port's simulator and façade (``repro_torch.sim``, ``repro_torch.api``)
against the JAX package's, bit for bit, on the CPU.

As in ``test_torch_placement.py``, the JAX package decides through its
numpy twins (``repro.core.batched.HAVE_JAX`` patched to False) and the port
runs its float64 torch decision kernels on ``device="cpu"``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.core.batched as ref_batched
import repro_torch.api as api
import repro_torch.core.batched as batched
from test_torch_placement import paper_apps, same_plan

import repro.sim as ref_sim
import repro_torch.sim as port_sim

SMALL = dict(n_cycles=1, instances_per_cycle=50, n_devices=24)


@pytest.fixture(autouse=True)
def reference_numpy_path(monkeypatch):
    monkeypatch.setattr(ref_batched, "HAVE_JAX", False)


@pytest.fixture
def launches():
    for kern in batched.DECISION_KERNELS:
        kern.launches = 0
    return lambda: {kern.__name__: kern.launches for kern in batched.DECISION_KERNELS}


def records(res):
    return [dataclasses.astuple(r) for r in res.instances]


def spans(tracer):
    """A trace as comparable tuples (an open span's NaN end as None)."""
    return [(s.kind, s.tid, s.t0, s.t1 if s.closed else None, s.name, s.attrs)
            for s in tracer.spans]


def same_result(a, b):
    """Two SimResults agree instance for instance and device for device."""
    assert (a.scheme, a.scenario, a.horizon, a.n) == (b.scheme, b.scenario, b.horizon, b.n)
    assert np.array_equal(a.load_per_device, b.load_per_device)
    assert records(a) == records(b)
    assert a.avg_service_time == b.avg_service_time or (
        math.isnan(a.avg_service_time) and math.isnan(b.avg_service_time))
    assert a.prob_failure == b.prob_failure


# (scheme, SimConfig fields): the paper's scenarios, a fused burst, the
# multi-tier fleet, churn with each recovery, correlated churn with salvage
RUNS = [
    ("ibdash", dict(scenario="mix")),
    ("ibdash", dict(scenario="ced", fused_burst=True, instances_per_cycle=120)),
    ("ibdash", dict(scenario="ped")),
    ("lavea", dict(scenario="mix", fused_burst=True, instances_per_cycle=120)),
    ("round_robin", dict(scenario="ped", fused_burst=True, instances_per_cycle=120)),
    ("tier_escalation", dict(scenario="multi_tier", latency_budget=3.0)),
    ("tier_escalation", dict(scenario="multi_tier", latency_budget=3.0, fused_burst=True,
                             instances_per_cycle=120)),
    ("ibdash", dict(scenario="churn", recovery="failover")),
    ("ibdash", dict(scenario="churn", recovery="replan")),
    ("churn_aware", dict(scenario="correlated_churn", salvage=1, recovery="replan")),
    ("churn_aware", dict(scenario="correlated_churn", salvage=1, fused_burst=True,
                         instances_per_cycle=120)),
    ("lats", dict(scenario="mix", trace=True)),
    ("petrel", dict(scenario="churn", recovery="failover", n_cycles=2)),
    ("random", dict(scenario="correlated_churn", salvage=1)),
]


@pytest.mark.parametrize("scheme,cfg", RUNS,
                         ids=[f"{s}-{'-'.join(f'{k}={v}' for k, v in c.items())}"
                              for s, c in RUNS])
def test_run_one_equals_reference(scheme, cfg, launches):
    """run_one on the CPU == the reference's run_one, instance for instance;
    fused bursts of kernel-backed policies launched their kernels."""
    cfg = {**SMALL, **cfg}
    got = api.run_one(scheme, api.SimConfig(device="cpu", **cfg))
    want = ref_api.run_one(scheme, ref_api.SimConfig(**cfg))
    same_result(got, want)
    if cfg.get("trace"):
        assert spans(got.trace) == spans(want.trace)
    if cfg.get("fused_burst"):
        assert launches()[{"lavea": "lavea_kernel", "round_robin": "round_robin_kernel",
                           "tier_escalation": "tier_escalation_kernel"}.get(
            scheme, "ibdash_scan_kernel")] > 0


def test_orchestrator_online_equals_reference(launches):
    """The online façade: arrivals submitted one by one and as a fused
    burst, the clock stepped, what-if plans committed and undone; records,
    counters and spans equal the reference's."""
    def drive(mod, sim, device_kw):
        profile = sim.make_profile(seed=2, **device_kw)
        cluster = sim.make_cluster(profile, scenario="ped", n_devices=30, seed=2,
                                   horizon=120.0)
        orch = mod.Orchestrator(cluster, "ibdash", seed=2, trace=True,
                                churn=sim.exponential_churn(cluster, horizon=100.0, seed=3),
                                recovery="replan")
        apps, times = paper_apps(sim, B=40)
        for app, t in zip(apps[:10], times[:10]):
            orch.submit(app, t)
        orch.step(until=2.0)
        orch.submit_batch(apps[10:], [t + 2.0 for t in times[10:]], fused=True)
        orch.step(until=5.0)
        plan = orch.plan(sim.video_app().relabel("#probe"))
        token = orch.commit(plan)
        alloc = orch.cluster.alloc.copy()
        orch.cluster.undo(token)
        orch.drain()
        return orch, plan, alloc

    got, plan_p, alloc_p = drive(api, port_sim, dict(device="cpu"))
    want, plan_r, alloc_r = drive(ref_api, ref_sim, {})
    same_plan(plan_p.placement, plan_r.placement)
    assert np.array_equal(alloc_p, alloc_r)
    assert records(got.result("ped")) == records(want.result("ped"))
    assert got.stats.as_dict() == want.stats.as_dict()
    assert spans(got.trace) == spans(want.trace)
    assert launches()["ibdash_scan_kernel"] > 0


def test_sim_config_carries_the_device():
    assert api.SimConfig().device == "cuda"
    profile = api.make_profile(seed=0, device="cpu")
    cluster = api.make_cluster(profile, scenario="multi_tier", n_devices=9)
    assert profile.device == cluster.device == torch.device("cpu")
    pol = port_sim.policy_for("tier_escalation", profile, api.SimConfig(device="cpu"))
    assert pol.device == torch.device("cpu")


def test_unported_parts_say_where_they_are_queued():
    """Every name of the JAX package's façade resolves to the port's own
    object (none is a stub any more), and a CPU stream run returns its
    StreamResult as ``res.stream``."""
    import importlib

    assert not hasattr(api, "_NOT_PORTED")
    assert set(ref_api._LAZY) == set(api._LAZY)
    for name, (mod, attr) in api._LAZY.items():
        assert mod.startswith("repro_torch.")
        obj = getattr(api, name)
        assert obj is getattr(importlib.import_module(mod), attr)
        assert getattr(obj, "__module__", "repro_torch").startswith("repro_torch")
    for name in ("ServingFleet", "StreamingOrchestrator", "to_chrome_trace"):
        assert getattr(api, name).__module__.startswith("repro_torch.")
    res = api.run_one("ibdash", api.SimConfig(scenario="stream", device="cpu", **SMALL,
                                              cycle_len=3.0, stream_rate=20.0))
    assert res.scenario == "stream" and res.stream.n_arrivals == res.stream.stats["admitted"] > 0
    with pytest.raises(AttributeError):
        api.no_such_name
