"""The port's fault-tolerance runtime (``repro_torch.ft``) against the JAX
package's ``repro.ft``, on the CPU, with an explicit clock (``now``) in
every call: the same heartbeat ledger gives the same failure-rate MLE,
forecasts, re-mesh plans and backup decisions, and the port's churn
generator fed by the port's monitor equals the JAX pair.
"""
import dataclasses

import numpy as np
import pytest

import repro.api as ref_api
import repro.ft as ref_ft
import repro_torch.api as api
import repro_torch.ft as ft


def monitor_ledger(pkg, seed=0, n=30, classes=("reserved", "spot", "0")):
    """A seeded fleet of pods joining, heartbeating and going silent; the
    monitor after a sweep at every step."""
    rng = np.random.default_rng(seed)
    mon = pkg.FleetMonitor(timeout=3.0)
    life = {}
    for i in range(n):
        cls = classes[i % len(classes)]
        mon.join(f"p{i}", cls=cls, now=float(i % 4))
        life[f"p{i}"] = float(rng.exponential(8.0 if cls == "spot" else 40.0))
    dead_by_sweep = []
    for t in np.arange(1.0, 30.0, 0.5):
        for pid, until in life.items():
            if t < until:
                mon.heartbeat(pid, now=float(t))
        dead_by_sweep.append(mon.sweep(now=float(t)))
    return mon, dead_by_sweep


def test_fleet_monitor_equals_reference():
    got, dead_p = monitor_ledger(ft)
    want, dead_r = monitor_ledger(ref_ft)
    assert dead_p == dead_r and any(dead_p)
    assert [dataclasses.astuple(p) for p in got.pods.values()] == [
        dataclasses.astuple(p) for p in want.pods.values()]
    assert got.alive_pods() == want.alive_pods()
    for cls in ("reserved", "spot", "0", "unseen"):
        assert got.lam(cls) == want.lam(cls)
    assert got.fleet_lams() == want.fleet_lams()
    classes = ["spot", "reserved", "0", "spot"]
    f_got, f_want = got.forecast(classes, horizon=20.0, n_points=9), want.forecast(
        classes, horizon=20.0, n_points=9)
    assert f_got.shape == (4, 9) and np.array_equal(f_got, f_want)
    for h in (0.5, 10.0, 120.0):
        assert got.prob_job_interrupted(h) == want.prob_job_interrupted(h)


@pytest.mark.parametrize("n_alive,mp,prev,restore", [
    (13, 4, 4, 120), (8, 2, None, None), (7, 7, 1, 3), (31, 3, 10, None)])
def test_plan_remesh_equals_reference(n_alive, mp, prev, restore):
    alive = [f"pod{i:02d}" for i in np.random.default_rng(n_alive).permutation(40)[:n_alive]]
    kw = dict(model_parallel=mp, prev_data_parallel=prev, restore_step=restore)
    got, want = ft.plan_remesh(alive, **kw), ref_ft.plan_remesh(alive, **kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    with pytest.raises(ValueError):
        ft.plan_remesh(alive[: mp - 1], model_parallel=mp)


def test_straggler_mitigator_equals_reference():
    rng = np.random.default_rng(5)
    for trial in range(40):
        n = int(rng.integers(1, 9))
        lat = rng.uniform(10.0, 200.0, n).round(1)
        lams = 10.0 ** rng.uniform(-7, -1.5, n)
        eligible = rng.random(n) < 0.8
        eligible[int(rng.integers(n))] = True
        kw = dict(alpha=float(rng.uniform(0.2, 0.9)), beta=float(rng.choice([0.01, 0.05, 0.2])),
                  gamma=int(rng.integers(0, 4)))
        got = ft.StragglerMitigator(**kw).decide(lat, lams, eligible)
        want = ref_ft.StragglerMitigator(**kw).decide(lat, lams, eligible)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert ft.StragglerMitigator(**kw).expected_step_speedup(lat, lams, 60.0) == \
            ref_ft.StragglerMitigator(**kw).expected_step_speedup(lat, lams, 60.0)
    with pytest.raises(ValueError):
        ft.StragglerMitigator().decide([1.0, 2.0], [1e-3, 1e-3], [False, False])


def test_churn_from_monitor_equals_reference():
    """The monitor's MLE rates drive each package's churn generator over the
    same seeded fleet: the same schedule, forecastable side included."""
    def schedule(pkg_api, pkg_ft, **kw):
        mon, _ = monitor_ledger(pkg_ft, classes=tuple(str(c) for c in range(8)))
        profile = pkg_api.make_profile(seed=0, **kw)
        cluster = pkg_api.make_cluster(profile, scenario="ped", n_devices=24, seed=0,
                                       horizon=120.0)
        return pkg_api.churn_from_monitor(mon, cluster, horizon=100.0, seed=1,
                                          mean_downtime=5.0)

    got = schedule(api, ft, device="cpu")
    want = schedule(ref_api, ref_ft)
    assert got.n_events == want.n_events > 0
    assert [dataclasses.astuple(e) for e in got.events] == [
        dataclasses.astuple(e) for e in want.events]
    assert got.known_departures == want.known_departures
    assert got.forecast_lams == want.forecast_lams
