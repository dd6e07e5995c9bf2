"""The port's serving fleet (``repro_torch.serve.scheduler``) against the JAX
package's, bit for bit, on the CPU.

The same seeds build the replicas, their lifetimes, the churn schedule and
the request stream in both packages.  The JAX package decides through its
numpy twins (``repro.core.batched.HAVE_JAX`` patched to False); the port's
fleet runs its float64 torch decision kernels on ``device="cpu"``.
"""
import numpy as np
import pytest
import torch

import repro.core.batched as ref_batched
import repro.serve.scheduler as ref_scheduler
import repro.stream as ref_stream
import repro_torch.serve.scheduler as scheduler
import repro_torch.stream as stream
from repro_torch.launch.serve import fleet_interference, serve_demo
from test_torch_sim import launches, same_result  # noqa: F401
from test_torch_stream import same_stream

POLICIES = ("ibdash", "petrel", "lavea", "round_robin")


@pytest.fixture(autouse=True)
def reference_numpy_path(monkeypatch):
    monkeypatch.setattr(ref_batched, "HAVE_JAX", False)


@pytest.mark.parametrize("coeffs", [
    {},
    dict(m_short=0.0015, c_short=0.030, m_long=0.0045, c_long=0.180),
    dict(m_short=2e-4, c_short=0.011, m_long=6e-4, c_long=0.066, n_classes=3, fast_factor=0.5),
])
def test_interference_model_equals_reference(coeffs):
    got = scheduler.serving_interference_model(**coeffs)
    want = ref_scheduler.serving_interference_model(**coeffs)
    assert np.array_equal(got.base, want.base) and got.base.dtype == want.base.dtype
    assert np.array_equal(got.slope, want.slope) and got.slope.dtype == want.slope.dtype


@pytest.mark.parametrize("m,c", [(0.0015, 0.030), (-3.1e-4, 0.0395), (0.0, 0.05)])
def test_fleet_interference_is_serve_demos_table(m, c):
    """``serve_demo``'s table is the JAX ``serve_demo``'s (3m, 6c for long
    requests), with a slope measured below zero taken as 0, where the
    reference table would refuse it."""
    got = fleet_interference(m, c)
    mm = max(m, 0.0)
    want = ref_scheduler.serving_interference_model(m_short=mm, c_short=c, m_long=3 * mm,
                                                    c_long=6 * c)
    assert np.array_equal(got.base, want.base) and np.array_equal(got.slope, want.slope)
    if m < 0:
        with pytest.raises(ValueError, match="negative"):
            ref_scheduler.serving_interference_model(m_short=m, c_short=c, m_long=3 * m,
                                                     c_long=6 * c)


# name: (ServingFleet keywords, run keywords)
FLEET_RUNS = {
    **{p: (dict(policy=p), {}) for p in POLICIES},
    "ibdash-fused": (dict(policy="ibdash"), dict(fused=True)),
    "ibdash-admission": (dict(policy="ibdash"), dict(admission=True)),
    "ibdash-churn-replan": (dict(policy="ibdash", churn=True, recovery="replan"), {}),
}


def fleet_run(sched, st, fleet_kw, run_kw, **device):
    im = sched.serving_interference_model(m_short=0.0015, c_short=0.030,
                                          m_long=0.0045, c_long=0.180)
    fleet = sched.ServingFleet(im, n_replicas=8, seed=0, horizon=40.0, **fleet_kw, **device)
    if run_kw.get("admission"):
        run_kw = dict(run_kw, admission=st.AdmissionConfig(queue_cap=8))
    return fleet, fleet.run(n_requests=160, arrival_window=3.0, seed=1, **run_kw)


@pytest.mark.parametrize("name", list(FLEET_RUNS))
def test_serving_fleet_equals_reference(name, launches):
    fleet_kw, run_kw = FLEET_RUNS[name]
    fleet, got = fleet_run(scheduler, stream, fleet_kw, run_kw, device="cpu")
    ref_fleet, want = fleet_run(ref_scheduler, ref_stream, fleet_kw, run_kw)
    assert fleet.cluster.device == torch.device("cpu")
    assert getattr(fleet.policy, "device", fleet.cluster.device) == fleet.cluster.device
    same_result(got, want)
    assert fleet.engine.stats.as_dict() == ref_fleet.engine.stats.as_dict()
    assert got.n > 0 and np.isfinite(got.avg_service_time)
    if run_kw.get("admission"):
        same_stream(got.stream, want.stream)
        assert got.stream.n_arrivals == 160 and got.stream.stats["shed"] > 0
    if run_kw.get("fused"):
        assert launches()["ibdash_scan_kernel"] > 0
    if fleet_kw.get("churn"):
        assert fleet.engine.stats.device_down > 0


def test_serve_demo_fleet_equals_reference():
    """Part 3 of ``serve_demo``: the four-policy comparison on the port's
    measured ``(m, c)`` equals the JAX fleet's on the same coefficients (a
    slope measured below zero enters both as 0)."""
    out = serve_demo(n_requests=6, max_batch=4, device="cpu")
    m, c, _ = out["interference"]
    assert list(out["fleet"]) == list(POLICIES)
    m = max(m, 0.0)
    im = ref_scheduler.serving_interference_model(m_short=m, c_short=c,
                                                  m_long=3 * m, c_long=6 * c)
    for pol in POLICIES:
        res = ref_scheduler.ServingFleet(im, policy=pol, n_replicas=16, seed=0).run(
            n_requests=600, arrival_window=8.0, seed=1)
        assert out["fleet"][pol] == (res.avg_service_time, res.prob_failure)
