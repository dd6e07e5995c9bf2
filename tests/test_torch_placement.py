"""The port's placement core (``repro_torch.core``) against the JAX package's,
bit for bit (``==``, float64), on the CPU.

The JAX package's four jitted decision kernels cannot load on this image,
so the reference here is its own jax-less path: ``repro.core.batched.HAVE_JAX``
patched to False sends every decision through the numpy twins (nothing in
the JAX package changes for that).  The port runs its float64 torch kernels
on ``device="cpu"``; the launch counts on the kernels show that they ran.
"""
from dataclasses import fields

import numpy as np
import pytest
import torch

import repro.core.batched as ref_batched
import repro.core.cluster as ref_cluster
import repro.core.dag as ref_dag
import repro.core.interference as ref_interference
import repro.core.orchestrator as ref_orchestrator
import repro.core.policy as ref_policy
import repro.sim as ref_sim
import repro_torch.core.batched as batched
import repro_torch.core.cluster as port_cluster
import repro_torch.core.dag as port_dag
import repro_torch.core.interference as port_interference
import repro_torch.core.orchestrator as port_orchestrator
import repro_torch.core.policy as port_policy
import repro_torch.sim as port_sim
from repro_torch.core.convert import batch_from_numpy, snapshot_from_numpy

GB, MB = 1e9, 1e6
CPU = torch.device("cpu")
SCHEMES = ("ibdash", "random", "round_robin", "lavea", "petrel", "lats",
           "tier_escalation", "churn_aware")
# the policies whose decide_batch runs a decision kernel, and its kernels
KERNELS_OF = {
    "ibdash": ("select_queue", "ibdash_scan_kernel"),
    "churn_aware": ("select_queue", "ibdash_scan_kernel"),
    "lavea": ("lavea_kernel",),
    "round_robin": ("round_robin_kernel",),
    "tier_escalation": ("tier_escalation_kernel",),
}


@pytest.fixture(autouse=True)
def reference_numpy_path(monkeypatch):
    """The JAX package decides through its numpy twins."""
    monkeypatch.setattr(ref_batched, "HAVE_JAX", False)


@pytest.fixture
def launches():
    """Reset the port's decision-kernel counts; read them by kernel name."""
    for kern in batched.DECISION_KERNELS:
        kern.launches = 0
    return lambda: {kern.__name__: kern.launches for kern in batched.DECISION_KERNELS}


# -- building the same inputs in both packages ----------------------------------
def small_cluster(pkg_cluster, pkg_interference, n, seed, lam=5e-2, **kw):
    """A fleet of ``n`` devices with a random interference table, as the
    JAX package's batched-policy tests build it."""
    rng = np.random.default_rng(seed)
    model = pkg_interference.InterferenceModel(
        base=rng.uniform(0.05, 0.5, (n, 2)),
        slope=rng.uniform(0.01, 0.08, (n, 2, 2)),
    )
    devices = [pkg_cluster.Device(did=i, cls=i, mem_total=8 * GB, lam=lam,
                                  up_bw=100e6, down_bw=100e6) for i in range(n)]
    return pkg_cluster.ClusterState(devices=devices, model=model, horizon=120.0,
                                    dt=0.05, **kw)


def random_apps(pkg_dag, seed, n_apps):
    """Random DAGs of 1-5 tasks of two types with shared model ids."""
    rng = np.random.default_rng(seed)
    apps = []
    for i in range(n_apps):
        tasks = []
        for j in range(int(rng.integers(1, 6))):
            deps = tuple(f"t{k}#{i}" for k in range(j) if rng.random() < 0.4)
            tasks.append(pkg_dag.TaskSpec(
                f"t{j}#{i}", ttype=int(rng.integers(2)), deps=deps,
                out_bytes=float(rng.uniform(0, 20e6)),
                model_id=f"m{int(rng.integers(2))}" if rng.random() < 0.4 else None,
                model_bytes=float(rng.uniform(10e6, 200e6)),
                mem_bytes=float(rng.uniform(0, 1 * GB)),
            ))
        apps.append(pkg_dag.AppDAG.from_tasks(f"app{i}", tasks))
    return apps


def paper_apps(pkg_sim, B, seed=1):
    """B instances of the four paper apps and their arrival times over the
    1.5 s window (distinct times, so pools reach the kernels)."""
    rng = np.random.default_rng(seed)
    builders = list(pkg_sim.APP_BUILDERS.values())
    apps = [builders[int(rng.integers(len(builders)))]().relabel(f"#{i}")
            for i in range(B)]
    return apps, np.sort(rng.uniform(0.0, 1.5, B)).tolist()


def lats_model(pkg_policy, seed=0):
    rng = np.random.default_rng(seed)
    return pkg_policy.LaTSModel(
        base=rng.uniform(0.05, 0.5, (16, 2)), b=rng.uniform(0.1, 0.6, 16),
        cpu_usage=rng.uniform(0.1, 0.6, (16, 2)),
    )


def policy_kwargs(pkg_policy, lats=None):
    return dict(seed=3, alpha=0.4, beta=0.08, gamma=3, latency_budget=2.0,
                lats_model=lats or lats_model(pkg_policy))


def port_policy_for(name, lats=None):
    return port_policy.make_policy(
        name, device="cpu", **policy_kwargs(port_policy, lats))


def ref_policy_for(name, lats=None):
    return ref_policy.make_policy(name, **policy_kwargs(ref_policy, lats))


def batch_fields(batch):
    """A JAX-package BatchedPolicyContext as numpy fields keyed by name."""
    out = {f.name: getattr(batch, f.name) for f in fields(batch)}
    out["fleet"] = {f.name: getattr(batch.fleet, f.name) for f in fields(batch.fleet)}
    return out


class Recorder:
    """Wraps a JAX-package policy: records every wave-stage context it is
    asked to decide and the decisions it gave."""

    def __init__(self, policy):
        self.policy, self.seen = policy, []

    def decide_batch(self, batch):
        dec = self.policy.decide_batch(batch)
        self.seen.append((batch, dec.devices))
        return dec


def same_plan(a, b):
    """Two plans (one from each package) place every task the same way,
    estimates included."""
    assert (a.feasible, a.infeasible_task, a.est_latency) == (
        b.feasible, b.infeasible_task, b.est_latency)
    assert set(a.tasks) == set(b.tasks)
    for name, ta in a.tasks.items():
        tb = b.tasks[name]
        assert (ta.ttype, ta.est_start, ta.est_latency) == (tb.ttype, tb.est_start,
                                                            tb.est_latency)
        assert [(r.did, r.est_exec, r.est_upload, r.est_transfer, r.pred_fail)
                for r in ta.replicas] == [
            (r.did, r.est_exec, r.est_upload, r.est_transfer, r.pred_fail)
            for r in tb.replicas]


# -- the decision functions -------------------------------------------------------
@pytest.mark.parametrize("n_devices", [24, 300])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_decide_batch_equals_reference_and_scalar_decide(scheme, n_devices, launches):
    """One reference wave context, fed to both packages: the port's
    decide_batch on the CPU == the reference's numpy decide_batch == the
    port's scalar decide looped over the rows.  D=300 is above
    TOPK_PRUNE_MIN_DEVICES, so the reference takes its partial selection."""
    profile = ref_sim.make_profile(seed=0)
    cluster = ref_sim.make_cluster(profile, scenario="mix", n_devices=n_devices, seed=0)
    apps, times = paper_apps(ref_sim, B=24)
    rec = Recorder(ref_policy_for(scheme, profile.lats_model))
    ref_orchestrator.orchestrate_batch(apps, cluster, rec, times=times)
    lats = port_sim.make_profile(seed=0, device="cpu").lats_model
    port_b, port_s = port_policy_for(scheme, lats), port_policy_for(scheme, lats)
    assert len(rec.seen) >= 3
    for batch, want in rec.seen:
        pb = batch_from_numpy(batch_fields(batch))
        assert port_b.decide_batch(pb).devices == want
        assert tuple(port_s.decide(pb.row(b)).devices for b in range(pb.n_rows)) == want
    for name in KERNELS_OF.get(scheme, ()):
        assert launches()[name] > 0, name
    if scheme not in KERNELS_OF:
        assert not any(launches().values())


def tie_heavy(seed, B, D):
    """Quantised totals (ties everywhere), +inf-free, 10% infeasible."""
    rng = np.random.default_rng(seed)
    total = rng.choice(np.linspace(0.1, 2.0, 12), size=(B, D))
    pf = rng.uniform(0.0, 0.9, size=(B, D))
    feasible = rng.uniform(size=(B, D)) > 0.1
    feasible[3] = False
    return total, pf, feasible


@pytest.mark.parametrize("gamma,beta", [(2, 0.25), (3, 0.0), (0, 0.1)])
def test_ibdash_decide_batch_tie_heavy_1000_devices(gamma, beta, launches):
    """B=32, D=1000 with quantised totals: the device queue's stable sort
    keeps the lowest device ids on ties, as the reference's partial
    selection does; equal to the scalar rule row by row too."""
    total, pf, feasible = tie_heavy(7, 32, 1000)
    args = (total, pf, feasible, 0.5, beta, gamma)
    got = batched.ibdash_decide_batch(*args, device=CPU)
    assert got == ref_batched.ibdash_decide_batch(*args)
    pol = port_policy.make_policy("ibdash", device="cpu", alpha=0.5, beta=beta, gamma=gamma)
    assert got == [pol._score(total[b], pf[b], feasible[b]) for b in range(32)]
    assert launches()["select_queue"] == 1 and launches()["ibdash_scan_kernel"] == 1


def test_other_decide_batches_tie_heavy(launches):
    """lavea, round robin and tier escalation on tie-heavy inputs (B=32,
    D=1000) equal the reference's numpy branches."""
    total, _, feasible = tie_heavy(11, 32, 1000)
    queue = np.floor(total * 2)
    tiers = np.random.default_rng(2).integers(0, 3, 1000)
    assert batched.lavea_decide_batch(queue, feasible, CPU) == \
        ref_batched.lavea_decide_batch(queue, feasible)
    assert batched.round_robin_decide_batch(feasible, 12345, CPU) == \
        ref_batched.round_robin_decide_batch(feasible, 12345)
    for budget in (0.2, 1.0, np.inf):
        assert batched.tier_escalation_decide_batch(total, feasible, tiers, budget, CPU) == \
            ref_batched.tier_escalation_decide_batch(total, feasible, tiers, budget)
    assert launches()["lavea_kernel"] == 1 and launches()["round_robin_kernel"] == 1
    assert launches()["tier_escalation_kernel"] == 3


def test_select_queue_is_the_stable_argsort():
    """The device queue equals numpy's stable argsort (and the reference's
    partial selection above 256 devices) on rows of few distinct values."""
    rng = np.random.default_rng(3)
    for D in (5, 300):
        m = rng.choice([0.25, 0.5, 0.5, 1.0, np.inf], size=(9, D))
        for k in (1, 2, 5, D):
            got = batched.select_queue(torch.from_numpy(m), k).numpy()
            assert np.array_equal(got, np.argsort(m, axis=1, kind="stable")[:, :k])
            assert np.array_equal(got, batched.select_queue_plain(m, k))


@pytest.mark.parametrize("G,D", [(8, 24), (33, 300), (64, 2)])
def test_decision_kernels_equal_plain_versions(G, D):
    """Each kernel on CPU tensors equals its plain numpy version exactly,
    rows all +inf and wholly infeasible rows included."""
    rng = np.random.default_rng(G + D)
    total = rng.integers(1, 6, (G, D)).astype(np.float64)
    total[rng.random((G, D)) < 0.05] = np.inf
    total[1] = np.inf
    feasible = rng.random((G, D)) < 0.8
    feasible[0] = False
    pf, tiers = rng.random((G, D)), rng.integers(0, 3, D)
    sizes = feasible.sum(axis=1)
    targets = np.where(sizes > 0, (5 + np.arange(G)) % np.maximum(sizes, 1), 0)
    t = torch.from_numpy
    k = min(3 + 1, D - 1) + 1
    masked = np.where(feasible, total, np.inf)
    order = batched.select_queue(t(masked), k).numpy()
    assert np.array_equal(order, batched.select_queue_plain(masked, k))
    s_total, s_pf = np.take_along_axis(total, order, 1), np.take_along_axis(pf, order, 1)
    with np.errstate(invalid="ignore"):
        want = batched.ibdash_scan_plain(s_total, s_pf, sizes, 0.5, 0.1, 3)
    got = batched.ibdash_scan_kernel(t(s_total), t(s_pf), t(sizes), 0.5, 0.1, 3)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(batched.lavea_kernel(t(total), t(feasible)).numpy(),
                          batched.lavea_plain(total, feasible))
    assert np.array_equal(batched.round_robin_kernel(t(feasible), t(targets)).numpy(),
                          batched.round_robin_plain(feasible, targets))
    assert np.array_equal(
        batched.tier_escalation_kernel(t(total), t(feasible), t(tiers), 3.0, 3).numpy(),
        batched.tier_escalation_plain(total, feasible, tiers, 3.0, 3))


def near_tie_scan_inputs(seed, G, K, alpha):
    """Sorted queue columns whose first replica candidate sits at the exact
    tie of Algorithm 1's line 34, ``w_new == w_s`` in exact arithmetic, so
    only the rounding of the four float64 operations decides: any fused
    multiply-add, reordering or changed constant flips some rows."""
    rng = np.random.default_rng(seed)
    best = rng.uniform(0.5, 3.0, G)
    ratio = 1 + rng.integers(1, 20, (G, K - 1)) / 64
    comb0 = rng.uniform(0.3, 0.9, G)
    pf1 = 1 - alpha * (ratio[:, 0] - 1) / ((1 - alpha) * comb0)
    s_total = np.concatenate([best[:, None], best[:, None] * ratio], axis=1)
    s_pf = np.concatenate([comb0[:, None], pf1[:, None], rng.uniform(0, 1, (G, K - 2))], axis=1)
    return s_total, np.clip(s_pf, 0.0, 1.0), np.full(G, K)


@pytest.mark.parametrize("alpha", [0.3, 0.5, 0.7])
def test_scan_kernel_rounds_as_numpy_at_exact_ties(alpha):
    """At line 34's exact ties the scan kernel's accepts equal numpy's,
    step by step: the weight update is four separate IEEE operations."""
    s_total, s_pf, n_feas = near_tie_scan_inputs(int(alpha * 10), 4096, 5, alpha)
    want = batched.ibdash_scan_plain(s_total, s_pf, n_feas, alpha, 0.1, 3)
    assert 0 < want[:, 0].sum() < len(want)       # both outcomes occur at the tie
    t = torch.from_numpy
    got = batched.ibdash_scan_kernel(t(s_total), t(s_pf), t(n_feas), alpha, 0.1, 3)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_devices,n_apps,seed", [(2, 4, 0), (1, 3, 1), (7, 10, 2)])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_random_fleets_batched_scalar_and_reference(scheme, n_devices, n_apps, seed):
    """Random fleets and DAGs: the port's batched plans == its scalar
    (batched=False) plans == the reference's numpy plans.  (2, 4, 0) with
    ibdash is the case the reference's property test recorded."""
    lam = float(np.random.default_rng(seed).uniform(1e-4, 0.5))
    times = list(np.random.default_rng(seed + 9).uniform(0.0, 2.0, n_apps))
    lats_p, lats_r = lats_model(port_policy), lats_model(ref_policy)
    port_c = small_cluster(port_cluster, port_interference, n_devices, seed, lam, device="cpu")
    ref_c = small_cluster(ref_cluster, ref_interference, n_devices, seed, lam)
    port_apps, ref_apps = random_apps(port_dag, seed, n_apps), random_apps(ref_dag, seed, n_apps)
    got = port_orchestrator.orchestrate_batch(
        port_apps, port_c, port_policy_for(scheme, lats_p), times=times)
    scalar = port_orchestrator.orchestrate_batch(
        port_apps, port_c, port_policy_for(scheme, lats_p), times=times, batched=False)
    want = ref_orchestrator.orchestrate_batch(
        ref_apps, ref_c, ref_policy_for(scheme, lats_r), times=times)
    for a, b, c in zip(got, scalar, want):
        same_plan(a, b)
        same_plan(a, c)


# -- waves through orchestrate_batch ----------------------------------------------
@pytest.mark.parametrize("scenario", ["mix", "multi_tier"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_orchestrate_batch_plans_equal_reference(scheme, scenario, launches):
    """A wave of 24 paper apps on the mix and multi_tier fleets: the port's
    plans (its kernels on the CPU) == the reference's numpy plans, and the
    kernel-backed policies launched their kernels."""
    port_p = port_sim.make_profile(seed=0, device="cpu")
    ref_p = ref_sim.make_profile(seed=0)
    port_c = port_sim.make_cluster(port_p, scenario=scenario, n_devices=40, seed=0)
    ref_c = ref_sim.make_cluster(ref_p, scenario=scenario, n_devices=40, seed=0)
    port_apps, times = paper_apps(port_sim, B=24)
    ref_apps, _ = paper_apps(ref_sim, B=24)
    got = port_orchestrator.orchestrate_batch(
        port_apps, port_c, port_policy_for(scheme, port_p.lats_model), times=times)
    want = ref_orchestrator.orchestrate_batch(
        ref_apps, ref_c, ref_policy_for(scheme, ref_p.lats_model), times=times)
    assert len(got) == len(want) == 24
    for a, b in zip(got, want):
        same_plan(a, b)
    for name in KERNELS_OF.get(scheme, ()):
        assert launches()[name] > 0, name


def test_orchestrate_by_name_takes_the_cluster_device(launches):
    """A policy given by name is built on the cluster's device (or the
    call's); an instance keeps its own, and then ``device`` is refused."""
    p = port_sim.make_profile(seed=0, device="cpu")
    c = port_sim.make_cluster(p, scenario="mix", n_devices=30, seed=0)
    assert c.device == CPU
    apps, times = paper_apps(port_sim, B=16)
    by_cluster = port_orchestrator.orchestrate_batch(apps, c, "ibdash", times=times)
    by_call = port_orchestrator.orchestrate_batch(apps, c, "ibdash", times=times, device="cpu")
    for a, b in zip(by_cluster, by_call):
        same_plan(a, b)
    assert launches()["ibdash_scan_kernel"] > 0
    with pytest.raises(ValueError, match="device"):
        port_orchestrator.orchestrate(apps[0], c, 0.0, port_policy_for("ibdash"), device="cpu")


# -- the fleet and its snapshots --------------------------------------------------
@pytest.mark.parametrize("scenario", ["mix", "ced", "ped", "churn", "correlated_churn",
                                      "multi_tier"])
def test_make_cluster_and_snapshot_leaves_equal_reference(scenario):
    """make_profile and make_cluster build the same fleet from the seed: all
    17 snapshot leaves equal, before and after a plan is applied, and with
    a churn forecast installed."""
    port_p = port_sim.make_profile(seed=4, device="cpu")
    ref_p = ref_sim.make_profile(seed=4)
    assert np.array_equal(port_p.interference.base, ref_p.interference.base)
    assert np.array_equal(port_p.interference.slope, ref_p.interference.slope)
    assert np.array_equal(port_p.lats_model.b, ref_p.lats_model.b)
    port_c = port_sim.make_cluster(port_p, scenario=scenario, n_devices=30, seed=4)
    ref_c = ref_sim.make_cluster(ref_p, scenario=scenario, n_devices=30, seed=4)
    assert [d.alive_until for d in port_c.devices] == [d.alive_until for d in ref_c.devices]

    def same_leaves(t):
        a, b = port_c.snapshot(t), ref_c.snapshot(t)
        names = [f.name for f in fields(a)]
        assert names == [f.name for f in fields(b)] == list(batched.FLEET_SNAPSHOT_SCHEMA)
        for n in names:
            assert np.array_equal(getattr(a, n), getattr(b, n)), n
        again = snapshot_from_numpy({n: getattr(b, n) for n in names})
        for n in names:
            assert np.array_equal(getattr(again, n), getattr(a, n)), n

    same_leaves(0.0)
    port_apps, times = paper_apps(port_sim, B=6)
    ref_apps, _ = paper_apps(ref_sim, B=6)
    for a, b in zip(
        port_orchestrator.orchestrate_batch(port_apps, port_c, "ibdash", times=times),
        ref_orchestrator.orchestrate_batch(ref_apps, ref_c, "ibdash", times=times),
    ):
        port_c.apply(a)
        ref_c.apply(b)
    assert np.array_equal(port_c.alloc, ref_c.alloc)
    same_leaves(1.0)
    port_sim.exponential_churn(port_c, horizon=60.0, seed=5).install(port_c)
    ref_sim.exponential_churn(ref_c, horizon=60.0, seed=5).install(ref_c)
    same_leaves(2.5)


def test_converters_refuse_wrong_fields():
    ref_c = ref_sim.make_cluster(ref_sim.make_profile(seed=0), n_devices=5)
    leaves = {f.name: getattr(ref_c.snapshot(0.0), f.name) for f in fields(batched.FleetSnapshot)}
    assert snapshot_from_numpy(leaves).n_devices == 5
    with pytest.raises(ValueError, match="missing"):
        snapshot_from_numpy({k: v for k, v in leaves.items() if k != "alive"})
    with pytest.raises(ValueError, match="unknown"):
        batch_from_numpy({"tasks": (), "extra": 1})


# -- registries and devices -------------------------------------------------------
def test_registries_are_the_ports_own():
    assert port_policy.available_policies() == ref_policy.available_policies() == SCHEMES

    @port_policy.register_policy("port_only_probe")
    class Probe(port_policy.Policy):
        def decide(self, ctx):
            return port_policy.TaskDecision(devices=())

    try:
        assert "port_only_probe" in port_policy.available_policies()
        assert "port_only_probe" not in ref_policy.available_policies()
    finally:
        del port_policy._REGISTRY["port_only_probe"]


def test_placement_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    from repro_torch import api

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.make_profile(seed=0)
    profile = api.make_profile(seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.make_cluster(profile, device="cuda")
    cluster = api.make_cluster(profile, n_devices=12)
    app = port_sim.video_app()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.orchestrate(app, cluster, 0.0, "ibdash", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.orchestrate_batch([app], cluster, "lavea", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.Orchestrator(cluster, "ibdash", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.make_policy("ibdash")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.run_one("ibdash", api.SimConfig(n_cycles=1, instances_per_cycle=5, n_devices=8))
    assert api.orchestrate(app, cluster, 0.0, "ibdash").feasible
    assert api.make_policy("round_robin", device="cpu").device == CPU
