"""The port's mixture of experts (``repro_torch.models.moe``) and the four
configs of slice 4's first part held against the JAX package: the router
(softmax and sigmoid, exact ties), both dispatch routes with and without
capacity drops, the aux loss, ``moe_apply`` with shared experts, the
weight conversion, reduced ``qwen2-moe-a2.7b`` and ``deepseek-v3-671b``
(loss, prefill and decode logits, greedy tokens of both engines) and
reduced ``olmo-1b`` and ``command-r-plus-104b``.

Inputs are made with numpy from a seed and handed to both sides; the JAX
weights are carried across with ``params_from_jax``.  Everything runs in
float32 on the CPU and is compared at 5e-4 unless noted; router indices,
the claims each token keeps and greedy tokens are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jax_moe
from repro.configs import get_config as jax_get_config
from repro.models import LM as JaxLM
from repro.models import reduced as jax_reduced
from repro.serve.engine import ServingEngine as JaxServingEngine

import repro_torch.models.moe as moe
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.launch.serve import serve_demo
from repro_torch.models import LM, params_from_jax, reduced
from repro_torch.serve.engine import ServingEngine

from _torch_config import assert_same_config

TOL = dict(atol=5e-4, rtol=5e-4)
MOE_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v3-671b")
SLICE_ARCHS = ("olmo-1b", "command-r-plus-104b") + MOE_ARCHS


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_config_matches_jax_full_and_reduced(arch):
    assert arch in ARCHS
    assert_same_config(get_config(arch), jax_get_config(arch))
    assert_same_config(reduced(get_config(arch)), jax_reduced(jax_get_config(arch)))
    if arch == "qwen2-moe-a2.7b":   # the full-width model the card serves
        assert get_config(arch).param_count() == 14_315_732_992
        assert get_config(arch).moe.capacity_factor == 1.25


# -- the layer ------------------------------------------------------------------------
@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_pair(request):
    """(JAX cfg, JAX layer params, port cfg, port layer params)."""
    jcfg = jax_reduced(jax_get_config(request.param))
    cfg = reduced(get_config(request.param))
    jp = jax_moe.moe_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _x(T, d, seed):
    return np.random.default_rng(seed).standard_normal((T, d)).astype(np.float32)


def test_router_matches_jax(moe_pair):
    jcfg, jp, cfg, p = moe_pair
    x = _x(40, cfg.d_model, 1)
    jg, ji, jprobs = jax_moe._router(jcfg, jp, jnp.asarray(x))
    g, i, probs = moe._router(cfg, p, _t(x))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(_np(g), np.asarray(jg), **TOL)
    np.testing.assert_allclose(_np(probs), np.asarray(jprobs), **TOL)


def test_router_breaks_exact_ties_to_the_lower_index(moe_pair):
    """Integer weights and inputs make the logits exact in any summation
    order; some router columns are equal, so those experts tie in every row
    and both frameworks must pick the lower index first."""
    jcfg, jp, cfg, _ = moe_pair
    rng = np.random.default_rng(2)
    E = cfg.moe.n_experts
    w = rng.integers(-2, 3, (cfg.d_model, E)).astype(np.float32)
    w[:, 5] = w[:, 2]
    w[:, 7] = w[:, 0] = w[:, 4]
    x = rng.integers(-1, 2, (64, cfg.d_model)).astype(np.float32)
    jg, ji, _ = jax_moe._router(jcfg, {"router": {"w": jnp.asarray(w)}}, jnp.asarray(x))
    g, i, probs = moe._router(cfg, {"router": {"w": _t(w)}}, _t(x))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(_np(g), np.asarray(jg), **TOL)
    # the ties are real: in some rows the k-th and (k+1)-th choices tie, so
    # the tie decides which expert is taken
    ranked = probs.sort(dim=1, descending=True).values
    K = cfg.moe.top_k
    assert bool((ranked[:, K - 1] == ranked[:, K]).any())


def _identity_experts(cfg, experts, xe):
    return xe


def _kept_gate_sums(y, x):
    """With identity experts ``y[t] = (sum of t's kept gates) * x[t]``."""
    return (y * x).sum(-1) / (x * x).sum(-1)


@pytest.mark.parametrize("T", [40, 24])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_dispatch_matches_jax(moe_pair, monkeypatch, dispatch, capacity_factor, T):
    """T is no multiple of the reduced group size (16).  At capacity factor
    1.25 claims are dropped, at 8.0 none; the gate weight each token keeps
    (identity experts) equals the JAX route's, then the outputs with the
    experts' weights do."""
    jcfg, jp, cfg, p = moe_pair
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             capacity_factor=capacity_factor))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           capacity_factor=capacity_factor))
    x = _x(T, cfg.d_model, 3)
    jg, ji, _ = jax_moe._router(jcfg, jp, jnp.asarray(x))
    g, i, _ = moe._router(cfg, p, _t(x))
    jfn = getattr(jax_moe, f"_dispatch_{dispatch}")
    fn = getattr(moe, f"_dispatch_{dispatch}")

    def both():
        return fn(cfg, p, _t(x), g, i), jfn(jcfg, jp, jnp.asarray(x), jg, ji)

    y, jy = both()
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)

    monkeypatch.setattr(moe, "_expert_ffn", _identity_experts)
    monkeypatch.setattr(jax_moe, "_expert_ffn", _identity_experts)
    y, jy = both()
    kept = _kept_gate_sums(_np(y), x)
    jkept = _kept_gate_sums(np.asarray(jy), x)
    np.testing.assert_allclose(kept, jkept, atol=1e-5)
    full = _np(g).sum(-1)
    dropped = int((kept < full - 1e-3).sum())
    assert dropped == int((jkept < full - 1e-3).sum())
    assert (dropped > 0) == (capacity_factor == 1.25)


def test_aux_loss_matches_jax(moe_pair):
    jcfg, jp, cfg, p = moe_pair
    x = _x(48, cfg.d_model, 4)
    _, ji, jprobs = jax_moe._router(jcfg, jp, jnp.asarray(x))
    _, i, probs = moe._router(cfg, p, _t(x))
    E = cfg.moe.n_experts
    aux = moe._aux_loss(probs, i, E)
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(_np(aux), np.asarray(jax_moe._aux_loss(jprobs, ji, E)), **TOL)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_moe_apply_with_shared_experts_matches_jax(moe_pair, dispatch):
    jcfg, jp, cfg, p = moe_pair
    assert "shared" in p
    x = np.random.default_rng(5).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    y, aux = moe.moe_apply(cfg, p, _t(x), dispatch=dispatch)
    jy, jaux = jax_moe.moe_apply(jcfg, jp, jnp.asarray(x), dispatch=dispatch)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(aux), np.asarray(jaux), **TOL)


def test_params_from_jax_carries_the_moe_tree(moe_pair):
    _, jp, _, p = moe_pair
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(jax.tree.leaves(p)) > 0
    for path, leaf in flat:
        node = p
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and str(node.dtype)[6:] == str(leaf.dtype)
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


# -- the models -------------------------------------------------------------------------
@pytest.fixture(scope="module", params=SLICE_ARCHS)
def model_pair(request):
    jcfg = jax_reduced(jax_get_config(request.param))
    cfg = reduced(get_config(request.param))
    jparams = JaxLM(jcfg).init(jax.random.PRNGKey(8))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, LM(cfg, device="cpu"), params


def test_init_layout_matches_jax(model_pair):
    """The port's own init gives the JAX ``LM.init`` tree: same leaves,
    shapes and dtypes (the MoE segment's experts stacked over layers)."""
    jcfg, jparams, model, _ = model_pair
    params = model.init(torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jflat) == len(jax.tree.leaves(params))
    for path, leaf in jflat:
        node = params
        for key in path:
            node = node[key.idx if hasattr(key, "idx") else key.key]
        assert tuple(node.shape) == leaf.shape and str(node.dtype)[6:] == str(leaf.dtype)
        assert bool(torch.isfinite(node).all())


def test_loss_matches_jax(model_pair):
    jcfg, jparams, model, params = model_pair
    toks = np.random.default_rng(9).integers(0, jcfg.vocab, (2, 24))
    labels = np.roll(toks, -1, axis=1)
    jl, jm = JaxLM(jcfg).loss(jparams, {"tokens": jnp.asarray(toks, jnp.int32),
                                        "labels": jnp.asarray(labels, jnp.int32)})
    loss, metrics = model.loss(params, {"tokens": torch.from_numpy(toks),
                                        "labels": torch.from_numpy(labels)})
    for got, want in ((loss, jl), (metrics["xent"], jm["xent"]),
                      (metrics["moe_aux"], jm["moe_aux"])):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert (float(metrics["moe_aux"]) > 0) == (jcfg.family == "moe")


def test_prefill_and_decode_match_jax(model_pair):
    """Prefill of a batch of two into a cache, then greedy decode steps:
    logits at 5e-4, tokens equal, and the caches left behind."""
    jcfg, jparams, model, params = model_pair
    B, S, steps, C = 2, 20, 6, 40
    toks = np.random.default_rng(10).integers(0, jcfg.vocab, (B, S))
    jmodel = JaxLM(jcfg)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                            jmodel.init_cache(B, C))
    lg, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                               model.init_cache(B, C))
    np.testing.assert_allclose(_np(lg), np.asarray(jl), **TOL)
    for t in range(steps):
        nxt = jnp.argmax(jl, -1)
        np.testing.assert_array_equal(torch.argmax(lg, -1).numpy(), np.asarray(nxt))
        pos = np.full((B,), S + t, np.int32)
        jl, jc = jmodel.decode_step(jparams, nxt.astype(jnp.int32), jnp.asarray(pos), jc)
        lg, caches = model.decode_step(params, torch.from_numpy(np.array(nxt)),
                                       torch.from_numpy(pos), caches)
        np.testing.assert_allclose(_np(lg), np.asarray(jl), **TOL)
    for cache, jcache in zip(caches, jc):
        assert set(cache) == set(jcache)
        for key in cache:
            np.testing.assert_allclose(_np(cache[key]), np.asarray(jcache[key], np.float32),
                                       **TOL)


def _serve(engine, requests):
    pending, done = list(requests), {}
    while len(done) < len(requests):
        while pending and engine.free_slots():
            engine.add_request(*pending.pop(0))
        done.update(engine.step())
    return done


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engines_give_the_same_tokens(arch):
    """Six requests through two slots, so slots are reused and idle slots
    run on and claim expert capacity; with the same slots and order of
    requests the port's engine gives the JAX engine's greedy tokens."""
    jcfg = jax_reduced(jax_get_config(arch))
    jparams = JaxLM(jcfg).init(jax.random.PRNGKey(11))
    model = LM(reduced(get_config(arch)), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(12)
    reqs = [(f"req{i}", rng.integers(0, jcfg.vocab, n).tolist(), m)
            for i, (n, m) in enumerate([(12, 3), (5, 9), (12, 4), (20, 2), (5, 6), (12, 5)])]
    jax_out = _serve(JaxServingEngine(JaxLM(jcfg), jparams, max_batch=2, max_seq=32), reqs)
    out = _serve(ServingEngine(model, params, max_batch=2, max_seq=32), reqs)
    assert out == jax_out
    assert {rid: len(toks) for rid, toks in out.items()} == {r[0]: r[2] + 1 for r in reqs}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_demo_serves_the_moe_archs_on_cpu(arch):
    before = [flash_attention.launches, flash_decode.launches]
    out = serve_demo(arch, n_requests=6, max_batch=4, device="cpu")
    assert [flash_attention.launches, flash_decode.launches] == before
    assert len(out["outputs"]) == 6
    assert all(0 <= t < 512 for toks in out["outputs"].values() for t in toks)
    assert np.isfinite(out["interference"]).all()
