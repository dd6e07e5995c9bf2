"""The port's options for Moonlight-16B-A3B (DeepSeek-V3's layer without a
q-LoRA) at a small size on the CPU, seeded: MLA with one query product and
``norm_eps`` against the benchmark's plain reference
(``port_bench/reference/moe.py``), the router's selection bias and routed
scaling, the ``dropless`` expert route against ``einsum``, an engine's
prefill and decode through the spliced cache against the reference's
full forward, the expert-load counter, the layer spans, and the defaults
leaving the registered MoE architectures bit for bit as the routes they
had compute them.  The port's options sit at their defaults in every
architecture of the JAX registry.

On a card (``-m cuda``): a Moonlight-shaped model's decode step, captured
and replayed by the engine, gives bit for bit the eager step's logits, and
each replay adds its claims to the counter.  This file imports neither JAX
nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_dropless.py
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from port_bench.reference import moe as ref
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import ops
from repro_torch.models import LM, reduced
from repro_torch.models import moe
from repro_torch.models import transformer
from repro_torch.models.attention import mla_apply, mla_init
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig
from repro_torch.models.layers import norm_apply
from repro_torch.obs import runtime
from repro_torch.serve.engine import ServingEngine

MOE = MoEConfig(n_experts=8, n_shared_experts=2, top_k=3, d_expert=32, n_dense_layers=1,
                router_act="sigmoid", router_bias=True, routed_scaling=2.446, dispatch="dropless")
MLA = MLAConfig(q_lora_rank=None, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16)
CFG = ModelConfig(name="moonlight-tiny", family="moe", n_layers=3, d_model=64, n_heads=4,
                  n_kv_heads=4, head_dim=16, d_ff=96, vocab=300, norm_eps=1e-5,
                  rope_theta=50000.0, attention="mla", dtype="float32", mla=MLA, moe=MOE)
# float32 on the CPU: the port and the reference differ only in summation order
TOL = dict(atol=2e-5, rtol=2e-5)


def _model_dict(cfg):
    """A configuration's ``model`` group, as ``port_bench`` hands it to the
    reference."""
    return dataclasses.asdict(cfg)


def _params(cfg, seed=0):
    """The port's weights with a router bias N(0, 0.3^2), large enough to
    change the choice of experts at this size."""
    lm = LM(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(seed))
    for seg in params["segments"]:
        bias = seg["ffn"].get("router", {}).get("bias")
        if bias is not None:
            bias.copy_(torch.randn(bias.shape, generator=torch.Generator().manual_seed(seed + 1))
                       * 0.3)
    return lm, params


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _x(*shape, seed=3):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


# -- MLA ------------------------------------------------------------------------------
def test_mla_without_q_lora_matches_the_reference():
    """One MLA layer, its queries through one product, eps 1e-5, against the
    reference's expanded MLA."""
    cfg = CFG
    p = mla_init(torch.Generator().manual_seed(5), cfg, torch.device("cpu"))
    assert "wq" in p and not {"wdq", "q_norm", "wuq"} & set(p)
    # the norm's scale away from 1, so that a wrong eps or a missing norm shows
    p["kv_norm"]["scale"].copy_(1.0 + 0.5 * _x(*p["kv_norm"]["scale"].shape, seed=6))
    x = _x(2, 11, cfg.d_model) * 3.0
    pos = torch.arange(11).expand(2, 11)
    got, _ = mla_apply(cfg, p, x, pos)
    m = _model_dict(cfg)
    for b in range(2):
        want = ref.mla(m, p, x[b], pos[b], torch.matmul)
        torch.testing.assert_close(got[b], want, **TOL)
    # the eps is read: another one moves the output
    other, _ = mla_apply(dataclasses.replace(cfg, norm_eps=1e-1), p, x, pos)
    assert not torch.allclose(other, got, **TOL)


def test_norm_eps_is_read_by_the_model_norms():
    cfg = dataclasses.replace(CFG, norm_eps=0.5)
    x = _x(3, cfg.d_model) * 0.1
    p = {"scale": torch.ones(cfg.d_model)}
    want = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 0.5)
    torch.testing.assert_close(norm_apply(cfg, p, x), want, **TOL)
    assert ModelConfig().norm_eps == 1e-6


# -- the router -------------------------------------------------------------------------
def test_biased_router_chooses_by_score_plus_bias_and_gates_by_score():
    lm, params = _params(CFG)
    p = _layer(params["segments"][1]["ffn"], 0)
    x = _x(40, CFG.d_model)
    gates, idx, probs = moe._router(CFG, p, x)
    s = torch.sigmoid(x @ p["router"]["w"])
    choice = s + p["router"]["bias"]
    want_idx = torch.topk(choice, CFG.moe.top_k, dim=-1).indices
    assert torch.equal(idx.sort(-1).values, want_idx.sort(-1).values)
    g = s.gather(1, idx)
    torch.testing.assert_close(gates, g / g.sum(-1, keepdim=True) * 2.446, **TOL)
    torch.testing.assert_close(probs, s, **TOL)
    # the bias changed some choices here: by the scores alone they differ
    plain = torch.topk(s, CFG.moe.top_k, dim=-1).indices
    assert not torch.equal(plain.sort(-1).values, want_idx.sort(-1).values)
    assert torch.allclose(gates.sum(-1), torch.full((40,), 2.446), atol=1e-5)


# -- the dropless route -----------------------------------------------------------------
@pytest.mark.parametrize("T", [1, 24, 64])
def test_dropless_equals_einsum_where_nothing_drops(T):
    lm, params = _params(CFG)
    p = _layer(params["segments"][1]["ffn"], 0)
    x = _x(1, T, CFG.d_model, seed=T)
    roomy = dataclasses.replace(CFG, moe=dataclasses.replace(MOE, capacity_factor=100.0))
    loads = {r: torch.zeros(MOE.n_experts, dtype=torch.int64) for r in ("dropless", "einsum")}
    outs = {r: moe.moe_apply(roomy, p, x, dispatch=r, load=loads.get(r))[0]
            for r in ("dropless", "einsum", "sort")}
    torch.testing.assert_close(outs["dropless"], outs["einsum"], **TOL)
    torch.testing.assert_close(outs["dropless"], outs["sort"], **TOL)
    # the counter: each expert's claims on the dropless route, untouched on the others
    idx = moe._router(roomy, p, x.reshape(T, -1))[1]
    assert torch.equal(loads["dropless"], torch.bincount(idx.reshape(-1), minlength=8))
    assert int(loads["dropless"].sum()) == T * MOE.top_k and not loads["einsum"].any()


def test_dropless_differs_from_einsum_where_einsum_drops():
    """A bias that sends every token to expert 0: at capacity 1.25 the
    ``einsum`` route drops claims and its output moves; the dropless route
    computes all (its counter: every token at expert 0) and matches the
    reference token by token."""
    lm, params = _params(CFG)
    p = _layer(params["segments"][1]["ffn"], 0)
    p["router"]["bias"] = torch.zeros(MOE.n_experts)
    p["router"]["bias"][0] = 10.0
    T = 32
    x = _x(1, T, CFG.d_model)
    load = torch.zeros(MOE.n_experts, dtype=torch.int64)
    y = {r: moe.moe_apply(CFG, p, x, dispatch=r, load=load)[0] for r in ("dropless", "einsum")}
    assert int(load.sum()) == T * MOE.top_k and int(load[0]) == T
    assert not torch.allclose(y["dropless"], y["einsum"], **TOL)
    m = _model_dict(CFG)
    want = torch.stack([ref.moe_layer(m, p, x[0, t:t + 1], torch.matmul)[0] for t in range(T)])
    torch.testing.assert_close(y["dropless"][0], want, **TOL)


# -- the engine against the reference -----------------------------------------------------
def test_engine_prefill_and_decode_match_the_reference():
    """Three requests through two slots (a slot reused): each served token's
    logit against the reference's full forward over prompt and served
    tokens; with these weights every served token is the reference's best
    (the gap below its best is rounding), and the counter holds every
    token's claims."""
    lm, params = _params(CFG, seed=11)
    eng = ServingEngine(lm, params, max_batch=2, max_seq=48)
    rng = np.random.default_rng(4)
    reqs = [("a", rng.integers(0, CFG.vocab, 13), 6), ("b", rng.integers(0, CFG.vocab, 5), 9),
            ("c", rng.integers(0, CFG.vocab, 20), 4)]
    pending, done, tokens = list(reqs), {}, 0
    load0 = lm.expert_load.clone()
    while len(done) < len(reqs):
        while pending and eng.free_slots():
            rid, prompt, n = pending.pop(0)
            eng.add_request(rid, prompt, n)
            tokens += len(prompt)
        done.update(eng.step())
        tokens += eng.max_batch
    claims = (lm.expert_load - load0).sum(dim=1)
    assert claims.tolist() == [tokens * MOE.top_k] * (CFG.n_layers - MOE.n_dense_layers)
    m = _model_dict(CFG)
    ref.exact_matmul()
    w = ref.head(m, params)
    for rid, prompt, n in reqs:
        served = done[rid]
        assert len(served) == n + 1
        seq = torch.as_tensor(np.concatenate([prompt, served[:-1]]))
        h = ref.hidden_states(m, params, [seq], [len(prompt) - 1])[0]
        gaps = ref.logit_gaps(w, h, torch.as_tensor(served))
        assert float(gaps.max()) < 1e-4, (rid, gaps)


def test_reference_hidden_states_match_a_per_token_moe():
    """The reference computes its experts over every sequence's tokens at
    once: the same as its MoE token by token, and a sequence alone the same
    as beside another."""
    lm, params = _params(CFG, seed=2)
    m = _model_dict(CFG)
    a, b = torch.arange(7) * 11 % CFG.vocab, torch.arange(12) * 5 % CFG.vocab
    both = ref.hidden_states(m, params, [a, b], [0, 3])
    alone = ref.hidden_states(m, params, [b], [3])[0]
    torch.testing.assert_close(both[1], alone, **TOL)
    p = ref.layer_weights(m, params, 1)
    h = _x(9, CFG.d_model)
    whole = ref.moe_layer(m, p["ffn"], h, torch.matmul)
    each = torch.cat([ref.moe_layer(m, p["ffn"], h[t:t + 1], torch.matmul) for t in range(9)])
    torch.testing.assert_close(whole, each, **TOL)


# -- spans ----------------------------------------------------------------------------------
def test_profile_records_a_span_per_mla_and_moe_layer():
    lm, params = _params(CFG)
    eng = ServingEngine(lm, params, max_batch=2, max_seq=32)
    runtime.disable()
    runtime.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        eng.add_request("r0", list(range(9)), 10)
        eng.step()
    spans = runtime.profile_spans()
    ids = {s.attrs["id"]: s for s in spans}
    under = {}
    for s in spans:
        if s.kind in ("model.mla", "model.moe"):
            under.setdefault((s.kind, ids[s.attrs["parent"]].kind), []).append(s)
    n_moe = CFG.n_layers - MOE.n_dense_layers
    assert {k: len(v) for k, v in under.items()} == {
        ("model.mla", "model.prefill"): CFG.n_layers, ("model.moe", "model.prefill"): n_moe,
        ("model.mla", "model.decode_step"): CFG.n_layers,
        ("model.moe", "model.decode_step"): n_moe}
    assert not any(s.kind == "model.backbone" for s in spans)     # eager: no replay
    runtime.drain()


# -- the defaults ---------------------------------------------------------------------------
def _router_as_before(cfg, p, x2d):
    """The router the JAX package has (and the port had before its options):
    softmax or sigmoid, the top k of a stable sort, gates renormalised."""
    logits = x2d.to(torch.float32) @ p["router"]["w"].to(torch.float32)
    probs = torch.sigmoid(logits) if cfg.moe.router_act == "sigmoid" else torch.softmax(
        logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :cfg.moe.top_k], idx[:, :cfg.moe.top_k]
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    return gates.to(x2d.dtype), idx, probs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "qwen2-moe-a2.7b"])
def test_defaults_leave_registered_moe_archs_bit_for_bit(arch, dtype, monkeypatch):
    """A prefill and three decode steps of the reduced model, against the
    same with the routes it had: the router without a bias or scaling, MLA's
    prefill over every cache slot, the norms at eps 1e-6."""
    cfg = reduced(get_config(arch), dtype=dtype)
    lm = LM(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab, (1, 19), generator=torch.Generator().manual_seed(1))

    def run():
        caches = lm.init_cache(1, 40)
        logits, caches = lm.prefill(params, {"tokens": prompt}, caches)
        out = [logits]
        pos = torch.tensor([prompt.shape[1]], dtype=torch.int32)
        for _ in range(3):
            logits, caches = lm.decode_step(params, logits.argmax(-1), pos, caches)
            out.append(logits)
            pos = pos + 1
        return torch.cat(out)

    now = run()
    monkeypatch.setattr(moe, "_router", _router_as_before)
    monkeypatch.setattr(transformer, "mla_apply",
                        lambda *a, **k: mla_apply(*a, **{**k, "gapless": False}))
    monkeypatch.setattr(transformer, "norm_apply",
                        lambda c, p, x, eps=None: norm_apply(c, p, x, eps=1e-6))
    assert torch.equal(now, run())


@pytest.mark.parametrize("arch", ARCHS)
def test_port_options_sit_at_their_defaults_in_the_registry(arch):
    for cfg in (get_config(arch), reduced(get_config(arch))):
        assert cfg.norm_eps == 1e-6
        if cfg.moe is not None:
            assert (cfg.moe.router_bias, cfg.moe.routed_scaling) == (False, 1.0)
            assert cfg.moe.dispatch in ("einsum", "sort")
        if cfg.mla is not None:
            assert cfg.mla.q_lora_rank


def test_param_count_without_q_lora_and_with_a_router_bias():
    lm, params = _params(CFG)
    leaves = [t for seg in params["segments"] for t in _flat(seg)]
    leaves += [params["embed"]["embedding"], params["lm_head"]["w"]]
    # ModelConfig.param_count (the JAX package's arithmetic) leaves out MLA's kv_norm
    # and the final norm; it counts the router's bias where there is one
    kv_norm = CFG.n_layers * MLA.kv_lora_rank
    assert sum(t.numel() for t in leaves) - kv_norm == CFG.param_count()


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    return [tree]


# -- on a card --------------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_clone(v) for v in tree]
    return None if tree is None else tree.clone()


@pytest.mark.cuda
def test_moonlight_shaped_step_is_replayed_with_the_eager_logits(cuda_device):
    """Moonlight's layer at reduced widths in bf16 (MLA without a q-LoRA, a
    biased sigmoid router, 2 shared experts, the dropless route): every
    step of the engine (eager, then captured, then replayed) against the
    eager step of a twin that cannot be captured, on a copy of the same
    state, bit for bit; each replay adds the step's claims to the counter."""
    cfg = dataclasses.replace(CFG, dtype="bfloat16", d_model=256, vocab=1024,
                              moe=dataclasses.replace(MOE, n_experts=16, top_k=6, d_expert=128))
    lm = LM(cfg, device=cuda_device)
    twin = LM(cfg, device=cuda_device, decode_fn=ops.decode_attention)
    params = lm.init(torch.Generator(device=cuda_device).manual_seed(3))
    eng = ServingEngine(lm, params, max_batch=4, max_seq=64)
    rng = np.random.default_rng(5)
    for i, n in enumerate((9, 17, 30)):
        eng.add_request(f"r{i}", rng.integers(0, cfg.vocab, n), 40)
    steps = 0
    for _ in range(8):
        want = twin.decode_step(params, eng.tokens.clone(), eng.pos.clone(),
                                _clone(eng.caches))[0]
        load0 = lm.expert_load.clone()
        got = eng._decode().clone()
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"step {steps}"
        claims = (lm.expert_load - load0).sum(dim=1)
        assert claims.tolist() == [eng.max_batch * 6] * (cfg.n_layers - 1)
        eng.tokens.copy_(got.argmax(-1))
        eng.pos += 1
        steps += 1
    assert (eng.captures, eng.replays) == (1, 7)
