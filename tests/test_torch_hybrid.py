"""The port's hybrid family (``repro_torch``: the RG-LRU in
``models/recurrent.py``, the ``group`` segment in ``models/transformer.py``,
attention over a windowed ring cache) held against the JAX package on
reduced ``recurrentgemma-9b``: 2 groups of (rec, rec, attn), d_model 128,
lru_width 128, head_dim 32, MQA (4 query heads, 1 kv head), window 16.

Inputs are made with numpy from a seed and handed to both sides; the JAX
weights are carried across with ``params_from_jax``.  Everything runs in
float32 on the CPU: the RG-LRU at 1e-5, the model at 5e-4, greedy tokens
exactly.  The JAX ``ServingEngine`` splices a group's RG-LRU states along
the wrong axis (ROADMAP.md, "Known reference faults"), so the port's
engine is held against the JAX model's ``prefill`` and ``decode_step``
driven one request at a time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import LM as JaxLM
from repro.models import reduced as jax_reduced
from repro.models.recurrent import _block_diag_mm as jax_block_diag_mm
from repro.models.recurrent import _causal_conv as jax_causal_conv
from repro.models.recurrent import rglru_apply as jax_rglru_apply
from repro.models.recurrent import rglru_init as jax_rglru_init

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.launch.serve import serve_demo
from repro_torch.models import LM, params_from_jax, reduced
from repro_torch.models.recurrent import (_block_diag_mm, _causal_conv, linear_scan,
                                          rglru_apply, rglru_state)
from repro_torch.serve.engine import ServingEngine

from _torch_config import assert_same_config

ARCH = "recurrentgemma-9b"
RGLRU_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=5e-4, rtol=5e-4)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_config_matches_jax_full_and_reduced():
    assert ARCH in ARCHS
    assert_same_config(get_config(ARCH), jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    assert_same_config(cfg, jax_reduced(jax_get_config(ARCH)))
    assert (cfg.n_layers, cfg.recurrent.lru_width, cfg.head_dim, cfg.attn_window) == (6, 128,
                                                                                      32, 16)
    full = LM(get_config(ARCH), device="cpu")
    assert [(s.kind, s.n, s.n_rec, s.has_attn, s.window) for s in full.segments] == [
        ("group", 12, 2, True, 2048), ("group", 1, 2, False, 2048)]


# -- the RG-LRU block ------------------------------------------------------------------
@pytest.fixture(scope="module")
def rglru_pair():
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jp = jax_rglru_init(jax.random.PRNGKey(1), jcfg)
    # nonzero gate biases, so the test sees them
    rng = np.random.default_rng(2)
    jp = dict(jp, ba=jnp.asarray(rng.standard_normal(128) * 0.3, jnp.float32),
              bx=jnp.asarray(rng.standard_normal(128) * 0.3, jnp.float32),
              conv_b=jnp.asarray(rng.standard_normal(128) * 0.1, jnp.float32))
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _state(seed, B, cfg):
    rng = np.random.default_rng(seed)
    W, cw = cfg.recurrent.lru_width, cfg.recurrent.conv_width
    return {"conv": rng.standard_normal((B, cw - 1, W)).astype(np.float32),
            "h": rng.standard_normal((B, W)).astype(np.float32)}


@pytest.mark.parametrize("S,with_state", [(1, True), (37, True), (37, False), (64, True)])
def test_rglru_apply_matches_jax(rglru_pair, S, with_state):
    jcfg, jp, cfg, p = rglru_pair
    B = 2
    x = np.random.default_rng(3).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    st = _state(4, B, cfg) if with_state else None
    got, new = rglru_apply(cfg, p, _t(x), {k: _t(v) for k, v in st.items()} if st else None)
    want, jnew = jax_rglru_apply(jcfg, jp, jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in st.items()} if st else None)
    np.testing.assert_allclose(_np(got), np.asarray(want), **RGLRU_TOL)
    if with_state:
        assert new["h"].dtype == torch.float32
        for key in ("conv", "h"):
            np.testing.assert_allclose(_np(new[key]), np.asarray(jnew[key]), **RGLRU_TOL)
    else:
        assert new is None and jnew is None


def test_rglru_split_sequence_equals_whole(rglru_pair):
    """37 tokens through the state in two pieces (20, then 17) give the
    whole sequence's outputs and final state."""
    _, _, cfg, p = rglru_pair
    x = _t(np.random.default_rng(5).standard_normal((2, 37, cfg.d_model)))
    st0 = {k: v[0] for k, v in rglru_state(cfg, 2, 1, torch.device("cpu")).items()}
    whole, st_whole = rglru_apply(cfg, p, x, st0)
    a, st_a = rglru_apply(cfg, p, x[:, :20], st0)
    b, st_b = rglru_apply(cfg, p, x[:, 20:], st_a)
    np.testing.assert_allclose(_np(torch.cat([a, b], 1)), _np(whole), **RGLRU_TOL)
    for key in ("conv", "h"):
        np.testing.assert_allclose(_np(st_b[key]), _np(st_whole[key]), **RGLRU_TOL)


def test_block_diag_mm_and_causal_conv_match_jax(rglru_pair):
    _, jp, _, p = rglru_pair
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 37, 128)).astype(np.float32)
    prev = rng.standard_normal((2, 3, 128)).astype(np.float32)
    np.testing.assert_allclose(_np(_block_diag_mm(_t(x), p["wa"])),
                               np.asarray(jax_block_diag_mm(jnp.asarray(x), jp["wa"])),
                               **RGLRU_TOL)
    for pr in (prev, None):
        got = _causal_conv(_t(x), p["conv"], p["conv_b"], None if pr is None else _t(pr))
        want = jax_causal_conv(jnp.asarray(x), jp["conv"], jp["conv_b"],
                               None if pr is None else jnp.asarray(pr))
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), **RGLRU_TOL)


@pytest.mark.parametrize("S", [1, 2, 5, 64, 100])
def test_linear_scan_is_the_sequential_recurrence(S):
    rng = np.random.default_rng(7)
    a = rng.uniform(0.5, 1.0, (2, S, 8))
    b = rng.standard_normal((2, S, 8))
    h, want = np.zeros((2, 8)), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), atol=1e-12, rtol=1e-12)


# -- the model -------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model_pair():
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jparams = JaxLM(jcfg).init(jax.random.PRNGKey(8))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, LM(cfg, device="cpu"), params


def test_init_and_cache_layout_match_jax(model_pair):
    """``LM.init`` and ``init_cache`` lay the tree out as the JAX model does
    (leaf paths, shapes and dtypes; the caches equal), and the port's
    ``lam``, the one drawn constant, equals the JAX model's."""
    jcfg, jparams, model, _ = model_pair

    def layout(tree):
        return sorted((jax.tree_util.keystr(path), tuple(np.shape(leaf)), str(leaf.dtype))
                      for path, leaf in jax.tree_util.tree_leaves_with_path(tree))

    mine = model.init(torch.Generator().manual_seed(0))
    as_np = jax.tree.map(lambda t: np.asarray(_np(t)).astype(str(t.dtype)[6:]), mine)
    assert layout(as_np) == layout(jax.tree.map(np.asarray, jparams))
    rec = mine["segments"][0]["rec"]["rec"]
    np.testing.assert_allclose(_np(rec["lam"]), np.asarray(jparams["segments"][0]["rec"]["rec"]
                                                            ["lam"]), atol=1e-6)
    caches = jax.tree.map(lambda t: np.asarray(_np(t)).astype(str(t.dtype)[6:]),
                          model.init_cache(3, 40))
    jcaches = jax.tree.map(np.asarray, JaxLM(jcfg).init_cache(3, 40))
    assert layout(caches) == layout(jcaches)
    for a, b in zip(jax.tree.leaves(caches), jax.tree.leaves(jcaches)):
        np.testing.assert_array_equal(a, b)


def test_backbone_and_loss_match_jax(model_pair):
    """48 tokens, three windows, without a cache: the window masks inside
    the no-cache kernel route."""
    jcfg, jparams, model, params = model_pair
    before = flash_attention.launches
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jcfg.vocab, (2, 48))
    labels = rng.integers(0, jcfg.vocab, (2, 48))
    seen = []

    def attn_fn(q, k, v, causal, window):
        seen.append(window)
        from repro_torch.kernels import ops
        return ops.attention(q, k, v, causal=causal, window=window)

    routed = LM(model.cfg, device="cpu", attn_fn=attn_fn)
    hidden, caches, aux = routed.backbone(params, torch.from_numpy(toks))
    jmodel = JaxLM(jcfg)
    pos = jnp.broadcast_to(jnp.arange(48, dtype=jnp.int32)[None], (2, 48))
    jhidden, _, _ = jmodel.backbone(jparams, jnp.asarray(toks, jnp.int32), pos)
    assert seen == [16, 16] and caches is None and float(aux) == 0.0
    np.testing.assert_allclose(_np(hidden), np.asarray(jhidden), **MODEL_TOL)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    loss, metrics = model.loss(params, batch)
    jloss, _ = jmodel.loss(jparams, {"tokens": jnp.asarray(toks, jnp.int32),
                                     "labels": jnp.asarray(labels, jnp.int32)})
    np.testing.assert_allclose(float(loss), float(jloss), **MODEL_TOL)
    assert float(metrics["moe_aux"]) == 0.0
    assert flash_attention.launches == before      # the CPU reaches no kernel


def test_prefill_and_decode_past_the_ring_wrap_match_jax(model_pair):
    """A 12-token prompt, then 12 decode steps (positions 12..23 over a
    16-slot ring: it wraps at 16); logits at every step and every cache leaf
    at the end equal the JAX model's."""
    jcfg, jparams, model, params = model_pair
    B, S, steps, C = 2, 12, 12, 40
    toks = np.random.default_rng(10).integers(0, jcfg.vocab, (B, S))
    jmodel = JaxLM(jcfg)
    decode = jax.jit(jmodel.decode_step)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                            jmodel.init_cache(B, C))
    lg, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                               model.init_cache(B, C))
    np.testing.assert_allclose(_np(lg), np.asarray(jl), **MODEL_TOL)
    for t in range(steps):
        nxt, jnxt = torch.argmax(lg, -1), jnp.argmax(jl, -1)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        pos = np.full((B,), S + t, np.int32)
        jl, jc = decode(jparams, jnxt.astype(jnp.int32), jnp.asarray(pos), jc)
        lg, caches = model.decode_step(params, nxt, torch.from_numpy(pos), caches)
        np.testing.assert_allclose(_np(lg), np.asarray(jl), **MODEL_TOL)
    assert int(caches[0]["attn"]["pos"].max()) == S + steps - 1 >= 16
    flat, jflat = jax.tree.leaves(jax.tree.map(_np, caches)), jax.tree.leaves(jc)
    assert len(flat) == len(jflat) == 5
    for a, b in zip(flat, jflat):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **MODEL_TOL)


def _jax_greedy(jmodel, decode, jparams, prompt, n_new, max_seq):
    """The JAX model's greedy tokens for one request, driven as the engine
    drives a slot: the prefill's token, then one token a decode step
    (``decode``: the model's ``decode_step``, jitted)."""
    lg, caches = jmodel.prefill(jparams, {"tokens": jnp.asarray([prompt], jnp.int32)},
                                jmodel.init_cache(1, max_seq))
    out = [int(jnp.argmax(lg[0]))]
    for t in range(n_new):
        lg, caches = decode(jparams, jnp.asarray([out[-1]], jnp.int32),
                            jnp.asarray([len(prompt) + t], jnp.int32), caches)
        out.append(int(jnp.argmax(lg[0])))
    return out


def test_engine_gives_the_jax_models_tokens(model_pair):
    """Five requests through three slots (slots reused, idle slots run on,
    rings wrap at 16) give the tokens of the JAX model driven one request
    at a time."""
    jcfg, jparams, model, params = model_pair
    rng = np.random.default_rng(11)
    reqs = [(f"req{i}", rng.integers(0, jcfg.vocab, n).tolist(), m)
            for i, (n, m) in enumerate([(12, 8), (5, 14), (16, 6), (3, 10), (9, 9)])]
    engine = ServingEngine(model, params, max_batch=3, max_seq=40)
    pending, done = list(reqs), {}
    while len(done) < len(reqs):
        while pending and engine.free_slots():
            engine.add_request(*pending.pop(0))
        done.update(engine.step())
    jmodel = JaxLM(jcfg)
    decode = jax.jit(jmodel.decode_step)
    want = {rid: _jax_greedy(jmodel, decode, jparams, prompt, n, 40) for rid, prompt, n in reqs}
    assert done == want


def test_serve_demo_serves_the_hybrid_on_cpu():
    """The serving driver's reduced model (two layers: one group of two
    RG-LRU blocks and no attention) on the CPU, where no kernel runs."""
    kernels = (flash_attention, flash_decode)
    before = [k.launches for k in kernels]
    out = serve_demo(ARCH, n_requests=6, max_batch=4, device="cpu")
    assert [k.launches for k in kernels] == before
    assert len(out["outputs"]) == 6
    assert all(0 <= t < 512 for toks in out["outputs"].values() for t in toks)
    assert np.isfinite(out["interference"]).all()
