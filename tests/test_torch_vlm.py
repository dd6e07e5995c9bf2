"""The port's vlm family (``repro_torch``: ``apply_mrope`` in
``models/layers.py``, M-RoPE in ``gqa_apply``, ``position_ids`` through the
``LM``, the batch stubs, the microbatch split and ``train()``) held
against the JAX package on reduced ``qwen2-vl-72b``: 2 layers, d_model 128,
head_dim 32 (M-RoPE sections (4, 6, 6)), 4 query heads over 2 kv heads.

Inputs are made with numpy from a seed and handed to both sides; the JAX
weights, every leaf nudged by seeded noise so the QKV biases are not zero,
are carried across with ``params_from_jax``.  Everything runs in float32 on
the CPU, the JAX model through its XLA attention (``attention_impl="xla"``,
the reduced config's own): ``apply_mrope`` at 1e-6, the model at 5e-4,
greedy tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.synthetic import materialize_batch as jax_materialize_batch
from repro.models import LM as JaxLM
from repro.models import reduced as jax_reduced
from repro.models.layers import apply_mrope as jax_apply_mrope
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro.train.step import _split_microbatches as jax_split_microbatches

from repro_torch.configs import ARCHS, get_config
from repro_torch.data.synthetic import materialize_batch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.launch.train import frontend_stubs, train
from repro_torch.models import LM, params_from_jax, reduced
from repro_torch.models.layers import apply_mrope, apply_rope
from repro_torch.serve.engine import ServingEngine
from repro_torch.train.step import _split_microbatches, value_and_grad
from repro_torch.tree import tree_leaves

from _torch_config import assert_same_config

ARCH = "qwen2-vl-72b"
MROPE_TOL = dict(atol=1e-6, rtol=1e-6)
MODEL_TOL = dict(atol=5e-4, rtol=5e-4)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _layout(tree):
    return sorted((jax.tree_util.keystr(path), tuple(np.shape(leaf)), str(leaf.dtype))
                  for path, leaf in jax.tree_util.tree_leaves_with_path(tree))


def _as_np(tree):
    return jax.tree.map(lambda t: np.asarray(_np(t)).astype(str(t.dtype)[6:]), tree)


def _image_then_text(B, S, grid=(2, 3, 4), seed=0):
    """(3, B, S) M-RoPE ids in Qwen2-VL's layout: a t x h x w grid of image
    positions (each stream its own index), then text, all three streams
    equal and counting on from the grid's largest id; each row starts at a
    seeded offset, so the rows differ."""
    t, h, w = grid
    n_img = t * h * w
    ti, hi, wi = np.meshgrid(np.arange(t), np.arange(h), np.arange(w), indexing="ij")
    img = np.stack([ti.ravel(), hi.ravel(), wi.ravel()])                # (3, n_img)
    text = img.max() + 1 + np.arange(S - n_img)
    ids = np.concatenate([img, np.broadcast_to(text, (3, S - n_img))], axis=1)
    offsets = np.random.default_rng(seed).integers(0, 50, B)
    return (ids[:, None, :] + offsets[None, :, None]).astype(np.int32)


def test_config_matches_jax_full_and_reduced():
    assert ARCH in ARCHS
    assert_same_config(get_config(ARCH), jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    assert_same_config(cfg, jax_reduced(jax_get_config(ARCH)))
    assert cfg.mrope_sections == (4, 6, 6) and cfg.needs_position_ids
    full = LM(get_config(ARCH), device="cpu")
    assert [(s.kind, s.n) for s in full.segments] == [("attn", 80)]


# -- M-RoPE --------------------------------------------------------------------------
@pytest.mark.parametrize("sections,D", [((4, 6, 6), 32), ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax(sections, D):
    rng = np.random.default_rng(1)
    B, S = 2, 11
    q = rng.standard_normal((B, S, 4, D)).astype(np.float32)
    k = rng.standard_normal((B, S, 2, D)).astype(np.float32)
    ids = rng.integers(0, 4000, (3, B, S)).astype(np.int32)
    got = apply_mrope(_t(q), _t(k), _t(ids), 1e6, sections)
    want = jax_apply_mrope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(ids), 1e6, sections)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **MROPE_TOL)
    # three equal streams: M-RoPE is RoPE
    same = np.broadcast_to(ids[0], (3, B, S)).copy()
    mrope = apply_mrope(_t(q), _t(k), _t(same), 1e6, sections)
    rope = apply_rope(_t(q), _t(k), _t(ids[0]), 1e6)
    for a, b in zip(mrope, rope):
        np.testing.assert_allclose(_np(a), _np(b), **MROPE_TOL)
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(_t(q), _t(k), _t(ids), 1e6, (4, 6, 7))


# -- the model -------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model_pair():
    jcfg = jax_reduced(jax_get_config(ARCH), n_kv_heads=2)
    cfg = reduced(get_config(ARCH), n_kv_heads=2)
    rng = np.random.default_rng(2)
    tree = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(3)))
    tree = jax.tree.map(lambda a: (a + 0.01 * rng.standard_normal(a.shape)).astype(a.dtype),
                        tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, LM(cfg, device="cpu"), params_from_jax(tree, device="cpu")


def test_init_and_cache_layout_match_jax(model_pair):
    jcfg, jparams, model, _ = model_pair
    mine = model.init(torch.Generator().manual_seed(0))
    assert _layout(_as_np(mine)) == _layout(jax.tree.map(np.asarray, jparams))
    assert mine["segments"][0]["attn"]["wq"]["b"].shape == (2, 128)   # the QKV bias
    caches = _as_np(model.init_cache(3, 40))
    jcaches = jax.tree.map(np.asarray, JaxLM(jcfg).init_cache(3, 40))
    assert _layout(caches) == _layout(jcaches)
    for a, b in zip(jax.tree.leaves(caches), jax.tree.leaves(jcaches)):
        np.testing.assert_array_equal(a, b)
    assert model.cache_batch_axes() == [1]


def _loss_batch(jcfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32),
            "position_ids": rng.integers(0, 300, (3, B, S)).astype(np.int32)}


def test_loss_and_grads_with_position_ids_match_jax(model_pair):
    """Random (3, B, S) ids, unlike any text: the loss and the gradients of
    a few leaves against ``jax.grad``; without ``position_ids`` the model
    takes RoPE, as the JAX one does; the CPU reaches no kernel."""
    jcfg, jparams, model, params = model_pair
    before = (flash_attention.launches, flash_decode.launches)
    b = _loss_batch(jcfg, 2, 24, seed=4)
    jmodel = JaxLM(jcfg)

    def jloss_fn(p, batch):
        return jmodel.loss(p, jax.tree.map(jnp.asarray, batch))[0]

    jloss, jgrads = jax.value_and_grad(jloss_fn)(jparams, b)
    loss, _, grads = value_and_grad(model, params, {k: _t(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(jloss), **MODEL_TOL)
    for path in (("segments", 0, "attn", "wq", "w"), ("segments", 0, "attn", "wk", "b"),
                 ("segments", 0, "ffn", "wg", "w"), ("lm_head", "w"), ("embed", "embedding")):
        g, jg = grads, jgrads
        for key in path:
            g, jg = g[key], jg[key]
        np.testing.assert_allclose(_np(g), np.asarray(jg), atol=5e-4,
                                   rtol=5e-4, err_msg=str(path))
    text = {k: _t(v) for k, v in b.items() if k != "position_ids"}
    with torch.no_grad():
        rope, _ = model.loss(params, text)
    np.testing.assert_allclose(float(rope), float(jmodel.loss(jparams, jax.tree.map(
        jnp.asarray, {k: v for k, v in b.items() if k != "position_ids"}))[0]), **MODEL_TOL)
    assert abs(float(rope) - float(loss)) > 1e-4       # the ids do move the loss
    assert (flash_attention.launches, flash_decode.launches) == before


def test_prefill_and_decode_with_position_ids_match_jax(model_pair):
    """An image grid of 24 positions then text: a 30-token prefill, then 4
    decode steps with ids that go on counting; logits at every step and
    the greedy tokens equal the JAX model's."""
    jcfg, jparams, model, params = model_pair
    B, S, steps, C = 2, 30, 4, 48
    ids = _image_then_text(B, S + steps)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    jmodel = JaxLM(jcfg)
    decode = jax.jit(jmodel.decode_step)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks),
                                      "position_ids": jnp.asarray(ids[:, :, :S])},
                            jmodel.init_cache(B, C))
    with torch.inference_mode():
        lg, caches = model.prefill(params, {"tokens": _t(toks), "position_ids": _t(ids[:, :, :S])},
                                   model.init_cache(B, C))
        np.testing.assert_allclose(_np(lg), np.asarray(jl), **MODEL_TOL)
        for t in range(steps):
            nxt, jnxt = torch.argmax(lg, -1), jnp.argmax(jl, -1)
            np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
            pos = np.full((B,), S + t, np.int32)
            step_ids = ids[:, :, S + t:S + t + 1]
            jl, jc = decode(jparams, jnxt.astype(jnp.int32), jnp.asarray(pos), jc,
                            jnp.asarray(step_ids))
            lg, caches = model.decode_step(params, nxt, _t(pos), caches, _t(step_ids))
            np.testing.assert_allclose(_np(lg), np.asarray(jl), **MODEL_TOL)
    for a, b in zip(jax.tree.leaves(_as_np(caches)), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **MODEL_TOL)


def _serve(engine, requests):
    pending, done = list(requests), {}
    while len(done) < len(requests):
        while pending and engine.free_slots():
            engine.add_request(*pending.pop(0))
        done.update(engine.step())
    return done


def test_engine_greedy_tokens_match_jax(model_pair):
    """Text requests through the port's engine and the JAX engine (which
    passes only tokens: RoPE on positions, the M-RoPE of text): five
    requests through three slots give the same greedy tokens."""
    jcfg, jparams, model, params = model_pair
    rng = np.random.default_rng(6)
    reqs = [(f"req{i}", rng.integers(0, jcfg.vocab, n).tolist(), m)
            for i, (n, m) in enumerate([(12, 6), (5, 9), (20, 4), (3, 7), (9, 5)])]
    want = _serve(JaxServingEngine(JaxLM(jcfg), jparams, max_batch=3, max_seq=48), reqs)
    got = _serve(ServingEngine(model, params, max_batch=3, max_seq=48), reqs)
    assert got == want
    assert all(len(got[rid]) == m + 1 for rid, _, m in reqs)


# -- data and train ----------------------------------------------------------------------
def test_batch_stubs_match_jax():
    cfg = reduced(get_config(ARCH))
    jcfg = jax_reduced(jax_get_config(ARCH))
    for mode in ("train", "prefill"):
        got = materialize_batch(cfg, 3, 16, seed=7, mode=mode)
        want = jax_materialize_batch(jcfg, 3, 16, seed=7, mode=mode)
        assert sorted(got) == sorted(want)
        for key in got:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    stubbed = frontend_stubs(cfg, {"tokens": np.zeros((3, 16), np.int32)})
    np.testing.assert_array_equal(stubbed["position_ids"],
                                  materialize_batch(cfg, 3, 16)["position_ids"])
    assert sorted(stubbed) == ["position_ids", "tokens"]


def test_split_microbatches_matches_jax():
    """At m = 2 both split the (3, B, S) ids along the batch axis (ROADMAP.md,
    "Known reference faults": the JAX split cuts them across the streams at
    m = 3, the port's does not)."""
    cfg = reduced(get_config(ARCH))
    b = materialize_batch(cfg, 6, 8, seed=8)
    b["position_ids"] = np.random.default_rng(9).integers(0, 99, (3, 6, 8)).astype(np.int32)
    want = jax_split_microbatches(jax.tree.map(jnp.asarray, b), 2)
    got = _split_microbatches({k: _t(v) for k, v in b.items()}, 2)
    assert len(got) == 2
    for i, mb in enumerate(got):
        for key, val in mb.items():
            np.testing.assert_array_equal(val.numpy(), np.asarray(want[key][i]))
    assert tuple(got[0]["position_ids"].shape) == (3, 3, 8)
    three = _split_microbatches({k: _t(v) for k, v in b.items()}, 3)
    assert [tuple(mb["position_ids"].shape) for mb in three] == [(3, 2, 8)] * 3
    np.testing.assert_array_equal(torch.cat([mb["position_ids"] for mb in three], 1).numpy(),
                                  b["position_ids"])
    with pytest.raises(ValueError, match="position_ids"):
        _split_microbatches({"tokens": _t(b["tokens"]), "position_ids":
                             _t(b["position_ids"][:, :5])}, 2)


def test_train_runs_on_cpu(tmp_path):
    """``train()`` on reduced qwen2-vl, two microbatches a step: the
    batches carry text position ids, the losses are finite, the CPU
    reaches no kernel."""
    before = flash_attention.launches
    out = train(ARCH, steps=8, batch=2, seq=32, log_every=100, device="cpu",
                ckpt_dirs=[str(tmp_path / "a")], async_ckpt=False, microbatches=2)
    assert np.isfinite(out["losses"]).all() and np.isfinite(out["grad_norms"]).all()
    assert len(out["losses"]) == 8
    assert out["config"].needs_position_ids
    assert all(t.device.type == "cpu" for t in tree_leaves(out["params"]))
    assert flash_attention.launches == before
