"""The port's audio family (``repro_torch``: ``sinusoidal_embed``,
``LM.encode``, the ``enc`` and ``dec`` segments, cross-attention in
``gqa_apply`` over a written and a read-only cache, the frame stubs and
``train()``) held against the JAX package on reduced ``whisper-tiny``: 2
encoder and 2 decoder layers, d_model 128, 4 heads of 32, LayerNorm, GELU,
32 frames.

Inputs are made with numpy from a seed and handed to both sides; the JAX
weights, every leaf nudged by seeded noise so the LayerNorm biases and
scales are not trivial, are carried across with ``params_from_jax``.
Everything runs in float32 on the CPU; the JAX decoder's self-attention in
training runs its Pallas kernel in interpret mode (``attention_impl=
"kernel_interpret"``, as ``tests/test_kernel_model_integration.py`` runs
it), everything else through XLA.  The encoder at 1e-5, the model at 5e-4,
greedy tokens exactly.  The JAX ``ServingEngine`` cannot serve the family
(it passes only tokens; ROADMAP.md, "Known reference faults"), and the
port's refuses it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.synthetic import materialize_batch as jax_materialize_batch
from repro.models import LM as JaxLM
from repro.models import reduced as jax_reduced
from repro.models.transformer import sinusoidal_embed as jax_sinusoidal_embed
from repro.serve.engine import ServingEngine as JaxServingEngine

from repro_torch.configs import ARCHS, get_config
from repro_torch.data.synthetic import materialize_batch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.train import frontend_stubs, train
from repro_torch.models import LM, params_from_jax, reduced
from repro_torch.models.transformer import sinusoidal_embed
from repro_torch.serve.engine import ServingEngine
from repro_torch.train.step import value_and_grad
from repro_torch.tree import tree_leaves

from _torch_config import assert_same_config

ARCH = "whisper-tiny"
ENC_TOL = dict(atol=1e-5, rtol=1e-5)
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


def test_config_matches_jax_full_and_reduced():
    assert ARCH in ARCHS
    assert_same_config(get_config(ARCH), jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    assert_same_config(cfg, jax_reduced(jax_get_config(ARCH)))
    assert (cfg.n_layers, cfg.enc_len, cfg.enc_dec) == (2, 32, True)
    full = LM(get_config(ARCH), device="cpu")
    assert [(s.kind, s.n) for s in full.segments] == [("enc", 4), ("dec", 4)]


@pytest.mark.parametrize("dim", [128, 384])
def test_sinusoidal_embed_matches_jax(dim):
    """Within 1e-5 over the first 64 positions; over Whisper's 1500 frames
    within two float32 ulps of the largest angle (1500 rad, an ulp of
    1.2e-4): the two libraries' exp may differ by an ulp of a frequency,
    which the position multiplies."""
    rng = np.random.default_rng(1)
    for hi, atol in ((64, 1e-5), (1500, 2 * float(np.spacing(np.float32(1500.0))))):
        pos = rng.integers(0, hi, (3, 17)).astype(np.int32)
        np.testing.assert_allclose(_np(sinusoidal_embed(_t(pos), dim)),
                                   np.asarray(jax_sinusoidal_embed(jnp.asarray(pos), dim)),
                                   atol=atol, rtol=0)


@pytest.fixture(scope="module")
def model_pair():
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    rng = np.random.default_rng(2)
    tree = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(3)))
    tree = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype),
                        tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, LM(cfg, device="cpu"), params_from_jax(tree, device="cpu")


def _frames(jcfg, B, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, jcfg.enc_len, jcfg.d_model)).astype(np.float32)


def test_init_and_cache_layout_match_jax(model_pair):
    """The parameter tree (``enc_final_norm``, the decoder's ``self_attn``,
    ``norm_x``, ``cross_attn``) and the caches (None for the encoder, self
    and cross caches for the decoder) laid out as the JAX model's."""
    jcfg, jparams, model, _ = model_pair
    mine = model.init(torch.Generator().manual_seed(0))
    assert _layout(_as_np(mine)) == _layout(jax.tree.map(np.asarray, jparams))
    assert sorted(mine["segments"][1]) == ["cross_attn", "ffn", "norm1", "norm2", "norm_x",
                                           "self_attn"]
    caches = model.init_cache(3, 40)
    jcaches = JaxLM(jcfg).init_cache(3, 40)
    assert caches[0] is None and jcaches[0] is None
    assert caches[1]["cross"]["k"].shape == (2, 3, 32, 4, 32)
    assert _layout(_as_np(caches)) == _layout(jax.tree.map(np.asarray, jcaches))
    for a, b in zip(jax.tree.leaves(_as_np(caches)), jax.tree.leaves(jcaches)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert model.cache_batch_axes() == [1, 1]


def test_encode_matches_jax(model_pair):
    jcfg, jparams, model, params = model_pair
    frames = _frames(jcfg, 2, seed=4)
    with torch.no_grad():
        got = model.encode(params, _t(frames))
    want = JaxLM(jcfg).encode(jparams, jnp.asarray(frames))
    assert got.shape == (2, jcfg.enc_len, jcfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), **ENC_TOL)


@pytest.mark.parametrize("impl", ["xla", "kernel_interpret"])
def test_loss_and_grads_with_frames_match_jax(model_pair, impl):
    """The loss over frames and the gradients of a few leaves (the
    encoder's, the cross-attention's, the tied embedding) against
    ``jax.grad``; the decoder's self-attention takes the kernel route (the
    plain version on the CPU), the encoder and cross-attention the plain
    one; the CPU reaches no kernel."""
    jcfg, jparams, model, params = model_pair
    jcfg = dataclasses.replace(jcfg, attention_impl=impl)
    before = flash_attention.launches
    rng = np.random.default_rng(5)
    b = {"tokens": rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32),
         "labels": rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32),
         "frames": _frames(jcfg, 2, seed=6)}
    jmodel = JaxLM(jcfg)

    def jloss_fn(p, batch):
        return jmodel.loss(p, jax.tree.map(jnp.asarray, batch))[0]

    jloss, jgrads = jax.value_and_grad(jloss_fn)(jparams, b)
    loss, metrics, grads = value_and_grad(model, params, {k: _t(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(jloss), **MODEL_TOL)
    assert float(metrics["moe_aux"]) == 0.0
    for path in (("segments", 0, "attn", "wq", "w"), ("segments", 1, "cross_attn", "wk", "w"),
                 ("segments", 1, "self_attn", "wv", "w"), ("segments", 1, "norm_x", "bias"),
                 ("enc_final_norm", "scale"), ("embed", "embedding")):
        g, jg = grads, jgrads
        for key in path:
            g, jg = g[key], jg[key]
        np.testing.assert_allclose(_np(g), np.asarray(jg), atol=5e-4, rtol=5e-4,
                                   err_msg=str(path))
    assert flash_attention.launches == before


def test_prefill_and_decode_with_frames_match_jax(model_pair):
    """A 6-token prompt over 32 frames (the encoder runs once, the cross
    caches are written), then 4 decode steps reading them: logits at every
    step, the greedy tokens and every cache leaf at the end equal the JAX
    model's."""
    jcfg, jparams, model, params = model_pair
    B, S, steps, C = 2, 6, 4, 24
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    frames = _frames(jcfg, B, seed=8)
    jmodel = JaxLM(jcfg)
    decode = jax.jit(jmodel.decode_step)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
                            jmodel.init_cache(B, C))
    with torch.inference_mode():
        lg, caches = model.prefill(params, {"tokens": _t(toks), "frames": _t(frames)},
                                   model.init_cache(B, C))
        np.testing.assert_allclose(_np(lg), np.asarray(jl), **MODEL_TOL)
        assert int(caches[1]["cross"]["pos"].min()) == 0
        for t in range(steps):
            nxt, jnxt = torch.argmax(lg, -1), jnp.argmax(jl, -1)
            np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
            pos = np.full((B,), S + t, np.int32)
            jl, jc = decode(jparams, jnxt.astype(jnp.int32), jnp.asarray(pos), jc)
            lg, caches = model.decode_step(params, nxt, _t(pos), caches)
            np.testing.assert_allclose(_np(lg), np.asarray(jl), **MODEL_TOL)
    assert caches[0] is None and jc[0] is None
    flat, jflat = jax.tree.leaves(_as_np(caches)), jax.tree.leaves(jc)
    assert len(flat) == len(jflat) == 6
    for a, b in zip(flat, jflat):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **MODEL_TOL)


def test_decoder_without_encoder_output_or_cache_raises(model_pair):
    _, _, model, params = model_pair
    with pytest.raises(ValueError, match="cross cache"):
        model.backbone(params, torch.zeros((1, 3), dtype=torch.long))


def test_engine_refuses_the_family_where_the_jax_engine_fails(model_pair):
    """The JAX engine takes the model and fails at ``add_request`` with
    ``KeyError: 'frames'``; the port's refuses it at construction, naming
    the reason and the model's own decode path."""
    jcfg, jparams, model, params = model_pair
    jengine = JaxServingEngine(JaxLM(jcfg), jparams, max_batch=2, max_seq=32)
    with pytest.raises(KeyError, match="frames"):
        jengine.add_request("r", [1, 2, 3], 4)
    with pytest.raises(NotImplementedError, match="frames") as info:
        ServingEngine(model, params, max_batch=2, max_seq=32)
    assert "LM.prefill" in str(info.value) and "ROADMAP" in str(info.value)


def test_frame_stubs_match_jax():
    cfg = reduced(get_config(ARCH))
    jcfg = jax_reduced(jax_get_config(ARCH))
    for mode in ("train", "prefill"):
        got = materialize_batch(cfg, 3, 16, seed=9, mode=mode)
        want = jax_materialize_batch(jcfg, 3, 16, seed=9, mode=mode)
        assert sorted(got) == sorted(want)
        for key in got:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    stubbed = frontend_stubs(cfg, {"tokens": np.zeros((3, 16), np.int32)})
    assert stubbed["frames"].shape == (3, 32, 128) and not stubbed["frames"].any()
    assert sorted(stubbed) == ["frames", "tokens"]


def test_train_runs_on_cpu(tmp_path):
    """``train()`` on reduced whisper: the batches carry zero frames, the
    losses are finite, the CPU reaches no kernel."""
    before = flash_attention.launches
    out = train(ARCH, steps=6, batch=2, seq=16, log_every=100, device="cpu",
                ckpt_dirs=[str(tmp_path / "a")], async_ckpt=False)
    assert np.isfinite(out["losses"]).all() and np.isfinite(out["grad_norms"]).all()
    assert len(out["losses"]) == 6 and out["config"].enc_dec
    assert "enc_final_norm" in out["params"]
    assert all(t.device.type == "cpu" for t in tree_leaves(out["params"]))
    assert flash_attention.launches == before
