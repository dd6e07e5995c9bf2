"""A KV cache in float8 (``kv_dtype``) in the port, held against the JAX
package on the CPU: the cast into the cache bit for bit with ``jnp.astype``
over every bfloat16 value, ``gqa_apply``'s prefill and decode over a float8
cache, a reduced ``minitron-8b``'s prefill and decode logits, and both
engines' greedy tokens, all in float32; and the plain decode attention on
float8 K/V, which widens them first.

Inputs are made with numpy from a seed and handed to both sides; a float8
cache is handed over as its bytes.  ``test_torch_kernels_cuda.py`` holds
the decode kernel on float8 K/V against the plain version on a card.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import LM as JaxLM
from repro.models import reduced as jax_reduced
from repro.models.attention import gqa_apply as jax_gqa_apply
from repro.models.attention import gqa_init as jax_gqa_init
from repro.serve.engine import ServingEngine as JaxServingEngine

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import check_decode_args
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.models import LM, params_from_jax, reduced
from repro_torch.models.attention import gqa_apply
from repro_torch.models.layers import FLOAT8, astype
from repro_torch.serve.engine import ServingEngine

from _torch_config import assert_same_config

FP8 = ["float8_e4m3fn", "float8_e5m2"]
# the JAX model against the port in float32 (the projections round in
# another order; the float8 cache contents are compared byte for byte)
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _bytes(x):
    """The bytes of a float8 tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


# -- the cast ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FP8)
def test_astype_is_jnp_astype_bit_for_bit_over_every_bfloat16(name):
    """All 65536 bf16 bit patterns (NaNs, infinities, subnormals, both zeros,
    and the values beyond float8_e4m3fn's range, where JAX gives NaN and a
    plain torch cast saturates to 448), and a float32 sweep across the
    overflow edge."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    x16 = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    want = np.asarray(jnp.asarray(bits.view(ml_dtypes.bfloat16)).astype(getattr(jnp, name)))
    got = astype(x16, getattr(torch, name))
    assert got.dtype == getattr(torch, name)
    np.testing.assert_array_equal(_bytes(got), _bytes(want))
    if name == "float8_e4m3fn":   # where a plain cast differs: x16 beyond 464 in magnitude
        plain = _bytes(x16.to(torch.float8_e4m3fn))
        assert int((plain != _bytes(want)).sum()) == 30512
    x32 = np.concatenate([np.linspace(-500, 500, 200001, dtype=np.float32),
                          np.linspace(57000, 62000, 5001, dtype=np.float32),
                          np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)])
    np.testing.assert_array_equal(
        _bytes(astype(torch.from_numpy(x32), getattr(torch, name))),
        _bytes(jnp.asarray(x32).astype(getattr(jnp, name))))


# -- the plain decode attention -------------------------------------------------------------
@pytest.mark.parametrize("name", FP8)
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_decode_attention_ref_widens_float8_kv(name, qdtype):
    """On float8 K/V the plain version equals itself on K/V widened to q's
    dtype (``==``): it widens first, and rounds its weights to q's dtype,
    not to float8."""
    rng = np.random.default_rng(1)
    B, C, Hq, Hk, D = 3, 40, 8, 2, 32
    q = _t(rng.standard_normal((B, Hq, D)), qdtype)
    k8, v8 = (astype(_t(rng.standard_normal((B, C, Hk, D))), getattr(torch, name))
              for _ in range(2))
    lengths = torch.tensor([1, 17, 40], dtype=torch.int32)
    got = ops.decode_attention(q, k8, v8, lengths)
    assert got.dtype == qdtype
    assert torch.equal(got, decode_attention_ref(q, k8.to(qdtype), v8.to(qdtype), lengths))


def test_decode_args_take_float8_kv_and_reject_mixed_pairs():
    """The kernel's argument check: K and V both in q's dtype or both in one
    float8 dtype; a bf16/float8 pair, two float8 dtypes, or float8 q are
    refused."""
    rng = np.random.default_rng(2)
    q = _t(rng.standard_normal((2, 8, 64)), torch.bfloat16)
    k, v = (_t(rng.standard_normal((2, 96, 2, 64))) for _ in range(2))
    lengths = torch.tensor([5, 96], dtype=torch.int32)
    for name in FP8:
        dt8 = getattr(torch, name)
        check_decode_args(q, astype(k, dt8), astype(v, dt8), lengths)
        check_decode_args(q.float(), astype(k, dt8), astype(v, dt8), lengths)
    e4, e5 = astype(k, torch.float8_e4m3fn), astype(v, torch.float8_e5m2)
    for kk, vv in ((k.to(torch.bfloat16), astype(v, torch.float8_e4m3fn)), (e4, e5),
                   (e4, v.to(torch.bfloat16))):
        with pytest.raises(TypeError, match="share one dtype"):
            check_decode_args(q, kk, vv, lengths)
    with pytest.raises(TypeError, match="q must be"):
        check_decode_args(astype(q.float(), torch.float8_e4m3fn), e4, e4, lengths)


# -- gqa_apply over a float8 cache ------------------------------------------------------
@pytest.fixture(scope="module")
def attn_pair():
    jcfg = jax_reduced(jax_get_config("minitron-8b"), n_kv_heads=2)
    cfg = reduced(get_config("minitron-8b"), n_kv_heads=2)
    jp = jax_gqa_init(jax.random.PRNGKey(3), jcfg)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("name", FP8)
@pytest.mark.parametrize("case", ["prefill", "decode", "ring decode"])
def test_gqa_apply_over_a_float8_cache_matches_jax(attn_pair, name, case):
    """A prefill of 6 tokens from position 0 (the attention kernel's route
    over the new keys and values rounded as the cache holds them) and a
    decode step (the decode route over the float8 cache itself; in a ring
    past its wrap too) equal the JAX model's route over
    ``cache.astype(q.dtype)``, and leave the same cache bytes behind."""
    jcfg, jp, cfg, p = attn_pair
    C, B = 16, 2
    rng = np.random.default_rng(4)
    dt8 = getattr(torch, name)
    k = rng.standard_normal((B, C, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    v = rng.standard_normal((B, C, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    window = None
    if case == "prefill":
        pos_k = np.where(np.arange(C) < 10, np.arange(C), -1)[None].repeat(B, 0)
        positions = np.broadcast_to(np.arange(6), (B, 6))
    elif case == "decode":
        pos_k = np.stack([np.where(np.arange(C) < n, np.arange(C), -1) for n in (5, 11)])
        positions = np.array([[5], [11]])
    else:
        window = C   # a ring past its wrap: positions first..first+C-1 at p % C
        pos_k = np.stack([[next(q for q in range(first, first + C) if q % C == s)
                           for s in range(C)] for first in (5, 24)])
        positions = np.array([[21], [40]])
    pos_k = pos_k.astype(np.int32)
    positions = np.ascontiguousarray(positions, dtype=np.int32)
    k8, v8 = astype(_t(k), dt8), astype(_t(v), dt8)
    tcache = {"k": k8.clone(), "v": v8.clone(), "pos": torch.from_numpy(pos_k.copy())}
    jcache = {"k": jnp.asarray(_bytes(k8)).view(getattr(jnp, name)),
              "v": jnp.asarray(_bytes(v8)).view(getattr(jnp, name)),
              "pos": jnp.asarray(pos_k)}
    x = rng.standard_normal((B, positions.shape[1], cfg.d_model)).astype(np.float32)
    seen = []

    def attn_fn(q, kk, vv, causal, window):
        seen.append("attention")
        return ops.attention(q, kk, vv, causal=causal, window=window)

    def decode_fn(q, kk, vv, lengths):
        seen.append(("decode", kk.dtype, vv.dtype))
        assert kk is tcache["k"] and vv is tcache["v"]      # the cache itself, not widened
        return ops.decode_attention(q, kk, vv, lengths)

    got, new = gqa_apply(cfg, p, _t(x), torch.from_numpy(positions), cache=tcache,
                         window=window, attn_fn=attn_fn, decode_fn=decode_fn, gapless=True)
    want, jnew = jax_gqa_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(positions), window=window,
                               cache=jcache)
    assert seen == (["attention"] if case == "prefill" else [("decode", dt8, dt8)])
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert new["k"].dtype == dt8
    for key in ("k", "v"):
        np.testing.assert_array_equal(_bytes(new[key]), _bytes(jnew[key]))
    np.testing.assert_array_equal(new["pos"].numpy(), np.asarray(jnew["pos"]))


# -- the model and the engine ------------------------------------------------------------
@pytest.fixture(scope="module", params=FP8)
def fp8_pair(request):
    over = dict(n_kv_heads=2, kv_dtype=request.param)
    jcfg = jax_reduced(jax_get_config("minitron-8b"), **over)
    cfg = reduced(get_config("minitron-8b"), **over)
    assert_same_config(cfg, jcfg)
    jparams = JaxLM(jcfg).init(jax.random.PRNGKey(8))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, LM(cfg, device="cpu"), params


def test_prefill_and_decode_over_a_float8_cache_match_jax(fp8_pair):
    """A reduced ``minitron-8b`` with a float8 cache: the prefill's and 6
    decode steps' logits within 1e-5 of the JAX model's, the same greedy
    tokens, and the same cache bytes."""
    jcfg, jparams, model, params = fp8_pair
    B, S, steps, C = 2, 24, 6, 40
    toks = np.random.default_rng(9).integers(0, jcfg.vocab, (B, S))
    jmodel = JaxLM(jcfg)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                            jmodel.init_cache(B, C))
    caches = model.init_cache(B, C)
    assert caches[0]["k"].dtype == getattr(torch, jcfg.kv_dtype)
    lg, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)}, caches)
    np.testing.assert_allclose(_np(lg), np.asarray(jl), **TOL)
    for t in range(steps):
        nxt, jnxt = torch.argmax(lg, -1), jnp.argmax(jl, -1)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        pos = np.full((B,), S + t, np.int32)
        jl, jc = jmodel.decode_step(jparams, jnxt.astype(jnp.int32), jnp.asarray(pos), jc)
        lg, caches = model.decode_step(params, nxt, torch.from_numpy(pos), caches)
        np.testing.assert_allclose(_np(lg), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_array_equal(_bytes(caches[0][key]), _bytes(jc[0][key]))
    np.testing.assert_array_equal(caches[0]["pos"].numpy(), np.asarray(jc[0]["pos"]))


def _serve(engine, requests):
    pending, done = list(requests), {}
    while len(done) < len(requests):
        while pending and engine.free_slots():
            engine.add_request(*pending.pop(0))
        done.update(engine.step())
    return done


def test_engines_over_a_float8_cache_give_the_same_tokens(fp8_pair):
    """Six requests through two slots (slots reused, a float8 cache spliced
    byte for byte): the port's engine and the JAX engine give the same
    greedy tokens."""
    jcfg, jparams, model, params = fp8_pair
    rng = np.random.default_rng(10)
    reqs = [(f"req{i}", rng.integers(0, jcfg.vocab, n).tolist(), m)
            for i, (n, m) in enumerate([(12, 3), (5, 9), (12, 4), (20, 2), (5, 6), (12, 5)])]
    jax_out = _serve(JaxServingEngine(JaxLM(jcfg), jparams, max_batch=2, max_seq=32), reqs)
    engine = ServingEngine(model, params, max_batch=2, max_seq=32)
    assert all(c["k"].dtype in FLOAT8 for c in engine.caches)
    assert _serve(engine, reqs) == jax_out
