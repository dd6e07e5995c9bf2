"""A KV cache in another float dtype than the model's (``kv_dtype``) in the
port, held against the JAX package on the CPU: the casts bit for bit with
``jnp.astype`` between float32, bfloat16 and float16, both ways;
``gqa_apply``'s prefill and decode over such a cache; a reduced
``minitron-8b``'s prefill and decode logits; and both engines' greedy
tokens, for bfloat16 and float16 caches under a float32 model and float32
and float16 caches under a bfloat16 one.

Inputs are made with numpy from a seed and handed to both sides, a cache
as its bits.  ``test_torch_kernels_cuda.py`` holds the decode kernel on
these K/V dtypes against the plain version on a card.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ref import decode_attention_ref as jax_decode_attention_ref
from repro.models import LM as JaxLM
from repro.models import reduced as jax_reduced
from repro.models.attention import gqa_apply as jax_gqa_apply
from repro.models.attention import gqa_init as jax_gqa_init
from repro.serve.engine import ServingEngine as JaxServingEngine

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import check_decode_args, kv_kind
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.models import LM, params_from_jax, reduced
from repro_torch.models.attention import gqa_apply
from repro_torch.models.layers import astype
from repro_torch.serve.engine import ServingEngine

FLOATS = ("float32", "bfloat16", "float16")
# (model dtype, kv_dtype): every pair the decode kernel is built for
PAIRS = [("float32", "bfloat16"), ("float32", "float16"),
         ("bfloat16", "float32"), ("bfloat16", "float16")]
# the JAX model against the port: float32 at the dense model's 5e-4
# (tests/test_torch_decode.py), bfloat16 at the kernel sweep's 3e-2
TOL = {"float32": dict(atol=5e-4, rtol=5e-4), "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _cache_tol(model_dtype, kv_dtype):
    """A cache against the JAX one: ``TOL``, or one step of the cache's
    dtype where that is wider, as the two sides' projections may round a key
    or value to neighbouring codes."""
    eps = torch.finfo(getattr(torch, kv_dtype)).eps
    tol = TOL[model_dtype]
    return dict(atol=max(tol["atol"], eps), rtol=max(tol["rtol"], eps))


_UINT = {"float32": np.uint32, "bfloat16": np.uint16, "float16": np.uint16}
_INT = {"float32": torch.int32, "bfloat16": torch.int16, "float16": torch.int16}


def _patterns(name):
    """Bit patterns of ``name``: all 65536 of a 16-bit dtype; for float32,
    2^20 drawn from a seed and the specials (both zeros, infinities, quiet
    and signalling NaNs with payloads, the largest finite values, the
    subnormals' ends, and the rounding edges of bfloat16 and float16)."""
    if name != "float32":
        return np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    drawn = np.random.default_rng(0).integers(0, 1 << 32, 1 << 20, dtype=np.uint64)
    specials = np.array([
        0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
        0x7F800001, 0xFF800001, 0x7FBFFFFF, 0x7FC00001, 0x7F810000, 0xFFFFFFFF,
        0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F7FFF, 0x7F7F8000, 0x00000001, 0x807FFFFF,
        0x00800000, 0x477FEFFF, 0x477FF000, 0x477FF001, 0x33000000, 0x33000001,
        0x387FE000, 0x3F808000, 0x3F818000, 0x3F808001,
    ], dtype=np.uint64)
    return np.concatenate([drawn, specials]).astype(np.uint32)


def _torch_of(bits, name):
    if name == "float32":
        return torch.from_numpy(bits.view(np.int32)).view(torch.float32)
    return torch.from_numpy(bits.view(np.int16)).view(getattr(torch, name))


def _jax_of(bits, name):
    return jnp.asarray(bits.view({"float32": np.float32, "float16": np.float16,
                                  "bfloat16": ml_dtypes.bfloat16}[name]))


def _bits(x, name):
    """The bit patterns of a torch tensor or a JAX/numpy array of ``name``."""
    if isinstance(x, torch.Tensor):
        return x.view(_INT[name]).numpy().view(_UINT[name])
    return np.asarray(x).view(_UINT[name])


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.detach().to(torch.float32).numpy()


# -- the casts --------------------------------------------------------------------------
@pytest.mark.parametrize("src,dst", [(a, b) for a in FLOATS for b in FLOATS if a != b])
def test_astype_is_jnp_astype_bit_for_bit(src, dst):
    """Every pattern of ``_patterns(src)`` cast to ``dst``: subnormals,
    overflow to infinity, NaNs (whose payload and sign JAX keeps as 0x7fc0
    with the sign bit in bfloat16, where a plain torch cast does not),
    equal bit for bit."""
    bits = _patterns(src)
    got = astype(_torch_of(bits, src), getattr(torch, dst))
    assert got.dtype == getattr(torch, dst)
    want = _jax_of(bits, src).astype(getattr(jnp, dst))
    np.testing.assert_array_equal(_bits(got, dst), _bits(want, dst))


# -- the plain decode attention and the kernel's argument check -------------------------------
@pytest.mark.parametrize("qname,kvname", PAIRS)
def test_decode_attention_ref_casts_kv_as_jax(qname, kvname):
    """On K/V in another dtype the plain version equals itself on K/V cast
    to q's dtype by ``astype`` (``==``), and the JAX function over
    ``k.astype(q.dtype)`` at the tolerances."""
    rng = np.random.default_rng(1)
    B, C, Hq, Hk, D = 3, 40, 8, 2, 32
    qd, kvd = getattr(torch, qname), getattr(torch, kvname)
    q = _t(rng.standard_normal((B, Hq, D)), qd)
    k, v = (_t(rng.standard_normal((B, C, Hk, D)), kvd) for _ in range(2))
    lengths = torch.tensor([1, 17, 40], dtype=torch.int32)
    got = ops.decode_attention(q, k, v, lengths)
    assert got.dtype == qd
    assert torch.equal(got, decode_attention_ref(q, astype(k, qd), astype(v, qd), lengths))
    jq = jnp.asarray(_np(q)).astype(getattr(jnp, qname))
    jk, jv = (jnp.asarray(_np(t)).astype(getattr(jnp, kvname)).astype(getattr(jnp, qname))
              for t in (k, v))
    want = jax_decode_attention_ref(jq, jk, jv, jnp.asarray(lengths.numpy()))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **TOL[qname])


def test_decode_args_take_the_built_kinds_and_refuse_others():
    """The kernel's argument check takes K/V in q's dtype, in float8, and in
    each pair of ``PAIRS``; it refuses float64 K/V, float16 q and K/V of
    two dtypes, each with a ``TypeError``."""
    rng = np.random.default_rng(2)
    q = _t(rng.standard_normal((2, 8, 64)))
    k, v = (_t(rng.standard_normal((2, 96, 2, 64))) for _ in range(2))
    lengths = torch.tensor([5, 96], dtype=torch.int32)
    for qname, kvname in PAIRS:
        qd, kvd = getattr(torch, qname), getattr(torch, kvname)
        check_decode_args(q.to(qd), k.to(kvd), v.to(kvd), lengths)
        assert kv_kind(qd, kvd) not in (None, 0, 1, 2)
    assert {kv_kind(getattr(torch, a), getattr(torch, b)) for a, b in PAIRS} == {3, 4, 5}
    with pytest.raises(TypeError, match="no kernel"):
        check_decode_args(q, k.double(), v.double(), lengths)
    with pytest.raises(TypeError, match="q must be"):
        check_decode_args(q.half(), k, v, lengths)
    with pytest.raises(TypeError, match="share one dtype"):
        check_decode_args(q, k.to(torch.bfloat16), v.half(), lengths)


# -- gqa_apply over such a cache -----------------------------------------------------------
def _cfgs(dtype, **over):
    jcfg = jax_reduced(jax_get_config("minitron-8b"), n_kv_heads=2, dtype=dtype, **over)
    cfg = reduced(get_config("minitron-8b"), n_kv_heads=2, dtype=dtype, **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _attn(dtype):
    jcfg, cfg = _cfgs(dtype)
    jp = jax_gqa_init(jax.random.PRNGKey(3), jcfg)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("qname,kvname", PAIRS)
@pytest.mark.parametrize("case", ["prefill", "decode", "ring decode"])
def test_gqa_apply_over_a_cache_in_another_dtype_matches_jax(qname, kvname, case):
    """A prefill of 6 tokens from position 0 (the attention kernel's route
    over the new keys and values rounded to ``kv_dtype`` and cast back) and
    a decode step (the decode route over the cache itself; in a ring past
    its wrap too) equal the JAX model's route over ``cache.astype(q.dtype)``
    at the tolerances, and leave a cache in ``kv_dtype`` behind that equals
    the JAX one."""
    jcfg, jp, cfg, p = _attn(qname)
    C, B = 16, 2
    rng = np.random.default_rng(4)
    kvd = getattr(torch, kvname)
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
    tk, tv = astype(_t(k), kvd), astype(_t(v), kvd)
    tcache = {"k": tk.clone(), "v": tv.clone(), "pos": torch.from_numpy(pos_k.copy())}
    jcache = {"k": _jax_of(_bits(tk, kvname), kvname), "v": _jax_of(_bits(tv, kvname), kvname),
              "pos": jnp.asarray(pos_k)}
    x = rng.standard_normal((B, positions.shape[1], cfg.d_model)).astype(np.float32)
    seen = []

    def attn_fn(q, kk, vv, causal, window):
        seen.append(("attention", kk.dtype))
        return ops.attention(q, kk, vv, causal=causal, window=window)

    def decode_fn(q, kk, vv, lengths):
        seen.append(("decode", kk.dtype, vv.dtype))
        assert kk is tcache["k"] and vv is tcache["v"]      # the cache itself, not cast
        return ops.decode_attention(q, kk, vv, lengths)

    qd = getattr(torch, qname)
    got, new = gqa_apply(cfg, p, _t(x, qd), torch.from_numpy(positions), cache=tcache,
                         window=window, attn_fn=attn_fn, decode_fn=decode_fn, gapless=True)
    want, jnew = jax_gqa_apply(jcfg, jp, jnp.asarray(x).astype(getattr(jnp, qname)),
                               jnp.asarray(positions), window=window, cache=jcache)
    assert seen == ([("attention", qd)] if case == "prefill" else [("decode", kvd, kvd)])
    assert got.dtype == qd and new["k"].dtype == kvd
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **TOL[qname])
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(new[key]), np.asarray(jnew[key], np.float32),
                                   **_cache_tol(qname, kvname))
    np.testing.assert_array_equal(new["pos"].numpy(), np.asarray(jnew["pos"]))


# -- the model and the engines --------------------------------------------------------------
@pytest.fixture(scope="module", params=PAIRS, ids=["-".join(p) for p in PAIRS])
def kv_pair(request):
    dtype, kv_dtype = request.param
    jcfg, cfg = _cfgs(dtype, kv_dtype=kv_dtype)
    jparams = JaxLM(jcfg).init(jax.random.PRNGKey(8))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, LM(cfg, device="cpu"), params


def test_prefill_and_decode_over_the_cache_match_jax(kv_pair):
    """The reduced model with its cache in ``kv_dtype``: the prefill's and 4
    decode steps' logits against the JAX model's at the tolerances, the
    same greedy tokens, and the same cache."""
    jcfg, jparams, model, params = kv_pair
    B, S, steps, C = 2, 24, 4, 40
    toks = np.random.default_rng(9).integers(0, jcfg.vocab, (B, S))
    jmodel = JaxLM(jcfg)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                            jmodel.init_cache(B, C))
    caches = model.init_cache(B, C)
    assert caches[0]["k"].dtype == getattr(torch, jcfg.kv_dtype)
    lg, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)}, caches)
    tol = TOL[jcfg.dtype]
    np.testing.assert_allclose(_np(lg), np.asarray(jl, np.float32), **tol)
    for t in range(steps):
        nxt, jnxt = torch.argmax(lg, -1), jnp.argmax(jl, -1)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        pos = np.full((B,), S + t, np.int32)
        jl, jc = jmodel.decode_step(jparams, jnxt.astype(jnp.int32), jnp.asarray(pos), jc)
        lg, caches = model.decode_step(params, nxt, torch.from_numpy(pos), caches)
        np.testing.assert_allclose(_np(lg), np.asarray(jl, np.float32), **tol)
    for key in ("k", "v"):
        assert caches[0][key].dtype == getattr(torch, jcfg.kv_dtype)
        np.testing.assert_allclose(_np(caches[0][key]), np.asarray(jc[0][key], np.float32),
                                   **_cache_tol(jcfg.dtype, jcfg.kv_dtype))
    np.testing.assert_array_equal(caches[0]["pos"].numpy(), np.asarray(jc[0]["pos"]))


def _serve(engine, requests):
    pending, done = list(requests), {}
    while len(done) < len(requests):
        while pending and engine.free_slots():
            engine.add_request(*pending.pop(0))
        done.update(engine.step())
    return done


def test_engines_over_the_cache_give_the_same_tokens(kv_pair):
    """Six requests through two slots (slots reused, the cache spliced).
    Under a float32 model the port's engine and the JAX engine give the same
    greedy tokens.  Under a bfloat16 model the two engines already part at a
    few near ties with a cache in the model's own dtype (the projections
    round in another order), so there each engine's tokens over the float32
    or float16 cache equal its own over a bfloat16 cache, which holds the
    same values: the cache adds no difference in either package."""
    jcfg, jparams, model, params = kv_pair
    rng = np.random.default_rng(10)
    reqs = [(f"req{i}", rng.integers(0, jcfg.vocab, n).tolist(), m)
            for i, (n, m) in enumerate([(12, 3), (5, 9), (12, 4), (20, 2), (5, 6), (12, 5)])]
    jax_out = _serve(JaxServingEngine(JaxLM(jcfg), jparams, max_batch=2, max_seq=32), reqs)
    engine = ServingEngine(model, params, max_batch=2, max_seq=32)
    assert all(c["k"].dtype == getattr(torch, jcfg.kv_dtype) for c in engine.caches)
    out = _serve(engine, reqs)
    if jcfg.dtype == "float32":
        assert out == jax_out
        return
    jcfg16 = dataclasses.replace(jcfg, kv_dtype=None)
    assert _serve(JaxServingEngine(JaxLM(jcfg16), jparams, max_batch=2, max_seq=32),
                  reqs) == jax_out
    model16 = LM(dataclasses.replace(model.cfg, kv_dtype=None), device="cpu")
    assert _serve(ServingEngine(model16, params, max_batch=2, max_seq=32), reqs) == out
