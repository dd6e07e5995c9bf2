"""The port's dense serving path with a KV cache (``repro_torch``) held
against the JAX package: the decode attention's plain version and the JAX
``flash_decode`` kernel (in interpret mode), the cache routes of
``gqa_apply`` against the JAX model's ``_mask_bias`` + ``_sdpa`` route over
the same cache, prefill and decode of reduced ``minitron-8b`` and
``qwen1.5-0.5b``, and both ``ServingEngine``s on one request set.

Inputs are made with numpy from a seed and handed to both sides.  On the
CPU the port's ``ops.decode_attention`` takes the plain version;
``test_torch_kernels_cuda.py`` holds the CUDA kernel against it on a card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.ref import decode_attention_ref as jax_decode_attention_ref
from repro.models import LM as JaxLM
from repro.models import reduced as jax_reduced
from repro.models.attention import gqa_apply as jax_gqa_apply
from repro.models.attention import gqa_init as jax_gqa_init
from repro.serve.engine import ServingEngine as JaxServingEngine

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import (MAX_CLUSTER, call_plan, check_decode_args,
                                              clustered, flash_decode, split_plan)
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.launch.serve import serve_demo
from repro_torch.models import LM, params_from_jax, reduced
from repro_torch.models.attention import gqa_apply, make_cache
from repro_torch.serve.engine import ServingEngine

from _torch_config import assert_same_config

# the JAX package's kernel-sweep tolerances (tests/test_kernels.py)
TOL = {"float32": dict(atol=3e-5, rtol=3e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}
# the dense model against the JAX model in float32 (ROADMAP.md)
MODEL_TOL = dict(atol=5e-4, rtol=5e-4)
# reduced configs; minitron keeps GQA (g = 2), which `reduced` alone would make MHA
ARCHS = {"minitron-8b": dict(n_kv_heads=2), "qwen1.5-0.5b": {}}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _np(t):
    return t.detach().to(torch.float32).numpy()


# -- the kernel's plain version ------------------------------------------------------
@pytest.mark.parametrize("B,C,Hq,Hk,D", [
    (2, 512, 8, 2, 64),
    (3, 256, 4, 4, 128),
    (1, 1024, 16, 1, 64),
    (2, 256, 8, 8, 32),
    (2, 256, 16, 1, 256),      # RecurrentGemma's heads: MQA with g = 16, D=256
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax_kernel_and_ref(B, C, Hq, Hk, D, dtype):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, C, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, C, Hk, D)).astype(np.float32)
    lengths = rng.integers(1, C, B).astype(np.int32)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    out = ops.decode_attention(_t(q, td), _t(k, td), _t(v, td), torch.from_numpy(lengths))
    assert out.dtype == td and tuple(out.shape) == (B, Hq, D)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    jl = jnp.asarray(lengths)
    want_kernel = jax_flash_decode(jq, jk, jv, jl, block_k=128, interpret=True)
    want_ref = jax_decode_attention_ref(jq, jk, jv, jl)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_np(out), np.asarray(want, np.float32), **TOL[dtype])


def test_decode_attention_length_masking():
    """Slots past ``lengths`` have no influence (tests/test_kernels.py:89)."""
    rng = np.random.default_rng(1)
    B, C, Hq, Hk, D = 1, 256, 2, 2, 32
    q, k, v = (_t(rng.standard_normal(s)) for s in ((B, Hq, D), (B, C, Hk, D), (B, C, Hk, D)))
    lengths = torch.tensor([100], dtype=torch.int32)
    out1 = ops.decode_attention(q, k, v, lengths)
    k2, v2 = k.clone(), v.clone()
    k2[:, 100:] = 999.0
    v2[:, 100:] = -999.0
    out2 = ops.decode_attention(q, k2, v2, lengths)
    np.testing.assert_allclose(_np(out1), _np(out2), atol=1e-6)


def test_decode_wrapper_rejects_what_it_does_not_take():
    rng = np.random.default_rng(2)
    q, k, v = (_t(rng.standard_normal(s)) for s in ((2, 8, 64), (2, 96, 2, 64), (2, 96, 2, 64)))
    lengths = torch.tensor([5, 96], dtype=torch.int32)
    check_decode_args(q, k, v, lengths)
    with pytest.raises(ValueError, match="head size"):
        check_decode_args(q[..., :16].contiguous(), k[..., :16].contiguous(),
                          v[..., :16].contiguous(), lengths)
    with pytest.raises(ValueError, match="multiple"):
        check_decode_args(q[:, :7].contiguous(), k, v, lengths)
    with pytest.raises(ValueError, match="lengths"):
        check_decode_args(q, k, v, lengths.long())
    with pytest.raises(TypeError):
        check_decode_args(q.half(), k.half(), v.half(), lengths)
    with pytest.raises(ValueError, match="contiguous"):
        check_decode_args(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, lengths)
    with pytest.raises(ValueError, match="16-byte"):
        check_decode_args(torch.zeros(2 * 8 * 64 + 1)[1:].reshape(2, 8, 64), k, v, lengths)
    before = flash_decode.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(q, k, v, lengths)      # the kernel takes CUDA tensors only
    assert flash_decode.launches == before


@pytest.mark.parametrize("B,Hk,C,n_sm", [
    (8, 8, 1024, 132), (1, 8, 1024, 132), (1, 1, 70, 132), (64, 8, 4096, 132),
    (2, 2, 1, 132), (3, 4, 1000, 16),
])
def test_split_plan_covers_the_cache(B, Hk, C, n_sm):
    split_keys, nsplit = split_plan(B, Hk, C, n_sm)
    assert split_keys % 64 == 0 and split_keys >= 64
    assert nsplit * split_keys >= C > (nsplit - 1) * split_keys
    # about two blocks per SM when the cache is full, or one tile per split
    assert B * Hk * nsplit >= min(2 * n_sm, B * Hk * -(-C // 64)) // 2


@pytest.mark.parametrize("B,Hk,C,want", [
    (8, 1, 1024, (64, 16)),      # RecurrentGemma's decode: a 64-slot split a block
    (1, 1, 2048, (128, 16)),     # past its ring's wrap: a row's splits are one cluster
    (1, 1, 40, (64, 1)),         # a cache shorter than a split: one split
])
def test_split_plan_at_d256_gives_64_slot_splits_in_one_cluster(B, Hk, C, want):
    """At D = 256 a bf16 q runs the split-D variant: 64-slot splits, as many
    as a full cache gives, at most MAX_CLUSTER (16) a row, one cluster, and
    no split scratch (the cluster merges in shared memory)."""
    split_keys, nsplit, scratch = call_plan(B, 16 * Hk, Hk, C, 256, torch.bfloat16,
                                            torch.bfloat16, 132)
    assert (split_keys, nsplit) == want and nsplit <= MAX_CLUSTER
    assert scratch == (0, 0, 0)
    assert clustered(256, torch.bfloat16) and not clustered(128, torch.bfloat16)
    assert not clustered(256, torch.float32)


# -- the cache routes of gqa_apply against the JAX model's mask-bias route ------------
@pytest.fixture(scope="module")
def attn_pair():
    jcfg = jax_reduced(jax_get_config("minitron-8b"), n_kv_heads=2)
    cfg = reduced(get_config("minitron-8b"), n_kv_heads=2)
    jp = jax_gqa_init(jax.random.PRNGKey(3), jcfg)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _cache_rows(cfg, C, rows, seed):
    """A one-layer cache of ``len(rows)`` batch rows; each row is a list of
    (slot, position) pairs to fill with random keys and values, every other
    slot empty (-1)."""
    rng = np.random.default_rng(seed)
    B, hk, hd = len(rows), cfg.n_kv_heads, cfg.head_dim
    k = np.zeros((B, C, hk, hd), np.float32)
    v = np.zeros((B, C, hk, hd), np.float32)
    pos = np.full((B, C), -1, np.int32)
    for b, filled in enumerate(rows):
        for slot, p in filled:
            k[b, slot] = rng.standard_normal((hk, hd))
            v[b, slot] = rng.standard_normal((hk, hd))
            pos[b, slot] = p
    return {"k": k, "v": v, "pos": pos}


def _assert_same_cache(cache, jcache):
    """Positions equal; keys and values within f32 rounding of the two
    frameworks' projections."""
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key]), np.asarray(jcache[key]), atol=1e-5, rtol=1e-5)


def _never(*args, **kwargs):
    raise AssertionError("a kernel route was taken")


C_ROUTE = 16
# name -> (cache rows, query positions (B, S), window); C_ROUTE slots per
# row; a window makes the cache a ring written at p % C
ROUTE_CASES = {
    # fresh slots: a prompt of P tokens at slots 0..P-1, decode at P
    "fresh": ([[(i, i) for i in range(5)], [(i, i) for i in range(11)]], [[5], [11]], None),
    # a reused slot: slots past the new request's prompt still hold an older,
    # longer request's entries (positions above the query's)
    "reused": ([[(i, i) for i in range(13)], [(i, i) for i in range(3)] +
                [(i, i) for i in range(3, 9)]], [[4], [3]], None),
    # an idle slot run past C: every slot full, the last one rewritten by
    # each clipped write; the query sees all C slots
    "idle past C": ([[(i, i) for i in range(C_ROUTE - 1)] + [(C_ROUTE - 1, 20)]] * 2,
                    [[21], [C_ROUTE + 40]], None),
    # a prefill of S tokens from position 0 into a cache that holds an older
    # request's entries at positions >= S
    "prefill": ([[(i, i) for i in range(14)], []], [list(range(6))] * 2, None),
    # a ring (window = C) before its wrap: a global cache in all but name
    "ring before wrap": ([[(i, i) for i in range(5)], [(i, i) for i in range(15)]],
                         [[5], [15]], C_ROUTE),
    # a ring past its wrap: the last C positions, out of slot order; the
    # write at p % C replaces the oldest, and every slot is in the window
    "ring past wrap": ([[(p % C_ROUTE, p) for p in range(5, 21)],
                        [(p % C_ROUTE, p) for p in range(24, 40)]], [[21], [40]], C_ROUTE),
    # an idle slot run past C in a ring narrower than its window (capacity
    # below the window), one row far past the wrap, one at p = C exactly
    "ring idle past C": ([[(p % C_ROUTE, p) for p in range(84, 100)],
                          [(p, p) for p in range(C_ROUTE)]], [[100], [C_ROUTE]], 40),
    # a prefill from position 0 into a ring that holds an older request's
    # entries
    "ring prefill": ([[(i, i) for i in range(14)], []], [list(range(6))] * 2, C_ROUTE),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_cache_routes_equal_the_mask_bias_route(attn_pair, case):
    """The port's decode route (``ops.decode_attention`` with lengths =
    min(pos + 1, C)) and prefill route (``flash_attention_trainable`` over
    the new tokens), over a global cache and over a ring, equal the JAX
    model's ``_mask_bias`` + ``_sdpa`` over the same cache, and leave the
    same cache behind."""
    jcfg, jp, cfg, p = attn_pair
    rows, positions, window = ROUTE_CASES[case]
    cache = _cache_rows(cfg, C_ROUTE, rows, seed=4)
    positions = np.asarray(positions, np.int32)
    B, S = positions.shape
    x = np.random.default_rng(5).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    seen = []
    tcache = {key: torch.from_numpy(val.copy()) for key, val in cache.items()}

    def decode_fn(q, k, v, lengths):
        seen.append(lengths.tolist())
        return ops.decode_attention(q, k, v, lengths)

    def attn_fn(q, k, v, causal, window):
        seen.append(q.shape[1])
        return ops.attention(q, k, v, causal=causal, window=window)

    got, new = gqa_apply(cfg, p, _t(x), torch.from_numpy(positions), cache=tcache,
                         window=window, attn_fn=attn_fn, decode_fn=decode_fn, gapless=True)
    want, jnew = jax_gqa_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(positions), window=window,
                               cache={key: jnp.asarray(val) for key, val in cache.items()})
    if S == 1:
        assert seen == [np.minimum(positions[:, 0] + 1, C_ROUTE).tolist()]
    else:
        assert seen == [S]
    assert new is tcache
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    _assert_same_cache(new, jnew)


def test_windowed_cache_and_softcap_take_the_jax_route(attn_pair):
    """A softcap, and a prefill longer than its ring (12 positions into 8
    slots: later positions overwrite earlier ones in the same slot, both
    sides writing in position order on the CPU), take ``_mask_bias`` +
    ``_sdpa`` and equal the JAX model."""
    jcfg, jp, cfg, p = attn_pair
    rng = np.random.default_rng(7)
    softcap_case = (_cache_rows(cfg, 8, [[(i, i) for i in range(5)]], seed=6),
                    np.asarray([[5]], np.int32), None, 30.0)
    ring_case = (_cache_rows(cfg, 8, [[]], seed=6), np.arange(12, dtype=np.int32)[None], 8,
                 None)
    for cache, pos, window, softcap in (softcap_case, ring_case):
        x = rng.standard_normal((1, pos.shape[1], cfg.d_model)).astype(np.float32)
        jc = dataclasses.replace(jcfg, attn_logit_softcap=softcap)
        c = dataclasses.replace(cfg, attn_logit_softcap=softcap)
        got, new = gqa_apply(c, p, _t(x), torch.from_numpy(pos), window=window,
                             cache={key: torch.from_numpy(val.copy()) for key, val in cache.items()},
                             attn_fn=_never, decode_fn=_never, gapless=True)
        want, jnew = jax_gqa_apply(jc, jp, jnp.asarray(x), jnp.asarray(pos), window=window,
                                   cache={key: jnp.asarray(val) for key, val in cache.items()})
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
        _assert_same_cache(new, jnew)


# -- the dense model and the engine ----------------------------------------------------
@pytest.fixture(scope="module", params=list(ARCHS))
def dense_pair(request):
    arch = request.param
    jcfg = jax_reduced(jax_get_config(arch), **ARCHS[arch])
    cfg = reduced(get_config(arch), **ARCHS[arch])
    assert_same_config(cfg, jcfg)
    jparams = JaxLM(jcfg).init(jax.random.PRNGKey(8))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, LM(cfg, device="cpu"), params


def test_config_matches_jax():
    assert_same_config(get_config("minitron-8b"), jax_get_config("minitron-8b"))
    cfg = reduced(get_config("minitron-8b"), n_kv_heads=2)
    assert cfg.n_heads // cfg.n_kv_heads == 2 and cfg.mlp == "mlp" and cfg.act == "relu2"


def test_prefill_and_decode_match_jax(dense_pair):
    jcfg, jparams, model, params = dense_pair
    B, S, steps, C = 2, 24, 8, 48
    toks = np.random.default_rng(9).integers(0, jcfg.vocab, (B, S))
    jmodel = JaxLM(jcfg)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                            jmodel.init_cache(B, C))
    lg, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                               model.init_cache(B, C))
    np.testing.assert_allclose(_np(lg), np.asarray(jl), **MODEL_TOL)
    for t in range(steps):
        nxt, jnxt = torch.argmax(lg, -1), jnp.argmax(jl, -1)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        pos = np.full((B,), S + t, np.int32)
        jl, jc = jmodel.decode_step(jparams, jnxt.astype(jnp.int32), jnp.asarray(pos), jc)
        lg, caches = model.decode_step(params, nxt, torch.from_numpy(pos), caches)
        np.testing.assert_allclose(_np(lg), np.asarray(jl), **MODEL_TOL)
    for key in caches[0]:
        np.testing.assert_allclose(_np(caches[0][key]), np.asarray(jc[0][key], np.float32),
                                   **MODEL_TOL)


def test_backbone_with_given_positions_takes_the_jax_route(dense_pair):
    """Positions handed to ``backbone`` carry no promise about the cache, so
    attention over it takes ``_mask_bias`` + ``_sdpa`` and equals the JAX
    backbone: a chunked prefill (a second chunk after the first), then one
    token at a position past a gap."""
    jcfg, jparams, model, params = dense_pair
    plain = LM(model.cfg, device="cpu", attn_fn=_never, decode_fn=_never)
    B, C = 2, 32
    toks = np.random.default_rng(13).integers(0, jcfg.vocab, (B, 15))
    jmodel = JaxLM(jcfg)
    _, caches = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :8])},
                              model.init_cache(B, C))
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :8], jnp.int32)},
                           jmodel.init_cache(B, C))
    for lo, hi, first in ((8, 14, 8), (14, 15, 20)):
        pos = np.broadcast_to(np.arange(first, first + hi - lo, dtype=np.int32), (B, hi - lo))
        hidden, caches, aux = plain.backbone(params, torch.from_numpy(toks[:, lo:hi]),
                                             positions=torch.from_numpy(pos.copy()),
                                             caches=caches)
        jhidden, jc, jaux = jmodel.backbone(jparams, jnp.asarray(toks[:, lo:hi], jnp.int32),
                                            jnp.asarray(pos), caches=jc)
        np.testing.assert_allclose(_np(hidden), np.asarray(jhidden), **MODEL_TOL)
        np.testing.assert_array_equal(aux.numpy(), np.asarray(jaux))
    np.testing.assert_array_equal(caches[0]["pos"].numpy(), np.asarray(jc[0]["pos"]))


def _serve(engine, requests):
    """Admit requests as slots free up and step until all have finished."""
    pending = list(requests)
    done = {}
    while len(done) < len(requests):
        while pending and engine.free_slots():
            engine.add_request(*pending.pop(0))
        done.update(engine.step())
    return done


def test_engines_give_the_same_tokens(dense_pair):
    """Six requests through two slots, so slots are reused and idle slots
    run on; the port's engine and the JAX engine give the same tokens."""
    jcfg, jparams, model, params = dense_pair
    rng = np.random.default_rng(10)
    reqs = [(f"req{i}", rng.integers(0, jcfg.vocab, n).tolist(), m)
            for i, (n, m) in enumerate([(12, 3), (5, 9), (12, 4), (20, 2), (5, 6), (12, 5)])]
    jax_out = _serve(JaxServingEngine(JaxLM(jcfg), jparams, max_batch=2, max_seq=32), reqs)
    out = _serve(ServingEngine(model, params, max_batch=2, max_seq=32), reqs)
    assert out == jax_out
    assert {rid: len(toks) for rid, toks in out.items()} == {r[0]: r[2] + 1 for r in reqs}


def test_init_cache_layout(dense_pair):
    jcfg, _, model, _ = dense_pair
    (cache,) = model.init_cache(3, 40)
    (jcache,) = JaxLM(jcfg).init_cache(3, 40)
    for key in cache:
        assert tuple(cache[key].shape) == jcache[key].shape
        assert str(cache[key].dtype)[6:] == str(jcache[key].dtype)
        np.testing.assert_array_equal(_np(cache[key]), np.asarray(jcache[key], np.float32))
    windowed = LM(dataclasses.replace(model.cfg, attn_window=16), device="cpu")
    assert windowed.init_cache(2, 40)[0]["k"].shape[2] == 16


@pytest.mark.parametrize("arch", ["minitron-8b", "rwkv6-3b"])
def test_serve_demo_serves_the_other_ported_archs_on_cpu(arch):
    """qwen1.5-0.5b, the default, is served by test_torch_serve.py.  On the
    CPU no kernel is launched."""
    kernels = (flash_attention, flash_decode, rwkv6_scan)
    before = [kern.launches for kern in kernels]
    out = serve_demo(arch, n_requests=6, max_batch=4, device="cpu")
    assert [kern.launches for kern in kernels] == before
    assert len(out["outputs"]) == 6
    assert all(0 <= t < 512 for toks in out["outputs"].values() for t in toks)
    assert np.isfinite(out["interference"]).all()
