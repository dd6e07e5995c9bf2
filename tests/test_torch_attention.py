"""The port's attention and its layers (``repro_torch``) held against the JAX
package.

Inputs are made with numpy from a seed and handed to both sides.  JAX runs
on the CPU; its Pallas flash-attention kernel runs in interpret mode, as the
JAX package's own tests run it.  On the CPU the port's ``ops.attention``
takes the plain version; ``test_torch_kernels_cuda.py`` holds the CUDA
kernel against it on a card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention import flash_attention_trainable as jax_flash_trainable
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models import reduced as jax_reduced
from repro.models.attention import gqa_apply as jax_gqa_apply
from repro.models.attention import gqa_init as jax_gqa_init
from repro.models.attention import make_cache as jax_make_cache
from repro.models.layers import apply_rope as jax_apply_rope
from repro.models.layers import mlp_apply as jax_mlp_apply
from repro.models.layers import mlp_init as jax_mlp_init
from repro.models.layers import norm_apply as jax_norm_apply

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    check_attention_args,
    flash_attention,
    flash_attention_trainable,
    tile_plan,
)
from repro_torch.models import params_from_jax, reduced
from repro_torch.models.attention import gqa_apply, make_cache
from repro_torch.models.layers import apply_rope, mlp_apply, norm_apply

# the JAX package's kernel-sweep tolerances (tests/test_kernels.py)
TOL = {"float32": dict(atol=3e-5, rtol=3e-5), "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def _qkv(seed, B, S, Hq, Hk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, D)).astype(np.float32),
            rng.standard_normal((B, S, Hk, D)).astype(np.float32),
            rng.standard_normal((B, S, Hk, D)).astype(np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("B,S,Hq,Hk,D,causal,window", [
    (1, 128, 4, 4, 32, True, None),       # MHA
    (1, 256, 8, 2, 64, True, None),       # GQA
    (2, 128, 4, 1, 128, True, None),      # MQA
    (1, 200, 8, 2, 32, True, None),       # ragged S: JAX takes one block of S
    (1, 256, 4, 2, 64, True, 64),
    (1, 256, 4, 1, 32, True, 128),
    (1, 128, 8, 2, 64, False, None),
    (1, 200, 4, 4, 128, False, 64),
    (1, 128, 16, 1, 256, True, 64),       # RecurrentGemma's heads: MQA, D=256, a window
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_attention_matches_jax_kernel_and_ref(B, S, Hq, Hk, D, causal, window, dtype):
    q, k, v = _qkv(0, B, S, Hq, Hk, D)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    out = ops.attention(_t(q, td), _t(k, td), _t(v, td), causal=causal, window=window)
    assert out.dtype == td and tuple(out.shape) == (B, S, Hq, D)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    block = 128 if S % 128 == 0 else S
    want_kernel = jax_flash_attention(jq, jk, jv, causal=causal, window=window,
                                      block_q=block, block_k=block, interpret=True)
    want_ref = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_np(out), np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("window", [None, 48])
def test_trainable_gradients_match_jax(window):
    B, S, Hq, Hk, D = 1, 128, 4, 2, 32
    q, k, v = _qkv(1, B, S, Hq, Hk, D)
    g = np.random.default_rng(2).standard_normal((B, S, Hq, D)).astype(np.float32)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = flash_attention_trainable(tq, tk, tv, causal=True, window=window)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(g))

    def f(q_, k_, v_):
        o = jax_flash_trainable(q_, k_, v_, causal=True, window=window, interpret=True)
        return jnp.sum(o * g)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for got, ref in zip(grads, want):
        np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_kernel_wrapper_rejects_what_it_does_not_take():
    q, k, v = (_t(a) for a in _qkv(3, 1, 16, 4, 2, 32))
    check_attention_args(q, k, v)
    with pytest.raises(ValueError, match="head size"):
        check_attention_args(q[..., :16].contiguous(), k[..., :16].contiguous(),
                             v[..., :16].contiguous())
    with pytest.raises(ValueError, match="multiple"):
        check_attention_args(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(TypeError):
        check_attention_args(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        check_attention_args(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="window"):
        check_attention_args(q, k, v, window=0)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)           # the kernel takes CUDA tensors only
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(*(t.bfloat16() for t in (q, k, v)))
    assert flash_attention.launches == before


def _kv_l2_bytes_brute(B, S, Hq, Hk, D, causal, window):
    """The K/V bytes a call loads from L2, row by row: a block loads each kv
    tile of BN keys that any of its rows may see, its keys inside S."""
    plan = tile_plan(B, S, Hq, Hk, D, causal=causal, window=window)
    T, BN = plan["tokens_per_block"], 128 if D <= 64 else 64
    rows = 0
    for t in range(plan["token_tiles"]):
        tiles = {key // BN for tok in range(t * T, min(t * T + T, S)) for key in range(S)
                 if (not causal or key <= tok) and (not window or key > tok - window)}
        rows += sum(min(BN, S - kt * BN) for kt in tiles)
    return B * Hk * plan["head_chunks"] * rows * 2 * D * 2


@pytest.mark.parametrize("B,S,Hq,Hk,D,window,want", [
    # the training shape: 64 tokens of one head a block
    pytest.param(4, 2048, 16, 16, 64, None, (1, 64, 1, 32, 2048), id="4-2048-16-16-want0"),
    # the dense prefill: 16 tokens x 4 heads, 2 blocks on 128 SMs
    pytest.param(1, 512, 32, 8, 128, None, (4, 16, 1, 32, 256), id="1-512-32-8-want1"),
    # g=64: one token of 64 heads a block
    pytest.param(1, 100, 64, 1, 128, None, (64, 1, 1, 100, 100), id="1-100-64-1-want2"),
    # g=3: 63 of 64 rows busy
    pytest.param(2, 100, 6, 2, 32, None, (3, 21, 1, 5, 20), id="2-100-6-2-want3"),
    # g > 64: three head chunks
    pytest.param(1, 9, 160, 1, 128, None, (64, 1, 3, 9, 27), id="1-9-160-1-want4"),
    # RecurrentGemma's prefill: 4 tokens x 16 heads
    pytest.param(1, 512, 16, 1, 256, 2048, (16, 4, 1, 128, 128), id="1-512-16-1-want5"),
    # MHA at D = 64: two adjacent blocks' 64 tokens share one 128-key
    # diagonal tile, which the first block sees only in part
    (1, 256, 8, 8, 64, None, (1, 64, 1, 4, 32)),
    # S = 100 is not a multiple of a block's 8 tokens: the last block holds 4
    (1, 100, 64, 8, 128, None, (8, 8, 1, 13, 104)),
    # a 100-token window starts inside a block's 16 tokens and mid-tile
    (1, 512, 32, 8, 128, 100, (4, 16, 1, 32, 256)),
])
def test_tile_plan_covers_every_row_once(B, S, Hq, Hk, D, window, want):
    """The bf16 kernel's blocks: heads_per_block x tokens_per_block rows of
    at most 64, head chunks covering each group's g heads and token tiles
    covering S; the K/V bytes the plan counts from L2 are those of the kv
    tiles each block's rows may see, counted row by row."""
    plan = tile_plan(B, S, Hq, Hk, D, window=window)
    keys = ("heads_per_block", "tokens_per_block", "head_chunks", "token_tiles", "blocks")
    assert tuple(plan[key] for key in keys) == want
    hb, T = plan["heads_per_block"], plan["tokens_per_block"]
    assert hb * T <= 64 and hb * plan["head_chunks"] >= Hq // Hk
    assert T * plan["token_tiles"] >= S > T * (plan["token_tiles"] - 1)
    if S <= 512:
        assert plan["kv_l2_bytes"] == _kv_l2_bytes_brute(B, S, Hq, Hk, D, True, window)


@pytest.mark.parametrize("B,S,Hq,Hk,D,window,tiles,want", [
    # Qwen2-VL's training shape: a block (8 tokens x 8 heads) j sees the
    # 64-key tiles 0..(8j+7)//64, for each of 8 kv heads
    (1, 2048, 64, 8, 128, None, 8 * sum((8 * j + 7) // 64 + 1 for j in range(256)),
     1_107_296_256),
    # the training shape: a block (64 tokens) j sees the 128-key tiles
    # 0..(64j+63)//128, for each of 4 x 16 (b, head)
    (4, 2048, 16, 16, 64, None, 64 * sum((64 * j + 63) // 128 + 1 for j in range(32)),
     570_425_344),
    # the dense prefill: a block (16 tokens x 4 heads) j sees the 64-key
    # tiles 0..(16j+15)//64, for each of 8 kv heads
    (1, 512, 32, 8, 128, None, 8 * sum((16 * j + 15) // 64 + 1 for j in range(32)),
     37_748_736),
    # RecurrentGemma's training shape, a 2048-token window: a block (4
    # tokens x 16 heads) j sees the 64-key tiles from (4j-2047)//64 (from 0
    # while 4j < 2048) to (4j+3)//64
    (1, 4096, 16, 1, 256, 2048,
     sum((4 * j + 3) // 64 + 1 - max(0, (4 * j - 2047) // 64) for j in range(1024)),
     1_660_944_384),
])
def test_tile_plan_counts_the_l2_bytes_by_hand(B, S, Hq, Hk, D, window, tiles, want):
    """The K/V bytes a call fetches from L2 under the plan: each kv tile a
    block loads, BN keys of D bf16 values of K and of V, for every (b, kv
    head), counted by hand."""
    plan = tile_plan(B, S, Hq, Hk, D, window=window)
    BN = 128 if D <= 64 else 64
    assert plan["kv_l2_bytes"] == tiles * BN * D * 2 * 2 == want


# -- layers ------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qwen_cfgs():
    return jax_reduced(jax_get_config("qwen1.5-0.5b")), reduced(get_config("qwen1.5-0.5b"))


def test_rmsnorm_matches_jax(qwen_cfgs):
    jcfg, cfg = qwen_cfgs
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 16, cfg.d_model)) * 3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cfg.d_model).astype(np.float32)
    got = norm_apply(cfg, {"scale": _t(scale)}, _t(x))
    want = jax_norm_apply(jcfg, {"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "mlp"])
def test_mlp_matches_jax(qwen_cfgs, mlp):
    jcfg, cfg = (dataclasses.replace(c, mlp=mlp) for c in qwen_cfgs)
    jp = jax_mlp_init(jax.random.PRNGKey(5), jcfg)
    x = np.random.default_rng(5).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    got = mlp_apply(cfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"), _t(x))
    want = jax_mlp_apply(jcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_rope_matches_jax(qwen_cfgs):
    _, cfg = qwen_cfgs
    assert cfg.rope_theta == 1e6
    q, k, _ = _qkv(6, 2, 128, 4, 2, 32)
    pos = np.broadcast_to(np.arange(128, dtype=np.int32), (2, 128))
    gq, gk = apply_rope(_t(q), _t(k), torch.from_numpy(pos.copy()), cfg.rope_theta)
    wq, wk = jax_apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), cfg.rope_theta)
    np.testing.assert_allclose(_np(gq), np.asarray(wq), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(gk), np.asarray(wk), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None),      # the kernel route
    (True, 32, None),        # the kernel route, windowed
    (False, None, None),     # _mask_bias / _sdpa
    (True, None, 30.0),      # a softcap: _mask_bias / _sdpa
])
def test_gqa_apply_matches_jax(qwen_cfgs, causal, window, softcap):
    jcfg, cfg = (dataclasses.replace(c, n_kv_heads=2, attn_logit_softcap=softcap)
                 for c in qwen_cfgs)
    jp = jax_gqa_init(jax.random.PRNGKey(7), jcfg)
    jp = jax.tree.map(lambda a: a + 0.01, jp)       # nonzero QKV biases
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (2, 64)).copy()
    got, cache = gqa_apply(cfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
                           _t(x), torch.from_numpy(pos), causal=causal, window=window)
    want, _ = jax_gqa_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), causal=causal,
                            window=window)
    assert cache is None
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_gqa_apply_says_where_unported_paths_are_queued(qwen_cfgs):
    """Paths once queued in ROADMAP.md now compute the JAX function: a
    cache in another dtype than the model's (here bfloat16 under a float32
    model, read through the JAX route: the prefill is not vouched gapless),
    a float8 cache (``kv_dtype``), cross-attention (``kv_x``, written into a
    cache and then read from it with ``cache_read_only``) and M-RoPE: here a
    float8 cache through the cross-attention write and read."""
    jcfg, cfg = qwen_cfgs
    jp = jax_gqa_init(jax.random.PRNGKey(11), jcfg)
    p = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5)).copy()
    enc_pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    pos1 = np.full((2, 1), 5, np.int32)
    kv_dtype = make_cache(cfg, 1, 8, 1, torch.device("cpu"), dtype=torch.bfloat16)
    kv_dtype = {key: val[:, 0] for key, val in kv_dtype.items()}  # another dtype than the model's

    def close(got, want):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)

    jkv = {key: val[0] for key, val in jax_make_cache(jcfg, 1, 8, 1,
                                                      dtype=jnp.bfloat16).items()}
    got, kv_dtype = gqa_apply(cfg, p, _t(x[:1]), torch.from_numpy(pos[:1]), cache=kv_dtype)
    want, jkv = jax_gqa_apply(jcfg, jp, jnp.asarray(x[:1]), jnp.asarray(pos[:1]), cache=jkv)
    assert kv_dtype["k"].dtype == torch.bfloat16
    # the cache within one bfloat16 step of JAX's; the output at the model's 5e-4
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(kv_dtype[key]), np.asarray(jkv[key], np.float32),
                                   atol=2.0 ** -7, rtol=2.0 ** -7)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=5e-4, rtol=5e-4)

    cross = dict(causal=False)
    got, none = gqa_apply(cfg, p, _t(x), torch.from_numpy(pos), kv_x=_t(enc),
                          kv_positions=torch.from_numpy(enc_pos), **cross)
    want, _ = jax_gqa_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), kv_x=jnp.asarray(enc),
                            kv_positions=jnp.asarray(enc_pos), **cross)
    assert none is None
    close(got, want)
    cache = {key: val[0] for key, val in make_cache(cfg, 2, 9, 1, torch.device("cpu")).items()}
    jcache = {key: val[0] for key, val in jax_make_cache(jcfg, 2, 9, 1).items()}
    got, cache = gqa_apply(cfg, p, _t(x), torch.from_numpy(pos), kv_x=_t(enc),
                           kv_positions=torch.from_numpy(enc_pos), cache=cache, **cross)
    want, jcache = jax_gqa_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                 kv_x=jnp.asarray(enc), kv_positions=jnp.asarray(enc_pos),
                                 cache=jcache, **cross)
    close(got, want)
    got, same = gqa_apply(cfg, p, _t(x1), torch.from_numpy(pos1), cache=cache,
                          cache_read_only=True, **cross)
    want, _ = jax_gqa_apply(jcfg, jp, jnp.asarray(x1), jnp.asarray(pos1), cache=jcache,
                            cache_read_only=True, **cross)
    assert same is cache
    close(got, want)
    f8 = {key: val[0] for key, val in make_cache(cfg, 2, 9, 1, torch.device("cpu"),
                                                   dtype=torch.float8_e4m3fn).items()}
    jf8 = {key: val[0] for key, val in jax_make_cache(jcfg, 2, 9, 1,
                                                      dtype=jnp.float8_e4m3fn).items()}
    got, f8 = gqa_apply(cfg, p, _t(x), torch.from_numpy(pos), kv_x=_t(enc),
                        kv_positions=torch.from_numpy(enc_pos), cache=f8, **cross)
    want, jf8 = jax_gqa_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), kv_x=jnp.asarray(enc),
                              kv_positions=jnp.asarray(enc_pos), cache=jf8, **cross)
    close(got, want)
    for key in ("k", "v"):
        assert f8[key].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(f8[key].view(torch.uint8).numpy(),
                                      np.asarray(jf8[key]).view(np.uint8))
    got, _ = gqa_apply(cfg, p, _t(x1), torch.from_numpy(pos1), cache=f8, cache_read_only=True,
                       **cross)
    want, _ = jax_gqa_apply(jcfg, jp, jnp.asarray(x1), jnp.asarray(pos1), cache=jf8,
                            cache_read_only=True, **cross)
    close(got, want)
    with pytest.raises(ValueError, match="cache_read_only"):
        gqa_apply(cfg, p, _t(x1), torch.from_numpy(pos1), cache_read_only=True, **cross)

    sections = dict(rope="mrope", mrope_sections=(4, 6, 6))
    ids = rng.integers(0, 99, (3, 2, 5)).astype(np.int32)
    got, _ = gqa_apply(dataclasses.replace(cfg, **sections), p, _t(x), torch.from_numpy(pos),
                       position_ids=torch.from_numpy(ids))
    want, _ = jax_gqa_apply(dataclasses.replace(jcfg, **sections), jp, jnp.asarray(x),
                            jnp.asarray(pos), position_ids=jnp.asarray(ids))
    close(got, want)