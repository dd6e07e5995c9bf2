"""The port's MLA (``repro_torch.models.attention.mla_apply``, DeepSeek-V3's
multi-head latent attention) held against the JAX package: the expanded
and the absorbed form, with and without a cache, the cache's writes, its
layout, and the weight conversion.

Inputs are made with numpy from a seed and handed to both sides; the JAX
weights are carried across with ``params_from_jax``.  float32 on the CPU,
compared at 5e-4; cache positions exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import LM as JaxLM
from repro.models import reduced as jax_reduced
from repro.models.attention import make_mla_cache as jax_make_mla_cache
from repro.models.attention import mla_apply as jax_mla_apply
from repro.models.attention import mla_init as jax_mla_init

from repro_torch.configs import get_config
from repro_torch.models import LM, params_from_jax, reduced
from repro_torch.models.attention import make_mla_cache, mla_apply

TOL = dict(atol=5e-4, rtol=5e-4)
ARCH = "deepseek-v3-671b"
CPU = torch.device("cpu")


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.fixture(scope="module")
def mla_pair():
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jp = jax_mla_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _x(B, S, d, seed):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _cache(cfg, B, C, seed):
    """A one-layer latent cache with random entries at the first C//2 slots
    (positions 0..C//2-1) and every other slot empty."""
    rng = np.random.default_rng(seed)
    m = cfg.mla
    n = C // 2
    ckv = np.zeros((B, C, m.kv_lora_rank), np.float32)
    krope = np.zeros((B, C, m.qk_rope_head_dim), np.float32)
    pos = np.full((B, C), -1, np.int32)
    ckv[:, :n] = rng.standard_normal((B, n, m.kv_lora_rank))
    krope[:, :n] = rng.standard_normal((B, n, m.qk_rope_head_dim))
    pos[:, :n] = np.arange(n)
    return {"ckv": ckv, "krope": krope, "pos": pos}


@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_without_cache_matches_jax(mla_pair, absorbed):
    jcfg, jp, cfg, p = mla_pair
    x = _x(2, 12, cfg.d_model, 1)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    out, cache = mla_apply(cfg, p, torch.from_numpy(x), torch.from_numpy(pos),
                           absorbed=absorbed)
    jout, _ = jax_mla_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), absorbed=absorbed)
    assert cache is None
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)


@pytest.mark.parametrize("absorbed", [None, False, True])
@pytest.mark.parametrize("S", [1, 5])
def test_mla_with_cache_matches_jax(mla_pair, S, absorbed):
    """Tokens at positions C//2.. over a half-filled cache: the output and
    the cache written in place (ckv, krope, pos) equal the JAX function's.
    ``absorbed=None`` picks the absorbed form for S == 1, as in JAX."""
    jcfg, jp, cfg, p = mla_pair
    B, C = 2, 16
    cache = _cache(cfg, B, C, seed=2)
    x = _x(B, S, cfg.d_model, 3)
    pos = np.broadcast_to(np.arange(C // 2, C // 2 + S, dtype=np.int32), (B, S)).copy()
    tcache = {key: torch.from_numpy(val.copy()) for key, val in cache.items()}
    out, new = mla_apply(cfg, p, torch.from_numpy(x), torch.from_numpy(pos), cache=tcache,
                         absorbed=absorbed)
    jout, jnew = jax_mla_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                               cache={key: jnp.asarray(val) for key, val in cache.items()},
                               absorbed=absorbed)
    assert new is tcache
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
    np.testing.assert_array_equal(new["pos"].numpy(), np.asarray(jnew["pos"]))
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(_np(new[key]), np.asarray(jnew[key]), **TOL)


def test_absorbed_decode_equals_expanded(mla_pair):
    """The two forms compute one function: a decode step over a cache in the
    absorbed form equals the same step in the expanded form."""
    _, _, cfg, p = mla_pair
    B, C = 3, 16
    cache = _cache(cfg, B, C, seed=4)
    x = torch.from_numpy(_x(B, 1, cfg.d_model, 5))
    pos = torch.tensor([[C // 2], [3], [C // 2]], dtype=torch.int32)
    outs = []
    for absorbed in (True, False):
        tcache = {key: torch.from_numpy(val.copy()) for key, val in cache.items()}
        outs.append(mla_apply(cfg, p, x, pos, cache=tcache, absorbed=absorbed)[0])
    np.testing.assert_allclose(_np(outs[0]), _np(outs[1]), **TOL)


def test_cache_writes_clip_at_the_last_slot(mla_pair):
    """A position past the cache's end is written to its last slot, as the
    JAX ``_ring_write`` at ``clip(p, 0, C-1)`` does, and the output still
    equals the JAX function's."""
    jcfg, jp, cfg, p = mla_pair
    B, C = 2, 8
    cache = _cache(cfg, B, C, seed=6)
    x = _x(B, 1, cfg.d_model, 7)
    pos = np.asarray([[C + 3], [C - 1]], np.int32)
    tcache = {key: torch.from_numpy(val.copy()) for key, val in cache.items()}
    out, new = mla_apply(cfg, p, torch.from_numpy(x), torch.from_numpy(pos), cache=tcache)
    jout, jnew = jax_mla_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                               cache={key: jnp.asarray(val) for key, val in cache.items()})
    assert new["pos"][:, C - 1].tolist() == [C + 3, C - 1]
    np.testing.assert_array_equal(new["pos"].numpy(), np.asarray(jnew["pos"]))
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
    np.testing.assert_allclose(_np(new["ckv"]), np.asarray(jnew["ckv"]), **TOL)


def test_mla_cache_layout_matches_jax(mla_pair):
    jcfg, _, cfg, _ = mla_pair
    cache = make_mla_cache(cfg, 3, 40, 2, CPU)
    jcache = jax_make_mla_cache(jcfg, 3, 40, 2)
    assert set(cache) == set(jcache) == {"ckv", "krope", "pos"}
    for key in cache:
        assert tuple(cache[key].shape) == jcache[key].shape
        assert str(cache[key].dtype)[6:] == str(jcache[key].dtype)
        np.testing.assert_array_equal(_np(cache[key]), np.asarray(jcache[key], np.float32))
    # the LM builds one per segment: DeepSeek's dense segment and its MoE one
    caches = LM(cfg, device="cpu").init_cache(2, 24)
    jcaches = JaxLM(jcfg).init_cache(2, 24)
    assert len(caches) == len(jcaches) == 2
    for c, jc in zip(caches, jcaches):
        assert {key: tuple(t.shape) for key, t in c.items()} == \
            {key: a.shape for key, a in jc.items()}


def test_params_from_jax_carries_the_mla_tree(mla_pair):
    _, jp, _, p = mla_pair
    assert set(p) == set(jp)
    for name, sub in jp.items():
        for key, leaf in sub.items():
            got = p[name][key]
            assert tuple(got.shape) == leaf.shape and str(got.dtype)[6:] == str(leaf.dtype)
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
