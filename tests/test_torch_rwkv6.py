"""The port's RWKV6 path (``repro_torch``) held against the JAX package.

Inputs are made with numpy from a seed and handed to both sides.  JAX runs
on the CPU; its Pallas kernel runs in interpret mode, as the JAX package's
own tests run it.  On the CPU the port's WKV entry point takes the plain
version; ``test_torch_kernels_cuda.py`` holds the CUDA kernel against it on
a card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.ref import rwkv6_ref as jax_rwkv6_ref
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv6_scan
from repro.models import LM as JaxLM
from repro.models import reduced as jax_reduced
from repro.models.recurrent import rwkv6_apply as jax_rwkv6_apply

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rwkv6_ref
from repro_torch.kernels.rwkv6_scan import check_rwkv6_args, chunk_for, rwkv6_scan
from repro_torch.models import LM, params_from_jax, reduced
from repro_torch.models.recurrent import rwkv6_apply

from _torch_config import assert_same_config

CPU = torch.device("cpu")
TOL = {"xla": dict(atol=1e-4, rtol=1e-4), "kernel_interpret": dict(atol=2e-3, rtol=2e-3)}


def _wkv_inputs(seed, B, T, H, N):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        r=(rng.standard_normal((B, T, H, N)) * 0.5).astype(f32),
        k=(rng.standard_normal((B, T, H, N)) * 0.5).astype(f32),
        v=rng.standard_normal((B, T, H, N)).astype(f32),
        w=rng.uniform(0.2, 0.999, (B, T, H, N)).astype(f32),
        u=(rng.standard_normal((H, N)) * 0.2).astype(f32),
        S0=(rng.standard_normal((B, H, N, N)) * 0.1).astype(f32),
    )


def _torch_wkv(inp, dtype=torch.float32, device=CPU):
    t = {key: torch.from_numpy(val).to(device) for key, val in inp.items()}
    for key in ("r", "k", "v"):
        t[key] = t[key].to(dtype)
    return t


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


# -- the plain version against the JAX side ---------------------------------------
@pytest.mark.parametrize("B,T,H,N", [
    (2, 64, 2, 32), (1, 20, 3, 16), (2, 80, 2, 32), (1, 5, 1, 8), (1, 1, 2, 16),
])
def test_ref_matches_jax_ref(B, T, H, N):
    inp = _wkv_inputs(0, B, T, H, N)
    y, s = rwkv6_ref(**_torch_wkv(inp))
    yj, sj = jax_rwkv6_ref(*(jnp.asarray(inp[key]) for key in ("r", "k", "v", "w", "u", "S0")))
    np.testing.assert_allclose(_np(y), np.asarray(yj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(s), np.asarray(sj), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,T,H,N,chunk", [(2, 64, 2, 32, 16), (1, 128, 2, 64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_matches_jax_chunked_kernel(B, T, H, N, chunk, dtype):
    """What a CPU caller of ``ops.rwkv6`` gets, against the Pallas kernel at
    the tolerances of the JAX package's own kernel sweep."""
    inp = _wkv_inputs(1, B, T, H, N)
    y, s = ops.rwkv6(**_torch_wkv(inp, getattr(torch, dtype)))
    jd = getattr(jnp, dtype)
    yj, sj = jax_rwkv6_scan(
        jnp.asarray(inp["r"], jd), jnp.asarray(inp["k"], jd), jnp.asarray(inp["v"], jd),
        jnp.asarray(inp["w"]), jnp.asarray(inp["u"]), jnp.asarray(inp["S0"]),
        chunk=chunk, interpret=True,
    )
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else dict(atol=2e-3, rtol=2e-3)
    assert y.dtype == getattr(torch, dtype) and s.dtype == torch.float32
    np.testing.assert_allclose(_np(y), np.asarray(yj, np.float32), **tol)
    np.testing.assert_allclose(_np(s), np.asarray(sj), **tol)


@pytest.mark.parametrize("split", [64, 37])
def test_ref_state_carry_composes(split):
    """Two pieces with the state carried == one run, ragged split included."""
    inp = _torch_wkv(_wkv_inputs(2, 1, 128, 2, 32))
    y_full, s_full = rwkv6_ref(**inp)
    first = {key: (val[:, :split] if val.dim() == 4 and key != "S0" else val)
             for key, val in inp.items()}
    y1, s1 = rwkv6_ref(**first)
    rest = {key: (val[:, split:] if val.dim() == 4 and key != "S0" else val)
            for key, val in inp.items()}
    rest["S0"] = s1
    y2, s2 = rwkv6_ref(**rest)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y_full), atol=1e-4)
    np.testing.assert_allclose(_np(s2), _np(s_full), atol=1e-4)


# -- the CUDA kernel's arithmetic, rehearsed in numpy ------------------------------
def _factored_wkv(r, k, v, w, u, S0, chunk=32, sub=16):
    """The WKV scan as the CUDA kernel computes it, in f32 numpy: 32-token
    chunks with a masked ragged tail, log-decays in base 2 summed within
    16-token sub-chunks only (a sum across sub-chunks adds sub-chunk totals,
    so no two long prefix sums are subtracted); per chunk the state
    increment and decay, then the carry, then y = A @ v + (r 2^{cum_exc}) @
    S_start.  A's diagonal sub-blocks take an exponential per term; a block
    below the diagonal (rows in sub-chunk q, columns in p < q) is
    (r 2^{exc}) diag(2^{totals of p+1..q-1}) (k 2^{total(p) - cum})^T with
    exc and cum within the row's and the column's sub-chunk, every factor
    <= 1."""
    f32 = np.float32
    B, T, H, N = r.shape
    nch, ns = -(-T // chunk), chunk // sub
    pad = nch * chunk - T

    def chunks(a, fill):
        a = np.concatenate([a, np.full((B, pad, H, N), fill, f32)], 1) if pad else a
        return a.reshape(B, nch, ns, sub, H, N).transpose(0, 4, 1, 2, 3, 5)   # b,h,c,q,t,n

    rc, kc, vc = chunks(r, 0), chunks(k, 0), chunks(v, 0)
    loc = np.cumsum(np.log2(np.maximum(chunks(w, 1), f32(1e-30))), axis=4, dtype=f32)
    exc = np.concatenate([np.zeros_like(loc[..., :1, :]), loc[..., :-1, :]], 4)
    tot = loc[..., -1, :]                                                   # b,h,c,q,n

    def span(lo, hi):                       # log-decay of sub-chunks lo..hi-1
        out = np.zeros_like(tot[..., 0, :])
        for s in range(lo, hi):
            out = out + tot[..., s, :]
        return out

    ds = sum(np.einsum("bhcin,bhcij->bhcnj", kc[..., q, :, :] * np.exp2(
        (tot[..., q, None, :] - loc[..., q, :, :]) + span(q + 1, ns)[..., None, :]),
        vc[..., q, :, :]) for q in range(ns))
    starts, S = [], S0.astype(f32)
    for c in range(nch):
        starts.append(S)
        S = np.exp2(span(0, ns)[:, :, c, :, None]) * S + ds[:, :, c]
    start = np.stack(starts, 2)
    ys = []
    tri = np.arange(sub)
    for q in range(ns):
        rq, kq = rc[..., q, :, :], kc[..., q, :, :]
        dec = np.exp2(np.minimum(exc[..., q, :, None, :] - loc[..., q, None, :, :], 0))
        A = np.where(tri[:, None] > tri[None, :],
                     np.einsum("bhctn,bhcin,bhctin->bhcti", rq, kq, dec), 0)
        A[..., tri, tri] = np.einsum("bhctn,hn,bhctn->bhct", rq, u, kq)
        y = np.einsum("bhcti,bhcij->bhctj", A, vc[..., q, :, :])
        for p in range(q):
            kp = kc[..., p, :, :] * np.exp2(tot[..., p, None, :] - loc[..., p, :, :])
            link = np.exp2(span(p + 1, q))[..., None, :]
            A = np.einsum("bhctn,bhcin->bhcti", rq * np.exp2(exc[..., q, :, :]) * link, kp)
            y = y + np.einsum("bhcti,bhcij->bhctj", A, vc[..., p, :, :])
        rt = rq * np.exp2(span(0, q)[..., None, :] + exc[..., q, :, :])
        ys.append(y + np.einsum("bhctn,bhcnj->bhctj", rt, start))
    y = np.stack(ys, 3).reshape(B, H, nch * chunk, N).transpose(0, 2, 1, 3)[:, :T]
    return y, S


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("B,T,H,N", [(1, 64, 2, 64), (2, 200, 2, 32), (1, 17, 3, 64),
                                     (1, 512, 2, 64)])
def test_factored_wkv_arithmetic_matches_jax_ref(B, T, H, N, strong):
    """The kernel's factored A, held against the JAX reference in f32 on mild
    decay and on a strong decay whose 16-token sub-chunks underflow."""
    inp = _wkv_inputs(11, B, T, H, N)
    if strong:
        x = np.random.default_rng(12).standard_normal((B, T, H, N // 2))
        inp["w"][..., : N // 2] = np.exp(-np.exp(x + 2.0)).astype(np.float32)
        assert np.log(np.maximum(inp["w"][:, :16, :, : N // 2], 1e-30)).sum(1).min() < -87
    y, s = _factored_wkv(**inp)
    yj, sj = jax_rwkv6_ref(*(jnp.asarray(inp[key]) for key in ("r", "k", "v", "w", "u", "S0")))
    assert np.isfinite(y).all() and np.isfinite(s).all()
    np.testing.assert_allclose(y, np.asarray(yj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s, np.asarray(sj), atol=1e-5, rtol=1e-5)


# -- the kernel's wrapper, as far as the CPU reaches it ---------------------------
def test_ops_takes_plain_version_on_cpu_only():
    inp = _torch_wkv(_wkv_inputs(3, 1, 24, 2, 32))
    before = rwkv6_scan.launches
    y, s = ops.rwkv6(**inp)
    yr, sr = rwkv6_ref(**inp)
    assert torch.equal(y, yr) and torch.equal(s, sr)
    assert rwkv6_scan.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_scan(**inp)


def _bad(case):
    inp = _torch_wkv(_wkv_inputs(4, 1, 16, 2, 32))
    if case == "w_bf16":
        inp["w"] = inp["w"].to(torch.bfloat16)
    elif case == "kv_dtype":
        inp["k"] = inp["k"].to(torch.bfloat16)
    elif case == "u_shape":
        inp["u"] = inp["u"][:1]
    elif case == "S0_shape":
        inp["S0"] = inp["S0"][..., :16]
    elif case == "strided":
        inp["r"] = torch.from_numpy(_wkv_inputs(4, 1, 16, 2, 64)["r"])[..., ::2]
    elif case == "head_size":
        inp = _torch_wkv(_wkv_inputs(4, 1, 16, 2, 16))
    elif case == "f16":
        inp = _torch_wkv(_wkv_inputs(4, 1, 16, 2, 32), torch.float16)
    return inp


@pytest.mark.parametrize("case", ["w_bf16", "kv_dtype", "u_shape", "S0_shape",
                                  "strided", "head_size", "f16"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises((TypeError, ValueError)):
        check_rwkv6_args(**_bad(case))


@pytest.mark.parametrize("T,chunk", [(64, 64), (512, 64), (80, 16), (200, 16), (20, 16), (1, 16)])
def test_chunk_rule(T, chunk):
    assert chunk_for(T) == chunk


# -- the model -------------------------------------------------------------------
def test_configs_match_jax():
    assert_same_config(get_config("rwkv6-3b"), jax_get_config("rwkv6-3b"))
    ported = reduced(get_config("rwkv6-3b"), dtype="float32")
    ref = jax_reduced(jax_get_config("rwkv6-3b"), dtype="float32")
    assert_same_config(ported, ref)


@pytest.fixture(scope="module")
def models():
    """The reduced RWKV6 model on both sides, with the JAX weights carried over."""
    jcfg = jax_reduced(jax_get_config("rwkv6-3b"), dtype="float32")
    jparams = JaxLM(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    cfg = reduced(get_config("rwkv6-3b"), dtype="float32")
    return jcfg, jparams, cfg, params_from_jax(tree, device="cpu")


def _jax_cfg(jcfg, impl):
    return dataclasses.replace(jcfg, attention_impl=impl)


def _block_state(cfg, B, seed):
    rng = np.random.default_rng(seed)
    d, N = cfg.d_model, cfg.recurrent.head_size
    return {
        "ts_tm": rng.standard_normal((B, d)).astype(np.float32),
        "ts_cm": rng.standard_normal((B, d)).astype(np.float32),
        "S": (rng.standard_normal((B, d // N, N, N)) * 0.1).astype(np.float32),
    }


@pytest.mark.parametrize("impl,S,with_state", [
    ("xla", 32, False), ("xla", 32, True), ("xla", 20, True),
    # the JAX block sends only S % 16 == 0 to its Pallas kernel
    ("kernel_interpret", 32, False), ("kernel_interpret", 32, True),
])
def test_block_matches_jax(models, impl, S, with_state):
    jcfg, jparams, cfg, params = models
    x = np.random.default_rng(6).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    state = _block_state(cfg, 2, 7) if with_state else None
    p0 = jax.tree.map(lambda a: a[0], params["segments"][0]["block"])
    jp0 = jax.tree.map(lambda a: a[0], jparams["segments"][0]["block"])
    out, new = rwkv6_apply(
        cfg, p0, torch.from_numpy(x),
        None if state is None else {key: torch.from_numpy(val) for key, val in state.items()},
    )
    jout, jnew = jax_rwkv6_apply(
        _jax_cfg(jcfg, impl), jp0, jnp.asarray(x),
        None if state is None else {key: jnp.asarray(val) for key, val in state.items()},
    )
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL[impl])
    assert (new is None) == (jnew is None)
    if new is not None:
        for key in new:
            np.testing.assert_allclose(_np(new[key]), np.asarray(jnew[key]), **TOL[impl])


@pytest.mark.parametrize("impl", ["xla", "kernel_interpret"])
def test_backbone_matches_jax(models, impl):
    jcfg, jparams, cfg, params = models
    B, S = 1, 64
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (B, S))
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S)).astype(jnp.int32)
    jh, _, jaux = JaxLM(_jax_cfg(jcfg, impl)).backbone(jparams, jnp.asarray(toks, jnp.int32),
                                                       pos)
    h, _, aux = LM(cfg, device="cpu").backbone(params, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(h), np.asarray(jh), **TOL[impl])
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_array_equal(aux.numpy(), np.asarray(jaux))


@pytest.mark.parametrize("with_caches", [False, True])
def test_backbone_returns_aux_as_jax_does(models, with_caches):
    """``backbone`` returns ``(hidden, caches, aux)``: ``aux`` the auxiliary
    loss summed over the layers, an f32 scalar on the model's device equal
    to the JAX one (0 with no router), and the one ``loss`` reports."""
    jcfg, jparams, cfg, params = models
    B, S = 2, 16
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (B, S))
    jmodel, model = JaxLM(jcfg), LM(cfg, device="cpu")
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S)).astype(jnp.int32)
    jc = jmodel.init_cache(B, S) if with_caches else None
    caches = model.init_cache(B, S) if with_caches else None
    _, _, jaux = jmodel.backbone(jparams, jnp.asarray(toks, jnp.int32), pos, caches=jc)
    out = model.backbone(params, torch.from_numpy(toks), caches=caches)
    assert len(out) == 3
    aux = out[2]
    assert aux.dtype == torch.float32 and aux.shape == () and aux.device == torch.device("cpu")
    np.testing.assert_array_equal(aux.numpy(), np.asarray(jaux))
    _, metrics = model.loss(params, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(toks)})
    assert torch.equal(metrics["moe_aux"], aux)


@pytest.mark.parametrize("impl", ["xla", "kernel_interpret"])
def test_prefill_and_decode_match_jax(models, impl):
    jcfg, jparams, cfg, params = models
    B, S, steps = 2, 32, 3
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab, (B, S))
    nxt = rng.integers(0, cfg.vocab, (steps, B))
    jmodel, model = JaxLM(_jax_cfg(jcfg, impl)), LM(cfg, device="cpu")

    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                            jmodel.init_cache(B, 64))
    lg, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                               model.init_cache(B, 64))
    np.testing.assert_allclose(_np(lg), np.asarray(jl), **TOL[impl])
    for t in range(steps):
        pos = jnp.full((B,), S + t, jnp.int32)
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(nxt[t], jnp.int32), pos, jc)
        lg, caches = model.decode_step(params, torch.from_numpy(nxt[t]),
                                       torch.from_numpy(np.array(pos)), caches)
        np.testing.assert_allclose(_np(lg), np.asarray(jl), **TOL[impl])
    for key in caches[0]:
        np.testing.assert_allclose(_np(caches[0][key]), np.asarray(jc[0][key]), **TOL[impl])


def test_params_from_jax_keeps_bfloat16_bits():
    a = jnp.asarray(np.random.default_rng(10).standard_normal((3, 5)), jnp.bfloat16)
    t = params_from_jax({"x": [np.asarray(a)]}, device="cpu")["x"][0]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(t), np.asarray(a, np.float32))
