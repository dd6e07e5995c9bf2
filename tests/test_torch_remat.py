"""Activation checkpointing (``remat``) in the port, on reduced configs in
float32 on the CPU: under ``"block"`` and ``"dots"`` the loss, the MoE
auxiliary loss and every gradient equal (``==``) those of ``"none"`` for a
dense, a mixture-of-experts and a hybrid model, and the loss is within 1e-5
of the JAX ``LM.loss`` under the same ``remat``; the recompute runs each
layer's attention forward a second time; ``"dots"`` keeps the products
with no batch axis and recomputes the batched ones.

Weights come from the JAX ``LM.init`` and batches from numpy with a seed.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.models import LM as JaxLM
from repro.models import reduced as jax_reduced

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention_trainable
from repro_torch.models import LM, params_from_jax, reduced
from repro_torch.tree import tree_leaves

ARCHS = ("qwen1.5-0.5b", "qwen2-moe-a2.7b", "recurrentgemma-9b")
# the JAX model's loss against the port's, in float32
JAX_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg = jax_reduced(jax_get_config(request.param))
    cfg = reduced(get_config(request.param))
    jparams = JaxLM(jcfg).init(jax.random.PRNGKey(8))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab, (2, 40))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    return jcfg, jparams, cfg, params, batch


class _OpCount(TorchDispatchMode):
    """Counts the aten ops that reach it."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def _run(cfg, params, batch, remat):
    """Loss, metrics, gradients, attention forwards, and the aten ops the
    backward pass ran (the recompute included)."""
    calls = []

    def attn_fn(q, k, v, causal, window):
        calls.append(q.shape)
        return flash_attention_trainable(q, k, v, causal=causal, window=window)

    model = LM(dataclasses.replace(cfg, remat=remat), device="cpu", attn_fn=attn_fn)
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    forward = len(calls)
    with _OpCount() as count:
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    metrics = {key: val.detach() for key, val in metrics.items()}
    return loss.detach(), metrics, grads, (forward, len(calls)), count.ops


@pytest.mark.parametrize("remat", ["block", "dots"])
def test_remat_equals_none_and_the_jax_loss(pair, remat):
    jcfg, jparams, cfg, params, batch = pair
    loss0, m0, g0, (f0, a0), ops0 = _run(cfg, params, batch, "none")
    loss, m, g, (f, a), ops = _run(cfg, params, batch, remat)
    assert torch.equal(loss, loss0)
    for key in ("xent", "moe_aux"):
        assert torch.equal(m[key], m0[key])
    assert (float(m["moe_aux"]) > 0) == (cfg.family == "moe")
    assert len(g) == len(g0)
    for got, want in zip(g, g0):
        assert (got is None) == (want is None)
        if got is not None:
            assert torch.equal(got, want)
    # the recompute runs every attention layer's forward once more
    n_attn = f0
    assert n_attn > 0 and (f, a, a0) == (n_attn, 2 * n_attn, n_attn)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    if remat == "dots":        # the mm results are kept, not recomputed
        assert ops[mm] == ops0[mm]
    else:
        assert ops[mm] > ops0[mm]
    if cfg.family == "moe":    # the experts' batched products are recomputed
        assert ops[bmm] > ops0[bmm]
    jloss, jm = JaxLM(dataclasses.replace(jcfg, remat=remat)).loss(
        jparams, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), **JAX_TOL)
    np.testing.assert_allclose(float(m["moe_aux"]), float(jm["moe_aux"]), **JAX_TOL)


def test_remat_policy_is_checked():
    cfg = reduced(get_config("qwen1.5-0.5b"), n_layers=1)
    model = LM(dataclasses.replace(cfg, remat="everything"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="remat"):
        model.loss(params, {"tokens": toks, "labels": toks})
