"""The port's ``Adafactor`` and ``TrainState`` held against the JAX
package's on the CPU, in float32: five steps over a tree with factored,
unfactored, stacked 3-D and 4-D and scalar leaves (whole leaves, and slices
forced small so that one leaf spans many), the state's layout, and a train
step through ``make_train_step``.

Parameters and gradients are made with numpy from a seed and handed to
both sides.  The sliced column means and the update's RMS sum in another
order than the JAX package's, so parameters and state agree to ``rtol``
1e-5 rather than bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import LM as JaxLM
from repro.models import reduced as jax_reduced
from repro.optim.optimizers import Adafactor as JaxAdafactor
from repro.optim.schedules import cosine_with_warmup as jax_cosine
from repro.train.step import TrainState as JaxTrainState
from repro.train.step import make_train_step as jax_make_train_step

from repro_torch.configs import get_config
from repro_torch.models import LM, params_from_jax, reduced
from repro_torch.optim import Adafactor, optimizers
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import tree_leaves

TOL = dict(atol=1e-6, rtol=1e-5)
# (shape, factored at min_dim_size_to_factor=8): a matrix, one too narrow to
# factor, a stacked 3-D and 4-D leaf (layers, experts), a vector, a scalar
SHAPES = {"w": ((24, 40), True), "narrow": ((24, 5), False), "stack": ((3, 16, 12), True),
          "experts": ((2, 3, 9, 10), True), "bias": ((7,), False), "s": ((), False)}


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {key: np.asarray(scale * rng.standard_normal(shape), dtype=np.float32)
            for key, (shape, _) in SHAPES.items()}


def _run(opt, jopt, steps=5, slice_elems=None, monkeypatch=None):
    if slice_elems:
        monkeypatch.setattr(optimizers, "UPDATE_SLICE", slice_elems)
    params = {key: torch.from_numpy(val.copy()) for key, val in _tree(0).items()}
    jparams = jax.tree.map(jnp.asarray, _tree(0))
    state, jstate = opt.init(params), jopt.init(jparams)
    for i in range(steps):
        g = _tree(10 + i, scale=3.0 ** i)     # growing gradients: the clip engages
        params, state = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                                   state, params)
        jparams, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
    return params, state, jparams, jstate


@pytest.mark.parametrize("slice_elems", [None, 50, 7], ids=["whole", "slices", "rows"])
@pytest.mark.parametrize("kwargs", [dict(min_dim_size_to_factor=8),
                                    dict(min_dim_size_to_factor=8, weight_decay=0.1,
                                         clip_threshold=0.5)],
                         ids=["default", "decay_clip"])
def test_adafactor_matches_jax(monkeypatch, slice_elems, kwargs):
    """Five steps; with 50-element slices the 4-D leaf's 90-element
    matrices go a row block at a time and the 3-D leaf's 192-element
    matrices too; with 7, every matrix a few rows at a time and the
    unfactored leaves a row at a time."""
    opt, jopt = Adafactor(lr=0.05, **kwargs), JaxAdafactor(lr=0.05, **kwargs)
    params, state, jparams, jstate = _run(opt, jopt, slice_elems=slice_elems,
                                          monkeypatch=monkeypatch)
    assert int(state["step"]) == int(jstate["step"]) == 5
    for key in SHAPES:
        np.testing.assert_allclose(_np(params[key]), np.asarray(jparams[key]), **TOL,
                                   err_msg=key)
        for part in jstate["v"][key]:
            np.testing.assert_allclose(_np(state["v"][key][part]),
                                       np.asarray(jstate["v"][key][part]), **TOL,
                                       err_msg=f"{key}/{part}")


def test_adafactor_updates_in_place_with_a_schedule():
    """The update writes into the given tensors and returns them; a
    schedule is read at the new step."""
    opt = Adafactor(lr=cosine_with_warmup(1e-2, 2, 5), min_dim_size_to_factor=8)
    jopt = JaxAdafactor(lr=jax_cosine(1e-2, 2, 5), min_dim_size_to_factor=8)
    params = {key: torch.from_numpy(val.copy()) for key, val in _tree(0).items()}
    state = opt.init(params)
    ids = {key: id(val) for key, val in params.items()}
    vr = state["v"]["w"]["vr"]
    out, out_state = opt.update({k: torch.from_numpy(v) for k, v in _tree(10).items()},
                                state, params)
    assert out is params and out_state is state and out_state["v"]["w"]["vr"] is vr
    assert {key: id(val) for key, val in out.items()} == ids
    jparams, _ = jopt.update(jax.tree.map(jnp.asarray, _tree(10)),
                             jopt.init(jax.tree.map(jnp.asarray, _tree(0))),
                             jax.tree.map(jnp.asarray, _tree(0)))
    for key in SHAPES:
        np.testing.assert_allclose(_np(out[key]), np.asarray(jparams[key]), **TOL)


def test_adafactor_state_is_factored():
    """The state tree of ``tests/test_train_optim.py``'s test, leaf for leaf
    against the JAX ``Adafactor.init``: float32 ``vr``/``vc`` for a factored
    leaf, ``v`` otherwise."""
    opt, jopt = Adafactor(min_dim_size_to_factor=8), JaxAdafactor(min_dim_size_to_factor=8)
    state = opt.init({"big": torch.zeros(64, 32), "small": torch.zeros(4)})
    assert set(state["v"]["big"]) == {"vr", "vc"}
    assert tuple(state["v"]["big"]["vr"].shape) == (64,)
    assert tuple(state["v"]["big"]["vc"].shape) == (32,)
    assert set(state["v"]["small"]) == {"v"}
    params = {key: torch.from_numpy(val) for key, val in _tree(0).items()}
    state = opt.init({key: val.to(torch.bfloat16) for key, val in params.items()})
    jstate = jopt.init(jax.tree.map(jnp.asarray, _tree(0)))
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for key, (shape, factored) in SHAPES.items():
        assert set(state["v"][key]) == set(jstate["v"][key]) == (
            {"vr", "vc"} if factored else {"v"})
        for part, leaf in state["v"][key].items():
            assert leaf.dtype == torch.float32
            assert tuple(leaf.shape) == jstate["v"][key][part].shape
            assert not leaf.any()
    assert Adafactor() == Adafactor(lr=1e-3, decay=0.8, eps1=1e-30, eps2=1e-3,
                                    clip_threshold=1.0, weight_decay=0.0,
                                    min_dim_size_to_factor=128)
    assert {f.name: f.default for f in dataclasses.fields(Adafactor)} == {
        f.name: f.default for f in dataclasses.fields(JaxAdafactor)}


def test_train_state_fields_match_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(TrainState)]
            == [(f.name, f.default) for f in dataclasses.fields(JaxTrainState)])
    st = TrainState(params={"w": torch.ones(2)}, opt_state={"step": 0})
    assert st.step == 0 and dataclasses.replace(st, step=3).step == 3


def test_adafactor_train_step_matches_jax():
    """Three steps of ``make_train_step(model, Adafactor())`` on a reduced
    ``qwen1.5-0.5b`` (min_dim_size_to_factor 32, so its matrices factor):
    losses, gradient norms and parameters against the JAX train step.
    Without QKV biases: the key bias adds the same logit to every key of a
    query, so its gradient is zero but for rounding, and Adafactor scales
    that rounding up to steps of ``lr``, differently in each framework."""
    jcfg = jax_reduced(jax_get_config("qwen1.5-0.5b"), n_layers=1, qkv_bias=False)
    cfg = reduced(get_config("qwen1.5-0.5b"), n_layers=1, qkv_bias=False)
    tree = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    batches = [{"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),
                "labels": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)}
               for _ in range(3)]
    jopt, opt = JaxAdafactor(lr=1e-2, min_dim_size_to_factor=32), Adafactor(
        lr=1e-2, min_dim_size_to_factor=32)
    jstep = jax.jit(jax_make_train_step(JaxLM(jcfg), jopt))
    step = make_train_step(LM(cfg, device="cpu"), opt)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    p = params_from_jax(tree, device="cpu")
    s = opt.init(p)
    for b in batches:
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        p, s, m = step(p, s, {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
    for got, want in zip(tree_leaves(p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
