"""The port's training path (``repro_torch``) held against the JAX package:
loss and gradients, the AdamW train step, the data stream, checkpoints and
the ``train()`` driver, on reduced configurations in float32 on the CPU.

Weights come from the JAX ``LM.init`` (with every leaf nudged by seeded
numpy noise, so the QKV biases are not zero) and reach the port through
``params_from_jax``; batches come from the numpy ``SyntheticLM`` stream.
JAX's Pallas kernels run in interpret mode (``"kernel_interpret"``).
"""
import dataclasses
import gc
import json
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import Prefetcher as JaxPrefetcher
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.kernels.rwkv6_scan import rwkv6_scan_trainable as jax_rwkv6_trainable
from repro.models import LM as JaxLM
from repro.models import reduced as jax_reduced
from repro.optim.optimizers import AdamW as JaxAdamW
from repro.optim.schedules import cosine_with_warmup as jax_cosine
from repro.optim.schedules import linear_warmup as jax_linear_warmup
from repro.train.step import make_train_step as jax_make_train_step

from repro_torch.ckpt.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.pipeline import Prefetcher
from repro_torch.data.synthetic import SyntheticLM, materialize_batch
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_trainable
from repro_torch.launch.train import train
from repro_torch.models import LM, params_from_jax, reduced
from repro_torch.optim import optimizers
from repro_torch.optim.optimizers import AdamW
from repro_torch.optim.schedules import constant, cosine_with_warmup, linear_warmup
from repro_torch.train.step import make_eval_step, make_train_step, value_and_grad
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

CPU = torch.device("cpu")


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _nudged_params(jcfg, seed=0):
    """JAX ``LM.init`` weights, every leaf nudged by seeded noise, as a numpy
    tree (handed to both sides)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(seed)))
    return jax.tree.map(
        lambda a: (a + 0.01 * rng.standard_normal(a.shape)).astype(a.dtype), tree)


def _batches(vocab, B, S, n, seed=0):
    it = iter(JaxSyntheticLM(vocab, B, S, seed=seed))
    return [next(it) for _ in range(n)]


def _torch_batch(b):
    return {key: torch.from_numpy(val) for key, val in b.items()}


def _pair(arch, **overrides):
    return (jax_reduced(jax_get_config(arch), **overrides),
            reduced(get_config(arch), **overrides))


# -- loss and gradients ------------------------------------------------------------
@pytest.mark.parametrize("variant", [{}, {"n_kv_heads": 2}, {"xent_chunk": 4}],
                         ids=["as_is", "gqa", "xent_chunk"])
@pytest.mark.parametrize("impl", ["xla", "kernel_interpret"])
def test_qwen_loss_and_grads_match_jax(variant, impl):
    jcfg, cfg = _pair("qwen1.5-0.5b", **variant)
    jcfg = dataclasses.replace(jcfg, attention_impl=impl)
    tree = _nudged_params(jcfg)
    batch = _batches(cfg.vocab, 2, 128, 1)[0]
    jmodel = JaxLM(jcfg)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    loss, metrics, grads = value_and_grad(LM(cfg, device="cpu"),
                                          params_from_jax(tree, device="cpu"),
                                          _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(metrics["moe_aux"]) == 0.0
    want = jax.tree.leaves(jgrads)
    got = tree_leaves(grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_rwkv6_trainable_gradients_match_jax():
    rng = np.random.default_rng(3)
    B, T, H, N = 1, 32, 2, 16
    inp = dict(
        r=rng.standard_normal((B, T, H, N)) * 0.5, k=rng.standard_normal((B, T, H, N)) * 0.5,
        v=rng.standard_normal((B, T, H, N)), w=rng.uniform(0.3, 0.99, (B, T, H, N)),
        u=rng.standard_normal((H, N)) * 0.2, S0=rng.standard_normal((B, H, N, N)) * 0.1)
    inp = {key: val.astype(np.float32) for key, val in inp.items()}
    gy = rng.standard_normal((B, T, H, N)).astype(np.float32)
    order = ("r", "k", "v", "w", "u", "S0")
    leaves = [torch.from_numpy(inp[key]).requires_grad_() for key in order]
    y, sT = rwkv6_scan_trainable(*leaves)
    grads = torch.autograd.grad((y * torch.from_numpy(gy)).sum() + sT.sum(), leaves)

    def f(*args):
        yj, sj = jax_rwkv6_trainable(*args, chunk=16, interpret=True)
        return jnp.sum(yj * gy) + jnp.sum(sj)

    want = jax.grad(f, argnums=tuple(range(6)))(*(jnp.asarray(inp[key]) for key in order))
    for g, w in zip(grads, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_rwkv6_loss_and_grads_match_jax():
    jcfg, cfg = _pair("rwkv6-3b")
    jcfg = dataclasses.replace(jcfg, attention_impl="kernel_interpret")
    tree = _nudged_params(jcfg, seed=1)
    batch = _batches(cfg.vocab, 2, 32, 1, seed=1)[0]
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(JaxLM(jcfg).loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    loss, _, grads = value_and_grad(LM(cfg, device="cpu"), params_from_jax(tree, device="cpu"),
                                    _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4, rtol=1e-4)


# -- the train step -------------------------------------------------------------------
# AdamW's eps for the step comparisons.  At the default 1e-8, elements whose
# gradient is rounding noise (the k-bias gradients here are ~1e-8, the
# softmax being nearly invariant to a shift of k) get updates of the size of
# the learning rate whose sign and size follow the noise, so no two
# summation orders agree on them; 1e-6 keeps those updates small and leaves
# every resolved gradient's update as it was.
STEP_EPS = 1e-6


def _run_steps(jcfg, cfg, tree, batches, microbatches):
    jopt = JaxAdamW(lr=jax_cosine(3e-3, warmup=1, total=len(batches)), eps=STEP_EPS)
    jstep = jax.jit(jax_make_train_step(JaxLM(jcfg), jopt, microbatches=microbatches))
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    opt = AdamW(lr=cosine_with_warmup(3e-3, warmup=1, total=len(batches)), eps=STEP_EPS)
    step = make_train_step(LM(cfg, device="cpu"), opt, microbatches=microbatches)
    p = params_from_jax(tree, device="cpu")
    s = opt.init(p)
    for b in batches:
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        p, s, m = step(p, s, _torch_batch(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    return (jp, js), (p, s)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(microbatches):
    jcfg, cfg = _pair("qwen1.5-0.5b", n_layers=1)
    tree = _nudged_params(jcfg)
    batches = _batches(cfg.vocab, 4, 32, 3)
    (jp, js), (p, s) = _run_steps(jcfg, cfg, tree, batches, microbatches)
    assert int(s["step"]) == int(js["step"]) == 3
    for name, got, want in (("params", p, jp), ("m", s["m"], js["m"]), ("v", s["v"], js["v"])):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-5, rtol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_in_slices_is_the_whole_leaf_update(monkeypatch, dtype):
    """``AdamW.update`` works through each leaf in slices of at most
    ``UPDATE_SLICE`` elements along its first axis, the clip folded in:
    bit for bit the clip of the whole tree, then the update of each whole
    leaf, over three steps (slices of 1000 elements: one leaf of 37 rows
    of 50, one whose 2100-element row is larger than a slice, a vector and
    a scalar)."""
    monkeypatch.setattr(optimizers, "UPDATE_SLICE", 1000)
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dtype)

    params = {"a": randn(37, 50), "b": randn(3), "c": randn(2, 3, 700), "s": randn()}
    grads = {key: randn(*val.shape) * 5 for key, val in params.items()}
    opt = AdamW(lr=1e-2, weight_decay=0.1)
    got, want = tree_map(torch.clone, params), tree_map(torch.clone, params)
    s_got, s_want = opt.init(got), opt.init(want)
    f32 = torch.float32
    for _ in range(3):
        opt.update(grads, s_got, got)
        clipped, _ = optimizers.clip_by_global_norm(grads, opt.clip_norm)
        step = s_want["step"] + 1
        lr, sf = opt.lr, step.to(f32)
        c1, c2 = 1.0 - opt.b1 ** sf, 1.0 - opt.b2 ** sf
        for p, g, m, v in zip(*(tree_leaves(t) for t in (want, clipped, s_want["m"],
                                                          s_want["v"]))):
            gf = g.to(f32)
            mf = opt.b1 * m.to(f32) + (1 - opt.b1) * gf
            vf = opt.b2 * v.to(f32) + (1 - opt.b2) * gf * gf
            u = (mf / c1) / (torch.sqrt(vf / c2) + opt.eps) + opt.weight_decay * p.to(f32)
            p.copy_(p.to(f32) - lr * u)
            m.copy_(mf)
            v.copy_(vf)
        s_want["step"].copy_(step)
    for a, b in zip(tree_leaves((got, s_got)), tree_leaves((want, s_want))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_schedules_and_eval_step_match_jax():
    for i in range(8):
        s = torch.tensor(i, dtype=torch.int32)
        np.testing.assert_allclose(float(cosine_with_warmup(1e-3, 2, 6)(s)),
                                   float(jax_cosine(1e-3, 2, 6)(jnp.int32(i))), rtol=1e-6)
        np.testing.assert_allclose(float(linear_warmup(1e-3, 3)(s)),
                                   float(jax_linear_warmup(1e-3, 3)(jnp.int32(i))), rtol=1e-6)
        assert float(constant(2e-3)(s)) == np.float32(2e-3)
    jcfg, cfg = _pair("qwen1.5-0.5b", n_layers=1)
    tree = _nudged_params(jcfg)
    b = _batches(cfg.vocab, 2, 16, 1)[0]
    out = make_eval_step(LM(cfg, device="cpu"))(params_from_jax(tree, device="cpu"),
                                                _torch_batch(b))
    jloss, _ = JaxLM(jcfg).loss(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, b))
    np.testing.assert_allclose(float(out["loss"]), float(jloss), rtol=1e-5)
    # the int8 cross-pod step is ported: without a pod mesh it raises as JAX's does
    with pytest.raises(ValueError, match="'pod' axis"):
        make_train_step(LM(cfg, device="cpu"), AdamW(), grad_compression="int8")
    # activation checkpointing is ported: the same loss under "block"
    rloss, _ = LM(dataclasses.replace(cfg, remat="block"), device="cpu").loss(
        params_from_jax(tree, device="cpu"), _torch_batch(b))
    assert float(rloss) == float(out["loss"])


# -- data ---------------------------------------------------------------------------
def test_synthetic_stream_is_byte_identical_to_jax():
    ours, theirs = iter(SyntheticLM(777, 3, 50, seed=9)), iter(JaxSyntheticLM(777, 3, 50, seed=9))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes()
    cfg = reduced(get_config("qwen1.5-0.5b"))
    mb = materialize_batch(cfg, 2, 16, seed=4)
    assert mb["tokens"].tobytes() == next(iter(JaxSyntheticLM(cfg.vocab, 2, 16, seed=4)))["tokens"].tobytes()


def test_prefetcher_keeps_order_places_batches_and_passes_errors():
    items = [{"x": np.full((2, 2), i, np.int32)} for i in range(7)]
    pf = Prefetcher(iter(items), depth=2, device="cpu")
    got = [int(b["x"][0, 0]) for b in pf]
    assert got == list(range(7)) == [int(b["x"][0, 0]) for b in JaxPrefetcher(iter(items))]
    pf.close()

    def broken():
        yield {"x": np.zeros(2)}
        raise ValueError("producer broke")

    pf = Prefetcher(broken(), depth=1, device="cpu")
    assert isinstance(next(pf)["x"], torch.Tensor)
    with pytest.raises(ValueError, match="producer broke"):
        next(pf)
    pf.close()

    endless = Prefetcher(iter(SyntheticLM(50, 2, 8, seed=0)), depth=1, device="cpu")
    next(endless)
    endless.close()                        # stops and joins a producer blocked on a full queue
    assert not endless._thread.is_alive()


# -- checkpoints -----------------------------------------------------------------------
def test_jax_checkpoint_restores_and_the_next_step_matches(tmp_path):
    jcfg, cfg = _pair("qwen1.5-0.5b", n_layers=1)
    tree = _nudged_params(jcfg)
    batches = _batches(cfg.vocab, 2, 32, 2)
    jopt = JaxAdamW(lr=jax_cosine(3e-3, warmup=1, total=4), eps=STEP_EPS)
    jstep = jax.jit(jax_make_train_step(JaxLM(jcfg), jopt))
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    jp, js, _ = jstep(jp, js, jax.tree.map(jnp.asarray, batches[0]))
    jax_save_checkpoint(str(tmp_path), (jp, js), step=1, clock=lambda: 0.0)

    opt = AdamW(lr=cosine_with_warmup(3e-3, warmup=1, total=4), eps=STEP_EPS)
    model = LM(cfg, device="cpu")
    like_p = model.init(torch.Generator().manual_seed(5))
    (p, s), step, _ = load_checkpoint([str(tmp_path)], (like_p, opt.init(like_p)))
    assert step == 1
    for g, w in zip(tree_leaves((p, s)), jax.tree.leaves((jp, js))):
        assert g.dtype == getattr(torch, str(np.asarray(w).dtype))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    jp, js, _ = jstep(jp, js, jax.tree.map(jnp.asarray, batches[1]))
    p, s, _ = make_train_step(model, opt)(p, s, _torch_batch(batches[1]))
    for g, w in zip(tree_leaves((p, s)), jax.tree.leaves((jp, js))):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), atol=1e-5, rtol=1e-5)


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5) * 7, "h": torch.randn(4, generator=torch.Generator().manual_seed(0)).bfloat16()},
            "step": torch.tensor(3, dtype=torch.int32)}


def test_checkpoint_layout_and_bfloat16_round_trip(tmp_path):
    tree = _tree()
    d = save_checkpoint(str(tmp_path), tree, step=4, clock=lambda: 1.0)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    # leaves in jax.tree.flatten order: a, b/c, b/h, step
    assert [m["dtype"] for m in manifest["leaves"].values()] == [
        "float32", "float32", "bfloat16", "int32"]
    back, step, _ = load_checkpoint([str(tmp_path)], tree)
    assert step == 4
    for g, w in zip(tree_leaves(back), tree_leaves(tree)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    leaves, structure = tree_flatten((tree, [None, tree["a"]]))
    assert len(leaves) == 5
    assert torch.equal(tree_unflatten(structure, leaves)[1][1], tree["a"])


def test_a_train_step_frees_its_gradients_without_the_garbage_collector():
    """With the cycle collector off, nothing of a step outlives it: the
    tree helpers hold no reference cycle (a self-calling nested walk
    was one, and it kept each step's gradient tree alive until the
    collector ran, a second copy of the gradients on the card), and the
    gradients of a train step are freed when the step returns."""
    jcfg, cfg = _pair("qwen1.5-0.5b", n_layers=1)
    model = LM(cfg, device="cpu")
    params = params_from_jax(_nudged_params(jcfg), device="cpu")
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    batch = _torch_batch(_batches(cfg.vocab, 2, 16, 1)[0])
    seen = []
    real = optimizers.global_norm

    def spy(tree):
        seen.extend(weakref.ref(leaf) for leaf in tree_leaves(tree))
        return real(tree)

    gc.collect()
    gc.disable()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(optimizers, "global_norm", spy)
            params, state, _ = make_train_step(model, opt)(params, state, batch)
        leaf = torch.zeros(3)
        ref = weakref.ref(leaf)
        leaves, structure = tree_flatten({"a": [leaf, None], "b": (leaf,)})
        tree_unflatten(structure, leaves)
        del leaf, leaves
        assert ref() is None
        assert seen and all(r() is None for r in seen)
    finally:
        gc.enable()


def test_torn_replica_is_skipped_and_all_corrupt_raises(tmp_path):
    tree = _tree()
    d1, d2 = str(tmp_path / "r1"), str(tmp_path / "r2")
    save_checkpoint(d1, tree, step=5)
    save_checkpoint(d2, tree, step=5)
    victim = os.path.join(d1, "step_00000005", "arrays.npz")
    with open(victim, "r+b") as f:
        f.seek(200)
        f.write(b"\x00" * 64)
    back, step, _ = load_checkpoint([d1, d2], tree)
    assert step == 5 and torch.equal(back["a"], tree["a"])
    os.remove(os.path.join(d2, "step_00000005", "manifest.json"))
    with pytest.raises(FileNotFoundError):
        load_checkpoint([d1, d2], tree)


def test_injected_clock_gives_identical_manifests(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(replica_dirs=[str(tmp_path / "r0"), str(tmp_path / "r1")],
                            clock=lambda: 7.25, keep=1)
    mgr.save(tree, step=2)
    texts = []
    for root in mgr.replica_dirs:
        with open(os.path.join(root, "step_00000002", "manifest.json")) as f:
            texts.append(f.read())
    assert texts[0] == texts[1] and json.loads(texts[0])["time"] == 7.25
    mgr.save(tree, step=3)
    assert os.listdir(mgr.replica_dirs[0]) == ["step_00000003"]


# -- the driver --------------------------------------------------------------------------
def test_train_runs_on_cpu_and_restores_after_a_simulated_failure(tmp_path, capsys):
    dirs = [str(tmp_path / "a"), str(tmp_path / "b")]
    out = train(steps=6, batch=2, seq=32, ckpt_dirs=dirs, simulate_failure=3,
                log_every=100, device="cpu")
    assert "simulated failure at step 3" in capsys.readouterr().out
    assert len(out["losses"]) == 6 and np.isfinite(out["losses"]).all()
    assert np.isfinite(out["grad_norms"]).all() and len(out["step_s"]) == 6
    assert int(out["opt_state"]["step"]) == 6
    _, step, _ = load_checkpoint(dirs, (out["params"], out["opt_state"]))
    assert step == 3
    again = train(steps=6, batch=2, seq=32, ckpt_dirs=dirs, resume=True,
                  log_every=100, device="cpu")
    assert len(again["losses"]) == 3                  # resumed at step 3
    assert np.isfinite(again["losses"]).all() and int(again["opt_state"]["step"]) == 6


def test_train_needs_a_card_unless_told_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(steps=1, batch=2, seq=16, ckpt_dirs=[str(tmp_path)])
