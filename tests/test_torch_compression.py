"""The port's int8 gradient compression (``repro_torch.optim.compression``)
and its cross-pod train step held against the JAX package.

Rounding to nearest must equal JAX's ``int8_quantize`` bit for bit (the
same float32 operations); stochastic rounding must stay within one step and
be unbiased, as the JAX package's own tests hold it.  Over gloo, two pod
processes run ``_cross_pod_int8_mean`` on each pod's JAX gradients of a
reduced OLMo (its result equals the mean of JAX's round trips, bit for bit)
and the compressed step on the global batch, which must stay within the
JAX test's bounds of the plain step (loss 1e-3, parameters 5e-3).  Those
bounds cannot tell a wrong gradient from a right one, so the step is also
held link by link: each pod's gradients to JAX's, and its parameters, bit
for bit, to the optimizer's update on the mean it reduced.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import LM as JaxLM
from repro.models import reduced as jax_reduced
from repro.optim.compression import int8_dequantize as jax_dequantize
from repro.optim.compression import int8_quantize as jax_quantize

from repro_torch.configs import get_config
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import LM, params_from_jax, reduced
from repro_torch.optim import (AdamW, compress_gradients, decompress_gradients,
                               int8_dequantize, int8_quantize)
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _cases():
    rng = np.random.default_rng(0)
    return {
        "normal": rng.standard_normal((64, 33)).astype(np.float32),
        "wide": (rng.standard_normal(1000) * 1e4).astype(np.float32),
        "zeros": np.zeros((5, 7), np.float32),
        "tiny": np.array([1e-30, -1e-30, 0.0, 3e-31], np.float32),
        # scale exactly 1: every value a whole or half step, ties to even
        "half_steps": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -127.0],
                               np.float32),
        "scalar": np.array(-3.25, np.float32),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_cases()))
def test_round_to_nearest_is_jax_bit_for_bit(case, dtype):
    x32 = _cases()[case]
    xj = jnp.asarray(x32, getattr(jnp, dtype))
    qj, sj = jax_quantize(xj)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    qt, st = int8_quantize(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32 and st.dim() == 0
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert st.numpy().tobytes() == np.asarray(sj, np.float32).tobytes()
    for out in ("float32", "bfloat16"):
        back_j = np.asarray(jax_dequantize(qj, sj, getattr(jnp, out)).astype(jnp.float32))
        back_t = int8_dequantize(qt, st, getattr(torch, out)).to(torch.float32).numpy()
        assert back_t.tobytes() == back_j.tobytes()


@pytest.mark.parametrize("scale", [0.01, 1.0, 100.0])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_quantization_error_bounds(scale, seed):
    """Rounding to nearest within half a step (tests/test_train_optim.py);
    stochastic rounding within one step."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(128) * scale).astype(np.float32))
    q, s = int8_quantize(x)
    assert float((int8_dequantize(q, s) - x).abs().max()) <= float(s) * 0.5 + 1e-7
    q, s = int8_quantize(x, torch.Generator().manual_seed(seed))
    assert float((int8_dequantize(q, s) - x).abs().max()) <= float(s) * (1 + 1e-6)


def test_stochastic_rounding_is_unbiased_and_seeded():
    """tests/test_train_optim.py's case (every value the max, so exact), then
    values 38.1 steps high, which round to 38 or 39."""
    x = torch.full((20000,), 0.3)
    q, s = int8_quantize(x, torch.Generator().manual_seed(0))
    assert float(int8_dequantize(q, s).mean()) == pytest.approx(0.3, rel=0.02)
    x[0] = 1.0
    q, s = int8_quantize(x, torch.Generator().manual_seed(0))
    assert set(q[1:].tolist()) == {38, 39}
    assert float(int8_dequantize(q, s)[1:].mean()) == pytest.approx(0.3, rel=0.002)
    q2, s2 = int8_quantize(x, torch.Generator().manual_seed(0))
    assert torch.equal(q, q2) and torch.equal(s, s2)
    q3, _ = int8_quantize(x, torch.Generator().manual_seed(1))
    assert not torch.equal(q, q3)


def test_compress_roundtrip_keeps_the_tree():
    tree = {"a": torch.tensor([1.0, -2.0, 3.0]),
            "b": {"c": torch.ones((4, 4)), "d": [torch.zeros(2, dtype=torch.bfloat16)]}}
    comp = compress_gradients(tree)
    assert set(comp) == {"a", "b"} and set(comp["b"]["c"]) == {"q", "scale"}
    back = decompress_gradients(comp, tree)
    assert back["b"]["d"][0].dtype == torch.bfloat16
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        assert a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= 3.0 / 127
    seeded = compress_gradients(tree, torch.Generator().manual_seed(4))
    assert tree_leaves(seeded)[0].dtype == torch.int8


def test_int8_step_needs_a_pod_axis():
    cfg = reduced(get_config("olmo-1b"), n_layers=1, vocab=128)
    model = LM(cfg, device="cpu")
    with pytest.raises(ValueError, match="pod"):
        make_train_step(model, AdamW(lr=1e-3), grad_compression="int8")
    with pytest.raises(ValueError, match="pod"):
        make_train_step(model, AdamW(lr=1e-3), grad_compression="int8",
                        mesh=AbstractMesh((2, 2), ("data", "model")))
    with pytest.raises(ValueError, match="size 1"):
        make_train_step(model, AdamW(lr=1e-3), grad_compression="int8",
                        mesh=AbstractMesh((2, 2, 1), ("pod", "data", "model")))
    with pytest.raises(ValueError, match="grad_compression"):
        make_train_step(model, AdamW(lr=1e-3), grad_compression="fp8")


POD_RANK = r'''
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import LM, reduced
from repro_torch.optim import AdamW
from repro_torch.train import step as step_module
from repro_torch.train.step import _cross_pod_int8_mean, make_train_step
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten
rank, world, store, inp, outp = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
mesh = make_host_mesh(pod=world, device_type="cpu")
data = np.load(inp)
n = int(data["n_leaves"])
# the mean of the pods' JAX gradients, rounded to nearest
grads = [torch.from_numpy(data[f"pod{rank}_{i}"]) for i in range(n)]
mean = _cross_pod_int8_mean(grads, mesh, None)
out = {f"mean_{i}": g.numpy() for i, g in enumerate(mean)}
# the compressed step on the global batch, to nearest and stochastic
cfg = reduced(get_config("olmo-1b"), n_layers=1, vocab=128)
model = LM(cfg, device="cpu")
opt = AdamW(lr=1e-3)
_, structure = tree_flatten(model.init(torch.Generator().manual_seed(0)))
batch = {"tokens": torch.from_numpy(data["tokens"]), "labels": torch.from_numpy(data["labels"])}
step = make_train_step(model, opt, grad_compression="int8", mesh=mesh)
# record this pod's gradients and the mean the step hands to the optimizer
grads_seen, means = [], []


def recorded_mean(grads, *args):
    grads_seen.append(grads)
    means.append(_cross_pod_int8_mean(grads, *args))
    return means[-1]


step_module._cross_pod_int8_mean = recorded_mean
for tag, gen in (("near", None), ("stoch", torch.Generator().manual_seed(3))):
    params = tree_unflatten(structure, [torch.from_numpy(data[f"param_{i}"].copy())
                                        for i in range(int(data["n_params"]))])
    start = tree_map(lambda t: t.detach().clone(), params)
    params, _, metrics = step(params, opt.init(params), batch, gen)
    out[f"{tag}_loss"] = metrics["loss"].numpy()
    for i, p in enumerate(tree_flatten(params)[0]):
        out[f"{tag}_param_{i}"] = p.detach().numpy()
    # the optimizer alone, from the same start, on the recorded mean
    replay, _ = opt.update(means[-1], opt.init(start), start)
    for i, p in enumerate(tree_flatten(replay)[0]):
        out[f"{tag}_replay_{i}"] = p.detach().numpy()
    for i, g in enumerate(tree_flatten(grads_seen[-1])[0]):
        out[f"{tag}_grad_{i}"] = g.numpy()
np.savez(outp.replace(".npz", f"_{rank}.npz"), **out)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def pod_run(tmp_path_factory):
    """Two pod processes over gloo; returns (inputs, per-rank outputs)."""
    tmp = tmp_path_factory.mktemp("pods")
    jcfg = jax_reduced(jax_get_config("olmo-1b"), n_layers=1, vocab=128)
    jmodel = JaxLM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 128, (8, 16)).astype(np.int32)
    labels = rng.integers(0, 128, (8, 16)).astype(np.int32)
    inputs = {"tokens": tokens, "labels": labels}
    pods = []
    for r in range(2):
        half = {k: jnp.asarray(v[4 * r:4 * (r + 1)]) for k, v in inputs.items()}
        g = jax.grad(lambda p: jmodel.loss(p, half)[0])(jparams)
        pods.append([np.asarray(x) for x in jax.tree.leaves(g)])
        for i, x in enumerate(pods[-1]):
            inputs[f"pod{r}_{i}"] = x
    inputs["n_leaves"] = np.array(len(pods[0]))
    leaves = [np.asarray(x) for x in jax.tree.leaves(jparams)]
    for i, x in enumerate(leaves):
        inputs[f"param_{i}"] = x
    inputs["n_params"] = np.array(len(leaves))
    np.savez(tmp / "in.npz", **inputs)

    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", POD_RANK, str(r), "2", str(tmp / "store"),
                               str(tmp / "in.npz"), str(tmp / "out.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    outs = [dict(np.load(tmp / f"out_{r}.npz")) for r in range(2)]
    return inputs, pods, jparams, outs


def test_cross_pod_mean_is_the_mean_of_jax_round_trips(pod_run):
    inputs, pods, _, outs = pod_run
    for i in range(int(inputs["n_leaves"])):
        deq = []
        for r in range(2):
            q, s = jax_quantize(jnp.asarray(pods[r][i]))
            deq.append(np.asarray(q).astype(np.float32) * np.float32(s))
        want = ((deq[0] + deq[1]) / np.float32(2)).astype(pods[0][i].dtype)
        for out in outs:
            assert out[f"mean_{i}"].tobytes() == want.tobytes(), i


def test_compressed_step_reduces_each_pods_jax_gradients(pod_run):
    """The gradients each pod's step quantises are JAX's gradients of that
    pod's half of the global batch, within 1e-5 of the largest (float32)."""
    inputs, pods, _, outs = pod_run
    for r, out in enumerate(outs):
        for tag in ("near", "stoch"):
            for i in range(int(inputs["n_leaves"])):
                want = pods[r][i]
                err = float(np.max(np.abs(out[f"{tag}_grad_{i}"] - want)))
                assert err <= 1e-5 * float(np.max(np.abs(want))), (r, tag, i, err)


def test_compressed_step_stays_near_the_plain_step(pod_run):
    """tests/test_system.py::test_compressed_cross_pod_step's bounds, at 2 pods.
    Those bounds cannot catch a wrong gradient (AdamW's first step moves a
    weight by about lr whatever the gradient), so the step's parameters must
    also equal, bit for bit, the optimizer's update from the same start on
    the mean the step reduced, which test_cross_pod_mean_is_the_mean_of_jax_
    round_trips holds to JAX's round trips."""
    inputs, _, jparams, outs = pod_run
    cfg = reduced(get_config("olmo-1b"), n_layers=1, vocab=128)
    model = LM(cfg, device="cpu")
    opt = AdamW(lr=1e-3)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    batch = {k: torch.from_numpy(inputs[k]) for k in ("tokens", "labels")}
    p1, _, m1 = make_train_step(model, opt)(params, opt.init(params), batch)
    plain = [p.detach().numpy() for p in tree_leaves(p1)]
    for tag in ("near", "stoch"):
        for out in outs:
            assert abs(float(m1["loss"]) - float(out[f"{tag}_loss"])) < 1e-3
            d = max(float(np.max(np.abs(a - out[f"{tag}_param_{i}"])))
                    for i, a in enumerate(plain))
            assert d < 5e-3, (tag, d)
        # every pod ends with the same parameters, the update of the mean
        for i in range(len(plain)):
            assert np.array_equal(outs[0][f"{tag}_param_{i}"], outs[1][f"{tag}_param_{i}"])
            for out in outs:
                assert out[f"{tag}_param_{i}"].tobytes() == out[f"{tag}_replay_{i}"].tobytes()
