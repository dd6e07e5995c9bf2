"""The port's GPipe pipeline (``repro_torch.train.pipeline``) held against
the JAX package's and against the sequential model.

The sizes of tests/test_system.py::test_pipeline_parallel_matches_sequential
(L=8 layers of width 32, vocab 64, M=6 microbatches of (2, 16)), in float32.
JAX runs its ``shard_map`` pipeline in a subprocess on 4 host devices at
P = 1, 2 and 4 and writes the loss and all gradients, with those of the
sequential model.  The port runs P = 1 in this process and P = 2 and 4 as
one process a stage over gloo; each rank writes its loss and its gradients
(its own stage's slice, and the replicated embedding and head), and all of
them must be within 1e-5 of JAX's pipeline and of the sequential model.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.train.pipeline import pipeline_efficiency as jax_efficiency
from repro.train.pipeline import split_stages as jax_split_stages

from repro_torch.launch.mesh import AbstractMesh
from repro_torch.train.pipeline import pipeline_efficiency, split_stages

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
L, d, V, M, mb, S = 8, 32, 64, 6, 2, 16
TOL = 1e-5

JAX_RUN = r'''
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.train.pipeline import pipeline_loss_fn, split_stages
data = dict(np.load(sys.argv[1]))
L = data["w"].shape[0]
block = lambda lp, x: x + jnp.tanh(x @ lp["w"])
embed = lambda ep, t: ep["e"][t]
def loss(hp, y, l):
    lg = y @ hp["h"]
    return (jax.nn.logsumexp(lg, -1) - jnp.take_along_axis(lg, l[..., None], -1)[..., 0]).mean()
batch = {"tokens": jnp.asarray(data["tokens"]), "labels": jnp.asarray(data["labels"])}
stacked = {"w": jnp.asarray(data["w"])}
out = {}
for P in (1, 2, 4):
    mesh = Mesh(np.array(jax.devices()[:P]), ("stage",))
    params = {"stages": split_stages(stacked, P), "embed": {"e": jnp.asarray(data["e"])},
              "head": {"h": jnp.asarray(data["h"])}}
    fn = pipeline_loss_fn(mesh, block, embed, loss)
    out[f"p{P}_loss"] = np.asarray(jax.jit(fn)(params, batch))
    g = jax.jit(jax.grad(fn))(params, batch)
    out[f"p{P}_w"] = np.asarray(g["stages"]["w"]).reshape(data["w"].shape)
    out[f"p{P}_e"] = np.asarray(g["embed"]["e"])
    out[f"p{P}_h"] = np.asarray(g["head"]["h"])
def seq(p):
    tot = 0.0
    for m in range(batch["tokens"].shape[0]):
        x = embed({"e": p["e"]}, batch["tokens"][m])
        for i in range(L):
            x = block({"w": p["w"][i]}, x)
        tot += loss({"h": p["h"]}, x, batch["labels"][m])
    return tot / batch["tokens"].shape[0]
p = {k: jnp.asarray(data[k]) for k in ("w", "e", "h")}
out["seq_loss"] = np.asarray(seq(p))
for k, v in jax.grad(seq)(p).items():
    out[f"seq_{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
'''

TORCH_RANK = r'''
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.launch.mesh import AbstractMesh, make_mesh
from repro_torch.train.pipeline import pipeline_loss_fn, split_stages

def block(lp, x):
    return x + torch.tanh(x @ lp["w"])

def embed(ep, t):
    return ep["e"][t]

def loss(hp, y, l):
    lg = y @ hp["h"]
    return (torch.logsumexp(lg, -1) - lg.gather(-1, l[..., None].long())[..., 0]).mean()

def run(rank, P, data, mesh):
    T = lambda k: torch.from_numpy(data[k].copy())
    stage = split_stages({"w": T("w")}, P)["w"][rank:rank + 1].clone().requires_grad_()
    params = {"stages": {"w": stage}, "embed": {"e": T("e").requires_grad_()},
              "head": {"h": T("h").requires_grad_()}}
    batch = {"tokens": T("tokens").long(), "labels": T("labels").long()}
    out = pipeline_loss_fn(mesh, block, embed, loss)(params, batch)
    out.backward()
    return {"loss": out.detach().numpy(), "w": stage.grad[0].numpy(),
            "e": params["embed"]["e"].grad.numpy(), "h": params["head"]["h"].grad.numpy()}

if __name__ == "__main__":
    rank, P, store, inp, outp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    dist.init_process_group("gloo", store=dist.FileStore(store, P), rank=rank, world_size=P)
    res = run(rank, P, dict(np.load(inp)), make_mesh((P,), ("stage",), "cpu"))
    np.savez(outp, **res)
    dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    rng = np.random.default_rng(0)
    data = {"w": (rng.standard_normal((L, d, d)) * 0.05).astype(np.float32),
            "e": (rng.standard_normal((V, d)) * 0.5).astype(np.float32),
            "h": (rng.standard_normal((d, V)) * 0.5).astype(np.float32),
            "tokens": rng.integers(0, V, (M, mb, S)).astype(np.int32),
            "labels": rng.integers(0, V, (M, mb, S)).astype(np.int32)}
    np.savez(tmp / "in.npz", **data)
    return tmp, data


@pytest.fixture(scope="module")
def jax_ref(inputs):
    tmp, _ = inputs
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", JAX_RUN, str(tmp / "in.npz"),
                          str(tmp / "jax.npz")], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(tmp / "jax.npz"))


def _torch_run(inputs, P):
    tmp, data = inputs
    if P == 1:
        ns = {}
        exec(compile(TORCH_RANK, "torch_rank", "exec"), ns)
        return [ns["run"](0, 1, data, AbstractMesh((1,), ("stage",)))]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    store = tmp / f"store{P}"
    procs = [subprocess.Popen([sys.executable, "-c", TORCH_RANK, str(r), str(P), str(store),
                               str(tmp / "in.npz"), str(tmp / f"out{P}_{r}.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for r in range(P)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [dict(np.load(tmp / f"out{P}_{r}.npz")) for r in range(P)]


def _close(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))) <= TOL


def test_efficiency_and_split_equal_jax():
    for m in (1, 4, 6, 16):
        for p in (1, 2, 4, 8):
            assert pipeline_efficiency(m, p) == jax_efficiency(m, p)
    x = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)
    for p in (1, 2, 4, 8):
        got = split_stages({"w": torch.from_numpy(x)}, p)["w"].numpy()
        assert np.array_equal(got, np.asarray(jax_split_stages({"w": x}, p)["w"]))
    with pytest.raises(ValueError, match="divisible"):
        split_stages({"w": torch.from_numpy(x)}, 3)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_pipeline_loss_and_gradients(inputs, jax_ref, P):
    """Every rank's loss, its stage's gradient and the full embedding and head
    gradients, gathered over the ranks, against JAX's pipeline at the same P
    and against the sequential model."""
    outs = _torch_run(inputs, P)
    k = L // P
    w = np.concatenate([o["w"] for o in outs])
    for ref in (f"p{P}_", "seq_"):
        for o in outs:
            assert _close(o["loss"], jax_ref[ref + "loss"]), (ref, o["loss"])
            assert _close(o["e"], jax_ref[ref + "e"]), ref
            assert _close(o["h"], jax_ref[ref + "h"]), ref
        assert _close(w, jax_ref[ref + "w"]), ref
    for r, o in enumerate(outs):
        assert o["w"].shape == (k, d, d)
    assert float(np.abs(w).sum()) > 0
