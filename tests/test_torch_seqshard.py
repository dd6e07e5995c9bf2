"""Sequence parallelism's shardings on the port's model (``LM.act_sharding``,
``LM.logits_sharding``, ``LM._wsc``) and ``data.pipeline.shard_batch``.

On a plain tensor a constraint is the identity, as JAX's
``with_sharding_constraint`` is on one device: the model's outputs on the
CPU must be ``==`` with the shardings set and unset, and those outputs are
the ones the other port tests hold against the JAX model.  On a DTensor it
redistributes: in two gloo processes the constrained stream must carry the
spec's placements and the same full value, and ``shard_batch`` must leave
each rank the rows the train batch's ``batch_shardings`` name, as the JAX
``shard_batch`` (``jax.device_put``) does, sliced from the rank's own array
with no collective.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import Prefetcher, shard_batch
from repro_torch.data.synthetic import materialize_batch
from repro_torch.launch.dryrun import model_shardings
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.sharding import NamedSharding, PartitionSpec
from repro_torch.models import LM, reduced

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _outputs(model, params, batch):
    loss, metrics = model.loss(params, batch)
    caches = model.init_cache(2, 24)
    logits, caches = model.prefill(params, {"tokens": batch["tokens"]}, caches)
    tok = logits.argmax(-1).to(torch.int32)
    step, _ = model.decode_step(params, tok, torch.full((2,), 16, dtype=torch.int32), caches)
    return [loss, metrics["xent"], metrics["moe_aux"], logits, step]


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-moe-a2.7b"])
def test_outputs_equal_with_and_without_shardings(arch):
    cfg = reduced(get_config(arch), dtype="float32")
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in materialize_batch(cfg, 2, 16).items()}
    plain = _outputs(model, params, batch)
    mesh = AbstractMesh((2, 2), ("data", "model"))
    model.act_sharding, model.logits_sharding = model_shardings(
        cfg, ShapeSpec("train_4k", "train", 16, 2), mesh, "sp")
    assert model.act_sharding.spec == PartitionSpec("data", "model")
    assert model.logits_sharding.spec == PartitionSpec("data", None, "model")
    sharded = _outputs(model, params, batch)
    for a, b in zip(plain, sharded):
        assert torch.equal(a, b)


def test_model_shardings_follow_the_reference():
    """The reference's ``build_lowerable`` rules: the sequence over "model"
    only for a non-decode cell under sp whose S divides; "pod" left out of
    the stream's batch axes under int8; vocab over "model" when it divides."""
    cfg = get_config("whisper-tiny")                     # vocab 51865: odd
    multi = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    train = ShapeSpec("train_4k", "train", 4096, 256)
    act, logits = model_shardings(cfg, train, multi, "sp")
    assert act.spec == PartitionSpec(("pod", "data"), "model")
    assert logits.spec == PartitionSpec(("pod", "data"), None, None)
    assert model_shardings(cfg, train, multi, "none")[0].spec == PartitionSpec(("pod", "data"),
                                                                               None)
    assert model_shardings(cfg, train, multi, "sp", "int8")[0].spec == PartitionSpec(
        "data", "model")
    odd = ShapeSpec("train_4k", "train", 4095, 256)
    assert model_shardings(cfg, odd, multi, "sp")[0].spec == PartitionSpec(("pod", "data"),
                                                                           None)
    decode = ShapeSpec("decode_32k", "decode", 32768, 1)
    act, logits = model_shardings(get_config("olmo-1b"), decode, multi, "sp")
    assert act.spec == PartitionSpec(None, None)
    assert logits.spec == PartitionSpec(None, None, "model")
    with pytest.raises(ValueError):
        model_shardings(cfg, train, multi, "ring")


def test_shard_batch_refuses_an_abstract_mesh_and_passes_other_keys():
    batch = {"tokens": np.arange(8, dtype=np.int32).reshape(2, 4),
             "extra": np.ones((3,), dtype=np.float32)}
    sh = {"tokens": NamedSharding(AbstractMesh((2,), ("data",)), PartitionSpec("data"))}
    with pytest.raises(ValueError, match="DeviceMesh"):
        shard_batch(batch, sh, "cpu")
    out = shard_batch({"extra": batch["extra"]}, sh, "cpu")
    assert out["extra"].device.type == "cpu" and torch.equal(out["extra"],
                                                              torch.ones(3))
    pf = Prefetcher(iter([{"extra": batch["extra"]}]), depth=1, device="cpu", shardings=sh)
    assert torch.equal(next(pf)["extra"], torch.ones(3))
    pf.close()


RANK = r'''
import datetime, json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from repro_torch.configs import get_config
from repro_torch.data.pipeline import Prefetcher, shard_batch
from repro_torch.data.synthetic import materialize_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import NamedSharding, PartitionSpec, batch_shardings
from repro_torch.models import LM, reduced
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=30))
out = {}
cfg = reduced(get_config("qwen1.5-0.5b"), dtype="float32")
batch = materialize_batch(cfg, 4, 16, seed=3)
batch["extra"] = np.arange(6, dtype=np.float32)
dp = make_mesh((2, 1), ("data", "model"), "cpu")
sh = batch_shardings({k: torch.from_numpy(v) for k, v in batch.items() if k != "extra"}, dp)
out["specs"] = {k: list(v.spec) for k, v in sh.items()}
local = lambda got: {k: [type(v).__name__, (v.to_local() if isinstance(v, DTensor) else v).tolist()]
                     for k, v in got.items()}
out["direct"] = local(shard_batch(batch, sh))
pf = Prefetcher(iter([batch]), depth=1, shardings=sh)
out["prefetch"] = local(next(pf))
pf.close()
# no collective: each rank in turn places an array of its own while the
# other waits in a barrier; a scatter from rank 0 would pair with the
# barrier and fail, or hand rank 1 rank 0's rows
for turn in range(world):
    if rank == turn:
        own = {"tokens": batch["tokens"] + 1000 * (rank + 1)}
        out["own"] = shard_batch(own, {"tokens": sh["tokens"]})["tokens"].to_local().tolist()
    dist.barrier()
sp = make_mesh((1, 2), ("data", "model"), "cpu")
model = LM(cfg, device="cpu")
model.act_sharding = NamedSharding(sp, PartitionSpec("data", "model"))
x = torch.arange(2 * 8 * 4, dtype=torch.float32).reshape(2, 8, 4)
stream = distribute_tensor(x, sp, [Replicate(), Replicate()])
y = model._wsc(stream)
out["wsc"] = {"placements": [repr(p) for p in y.placements],
              "want": [repr(p) for p in model.act_sharding.placements],
              "local": list(y.to_local().shape), "equal": bool(torch.equal(y.full_tensor(), x))}
print("RESULT" + json.dumps(out))
dist.destroy_process_group()
'''


def test_shard_batch_and_wsc_on_two_gloo_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), "2", store],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.split("RESULT", 1)[1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    cfg = reduced(get_config("qwen1.5-0.5b"), dtype="float32")
    batch = materialize_batch(cfg, 4, 16, seed=3)
    for rank, got in enumerate(outs):
        assert got["specs"] == {"tokens": ["data"], "labels": ["data"]}
        for name in ("direct", "prefetch"):
            for key in ("tokens", "labels"):
                kind, local = got[name][key]
                assert kind == "DTensor"
                assert local == batch[key][2 * rank:2 * rank + 2].tolist(), (rank, key)
            assert got[name]["extra"] == ["Tensor", list(range(6))]
        assert got["own"] == (batch["tokens"][2 * rank:2 * rank + 2] + 1000 * (rank + 1)).tolist()
        wsc = got["wsc"]
        assert wsc["placements"] == wsc["want"] == ["Shard(dim=0)", "Shard(dim=1)"]
        assert wsc["local"] == [2, 4, 4] and wsc["equal"]


RANK4 = r'''
import datetime, json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import NamedSharding, PartitionSpec
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=30))
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
out = {"coord": mesh.get_coordinate()}
for name, spec in (("minor_first", PartitionSpec(("model", "data"))),
                   ("major_first", PartitionSpec(("data", "model"))),
                   ("two_dims", PartitionSpec("data", "model"))):
    sh = NamedSharding(mesh, spec)
    got = shard_batch({"x": x}, {"x": sh})["x"]
    ref = distribute_tensor(torch.from_numpy(x), mesh, list(sh.placements), src_data_rank=None)
    out[name] = {"local": got.to_local().tolist(), "ref": ref.to_local().tolist(),
                 "full": bool(torch.equal(got.full_tensor(), torch.from_numpy(x)))}
print("RESULT" + json.dumps(out))
dist.destroy_process_group()
'''


def test_shard_batch_layout_on_four_gloo_ranks(tmp_path):
    """A dim split over two axes keeps JAX's order, the first axis major,
    in either mesh order: each rank's block is the numpy slice
    ``jax.device_put`` gives it, the block ``distribute_tensor`` gives for
    the spec's placements, and the DTensor's full value the array."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", RANK4, str(r), "4", store],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for r in range(4)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.split("RESULT", 1)[1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    for got in outs:
        d, m = got["coord"]
        want = {"minor_first": x[2 * (2 * m + d):2 * (2 * m + d) + 2],
                "major_first": x[2 * (2 * d + m):2 * (2 * d + m) + 2],
                "two_dims": x[4 * d:4 * d + 4, 3 * m:3 * m + 3]}
        for name, block in want.items():
            assert got[name]["local"] == block.tolist(), (got["coord"], name)
            assert got[name]["ref"] == block.tolist(), (got["coord"], name)
            assert got[name]["full"]
