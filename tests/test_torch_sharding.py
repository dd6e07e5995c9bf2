"""The port's meshes and sharding rules (``repro_torch.launch.mesh`` and
``repro_torch.launch.sharding``) held against the JAX package's.

The JAX side runs in a subprocess that imports ``repro.launch.dryrun``, which
sets ``XLA_FLAGS`` for 512 host devices, so the production meshes and the
small test meshes are real JAX meshes there.  It writes, for all ten
architectures at full width, every leaf's path, shape and dtype and the spec
of each of ``param_pspec`` (modes train, infer, train_ep), the optimizer
states' specs (AdamW with bf16 state, Adafactor), the ``prefill_32k`` and
``decode_32k`` caches' ``cache_pspec``, ``batch_shardings`` and ``_dp_for``,
on meshes (16,16), (2,16,16), (2,2,2) and (4,2); the port builds the same
trees on the meta device and must give ``==`` specs leaf for leaf.  Last, on
a 2x2 gloo ``DeviceMesh`` in four processes, ``distribute_tensor`` with the
port's placements leaves each rank the block that JAX's
``devices_indices_map`` names for the same spec.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.shapes import SHAPES
from repro_torch.data.synthetic import batch_specs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (AbstractMesh, dp_axes, make_production_mesh,
                                     mesh_axis_sizes)
from repro_torch.launch.sharding import (PartitionSpec, _dp_for, batch_shardings,
                                         cache_pspec, param_pspec)
from repro_torch.models import LM
from repro_torch.tree import tree_flatten, tree_paths

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
MODES = ("train", "infer", "train_ep")
CACHE_CELLS = ("prefill_32k", "decode_32k")
BATCHES = (1, 2, 6, 8, 16, 32, 256)

JAX_DUMP = r'''
import json, sys
import numpy as np
import repro.launch.dryrun as dr            # sets XLA_FLAGS: 512 host devices
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import ARCHS
from repro.configs.shapes import SHAPES
from repro.data.synthetic import batch_specs
from repro.launch.sharding import (_dp_for, _path_str, batch_shardings, cache_pspec,
                                   param_pspec)
from repro.models import LM
from repro.optim.optimizers import Adafactor, AdamW

MESHES = json.loads(sys.argv[2])
meshes = {k: Mesh(np.array(jax.devices()[:int(np.prod(s))]).reshape(s), tuple(n))
          for k, (s, n) in MESHES.items()}

def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(_path_str(p), list(x.shape), str(x.dtype)) for p, x in flat]

def opt_specs(opt_sds, mesh):
    sh = dr._opt_state_shardings(opt_sds, mesh, mode="train")
    return [enc(s.spec) for s in jax.tree.leaves(sh, is_leaf=lambda x: hasattr(x, "spec"))]

out = {"archs": {}, "dp_for": {}, "batch": {}}
for arch in ARCHS:
    cfg = dr.make_cell_config(arch, SHAPES["train_4k"])
    model = LM(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    rec = {"params": leaves(params), "specs": {}, "opt": {}, "cache": {}}
    for mk, mesh in meshes.items():
        rec["specs"][mk] = {mode: [enc(param_pspec(p, tuple(s), mesh, mode))
                                   for p, s, _ in rec["params"]] for mode in
                            ("train", "infer", "train_ep")}
    for name, opt in (("adamw", AdamW(lr=3e-4, state_dtype="bfloat16")),
                      ("adafactor", Adafactor(lr=1e-3))):
        sds = jax.eval_shape(opt.init, params)
        rec["opt"][name] = {"leaves": leaves(sds),
                            "specs": {mk: opt_specs(sds, m) for mk, m in meshes.items()}}
    for cell in ("prefill_32k", "decode_32k"):
        shape = SHAPES[cell]
        c = jax.eval_shape(lambda: LM(dr.make_cell_config(arch, shape)).init_cache(
            shape.global_batch, shape.seq_len))
        lv = leaves(c)
        rec["cache"][cell] = {"leaves": lv, "specs": {
            mk: [enc(cache_pspec(p, tuple(s), m)) for p, s, _ in lv]
            for mk, m in meshes.items()}}
    out["archs"][arch] = rec
    for B in (1, 2, 6, 8, 16, 32, 256):
        specs = batch_specs(cfg, B, 16, mode="train")
        out["batch"][f"{arch}|{B}"] = {
            mk: {k: enc(v.spec) for k, v in batch_shardings(specs, m).items()}
            for mk, m in meshes.items()}
for mk, m in meshes.items():
    out["dp_for"][mk] = [list(_dp_for(B, m)) for B in range(1, 70)]

# the blocks a 2x2 mesh gives each device, for the distribute test
m22 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
blocks = {}
for name, (shape, spec) in json.loads(sys.argv[3]).items():
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    imap = NamedSharding(m22, spec).devices_indices_map(tuple(shape))
    blocks[name] = [[[s.start or 0, s.stop if s.stop is not None else n]
                     for s, n in zip(imap[d], shape)] for d in m22.devices.flat]
out["blocks"] = blocks
json.dump(out, open(sys.argv[1], "w"))
'''

# (shape, spec) of the 2x2 distribute test: a projection, an embedding, a
# replicated leaf, a batch and a train_ep expert leaf (one dim over
# ("model", "data"), model major, against the mesh's own order)
DIST_CASES = {
    "wq": ((8, 12), ["data", "model"]),
    "embedding": ((12, 8), ["model", "data"]),
    "norm": ((6,), [None]),
    "tokens": ((8, 5), [["data"]]),
    "experts_wi": ((8, 6, 4), [["model", "data"], None, None]),
    "position_ids": ((3, 4, 5), [None, ["data"]]),
}


@pytest.fixture(scope="module")
def jax_specs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "specs.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", JAX_DUMP, str(path),
         json.dumps({k: [list(s), list(n)] for k, (s, n) in MESHES.items()}),
         json.dumps(DIST_CASES)],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


def _abstract(mk):
    shape, names = MESHES[mk]
    return AbstractMesh(shape, names)


def _enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _leaves(tree):
    leaves, _ = tree_flatten(tree)
    return [[p, list(x.shape), str(x.dtype).replace("torch.", "")]
            for p, x in zip(tree_paths(tree), leaves)]


@pytest.fixture(scope="module")
def meta_params():
    return {arch: LM(dryrun.make_cell_config(arch, SHAPES["train_4k"]), device="meta").init(
        torch.Generator()) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax_on_every_leaf(jax_specs, meta_params, arch):
    rec = jax_specs["archs"][arch]
    leaves = _leaves(meta_params[arch])
    assert leaves == rec["params"]
    for mk in MESHES:
        mesh = _abstract(mk)
        for mode in MODES:
            got = [_enc(param_pspec(p, tuple(s), mesh, mode)) for p, s, _ in leaves]
            assert got == rec["specs"][mk][mode], (mk, mode)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizer_state_specs_equal_jax(jax_specs, meta_params, arch, opt):
    rec = jax_specs["archs"][arch]["opt"][opt]
    optimizer = dryrun.AdamW(lr=3e-4, state_dtype="bfloat16") if opt == "adamw" else \
        dryrun.Adafactor(lr=1e-3)
    state = optimizer.init(meta_params[arch])
    assert _leaves(state) == rec["leaves"]
    for mk in MESHES:
        sh = dryrun._opt_state_shardings(state, _abstract(mk), mode="train")
        assert [_enc(s.spec) for s in tree_flatten(sh)[0]] == rec["specs"][mk], mk


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cell", CACHE_CELLS)
def test_cache_specs_equal_jax(jax_specs, arch, cell):
    rec = jax_specs["archs"][arch]["cache"][cell]
    shape = SHAPES[cell]
    caches = LM(dryrun.make_cell_config(arch, shape), device="meta").init_cache(
        shape.global_batch, shape.seq_len)
    leaves = _leaves(caches)
    assert leaves == rec["leaves"]
    for mk in MESHES:
        got = [_enc(cache_pspec(p, tuple(s), _abstract(mk))) for p, s, _ in leaves]
        assert got == rec["specs"][mk], mk


def test_batch_shardings_and_dp_for_equal_jax(jax_specs):
    for mk in MESHES:
        mesh = _abstract(mk)
        assert [list(_dp_for(B, mesh)) for B in range(1, 70)] == jax_specs["dp_for"][mk]
        for arch in ARCHS:
            cfg = dryrun.make_cell_config(arch, SHAPES["train_4k"])
            for B in BATCHES:
                got = {k: _enc(v.spec)
                       for k, v in batch_shardings(batch_specs(cfg, B, 16), mesh).items()}
                assert got == jax_specs["batch"][f"{arch}|{B}"][mk], (mk, arch, B)


def test_partition_spec_compares_with_jax_entries():
    from jax.sharding import PartitionSpec as P

    assert P("data", "model") == tuple(PartitionSpec("data", "model"))
    assert P(("pod", "data")) == tuple(PartitionSpec(("pod", "data")))
    assert P(("data",)) == tuple(PartitionSpec(("data",)))
    assert PartitionSpec(("data",)) == ("data",)


def test_sharding_rules_on_production_mesh():
    """Every case of tests/test_system.py::test_sharding_rules_on_production_mesh."""
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    # attention projection: column-parallel
    assert param_pspec("segments/0/attn/wq/w", (16, 2048, 2048), mesh) == (None, "data", "model")
    # embedding: vocab on model, FSDP on d
    assert param_pspec("embed/embedding", (50304, 2048), mesh) == ("model", "data")
    # whisper's odd vocab cannot shard on model -> falls back
    assert param_pspec("embed/embedding", (51865, 384), mesh)[0] is None
    # experts: EP on expert dim
    assert param_pspec("segments/1/ffn/experts/wi", (58, 256, 7168, 2048), mesh)[1] == "model"
    # batch shardings: B=8 divisible by pod*data=4
    tokens = {"tokens": torch.empty((8, 64), dtype=torch.int32, device="meta")}
    assert batch_shardings(tokens, mesh)["tokens"].spec == (("pod", "data"),)
    # B=1: replicated
    tokens = {"tokens": torch.empty((1, 64), dtype=torch.int32, device="meta")}
    assert batch_shardings(tokens, mesh)["tokens"].spec == (None,)
    assert dp_axes(mesh) == ("pod", "data")
    assert mesh_axis_sizes(make_production_mesh(multi_pod=True)) == {
        "pod": 2, "data": 16, "model": 16}
    assert make_production_mesh().size == 256


DIST_RANK = r'''
import json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import NamedSharding, PartitionSpec
rank, world, store, cases = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
out = {}
for name, (shape, spec) in json.loads(cases).items():
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    sh = NamedSharding(mesh, PartitionSpec(*spec))
    local = distribute_tensor(full, mesh, list(sh.placements)).to_local()
    out[name] = {"local": local.flatten().tolist(), "shape": list(local.shape),
                 "placements": [repr(p) for p in sh.placements]}
print("RESULT" + json.dumps(out))
dist.destroy_process_group()
'''


def _run_ranks(code, world, tmp_path, *args, timeout=120):
    """``code`` in ``world`` processes (rank, world, FileStore path, *args in
    ``sys.argv``); every one must exit 0 within ``timeout``.  Returns their
    standard outputs by rank."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), store, *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_distribute_tensor_leaves_the_jax_block_on_each_rank(jax_specs, tmp_path):
    outs = _run_ranks(DIST_RANK, 4, tmp_path, json.dumps(DIST_CASES))
    for rank, out in enumerate(outs):
        got = json.loads(out.split("RESULT", 1)[1])
        for name, (shape, _) in DIST_CASES.items():
            full = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
            block = full[tuple(slice(a, b) for a, b in jax_specs["blocks"][name][rank])]
            assert got[name]["shape"] == list(block.shape), (rank, name)
            assert got[name]["local"] == block.flatten().tolist(), (rank, name)
    placements = json.loads(outs[0].split("RESULT", 1)[1])["experts_wi"]["placements"]
    assert "_StridedShard" in placements[0] and placements[1] == "Shard(dim=0)"
