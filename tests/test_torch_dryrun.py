"""The port's dry-run and roofline (``repro_torch.launch.dryrun``,
``repro_torch.launch.roofline``, ``repro_torch.configs.shapes``,
``repro_torch.kernels.meta``) held against the JAX package and against
counts made by hand.

The JAX dry-run module sets ``XLA_FLAGS`` when imported, so its
``input_specs`` and the resident bytes of its ``build_lowerable`` on the two
production meshes come from a subprocess; the shapes, ``cell_applicable``,
``batch_specs`` and ``model_flops`` are compared in this process.  A meta
cell's operation count must equal ``FlopCounterMode`` over the same step on
real CPU tensors of a reduced config, where each kernel's forward is counted
by its formula (on the CPU the plain version, which counts every masked
pair, stands in for it); each formula must equal a hand count, and the
collective plan the rules counted by hand on a one-layer model.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.configs.shapes import cell_applicable as jax_cell_applicable
from repro.data.synthetic import batch_specs as jax_batch_specs
from repro.launch.roofline import model_flops as jax_model_flops

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_applicable
from repro_torch.data.synthetic import batch_specs, materialize_batch
from repro_torch.kernels import meta
from repro_torch.kernels import ref as ref_module
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import LM, reduced
from repro_torch.train.step import make_train_step

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PORT = Path(__file__).resolve().parent.parent / "src" / "repro_torch"

JAX_DUMP = r'''
import json, sys
import repro.launch.dryrun as dr            # sets XLA_FLAGS: 512 host devices
from repro.configs import ARCHS
from repro.configs.shapes import SHAPES, cell_applicable
out = {"specs": {}, "resident": {}}
for arch in ARCHS:
    for shape in SHAPES:
        cfg = dr.make_cell_config(arch, SHAPES[shape])
        out["specs"][f"{arch}|{shape}"] = {
            k: [list(v.shape), str(v.dtype)] for k, v in dr.input_specs(cfg, SHAPES[shape]).items()}
        if not cell_applicable(cfg, SHAPES[shape])[0]:
            continue
        for mk in ("single", "multi"):
            mesh = dr.make_production_mesh(multi_pod=(mk == "multi"))
            out["resident"][f"{arch}|{shape}|{mk}"] = dr.build_lowerable(arch, shape, mesh)[3]
json.dump(out, open(sys.argv[1], "w"))
'''


@pytest.fixture(scope="module")
def jax_dryrun(tmp_path_factory):
    path = tmp_path_factory.mktemp("jaxdr") / "dr.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_DUMP, str(path)], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


def _dt(t):
    return str(t.dtype).replace("torch.", "")


def test_shapes_and_applicability_equal_jax():
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, s in SHAPES.items():
        j = JAX_SHAPES[name]
        assert (s.name, s.kind, s.seq_len, s.global_batch) == (j.name, j.kind, j.seq_len,
                                                               j.global_batch)
    skips = 0
    for arch in ARCHS:
        for name in SHAPES:
            got = cell_applicable(get_config(arch), SHAPES[name])
            assert got == jax_cell_applicable(jax_get_config(arch), JAX_SHAPES[name])
            skips += not got[0]
    assert skips == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_jax(arch):
    for mode in ("train", "prefill"):
        for B, S in ((2, 16), (256, 4096)):
            cfg = get_config(arch, dtype="bfloat16")
            got = batch_specs(cfg, B, S, mode)
            want = jax_batch_specs(jax_get_config(arch, dtype="bfloat16"), B, S, mode)
            assert list(got) == list(want)
            for k, v in got.items():
                assert v.device.type == "meta"
                assert [list(v.shape), _dt(v)] == [list(want[k].shape), str(want[k].dtype)]


def test_input_specs_equal_jax(jax_dryrun):
    for arch in ARCHS:
        for shape in SHAPES:
            specs = dryrun.input_specs(dryrun.make_cell_config(arch, SHAPES[shape]),
                                       SHAPES[shape])
            got = {k: [list(v.shape), _dt(v)] for k, v in specs.items()}
            assert got == jax_dryrun["specs"][f"{arch}|{shape}"], (arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_resident_bytes_equal_jax(jax_dryrun, arch):
    """sharded_bytes_per_device of the parameter, optimizer and cache trees on
    both production meshes: the reference's ``build_lowerable`` info."""
    n = 0
    for shape in SHAPES:
        try:
            cell = dryrun.build_cell(arch, shape)
        except dryrun.SkipCell:
            continue
        for mk in ("single", "multi"):
            mesh = dryrun.make_production_mesh(multi_pod=(mk == "multi"))
            assert dryrun.cell_resident(cell, mesh) == \
                jax_dryrun["resident"][f"{arch}|{shape}|{mk}"], (shape, mk)
            n += 1
    assert n == (8 if cell.cfg.sub_quadratic() else 6)


# ---------------------------------------------------------------- formulas --
def test_attention_formula_is_a_hand_count():
    # causal S=4: 1+2+3+4 = 10 pairs; window 2: 1+2+2+2 = 7; full: 16
    assert meta.attention_work(1, 4, 1, 1, 2, 2) == (4 * 2 * 10, (2 * 8 + 2 * 8) * 2)
    assert meta.attention_work(1, 4, 1, 1, 2, 2, window=2)[0] == 4 * 2 * 7
    assert meta.attention_work(1, 4, 1, 1, 2, 2, causal=False)[0] == 4 * 2 * 16
    assert meta.attention_work(2, 4, 6, 2, 8, 4)[0] == 2 * 6 * 4 * 8 * 10
    # the training shape's reckoning in chip_smoke.py
    assert meta.attention_work(4, 2048, 16, 16, 64, 2)[0] == 34_376_515_584


def test_decode_formula_is_a_hand_count():
    # B=2 rows of 5 slots x Hq=4 heads, 4*D=32 a pair; bytes: q and o
    # (2*2*4*8*2), K and V over 10 slots (2*10*2*8*1), the lengths (8)
    assert meta.decode_work(2, 4, 2, 8, 10, 2, 1) == (32 * 4 * 10, 256 + 320 + 8)


def test_wkv_formula_is_a_hand_count():
    assert meta.wkv_tiling() == (32, 16)          # kChunk, kSub of csrc/rwkv6_scan.cu
    B, T, H, N = 1, 40, 1, 2
    # chunk 1 (32 tokens: two 16-token sub-chunks), chunk 2 (8 tokens, one)
    simt = (2 * 32 * 4 + 2 * 4 + 3 * 32 * 2) + 2 * (5 * 120 * 2 + 3 * 16 * 2)
    simt += (2 * 8 * 4 + 2 * 4 + 3 * 8 * 2) + (5 * 28 * 2 + 3 * 8 * 2)
    prod = (2 * 32 * 4 + 2 * (496 + 32) * 2 + 2 * 16 * 16 * 2) + (2 * 8 * 4 + 2 * (28 + 8) * 2)
    nbytes = 40 * 2 * (4 * 2 + 4) + 2 * 4 + 2 * 4 * 4
    assert meta.wkv_work(B, T, H, N, 2) == (simt + prod, nbytes)
    assert meta.wkv_backward_work(2, 3, 4, 5, 4)[0] == 6 * 2 * 4 * 3 * 25


def test_meta_route_counts_and_returns_shapes():
    q = torch.empty((2, 8, 4, 16), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 8, 2, 16), dtype=torch.bfloat16, device="meta")
    from repro_torch.kernels import ops

    with meta.count_kernel_work() as work:
        o = ops.attention(q, k, k, window=3)
        d = ops.decode_attention(q[:, 0], k, k, torch.empty(2, dtype=torch.int32,
                                                            device="meta"))
        y, s = ops.rwkv6(q, q, q, q.float(), torch.empty(4, 16, device="meta"),
                         torch.empty(2, 4, 16, 16, device="meta"))
    assert o.shape == q.shape and o.device.type == "meta" and o.dtype == torch.bfloat16
    assert d.shape == (2, 4, 16) and y.shape == q.shape and s.dtype == torch.float32
    assert work.calls == {"flash_attention": 1, "flash_decode": 1, "rwkv6_scan": 1}
    assert work.flops == (meta.attention_work(2, 8, 4, 2, 16, 2, True, 3)[0]
                          + meta.decode_work(2, 4, 2, 16, 2 * 8, 2, 2)[0]
                          + meta.wkv_work(2, 8, 4, 16, 2)[0])


# ---------------------------------------- meta cells against the CPU ----
SMALL = {"train_4k": ShapeSpec("train_4k", "train", 16, 2),
         "prefill_32k": ShapeSpec("prefill_32k", "prefill", 16, 2),
         "decode_32k": ShapeSpec("decode_32k", "decode", 16, 2)}


def _counted_refs(monkeypatch, total):
    """The CPU routes' plain versions, run with counting off, their work
    added by the kernels' formulas instead."""
    def wrap(fn, work):
        def counted(*args, **kw):
            total[0] += work(*args, **kw)
            with _disable_current_modes():
                return fn(*args, **kw)
        return counted

    def attn(q, k, v, *, causal=True, window=None, scale=None):
        B, S, Hq, D = q.shape
        return meta.attention_work(B, S, Hq, k.shape[2], D, 4, causal, window)[0]

    def dec(q, k, v, lengths, *, scale=None):
        return meta.decode_work(q.shape[0], q.shape[1], k.shape[2], q.shape[2],
                                q.shape[0] * k.shape[1], 4, 4)[0]

    def wkv(r, k, v, w, u, S0):
        B, T, H, N = r.shape
        return meta.wkv_work(B, T, H, N, 4)[0]

    monkeypatch.setattr(ref_module, "attention_ref", wrap(ref_module.attention_ref, attn))
    monkeypatch.setattr(ref_module, "decode_attention_ref",
                        wrap(ref_module.decode_attention_ref, dec))
    monkeypatch.setattr(ref_module, "rwkv6_ref", wrap(ref_module.rwkv6_ref, wkv))


@pytest.mark.parametrize("arch", ["olmo-1b", "rwkv6-3b", "qwen2-moe-a2.7b", "deepseek-v3-671b",
                                  "recurrentgemma-9b", "whisper-tiny", "qwen2-vl-72b"])
@pytest.mark.parametrize("shape", list(SMALL))
def test_meta_cell_flops_equal_the_cpu_step(monkeypatch, arch, shape):
    for name, spec in SMALL.items():
        monkeypatch.setitem(SHAPES, name, spec)
    cfg = reduced(get_config(arch), remat="block")
    cell = dryrun.build_cell(arch, shape, cfg=cfg)
    count = dryrun.trace_cell(cell)
    assert count["flops"] > 0

    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    s = SMALL[shape]
    total = [0]
    _counted_refs(monkeypatch, total)
    if s.kind == "train":
        batch = {k: torch.from_numpy(v) for k, v in
                 materialize_batch(cfg, s.global_batch, s.seq_len).items()}
        opt = dryrun.pick_optimizer(arch)
        state = opt.init(params)
        step = make_train_step(model, opt)
        run = lambda: step(params, state, batch)
    elif s.kind == "prefill":
        batch = {k: torch.from_numpy(v) for k, v in
                 materialize_batch(cfg, s.global_batch, s.seq_len, mode="prefill").items()}
        caches = model.init_cache(s.global_batch, s.seq_len)
        run = lambda: model.prefill(params, batch, caches)
    else:
        caches = model.init_cache(s.global_batch, s.seq_len)
        tokens = torch.zeros(s.global_batch, dtype=torch.int32)
        pos = torch.full((s.global_batch,), 5, dtype=torch.int32)
        ids = pos.expand(3, -1)[..., None].contiguous() if cfg.needs_position_ids else None
        run = lambda: model.decode_step(params, tokens, pos, caches, ids)
    with FlopCounterMode(display=False) as fc, (torch.enable_grad() if s.kind == "train"
                                                 else torch.no_grad()):
        run()
    assert fc.get_total_flops() + total[0] == count["flops"]


# ------------------------------------------------------------- the plan --
POD_MESH = AbstractMesh((2, 2, 2), ("pod", "data", "model"))


def _one_layer_cell(monkeypatch, kind, remat="none", arch="olmo-1b", seq=16, opt="auto",
                    **overrides):
    name = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    shape = ShapeSpec(name, kind, seq, 8)
    monkeypatch.setitem(SHAPES, shape.name, shape)
    cfg = reduced(get_config(arch), **{"n_layers": 1, "vocab": 128, "dtype": "bfloat16",
                                       "remat": remat, **overrides})
    return dryrun.build_cell(arch, shape.name, cfg=cfg, opt=opt)


def test_plan_counted_by_hand_train(monkeypatch):
    """One OLMo layer (d=128, d_ff=256, vocab 128, tied embedding, bf16, no
    remat) on pod 2 x data 2 x model 2, B=8, S=16, without SP.  Eight
    leaves, every one sharded over data and model (n = 4): the embedding and
    the four attention projections of 32768 bytes, the three MLP matrices of
    65536; 360448 bytes in all.  A device holds 2 rows, T = 32 tokens, a
    (T, d) bf16 activation X = 8192 bytes."""
    cell = _one_layer_cell(monkeypatch, "train")
    plan = dryrun.plan_collectives(cell, POD_MESH, seq_shard="none")
    b, X = 360448, 8192
    # two gathers over data of b*d/n = b/2 each a leaf; one reduce-scatter of b/4
    assert plan["all-gather"] == {"bytes": b, "count": 16}
    assert plan["reduce-scatter"] == {"bytes": b / 4, "count": 8}
    # the pod all-reduce of b/4 a leaf and its 4 bytes of the global norm;
    # over "model": attention's and the MLP's wo all-reduce their outputs in
    # the forward pass, the two column-parallel groups (wq/wk/wv, wi/wg)
    # their inputs' gradients in the backward, the vocab-parallel lookup its
    # rows (X each); the tied head's f32 hidden gradient (32 x 128 x 4); the
    # loss's max, sum and gold logit (32 x 4 each), its mean over the batch
    model = 2 * X + 2 * X + X + 32 * 128 * 4 + 3 * 32 * 4
    assert plan["all-reduce"] == {"bytes": b / 4 + 8 * 4 + model + 4, "count": 8 + 8 + 9 + 1}
    assert plan["all-to-all"]["count"] == 0
    assert plan["by_axis"] == {"data": b + b / 4, "pod": b / 4, "data+model": 32,
                               "model": model, "pod+data": 4}
    # on 2 devices a ring all-gather sends half its result, a reduce-scatter
    # its result, an all-reduce its result; on 4 an all-reduce 3/2 of it
    assert plan["wire_by_axis"] == {"data": b / 2 + b / 4, "pod": b / 4, "data+model": 48,
                                    "model": model, "pod+data": 6}
    assert plan["total_bytes"] == b + b / 4 + b / 4 + 32 + model + 4

    int8 = dryrun.plan_collectives(cell, POD_MESH, "int8", "none")
    # the pod all-reduce becomes the leaf's max-abs over its data and model
    # shards (4 bytes) and two gathers: 2*e/4 int8 bytes (e = b/2 elements)
    # and 4*2 bytes of scales, a leaf
    assert int8["all-gather"] == {"bytes": b + b / 4 + 8 * 8, "count": 16 + 16}
    assert int8["all-reduce"] == {"bytes": 8 * 4 + 8 * 4 + model + 4, "count": 8 + 8 + 9 + 1}
    assert int8["wire_by_axis"]["pod"] == b / 8 + 8 * 4
    # half the bf16 all-reduce's bytes on the pod links, plus the scales
    assert int8["wire_by_axis"]["pod"] == plan["wire_by_axis"]["pod"] / 2 + 32


def test_plan_counted_by_hand_int8_max_abs(monkeypatch):
    """The int8 step's max-abs reduction: one float32 a leaf all-reduced over
    the leaf's own shards inside a pod ("data+model" for all eight leaves),
    beside the global norm's; nothing of it over "pod"."""
    cell = _one_layer_cell(monkeypatch, "train")
    plain = dryrun.plan_collectives(cell, POD_MESH, seq_shard="none")
    int8 = dryrun.plan_collectives(cell, POD_MESH, "int8", "none")
    assert plain["by_axis"]["data+model"] == 8 * 4
    assert int8["by_axis"]["data+model"] == 2 * 8 * 4
    assert int8["wire_by_axis"]["data+model"] == 2 * 8 * 4 * 3 / 2
    assert "pod" not in dryrun.model_shardings(cell.cfg, cell.shape, POD_MESH, "sp",
                                              "int8")[0].spec.axes(0)


def test_plan_counted_by_hand_train_sp(monkeypatch):
    """The one-layer cell of the train hand count under SP (its S = 16
    divides by the model axis) with remat="block": two forward passes (the
    forward and the recompute) and the backward, run context-parallel as
    XLA partitions it.  T = 32 tokens and X = 8192 as there; 4 query heads
    of 32, as many K/V heads."""
    cell = _one_layer_cell(monkeypatch, "train", remat="block")
    act, logits = dryrun.model_shardings(cell.cfg, cell.shape, POD_MESH, "sp")
    assert act.spec == dryrun.PartitionSpec(("pod", "data"), "model")
    assert logits.spec == dryrun.PartitionSpec(("pod", "data"), None, "model")
    plan = dryrun.plan_collectives(cell, POD_MESH)
    b, X, T = 360448, 8192, 32
    # over "model": the seven layer matrices (327680 bytes), after their
    # data gathers, gathered whole in each forward pass; attention's
    # queries in each forward pass (X: K and V, 2 X, are more than the
    # queries and half the output), the output's gradient (X) and its two
    # softmax statistics (T x 4 heads x 4 bytes each) in the backward; the
    # tied table once for the lookup (b_embed * d * m / n = 32768); the
    # hidden once for the vocab-parallel logits (X)
    stats = T * 4 * 4
    ag_model = 2 * 327680 + 2 * X + X + 2 * stats + 32768 + X
    assert plan["all-gather"] == {"bytes": b + ag_model, "count": 16 + 14 + 2 + 1 + 2 + 1 + 1}
    # every leaf's gradient, a partial sum over the sequence shards,
    # reduce-scattered over "model" down to its data-gathered size (b/2 in
    # all); the partial outputs in each forward pass and the queries'
    # gradient (X/2 each); the f32 hidden gradient (T x 128 x 4 / 2)
    rs_model = b / 2 + 2 * X / 2 + X / 2 + T * 128 * 4 / 2
    assert plan["reduce-scatter"] == {"bytes": b / 4 + rs_model, "count": 8 + 8 + 2 + 1 + 1}
    assert plan["by_kind_axis"]["reduce-scatter"] == {"data": b / 4, "model": rs_model}
    # the softmax statistics in each forward pass and the loss's three
    # reductions; OLMo's norms carry no weights
    ar_model = 2 * 2 * stats + 3 * T * 4
    assert plan["all-reduce"] == {"bytes": b / 4 + 8 * 4 + ar_model + 4,
                                  "count": 8 + 8 + 4 + 3 + 1}
    assert plan["by_axis"]["model"] == ag_model + rs_model + ar_model
    # on 2 devices an all-gather sends half its result, a reduce-scatter or
    # an all-reduce its result.  Without SP: the row-parallel outputs in
    # both forward passes (4 X), the groups' input gradients (2 X), the
    # lookup (X), the f32 hidden gradient, the loss.  At 32 tokens a device
    # the weight gathers of context parallelism outweigh all of it
    none = dryrun.plan_collectives(cell, POD_MESH, seq_shard="none")
    assert plan["wire_by_axis"]["model"] == ag_model / 2 + rs_model + ar_model
    assert none["wire_by_axis"]["model"] == 7 * X + T * 128 * 4 + 3 * T * 4


def test_plan_sp_norm_gradients(monkeypatch):
    """Under SP the gradient of a leaf on the context-parallel path that is
    not split over "model" is a partial sum over the sequence shards and is
    all-reduced over "model": reduced qwen1.5-0.5b's norm1, norm2 and
    final_norm scales (d = 128 bf16: 256 bytes each); beside them the
    global-norm shares (4 bytes) of the q/k/v biases, split over "model"
    alone, the softmax statistics of its context-parallel attention (T = 32
    tokens x 4 heads x 4 bytes, twice) and the loss's three reductions."""
    cell = _one_layer_cell(monkeypatch, "train", arch="qwen1.5-0.5b")
    sp = dryrun.plan_collectives(cell, POD_MESH)
    assert sp["by_kind_axis"]["all-reduce"]["model"] == (3 * 256 + 3 * 4 + 2 * 32 * 4 * 4
                                                         + 3 * 32 * 4)
    none = dryrun.plan_collectives(cell, POD_MESH, seq_shard="none")
    assert "model" not in none["by_kind_axis"].get("reduce-scatter", {})
    # without SP: 2 row-parallel outputs, 2 column-parallel groups, the
    # lookup (X = 32 x 128 x 2 each), the f32 hidden gradient, the loss
    X = 32 * 128 * 2
    assert none["by_kind_axis"]["all-reduce"]["model"] == 5 * X + 2 * X + 3 * 32 * 4 + 3 * 4


def test_plan_counted_by_hand_mla(monkeypatch):
    """MLA's partner sums, on one reduced DeepSeek-V3 layer (d=128, 4 heads,
    q_lora 64, kv_lora 32, nope 32 + rope 16, v 32; a dense MLP; untied
    head) without SP or remat: T = 32 tokens a device, X = 8192 bytes."""
    cell = _one_layer_cell(monkeypatch, "train", arch="deepseek-v3-671b")
    plan = dryrun.plan_collectives(cell, POD_MESH, seq_shard="none")
    X, T = 8192, 32
    # the query latent, split over "model" by wdq (data, model), gathered
    # for q_norm and wuq (T x 64 x 2) and its gradient reduce-scattered;
    # beside it Adafactor's statistics gathered over "model": the row or
    # column means of the six factored matrices whose other dim is split
    # over "data" (the embedding, the head, wo, wi, wg and the MLP's wo:
    # 3 x 512 + 3 x 1024 bytes; test_plan_counted_by_hand_adafactor)
    assert plan["by_kind_axis"]["all-gather"]["model"] == T * 64 * 2 + 3 * 512 + 3 * 1024
    assert plan["by_kind_axis"]["reduce-scatter"]["model"] == T * 64 * 2 / 2
    # all-reduces over "model": the input gradients of wdq's and wi/wg's
    # groups, attention's and the MLP's wo outputs, the lookup (X each);
    # wuk/wuv's replicated key-value latent's gradient (T x 32 x 2); the
    # head's f32 hidden gradient; the loss; the global-norm shares of
    # wuq, wuk and wuv, split over "model" alone, and their Adafactor update
    # RMS (4 bytes each); the six factored matrices' means over their
    # "model" dims, partial sums over its two shards (half their 512 or
    # 1024 float32 bytes: 6 x 256)
    assert plan["by_kind_axis"]["all-reduce"]["model"] == (
        5 * X + T * 32 * 2 + T * 128 * 4 + 3 * T * 4 + 3 * 4 + 3 * 4 + 6 * 256)


def test_plan_counted_by_hand_decode(monkeypatch):
    cell = _one_layer_cell(monkeypatch, "decode")
    plan = dryrun.plan_collectives(cell, POD_MESH)
    b = 360448
    # the data gathers of b/2 a leaf; over "model", a row (2 a device) x 4
    # query heads x 32 x 2 bytes = 512 for the split-KV query gather and 512
    # each for the new token's K and V
    assert plan["all-gather"] == {"bytes": b / 2 + 3 * 512, "count": 8 + 3}
    # two row-parallel outputs and the vocab-parallel lookup, of 2 rows x
    # 128 x 2 bytes, and the split-KV reduction: 2 rows x 4 heads x (32 + 2)
    # f32 values
    assert plan["all-reduce"] == {"bytes": 3 * 512 + 2 * 4 * 34 * 4, "count": 4}
    assert plan["reduce-scatter"]["count"] == 0


def test_plan_counted_by_hand_rwkv_train_sp(monkeypatch):
    """One reduced RWKV6 layer (d = 128, d_ff = 256, vocab 128, untied,
    bf16) in training under SP with remat="block": two forward passes and
    the backward, T = 32 tokens a device, X = T x d x 2 = 8192 bytes."""
    cell = _one_layer_cell(monkeypatch, "train", remat="block", arch="rwkv6-3b")
    plan = dryrun.plan_collectives(cell, POD_MESH)
    X, kinds = 8192, plan["by_kind_axis"]
    # each token shift moves the normed stream off its sequence shard and
    # back each forward pass: 2 shifts x 2 all-to-alls x 2 passes, X/2 each
    assert kinds["all-to-all"] == {"model": 8 * X / 2}
    # in the backward each shift is a one-token halo: 2 rows x d x 2 bytes
    assert kinds["collective-permute"] == {"model": 2 * 2 * 128 * 2}
    # over "model": the block's eight matrices split over it (wr, wk, wv,
    # wg, wo, cm_r of 32768 bytes, cm_k, cm_v of 65536) gathered whole each
    # forward pass; the table once for the lookup (32768); the hidden for
    # the logits (X); the scan's r, k, v (X each) and float32 decay (2 X)
    # each forward pass and the outputs' gradient (X) in the backward
    weights = 6 * 32768 + 2 * 65536
    assert kinds["all-gather"]["model"] == 2 * weights + 32768 + X + 2 * (3 * X + 2 * X) + X


def test_plan_counted_by_hand_rwkv_prefill_sp(monkeypatch):
    """The RWKV6 layer at prefill under SP (B = 8, S = 16: T = 32, X =
    8192): the shifts' all-to-alls (4 x X/2), the scan's r, k and float32
    decay moved to the state's key shard ((2 X + 2 X)/2), v gathered (X),
    the outputs' float32 partial sums over the key shards all-reduced (2 X);
    the wkv and shift states are written from the shards they were
    computed on, the ones their cache holds: nothing else moves."""
    cell = _one_layer_cell(monkeypatch, "prefill", arch="rwkv6-3b")
    plan = dryrun.plan_collectives(cell, POD_MESH)
    X, kinds = 8192, plan["by_kind_axis"]
    assert kinds["all-to-all"] == {"model": 4 * X / 2 + 4 * X / 2}
    assert kinds["all-reduce"] == {"model": 2 * X}
    assert plan["collective-permute"]["count"] == plan["reduce-scatter"]["count"] == 0
    # over "model": the eight matrices once, the table, the last position's
    # hidden for the logits (2 rows x d x 2 bytes), v
    assert kinds["all-gather"]["model"] == 6 * 32768 + 2 * 65536 + 32768 + 512 + X


def test_plan_counted_by_hand_hybrid_train_sp(monkeypatch):
    """One reduced RG-LRU layer (d = lru width = 128, conv width 4) in
    training under SP with remat="block": each forward pass moves the
    conv's input and output (X/2 each, X = 8192) and the scan's input and
    states (float32: X each) to a batch shard and back; in the backward the
    conv's halo of 3 tokens is exchanged (2 rows x 3 x 128 x 2 bytes)."""
    cell = _one_layer_cell(monkeypatch, "train", remat="block", arch="recurrentgemma-9b")
    plan = dryrun.plan_collectives(cell, POD_MESH)
    X, kinds = 8192, plan["by_kind_axis"]
    assert kinds["all-to-all"] == {"model": 2 * (2 * X / 2 + 2 * 2 * X / 2)}
    assert kinds["collective-permute"] == {"model": 2 * 3 * 128 * 2}
    # a device sends a permute's result once
    assert dryrun._wire("collective-permute", 2, 1536) == 1536


def test_plan_counted_by_hand_hybrid_prefill_sp(monkeypatch):
    """Reduced RecurrentGemma (two RG-LRU layers, one local-attention layer,
    window 16) at prefill under SP, S = 32: T = 64 tokens a device, X = 64 x
    128 x 2 = 16384.  Each RG-LRU runs on its state's width shard: proj_x's
    and proj_g's outputs move there (X/2 each), proj_out reduce-scatters its
    partial sums (X/2); its conv and h states are written where they were
    computed.  The ring cache (16 slots, split over "model") is shorter
    than the sequence: the other rank receives the last window's K and V of
    its own 8 slots from the last sequence shard (2 rows x 8 x 1 head x 32 x
    2 bytes each)."""
    cell = _one_layer_cell(monkeypatch, "prefill", arch="recurrentgemma-9b", seq=32,
                           n_layers=3)
    plan = dryrun.plan_collectives(cell, POD_MESH)
    X, kinds = 16384, plan["by_kind_axis"]
    assert kinds["all-to-all"] == {"model": 2 * 2 * X / 2}
    assert kinds["reduce-scatter"] == {"model": 2 * X / 2}
    assert kinds["collective-permute"] == {"model": 2 * (2 * 8 * 1 * 32 * 2)}


def test_plan_counted_by_hand_moe_tokens_or_weights(monkeypatch):
    """Routed experts outside training, reduced Qwen-MoE (8 experts of
    d_expert 64 over "model", d = 128 over "data", top 2, groups of 16,
    capacity factor 1.25).  At decode (8 tokens: one group of 8, capacity
    ceil(8 x 2 x 1.25 / 8) = 3) a device holds 4 experts x 3 slots: moving
    them, 12 x (2 x 128 + 2 x 64) x 2 = 9216 bytes, costs less than
    gathering the three expert matrices (3 x 65536): the dispatched slots and
    the up projections' partial sums are all-reduced over "data", the down
    projection's outputs gathered.  At a prefill of 8 x 256 tokens (128
    groups, 32 a device, capacity 5) the 640 slots would move 491520 bytes:
    the weights are gathered."""
    decode = dryrun.plan_collectives(_one_layer_cell(monkeypatch, "decode",
                                                     arch="qwen2-moe-a2.7b"), POD_MESH)
    slots = 4 * 1 * 3
    assert decode["by_kind_axis"]["all-reduce"]["data"] == slots * 128 * 2 + 2 * slots * 64 * 2
    prefill = dryrun.plan_collectives(_one_layer_cell(monkeypatch, "prefill", seq=256,
                                                      arch="qwen2-moe-a2.7b"), POD_MESH)
    assert "data" not in prefill["by_kind_axis"]["all-reduce"]
    gathers = 3 * 65536
    assert (prefill["by_kind_axis"]["all-gather"]["data"]
            - decode["by_kind_axis"]["all-gather"]["data"] == gathers - slots * 128 * 2)


def test_plan_counted_by_hand_adafactor(monkeypatch):
    """Adafactor's statistics on one reduced Command R+ layer (d = 128, 4
    query and 4 K/V heads of 32, d_ff = 256, tied table), without SP: eight
    factored matrices, each split over "data" on one dim and "model" on the
    other.  A mean over a dim is a partial sum over that dim's two shards,
    all-reduced there (half its float32 bytes), then gathered over the other
    axis (the statistics are replicated): the table, wq, wk, wv and wo have
    512-byte row and column means, wi and wg 512 and 1024, the MLP's wo 1024
    and 512; each leaf's update RMS is 4 bytes over its four shards.  The
    plan with AdamW differs by these alone."""
    ada = _one_layer_cell(monkeypatch, "train", arch="command-r-plus-104b")
    adamw = _one_layer_cell(monkeypatch, "train", arch="command-r-plus-104b", opt="adamw")
    assert isinstance(ada.optimizer, dryrun.Adafactor)
    plan = dryrun.plan_collectives(ada, POD_MESH, seq_shard="none")
    base = dryrun.plan_collectives(adamw, POD_MESH, seq_shard="none")
    means = 5 * (512 + 512) + 3 * (512 + 1024)
    assert plan["all-gather"]["bytes"] - base["all-gather"]["bytes"] == means
    assert plan["all-reduce"]["bytes"] - base["all-reduce"]["bytes"] == means / 2 + 8 * 4
    assert (plan["by_axis"]["data+model"] - base["by_axis"]["data+model"]) == 8 * 4


def test_plan_counted_by_hand_xent_chunk(monkeypatch):
    """The chunked cross-entropy (xent_chunk = 2) recomputes each chunk's
    logits in the backward: on the one-layer OLMo cell under SP with
    remat="block" the hidden is gathered for the logits again (X = 8192)
    and the loss's max, sum and gold logit reduced again (3 x 32 x 4)."""
    whole = _one_layer_cell(monkeypatch, "train", remat="block")
    chunked = _one_layer_cell(monkeypatch, "train", remat="block", xent_chunk=2)
    a = dryrun.plan_collectives(whole, POD_MESH)
    b = dryrun.plan_collectives(chunked, POD_MESH)
    assert b["all-gather"]["bytes"] - a["all-gather"]["bytes"] == 8192
    assert b["all-reduce"]["bytes"] - a["all-reduce"]["bytes"] == 3 * 32 * 4
    assert b["reduce-scatter"] == a["reduce-scatter"]


def test_cli_seq_shard_none_sends_less_over_model(tmp_path):
    """--seq-shard none prices the same trace with fewer bytes over "model"
    than the default sp, counted as the reference's records count them (a
    reduce-scatter as the all-reduce of its input, result x group size);
    both records get one key, as the reference's do."""
    recs = []
    for flag in ("sp", "none"):
        out = tmp_path / f"{flag}.json"
        assert dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k", "--mesh", "single",
                            "--seq-shard", flag, "--out", str(out)]) == 0
        recs.append(json.loads(out.read_text()))
    assert list(recs[0]) == list(recs[1]) == ["olmo-1b|train_4k|single|remat=block"]
    sp, none = (r["olmo-1b|train_4k|single|remat=block"] for r in recs)

    def model_bytes(rec):
        kinds, m = rec["collectives"]["by_kind_axis"], rec["mesh_shape"]["model"]
        return sum(v * (m if kind == "reduce-scatter" else 1)
                   for kind, axes in kinds.items() for a, v in axes.items() if a == "model")

    assert model_bytes(none) < model_bytes(sp)
    assert none["flops_per_device"] == sp["flops_per_device"]


# --------------------------------------------------------------- roofline --
def test_model_flops_and_roofline_row():
    rec = {"arch": "qwen1.5-0.5b", "mesh": "multi", "chips": 512, "status": "ok",
           "params": 463_987_712, "active_params": None,
           "flops_per_device": 2e12, "bytes_per_device": 6.7e10,
           "mesh_shape": {"pod": 2, "data": 16, "model": 16},
           "collectives": {"wire_by_axis": {"data": 1e9, "pod": 5e8}}}
    for shape in SHAPES:
        rec["shape"] = shape
        assert roofline.model_flops(rec) == jax_model_flops(rec)
    rec["memory"] = {"temp_size_in_bytes": 3 * 2**30, "peak_bytes": 81 * 2**30, "fits": False}
    row = roofline.roofline_row(dict(rec, shape="train_4k"))
    assert row["compute_s"] == 2e12 / 989e12
    assert row["memory_s"] == 6.7e10 / 3.35e12
    assert row["collective_s"] == 1e9 / 50e9 + 5e8 / 50e9
    assert row["dominant"] == "collective" and row["hbm_temp_gib"] == 3.0
    assert row["peak_gib"] == 81.0 and row["fits"] is False
    assert "  81.00   no" in roofline.format_table([row])
    assert roofline.axis_bandwidth({"data": 2, "model": 4}, ["model"]) == 450e9
    assert roofline.axis_bandwidth({"data": 2, "model": 4}, ["data"]) == 450e9
    assert roofline.axis_bandwidth({"data": 16, "model": 16}, ["model"]) == 50e9
    assert roofline.axis_bandwidth({"data": 4, "model": 4}, ["data"]) == 50e9


def test_no_tpu_constant_in_the_port():
    pattern = re.compile(r"197e12|819e9|ICI_BW|\bICI\b")
    for path in PORT.rglob("*.py"):
        assert not pattern.search(path.read_text()), path


def test_cli_writes_and_rereads_its_results(tmp_path, capsys):
    out = tmp_path / "dr.json"
    args = ["--arch", "whisper-tiny", "--shape", "decode_32k", "--mesh", "both",
            "--out", str(out)]
    assert dryrun.main(args) == 0
    results = json.loads(out.read_text())
    assert sorted(results) == ["whisper-tiny|decode_32k|multi|remat=block",
                               "whisper-tiny|decode_32k|single|remat=block"]
    rec = results["whisper-tiny|decode_32k|single|remat=block"]
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["kernel_calls"] == {"flash_decode": 4}
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                  "alias_size_in_bytes", "temp_size_in_bytes", "peak_bytes",
                                  "fits", "peak_parts"}
    assert rec["memory"]["alias_size_in_bytes"] == rec["resident"]["cache_bytes_per_device"]
    assert dryrun.main(args) == 0
    assert capsys.readouterr().out.count("[cached]") == 2
    # a record written before records carried ``memory`` is run again
    single = "whisper-tiny|decode_32k|single|remat=block"
    results = json.loads(out.read_text())
    del results[single]["memory"]
    out.write_text(json.dumps(results))
    assert dryrun.main(args) == 0
    printed = capsys.readouterr().out
    assert printed.count("[cached]") == 1 and f"[dryrun] {single}" in printed
    assert json.loads(out.read_text())[single]["memory"] == rec["memory"]
    rows = roofline.build_table(json.loads(out.read_text()), "single")
    assert [r["arch"] for r in rows] == ["whisper-tiny"]
    roofline.main(["--results", str(out)])
    assert "whisper-tiny" in capsys.readouterr().out
