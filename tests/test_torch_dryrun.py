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
def _one_layer_cell(monkeypatch, kind):
    shape = {"train": ShapeSpec("train_4k", "train", 16, 8),
             "decode": ShapeSpec("decode_32k", "decode", 16, 8)}[kind]
    monkeypatch.setitem(SHAPES, shape.name, shape)
    cfg = reduced(get_config("olmo-1b"), n_layers=1, vocab=128, dtype="bfloat16")
    return dryrun.build_cell("olmo-1b", shape.name, cfg=cfg)


def test_plan_counted_by_hand_train(monkeypatch):
    """One OLMo layer (d=128, d_ff=256, vocab 128, tied embedding, bf16) on
    pod 2 x data 2 x model 2, B=8, S=16.  Eight leaves, every one sharded
    over data and model (n = 4): the embedding and the four attention
    projections of 32768 bytes, the three MLP matrices of 65536; 360448
    bytes in all."""
    cell = _one_layer_cell(monkeypatch, "train")
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    plan = dryrun.plan_collectives(cell, mesh)
    b = 360448
    # two gathers over data of b*d/n = b/2 each a leaf; one reduce-scatter of b/4
    assert plan["all-gather"] == {"bytes": b, "count": 16}
    assert plan["reduce-scatter"] == {"bytes": b / 4, "count": 8}
    # the pod all-reduce of b/4; attention's and the MLP's wo, row-parallel,
    # all-reduce 32 tokens a device x 128 x 2 bytes, 3 passes each
    act = 32 * 128 * 2 * 3 * 2
    assert plan["all-reduce"] == {"bytes": b / 4 + act, "count": 8 + 6}
    assert plan["all-to-all"]["count"] == 0
    assert plan["by_axis"] == {"data": b + b / 4, "pod": b / 4, "model": act}
    # on 2 devices a ring all-gather sends half its result, a reduce-scatter
    # its result, an all-reduce its result
    assert plan["wire_by_axis"] == {"data": b / 2 + b / 4, "pod": b / 4, "model": act}
    assert plan["total_bytes"] == b + b / 4 + b / 4 + act

    int8 = dryrun.plan_collectives(cell, mesh, "int8")
    # the pod all-reduce becomes two gathers: 2*e/4 int8 bytes (e = b/2
    # elements) and 4*2 bytes of scales, a leaf
    assert int8["all-gather"] == {"bytes": b + b / 4 + 8 * 8, "count": 16 + 16}
    assert int8["all-reduce"] == {"bytes": act, "count": 6}
    assert int8["wire_by_axis"]["pod"] == b / 8 + 8 * 4
    # half the bf16 all-reduce's bytes on the pod links, plus the scales
    assert int8["wire_by_axis"]["pod"] == plan["wire_by_axis"]["pod"] / 2 + 32


def test_plan_counted_by_hand_decode(monkeypatch):
    cell = _one_layer_cell(monkeypatch, "decode")
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    plan = dryrun.plan_collectives(cell, mesh)
    b = 360448
    assert plan["all-gather"] == {"bytes": b / 2, "count": 8}
    # two row-parallel outputs of 2 rows x 128 x 2 bytes, and the split-KV
    # reduction: 2 rows x 4 heads x (32 + 2) f32 values
    assert plan["all-reduce"] == {"bytes": 2 * 512 + 2 * 4 * 34 * 4, "count": 3}
    assert plan["reduce-scatter"]["count"] == 0


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
    row = roofline.roofline_row(dict(rec, shape="train_4k"))
    assert row["compute_s"] == 2e12 / 989e12
    assert row["memory_s"] == 6.7e10 / 3.35e12
    assert row["collective_s"] == 1e9 / 50e9 + 5e8 / 50e9
    assert row["dominant"] == "collective" and row["hbm_temp_gib"] is None
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
    assert dryrun.main(args) == 0
    assert capsys.readouterr().out.count("[cached]") == 2
    rows = roofline.build_table(json.loads(out.read_text()), "single")
    assert [r["arch"] for r in rows] == ["whisper-tiny"]
    roofline.main(["--results", str(out)])
    assert "whisper-tiny" in capsys.readouterr().out
