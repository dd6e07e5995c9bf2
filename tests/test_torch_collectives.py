"""The port's collective plan (``repro_torch.launch.dryrun.plan_collectives``)
held against the JAX dry-run's own records.

The JAX ``run_cell`` lowers and compiles a cell for 512 placeholder host
devices and sums the collectives of the partitioned HLO.  It gives records
on this image only on meshes whose axes are Auto: ``jax.make_mesh``'s default
Explicit axes make ``with_sharding_constraint`` raise.  So a subprocess
builds the two meshes with ``AxisType.Auto`` (data 4 x model 2, and pod 2 x
data 2 x model 2), puts them in place of ``make_production_mesh`` and runs
the JAX ``run_cell`` on each cell; nothing of the JAX package changes.  The
port's ``run_cell`` runs on an ``AbstractMesh`` of the same sizes.

Each compile's HLO (the full cell and the one- and two-layer probes whose
extrapolation the record holds) is read once more, to take out what an H100
program would not send, extrapolated as the record is:

  * Widened by the CPU compiler (every cell).  An all-reduce whose reducer
    is ``*.clone_promoted`` is a bf16 all-reduce that XLA's CPU pipeline
    promoted to f32 (the CPU runtime has no bf16 reduction); an all-gather
    whose operand is a fusion converting bf16 to f32 gathers a bf16 weight
    or activation the CPU widened for its f32 products.  An H100 moves them
    in bf16: half their bytes are taken out.
  * ``EXCEPTIONS`` below, each named by cell, kind, mesh axes and the HLO
    instruction's ``op_name``, with its reason; their bytes are taken out
    whole.

The JAX records hold no reduce-scatter on this image: where the program
reduces a tensor that ends up sharded (a data-sharded leaf's gradient), the
CPU HLO all-reduces the whole tensor and slices it (the olmo-1b gradients of
``wi``/``wg`` are ``all-reduce`` of their full ``f32[2048,4096]`` over
"data", not of the ``[512,4096]`` shard).  So a port reduce-scatter counts as
the all-reduce of its input: its result times its group size.

Within those rules, a compared cell's total lies within a factor of 1.5 of
the record's and each of all-gather, all-reduce and all-to-all within a
factor of 2, a kind under 1% of both totals excepted; the sequence-parallel
cell moves more bytes over "model" than the one without, in both packages,
counted so.
"""
import json
import math
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

SINGLE = AbstractMesh((4, 2), ("data", "model"))
JAX_TIMEOUT_S = 240
MULTI = AbstractMesh((2, 2, 2), ("pod", "data", "model"))

# id: (arch, shape, mesh kind, variant).  The int8 cell is left out: its
# compile aborts XLA (``Check failed`` at spmd_partitioner_util.cc:495).
CELLS = {
    "olmo-train-sp": ("olmo-1b", "train_4k", "single", {}),
    "olmo-train-none": ("olmo-1b", "train_4k", "single", {"seq_shard": "none"}),
    "olmo-prefill": ("olmo-1b", "prefill_32k", "single", {}),
    "olmo-decode": ("olmo-1b", "decode_32k", "multi", {}),
    "moe-train-sp": ("qwen2-moe-a2.7b", "train_4k", "single", {}),
    "minitron-train-sp": ("minitron-8b", "train_4k", "single", {}),
}

_SCORES = ("Under SP XLA shards attention's sequence and materialises the (B, H, S, S) "
           "f32 weights; the backward redistributes them from query- to key-sharded. "
           "The port's attention kernel never materialises them: it gathers the "
           "sequence before attention (Megatron SP).")
_LOOKUP = ("The untied embedding's lookup runs for all 256 batch rows on the rank's "
           "(vocab/model, d/data) table shard (f32[256,4096,1024]), is all-reduced over "
           "'model', and all-to-alls over 'model' and over 'data' then move the rows to the "
           "stream's (batch, sequence) shard; a rank looks up the tokens of its own shard.")
# id: (cells, kind, axes, op_name tail, reason)
EXCEPTIONS = {
    "attention-scores": (("olmo-train-sp", "moe-train-sp"), "all-to-all",
                         "model", "mul", _SCORES),
    "lookup-rows-model": (("minitron-train-sp",), "all-to-all", "model", "gather", _LOOKUP),
    "lookup-rows-data": (("minitron-train-sp",), "all-to-all", "data", "gather", _LOOKUP),
    "cache-rows": (("olmo-prefill",), "all-gather", "data", "scatter",
                   "The prefill's K/V cache write gathers every batch row's K and V "
                   "(f32[32,32768,16,128]) over 'data' before scattering them into a cache "
                   "whose batch is data-sharded; each rank writes its own rows."),
    "cache-heads": (("olmo-prefill",), "all-gather", "model", "scatter",
                    "K and V (f32[8,32768,16,128]), computed on the rank's sequence shard, "
                    "are gathered whole over 'model' and sliced back into the "
                    "sequence-sharded cache; each rank writes its own slots."),
    "decode-lookup": (("olmo-decode",), "all-to-all", "data", "gather",
                      "XLA's 'Involuntary full rematerialization' of the embedding lookup "
                      "(bf16[128,1,1024] gather): the rows are replicated, then "
                      "repartitioned."),
    "decode-lookup-rows": (("olmo-decode",), "all-gather", "pod", "gather",
                           "The same rematerialization: the lookup's f32[128,1,1024] rows "
                           "gathered over 'pod'."),
    "decode-cache-rows": (("olmo-decode",), "all-gather", "pod+data", "scatter",
                          "The decode step's K/V write gathers the new token of every batch "
                          "row (f32[128,1,16,128]) over the batch axes before the scatter."),
}

JAX_RUN = r'''
import collections, json, os, re, sys
import numpy as np
import repro.launch.dryrun as dr            # sets XLA_FLAGS: 512 host devices
# the records come from the partitioned HLO and its cost analysis, which the
# CPU backend's LLVM optimisation leaves as they are; without it a compile
# takes about a fifth less time
os.environ["XLA_FLAGS"] += (" --xla_backend_optimization_level=0"
                            " --xla_llvm_disable_expensive_passes=true")
import repro.launch.mesh as mesh_mod
import jax
from jax.sharding import AxisType
from repro.configs.shapes import SHAPES

def auto_mesh(multi_pod=False):
    if multi_pod:
        return jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                             axis_types=(AxisType.Auto,) * 3)
    return jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)

mesh_mod.make_production_mesh = dr.make_production_mesh = auto_mesh
cells, exceptions = json.loads(sys.argv[1]), json.loads(sys.argv[2])

def groups(rg):
    m = re.match(r"\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?", rg)
    if m:
        a = np.arange(int(np.prod([int(x) for x in m.group(3).split(",")])))
        a = a.reshape([int(x) for x in m.group(3).split(",")])
        if m.group(4):
            a = a.transpose([int(x) for x in m.group(4).split(",")])
        return a.reshape(int(m.group(1)), int(m.group(2))).tolist()
    return [[int(x) for x in g.split(",") if x] for g in re.findall(r"\{([\d,]*)\}", rg)]

def parse(txt, names, sizes, cell):
    """(widened bytes by kind, excepted bytes by id, bytes by axes) of one
    compile."""
    fused, defs, cur = {}, {}, None
    for line in txt.splitlines():
        head = re.match(r"^(?:ENTRY )?%(\S+) .*\{$", line)
        if head:
            cur = fused.setdefault(head.group(1), [])
            continue
        if cur is not None:
            cur.append(line)
        d = re.match(r"\s*(?:ROOT )?%(\S+) = ", line)
        if d:
            defs[d.group(1)] = line
    widened, excepted, by_axis = (collections.Counter() for _ in range(3))
    for line in txt.splitlines():
        ls = line.strip()
        m = re.match(r"(?:ROOT )?%?\S+\s*=\s*(\(.*?\)|\S+\[\S*\]\S*)\s+(\S+)\((.*?)\)", ls)
        if not m:
            continue
        kind = next((k for k in dr._COLL_KINDS
                     if m.group(2) == k or m.group(2).startswith(k + "-")), None)
        if kind is None:
            continue
        nbytes = dr._shape_bytes(m.group(1))
        rg = re.search(r"replica_groups=(\S+?)(,\s|$)", ls)
        axes = ""
        if rg:
            coords = [np.unravel_index(i, sizes) for i in groups(rg.group(1))[0]]
            axes = "+".join(n for j, n in enumerate(names) if len({c[j] for c in coords}) > 1)
        by_axis[axes] += nbytes
        op = re.search(r'op_name="([^"]*)"', ls)
        op = op.group(1).rsplit("/", 1)[-1] if op else ""
        hit = [i for i, (cs, k, ax, o, _) in exceptions.items()
               if cell in cs and k == kind and ax == axes and o == op]
        if hit:
            excepted[hit[0]] += nbytes
            continue
        if "clone_promoted" in ls:
            widened[kind] += nbytes
        elif kind == "all-gather":
            src = defs.get(m.group(3).split(",")[0].strip().lstrip("%"), "")
            calls = re.search(r"calls=%(\S+?)[,\s]", src)
            body = "\n".join(fused.get(calls.group(1), [])) if calls else ""
            if "bf16[" in body and re.search(r"f32\[[^\]]*\][^=]*convert\(", body):
                widened[kind] += nbytes
    return widened, excepted, by_axis

texts = []
analyze = dr._analyze
def capture(compiled):
    texts.append(compiled.as_text())
    return analyze(compiled)
dr._analyze = capture

out = {}
for cid, (arch, shape, mk, variant) in cells.items():
    texts.clear()
    rec = dr.run_cell(arch, shape, mk, **variant)
    assert rec["status"] == "ok", (cid, rec.get("error"))
    mesh = auto_mesh(mk == "multi")
    names, sizes = list(mesh.axis_names), list(mesh.devices.shape)
    parts = [parse(t, names, sizes, cid) for t in texts[1:]]    # the probes
    cfg = dr.make_cell_config(arch, SHAPES[shape])
    counts = [dr._seg_counts(p) for p in dr.probe_configs(cfg)]
    true = dr._seg_counts(cfg)
    ext = lambda vals: dr.extrapolate_costs(counts, vals, true)
    coll = rec["collectives"]
    out[cid] = {
        "kinds": {k: coll[k]["bytes"] for k in dr._COLL_KINDS},
        "total": coll["total_bytes"],
        "flops_per_device": rec["flops_per_device"],
        "widened": {k: ext([w.get(k, 0) for w, _, _ in parts]) for k in dr._COLL_KINDS},
        "excepted": {i: ext([e.get(i, 0) for _, e, _ in parts]) for i in exceptions},
        "by_axis": {a: ext([b.get(a, 0) for _, _, b in parts])
                    for a in set().union(*(b for _, _, b in parts))},
        "temp_bytes": rec["memory"].get("temp_size_in_bytes"),
        "seconds": rec["total_s"],
    }
json.dump(out, open(sys.argv[3], "w"))
'''


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    path = tmp_path_factory.mktemp("jaxcoll") / "records.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    try:
        out = subprocess.run([sys.executable, "-c", JAX_RUN, json.dumps(CELLS),
                              json.dumps(EXCEPTIONS), str(path)],
                             capture_output=True, text=True, env=env, timeout=JAX_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the JAX dry-run of {len(CELLS)} cells took over {JAX_TIMEOUT_S} s "
                    "(it compiles each cell and its two probes for 512 host devices); "
                    "a slow or crowded host, not a plan fault")
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port_records():
    traces = {}
    out = {}
    for cid, (arch, shape, mk, variant) in CELLS.items():
        rec = dryrun.run_cell(arch, shape, mk, mesh=MULTI if mk == "multi" else SINGLE,
                              traces=traces, **variant)
        assert rec["status"] == "ok", rec.get("error")
        out[cid] = rec
    return out


def _jax_normalised(rec, cid):
    kinds = {k: v - rec["widened"][k] / 2 for k, v in rec["kinds"].items()}
    for i, (cells, kind, _, _, _) in EXCEPTIONS.items():
        if cid in cells:
            kinds[kind] -= rec["excepted"][i]
    return kinds


def _port_normalised(rec, cid):
    c = rec["collectives"]
    kinds = {k: c[k]["bytes"] for k in ("all-gather", "all-reduce", "all-to-all",
                                        "collective-permute")}
    sizes = rec["mesh_shape"]
    for axes, nbytes in c["by_kind_axis"].get("reduce-scatter", {}).items():
        kinds["all-reduce"] += nbytes * math.prod(sizes[a] for a in axes.split("+"))
    return kinds


def test_every_exception_takes_out_bytes(jax_records):
    """Each named exception matches HLO instructions in its cells."""
    for i, (cells, *_rest) in EXCEPTIONS.items():
        for cid in cells:
            assert jax_records[cid]["excepted"][i] > 0, (i, cid)
    # the attention weights' all-to-all is the records' whole all-to-all
    for cid in EXCEPTIONS["attention-scores"][0]:
        rec = jax_records[cid]
        assert rec["excepted"]["attention-scores"] == pytest.approx(rec["kinds"]["all-to-all"])
    # K and V whole (f32), 16 layers, and their s32 slot indices
    cache = 16 * 2 * 8 * 32768 * 16 * 128 * 4
    assert cache <= jax_records["olmo-prefill"]["excepted"]["cache-heads"] <= 1.001 * cache


@pytest.mark.parametrize("cid", list(CELLS))
def test_plan_within_the_jax_record(jax_records, port_records, cid):
    jax = _jax_normalised(jax_records[cid], cid)
    port = _port_normalised(port_records[cid], cid)
    assert min(port.values()) >= 0 and min(jax.values()) >= -1e-6 * sum(jax.values())
    jt, pt = sum(jax.values()), sum(port.values())
    assert 1 / 1.5 <= pt / jt <= 1.5, (cid, pt / jt, port, jax)
    for kind in ("all-gather", "all-reduce", "all-to-all"):
        if max(jax[kind] / jt, port[kind] / pt) < 0.01:
            continue
        assert jax[kind] > 0 and 0.5 <= port[kind] / jax[kind] <= 2, (cid, kind, port, jax)


def _model_bytes(by_axis):
    return sum(v for axes, v in by_axis.items() if "model" in axes.split("+"))


def _port_model_bytes(rec):
    """The port's bytes over "model", a reduce-scatter counted as the
    all-reduce of its input."""
    m = rec["mesh_shape"]["model"]
    return sum(v * (m if kind == "reduce-scatter" else 1)
               for kind, axes in rec["collectives"]["by_kind_axis"].items()
               for a, v in axes.items() if "model" in a.split("+"))


def test_sequence_parallel_sends_more_over_model(jax_records, port_records):
    """In both packages the SP cell moves more bytes over "model" than the
    cell without SP, counted as the JAX records count them (the port's
    reduce-scatters as all-reduces of their inputs; JAX's with the attention
    weights' all-to-all taken out), and the two records share a variant
    tag, and so a key.  In result bytes the port's SP moves less: its
    reduce-scatters return a shard."""
    sp, none = port_records["olmo-train-sp"], port_records["olmo-train-none"]
    assert _port_model_bytes(sp) > _port_model_bytes(none)
    assert (_model_bytes(sp["collectives"]["by_axis"])
            < _model_bytes(none["collectives"]["by_axis"]))
    assert sp["variant"] == none["variant"] == {}
    j_sp, j_none = jax_records["olmo-train-sp"], jax_records["olmo-train-none"]
    scores = j_sp["excepted"]["attention-scores"]
    assert _model_bytes(j_sp["by_axis"]) - scores > _model_bytes(j_none["by_axis"])


@pytest.mark.parametrize("cid", ["olmo-train-sp", "olmo-train-none", "moe-train-sp",
                                 "minitron-train-sp"])
def test_train_flops_within_3_percent_of_jax(jax_records, port_records, cid):
    jax, port = jax_records[cid]["flops_per_device"], port_records[cid]["flops_per_device"]
    assert abs(port / jax - 1) <= 0.03, (cid, port / jax)
