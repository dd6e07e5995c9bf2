"""The JAX dry-run's collective records, read for the port's plan, shared by
``test_torch_collectives.py`` and the files that hold more cells to it.

The JAX ``run_cell`` lowers and compiles a cell for 512 placeholder host
devices and sums the collectives of the partitioned HLO.  It gives records
only on meshes whose axes are Auto: the installed ``jax.make_mesh``'s default
Explicit axes make ``with_sharding_constraint`` raise.  So a subprocess
builds the two meshes with ``AxisType.Auto`` (data 4 x model 2, and pod 2 x
data 2 x model 2), puts them in place of ``make_production_mesh`` and runs
the JAX ``run_cell`` on each cell; nothing of the JAX package changes.  A
record's ``collectives`` and ``flops_per_device`` come from its probes alone
(the one- and two-layer unrolled compiles it extrapolates from), so a cell
may be run as its probes only (``probes_only``): the JAX package's own
``probe_configs``, ``build_lowerable``, ``_analyze``, ``_seg_counts`` and
``extrapolate_costs``, without the full compile, which only proves memory.

Each probe's HLO is read once more, to take out what an H100 program would
not send and to put in what the record's count misses, extrapolated as the
record is:

  * Widened by the CPU compiler (every cell).  An all-reduce whose reducer
    is ``*.clone_promoted`` is a bf16 all-reduce that XLA's CPU pipeline
    promoted to f32 (the CPU runtime has no bf16 reduction); so is an element
    of a combined all-reduce that is a ``dot`` of such operands or such a
    fusion (the combiner merges a promoted gradient reduction into the
    global norm's f32 one, whose reducer it keeps: of two twin gradient dots
    one is reduced ``clone_promoted``, the other beside the norm).  An
    all-gather or all-to-all whose operand is a fusion converting bf16 to
    f32 moves a bf16 weight or activation the CPU widened for its f32
    products.  An H100 moves them in bf16: half their bytes are taken out.
  * A collective inside a ``while`` loop of known trip count (the RWKV
    time scan, which the probes do not unroll) runs once a step; the record
    counts it once.  It is counted its trip count times.
  * ``EXCEPTIONS`` of each file, each named by cell, kind, mesh axes and the
    HLO instruction's ``op_name``, with its reason; their bytes are taken out
    whole.

The CPU-compiled records hold no reduce-scatter: where the program
reduces a tensor that ends up sharded (a data-sharded leaf's gradient), the
CPU HLO all-reduces the whole tensor and slices it.  So a port
reduce-scatter counts as the all-reduce of its input: its result times its
group size.
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
MULTI = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
KINDS = ("all-gather", "all-reduce", "all-to-all")

JAX_RUN = r'''
import collections, json, os, re, sys, time
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
cells, exceptions, probes_only = (json.loads(a) for a in sys.argv[1:4])

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
    """(widened bytes by kind, excepted bytes by id, bytes by axes, bytes a
    loop adds by kind) of one compile."""
    fused, defs, owner, calls, cur, entry = {}, {}, {}, collections.defaultdict(list), None, None
    for line in txt.splitlines():
        head = re.match(r"^(ENTRY )?%(\S+) .*\{$", line)
        if head:
            cur, comp = fused.setdefault(head.group(2), []), head.group(2)
            entry = comp if head.group(1) else entry
            continue
        if cur is not None:
            cur.append(line)
        d = re.match(r"\s*(?:ROOT )?%(\S+) = ", line)
        if d:
            defs[d.group(1)], owner[d.group(1)] = line, comp
            trip = re.search(r'known_trip_count":\{"n":"(\d+)"', line)
            for c in re.finditer(r"(body|condition|to_apply|calls)=%([\w.\-]+)", line):
                calls[comp].append((c.group(2), int(trip.group(1))
                                    if trip and c.group(1) == "body" else 1))
            for c in re.finditer(r"(?:branch|called)_computations=\{([^}]*)\}", line):
                calls[comp] += [(x.strip().lstrip("%"), 1) for x in c.group(1).split(",")]
    trips, todo = {entry: 1}, [entry]          # runs of each computation a step
    while todo:
        comp = todo.pop()
        for callee, n in calls[comp]:
            if callee not in trips:
                trips[callee] = trips[comp] * n
                todo.append(callee)

    def widened_fusion(name):
        calls_ = re.search(r"calls=%(\S+?)[,\s]", defs.get(name, ""))
        body = "\n".join(fused.get(calls_.group(1), [])) if calls_ else ""
        return "bf16[" in body and bool(re.search(r"f32\[[^\]]*\][^=]*convert\(", body))

    def widened_element(name):
        src = re.match(r"\s*(?:ROOT )?%\S+ = (\S+) ([\w-]+)\(([^)]*)\)", defs.get(name, ""))
        if not src:
            return 0
        if src.group(2) == "dot":
            wide = all(widened_fusion(o.strip().lstrip("%")) for o in src.group(3).split(",")[:2])
        else:
            wide = src.group(2) == "fusion" and widened_fusion(name)
        return dr._shape_bytes(src.group(1)) if wide else 0

    widened, excepted, by_axis, looped = (collections.Counter() for _ in range(4))
    for line in txt.splitlines():
        ls = line.strip()
        m = re.match(r"(?:ROOT )?%?(\S+)\s*=\s*(\(.*?\)|\S+\[\S*\]\S*)\s+(\S+)\((.*?)\)", ls)
        if not m:
            continue
        kind = next((k for k in dr._COLL_KINDS
                     if m.group(3) == k or m.group(3).startswith(k + "-")), None)
        if kind is None:
            continue
        nbytes = dr._shape_bytes(m.group(2))
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
        operands = [o.strip().lstrip("%") for o in m.group(4).split(",")]
        if "clone_promoted" in ls:
            wide = nbytes
        elif kind in ("all-gather", "all-to-all"):
            wide = nbytes if widened_fusion(operands[0]) else 0
        elif kind == "all-reduce":
            wide = sum(widened_element(o) for o in operands)
        else:
            wide = 0
        widened[kind] += wide
        looped[kind] += (trips.get(owner.get(m.group(1)), 1) - 1) * (nbytes - wide / 2)
    return widened, excepted, by_axis, looped

texts = []
analyze = dr._analyze
def capture(compiled):
    texts.append(compiled.as_text())
    return analyze(compiled)
dr._analyze = capture

out = {}
for cid, (arch, shape, mk, variant) in cells.items():
    texts.clear()
    t0 = time.perf_counter()
    mesh = auto_mesh(mk == "multi")
    cfg_keys = ("dispatch", "remat", "xent_chunk", "kv_dtype", "group_size")
    cfg = dr.make_cell_config(arch, SHAPES[shape],
                              **{k: v for k, v in variant.items() if k in cfg_keys})
    counts = [dr._seg_counts(p) for p in dr.probe_configs(cfg)]
    true = dr._seg_counts(cfg)
    ext = lambda vals: dr.extrapolate_costs(counts, vals, true)
    if cid in probes_only:
        # the record's collectives and FLOPs, from the probes as run_cell
        # extrapolates them
        texts.append(None)                  # no full compile
        with mesh:
            probes = []
            for pcfg in dr.probe_configs(cfg):
                _, pfn, pargs, _ = dr.build_lowerable(arch, shape, mesh, cfg=pcfg, **variant)
                probes.append(dr._analyze(pfn.lower(*pargs).compile()))
        coll = {k: {"bytes": ext([p["coll"][k]["bytes"] for p in probes])}
                for k in dr._COLL_KINDS}
        coll["total_bytes"] = ext([p["coll"]["total_bytes"] for p in probes])
        rec = {"collectives": coll, "flops_per_device": ext([p["flops"] for p in probes]),
               "memory": {}}
    else:
        rec = dr.run_cell(arch, shape, mk, **variant)
        assert rec["status"] == "ok", (cid, rec.get("error"))
    names, sizes = list(mesh.axis_names), list(mesh.devices.shape)
    parts = [parse(t, names, sizes, cid) for t in texts[1:]]    # the probes
    coll = rec["collectives"]
    out[cid] = {
        "kinds": {k: coll[k]["bytes"] for k in dr._COLL_KINDS},
        "total": coll["total_bytes"],
        "flops_per_device": rec["flops_per_device"],
        "widened": {k: ext([w.get(k, 0) for w, _, _, _ in parts]) for k in dr._COLL_KINDS},
        "excepted": {i: ext([e.get(i, 0) for _, e, _, _ in parts]) for i in exceptions},
        "by_axis": {a: ext([b.get(a, 0) for _, _, b, _ in parts])
                    for a in set().union(*(b for _, _, b, _ in parts))},
        "looped": {k: ext([lp.get(k, 0) for _, _, _, lp in parts]) for k in dr._COLL_KINDS},
        "memory": rec["memory"],
        "seconds": time.perf_counter() - t0,
    }
json.dump(out, open(sys.argv[4], "w"))
'''


def jax_records(cells, exceptions, path, timeout_s, probes_only=()):
    """The JAX records of ``cells`` (id: (arch, shape, mesh kind, variant)),
    from one subprocess; the ids in ``probes_only`` from their probes
    alone."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    try:
        out = subprocess.run([sys.executable, "-c", JAX_RUN, json.dumps(cells),
                              json.dumps(exceptions), json.dumps(list(probes_only)), str(path)],
                             capture_output=True, text=True, env=env, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the JAX dry-run of {len(cells)} cells took over {timeout_s} s "
                    "(it compiles each cell's probes for 512 host devices); "
                    "a slow or crowded host, not a plan fault")
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


def port_records(cells):
    """The port's records of ``cells`` on abstract meshes of the same sizes."""
    traces, out = {}, {}
    for cid, (arch, shape, mk, variant) in cells.items():
        rec = dryrun.run_cell(arch, shape, mk, mesh=MULTI if mk == "multi" else SINGLE,
                              traces=traces, **variant)
        assert rec["status"] == "ok", rec.get("error")
        out[cid] = rec
    return out


def jax_normalised(rec, cid, exceptions):
    """A record's bytes by kind as an H100 program under its specs sends
    them: widened halves out, loop steps in, named exceptions out."""
    kinds = {k: v - rec["widened"][k] / 2 + rec["looped"][k] for k, v in rec["kinds"].items()}
    for i, (cells, kind, _, _, _) in exceptions.items():
        if cid in cells:
            kinds[kind] -= rec["excepted"][i]
    return kinds


def port_normalised(rec):
    """The port's bytes by kind, a reduce-scatter as the all-reduce of its
    input."""
    c = rec["collectives"]
    kinds = {k: c[k]["bytes"] for k in ("all-gather", "all-reduce", "all-to-all",
                                        "collective-permute")}
    sizes = rec["mesh_shape"]
    for axes, nbytes in c["by_kind_axis"].get("reduce-scatter", {}).items():
        kinds["all-reduce"] += nbytes * math.prod(sizes[a] for a in axes.split("+"))
    return kinds


MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes", "alias_size_in_bytes")


def assert_memory_within(jax, port, cid):
    """A device's argument and alias bytes equal to the record's (no leaf or
    input is padded on these meshes: every sharded dim divides), its output
    bytes within 1% (the step's float32 metrics or the last position's
    logits beside the aliased state, a few bytes apart).  The record's
    temporaries are the CPU compiler's figure, not a card's: printed beside
    the port's, not held."""
    for key in MEMORY_KEYS[::2]:
        assert port[key] == jax[key], (cid, key, port[key], jax[key])
    key = MEMORY_KEYS[1]
    assert abs(port[key] / jax[key] - 1) <= 0.01, (cid, key, port[key], jax[key])
    print(f"{cid}: output {port[key]} against {jax[key]} bytes; temporaries "
          f"{port['temp_size_in_bytes']} traced against {jax['temp_size_in_bytes']} on the "
          f"CPU compiler")


def assert_within(jax, port, cid):
    """The total within a factor of 1.5 of the record's; each of
    all-gather, all-reduce and all-to-all within 2, a kind under 1% of both
    totals excepted."""
    assert min(port.values()) >= 0 and min(jax.values()) >= -1e-6 * sum(jax.values())
    jt, pt = sum(jax.values()), sum(port.values())
    assert 1 / 1.5 <= pt / jt <= 1.5, (cid, pt / jt, port, jax)
    for kind in KINDS:
        if max(jax[kind] / jt, port[kind] / pt) < 0.01:
            continue
        assert jax[kind] > 0 and 0.5 <= port[kind] / jax[kind] <= 2, (cid, kind, port, jax)
