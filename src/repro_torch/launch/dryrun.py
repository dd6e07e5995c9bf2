"""Dry-run of the (arch x shape x mesh) grid on the meta device.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles every cell for 512 placeholder host devices and reads XLA's cost
and memory analyses.  Here a cell is built on PyTorch's meta device, where
tensors have shapes and dtypes but no storage, so a full-width model of any
size costs host time only:

  1. the exact published config, bf16, and meta stand-ins for its inputs
     (:func:`input_specs`);
  2. ``LM(cfg, device="meta")``, its ``init``, the optimizer's state (train)
     or ``init_cache`` (prefill, decode), all on meta, with the sharding
     rules' specs on the cell's mesh;
  3. one trace of the step (train: the train step with its optimizer
     update; prefill: ``LM.prefill``; decode: ``LM.decode_step``) on meta,
     which counts its work; the count of the global program does not depend
     on the mesh, so it is made once per (arch, shape, variant) and reused
     for both meshes.  The traced optimizer updates each leaf whole
     (``update_slice``): on the card it works through a large leaf in
     slices to bound its float32 temporaries, which on meta only multiplies
     the ops to trace (DeepSeek-V3's Adafactor update: 215 s sliced, 0.2 s
     whole, on a host CPU); the products are the same (none) and so are the
     elementwise bytes, but for the slices' partial sums, which the count
     leaves out.

Each cell's record keeps the reference's keys where they have a
counterpart:

  * ``status`` (``ok``, ``skip`` or ``fail``), ``params``, ``active_params``;
  * ``resident``: per-device bytes of the parameters, the optimizer state
    and the cache under the rules' specs, exact (:func:`sharded_bytes_per_device`);
  * ``flops_per_device``: ``FlopCounterMode`` over the traced step (matrix
    products, FLOPs by its convention) plus the hand-written kernels' own
    work counted by their meta route (``kernels/meta.py``), over the
    mesh's devices; ``flops_global`` is the whole;
  * ``bytes_per_device``: the operand and result bytes of every aten op of
    the step (views and bare allocations left out) plus the kernels' own,
    over the devices.  It is an upper bound on HBM traffic: every op reads
    and writes its tensors in full, where fused code keeps some in
    registers, as the reference's CPU-HLO bytes over-count too;
  * ``collectives``: per-device bytes by kind and by mesh axis, from the
    plan below (there is no partitioned program to read them from);
  * ``trace_s`` and ``total_s`` (the reference's ``lower_s`` and
    ``total_s``).

The port counts every layer, since nothing is a ``lax.scan`` whose body
XLA's cost analysis counts once; so the reference's ``probe_configs``,
``extrapolate_costs`` and ``_seg_counts`` have no job here, and with no
HLO there is nothing for ``collective_bytes_from_hlo`` to parse.

The collective plan, the counterpart of what XLA's partitioner inserts.
Bytes are each collective's result bytes per device, by kind (as
``collective_bytes_from_hlo`` sums them) and by axis; ``wire_by_axis`` adds
what each device sends over each axis under ring algorithms on k devices
(all-gather and all-to-all (k-1)/k of the result, reduce-scatter (k-1) times
it, all-reduce 2(k-1)/k), which the roofline reads.  For a parameter leaf of
b bytes and e elements whose spec splits it over n devices in all, with
d, m and p the data, model and pod axis sizes:

  * train: a leaf sharded over "data" is all-gathered over "data" twice a
    step, in the forward and in the backward (result b*d/n each), and its
    gradient reduce-scattered over "data" (result b/n); any other leaf,
    when d > 1, has its gradient all-reduced over "data" (result b/n).
    When p > 1 each gradient is all-reduced over "pod" (result b/n); under
    ``--compression int8`` that becomes two all-gathers over "pod": p*e/n
    int8 bytes and the 4p bytes of the float32 scales.  At p = 2 the int8
    gather sends e/n bytes a device against the bf16 all-reduce's 2e/n
    (half; a quarter of a float32 all-reduce's), and from p = 4 on it sends
    as much or more: a gather grows with p, an all-reduce does not;
  * prefill and decode: a data-sharded leaf is all-gathered once a pass
    (result b*d/n);
  * activations over "model": each row-parallel projection (a leaf whose
    input dim is sharded over "model": the ``wo``s, ``cm_v``,
    ``proj_out``) all-reduces its output once a pass over "model", per
    device tokens x d_out x the activation's bytes; train makes 3 passes
    (forward, recompute, backward), prefill and decode 1; a Whisper
    encoder layer's tokens are its frames, and decode runs no encoder;
  * experts sharded over "model" (over model x data under ``train_ep``)
    make two all-to-alls a MoE layer a pass over those axes, of per-device
    tokens x top_k x d_model x the activation's bytes;
  * split-KV decode: a cache whose sequence dim is sharded over "model"
    all-reduces each attention layer's partial outputs and softmax
    statistics over "model": per-device rows x query heads x (value width
    + 2) float32 values (the value width is MLA's latent rank).

What the plan leaves out is listed in ROADMAP.md (the vocab-parallel
embedding and loss reductions, the sequence-parallel gathers, the int8
step's max-abs reduction inside a pod, the optimizer's own reductions).

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out dryrun_results.json
Variant flags (--remat/--dispatch/--xent-chunk/--compression/--opt/...) tag
the cell key, as the reference's do.  The reference's ``--seq-shard`` has
no counterpart: the port's models place no sequence-parallel activations,
and the plan does not model them (ROADMAP.md lists that gap), so a variant
without them would be priced the same as one with.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, get_config
from ..configs.shapes import SHAPES, ShapeSpec, cell_applicable
from ..data.synthetic import batch_specs
from ..kernels.meta import count_kernel_work
from ..models.transformer import LM, build_segments
from ..optim.optimizers import Adafactor, AdamW
from ..train.step import make_train_step
from ..tree import tree_flatten, tree_paths
from .mesh import make_production_mesh, mesh_axis_sizes, mesh_size
from .sharding import (
    PartitionSpec,
    _dp_for,
    cache_shardings,
    param_pspec,
    param_shardings,
    shard_count,
    tree_shardings,
)

__all__ = ["ADAFACTOR_ARCHS", "pick_optimizer", "input_specs", "make_cell_config",
           "build_cell", "trace_cell", "plan_collectives", "run_cell", "SkipCell",
           "sharded_bytes_per_device", "cell_key", "main"]

# Big configs use Adafactor (factored second moments) so optimizer state
# fits 16 GB/chip; everything else uses AdamW.
ADAFACTOR_ARCHS = {"deepseek-v3-671b", "command-r-plus-104b", "qwen2-vl-72b"}

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_VARIANT_DEFAULTS = (None, "none", 0, 1, "auto", "fsdp")


def pick_optimizer(arch: str, name: str = "auto"):
    if name == "adamw" or (name == "auto" and arch not in ADAFACTOR_ARCHS):
        return AdamW(lr=3e-4, state_dtype="bfloat16")
    return Adafactor(lr=1e-3)


def input_specs(cfg, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for every model input of this cell."""
    if shape.kind == "train":
        return batch_specs(cfg, shape.global_batch, shape.seq_len, mode="train")
    if shape.kind == "prefill":
        return batch_specs(cfg, shape.global_batch, shape.seq_len, mode="prefill")
    # decode: one new token against a seq_len cache
    B = shape.global_batch
    specs = {
        "tokens": torch.empty((B,), dtype=torch.int32, device="meta"),
        "pos": torch.empty((B,), dtype=torch.int32, device="meta"),
    }
    if cfg.needs_position_ids:
        specs["position_ids"] = torch.empty((3, B, 1), dtype=torch.int32, device="meta")
    return specs


def make_cell_config(arch: str, shape: ShapeSpec, *,
                     dispatch: Optional[str] = None, remat: str = "block",
                     xent_chunk: int = 0, kv_dtype: Optional[str] = None,
                     group_size: int = 0):
    overrides: Dict[str, Any] = {"dtype": "bfloat16"}
    if shape.kind == "train":
        overrides["remat"] = remat
        overrides["xent_chunk"] = xent_chunk
    if kv_dtype:
        overrides["kv_dtype"] = kv_dtype
    cfg = get_config(arch, **overrides)
    if cfg.moe is not None and (dispatch or group_size):
        moe_over = {}
        if dispatch:
            moe_over["dispatch"] = dispatch
        if group_size:
            moe_over["group_size"] = group_size
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
    return cfg


class SkipCell(Exception):
    pass


def _opt_state_shardings(opt_state, mesh, mode="train"):
    def spec_fn(path_str: str, shape, mesh):
        # m/v mirror the param tree: strip the state prefix and reuse rules
        stripped = re.sub(r"^(m|v)/", "", path_str)
        stripped = re.sub(r"/v$|/vr$|/vc$", "", stripped)
        if path_str.endswith(("/vr", "/vc")) or len(shape) == 0:
            return PartitionSpec()
        return param_pspec(stripped, shape, mesh, mode=mode)

    return tree_shardings(opt_state, mesh, spec_fn)


def sharded_bytes_per_device(shapes_tree, shardings_tree, mesh) -> float:
    """Sum of leaf bytes divided by the #devices each leaf is sharded over
    (replication across unused axes does NOT reduce per-device bytes)."""
    sizes = mesh_axis_sizes(mesh)
    total = 0.0
    shardings, _ = tree_flatten(shardings_tree)
    for leaf, sh in zip(tree_flatten(shapes_tree)[0], shardings):
        total += leaf.numel() * leaf.element_size() / shard_count(sh.spec, sizes)
    return float(total)


@dataclasses.dataclass
class _Cell:
    """A cell built on meta: everything but the mesh."""
    cfg: Any
    shape: ShapeSpec
    model: LM
    params: Any
    specs: Dict[str, torch.Tensor]
    opt_state: Any = None
    optimizer: Any = None
    caches: Any = None
    pmode: str = "train"


def build_cell(arch: str, shape_name: str, *,
               opt: str = "auto", dispatch: Optional[str] = None,
               remat: str = "block", xent_chunk: int = 0,
               compression: str = "none", microbatches: int = 1,
               infer_shard: str = "fsdp", kv_dtype: Optional[str] = None,
               group_size: int = 0, moe_shard: str = "fsdp",
               batch_override: int = 0, cfg=None) -> _Cell:
    """The model, parameters, optimizer state or caches and inputs of a
    cell, all on meta; raises :class:`SkipCell` for a cell the grid skips."""
    shape = SHAPES[shape_name]
    if batch_override:
        shape = dataclasses.replace(shape, global_batch=batch_override)
    if cfg is None:
        cfg = make_cell_config(arch, shape, dispatch=dispatch, remat=remat,
                               xent_chunk=xent_chunk, kv_dtype=kv_dtype,
                               group_size=group_size)
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        raise SkipCell(reason)
    model = LM(cfg, device="meta")
    params = model.init(torch.Generator())
    if shape.kind == "train":
        pmode = "train_ep" if moe_shard == "ep_full" else "train"
    else:
        pmode = "infer" if infer_shard == "tp" else "train"
    cell = _Cell(cfg, shape, model, params, input_specs(cfg, shape), pmode=pmode)
    if shape.kind == "train":
        cell.optimizer = pick_optimizer(arch, opt)
        cell.opt_state = cell.optimizer.init(params)
    else:
        cell.caches = model.init_cache(shape.global_batch, shape.seq_len)
    return cell


def cell_resident(cell: _Cell, mesh) -> Dict[str, float]:
    """Per-device bytes of the cell's parameters and optimizer state or
    cache, under the rules' specs on ``mesh``."""
    info = {"param_bytes_per_device": sharded_bytes_per_device(
        cell.params, param_shardings(cell.params, mesh, mode=cell.pmode), mesh)}
    if cell.opt_state is not None:
        info["opt_bytes_per_device"] = sharded_bytes_per_device(
            cell.opt_state, _opt_state_shardings(cell.opt_state, mesh, mode=cell.pmode), mesh)
    else:
        info["cache_bytes_per_device"] = sharded_bytes_per_device(
            cell.caches, cache_shardings(cell.caches, mesh), mesh)
    return info


_NO_TRAFFIC = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default}


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor operands and results,
    leaving out views (no data moves) and bare allocations."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        returns = func._schema.returns
        view = bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                     for r in returns)
        if not view and func not in _NO_TRAFFIC:
            for t in _pytree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def _step_fn(cell: _Cell, microbatches: int):
    model, shape = cell.model, cell.shape
    if shape.kind == "train":
        step = make_train_step(model, cell.optimizer, microbatches=microbatches,
                               update_slice=sys.maxsize)
        return lambda: step(cell.params, cell.opt_state, cell.specs)
    if shape.kind == "prefill":
        return lambda: model.prefill(cell.params, cell.specs, cell.caches)
    s = cell.specs
    return lambda: model.decode_step(cell.params, s["tokens"], s["pos"], cell.caches,
                                     s.get("position_ids"))


def trace_cell(cell: _Cell, microbatches: int = 1) -> Dict[str, Any]:
    """Run the cell's step once on meta and count its work: ``flops`` and
    ``bytes`` of the whole program (aten ops and kernels), the kernels'
    FLOPs and calls by kernel."""
    fn = _step_fn(cell, microbatches)
    flop_mode, bytes_mode = FlopCounterMode(display=False), _BytesMode()
    t0 = time.perf_counter()
    grad = torch.enable_grad() if cell.shape.kind == "train" else torch.no_grad()
    with grad, count_kernel_work() as kernels, flop_mode, bytes_mode:
        fn()
    return {"flops": int(flop_mode.get_total_flops()) + kernels.flops,
            "kernel_flops": kernels.flops, "bytes": bytes_mode.bytes + kernels.bytes,
            "kernel_calls": dict(kernels.calls), "trace_s": time.perf_counter() - t0}


# ------------------------------------------------------------- the plan --
def _wire(kind: str, k: int, result: float) -> float:
    if k <= 1:
        return 0.0
    if kind in ("all-gather", "all-to-all"):
        return (k - 1) / k * result
    if kind == "reduce-scatter":
        return (k - 1) * result
    return 2 * (k - 1) / k * result


class _Plan:
    def __init__(self, sizes: Dict[str, int]):
        self.sizes = sizes
        self.out: Dict[str, Any] = {k: {"bytes": 0.0, "count": 0} for k in _COLL_KINDS}
        self.by_axis: Dict[str, float] = {}
        self.wire_by_axis: Dict[str, float] = {}

    def add(self, kind: str, axes: Tuple[str, ...], result: float, count: int = 1) -> None:
        k = math.prod(self.sizes.get(a, 1) for a in axes)
        if k <= 1 or count <= 0:
            return
        label = "+".join(axes)
        self.out[kind]["bytes"] += result * count
        self.out[kind]["count"] += count
        self.by_axis[label] = self.by_axis.get(label, 0.0) + result * count
        self.wire_by_axis[label] = self.wire_by_axis.get(label, 0.0) + _wire(kind, k, result) * count

    def record(self) -> Dict[str, Any]:
        rec = dict(self.out)
        rec["total_bytes"] = sum(v["bytes"] for v in self.out.values())
        rec["by_axis"] = self.by_axis
        rec["wire_by_axis"] = self.wire_by_axis
        return rec


def plan_collectives(cell: _Cell, mesh, compression: str = "none") -> Dict[str, Any]:
    """The per-device collectives of a cell's step on ``mesh``, by the rules
    in the module docstring."""
    cfg, shape = cell.cfg, cell.shape
    sizes = mesh_axis_sizes(mesh)
    d, p = sizes.get("data", 1), sizes.get("pod", 1)
    plan = _Plan(sizes)
    kind = shape.kind
    B = shape.global_batch
    dp = _dp_for(B, mesh)
    b_pd = B // math.prod(sizes[a] for a in dp)
    tokens_pd = b_pd * (shape.seq_len if kind != "decode" else 1)
    passes = 3 if kind == "train" else 1
    act = torch.tensor([], dtype=getattr(torch, cfg.dtype)).element_size()
    seg_kinds = [seg.kind for seg in build_segments(cfg)]

    param_sh = param_shardings(cell.params, mesh, mode=cell.pmode)
    leaves = tree_flatten(cell.params)[0]
    for path, leaf, sh in zip(tree_paths(cell.params), leaves, tree_flatten(param_sh)[0]):
        spec, shp = sh.spec, tuple(leaf.shape)
        e, n = leaf.numel(), shard_count(sh.spec, sizes)
        b = e * leaf.element_size()
        data_sharded = any("data" in spec.axes(i) for i in range(len(spec)))
        if kind == "train":
            if data_sharded:
                plan.add("all-gather", ("data",), b * d / n, 2)
                plan.add("reduce-scatter", ("data",), b / n)
            else:
                plan.add("all-reduce", ("data",), b / n)
            if compression == "int8":
                plan.add("all-gather", ("pod",), p * e / n)
                plan.add("all-gather", ("pod",), 4 * p)
            else:
                plan.add("all-reduce", ("pod",), b / n)
        elif data_sharded:
            plan.add("all-gather", ("data",), b * d / n)

        nd = len(shp)
        m = re.match(r"segments/(\d+)/", path)
        seg = seg_kinds[int(m.group(1))] if m else None
        if seg == "enc" and kind == "decode":
            continue                                   # decode runs no encoder
        tok = b_pd * cfg.enc_len if seg == "enc" else tokens_pd
        if (nd >= 2 and "experts/" not in path and not path.startswith("embed/")
                and "model" in spec.axes(nd - 2)):
            plan.add("all-reduce", ("model",), tok * shp[-1] * act,
                     passes * math.prod(shp[:-2]))
        if path.endswith("experts/wi") and spec.axes(nd - 3):
            plan.add("all-to-all", spec.axes(nd - 3), tok * cfg.moe.top_k * cfg.d_model * act,
                     2 * passes * math.prod(shp[:-3]))

    if kind == "decode":
        cache_sh = cache_shardings(cell.caches, mesh)
        for path, leaf, sh in zip(tree_paths(cell.caches), tree_flatten(cell.caches)[0],
                                  tree_flatten(cache_sh)[0]):
            name = path.rsplit("/", 1)[-1]
            if name not in ("k", "ckv") or "model" not in sh.spec.axes(2):
                continue
            rows = leaf.shape[1] // math.prod(sizes[a] for a in sh.spec.axes(1))
            width = cfg.mla.kv_lora_rank if name == "ckv" else cfg.head_dim
            plan.add("all-reduce", ("model",), rows * cfg.n_heads * (width + 2) * 4,
                     leaf.shape[0])
    return plan.record()


# ------------------------------------------------------------- the cells --
def _variant_tag(variant: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in variant.items() if v not in _VARIANT_DEFAULTS}


def run_cell(arch: str, shape_name: str, mesh_kind: str, mesh=None,
             traces: Optional[Dict[Any, Any]] = None, **variant) -> Dict[str, Any]:
    """One cell's record on ``mesh`` (default: the production mesh of
    ``mesh_kind``, "single" or "multi").  ``traces`` caches the built cell
    and its count by (arch, shape, variant) across meshes."""
    t0 = time.perf_counter()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = mesh_size(mesh)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "chips": n_chips,
        "mesh_shape": mesh_axis_sizes(mesh), "variant": _variant_tag(variant),
    }
    traces = {} if traces is None else traces
    key = (arch, shape_name, tuple(sorted(variant.items(), key=lambda kv: kv[0])))
    try:
        if key not in traces:
            cell = build_cell(arch, shape_name, **variant)
            traces[key] = (cell, trace_cell(cell, variant.get("microbatches", 1)))
        cell, count = traces[key]
        rec.update({
            "status": "ok",
            "trace_s": count["trace_s"],
            "flops_global": count["flops"],
            "flops_per_device": count["flops"] / n_chips,
            "kernel_flops_global": count["kernel_flops"],
            "bytes_global": count["bytes"],
            "bytes_per_device": count["bytes"] / n_chips,
            "kernel_calls": count["kernel_calls"],
            "collectives": plan_collectives(cell, mesh, variant.get("compression", "none")),
            "params": cell.cfg.param_count(),
            "active_params": cell.cfg.active_param_count(),
            "resident": cell_resident(cell, mesh),
        })
    except SkipCell as e:
        rec.update({"status": "skip", "reason": str(e)})
    except Exception as e:  # a failure here is a bug in the system: recorded, not raised
        rec.update({"status": "fail", "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:]})
    rec["total_s"] = time.perf_counter() - t0
    return rec


def cell_key(arch, shape, mesh_kind, variant) -> str:
    tag = ",".join(f"{k}={v}" for k, v in sorted(variant.items())
                   if v not in _VARIANT_DEFAULTS)
    return f"{arch}|{shape}|{mesh_kind}" + (f"|{tag}" if tag else "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true", help="run the full grid")
    ap.add_argument("--out", default=None, help="incremental JSON results path")
    ap.add_argument("--opt", default="auto", choices=("auto", "adamw", "adafactor"))
    ap.add_argument("--dispatch", default=None, choices=(None, "einsum", "sort"))
    ap.add_argument("--remat", default="block", choices=("none", "block", "dots"))
    ap.add_argument("--xent-chunk", type=int, default=0)
    ap.add_argument("--compression", default="none", choices=("none", "int8"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--infer-shard", default="fsdp", choices=("fsdp", "tp"))
    ap.add_argument("--kv-dtype", default=None)
    ap.add_argument("--group-size", type=int, default=0)
    ap.add_argument("--moe-shard", default="fsdp", choices=("fsdp", "ep_full"))
    ap.add_argument("--batch-override", type=int, default=0)
    ap.add_argument("--force", action="store_true", help="recompute existing cells")
    args = ap.parse_args(argv)

    variant = dict(opt=args.opt, dispatch=args.dispatch, remat=args.remat,
                   xent_chunk=args.xent_chunk, compression=args.compression,
                   microbatches=args.microbatches, infer_shard=args.infer_shard,
                   kv_dtype=args.kv_dtype, group_size=args.group_size,
                   moe_shard=args.moe_shard, batch_override=args.batch_override)

    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        cells = [(arch, shape, mk) for arch in ARCHS for shape in SHAPES for mk in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("need --arch and --shape (or --all)")
        cells = [(args.arch, args.shape, mk) for mk in meshes]

    results: Dict[str, Any] = {}
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    failures = 0
    traces: Dict[Any, Any] = {}
    for arch, shape, mk in cells:
        key = cell_key(arch, shape, mk, variant)
        if key in results and results[key].get("status") == "ok" and not args.force:
            print(f"[cached] {key}")
            continue
        print(f"[dryrun] {key} ...", flush=True)
        rec = run_cell(arch, shape, mk, traces=traces, **variant)
        results[key] = rec
        status = rec["status"]
        extra = ""
        if status == "ok":
            extra = (f" flops/dev={rec['flops_per_device']:.3e}"
                     f" coll={rec['collectives']['total_bytes']:.3e}B"
                     f" trace={rec['trace_s']:.2f}s")
        elif status == "fail":
            failures += 1
            extra = " " + rec["error"]
        print(f"  -> {status}{extra}", flush=True)
        if args.out:
            tmp = args.out + ".tmp"
            with open(tmp, "w") as f:
                json.dump(results, f, indent=1, sort_keys=True)
            os.replace(tmp, args.out)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
