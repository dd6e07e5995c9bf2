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
  * ``memory``: a device's bytes, the reference's ``memory_analysis()``
    keys (below, "Memory"): ``argument_size_in_bytes``,
    ``output_size_in_bytes``, ``alias_size_in_bytes`` and
    ``temp_size_in_bytes``; beside them ``peak_bytes``, ``fits`` (the peak
    within one H100's ``roofline.HBM_BYTES``) and ``peak_parts``, the peak's
    bytes by kind.  ``generated_code_size_in_bytes`` has no counterpart (no
    program is compiled) and is left out;
  * ``trace_s`` and ``total_s`` (the reference's ``lower_s`` and
    ``total_s``).

Memory.  The same pass traces the step's live bytes
(:class:`repro_torch.memtrace.LiveBytes`): every storage an aten op makes is
taken on, and taken off when freed, so the log holds the global program's
bytes op by op, the kernels' own buffers included (their meta route
allocates what their CUDA wrappers allocate).
The arguments (parameters, optimizer state or caches, inputs) are taken on
first.  Under a dispatch mode, and on meta tensors, autograd takes its
out-of-place paths for tensor subclasses; the tracker runs those ops in
place as a card runs them (``memtrace._as_on_the_card``), so the log is the
card's: ``tests/test_torch_memory.py`` holds it to the allocations of the
same step on the CPU with no tracker.  The optimizer's update is kept out
of the trace (:class:`TracedUpdate`; the trace updates each leaf whole) and
priced in the card's slices from a trace of two slices of each leaf
(:func:`update_temps`), on what the step holds when it starts.

A device's bytes come from the log by pricing each storage by what it is:
  * an argument by its spec on the mesh, exactly
    (:func:`sharded_bytes_per_device`, the batch's shardings for the
    inputs);
  * a tensor the step makes in a leaf's shape, a layer's part of it, or
    its transpose (gradients, an update's temporaries, a cast of a weight)
    by its leaf's spec; one in a cache leaf's shape (or a layer's) by the
    cache's;
  * anything else by the stream's shards: led by the batch (a multiple of
    B rows, B the microbatch's), over the batch's data-parallel devices;
    also over "model" under SP for a tensor that carries the sequence (a
    multiple of B x S rows, or S among its dims), and for the logits (last
    dim the vocab) where ``logits_sharding`` splits the vocab; routed
    experts' dispatched tokens (experts, then a multiple of B) also over
    the expert axis's shards of the expert weights; anything not led by the
    batch (masks, tables) is replicated;
  * plus the largest weight group gathered at once beyond a device's own
    shards (:func:`_gathered_weights`), twice in training.
On a one-device mesh every divisor is 1 and the peak is the global
program's.  The step's arguments, what it returns (weights and state
updated in place and the caches written in place alias their arguments, as
the reference donates them) and its peak give the reference's keys:
``temp_size_in_bytes`` is the peak less the arguments and the outputs that
alias none, as XLA counts temporaries.

The port counts every layer, since nothing is a ``lax.scan`` whose body
XLA's cost analysis counts once; so the reference's ``probe_configs``,
``extrapolate_costs`` and ``_seg_counts`` have no job here, and with no
HLO there is nothing for ``collective_bytes_from_hlo`` to parse.

The collective plan, the counterpart of what XLA's partitioner inserts,
held against the JAX dry-run's records in ``tests/test_torch_collectives*.py``
(dense, MoE, GQA, RWKV6, hybrid, MLA and Adafactor cells).
Bytes are each collective's result bytes per device, by kind (as
``collective_bytes_from_hlo`` sums them) and by axis; ``wire_by_axis`` adds
what each device sends over each axis under ring algorithms on k devices
(all-gather and all-to-all (k-1)/k of the result, reduce-scatter (k-1) times
it, all-reduce 2(k-1)/k, a collective-permute the result), which the
roofline reads; ``by_kind_axis`` splits ``by_axis`` by kind.  d, m and p are the data, model and pod axis sizes; T the
tokens a device holds in full (its batch rows times S, 1 at decode); X a
(T, width) activation's bytes; a train step makes two forward passes under
remat (the forward and the recompute) and one backward.

Weights, for a leaf of b bytes and e elements split over n devices:

  * train: a leaf sharded over "data" is all-gathered over "data" twice a
    step (result b*d/n each) and its gradient reduce-scattered (result
    b/n); any other leaf, when d > 1, has its gradient all-reduced over
    "data" (result b/n).  When p > 1 each gradient is all-reduced over
    "pod" (result b/n); under ``--compression int8`` that becomes the
    leaf's max-abs all-reduced over its own shards (4 bytes) and two
    all-gathers over "pod": p*e/n int8 bytes and the 4p bytes of the
    float32 scales.  At p = 2 the int8 gather sends e/n bytes a device
    against the bf16 all-reduce's 2e/n; from p = 4 on it sends as much or
    more.  Every leaf adds 4 bytes all-reduced over its shards (the global
    gradient norm);
  * prefill and decode: a data-sharded leaf is all-gathered once (b*d/n),
    but for two that stay where they are when moving activations costs
    fewer bytes, as XLA chooses: the routed experts (at decode every rank
    gathers nothing: the dispatched slots, E/m experts x the device's groups
    x capacity, are all-reduced over "data" after the dispatch (x d_model)
    and after the up projections' data-split contraction (x d_expert,
    twice), and the down projection's data-split outputs gathered (x
    d_model); at prefill the weights are gathered) and MLA's wuk at decode
    (below);
  * Adafactor (train): a factored leaf's row and column statistics (float32
    means over its last and second last dims) are partial sums over the
    axes that split the reduced dim, all-reduced there, then gathered whole
    over the leaf's other axes (the statistics are replicated); every leaf's
    update RMS adds 4 bytes all-reduced over its shards.

Activations over "model", where the projections are column-parallel (their
output dim sharded over "model": wq/wk/wv, wi/wg, the shared experts',
RWKV's, the RG-LRU's) or row-parallel (their input dim: the wo's, cm_v,
proj_out).  The stream is the model's ``act_sharding``: its sequence over
"model" (SP) for a train or prefill cell under ``seq_shard="sp"`` whose S
divides by m, as in the reference:

  * without SP: each row-parallel output is all-reduced each forward pass
    (X), and each group of column-parallel projections that reads one
    input all-reduces that input's gradient in the backward (X, once a
    group: the partial sums add up first);
  * under SP the step runs context-parallel, as XLA's partitioner runs it
    for these specs: the stream stays on its sequence shard; every leaf
    split over "model" (the embedding, attention, the MLPs, the router, the
    RWKV and RG-LRU blocks) is gathered whole each forward pass (the
    embedding once) and its gradient, a partial sum over the sequence
    shards, reduce-scattered over "model" before its data reduction; such a
    leaf not split over "model" (a norm's scale) has its gradient
    all-reduced.  Attention gathers K and V each forward pass and
    reduce-scatters their gradients, or, when fewer bytes, gathers the
    queries and reduce-scatters its partial outputs with their max and sum
    (T x heads x 4, twice), and in the backward gathers the outputs'
    gradient and both statistics and reduce-scatters the queries' gradient.
    MLA gathers K and V as XLA does, expanded by wuk and wuv (heads x
    (nope + v) and the shared rope key), the up projection of each token
    made once.  Routed experts gather the stream each forward pass (X) and
    reduce-scatter its gradient (X/m); their row-parallel outputs are
    reduce-scattered (X/m) and the outputs' gradients gathered (X); the
    stream norms' gradients are all-reduced;
  * the recurrent blocks under SP, as XLA reshards them (X = T x width x
    act, X32 its float32 size).  RWKV6: each of the two token shifts moves
    the normed stream off its sequence shard and back each forward pass
    (two all-to-alls of X/m); in the backward the shift is a one-token halo
    (collective-permute of rows x d).  In training (no state) the WKV scan
    runs whole on every rank: r, k, v (X each) and the float32 decay (X32)
    are gathered each forward pass and the outputs' gradient (X) in the
    backward.  At prefill the state's key dim is split over "model": r, k
    and the decay move to that shard (all-to-all, (2 X + X32)/m), v is
    gathered (X), and the outputs' partial sums over the key shards are
    all-reduced (X32; XLA reduces each step's).  RG-LRU in training: the
    causal conv and the scan run on a batch shard: the conv's input and
    output (X/m each) and the scan's input and states (X32/m each) move there
    and back each forward pass (all-to-all); in the backward the conv's
    halo, conv_width - 1 tokens, is exchanged.  RG-LRU at prefill runs on
    its state's width shard: proj_x and proj_g, gathered whole, run on the
    sequence shard and their outputs move to the width shard (X/m each);
    proj_out, row-parallel, reduce-scatters its partial sums (X/m).  The
    blocks' states are written from the shard they were computed on, the
    one their cache holds: nothing moves;
  * the vocab-parallel embedding (vocab over "model"), without SP: the
    partial rows are all-reduced into the stream (X); vocab-parallel
    logits (``logits_sharding`` vocab over "model"): under SP the hidden
    is gathered (X) and its f32 gradient reduce-scattered, else that
    gradient all-reduced; the loss
    all-reduces its max, sum of exponentials and gold logit (T x 4 bytes
    each) over "model" and its mean over the batch axes; under
    ``xent_chunk`` the backward recomputes each chunk's logits, so the
    hidden's gather and the three reductions come twice; a SP prefill
    gathers the last position's hidden;
  * MLA without SP: the query latent, split over "model" by wdq, is
    gathered for q_norm and wuq each forward pass and its gradient
    reduce-scattered; wuk and wuv, column-parallel from the replicated
    key-value latent, all-reduce its gradient; RWKV's channel-mix gate cm_r
    is gathered;
  * experts sharded over "model" alone, under einsum dispatch: every rank
    routes all the stream to its experts and the combine's partial sums
    reduce, like a column- then row-parallel MLP; sharded over data too
    (``train_ep``) or under sort dispatch: two all-to-alls a MoE layer a
    pass over those axes, of T x top_k x d_model x the activation's bytes;
  * the KV cache: at prefill K and V leave their projections sharded by
    head, and an all-to-all over "model" writes each rank's slots (an
    all-gather when the slots do not split; nothing under context
    parallelism, whose K and V are the rank's own slots, but for a ring
    cache shorter than the sequence, whose last window sits on the last
    sequence shard: each other rank receives the window's K and V of its
    own slots, a collective-permute of rows x C/m slots); at decode, with
    the slots split over "model", each attention layer gathers the query
    heads and the new token's K and V, and all-reduces its partial outputs
    and softmax statistics: rows x query heads x (value width + 2) float32
    values (the value width is MLA's latent rank).  MLA's absorbed decode
    gathers the queries' rope heads and the new token's latent and rope
    key, and keeps wuk on its data shard of the latent: every row's query
    heads are absorbed over each rank's latent slice (rows x heads x
    latent, gathered over "model" by head) and an all-to-all over "data"
    gives each row its whole latent query.

The hybrid's conv and gate weights act on their own "model" shard of the
RG-LRU's width and move no activation; their gradients reduce over "data"
as any unsharded leaf's.  Where these rules were read from the records'
HLO and what the plan leaves out: ROADMAP.md and ``tests/_jax_collectives.py``.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out dryrun_results.json
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --seq-shard none
Variant flags (--remat/--dispatch/--xent-chunk/--compression/--opt/--seq-shard
/...) tag the cell key, as the reference's do; as there, "sp" and "none" both
drop from the tag, so the two --seq-shard records of a cell share a key.  The
trace does not depend on --seq-shard (the shardings are the identity on meta
tensors): only the plan does.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import re
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, get_config
from ..configs.shapes import SHAPES, ShapeSpec, cell_applicable
from ..data.synthetic import batch_specs
from ..kernels.meta import count_kernel_work
from ..memtrace import LiveBytes
from ..models.transformer import LM, build_segments
from ..optim import optimizers
from ..optim.optimizers import Adafactor, AdamW, Optimizer
from ..train.step import make_train_step
from ..tree import tree_flatten, tree_paths
from .mesh import make_production_mesh, mesh_axis_sizes, mesh_size
from .roofline import HBM_BYTES
from .sharding import (
    NamedSharding,
    PartitionSpec,
    _dp_for,
    batch_shardings,
    cache_shardings,
    param_pspec,
    param_shardings,
    shard_count,
    tree_shardings,
)

__all__ = ["ADAFACTOR_ARCHS", "pick_optimizer", "input_specs", "make_cell_config",
           "build_cell", "model_shardings", "trace_cell",
           "plan_collectives", "run_cell", "SkipCell",
           "sharded_bytes_per_device", "cell_key", "main"]

# Big configs use Adafactor (factored second moments) to keep the optimizer
# state small; everything else uses AdamW.  With it their train_4k cells'
# traced peaks fit one H100 on both production meshes: DeepSeek-V3 53.03 /
# 33.89 GiB a device (single / multi), Command R+ 39.19 / 25.86, Qwen2-VL
# 23.89 / 14.56 (chip_smoke.py phase 14 (d), NVIDIA H100 80GB HBM3, 700.00 W).
ADAFACTOR_ARCHS = {"deepseek-v3-671b", "command-r-plus-104b", "qwen2-vl-72b"}

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# a variant's default values, left out of its tag; "sp" and "none" both, as
# in the reference, so a --seq-shard none record shares the sp record's key
_VARIANT_DEFAULTS = (None, "none", 0, 1, "auto", "fsdp", "sp")


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


def build_cell(arch: str, shape_name: Any, *,
               opt: str = "auto", dispatch: Optional[str] = None,
               remat: str = "block", xent_chunk: int = 0,
               compression: str = "none", microbatches: int = 1,
               infer_shard: str = "fsdp", kv_dtype: Optional[str] = None,
               group_size: int = 0, moe_shard: str = "fsdp",
               batch_override: int = 0, cfg=None) -> _Cell:
    """The model, parameters, optimizer state or caches and inputs of a
    cell, all on meta; raises :class:`SkipCell` for a cell the grid skips.
    ``shape_name`` names a shape of ``SHAPES`` or is a ``ShapeSpec``."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
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


class TracedUpdate(Optimizer):
    """``optimizer`` with its update kept out of ``live``'s trace: the
    update marks where it runs, gives the gradients it is handed their
    leaf's category, and pauses the trace, whose whole-leaf update
    (``update_slice``) would overstate the float32 temporaries of the
    card's slices; :func:`update_temps` prices those instead."""

    def __init__(self, optimizer: Optimizer, live: "LiveBytes"):
        self.optimizer, self.live = optimizer, live

    def init(self, params):
        return self.optimizer.init(params)

    def update(self, grads, state, params, update_slice: Optional[int] = None):
        live = self.live
        for i, g in enumerate(tree_flatten(grads)[0]):
            live.slot(g, ("leaf", i))
        live.update_at = len(live.ev_slot)
        live.paused = True
        try:
            return self.optimizer.update(grads, state, params, update_slice)
        finally:
            live.paused = False


def _cut_leaf(optimizer, shape: Tuple[int, ...], n: int) -> Tuple[Tuple[int, ...], int]:
    """``(shape, M / M_cut)``: the leaf traced for the update of a leaf of
    ``shape`` in slices of ``n`` elements, and the factor its per-matrix
    statistics scale by.  Adafactor's factored leaf is cut to two slices'
    matrices (two matrices when one spans slices); every other leaf (AdamW,
    a full second moment) to two slices along its first axis."""
    shape = tuple(shape)
    probe = torch.empty(shape, device="meta")
    if isinstance(optimizer, Adafactor) and optimizer._factored(probe):
        R, C = shape[-2:]
        M = math.prod(shape[:-2])
        keep = 2 * (n // (R * C)) if R * C <= n else 2
        return ((keep, R, C), M // keep) if M > keep else (shape, 1)
    if not shape:
        return shape, 1
    rows = max(1, n // max(1, math.prod(shape[1:])))
    return ((2 * rows,) + shape[1:], 1) if shape[0] > 2 * rows else (shape, 1)


def update_temps(optimizer, leaves) -> Dict[str, Any]:
    """The temporaries of ``optimizer.update`` over parameters shaped like
    ``leaves`` (tensors in leaf order), in the card's slices
    (``optimizers.UPDATE_SLICE``): a log of (leaf or -1, bytes) above the
    parameters, gradients and state, for :func:`cell_memory` to price.

    Each leaf is traced cut (:func:`_cut_leaf`): a slice's temporaries are
    freed before the next slice's are made, so two slices reach the peak of
    any number, but for Adafactor's statistics over every matrix of a
    stacked leaf (row and column sums, the normalised row statistics),
    two-dimensional with one row a matrix; their bytes are scaled by the
    leaf's matrices over the cut's."""
    return _update_log(optimizer, tuple((tuple(t.shape), t.dtype) for t in leaves),
                       optimizers.UPDATE_SLICE)


@functools.lru_cache(maxsize=None)
def _update_log(optimizer, shapes, n: int) -> Dict[str, Any]:
    cuts = [_cut_leaf(optimizer, shape, n) for shape, _ in shapes]
    with _disable_current_modes():
        params = [torch.empty(c, dtype=dt, device="meta") for (c, _), (_, dt) in
                  zip(cuts, shapes)]
        grads = [torch.empty_like(p) for p in params]
        state = optimizer.init(params)
        live = LiveBytes(inherit=True)
        with live:
            for i, (p, g) in enumerate(zip(params, grads)):
                live.slot(p, i)
                live.slot(g, i)
            for part in ("m", "v"):                     # each leaf's state
                for i, sub in enumerate(state.get(part, ())):
                    for t in tree_flatten(sub)[0]:
                        live.slot(t, i)
            for t in tree_flatten(state)[0]:            # the step count
                live.slot(t)
            start = len(live.ev_slot)
            optimizer.update(grads, state, params, None)
        live.close()
    log_leaf, log_bytes = [], []
    for s, b in zip(live.ev_slot[start:], live.ev_bytes[start:]):
        leaf, shape = live.slot_cat[s], live.slot_shape[s]
        scale = (cuts[leaf][1] if leaf is not None and len(shape) == 2
                 and shape[0] == cuts[leaf][0][0] and cuts[leaf][1] > 1 else 1)
        log_leaf.append(-1 if leaf is None else leaf)
        log_bytes.append(b * scale)
    return {"leaf": np.asarray(log_leaf, dtype=np.int64),
            "bytes": np.asarray(log_bytes, dtype=np.float64)}


def _step_fn(cell: _Cell, microbatches: int, live: LiveBytes):
    model, shape = cell.model, cell.shape
    if shape.kind == "train":
        step = make_train_step(model, TracedUpdate(cell.optimizer, live),
                               microbatches=microbatches, update_slice=sys.maxsize)
        return lambda: step(cell.params, cell.opt_state, cell.specs)
    if shape.kind == "prefill":
        return lambda: model.prefill(cell.params, cell.specs, cell.caches)
    s = cell.specs
    return lambda: model.decode_step(cell.params, s["tokens"], s["pos"], cell.caches,
                                     s.get("position_ids"))


def _arguments(cell: _Cell):
    """The step's argument trees, by category: parameters, optimizer state
    or caches, inputs."""
    args = [("param", cell.params)]
    args.append(("opt", cell.opt_state) if cell.opt_state is not None else ("cache", cell.caches))
    args.append(("input", cell.specs))
    return args


def trace_cell(cell: _Cell, microbatches: int = 1) -> Dict[str, Any]:
    """Run the cell's step once on meta and count its work: ``flops`` and
    ``bytes`` of the whole program (aten ops and kernels), the kernels'
    FLOPs and calls by kernel; and ``live``, the :class:`LiveBytes` log of
    the step, its arguments registered first and the slots of what it
    returns in ``out_slots``."""
    flop_mode, bytes_mode, live = FlopCounterMode(display=False), _BytesMode(), LiveBytes()
    fn = _step_fn(cell, microbatches, live)
    t0 = time.perf_counter()
    grad = torch.enable_grad() if cell.shape.kind == "train" else torch.no_grad()
    with grad, count_kernel_work() as kernels, flop_mode, bytes_mode, live:
        for kind, tree in _arguments(cell):
            for j, t in enumerate(tree_flatten(tree)[0]):
                live.slot(t, (kind, j))
        out = fn()
        out_slots = sorted({live.slot_of(t) for t in tree_flatten(out)[0]
                            if isinstance(t, torch.Tensor)} - {None})
        del out
    live.close()
    live.out_slots = out_slots
    return {"flops": int(flop_mode.get_total_flops()) + kernels.flops,
            "kernel_flops": kernels.flops, "bytes": bytes_mode.bytes + kernels.bytes,
            "kernel_calls": dict(kernels.calls), "live": live,
            "trace_s": time.perf_counter() - t0}


# ------------------------------------------------------------- the plan --
def _wire(kind: str, k: int, result: float) -> float:
    if k <= 1:
        return 0.0
    if kind in ("all-gather", "all-to-all"):
        return (k - 1) / k * result
    if kind == "reduce-scatter":
        return (k - 1) * result
    if kind == "collective-permute":
        return result
    return 2 * (k - 1) / k * result


class _Plan:
    def __init__(self, sizes: Dict[str, int]):
        self.sizes = sizes
        self.out: Dict[str, Any] = {k: {"bytes": 0.0, "count": 0} for k in _COLL_KINDS}
        self.by_axis: Dict[str, float] = {}
        self.wire_by_axis: Dict[str, float] = {}
        self.by_kind_axis: Dict[str, Dict[str, float]] = {}

    def add(self, kind: str, axes: Tuple[str, ...], result: float, count: int = 1) -> None:
        k = math.prod(self.sizes.get(a, 1) for a in axes)
        if k <= 1 or count <= 0:
            return
        label = "+".join(axes)
        self.out[kind]["bytes"] += result * count
        self.out[kind]["count"] += count
        self.by_axis[label] = self.by_axis.get(label, 0.0) + result * count
        per_kind = self.by_kind_axis.setdefault(kind, {})
        per_kind[label] = per_kind.get(label, 0.0) + result * count
        self.wire_by_axis[label] = self.wire_by_axis.get(label, 0.0) + _wire(kind, k, result) * count

    def record(self) -> Dict[str, Any]:
        rec = dict(self.out)
        rec["total_bytes"] = sum(v["bytes"] for v in self.out.values())
        rec["by_axis"] = self.by_axis
        rec["wire_by_axis"] = self.wire_by_axis
        rec["by_kind_axis"] = self.by_kind_axis
        return rec


_STREAM_NORMS = re.compile(r"(^|/)(norm1|norm2|norm_x|final_norm|enc_final_norm|ln1|ln2)/")


def model_shardings(cfg, shape: ShapeSpec, mesh, seq_shard: str = "sp",
                    compression: str = "none") -> Tuple[NamedSharding, NamedSharding]:
    """The stream's and the logits' shardings of a cell, as the reference's
    ``build_lowerable`` sets them: the (B, S, d) stream batch over the dp
    axes that divide B ("pod" left out under int8 compression, whose step
    runs one process a pod) and, for a train or prefill cell under ``sp``
    whose S divides by the model axis, its sequence over "model"; the (B, S,
    vocab) logits batch over dp and vocab over "model" when it divides."""
    if seq_shard not in ("sp", "none"):
        raise ValueError(f"unknown seq_shard {seq_shard!r}")
    m = mesh_axis_sizes(mesh)["model"]
    dp = _dp_for(shape.global_batch, mesh)
    if compression == "int8":
        dp = tuple(a for a in dp if a != "pod")
    seq = "model" if (shape.kind != "decode" and seq_shard == "sp"
                      and shape.seq_len % m == 0) else None
    vocab = "model" if cfg.vocab % m == 0 else None
    return (NamedSharding(mesh, PartitionSpec(dp or None, seq)),
            NamedSharding(mesh, PartitionSpec(dp or None, None, vocab)))


def _input_group(path: str, name: str) -> str:
    """Which input a column-parallel projection reads: projections of one
    group share it, so their input-gradient partial sums add up before one
    reduction.  (MLA's up-projections read the latents: planned apart.)"""
    if "cross_attn/" in path and name in ("wk", "wv"):
        return "enc"
    return "cm" if name in ("cm_k", "cm_r") else "in"


def plan_collectives(cell: _Cell, mesh, compression: str = "none",
                     seq_shard: str = "sp") -> Dict[str, Any]:
    """The per-device collectives of a cell's step on ``mesh``, by the rules
    in the module docstring, under the stream and logits shardings that
    :func:`model_shardings` gives the cell."""
    cfg, shape = cell.cfg, cell.shape
    act_sh, logits_sh = model_shardings(cfg, shape, mesh, seq_shard, compression)
    sizes = mesh_axis_sizes(mesh)
    d, p, m = sizes.get("data", 1), sizes.get("pod", 1), sizes.get("model", 1)
    plan = _Plan(sizes)
    kind = shape.kind
    train = kind == "train"
    B, S = shape.global_batch, shape.seq_len
    dp = _dp_for(B, mesh)
    b_pd = B // math.prod(sizes[a] for a in dp)
    rows = b_pd * (S if kind != "decode" else 1)
    act = torch.tensor([], dtype=getattr(torch, cfg.dtype)).element_size()
    lg = torch.tensor([], dtype=getattr(torch, cfg.logits_dtype)).element_size()
    # SP: the stream's sequence over "model", run context-parallel
    sp = "model" in act_sh.spec.axes(1)
    vocab_par = "model" in logits_sh.spec.axes(2)
    fwd = (2 if cfg.remat != "none" else 1) if train else 1   # forward (+ recompute)
    bwd = 1 if train else 0
    M = ("model",)
    seg_kinds = [seg.kind for seg in build_segments(cfg)]

    def stream_in(tok: float, width: int, count: int = 1) -> None:
        """A column-parallel group reads the (replicated or sequence-sharded)
        stream: SP gathers it each forward pass and reduce-scatters its
        gradient; without SP its gradient's partial sums are all-reduced."""
        full = tok * width * act
        if sp:
            plan.add("all-gather", M, full, fwd * count)
            plan.add("reduce-scatter", M, full / m, bwd * count)
        else:
            plan.add("all-reduce", M, full, bwd * count)

    def stream_out(tok: float, width: int, count: int = 1) -> None:
        """A row-parallel output's partial sums: reduce-scattered into the
        sequence-sharded stream under SP (its gradient gathered back), else
        all-reduced each forward pass."""
        full = tok * width * act
        if sp:
            plan.add("reduce-scatter", M, full / m, fwd * count)
            plan.add("all-gather", M, full, bwd * count)
        else:
            plan.add("all-reduce", M, full, fwd * count)

    adafactor = train and isinstance(cell.optimizer, Adafactor)

    def adafactor_stats(leaf, spec, shard_axes, n) -> None:
        """Adafactor's factored statistics of a leaf: the row means (over
        its last dim) are partial sums over the axes splitting that dim,
        all-reduced, then gathered whole over the rest (the statistics are
        replicated); the column means likewise over the second last dim;
        then the update's RMS over the leaf (4 bytes)."""
        if cell.optimizer._factored(leaf):
            for dim in (leaf.dim() - 1, leaf.dim() - 2):
                red = spec.axes(dim)
                rest = tuple(a for a in shard_axes if a not in red)
                k = math.prod(sizes[a] for a in red)
                full = leaf.numel() // leaf.shape[dim] * 4
                plan.add("all-reduce", red, full * k / n)
                plan.add("all-gather", rest, full)
        plan.add("all-reduce", shard_axes, 4)

    param_sh = param_shardings(cell.params, mesh, mode=cell.pmode)
    shared_tp = _shared_beside_routed(cfg, cell.params, param_sh)
    leaves = tree_flatten(cell.params)[0]
    groups: Dict[Tuple[str, str], Tuple[float, int, int]] = {}
    attn_mods: Dict[str, Dict[str, float]] = {}
    recurrent: list = []                      # (first projection, layers, width)
    moe_weights: Dict[str, Dict[str, Any]] = {}   # routed experts by segment
    for path, leaf, sh in zip(tree_paths(cell.params), leaves, tree_flatten(param_sh)[0]):
        spec, shp = sh.spec, tuple(leaf.shape)
        e, n = leaf.numel(), shard_count(sh.spec, sizes)
        if e == 0:
            continue                                   # a segment of no layers
        b = e * leaf.element_size()
        nd = len(shp)
        shard_axes = tuple(a for a in sizes for i in range(nd) if a in spec.axes(i))
        data_sharded = "data" in shard_axes
        gathered = b * (d if data_sharded else 1) / n      # after the data gathers
        # under SP a leaf on the context-parallel path meets the stream on
        # its sequence shard: gathered whole, its gradient a partial sum; an
        # RG-LRU with a state runs on the state's width shard, which only
        # its input projections leave from the sequence shard
        name = path.split("/")[-2] if path.endswith("/w") else path.split("/")[-1]
        cp_leaf = _cp_leaf(path, train, sp, shared_tp)
        if train:
            if data_sharded:
                plan.add("all-gather", ("data",), b * d / n, 2)
                plan.add("reduce-scatter", ("data",), b / n)
            else:
                plan.add("all-reduce", ("data",), b / n)
            if compression == "int8":
                # the leaf's max-abs over the pod's shards, then the gathers
                plan.add("all-reduce", tuple(a for a in shard_axes if a != "pod"), 4)
                plan.add("all-gather", ("pod",), p * e / n)
                plan.add("all-gather", ("pod",), 4 * p)
            else:
                plan.add("all-reduce", ("pod",), b / n)
            plan.add("all-reduce", shard_axes, 4)        # its share of the global norm
            if adafactor:
                adafactor_stats(leaf, spec, shard_axes, n)
            if cp_leaf and "model" in shard_axes:
                plan.add("reduce-scatter", M, gathered)  # before the data reduction
            elif cp_leaf or (sp and _STREAM_NORMS.search(path)):
                plan.add("all-reduce", M, b / n)         # applied to a sequence shard
        elif data_sharded and kind == "decode" and name == "wuk" and "data" in spec.axes(nd - 2):
            # MLA's absorbed decode keeps wuk on its data shard of the
            # latent: every row's query heads are absorbed over each rank's
            # slice of the latent (the rows gathered over "model" by head),
            # and an all-to-all over "data" gives each row its whole latent
            q_lat = rows * cfg.n_heads * cfg.mla.kv_lora_rank * act
            plan.add("all-gather", M, q_lat, math.prod(shp[:-2]))
            plan.add("all-to-all", ("data",), q_lat, math.prod(shp[:-2]))
        elif data_sharded and "experts/" in path:
            e_split = math.prod(sizes[a] for a in spec.axes(nd - 3))
            moe = moe_weights.setdefault(path.rsplit("/", 1)[0], {
                "layers": math.prod(shp[:-3]), "experts": shp[-3] // e_split, "gathers": []})
            moe["gathers"].append(b * d / n)
        elif data_sharded:
            plan.add("all-gather", ("data",), b * d / n)

        mt = re.match(r"segments/(\d+)/", path)
        seg = seg_kinds[int(mt.group(1))] if mt else None
        if seg == "enc" and kind == "decode":
            continue                                   # decode runs no encoder
        tok = b_pd * cfg.enc_len if seg == "enc" else rows
        if nd < 2 or path.startswith(("embed/", "lm_head/")):
            continue
        if sp and name in ("wr", "proj_x"):
            recurrent.append((name, math.prod(shp[:-2]), shp[-1]))
        if cp_leaf:
            # the stream stays on its sequence shard: a leaf split over
            # "model" is gathered whole each forward pass; attention's
            # widths are noted
            if "model" in shard_axes:
                plan.add("all-gather", M, gathered * m, fwd)
            mod = re.match(r"(.*(?:attn|self_attn|cross_attn))/(wq|wuq|wk|wv|wuk|wuv|wdkv|wo)/w$",
                           path)
            if mod:
                widths = attn_mods.setdefault(mod.group(1), {"count": math.prod(shp[:-2])})
                role = {"wuq": "q", "wdkv": "kv", "wk": "kv", "wv": "kv", "wuk": "kv",
                        "wuv": "kv"}.get(name, name[1:])
                width_tok = b_pd * cfg.enc_len if "cross_attn/" in path and role == "kv" else tok
                # MLA's keys and values: the heads wuk and wuv expand, and
                # the rope key wdkv leaves beside the latent
                width = (cfg.mla.qk_rope_head_dim if name == "wdkv"
                         else shp[-1 if role != "o" else -2])
                widths[role] = widths.get(role, 0) + width_tok * width
            continue
        if sp and shared_tp and "/shared/" in path:
            # the shared experts beside the routed ones read the stream
            # those gather, and the routed combine's output gradient: the
            # down projection's partial sums reduce each forward pass, and
            # each up projection's input gradient apart in the backward
            plan.add("reduce-scatter", M, tok * cfg.d_model * act / m,
                     (fwd if name == "wo" else bwd) * math.prod(shp[:-2]))
            continue
        if "experts/" in path:
            e_axes = spec.axes(nd - 3)
            if not path.endswith("experts/wi") or not e_axes:
                continue
            n_moe = math.prod(shp[:-3])
            if e_axes == M and (cfg.moe.dispatch or "einsum") == "einsum":
                # every model rank routes the whole stream to its own experts;
                # the combine's partial sums reduce like a row-parallel output
                stream_in(tok, cfg.d_model, n_moe)
                stream_out(tok, cfg.d_model, n_moe)
            else:
                plan.add("all-to-all", e_axes, tok * cfg.moe.top_k * cfg.d_model * act,
                         2 * (fwd + bwd) * n_moe)
            continue
        if not path.endswith("/w"):
            continue                                   # not a projection's matrix
        count = math.prod(shp[:-2])
        col = "model" in spec.axes(nd - 1) and "model" not in spec.axes(nd - 2)
        if "model" in spec.axes(nd - 2):
            stream_out(tok, shp[-1], count)
        elif col and name == "cm_r":
            # RWKV's channel-mix gate, sharded over "model" by its output,
            # gates the reduced stream: gathered each forward pass
            plan.add("all-gather", M, tok * shp[-1] * act, fwd * count)
            plan.add("reduce-scatter", M, tok * shp[-1] * act / m, bwd * count)
            groups[(path.rsplit("/", 2)[0], "cm")] = (tok, shp[-2], count)
        elif col and name == "wuq":
            # MLA: the query latent leaves wdq sharded over "model"; q_norm
            # and wuq read it whole: gathered each forward pass, its
            # gradient's partial sums reduce-scattered
            plan.add("all-gather", M, tok * shp[-2] * act, fwd * count)
            plan.add("reduce-scatter", M, tok * shp[-2] * act / m, bwd * count)
        elif col and name == "wuk":
            # MLA: wuk and wuv read the replicated key-value latent; their
            # input gradients' partial sums are all-reduced
            plan.add("all-reduce", M, tok * shp[-2] * act, bwd * count)
        elif col and name != "wuv" and not (kind == "decode" and "cross_attn/" in path
                                            and name != "wq"):
            group = _input_group(path, name)
            key = (path.rsplit("/", 2)[0], group)
            width_tok = b_pd * cfg.enc_len if group == "enc" else tok
            groups[key] = (width_tok, shp[-2], count)
    for tok, width, count in groups.values():
        stream_in(tok, width, count)
    for widths in attn_mods.values():
        # context-parallel attention: each rank's queries need every key;
        # gather K and V (MLA: the latent) each forward pass and
        # reduce-scatter their gradients, or, when the queries and the
        # partial outputs of each rank's keys move fewer bytes, gather the
        # queries and reduce-scatter the outputs with their max and sum, and
        # in the backward gather the outputs' gradient with the softmax
        # statistics and reduce-scatter the queries' gradient; MLA gathers
        # K and V, as XLA does
        q, o, kv, count = widths["q"], widths["o"], widths["kv"], widths["count"]
        stats = q / cfg.head_dim * 4
        if cfg.mla is not None or kv <= q + o / m:
            plan.add("all-gather", M, kv * act, fwd * count)
            plan.add("reduce-scatter", M, kv * act / m, bwd * count)
        else:
            plan.add("all-gather", M, q * act, fwd * count)
            plan.add("reduce-scatter", M, o * act / m, fwd * count)
            plan.add("all-reduce", M, stats, 2 * fwd * count)
            plan.add("all-gather", M, o * act, bwd * count)
            plan.add("all-gather", M, stats, 2 * bwd * count)
            plan.add("reduce-scatter", M, q * act / m, bwd * count)

    for first, count, width in recurrent:
        # the recurrent blocks on the sequence-sharded stream (XLA's
        # reshards, read from the records' HLO)
        x = rows * width * act                    # one (T, width) activation
        x32 = rows * width * 4
        if first == "wr":
            # RWKV6: each token shift (time and channel mix) moves the normed
            # stream off its sequence shard and back (two all-to-alls); in
            # the backward the shift is a one-token halo
            plan.add("all-to-all", M, x / m, 4 * fwd * count)
            plan.add("collective-permute", M, b_pd * width * act, 2 * bwd * count)
            if train:
                # no state: the scan runs whole on every rank; r, k, v and
                # the float32 decay are gathered each forward pass, the
                # output's gradient in the backward
                plan.add("all-gather", M, x, 3 * fwd * count)
                plan.add("all-gather", M, x32, fwd * count)
                plan.add("all-gather", M, x, bwd * count)
            else:
                # the state's key dim is split over "model": r, k and the
                # decay move to that shard, v is gathered whole, and the
                # outputs' partial sums over the key shards are all-reduced
                plan.add("all-to-all", M, (2 * x + x32) / m, count)
                plan.add("all-gather", M, x, count)
                plan.add("all-reduce", M, x32, count)
        elif train:
            # RG-LRU, no state: the causal conv and the scan run on a batch
            # shard; the conv's input and output (act) and the scan's input
            # and states (float32) move there and back each forward pass; in
            # the backward the conv's halo is exchanged
            plan.add("all-to-all", M, (x + x32) / m, 2 * fwd * count)
            plan.add("collective-permute", M,
                     b_pd * (cfg.recurrent.conv_width - 1) * width * act, bwd * count)
        else:
            # RG-LRU with a state: it runs on the state's width shard; proj_x's
            # and proj_g's outputs move there from the sequence shard
            # (proj_out, row-parallel, reduces its partial sums above)
            plan.add("all-to-all", M, x / m, 2 * count)
    for moe in moe_weights.values():
        # routed experts outside training: gather their data-sharded weights
        # or keep them and move the dispatched tokens, whichever moves fewer
        # bytes (XLA gathers at prefill and moves tokens at decode): the
        # dispatch's partial sums over the batch shards and the up
        # projections' over the data-split width are all-reduced, the down
        # projection's data-split outputs gathered
        mc, n_moe = cfg.moe, moe["layers"]
        tokens = B * (S if kind != "decode" else 1)
        s_grp = min(mc.group_size, tokens)
        n_grp, n_dp = tokens // s_grp, math.prod(sizes[a] for a in dp)
        cap = max(math.ceil(s_grp * mc.top_k * mc.capacity_factor / mc.n_experts), 1)
        # (expert, capacity) slots a device holds: its experts, its groups
        slots = moe["experts"] * (n_grp // n_dp if n_grp % n_dp == 0 else n_grp) * cap
        if slots * (2 * cfg.d_model + 2 * mc.d_expert) * act * n_moe < sum(moe["gathers"]):
            plan.add("all-reduce", ("data",), slots * cfg.d_model * act, n_moe)
            plan.add("all-reduce", ("data",), slots * mc.d_expert * act, 2 * n_moe)
            plan.add("all-gather", ("data",), slots * cfg.d_model * act, n_moe)
        else:
            for gather in moe["gathers"]:
                plan.add("all-gather", ("data",), gather)

    emb_sh = param_pspec("embed/embedding", (cfg.vocab, cfg.d_model), mesh, mode=cell.pmode)
    if sp and "model" in emb_sh.axes(0):
        # the lookup reads the table gathered whole over "model" (once:
        # outside any checkpoint); its gradient is reduce-scattered above
        n = shard_count(emb_sh, sizes)
        plan.add("all-gather", M, cfg.vocab * cfg.d_model * act
                 * (d if "data" in emb_sh.axes(1) else 1) * m / n)
    elif "model" in emb_sh.axes(0):
        # vocab-parallel lookup: each rank embeds the tokens in its vocab
        # shard; the partial rows are all-reduced into the stream
        plan.add("all-reduce", M, rows * cfg.d_model * act)
    if vocab_par:
        if train:
            full = rows * cfg.d_model
            # the chunked cross-entropy recomputes each chunk's logits, and
            # what they need, in the backward
            nc = cfg.xent_chunk
            lg_fwd = 2 if nc and nc > 1 and S % nc == 0 else 1
            if sp:                                     # the hidden gathered for the logits
                plan.add("all-gather", M, full * act, lg_fwd)
                plan.add("reduce-scatter", M, full * lg / m)
            else:
                plan.add("all-reduce", M, full * lg)
            # the vocab-parallel loss: max, sum of exponentials, gold logit
            plan.add("all-reduce", M, rows * 4, 3 * lg_fwd)
        elif kind == "prefill" and sp:
            plan.add("all-gather", M, b_pd * cfg.d_model * act)   # the last position
    if train:
        plan.add("all-reduce", dp, 4)                  # the loss's mean over the batch

    if kind != "train":
        cache_sh = cache_shardings(cell.caches, mesh)
        for path, leaf, sh in zip(tree_paths(cell.caches), tree_flatten(cell.caches)[0],
                                  tree_flatten(cache_sh)[0]):
            name = path.rsplit("/", 1)[-1]
            split = "model" in sh.spec.axes(2) if leaf.dim() > 2 else False
            L = leaf.shape[0]
            if kind == "prefill" and name in ("k", "v") and m > 1 and not (sp and split):
                # K and V leave their projections sharded by head (by
                # sequence under context parallelism, which writes a split
                # cache in place); the cache holds a sequence shard of every
                # head (all-to-all) or, when its slots do not split, every
                # slot of every head (all-gather)
                cross = "cross" in path
                written = b_pd * (cfg.enc_len if cross else min(S, leaf.shape[2]))
                full = written * math.prod(leaf.shape[3:]) * leaf.element_size()
                plan.add("all-to-all" if split else "all-gather", M, full / m if split else full,
                         L)
            elif (kind == "prefill" and name in ("k", "v") and split and leaf.shape[2] < S
                  and "cross" not in path):
                # a ring cache under context parallelism: the last window's
                # K and V sit on the last sequence shard, and the other ranks
                # receive those of their own slots
                plan.add("collective-permute", M, b_pd * leaf.shape[2] // m
                         * math.prod(leaf.shape[3:]) * leaf.element_size(), L)
            if kind == "decode" and name in ("k", "ckv") and split:
                # split-KV decode: every rank reads all query heads over its
                # slots; the partial outputs and softmax statistics reduce
                r = leaf.shape[1] // math.prod(sizes[a] for a in sh.spec.axes(1))
                width = cfg.mla.kv_lora_rank if name == "ckv" else cfg.head_dim
                if name == "k":
                    # the query heads, and the new token's K and V for the
                    # rank whose slots take it
                    plan.add("all-gather", M, r * cfg.n_heads * cfg.head_dim * act, L)
                    plan.add("all-gather", M, r * math.prod(leaf.shape[3:])
                             * leaf.element_size(), 2 * L)
                else:
                    # MLA: the query heads' rope part (the latent part is
                    # wuk's, above), and the new token's latent and rope key
                    mla = cfg.mla
                    plan.add("all-gather", M, r * cfg.n_heads * mla.qk_rope_head_dim * act, L)
                    plan.add("all-gather", M, r * (mla.kv_lora_rank + mla.qk_rope_head_dim)
                             * leaf.element_size(), L)
                plan.add("all-reduce", M, r * cfg.n_heads * (width + 2) * 4, L)
    return plan.record()


# ----------------------------------------------------------- the memory --
def _stacked_dims(path: str) -> int:
    """Leading layer axes of a parameter or cache leaf: two for a hybrid
    group's RG-LRU blocks (groups, blocks), one for any other segment's."""
    if not path.startswith("segments/"):
        return 0
    return 2 if re.match(r"segments/\d+/rec/", path) else 1


def _shared_beside_routed(cfg, params, param_sh) -> bool:
    """Whether the shared experts run tensor-parallel beside routed experts
    sharded over "model" alone under einsum dispatch: on the stream those
    gather, as XLA's partitioner runs them (the records' HLO reduces the
    shared down projection's partial sums and the combine's over "model"
    in one all-reduce of two (T, d) elements, each a dot of its own)."""
    if cfg.moe is None or (cfg.moe.dispatch or "einsum") != "einsum":
        return False
    return any(path.endswith("experts/wi") and sh.spec.axes(leaf.dim() - 3) == ("model",)
               for path, leaf, sh in zip(tree_paths(params), tree_flatten(params)[0],
                                         tree_flatten(param_sh)[0]))


def _cp_leaf(path: str, train: bool, sp: bool, shared_tp: bool = False) -> bool:
    """Whether a leaf is on the context-parallel path under SP: it meets
    the stream on its sequence shard (not the routed experts, the shared
    experts beside them (``shared_tp``), the untied head, nor an RG-LRU
    with a state, which runs on the state's width shard past its input
    projections)."""
    name = path.split("/")[-2] if path.endswith("/w") else path.split("/")[-1]
    on_width = "/rec/rec/" in path and not train and name not in ("proj_x", "proj_g")
    beside = shared_tp and "/shared/" in path
    return sp and not (on_width or beside or "experts/" in path or path.startswith("lm_head/"))


def _gathered_weights(cell: _Cell, mesh, sp: bool) -> float:
    """A device's bytes of the largest weight group live gathered at once,
    beyond its own shards: a layer's leaves (a hybrid group's block), the
    table or the head, each gathered as :func:`plan_collectives` prices it
    (over "data" when split there, and whole over "model" on the
    context-parallel path); in training twice that, for the gradient before
    its reduce-scatter."""
    sizes = mesh_axis_sizes(mesh)
    d, m = sizes.get("data", 1), sizes.get("model", 1)
    train = cell.shape.kind == "train"
    groups: Dict[str, float] = {}
    param_sh = param_shardings(cell.params, mesh, mode=cell.pmode)
    shardings = tree_flatten(param_sh)[0]
    shared_tp = _shared_beside_routed(cell.cfg, cell.params, param_sh)
    for path, leaf, sh in zip(tree_paths(cell.params), tree_flatten(cell.params)[0],
                              shardings):
        n = shard_count(sh.spec, sizes)
        axes = {a for i in range(leaf.dim()) for a in sh.spec.axes(i)}
        b = leaf.numel() * leaf.element_size()
        full = b * (d if "data" in axes else 1) * (
            m if "model" in axes and _cp_leaf(path, train, sp, shared_tp) else 1) / n
        k = _stacked_dims(path)
        group = "/".join(path.split("/")[:3 if k == 2 else 2]) if k else path.split("/")[0]
        groups[group] = groups.get(group, 0.0) + (full - b / n) / math.prod(leaf.shape[:k])
    return max(groups.values(), default=0.0) * (2 if train else 1)


def _slot_kinds(cell: _Cell, live: LiveBytes, microbatches: int) -> List[Any]:
    """The category of each slot of a cell's live-bytes log: its argument
    or leaf, else by its shape (module docstring, "Memory")."""
    B, S, V = cell.shape.global_batch // microbatches, cell.shape.seq_len, cell.cfg.vocab
    E = cell.cfg.moe.n_experts if cell.cfg.moe is not None else 0
    like: Dict[Tuple[int, ...], Any] = {}
    trees = [("leaf", cell.params)] + ([("cacheleaf", cell.caches)] if cell.caches else [])
    for kind, tree in trees:
        for j, (path, leaf) in enumerate(zip(tree_paths(tree), tree_flatten(tree)[0])):
            shape = tuple(leaf.shape)
            for cut in range(_stacked_dims(path) + 1):
                like.setdefault(shape[cut:], (kind, j))
                if len(shape) - cut == 2:
                    like.setdefault(shape[cut:][::-1], (kind, j))
    kinds = []
    for shape, cat in zip(live.slot_shape, live.slot_cat):
        if cat is None:
            cat = like.get(shape)
        if cat is None:
            while shape[:1] == (1,) and len(shape) > 1:     # unsqueezed
                shape = shape[1:]
            rows = bool(shape) and shape[0] % B == 0        # batch-led (rows, tokens, heads)
            if (E and len(shape) >= 2 and shape[0] == E and shape[1] % B == 0):
                cat = "experts"                              # expert-major dispatched tokens
            elif rows and len(shape) >= 2 and shape[-1] == V:
                cat = "logits"
            elif rows and (shape[0] % (B * S) == 0 or S in shape[1:]):
                cat = "seq"
            else:
                cat = "act" if rows else "rep"
        kinds.append(cat)
    return kinds


def _divisors(cell: _Cell, mesh, seq_shard: str) -> Dict[Any, int]:
    """The devices each category of bytes is split over on ``mesh``."""
    sizes = mesh_axis_sizes(mesh)
    act_sh, logits_sh = model_shardings(cell.cfg, cell.shape, mesh, seq_shard)
    dp = math.prod(sizes[a] for a in _dp_for(cell.shape.global_batch, mesh))
    m = sizes.get("model", 1)
    param_sh = param_shardings(cell.params, mesh, mode=cell.pmode)
    dp_axes = _dp_for(cell.shape.global_batch, mesh)
    # the routed experts' axis is split as their weights' is
    e_split = next((math.prod(sizes[a] for a in sh.spec.axes(len(leaf.shape) - 3)
                              if a not in dp_axes)
                    for path, leaf, sh in zip(tree_paths(cell.params), tree_flatten(cell.params)[0],
                                              tree_flatten(param_sh)[0])
                    if path.endswith("experts/wi")), 1)
    out: Dict[Any, int] = {"rep": 1, "act": dp, "experts": dp * e_split,
                           "seq": dp * (m if "model" in act_sh.spec.axes(1) else 1),
                           "logits": dp * (m if "model" in logits_sh.spec.axes(2) else 1)}
    trees = {"param": param_sh, "input": batch_shardings(cell.specs, mesh)}
    if cell.opt_state is not None:
        trees["opt"] = _opt_state_shardings(cell.opt_state, mesh, mode=cell.pmode)
    else:
        trees["cache"] = cache_shardings(cell.caches, mesh)
    for kind, tree in trees.items():
        for j, sh in enumerate(tree_flatten(tree)[0]):
            out[(kind, j)] = shard_count(sh.spec, sizes)
            if kind in ("param", "cache"):
                out[("leaf" if kind == "param" else "cacheleaf", j)] = out[(kind, j)]
    return out


def cell_memory(cell: _Cell, count: Dict[str, Any], mesh, seq_shard: str = "sp",
                microbatches: int = 1) -> Dict[str, Any]:
    """A device's memory on ``mesh`` from the cell's traced live bytes
    (module docstring, "Memory"): the reference's argument, output, alias
    and temporary bytes, the peak, whether it fits one card, and the
    peak's parts."""
    live = count["live"]
    div = _divisors(cell, mesh, seq_shard)
    kinds = _slot_kinds(cell, live, microbatches)
    slot_div = np.asarray([div[k] for k in kinds], dtype=np.float64)
    names = ("arguments", "leaves", "stream", "activations")
    group = {"param": 0, "opt": 0, "cache": 0, "input": 0, "leaf": 1, "seq": 2}
    slot_group = np.asarray([group.get(k[0] if isinstance(k, tuple) else k, 3) for k in kinds])
    ev_slot = np.asarray(live.ev_slot, dtype=np.int64)
    price = np.asarray(live.ev_bytes, dtype=np.float64) / slot_div[ev_slot]
    by_group = np.stack([np.cumsum(np.where(slot_group[ev_slot] == g, price, 0.0))
                         for g in range(len(names))])
    total = by_group.sum(axis=0)
    at = int(np.argmax(total))
    parts = dict(zip(names, by_group[:, at].tolist()))
    parts["update"] = 0.0
    peak = float(total[at])
    if live.update_at is not None:
        # the update's temporaries, in the card's slices, on what the step
        # holds when it starts
        upd = update_temps(cell.optimizer, tree_flatten(cell.params)[0])
        leaf_div = np.asarray([div[("leaf", j)] for j in
                               range(len(tree_flatten(cell.params)[0]))] + [1], dtype=np.float64)
        temps = float(np.cumsum(upd["bytes"] / leaf_div[upd["leaf"]]).max(initial=0.0))
        at_update = by_group[:, live.update_at - 1]
        if float(at_update.sum()) + temps > peak:
            peak = float(at_update.sum()) + temps
            parts = dict(zip(names, at_update.tolist()))
            parts["update"] = temps
    parts["gathered"] = _gathered_weights(cell, mesh, "model" in model_shardings(
        cell.cfg, cell.shape, mesh, seq_shard)[0].spec.axes(1))
    peak += parts["gathered"]
    argument = sum(live.slot_bytes[s] / slot_div[s] for s, k in enumerate(kinds)
                   if isinstance(k, tuple) and k[0] in ("param", "opt", "cache", "input"))
    output = alias = 0.0
    for s in live.out_slots:
        b = live.slot_bytes[s] / slot_div[s]
        output += b
        if isinstance(kinds[s], tuple) and kinds[s][0] in ("param", "opt", "cache"):
            alias += b
    return {"argument_size_in_bytes": int(round(argument)),
            "output_size_in_bytes": int(round(output)),
            "alias_size_in_bytes": int(round(alias)),
            "temp_size_in_bytes": int(round(peak - argument - (output - alias))),
            "peak_bytes": int(round(peak)), "fits": bool(peak <= HBM_BYTES),
            "peak_parts": {k: int(round(v)) for k, v in parts.items()}}


# ------------------------------------------------------------- the cells --
def _variant_tag(variant: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in variant.items() if v not in _VARIANT_DEFAULTS}


def run_cell(arch: str, shape_name: str, mesh_kind: str, mesh=None,
             traces: Optional[Dict[Any, Any]] = None, **variant) -> Dict[str, Any]:
    """One cell's record on ``mesh`` (default: the production mesh of
    ``mesh_kind``, "single" or "multi").  ``traces`` caches the built cell
    and its count by (arch, shape, variant) across meshes and across
    ``seq_shard``, which changes the plan only."""
    t0 = time.perf_counter()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = mesh_size(mesh)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "chips": n_chips,
        "mesh_shape": mesh_axis_sizes(mesh), "variant": _variant_tag(variant),
    }
    traces = {} if traces is None else traces
    build = {k: v for k, v in variant.items() if k != "seq_shard"}
    key = (arch, shape_name, tuple(sorted(build.items(), key=lambda kv: kv[0])))
    try:
        if key not in traces:
            cell = build_cell(arch, shape_name, **build)
            traces[key] = (cell, trace_cell(cell, variant.get("microbatches", 1)))
        cell, count = traces[key]
        seq_shard = variant.get("seq_shard", "sp")
        rec.update({
            "status": "ok",
            "trace_s": count["trace_s"],
            "flops_global": count["flops"],
            "flops_per_device": count["flops"] / n_chips,
            "kernel_flops_global": count["kernel_flops"],
            "bytes_global": count["bytes"],
            "bytes_per_device": count["bytes"] / n_chips,
            "kernel_calls": count["kernel_calls"],
            "collectives": plan_collectives(cell, mesh, variant.get("compression", "none"),
                                            variant.get("seq_shard", "sp")),
            "params": cell.cfg.param_count(),
            "active_params": cell.cfg.active_param_count(),
            "resident": cell_resident(cell, mesh),
            "memory": cell_memory(cell, count, mesh, seq_shard, variant.get("microbatches", 1)),
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
    ap.add_argument("--seq-shard", default="sp", choices=("sp", "none"),
                    help="sequence parallelism: the stream's sequence over 'model'")
    ap.add_argument("--batch-override", type=int, default=0)
    ap.add_argument("--force", action="store_true", help="recompute existing cells")
    args = ap.parse_args(argv)

    variant = dict(opt=args.opt, dispatch=args.dispatch, remat=args.remat,
                   xent_chunk=args.xent_chunk, compression=args.compression,
                   microbatches=args.microbatches, infer_shard=args.infer_shard,
                   kv_dtype=args.kv_dtype, group_size=args.group_size,
                   moe_shard=args.moe_shard, seq_shard=args.seq_shard,
                   batch_override=args.batch_override)

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
        cached = results.get(key, {})
        # an ok record written before records carried ``memory`` is run again
        if cached.get("status") == "ok" and "memory" in cached and not args.force:
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
