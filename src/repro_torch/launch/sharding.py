"""Sharding rules: parameter, optimizer-state, batch and cache partition
specs, a copy of the JAX package's ``launch/sharding.py`` (the rule tables
verbatim).

Strategy:
  * "model" axis: tensor and expert parallelism (attention head
    projections, FFN hidden dims, the expert dim or, when E does not
    divide, the expert-FFN dim, the vocab dim of embeddings and heads, the
    cache's sequence dim for split-KV decode).
  * "data" axis: the batch, and ZeRO-3/FSDP sharding of any large
    parameter on its largest still-unsharded divisible dim.
  * "pod" axis: pure data parallelism across pods (the slow links carry
    only the gradient reduction, optionally int8-compressed).

Every rule checks divisibility and falls back to replication on that dim
(Whisper's vocab 51865 is odd, so its embedding shards d_model instead),
which keeps one rule set valid over the ten architectures, four shapes and
both meshes.

A spec is a :class:`PartitionSpec`: a tuple with one entry a tensor dim,
each ``None``, a mesh axis name, or a tuple of names for a dim sharded over
several axes, major first (a one-name tuple is stored as the name, as JAX
stores it).  It compares ``==`` with a JAX ``PartitionSpec`` of the same
entries.  A :class:`NamedSharding` pairs a spec with a mesh; on a
``DeviceMesh`` it also gives the DTensor ``placements``.  A leaf's path is
the ``"segments/0/attn/wq/w"`` string of :func:`repro_torch.tree.tree_paths`:
the port's parameter, optimizer and cache trees have the JAX trees' keys
and indices, so a leaf gets the same string, and the same spec, in both.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..tree import tree_map_with_path
from .mesh import axis_names, dp_axes, mesh_axis_sizes

__all__ = [
    "PartitionSpec",
    "NamedSharding",
    "param_pspec",
    "param_shardings",
    "batch_shardings",
    "cache_pspec",
    "cache_shardings",
    "tree_shardings",
    "replicated",
    "shard_count",
]

# (regex over the flattened param path, trailing-dims spec template).
# The template applies to the LAST len(template) dims; leading (scan-stack)
# dims are None.  "data" entries are FSDP hints; all entries are dropped when
# the dim is not divisible by the axis size.
_PARAM_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    # embeddings / head: shard vocab on model, d on data(FSDP)
    (r"embed/embedding$", ("model", "data")),
    (r"lm_head/w$", ("data", "model")),
    # MoE experts: (E, d, f) / (E, f, d) — expert parallelism on E,
    # FSDP on the middle dim
    (r"experts/wi$", ("model", "data", None)),
    (r"experts/wg$", ("model", "data", None)),
    (r"experts/wo$", ("model", None, "data")),
    (r"router/w$", (None, None)),
    (r"shared/wi/w$", ("data", "model")),
    (r"shared/wg/w$", ("data", "model")),
    (r"shared/wo/w$", ("model", "data")),
    # attention projections (column-parallel in, row-parallel out)
    (r"attn/wq/w$", ("data", "model")),
    (r"attn/wk/w$", ("data", "model")),
    (r"attn/wv/w$", ("data", "model")),
    (r"attn/wo/w$", ("model", "data")),
    (r"attn/w[qkv]/b$", ("model",)),
    (r"self_attn/w[qkv]/w$", ("data", "model")),
    (r"self_attn/wo/w$", ("model", "data")),
    (r"cross_attn/w[qkv]/w$", ("data", "model")),
    (r"cross_attn/wo/w$", ("model", "data")),
    # MLA
    (r"attn/wdq/w$", ("data", "model")),
    (r"attn/wuq/w$", (None, "model")),
    (r"attn/wdkv/w$", ("data", None)),
    (r"attn/wuk/w$", (None, "model")),
    (r"attn/wuv/w$", (None, "model")),
    # dense MLP
    (r"ffn/wi/w$", ("data", "model")),
    (r"ffn/wg/w$", ("data", "model")),
    (r"ffn/wo/w$", ("model", "data")),
    # RWKV6
    (r"block/w[rkvg]/w$", ("data", "model")),
    (r"block/wo/w$", ("model", "data")),
    (r"block/cm_k/w$", ("data", "model")),
    (r"block/cm_v/w$", ("model", "data")),
    (r"block/cm_r/w$", ("data", "model")),
    (r"block/w[AB]$", (None, None)),
    # RG-LRU
    (r"rec/proj_x/w$", ("data", "model")),
    (r"rec/proj_g/w$", ("data", "model")),
    (r"rec/proj_out/w$", ("model", "data")),
    (r"rec/conv$", (None, "model")),
    (r"rec/w[ax]$", ("model", None, None)),
]

FSDP_MIN_SIZE = 1 << 22   # 4M elements: smaller leaves stay replicated on "data"

# Inference ("weight-stationary") overrides: at decode, FSDP weight
# all-gathers repeat EVERY token step and dwarf the math (measured: 26 GB
# of f32 weight gathers per decode step on command-r-plus).  For serving,
# weights shard over "model" only; MoE experts move their second shard to
# the expert-FFN dim so cross-"data" traffic becomes activation-sized
# partial-sum reductions instead of weight gathers.
_INFER_RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    (r"embed/embedding$", ("model", None)),
    (r"lm_head/w$", (None, "model")),
    (r"experts/wi$", ("model", None, "data")),
    (r"experts/wg$", ("model", None, "data")),
    (r"experts/wo$", ("model", "data", None)),
    (r"router/w$", (None, None)),
    (r"shared/wi/w$", (None, "model")),
    (r"shared/wg/w$", (None, "model")),
    (r"shared/wo/w$", ("model", None)),
    (r"attn/w[qkv]/w$", (None, "model")),
    (r"attn/wo/w$", ("model", None)),
    (r"attn/w[qkv]/b$", ("model",)),
    (r"self_attn/w[qkv]/w$", (None, "model")),
    (r"self_attn/wo/w$", ("model", None)),
    (r"cross_attn/w[qkv]/w$", (None, "model")),
    (r"cross_attn/wo/w$", ("model", None)),
    (r"attn/wdq/w$", (None, "model")),
    (r"attn/wuq/w$", (None, "model")),
    (r"attn/wdkv/w$", (None, None)),
    (r"attn/wuk/w$", (None, "model")),
    (r"attn/wuv/w$", (None, "model")),
    (r"ffn/wi/w$", (None, "model")),
    (r"ffn/wg/w$", (None, "model")),
    (r"ffn/wo/w$", ("model", None)),
    (r"block/w[rkvg]/w$", (None, "model")),
    (r"block/wo/w$", ("model", None)),
    (r"block/cm_k/w$", (None, "model")),
    (r"block/cm_v/w$", ("model", None)),
    (r"block/cm_r/w$", (None, "model")),
    (r"block/w[AB]$", (None, None)),
    (r"rec/proj_x/w$", (None, "model")),
    (r"rec/proj_g/w$", (None, "model")),
    (r"rec/proj_out/w$", ("model", None)),
    (r"rec/conv$", (None, "model")),
    (r"rec/w[ax]$", ("model", None, None)),
]

# Fully-expert-sharded training mode ("train_ep"): the expert dim spans
# model x data (256 experts over 256 chips) — expert weights never move;
# routed tokens all-to-all to their expert's chip instead.  Activation-sized
# traffic replaces weight-sized FSDP gathers (hillclimb #2, EXPERIMENTS.md).
_EP_FULL_OVERRIDES: List[Tuple[str, Tuple[Any, ...]]] = [
    (r"experts/wi$", (("model", "data"), None, None)),
    (r"experts/wg$", (("model", "data"), None, None)),
    (r"experts/wo$", (("model", "data"), None, None)),
]


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None``, an axis name, or a tuple of names
    (major first).  A one-name tuple is stored as the name."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = e[0] if len(e) == 1 else (e or None)
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes that shard tensor dim ``dim``, major first."""
        e = self[dim] if dim < len(self) else None
        if e is None:
            return ()
        return e if isinstance(e, tuple) else (e,)


def shard_count(spec: PartitionSpec, sizes: Dict[str, int]) -> int:
    """The number of devices a leaf of ``spec`` is split over (replication
    across the other axes does not reduce a device's share)."""
    return math.prod(sizes[a] for i in range(len(spec)) for a in spec.axes(i))


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (an ``AbstractMesh`` or a ``DeviceMesh``)."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """The DTensor placements of the spec on a ``DeviceMesh``: one a
        mesh dim, ``Shard(i)`` where the axis shards tensor dim ``i``, else
        ``Replicate()``.  A dim sharded over several axes keeps JAX's order
        (the first axis major): an axis that comes before a more major one
        in the mesh's own order gets ``_StridedShard`` with that major
        part's size as its split factor, the layout ``distribute_tensor``
        then gives is the one JAX gives.  Nothing in the port places a
        DTensor yet: the tests use these placements, with
        ``distribute_tensor`` on a gloo mesh, to hold the layout to JAX's,
        and ``_StridedShard`` is a private PyTorch class."""
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.placement_types import _StridedShard

        names = axis_names(self.mesh)
        sizes = mesh_axis_sizes(self.mesh)
        out = []
        for a in names:
            place = Replicate()
            for i in range(len(self.spec)):
                axes = self.spec.axes(i)
                if a in axes:
                    j = axes.index(a)
                    split = math.prod(sizes[b] for b in axes[:j]
                                      if names.index(b) > names.index(a))
                    place = _StridedShard(i, split_factor=split) if split > 1 else Shard(i)
                    break
            out.append(place)
        return tuple(out)


def param_pspec(path_str: str, shape: Tuple[int, ...], mesh,
                mode: str = "train") -> PartitionSpec:
    sizes = mesh_axis_sizes(mesh)
    msize = sizes.get("model", 1)
    dsize = sizes.get("data", 1)
    nd = len(shape)

    if mode == "train_ep":
        for pat, tmpl in _EP_FULL_OVERRIDES:
            if re.search(pat, path_str):
                off = nd - len(tmpl)
                spec: List[Any] = [None] * nd
                if shape[off] % (msize * dsize) == 0:
                    spec[off] = ("model", "data")
                    return PartitionSpec(*spec)
                break
        mode = "train"

    rules = _PARAM_RULES if mode == "train" else _INFER_RULES
    template: Optional[Tuple[Optional[str], ...]] = None
    for pat, tmpl in rules:
        if re.search(pat, path_str):
            template = tmpl
            break
    spec = [None] * nd
    if template is not None and nd >= len(template):
        off = nd - len(template)
        for i, ax in enumerate(template):
            if ax is None:
                continue
            axsize = msize if ax == "model" else dsize
            if ax in spec:                       # axis already used
                continue
            if shape[off + i] % axsize == 0 and axsize > 1:
                spec[off + i] = ax

    # FSDP fallback (train only): big leaf with "data" unused -> shard the
    # largest divisible dim
    n_elem = math.prod(shape) if shape else 0
    if (mode == "train" and "data" not in spec and dsize > 1
            and n_elem >= FSDP_MIN_SIZE):
        order = sorted(range(nd), key=lambda i: -shape[i])
        for i in order:
            if spec[i] is None and shape[i] % dsize == 0:
                spec[i] = "data"
                break
    return PartitionSpec(*spec)


def tree_shardings(shapes: Any, mesh, spec_fn: Callable) -> Any:
    """A tree of :class:`NamedSharding` like ``shapes`` (tensors, meta or
    real): ``spec_fn(path, shape, mesh)`` for each leaf."""
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, spec_fn(path, tuple(leaf.shape), mesh)), shapes)


def param_shardings(params_shapes: Any, mesh, mode: str = "train") -> Any:
    """Tree of shardings matching a parameter tree."""
    return tree_shardings(params_shapes, mesh,
                          lambda path, shape, m: param_pspec(path, shape, m, mode))


def _dp_for(batch: int, mesh) -> Tuple[str, ...]:
    """Largest prefix of the dp axes that divides the batch."""
    axes = []
    prod = 1
    sizes = mesh_axis_sizes(mesh)
    for a in dp_axes(mesh):
        size = sizes[a]
        if batch % (prod * size) == 0:
            axes.append(a)
            prod *= size
    return tuple(axes)


def batch_shardings(specs: Dict[str, torch.Tensor], mesh) -> Dict[str, NamedSharding]:
    """Input-batch shardings: batch dim over ("pod", "data"), rest replicated."""
    out = {}
    for k, sds in specs.items():
        if k == "position_ids":            # (3, B, S)
            dp = _dp_for(sds.shape[1], mesh)
            spec = PartitionSpec(None, dp if dp else None)
        else:                               # (B, ...)
            dp = _dp_for(sds.shape[0], mesh)
            spec = PartitionSpec(dp if dp else None)
        out[k] = NamedSharding(mesh, spec)
    return out


def cache_pspec(path_str: str, shape: Tuple[int, ...], mesh) -> PartitionSpec:
    """Decode-cache sharding.

    KV caches (L, B, C, hk, hd): batch over dp axes, the *sequence* dim C
    over "model" — split-KV (sequence-parallel) decode, where partial
    softmax stats reduce over the model axis.  Recurrent states shard their
    width/head dims over "model" when divisible.
    """
    sizes = mesh_axis_sizes(mesh)
    msize = sizes.get("model", 1)
    nd = len(shape)
    spec: List[Any] = [None] * nd
    if nd >= 2:
        dp = _dp_for(shape[1], mesh)
        if dp:
            spec[1] = dp if len(dp) > 1 else dp[0]
    name = path_str.rsplit("/", 1)[-1]
    if name in ("k", "v", "ckv", "krope") and nd >= 3:
        if shape[2] % msize == 0 and msize > 1:
            spec[2] = "model"
    elif name == "pos" and nd >= 3:
        if shape[2] % msize == 0 and msize > 1:
            spec[2] = "model"
    elif name in ("S",):                    # rwkv state (L,B,H,N,N): shard N(k-dim)
        if nd >= 4 and shape[-2] % msize == 0 and msize > 1:
            spec[-2] = "model"
    elif name in ("h", "conv", "ts_tm", "ts_cm"):   # width-sharded recurrent state
        if shape[-1] % msize == 0 and msize > 1:
            spec[-1] = "model"
    return PartitionSpec(*spec)


def cache_shardings(cache_shapes: Any, mesh) -> Any:
    return tree_shardings(cache_shapes, mesh, cache_pspec)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
