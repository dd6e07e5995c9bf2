"""Train-step factory.

The counterpart of the JAX package's ``train/step.py``: gradients of
``model.loss`` by autograd, accumulated in float32 over ``microbatches``
(a Python loop in place of ``lax.scan``), then one optimizer update.  The
JAX step is pure and donates its buffers; here the optimizer writes the new
parameters and state into the old tensors in place.

``grad_compression="int8"`` is the cross-pod step: one process a pod on a
mesh with a "pod" axis.  Each pod takes its share of the global batch,
computes its gradients, quantises each leaf to int8 with a float32 scale
and all-gathers both over the "pod" process group (one byte an element on
the slow links between pods), then dequantises, averages over the pods and
updates.  The JAX step runs this under ``shard_map``, manual over "pod" and
automatic over "data" and "model", which XLA partitions; here a process
holds whole parameters, so those two axes must have size 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..launch.mesh import axis_names, mesh_axis_sizes
from ..models.transformer import LM
from ..obs.runtime import span
from ..optim.compression import int8_quantize
from ..optim.optimizers import Optimizer, global_norm
from ..tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["TrainState", "value_and_grad", "make_train_step", "make_eval_step"]


@dataclass
class TrainState:
    """Parameters, optimizer state and step count, as the JAX package's
    ``TrainState`` holds them."""
    params: Any
    opt_state: Any
    step: int = 0


def _split_microbatches(batch: Dict[str, torch.Tensor], m: int):
    """``m`` microbatches split along the batch axis: axis 1 of M-RoPE
    ``position_ids`` (3, B, S), axis 0 of everything else.  (The JAX
    version splits a leaf along axis 0 whenever that axis divides by
    ``m``, so at m = 3 it cuts ``position_ids`` across its three streams;
    ROADMAP.md, "Known reference faults".)"""
    parts = {}
    for key, x in batch.items():
        axis = 1 if key == "position_ids" else 0
        if x.dim() < 2 or x.shape[axis] % m:
            raise ValueError(f"cannot split batch axis {axis} of {tuple(x.shape)} of "
                             f"{key!r} into {m}")
        parts[key] = x.chunk(m, dim=axis)
    return [{key: val[i] for key, val in parts.items()} for i in range(m)]


def value_and_grad(model: LM, params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """``(loss, metrics, grads)`` of ``model.loss`` at ``params``, with
    ``grads`` a tree like ``params`` in the parameters' dtypes (zeros for a
    leaf the loss does not reach).  Marks every leaf of ``params`` as
    requiring gradients."""
    leaves, structure = tree_flatten(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    with span("train.forward", device=model.device):
        loss, metrics = model.loss(params, batch)
    with span("train.backward", device=model.device):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return (loss.detach(), {key: val.detach() for key, val in metrics.items()},
            tree_unflatten(structure, grads))


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` from every rank of ``group`` stacked along a new leading axis."""
    n = dist.get_world_size(group)
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(-1).contiguous(), group=group)
    return out.reshape((n,) + tuple(x.shape))


def _cross_pod_int8_mean(grads, mesh, generator: Optional[torch.Generator] = None):
    """Quantise this pod's gradients, all-gather the int8 leaves and their
    scales over "pod", and return the dequantised mean over the pods, each
    leaf in its own dtype."""
    group = mesh.get_group("pod")
    npod = dist.get_world_size(group)

    def reduce_leaf(g):
        q, scale = int8_quantize(g, generator)
        qs = _all_gather(q, group)                          # (npod, ...)
        ss = _all_gather(scale.reshape(1), group)           # (npod, 1)
        deq = (qs.to(torch.float32) * ss.reshape((npod,) + (1,) * g.dim())).sum(0)
        return (deq / npod).to(g.dtype)

    return tree_map(reduce_leaf, grads)


def _pod_share(batch: Dict[str, torch.Tensor], npod: int, rank: int):
    """This pod's contiguous share of the global batch: along axis 1 of
    ``position_ids`` (3, B, S), axis 0 of everything else."""
    out = {}
    for key, x in batch.items():
        axis = 1 if key == "position_ids" else 0
        if x.shape[axis] % npod:
            raise ValueError(f"batch axis {axis} of {key!r} ({x.shape[axis]}) does not "
                             f"divide into {npod} pods")
        out[key] = x.chunk(npod, dim=axis)[rank]
    return out


def make_train_step(
    model: LM,
    optimizer: Optimizer,
    *,
    microbatches: int = 1,
    grad_compression: str = "none",
    mesh=None,
    update_slice: Optional[int] = None,
) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, with ``metrics["loss"]`` and ``metrics["grad_norm"]``
    (of the unclipped gradients), as the JAX step returns them.

    With ``grad_compression="int8"`` the step is ``step(params, opt_state,
    batch, rng=None)`` on a ``DeviceMesh`` with a "pod" axis (its "data"
    and "model" axes of size 1), called by every pod's process with the
    same parameters and the global batch; ``rng`` is a ``torch.Generator``
    for stochastic rounding, or None to round to nearest.  The loss is
    averaged over the pods.

    ``update_slice`` is passed to ``optimizer.update``: the elements of a
    leaf one slice of the update takes (None: the optimizer module's
    ``UPDATE_SLICE``)."""
    if grad_compression not in ("none", "int8"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")
    use_compression = grad_compression == "int8"
    if use_compression:
        if mesh is None or "pod" not in axis_names(mesh):
            raise ValueError("int8 grad compression needs a mesh with a 'pod' axis")
        sizes = mesh_axis_sizes(mesh)
        if any(sizes[a] != 1 for a in sizes if a != "pod"):
            raise ValueError(f"the int8 step runs one process a pod: every axis but "
                             f"'pod' must have size 1, got {sizes}")
        if not hasattr(mesh, "get_group"):
            raise ValueError("the int8 step needs a DeviceMesh (make_host_mesh), "
                             "not an abstract mesh")
    if microbatches < 1:
        raise ValueError("microbatches must be >= 1")

    def accumulate(params, batch):
        if microbatches == 1:
            loss, metrics, grads = value_and_grad(model, params, batch)
            return grads, loss, metrics
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        for mb in _split_microbatches(batch, microbatches):
            loss, _, g = value_and_grad(model, params, mb)
            tree_map(lambda a, b: a.add_(b.to(a.dtype)), acc, g)
            loss_sum = loss_sum + loss
        return tree_map(lambda a: a / microbatches, acc), loss_sum / microbatches, {}

    def step(params, opt_state, batch):
        with span("train.step"):
            grads, loss, metrics = accumulate(params, batch)
            with span("train.optimizer", device=model.device):
                params, opt_state = optimizer.update(grads, opt_state, params, update_slice)
            out = {"loss": loss, "grad_norm": global_norm(grads)}
            out.update(metrics)
        return params, opt_state, out

    if not use_compression:
        return step

    group = mesh.get_group("pod")
    npod, rank = dist.get_world_size(group), mesh.get_local_rank("pod")

    def compressed_step(params, opt_state, batch, rng: Optional[torch.Generator] = None):
        with span("train.step"):
            grads, loss, _ = accumulate(params, _pod_share(batch, npod, rank))
            grads = _cross_pod_int8_mean(grads, mesh, rng)
            loss = loss.to(torch.float32).clone()
            dist.all_reduce(loss, group=group)
            loss = loss / npod
            with span("train.optimizer", device=model.device):
                params, opt_state = optimizer.update(grads, opt_state, params, update_slice)
            out = {"loss": loss, "grad_norm": global_norm(grads)}
        return params, opt_state, out

    return compressed_step


def make_eval_step(model: LM) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss(params, batch)
        return {"loss": loss, **metrics}
    return eval_step
