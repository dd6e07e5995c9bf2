"""Train-step factory.

The counterpart of the JAX package's ``train/step.py`` on one device:
gradients of ``model.loss`` by autograd, accumulated in float32 over
``microbatches`` (a Python loop in place of ``lax.scan``), then one
optimizer update.  The JAX step is pure and donates its buffers; here the
optimizer writes the new parameters and state into the old tensors in
place.  The int8-compressed cross-pod reduction needs a pod mesh and is
queued in ROADMAP.md (slice 6).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from ..models.transformer import LM
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
    loss, metrics = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return (loss.detach(), {key: val.detach() for key, val in metrics.items()},
            tree_unflatten(structure, grads))


def make_train_step(
    model: LM,
    optimizer: Optimizer,
    *,
    microbatches: int = 1,
    grad_compression: str = "none",
) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, with ``metrics["loss"]`` and ``metrics["grad_norm"]``
    (of the unclipped gradients), as the JAX step returns them."""
    if grad_compression == "int8":
        raise NotImplementedError(
            "int8 cross-pod gradient compression needs a pod mesh; it is queued "
            "in ROADMAP.md (slice 6)")
    if grad_compression != "none":
        raise ValueError(f"unknown grad_compression {grad_compression!r}")
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
        grads, loss, metrics = accumulate(params, batch)
        params, opt_state = optimizer.update(grads, opt_state, params)
        out = {"loss": loss, "grad_norm": global_norm(grads)}
        out.update(metrics)
        return params, opt_state, out

    return step


def make_eval_step(model: LM) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss(params, batch)
        return {"loss": loss, **metrics}
    return eval_step
