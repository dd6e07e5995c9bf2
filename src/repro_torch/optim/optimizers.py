"""AdamW over trees of tensors, with global-norm clipping.

The counterpart of the JAX package's ``optim/optimizers.py``: the same state
tree (``{"step", "m", "v"}``, ``m`` and ``v`` in the parameter dtype unless
``state_dtype`` says otherwise) and the same order of operations, leaf by
leaf in ``jax.tree.flatten`` order.  Where the JAX update is pure and its
train step donates the old buffers, :meth:`AdamW.update` writes the new
parameters and state into the old tensors in place, under
``torch.no_grad()``, and returns them.  It works through each leaf in
slices along its first axis of at most ``UPDATE_SLICE`` elements (the
update is elementwise, so the values are the same) and folds the clip into
each slice, so its float32 temporaries stay at a few slices rather than
several copies of the largest leaf: Qwen2-VL's 152064 x 8192 embedding is
5 GB in float32.  Adafactor is queued in ROADMAP.md.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..models.layers import torch_dtype
from ..tree import tree_leaves, tree_map

__all__ = ["Optimizer", "AdamW", "clip_by_global_norm", "global_norm", "UPDATE_SLICE"]

# elements of a leaf one slice of the AdamW update takes (64 MB in float32)
UPDATE_SLICE = 1 << 24

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


def global_norm(tree) -> torch.Tensor:
    leaves = [x.to(torch.float32).square().sum() for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(leaves).sum())


def clip_by_global_norm(tree, max_norm: float) -> Tuple[Any, torch.Tensor]:
    n = global_norm(tree)
    scale = torch.clamp(max_norm / (n + 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), n


class Optimizer:
    """init(params) -> state;  update(grads, state, params) -> (params, state)."""

    def init(self, params) -> Dict[str, Any]:
        raise NotImplementedError

    def update(self, grads, state, params):
        raise NotImplementedError


@dataclass(frozen=True)
class AdamW(Optimizer):
    lr: Schedule = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    state_dtype: Optional[str] = None   # None = param dtype; "bfloat16" to halve state
    clip_norm: Optional[float] = 1.0

    def _sd(self, p: torch.Tensor) -> torch.dtype:
        return torch_dtype(self.state_dtype) if self.state_dtype else p.dtype

    def init(self, params) -> Dict[str, Any]:
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")

        def zeros(p):
            return torch.zeros(p.shape, dtype=self._sd(p), device=p.device)

        return {
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
        }

    @torch.no_grad()
    def update(self, grads, state, params):
        """One AdamW step, written into ``params`` and ``state`` in place;
        returns them."""
        scale = None
        if self.clip_norm is not None:   # clip_by_global_norm's scale, applied slice by slice
            scale = torch.clamp(self.clip_norm / (global_norm(grads) + 1e-9), max=1.0)
        step = state["step"] + 1
        lr = _lr_at(self.lr, step)
        sf = step.to(torch.float32)
        c1 = 1.0 - self.b1 ** sf
        c2 = 1.0 - self.b2 ** sf
        f32 = torch.float32
        for leaf in zip(tree_leaves(params), tree_leaves(grads),
                        tree_leaves(state["m"]), tree_leaves(state["v"])):
            if leaf[0].dim():
                rows = max(1, UPDATE_SLICE // max(1, leaf[0][0].numel()))
                slices = zip(*(t.split(rows) for t in leaf))
            else:
                slices = [leaf]
            for p, g, m, v in slices:
                gf = g.to(f32) if scale is None else (g.to(f32) * scale).to(g.dtype).to(f32)
                mf = self.b1 * m.to(f32) + (1 - self.b1) * gf
                vf = self.b2 * v.to(f32) + (1 - self.b2) * gf * gf
                u = (mf / c1) / (torch.sqrt(vf / c2) + self.eps)
                if self.weight_decay:
                    u = u + self.weight_decay * p.to(f32)
                p.copy_(p.to(f32) - lr * u)
                m.copy_(mf)
                v.copy_(vf)
        state["step"].copy_(step)
        return params, state
