"""AdamW and Adafactor over trees of tensors, with global-norm clipping.

The counterpart of the JAX package's ``optim/optimizers.py``: the same state
trees (AdamW's ``{"step", "m", "v"}``, ``m`` and ``v`` in the parameter
dtype unless ``state_dtype`` says otherwise; Adafactor's ``{"step", "v"}``,
a float32 ``{"vr", "vc"}`` or ``{"v"}`` for each parameter) and the same
order of operations, leaf by leaf in ``jax.tree.flatten`` order.  Where the
JAX update is pure and its train step donates the old buffers, ``update``
writes the new parameters and state into the old tensors in place, under
``torch.no_grad()``, and returns them.

Both work through each leaf in slices of at most ``UPDATE_SLICE`` elements,
so their float32 temporaries stay at a few slices rather than several
copies of the largest leaf: Qwen2-VL's 152064 x 8192 embedding is 5 GB in
float32, and one stacked expert leaf of Qwen1.5-MoE (24 x 60 x 2048 x 1408)
would be 16.6 GB.  AdamW is elementwise, so its slices along the first axis
give the same values, with the clip folded into each.  Adafactor's slices
run along the leading (stacked) axes, whole matrices at a time, or along
the rows of one matrix larger than a slice; its column means and its
update clip (by the RMS of the update over the whole leaf) span slices, so
it makes passes: the second-moment statistics, then the sum of the squared
update, then the update itself, recomputed slice by slice from the new
statistics.  Its sums run in another order than the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..models.layers import torch_dtype
from ..tree import flatten_up_to, tree_flatten, tree_leaves, tree_map

__all__ = ["Optimizer", "AdamW", "Adafactor", "clip_by_global_norm", "global_norm",
           "UPDATE_SLICE"]

# elements of a leaf one slice of an update takes (64 MB in float32)
UPDATE_SLICE = 1 << 24

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


def _sumsq(x: torch.Tensor) -> torch.Tensor:
    """The sum of the squares of ``x`` in float32, in slices along its first
    axis of at most ``UPDATE_SLICE`` elements, so no float32 copy of a large
    leaf is made (a leaf no larger than one slice sums whole)."""
    if x.dim() == 0 or x.numel() <= UPDATE_SLICE:
        return x.to(torch.float32).square().sum()
    rows = max(1, UPDATE_SLICE // max(1, x[0].numel()))
    return torch.stack([part.to(torch.float32).square().sum() for part in x.split(rows)]).sum()


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack([_sumsq(x) for x in tree_leaves(tree)]).sum())


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


@dataclass(frozen=True)
class Adafactor(Optimizer):
    """Adafactor (Shazeer & Stern '18) with factored second moments, no
    momentum and update clipping, as in the JAX package: ``beta2 = 1 -
    step^-decay``, a leaf of rank >= 2 whose last two axes both reach
    ``min_dim_size_to_factor`` keeps row and column statistics, any other
    a full second moment; no global-norm clip."""

    lr: Schedule = 1e-3
    decay: float = 0.8        # beta2_t = 1 - step^-decay
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    min_dim_size_to_factor: int = 128

    def _factored(self, p: torch.Tensor) -> bool:
        return (p.dim() >= 2 and p.shape[-1] >= self.min_dim_size_to_factor
                and p.shape[-2] >= self.min_dim_size_to_factor)

    def init(self, params) -> Dict[str, Any]:
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")

        def st(p):
            f32 = torch.float32
            if self._factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=f32, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=f32,
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=f32, device=p.device)}

        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "v": tree_map(st, params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        """One Adafactor step, written into ``params`` and ``state`` in
        place; returns them."""
        step = state["step"] + 1
        sf = step.to(torch.float32)
        beta2 = 1.0 - sf ** (-self.decay)
        scale = _lr_at(self.lr, step) * max(self.eps2, 1.0)
        leaves_p, structure = tree_flatten(params)
        for p, g, v in zip(leaves_p, flatten_up_to(structure, grads),
                           flatten_up_to(structure, state["v"])):
            if "vr" in v:
                self._update_factored(p, g, v, beta2, scale)
            else:
                self._update_full(p, g, v, beta2, scale)
        state["step"].copy_(step)
        return params, state

    def _apply(self, p, u, sumsq, n, scale):
        """The clipped update of one slice ``u``, written into ``p``: the
        clip by RMS(u) over the whole leaf (``sumsq`` over ``n`` elements)."""
        rms = torch.sqrt(sumsq / n + 1e-30)
        u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
        if self.weight_decay:
            u = u + self.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - scale * u)

    def _update_full(self, p, g, v, beta2, scale):
        vv = v["v"]
        if p.dim():
            rows = max(1, UPDATE_SLICE // max(1, p[0].numel()))
            slices = list(zip(p.split(rows), g.split(rows), vv.split(rows)))
        else:
            slices = [(p, g, vv)]

        def u_of(gs, vs):
            gf = gs.to(torch.float32)
            return gf * torch.rsqrt(torch.clamp(vs, min=self.eps1))

        sumsq = torch.zeros((), dtype=torch.float32, device=p.device)
        for _, gs, vs in slices:
            gf = gs.to(torch.float32)
            vs.copy_(beta2 * vs + (1 - beta2) * (gf * gf + self.eps1))
            sumsq += u_of(gs, vs).square().sum()
        for ps, gs, vs in slices:
            self._apply(ps, u_of(gs, vs), sumsq, max(1, p.numel()), scale)

    def _update_factored(self, p, g, v, beta2, scale):
        R, C = p.shape[-2:]
        p3, g3 = p.view(-1, R, C), g.reshape(-1, R, C)
        vr, vc = v["vr"].view(-1, R), v["vc"].view(-1, C)
        # (matrices, rows) of each slice: whole matrices while one fits a
        # slice, else row blocks of one matrix
        if R * C <= UPDATE_SLICE:
            m = UPDATE_SLICE // (R * C)
            chunks = [(slice(i, i + m), slice(None)) for i in range(0, p3.shape[0], m)]
        else:
            rows = max(1, UPDATE_SLICE // C)
            chunks = [(slice(i, i + 1), slice(r, r + rows))
                      for i in range(p3.shape[0]) for r in range(0, R, rows)]
        f32 = torch.float32
        colsum = torch.zeros(vc.shape, dtype=f32, device=p.device)
        for mi, ri in chunks:
            gf = g3[mi, ri].to(f32)
            g2 = gf * gf + self.eps1
            vr[mi, ri] = beta2 * vr[mi, ri] + (1 - beta2) * g2.mean(dim=-1)
            colsum[mi] += g2.sum(dim=-2)
        vc.copy_(beta2 * vc + (1 - beta2) * (colsum / R))
        r_all = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=self.eps1)

        def u_of(mi, ri):
            rc = r_all[mi, ri][..., None] * vc[mi][:, None, :]
            return g3[mi, ri].to(f32) * torch.rsqrt(torch.clamp(rc, min=self.eps1))

        sumsq = torch.zeros((), dtype=f32, device=p.device)
        for mi, ri in chunks:
            sumsq += u_of(mi, ri).square().sum()
        for mi, ri in chunks:
            self._apply(p3[mi, ri], u_of(mi, ri), sumsq, p.numel(), scale)
