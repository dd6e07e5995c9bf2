"""Pipeline parallelism over a "stage" mesh axis (the GPipe schedule).

The counterpart of the JAX package's ``train/pipeline.py``.  On a two-pod
mesh the "pod" axis can carry pipeline stages instead of pure data
parallelism: the links between pods then carry only the (mb, S, d)
activation edge each tick instead of whole-gradient reductions.

The JAX version runs the schedule as one SPMD program under ``shard_map``:
every stage computes every tick, stage-0-only work (the embedding) and
last-stage-only work (the head and loss) are computed and masked, and
``jax.lax.ppermute`` moves the activations.  Here each stage is its own
process (one rank of the "stage" process group), so the schedule is a
branch on the rank, and a stage computes only on the ticks whose work
reaches the loss:

  * the layer-stacked parameters are split (L, ...) -> (P, L/P, ...) by
    :func:`split_stages`, and each rank holds its own stage's block
    ``(1, L/P, ...)``, the block ``shard_map`` gives it;
  * there are M + P - 1 ticks; stage s works on tick t when microbatch
    m = t - s exists (stage 0 embeds microbatch t, the last stage adds the
    loss of microbatch t - (P - 1));
  * after its work a stage sends its activations one stage down and
    receives the next tick's from the stage above, in one
    ``batch_isend_irecv`` (the ``ppermute``, an autograd function whose
    backward sends the gradients the other way); a tick with no work moves
    nothing, and the sends and receives still pair up tick by tick;
  * the loss is the sum of the M microbatch losses over the group, divided
    by M, on every rank.  Its backward does not sum again: each rank's
    share of the gradient is its own, so ``loss.backward()`` on every rank
    gives each the gradient of the one loss;
  * the embedding and head parameters are replicated.  The transpose of
    replication is a sum over the group, so their gradients are
    all-reduced over the stages: after the backward every rank holds the
    full gradient of both, as JAX returns it.  Those reductions are the last
    work of every rank's backward (their autograd nodes are the first made
    in the forward, so the engine runs them after everything else), so the
    ranks meet them in the same order.

A one-stage mesh (P = 1) needs no process group.  The bubble fraction is
(P - 1) / (M + P - 1); :func:`pipeline_efficiency` gives the rest.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..launch.mesh import mesh_axis_sizes
from ..tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["pipeline_loss_fn", "pipeline_efficiency", "split_stages"]

# the backward's messages carry tags of their own, apart from the forward's
_BACKWARD_TAG = 1 << 20


def pipeline_efficiency(n_micro: int, n_stages: int) -> float:
    """Fraction of non-bubble ticks in the GPipe schedule."""
    return n_micro / (n_micro + n_stages - 1)


def split_stages(stacked_params: Any, n_stages: int) -> Any:
    """(L, ...) layer-stacked params -> (P, L/P, ...)."""
    def re(x):
        L = x.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers not divisible into {n_stages} stages")
        return x.reshape((n_stages, L // n_stages) + tuple(x.shape[1:]))
    return tree_map(re, stacked_params)


class _Link:
    """Where a stage's activations go and come from: the "stage" group and
    the global ranks of the stages before and after this one."""

    def __init__(self, group, sid: int, n_stages: int):
        self.group, self.sid, self.n = group, sid, n_stages
        self.prev = dist.get_global_rank(group, sid - 1) if sid > 0 else None
        self.next = dist.get_global_rank(group, sid + 1) if sid < n_stages - 1 else None

    def exchange(self, send: Optional[torch.Tensor], send_to: Optional[int],
                 recv: Optional[torch.Tensor], recv_from: Optional[int], tag: int) -> None:
        ops = []
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send.contiguous(), send_to, self.group, tag))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv, recv_from, self.group, tag))
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _Shift(torch.autograd.Function):
    """The ``ppermute`` of one tick: sends ``y`` to the next stage (when
    ``send``) and returns what the previous stage sent (when ``recv``; an
    empty tensor otherwise).  Backward: the gradient of what was received
    goes back to the previous stage, and the gradient of ``y`` comes from
    the next one."""

    @staticmethod
    def forward(ctx, y, link: _Link, send: bool, recv: bool, like: torch.Tensor, tick: int):
        ctx.link, ctx.send, ctx.recv, ctx.tick = link, send, recv, tick
        ctx.y_meta = (y.shape, y.dtype, y.device)
        buf = torch.empty_like(like) if recv else like.new_empty(0)
        link.exchange(y if send else None, link.next, buf if recv else None, link.prev, tick)
        return buf

    @staticmethod
    def backward(ctx, grad):
        link = ctx.link
        shape, dtype, device = ctx.y_meta
        gy = torch.empty(shape, dtype=dtype, device=device) if ctx.send else None
        link.exchange(grad if ctx.recv else None, link.prev, gy, link.next,
                      _BACKWARD_TAG + ctx.tick)
        if gy is None:
            gy = torch.zeros(shape, dtype=dtype, device=device)
        return gy, None, None, None, None, None


class _Replicate(torch.autograd.Function):
    """Replicated parameters: the identity forward; the backward sums each
    gradient over the group (the transpose of replication)."""

    @staticmethod
    def forward(ctx, group, *leaves):
        ctx.group = group
        return tuple(x.view_as(x) for x in leaves)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g in grads:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None, *out)


class _LossShare(torch.autograd.Function):
    """The loss on every rank: the group's sum of the last stage's
    microbatch losses over ``count``.  Its backward hands this rank's sum
    ``grad / count``, with no second sum over the group, and zeros to the
    ``sinks`` (what this rank made that reaches the loss only through other
    ranks: its last send and its replicated parameters), so the backward
    reaches them."""

    @staticmethod
    def forward(ctx, loss_sum, count: int, group, *sinks):
        ctx.count = count
        ctx.sinks = [(s.shape, s.dtype, s.device) for s in sinks]
        total = loss_sum.detach().clone()
        if group is not None:
            dist.all_reduce(total, group=group)
        return total / count

    @staticmethod
    def backward(ctx, grad):
        zeros = [torch.zeros(shape, dtype=dt, device=dev) for shape, dt, dev in ctx.sinks]
        return (grad / ctx.count, None, None, *zeros)


def pipeline_loss_fn(
    mesh,
    block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    embed_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_fn: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor],
    *,
    axis: str = "stage",
) -> Callable:
    """Build ``loss(params, batch) -> scalar`` running the GPipe schedule on
    this rank's stage of ``mesh``'s ``axis``.

    params = {"stages": this rank's (1, L/P, ...) stacked block params,
              "embed":  embedding params   (replicated),
              "head":   head/loss params   (replicated)}
    batch  = {"tokens": (M, mb, S), "labels": (M, mb, S)}: M microbatches,
    the same on every rank.  Every rank of the group calls ``loss`` and
    then ``backward()`` on its result.
    """
    n_stages = mesh_axis_sizes(mesh)[axis]
    if n_stages > 1:
        group = mesh.get_group(axis)
        link = _Link(group, mesh.get_local_rank(axis), n_stages)
        sid = link.sid
    else:
        group, link, sid = None, None, 0

    def loss(params: Dict[str, Any], batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        tokens, labels = batch["tokens"], batch["labels"]
        M = tokens.shape[0]
        embed, head = params["embed"], params["head"]
        sinks: List[torch.Tensor] = []
        if group is not None:
            # made first, so the engine runs their backward (the sums) last
            e_leaves, e_struct = tree_flatten(embed)
            h_leaves, h_struct = tree_flatten(head)
            e_rep = _Replicate.apply(group, *e_leaves)
            h_rep = _Replicate.apply(group, *h_leaves)
            embed = tree_unflatten(e_struct, list(e_rep))
            head = tree_unflatten(h_struct, list(h_rep))
            sinks += list(e_rep) + list(h_rep)

        def stage_leaf(x):
            if x.shape[0] != 1:
                raise ValueError(f"a rank holds its own stage's (1, L/P, ...) block; got "
                                 f"leading dim {x.shape[0]}")
            return x[0]

        stage = tree_map(stage_leaf, params["stages"])
        leaves, struct = tree_flatten(stage)
        n_layers = leaves[0].shape[0]
        per_layer = [tree_unflatten(struct, [x[i] for x in leaves]) for i in range(n_layers)]

        with torch.no_grad():
            like = embed_fn(embed, tokens[0])
        anchor = like.new_zeros((), requires_grad=True) if link is not None else None
        loss_sum = torch.zeros((), dtype=torch.float32, device=like.device)
        buf: Optional[torch.Tensor] = None
        for t in range(M + n_stages - 1):
            work = sid <= t < sid + M
            y = None
            if work:
                m = t - sid
                x = embed_fn(embed, tokens[m]) if sid == 0 else buf
                for lp in per_layer:
                    x = block_fn(lp, x)
                y = x
                if sid == n_stages - 1:
                    loss_sum = loss_sum + loss_fn(head, y, labels[m]).to(torch.float32)
            send = work and sid < n_stages - 1
            recv = sid > 0 and sid <= t + 1 < sid + M
            if send or recv:
                out = _Shift.apply(y if send else anchor, link, send, recv, like, t)
                if recv:
                    buf = out
                else:
                    sinks.append(out)
        return _LossShare.apply(loss_sum, M, group, *sinks)

    return loss
