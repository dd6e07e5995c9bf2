"""Model assembly: one ``LM`` for every family of the JAX package.

The counterpart of the JAX package's ``models/transformer.py``.  The model
is a sequence of segments, each a homogeneous stack of blocks whose
parameters and states are stacked over a leading layer axis, as in the JAX
package; a Python loop over layers takes the place of ``lax.scan``.

The families: ``dense`` and ``vlm`` (one ``"attn"`` segment of GQA + MLP
blocks, trained, and served with a KV cache; ``vlm`` rotates q and k by
M-RoPE when ``position_ids`` are given, RoPE otherwise), the ``ssm``
family (one ``"rwkv"`` segment of RWKV6 blocks, served and trained), the
``moe`` family (an optional segment of ``n_dense_layers`` dense blocks,
then a ``moe=True`` segment whose blocks take a mixture of experts for
their MLP; attention GQA or MLA; served, and its auxiliary load-balance
loss flows through ``LM.loss``), the ``hybrid`` family (RecurrentGemma:
``"group"`` segments of ``n_rec`` RG-LRU blocks, then a local-attention
block when ``has_attn``; for 38 layers, (rec, rec, attn) x 12 then (rec,
rec) x 1; served) and the ``audio`` family (Whisper: an ``"enc"`` segment
of non-causal attention blocks over the frame embeddings, run once by
:meth:`LM.encode`, then a ``"dec"`` segment of blocks with causal
self-attention, cross-attention to the encoder's output and an MLP; the
decoder's cross cache is written at prefill and read at each decode step).
Activation checkpointing: without caches (training), ``remat="block"``
recomputes each layer (a ``group`` segment: each group) in the backward
pass, the unit the JAX model checkpoints (its ``lax.scan`` body), through
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``; ``"dots"``
keeps the results of the products with no batch axis (``aten.mm`` and
``aten.addmm``: the dense projections and the router), as JAX's
``dots_with_no_batch_dims_saveable`` does, and recomputes the rest (the
experts' batched products, attention).  The layer returns its own MoE
auxiliary loss, so a recompute adds nothing to the sum.  Either way the
attention kernel's forward runs twice a layer a step.

``act_sharding`` and ``logits_sharding`` (a ``launch.sharding.NamedSharding``
each, None by default) constrain the stream and the logits where the JAX
model does: a DTensor is redistributed to the spec, a plain tensor left as
it is.

Parameters are plain dictionaries of tensors laid out like the JAX
``LM.init`` pytree, so :func:`repro_torch.models.convert.params_from_jax`
loads JAX weights as they are.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import dataclasses
import functools
import gc

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..kernels import counts
from ..obs.runtime import span
from .attention import (AttnFn, DecodeFn, gqa_apply, gqa_init, make_cache, make_mla_cache,
                        mla_apply, mla_init)
from .config import ModelConfig
from .layers import (embed_init, head_product, head_route, mlp_apply, mlp_init, norm_apply,
                     norm_init, torch_dtype)
from .moe import moe_apply, moe_init
from .recurrent import (MixFn, rglru_apply, rglru_init, rglru_state, rwkv6_apply, rwkv6_init,
                        rwkv6_state)

__all__ = ["Segment", "LM", "DecodeGraph", "build_segments", "sinusoidal_embed",
           "MOE_AUX_WEIGHT"]

MOE_AUX_WEIGHT = 0.01

# the ops whose results remat="dots" keeps: products with no batch axis
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


@dataclass(frozen=True)
class Segment:
    kind: str                     # "attn" | "rwkv" | "group" | "enc" | "dec"
    n: int                        # layers, or groups for "group"
    moe: bool = False             # a mixture of experts for the MLP ("attn")
    window: Optional[int] = None  # local-attention window ("attn", "group")
    n_rec: int = 0                # recurrent blocks per group ("group")
    has_attn: bool = True         # the group ends in an attention block ("group")


def build_segments(cfg: ModelConfig) -> List[Segment]:
    if cfg.family in ("dense", "vlm"):
        return [Segment("attn", cfg.n_layers, window=cfg.attn_window)]
    if cfg.family == "moe":
        m, w = cfg.moe, cfg.attn_window
        segs = [Segment("attn", m.n_dense_layers, window=w)] if m.n_dense_layers else []
        return segs + [Segment("attn", cfg.n_layers - m.n_dense_layers, moe=True, window=w)]
    if cfg.family == "ssm" and cfg.recurrent is not None and cfg.recurrent.kind == "rwkv6":
        return [Segment("rwkv", cfg.n_layers)]
    if cfg.family == "hybrid" and cfg.recurrent is not None and cfg.recurrent.kind == "rglru":
        pat, w = cfg.recurrent.pattern, cfg.attn_window
        n_rec = sum(1 for kind in pat if kind == "rec")
        groups, tail = divmod(cfg.n_layers, len(pat))
        segs = [Segment("group", groups, window=w, n_rec=n_rec, has_attn="attn" in pat)]
        if tail:
            segs.append(Segment("group", 1, window=w, n_rec=tail, has_attn=False))
        return segs
    if cfg.family == "audio":
        return [Segment("enc", cfg.n_layers), Segment("dec", cfg.n_layers)]
    raise ValueError(f"unknown family {cfg.family!r}")


def sinusoidal_embed(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """(..., S) int -> (..., S, dim) float32 sinusoidal embedding."""
    half = dim // 2
    f32 = torch.float32
    freq = torch.exp(-np.log(10000.0) * torch.arange(half, dtype=f32, device=positions.device)
                     / half)
    ang = positions.to(f32)[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _constrain(x: torch.Tensor, sharding) -> torch.Tensor:
    """``jax.lax.with_sharding_constraint``'s counterpart: a DTensor is
    redistributed to ``sharding``'s placements (a ``launch.sharding.
    NamedSharding`` on a ``DeviceMesh``); any other tensor, which one device
    holds whole, is returned as it is, as the constraint leaves an array on
    one device.  ``sharding`` None constrains nothing."""
    if sharding is None:
        return x
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(sharding.mesh, sharding.placements)
    return x


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a layer-stacked dictionary of tensors (views, no copy)."""
    if isinstance(tree, dict):
        return {key: _layer(val, i) for key, val in tree.items()}
    return tree[i]


def _unstack(tree: Any, n: int) -> List[Any]:
    """The ``n`` layers of a layer-stacked dictionary of tensors, split with
    one ``unbind`` per leaf, so autograd gathers each leaf's gradient in
    one stack rather than one full-size scatter per layer."""
    if isinstance(tree, dict):
        per_key = {key: _unstack(val, n) for key, val in tree.items()}
        return [{key: val[i] for key, val in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


class LM:
    """Language model over ``ModelConfig``, on one device.

    Public surface (mirrors the JAX ``LM``):
      init(generator) -> params
      loss(params, batch) -> (scalar, metrics)           [training]
      init_cache(batch, capacity) -> caches
      encode(params, frames) -> encoder output           [audio]
      backbone(params, tokens, positions=None, caches=None, position_ids=None,
               enc_out=None, enc_positions=None) -> (hidden, caches, aux)
      logits(params, hidden) -> logits
      prefill(params, batch, caches) -> (last-token logits, caches)
      decode_step(params, tokens, pos, caches, position_ids=None) -> (logits, caches)

    A batch holds ``tokens`` (B,S) and, for training, ``labels`` (B,S);
    an ``audio`` model's also ``frames`` (B, enc_len, d_model), and a
    ``vlm`` model's may hold M-RoPE ``position_ids`` (3, B, S).

    Caches are updated in place and returned, where the JAX model returns
    new arrays (its engine donates the old ones).  ``mix_fn`` replaces the
    WKV recurrence in every RWKV6 block, ``attn_fn`` the attention kernel
    and ``decode_fn`` the decode kernel of every GQA block, to hold the
    kernels' path against the plain versions on the card.
    """

    def __init__(self, cfg: ModelConfig, device: Optional[Union[str, torch.device]] = "cuda",
                 mix_fn: Optional[MixFn] = None, attn_fn: Optional[AttnFn] = None,
                 decode_fn: Optional[DecodeFn] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.segments = build_segments(cfg)
        self.mix_fn = mix_fn
        self.attn_fn = attn_fn
        self.decode_fn = decode_fn
        # Optional NamedShardings on a DeviceMesh (``launch.dryrun.
        # model_shardings`` gives the reference's), as the JAX model's: the
        # (B, S, d) activation stream's, applied to the embedding output,
        # the encoder's input and after every layer (a hybrid group); and
        # the (B, S, vocab) logits'.
        self.act_sharding = None
        self.logits_sharding = None
        # claims each expert computed on the dropless route, (MoE layers, E) on
        # the device, added to in place by every prefill and decode step (a
        # captured step's replays too; training counts none): read it as a
        # difference between two points
        moe_layers = sum(seg.n for seg in self.segments if seg.moe)
        self.expert_load = (torch.zeros((moe_layers, cfg.moe.n_experts), dtype=torch.int64,
                                        device=self.device)
                            if moe_layers and cfg.moe.dispatch == "dropless" else None)

    def _wsc(self, x: torch.Tensor) -> torch.Tensor:
        return _constrain(x, self.act_sharding)

    # ------------------------------------------------------------------ init --
    def _block_init(self, gen: torch.Generator, seg: Segment) -> Dict:
        cfg, dev, n = self.cfg, self.device, seg.n
        if seg.kind == "rwkv":
            return {"block": rwkv6_init(gen, cfg, n, dev)}
        if seg.kind == "group":
            lead = (n, seg.n_rec)
            p = {"rec": {
                "norm1": norm_init(cfg, dev, layers=lead),
                "rec": rglru_init(gen, cfg, dev, layers=lead),
                "norm2": norm_init(cfg, dev, layers=lead),
                "ffn": mlp_init(gen, cfg, dev, layers=lead),
            }}
            if seg.has_attn:
                p["attn"] = {
                    "norm1": norm_init(cfg, dev, layers=n),
                    "norm2": norm_init(cfg, dev, layers=n),
                    "attn": gqa_init(gen, cfg, dev, layers=n),
                    "ffn": mlp_init(gen, cfg, dev, layers=n),
                }
            return p
        if seg.kind == "dec":
            return {
                "norm1": norm_init(cfg, dev, layers=n),
                "self_attn": gqa_init(gen, cfg, dev, layers=n),
                "norm_x": norm_init(cfg, dev, layers=n),
                "cross_attn": gqa_init(gen, cfg, dev, layers=n, cross=True),
                "norm2": norm_init(cfg, dev, layers=n),
                "ffn": mlp_init(gen, cfg, dev, layers=n),
            }
        attn = mla_init if cfg.attention == "mla" else gqa_init
        return {
            "norm1": norm_init(cfg, dev, layers=n),
            "norm2": norm_init(cfg, dev, layers=n),
            "attn": attn(gen, cfg, dev, layers=n),
            "ffn": (moe_init if seg.moe else mlp_init)(gen, cfg, dev, layers=n),
        }

    def init(self, gen: torch.Generator) -> Dict:
        """Random parameters drawn from ``gen``, which lies on the model's
        device."""
        cfg, dev = self.cfg, self.device
        dt = torch_dtype(cfg.dtype)
        params: Dict[str, Any] = {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, dt, dev),
            "final_norm": norm_init(cfg, dev),
            "segments": [self._block_init(gen, seg) for seg in self.segments],
        }
        if not cfg.tie_embeddings:
            w = torch.randn((cfg.d_model, cfg.vocab), generator=gen,
                            dtype=torch.float32, device=dev) * 0.02
            params["lm_head"] = {"w": w.to(dt)}
        if cfg.enc_dec:
            params["enc_final_norm"] = norm_init(cfg, dev)
        return params

    # ------------------------------------------------------------------ cache --
    def init_cache(self, batch: int, capacity: int) -> List[Dict[str, Any]]:
        """Per-segment decode caches and states, stacked over layers: a KV
        cache of ``capacity`` slots (a local-attention segment keeps at most
        its window, as a ring), MLA's latent cache, the RWKV6 state, a
        group's ``{"rec": RG-LRU states (groups, n_rec, B, ...), "attn": KV
        ring (groups, B, ...)}``, or a decoder's ``{"self": KV cache of
        ``capacity`` slots, "cross": KV cache of ``enc_len`` slots}`` (an
        encoder segment keeps None); the recurrent states do not grow with
        the sequence.  :meth:`cache_batch_axes` says where the batch axis is."""
        cfg, dev = self.cfg, self.device
        caches: List[Dict[str, Any]] = []
        for seg in self.segments:
            cap = min(capacity, seg.window) if seg.window else capacity
            if seg.kind == "attn" and cfg.attention == "mla":
                caches.append(make_mla_cache(cfg, batch, capacity, seg.n, dev))
            elif seg.kind == "attn":
                caches.append(make_cache(cfg, batch, cap, seg.n, dev))
            elif seg.kind == "group":
                cache = {"rec": rglru_state(cfg, batch, (seg.n, seg.n_rec), dev)}
                if seg.has_attn:
                    cache["attn"] = make_cache(cfg, batch, cap, seg.n, dev)
                caches.append(cache)
            elif seg.kind == "enc":
                caches.append(None)
            elif seg.kind == "dec":
                caches.append({"self": make_cache(cfg, batch, capacity, seg.n, dev),
                               "cross": make_cache(cfg, batch, cfg.enc_len, seg.n, dev)})
            else:
                caches.append(rwkv6_state(cfg, batch, seg.n, dev))
        return caches

    def cache_batch_axes(self) -> List[Any]:
        """The batch axis of every leaf of :meth:`init_cache`'s caches, one
        entry a segment: an int for every leaf below it, or a dictionary by
        key.  Axis 1 under the layer axis (a decoder's self and cross
        caches alike; an encoder segment holds no cache); 2 for a group's
        RG-LRU states, stacked over (groups, blocks)."""
        return [{"rec": 2, "attn": 1} if seg.kind == "group" else 1 for seg in self.segments]

    # ----------------------------------------------------------------- blocks --
    def _apply_attn_block(self, seg: Segment, p, x, positions, cache, gapless, aux,
                          position_ids=None, causal=True, load=None):
        """Attention (MLA or GQA), then the MLP or (``seg.moe``) the mixture
        of experts, whose claims a layer are added to ``load`` (E,)."""
        cfg = self.cfg
        h = norm_apply(cfg, p["norm1"], x)
        if cfg.attention == "mla":
            with span("model.mla", device=self.device):
                a, _ = mla_apply(cfg, p["attn"], h, positions, cache=cache, gapless=gapless)
        else:
            a, _ = gqa_apply(cfg, p["attn"], h, positions, cache=cache, causal=causal,
                             window=seg.window, position_ids=position_ids,
                             attn_fn=self.attn_fn, decode_fn=self.decode_fn, gapless=gapless)
        x = x + a
        h2 = norm_apply(cfg, p["norm2"], x)
        if seg.moe:
            with span("model.moe", device=self.device):
                f, aux_l = moe_apply(cfg, p["ffn"], h2, load=load)
            return x + f, aux + aux_l
        return x + mlp_apply(cfg, p["ffn"], h2), aux

    def _apply_rec_block(self, p, x, state):
        """One RG-LRU block with its GeGLU MLP; a new state is written into
        ``state`` in place."""
        cfg = self.cfg
        h = norm_apply(cfg, p["norm1"], x)
        r, new = rglru_apply(cfg, p["rec"], h, state)
        if state is not None:
            for key, val in new.items():
                state[key].copy_(val)
        x = x + r
        h2 = norm_apply(cfg, p["norm2"], x)
        return x + mlp_apply(cfg, p["ffn"], h2)

    def _apply_dec_block(self, p, x, positions, cache, enc_out, enc_positions, gapless):
        """A decoder block: causal self-attention (the kernel routes), then
        cross-attention to ``enc_out`` (written into the cross cache when
        there is one) or, without ``enc_out``, to the cross cache read only,
        then the MLP."""
        cfg = self.cfg
        h = norm_apply(cfg, p["norm1"], x)
        a, _ = gqa_apply(cfg, p["self_attn"], h, positions,
                         cache=cache["self"] if cache is not None else None,
                         attn_fn=self.attn_fn, decode_fn=self.decode_fn, gapless=gapless)
        x = x + a
        hx = norm_apply(cfg, p["norm_x"], x)
        if enc_out is not None:
            c, _ = gqa_apply(cfg, p["cross_attn"], hx, positions, kv_x=enc_out,
                             kv_positions=enc_positions,
                             cache=cache["cross"] if cache is not None else None, causal=False)
        elif cache is not None:
            c, _ = gqa_apply(cfg, p["cross_attn"], hx, positions, cache=cache["cross"],
                             cache_read_only=True, causal=False)
        else:
            raise ValueError("a decoder block needs the encoder's output or a cross cache")
        x = x + c
        h2 = norm_apply(cfg, p["norm2"], x)
        return x + mlp_apply(cfg, p["ffn"], h2)

    def _apply_group(self, seg: Segment, p, x, positions, cache, gapless, aux):
        """A hybrid group: ``n_rec`` RG-LRU blocks, then (``has_attn``) a
        local-attention block over the group's KV ring."""
        for j, pj in enumerate(_unstack(p["rec"], seg.n_rec)):
            state = _layer(cache["rec"], j) if cache is not None else None
            x = self._apply_rec_block(pj, x, state)
        if seg.has_attn:
            kv = cache["attn"] if cache is not None else None
            x, aux = self._apply_attn_block(dataclasses.replace(seg, moe=False), p["attn"], x,
                                            positions, kv, gapless, aux)
        return x, aux

    # ----------------------------------------------------------------- driver --
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """The Whisper encoder over precomputed (stub front end) frame
        embeddings ``frames`` (B, T, d): plus the sinusoidal embedding of
        ``0..T-1``, the ``"enc"`` segments' non-causal blocks, then
        ``enc_final_norm``."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        B, T, _ = frames.shape
        pos = torch.arange(T, device=frames.device).expand(B, T)
        x = self._wsc(frames.to(dt) + sinusoidal_embed(pos, cfg.d_model).to(dt))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for s, seg in enumerate(self.segments):
            if seg.kind != "enc":
                continue
            block = functools.partial(self._apply_attn_block, seg, positions=pos, cache=None,
                                      gapless=False, causal=False)
            for p in _unstack(params["segments"][s], seg.n):
                x, aux = self._layer(block, p, x, aux, remat=True)
                x = self._wsc(x)
        return norm_apply(cfg, params["enc_final_norm"], x)

    def _encoder_inputs(self, params, batch):
        """``(enc_out, enc_positions)`` for an encoder-decoder model (the
        encoder run once over ``batch["frames"]``), else ``(None, None)``."""
        if not self.cfg.enc_dec:
            return None, None
        enc_out = self.encode(params, batch["frames"])
        B, T, _ = enc_out.shape
        return enc_out, torch.arange(T, device=enc_out.device).expand(B, T)

    def backbone(self, params, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None,
                 caches=None, position_ids: Optional[torch.Tensor] = None,
                 enc_out: Optional[torch.Tensor] = None,
                 enc_positions: Optional[torch.Tensor] = None):
        """Embed -> segments -> final norm.  ``positions`` (B,S) are the
        tokens' absolute positions, ``0..S-1`` if not given; the RWKV6
        segment carries its position in its state and reads none.
        ``position_ids`` (3,B,S) rotate a ``vlm`` model's attention by
        M-RoPE; masks and cache slots still come from ``positions``.  An
        encoder-decoder model adds the sinusoidal embedding of ``positions``
        to the token embedding and skips its encoder segments here: its
        decoder blocks attend to ``enc_out`` at ``enc_positions``, or
        without them read their cross caches.  Returns
        ``(hidden (B,S,d), caches, aux)``, as the JAX ``backbone`` does; with
        caches, each layer's new state is written into them in place.
        ``aux`` is the auxiliary (MoE) loss summed over the layers, an f32
        scalar on the device (0 without a mixture of experts).  The RG-LRU
        blocks carry their state and read no position.
        Attention over a cache takes the kernel route only for positions it
        makes itself (a prefill from 0); given positions take the JAX route
        (``models/attention.py``)."""
        return self._backbone(params, tokens, positions, caches, gapless=positions is None,
                              position_ids=position_ids, enc_out=enc_out,
                              enc_positions=enc_positions)

    def _backbone(self, params, tokens, positions, caches, gapless: bool, position_ids=None,
                  enc_out=None, enc_positions=None):
        cfg = self.cfg
        B, S = tokens.shape
        x = self._wsc(params["embed"]["embedding"][tokens])
        if positions is None:
            positions = torch.arange(S, device=tokens.device).expand(B, S)
        if cfg.enc_dec:
            x = x + sinusoidal_embed(positions, cfg.d_model).to(x.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for s, seg in enumerate(self.segments):
            if seg.kind == "enc":
                continue
            cache = caches[s] if caches is not None else None
            for i, p in enumerate(_unstack(params["segments"][s], seg.n)):
                layer = _layer(cache, i) if cache is not None else None
                block = functools.partial(
                    self._block, seg, positions=positions, cache=layer, gapless=gapless,
                    position_ids=position_ids, enc_out=enc_out, enc_positions=enc_positions,
                    load=(self.expert_load[i] if seg.moe and caches is not None
                          and self.expert_load is not None else None))
                x, aux = self._layer(block, p, x, aux, remat=caches is None)
                x = self._wsc(x)
        return norm_apply(cfg, params["final_norm"], x), caches, aux

    def _block(self, seg: Segment, p, x, aux, positions, cache, gapless, position_ids,
               enc_out, enc_positions, load=None):
        """One layer of ``seg`` (a group for ``"group"``): ``(x, aux)``
        after it, its new state written into ``cache`` in place."""
        if seg.kind == "attn":
            return self._apply_attn_block(seg, p, x, positions, cache, gapless, aux,
                                          position_ids, load=load)
        if seg.kind == "dec":
            return self._apply_dec_block(p, x, positions, cache, enc_out, enc_positions,
                                         gapless), aux
        if seg.kind == "group":
            return self._apply_group(seg, p, x, positions, cache, gapless, aux)
        x, new = rwkv6_apply(self.cfg, p["block"], x, cache, mix_fn=self.mix_fn)
        if cache is not None:
            for key, val in new.items():
                cache[key].copy_(val)
        return x, aux

    def _layer(self, block, p, x, aux, remat: bool):
        """``block(p, x, aux) -> (x, aux)``, checkpointed by ``cfg.remat``
        when ``remat`` (no caches).  The checkpointed block starts from a
        zero aux and returns its own, which is added here once."""
        policy = self.cfg.remat
        if not remat or policy == "none":
            return block(p, x, aux=aux)
        if policy not in ("block", "dots"):
            raise ValueError(f"unknown remat {policy!r}")
        extra = {"context_fn": _dots_context} if policy == "dots" else {}
        x, own = checkpoint(lambda p_, x_, a_: block(p_, x_, aux=a_), p, x,
                            torch.zeros_like(aux), use_reentrant=False, **extra)
        return x, aux + own

    # ------------------------------------------------------------------ heads --
    def _head(self, params) -> Tuple[torch.Tensor, torch.dtype]:
        """The head's weight ``(d, vocab)`` (the tied embedding's transpose or
        ``lm_head.w``, a view, no copy) and the logits' dtype."""
        cfg = self.cfg
        w = (params["embed"]["embedding"].T if cfg.tie_embeddings
             else params["lm_head"]["w"])
        return w, torch_dtype(cfg.logits_dtype)

    def logits(self, params, hidden: torch.Tensor) -> torch.Tensor:
        """``hidden @ W`` in ``logits_dtype``, constrained to
        ``logits_sharding``.  The JAX model gets float32 logits from bf16
        operands (``preferred_element_type``); here
        :func:`~repro_torch.models.layers.head_product` does: on a card, 16-bit
        operands go to the tensor cores with a float32 output and an exact
        backward; elsewhere both operands are cast up first, which gives the
        same values.  The span's ``route`` says which."""
        w, ld = self._head(params)
        with span("model.logits", device=self.device) as sp:
            if sp:
                sp.set(route=head_route(hidden, w, ld))
            return _constrain(head_product(hidden, w, ld), self.logits_sharding)

    def _xent(self, params, hidden: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Mean cross-entropy over the vocabulary; with ``xent_chunk`` > 1
        dividing S, computed over that many sequence chunks, each
        recomputed in the backward pass (``jax.remat`` in the JAX model) so
        only one chunk's logits are alive at a time."""
        nc = self.cfg.xent_chunk

        def ce(h, y):
            lg = self.logits(params, h)
            m = lg.max(dim=-1, keepdim=True).values.detach()
            logz = torch.log(torch.exp(lg - m).sum(dim=-1)) + m[..., 0]
            gold = lg.gather(-1, y[..., None].long())[..., 0]
            return (logz - gold).sum()

        B, S, _ = hidden.shape
        if nc and nc > 1 and S % nc == 0:
            parts = [checkpoint(ce, h, y, use_reentrant=False)
                     for h, y in zip(hidden.chunk(nc, dim=1), labels.chunk(nc, dim=1))]
            total = torch.stack(parts).sum()
        else:
            total = ce(hidden, labels)
        return total / (B * S)

    # -------------------------------------------------------------------- API --
    def loss(self, params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: tokens (B,S), labels (B,S) [+ frames / position_ids].
        Returns ``(loss, {"xent", "moe_aux"})`` as the JAX model does: the
        cross-entropy plus ``MOE_AUX_WEIGHT`` times the auxiliary loss summed
        over the MoE layers (0 without them)."""
        enc_out, enc_pos = self._encoder_inputs(params, batch)
        hidden, _, aux = self.backbone(params, batch["tokens"],
                                       position_ids=batch.get("position_ids"),
                                       enc_out=enc_out, enc_positions=enc_pos)
        xent = self._xent(params, hidden, batch["labels"])
        return xent + MOE_AUX_WEIGHT * aux, {"xent": xent, "moe_aux": aux}

    def prefill(self, params, batch: Dict[str, torch.Tensor], caches):
        """Bulk-process a prompt from position 0, filling caches (an
        encoder-decoder model runs its encoder over ``batch["frames"]`` and
        writes the cross caches).  Returns last-token logits."""
        with span("model.prefill", device=self.device):
            enc_out, enc_pos = self._encoder_inputs(params, batch)
            hidden, caches, _ = self.backbone(params, batch["tokens"], caches=caches,
                                              position_ids=batch.get("position_ids"),
                                              enc_out=enc_out, enc_positions=enc_pos)
            return self.logits(params, hidden[:, -1:, :])[:, 0], caches

    def decode_step(self, params, tokens: torch.Tensor, pos: torch.Tensor, caches,
                    position_ids: Optional[torch.Tensor] = None):
        """One decode step.  tokens: (B,), pos: (B,) absolute position of
        each token (read by attention; the RWKV6 and RG-LRU states carry
        their own); ``position_ids`` (3,B,1) for M-RoPE.  An
        encoder-decoder model's cross-attention reads its cross caches.

        The caller keeps the invariant the ``ServingEngine`` keeps: each
        row's cache holds its sequence's positions ``0..pos-1`` with no gap
        (written by ``prefill`` and the steps since; a position past a
        global cache's end is written to its last slot, a ring cache wraps).
        Attention then reads slots ``[0, min(pos + 1, C))`` through the
        decode kernel.  Use
        ``backbone`` with explicit positions for anything else."""
        with span("model.decode_step", device=self.device) as sp:
            if sp:
                sp.set(replay=False)
            hidden, caches, _ = self._backbone(params, tokens[:, None], pos[:, None], caches,
                                               gapless=True, position_ids=position_ids)
            return self.logits(params, hidden)[:, 0], caches

    @property
    def decode_capturable(self) -> bool:
        """Whether :meth:`decode_graph` may capture this model's decode step.
        Not where a hook (``mix_fn``, ``attn_fn``, ``decode_fn``) stands in
        for a kernel: its Python runs at every eager step (the card checks
        hold each call's inputs and outputs), and a replay would skip it.
        Every segment's decode step is capturable: each issues its work on
        the device with no host sync, at shapes fixed by the batch and the
        caches."""
        return self.mix_fn is None and self.attn_fn is None and self.decode_fn is None

    def decode_graph(self, params, tokens: torch.Tensor, pos: torch.Tensor,
                     caches) -> "DecodeGraph":
        """:meth:`decode_step` on these very tensors as a :class:`DecodeGraph`,
        whose call runs one step: the caller updates ``tokens`` and ``pos`` in
        place between calls, and the caches are written in place as always.
        Needs a CUDA device and :attr:`decode_capturable`."""
        if self.device.type != "cuda" or not self.decode_capturable:
            raise ValueError(f"{self.cfg.name} on {self.device}: no CUDA graph of its decode "
                             "step (a CUDA device and no kernel hook are needed)")
        return DecodeGraph(self, params, tokens, pos, caches)


class DecodeGraph:
    """One model's decode step on fixed tensors, replayed as CUDA graphs.

    The first :data:`WARMUP_STEPS` calls run :meth:`LM.decode_step` eagerly
    on a side stream: the warm-up (libraries' handles and workspaces for
    that stream, the kernels loaded) is the step's own work, so no state is
    advanced twice.  The next call captures one call of the model's
    ``decode_step`` on that stream as two graphs sharing one memory pool,
    split where the step calls :meth:`LM.logits`: the backbone (embedding,
    every layer, final norm, into a static hidden buffer), then the head
    (its product into a static logits buffer, and whatever the step does
    after it).  The capture goes through ``decode_step`` as the model's
    class has it at that moment, so a wrapper patched over
    ``LM.decode_step`` before then is replayed with the step.  A replay
    opens the eager step's spans: ``model.decode_step`` (with
    ``replay=True``) over both replays, ``model.logits`` with its device
    time and the ``route`` the capture took over the head's; and
    ``model.backbone`` with its device time over the backbone's (the
    layers' own spans, ``model.mla`` and ``model.moe``, are not recorded
    inside a graph).  The capture records no span (none
    records while a stream captures), runs no garbage collection and counts
    no launch; each replay adds the launches the capture counted to the
    kernels' counters (:mod:`repro_torch.kernels.counts`).

    A call returns the logits ``(B, vocab)``: after a capture, the static
    buffer the next replay overwrites.  The graphs' pool holds the step's
    activations and the logits for as long as the object lives.
    ``captures`` and ``replays`` count what the calls did."""

    WARMUP_STEPS = 1

    def __init__(self, model: LM, params, tokens, pos, caches):
        self.model = model
        self.args = (params, tokens, pos, caches)
        self.stream = torch.cuda.Stream(model.device)
        self.graphs: Optional[Tuple[torch.cuda.CUDAGraph, torch.cuda.CUDAGraph]] = None
        self.hidden: Optional[torch.Tensor] = None     # held: the head's graph reads it
        self.logits: Optional[torch.Tensor] = None
        self.launches: Optional[counts.Counts] = None
        self.route: Optional[str] = None              # the head's, as captured
        self.warmups = self.captures = self.replays = 0

    def serves(self, model: LM, params, caches) -> bool:
        """Whether this graph steps ``model`` on ``params`` and ``caches``,
        the very objects it was made for."""
        return model is self.model and params is self.args[0] and caches is self.args[3]

    def __call__(self) -> torch.Tensor:
        if self.graphs is None:
            if self.warmups < self.WARMUP_STEPS:
                self.warmups += 1
                return self._on_side_stream(lambda: self.model.decode_step(*self.args)[0])
            self._on_side_stream(self._capture)
        return self._replay()

    def _on_side_stream(self, fn):
        main = torch.cuda.current_stream(self.model.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = fn()
        main.wait_stream(self.stream)
        return out

    def _capture(self) -> None:
        model = self.model
        head_of = model.logits
        backbone, head = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        capturing = [backbone]

        def split_logits(params, hidden):
            if capturing[-1] is backbone:      # the backbone's graph ends at the head
                backbone.capture_end()
                head.capture_begin(backbone.pool())
                capturing.append(head)
                self.hidden = hidden
                self.route = head_route(hidden, *model._head(params))
            return head_of(params, hidden)

        before = counts.snapshot()
        torch.cuda.synchronize(model.device)
        # no collection inside the capture: one that frees a dead CUDA graph
        # destroys it, which a capture forbids, and the capture fails
        collecting = gc.isenabled()
        gc.disable()
        model.logits = split_logits            # this instance's, for the capture only
        try:
            backbone.capture_begin()
            try:
                self.logits = model.decode_step(*self.args)[0]
            finally:
                capturing[-1].capture_end()
        finally:
            del model.logits
            if collecting:
                gc.enable()
        if capturing[-1] is not head:
            raise RuntimeError(f"{model.cfg.name}: the decode step never called LM.logits, "
                               "so its head could not be captured apart")
        self.launches = counts.since(before)
        counts.add(self.launches, -1)
        self.graphs = (backbone, head)
        self.captures += 1

    def _replay(self) -> torch.Tensor:
        dev = self.model.device
        backbone, head = self.graphs
        with span("model.decode_step", device=dev) as sp:
            if sp:
                sp.set(replay=True)
            with span("model.backbone", device=dev):
                backbone.replay()
            with span("model.logits", device=dev) as sp:
                if sp:
                    sp.set(route=self.route)
                head.replay()
        counts.add(self.launches)
        self.replays += 1
        return self.logits
