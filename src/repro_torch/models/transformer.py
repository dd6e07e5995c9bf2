"""Model assembly: the ``LM`` for the families ported so far.

The counterpart of the JAX package's ``models/transformer.py``.  The model
is a sequence of segments, each a homogeneous stack of blocks whose
parameters and states are stacked over a leading layer axis, as in the JAX
package; a Python loop over layers takes the place of ``lax.scan``.

Ported: the ``ssm`` family (one ``"rwkv"`` segment of RWKV6 blocks).  The
other families raise ``NotImplementedError``; they are queued in ROADMAP.md
("Remaining model families").

Parameters are plain dictionaries of tensors laid out like the JAX
``LM.init`` pytree, so :func:`repro_torch.models.convert.params_from_jax`
loads JAX weights as they are.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import torch

from ..device import resolve_device
from .config import ModelConfig
from .layers import embed_init, norm_apply, norm_init, torch_dtype
from .recurrent import MixFn, rwkv6_apply, rwkv6_init, rwkv6_state

__all__ = ["Segment", "LM", "build_segments"]


@dataclass(frozen=True)
class Segment:
    kind: str            # "rwkv"
    n: int               # layers


def build_segments(cfg: ModelConfig) -> List[Segment]:
    if cfg.family == "ssm" and cfg.recurrent is not None and cfg.recurrent.kind == "rwkv6":
        return [Segment("rwkv", cfg.n_layers)]
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet; see ROADMAP.md, queue 1, "
        "'Remaining model families'"
    )


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a layer-stacked dictionary of tensors (views, no copy)."""
    if isinstance(tree, dict):
        return {key: _layer(val, i) for key, val in tree.items()}
    return tree[i]


class LM:
    """Language model over ``ModelConfig``, on one device.

    Public surface (mirrors the JAX ``LM``):
      init(generator) -> params
      init_cache(batch, capacity) -> caches
      backbone(params, tokens, caches=None) -> (hidden, caches)
      logits(params, hidden) -> logits
      prefill(params, batch, caches) -> (last-token logits, caches)
      decode_step(params, tokens, caches) -> (logits, caches)

    Caches are updated in place and returned, where the JAX model returns
    new arrays (its engine donates the old ones).  ``mix_fn`` replaces the
    WKV recurrence in every block, to hold the kernel's path against the
    plain version on the card.
    """

    def __init__(self, cfg: ModelConfig, device: Optional[Union[str, torch.device]] = "cuda",
                 mix_fn: Optional[MixFn] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.segments = build_segments(cfg)
        self.mix_fn = mix_fn

    # ------------------------------------------------------------------ init --
    def init(self, gen: torch.Generator) -> Dict:
        """Random parameters drawn from ``gen``, which lies on the model's
        device."""
        cfg, dev = self.cfg, self.device
        dt = torch_dtype(cfg.dtype)
        params: Dict[str, Any] = {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, dt, dev),
            "final_norm": norm_init(cfg, dev),
            "segments": [
                {"block": rwkv6_init(gen, cfg, seg.n, dev)} for seg in self.segments
            ],
        }
        if not cfg.tie_embeddings:
            w = torch.randn((cfg.d_model, cfg.vocab), generator=gen,
                            dtype=torch.float32, device=dev) * 0.02
            params["lm_head"] = {"w": w.to(dt)}
        return params

    # ------------------------------------------------------------------ cache --
    def init_cache(self, batch: int, capacity: int) -> List[Dict[str, torch.Tensor]]:
        """Per-segment states, stacked over layers.  RWKV6 state does not
        grow with the sequence, so ``capacity`` is not needed for it."""
        return [rwkv6_state(self.cfg, batch, seg.n, self.device) for seg in self.segments]

    # ----------------------------------------------------------------- driver --
    def backbone(self, params, tokens: torch.Tensor, caches=None):
        """Embed -> segments -> final norm.  Returns ``(hidden (B,S,d),
        caches)``; with caches, each layer's new state is written into them
        in place."""
        cfg = self.cfg
        x = params["embed"]["embedding"][tokens]
        for s, seg in enumerate(self.segments):
            seg_p = params["segments"][s]
            cache = caches[s] if caches is not None else None
            for i in range(seg.n):
                state = _layer(cache, i) if cache is not None else None
                x, new = rwkv6_apply(cfg, _layer(seg_p, i)["block"], x, state,
                                     mix_fn=self.mix_fn)
                if cache is not None:
                    for key, val in new.items():
                        cache[key][i].copy_(val)
        return norm_apply(cfg, params["final_norm"], x), caches

    # ------------------------------------------------------------------ heads --
    def logits(self, params, hidden: torch.Tensor) -> torch.Tensor:
        """``hidden @ W`` in ``logits_dtype``.  The JAX model gets float32
        logits from bf16 operands (``preferred_element_type``); here both
        operands are cast up first, which gives the same values."""
        cfg = self.cfg
        w = (params["embed"]["embedding"].T if cfg.tie_embeddings
             else params["lm_head"]["w"])
        ld = torch_dtype(cfg.logits_dtype)
        return hidden.to(ld) @ w.to(ld)

    # -------------------------------------------------------------------- API --
    def prefill(self, params, batch: Dict[str, torch.Tensor], caches):
        """Bulk-process a prompt, filling caches.  Returns last-token logits."""
        hidden, caches = self.backbone(params, batch["tokens"], caches=caches)
        return self.logits(params, hidden[:, -1:, :])[:, 0], caches

    def decode_step(self, params, tokens: torch.Tensor, caches):
        """One decode step.  tokens: (B,).  The recurrent state carries the
        position, so no position is passed."""
        hidden, caches = self.backbone(params, tokens[:, None], caches=caches)
        return self.logits(params, hidden)[:, 0], caches
