"""Deterministic synthetic LM data.

A copy of the JAX package's ``data/synthetic.py`` stream, numpy only, so the
port's batches are byte-identical to the JAX package's for the same seed: a
seeded generator with a Markov-ish structure (next token = hash of the
previous one, or noise), so a trained model's loss actually decreases.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.layers import torch_dtype

__all__ = ["SyntheticLM", "batch_specs", "materialize_batch"]


@dataclass
class SyntheticLM:
    """Infinite deterministic stream of (tokens, labels) LM batches."""

    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    structure: float = 0.7   # fraction of deterministically-predictable tokens

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        mult = 6364136223846793005
        while True:
            x = np.empty((self.batch, self.seq_len + 1), dtype=np.int64)
            x[:, 0] = rng.integers(0, self.vocab, self.batch)
            noise = rng.random((self.batch, self.seq_len))
            rand_tok = rng.integers(0, self.vocab, (self.batch, self.seq_len))
            for t in range(self.seq_len):
                nxt = (x[:, t] * mult + 1442695040888963407) % self.vocab
                x[:, t + 1] = np.where(noise[:, t] < self.structure, nxt, rand_tok[:, t])
            yield {
                "tokens": x[:, :-1].astype(np.int32),
                "labels": x[:, 1:].astype(np.int32),
            }


def batch_specs(cfg: ModelConfig, batch: int, seq_len: int, mode: str = "train"
                ) -> Dict[str, torch.Tensor]:
    """Stand-ins on the meta device for every model input (the dry-run's
    inputs: shapes and dtypes, no storage), as the JAX version's
    ``ShapeDtypeStruct``s.  mode: "train" (tokens and labels) or "prefill"
    (tokens); ``tokens`` and ``labels`` (B, S) int32, an ``audio`` model's
    ``frames`` (B, enc_len, d_model) in the model's dtype, a ``vlm`` model's
    ``position_ids`` (3, B, S) int32."""
    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs = {"tokens": meta(batch, seq_len)}
    if mode == "train":
        specs["labels"] = meta(batch, seq_len)
    if cfg.enc_dec:
        specs["frames"] = meta(batch, cfg.enc_len, cfg.d_model, dtype=torch_dtype(cfg.dtype))
    if cfg.needs_position_ids:
        specs["position_ids"] = meta(3, batch, seq_len)
    return specs


def materialize_batch(cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0,
                      mode: str = "train") -> Dict[str, np.ndarray]:
    """One concrete host batch of the stream, matching :func:`batch_specs`.  mode: "train" (tokens and
    labels) or "prefill" (tokens).  The front-end stubs come as in the JAX
    version, the same values for the same seed: an ``audio`` model's
    ``frames`` (B, enc_len, d_model), standard normal draws of their own
    generator from ``seed``, in float32 (or the model's dtype when that is
    not bfloat16, which numpy lacks); a ``vlm`` model's M-RoPE
    ``position_ids`` (3, B, S), ``0..S-1`` in all three streams (text)."""
    rng = np.random.default_rng(seed)
    b = next(iter(SyntheticLM(cfg.vocab, batch, seq_len, seed=seed)))
    out = {"tokens": b["tokens"]}
    if mode == "train":
        out["labels"] = b["labels"]
    if cfg.enc_dec:
        frames = rng.standard_normal((batch, cfg.enc_len, cfg.d_model), dtype=np.float32)
        out["frames"] = frames.astype(cfg.dtype if cfg.dtype != "bfloat16" else "float32")
    if cfg.needs_position_ids:
        pos = np.broadcast_to(np.arange(seq_len, dtype=np.int32), (3, batch, seq_len))
        out["position_ids"] = np.ascontiguousarray(pos)
    return out
