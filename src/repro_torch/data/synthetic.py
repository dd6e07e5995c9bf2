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

from ..models.config import ModelConfig

__all__ = ["SyntheticLM", "materialize_batch"]


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


def materialize_batch(cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0,
                      mode: str = "train") -> Dict[str, np.ndarray]:
    """One concrete host batch of the stream.  mode: "train" (tokens and
    labels) or "prefill" (tokens).  The audio frames and M-RoPE position
    ids of the JAX version come with those families (ROADMAP.md)."""
    if cfg.enc_dec or cfg.needs_position_ids:
        raise NotImplementedError(
            f"{cfg.name}: audio frames and M-RoPE positions are not ported yet "
            "(ROADMAP.md, queue 1, 'Remaining model families')")
    b = next(iter(SyntheticLM(cfg.vocab, batch, seq_len, seed=seed)))
    out = {"tokens": b["tokens"]}
    if mode == "train":
        out["labels"] = b["labels"]
    return out
