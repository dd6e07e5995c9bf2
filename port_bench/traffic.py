"""The one traffic generator: reads a mix's parameters and makes its
requests or batches.

Every seed gets the same work.  The sizes (prompt and output lengths) and
the gaps between arrivals are drawn from the mix's own ``shape_seed``, so
the set of them is fixed by the mix; the run's ``--seed`` only orders them,
by a rotation (where the sequence starts), and draws the token ids.  A
rotation keeps each request behind the gap it was drawn with, so bursts
and the long prompts in them stay as they are: two seeds differ in where
the sequence starts and what the prompts say, not in how much there is to
do or how it bunches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Request", "lognormal_lengths", "open_loop", "warmup_requests", "seed_rng"]


@dataclass
class Request:
    rid: str
    prompt: np.ndarray            # int64 token ids
    n_out: int                    # max_new_tokens handed to the engine
    due: Optional[float] = None   # seconds after the window opens (open loop)
    # filled by the serving loop, on the host clock relative to the window
    admitted: Optional[float] = None
    first: Optional[float] = None
    token_times: List[float] = field(default_factory=list)
    tokens: Optional[List[int]] = None
    done: Optional[float] = None


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for ``stream`` of a run's ``seed`` (any whole
    number; negative ones are taken modulo 2**64)."""
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def lognormal_lengths(rng: np.random.Generator, n: int, spec: Dict) -> np.ndarray:
    """``n`` lengths, lognormal about ``spec["median"]`` with log-spread
    ``spec["sigma"]``, rounded and clipped to ``[min, max]``."""
    x = spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n))
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def _prompts(rng: np.random.Generator, lengths: np.ndarray, vocab: int) -> List[np.ndarray]:
    ids = rng.integers(0, vocab, int(lengths.sum()), dtype=np.int64)
    return np.split(ids, np.cumsum(lengths)[:-1])


def open_loop(mix: Dict, seconds: float, seed: int, vocab: int) -> List[Request]:
    """Poisson arrivals at ``mix["rate_per_s"]`` over the window: ``n =
    round(rate * seconds)`` requests, each with the exponential gap before
    it, drawn from the mix's shape seed and scaled so that the ``n`` gaps
    and one more span the window exactly; the seed rotates the sequence of
    (gap, prompt, output)."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    shape = np.random.default_rng(mix["shape_seed"])
    p_len = lognormal_lengths(shape, n, mix["prompt"])
    o_len = lognormal_lengths(shape, n, mix["output"])
    gaps = shape.exponential(1.0, n + 1)
    gaps *= seconds / gaps.sum()
    rng = seed_rng(seed, 1)
    order = np.roll(np.arange(n), -int(rng.integers(n)))
    due = np.cumsum(gaps[:n][order])
    prompts = _prompts(rng, p_len[order], vocab)
    return [Request(f"r{i}", prompts[i], int(o_len[order][i]), due=float(due[i]))
            for i in range(n)]


def warmup_requests(mix: Dict, seed: int, vocab: int) -> List[Request]:
    """The set-up's requests: one for each of the mix's ``warmup_prompts``
    lengths, ``warmup_new`` tokens each, ids from the run's seed."""
    lengths = np.asarray(mix["warmup_prompts"], dtype=np.int64)
    prompts = _prompts(seed_rng(seed, 2), lengths, vocab)
    return [Request(f"w{i}", p, int(mix["warmup_new"])) for i, p in enumerate(prompts)]
