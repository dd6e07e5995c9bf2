"""Faults planted in the program underneath a run, to show that the check
fails them: each is a context manager that patches the port while it is
open.  Used by the tests and by ``calibrate.py``; a benchmark run plants
none.

Serving (``LM.decode_step``, the engine's decode):
  ``state_unchanged``  the step decodes from a copy of the cache, so the
                       engine's cache never takes the new tokens;
  ``half_batch``       the second half of the batch is left out: its rows
                       get the first half's logits;
  ``token_altered``    every decoded token is the next id after the one
                       the logits put first.
Training (``make_train_step``):
  ``state_unchanged``  the step computes, then returns the parameters and
                       optimizer state as they were;
  ``half_batch``       the step sees the first half of the batch's rows, the
                       mean taken over them.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

SERVE = ("state_unchanged", "half_batch", "token_altered")
TRAIN = ("state_unchanged", "half_batch")


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if hasattr(tree, "clone") else tree


@contextlib.contextmanager
def serve_fault(kind: str) -> Iterator[None]:
    from repro_torch.models.transformer import LM

    orig = LM.decode_step

    def decode_step(self, params, tokens, pos, caches, position_ids=None):
        if kind == "state_unchanged":
            logits, _ = orig(self, params, tokens, pos, _clone(caches), position_ids)
            return logits, caches
        logits, caches = orig(self, params, tokens, pos, caches, position_ids)
        if kind == "half_batch":
            half = logits.shape[0] // 2
            logits = logits.clone()
            logits[logits.shape[0] - half:] = logits[:half]
        elif kind == "token_altered":
            logits = logits.roll(1, dims=-1)
        else:
            raise ValueError(f"unknown serving fault {kind!r}")
        return logits, caches

    LM.decode_step = decode_step
    try:
        yield
    finally:
        LM.decode_step = orig


@contextlib.contextmanager
def train_fault(kind: str) -> Iterator[None]:
    import repro_torch.train.step as step_module

    orig = step_module.make_train_step

    def make_train_step(model, optimizer, **kw):
        step = orig(model, optimizer, **kw)

        def faulty(params, opt_state, batch):
            if kind == "state_unchanged":
                _, _, out = step(_clone(params), _clone(opt_state), batch)
                return params, opt_state, out
            if kind == "half_batch":
                half = batch["tokens"].shape[0] // 2
                return step(params, opt_state, {k: v[:half] for k, v in batch.items()})
            raise ValueError(f"unknown training fault {kind!r}")

        return faulty

    step_module.make_train_step = make_train_step
    try:
        yield
    finally:
        step_module.make_train_step = orig
