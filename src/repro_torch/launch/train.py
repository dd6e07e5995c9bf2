"""End-to-end training driver on one device.

The counterpart of the JAX package's ``launch/train.py``, without a mesh or
shardings: synthetic-but-learnable LM data through the ``Prefetcher``, the
train step (AdamW on a cosine schedule with warmup), replicated
checkpointing on the Young/Daly cadence, and crash-restart resume.  Every
architecture trains: an ``audio`` model's batches carry zero ``frames`` and
a ``vlm`` model's text ``position_ids``, as in the JAX trainer
(:func:`frontend_stubs`).  On the card every causal self-attention layer's
forward runs the flash-attention kernel.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --full --batch 4 --seq 2048

``--simulate-failure N`` drops the state at step N and restores it from the
replicated checkpoint, to exercise the restart path end to end.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..ckpt.checkpoint import CheckpointManager
from ..configs import ARCHS, get_config
from ..data.pipeline import Prefetcher
from ..data.synthetic import SyntheticLM
from ..device import synchronize
from ..models import LM, reduced
from ..optim.optimizers import AdamW
from ..optim.schedules import cosine_with_warmup
from ..train.step import make_train_step

__all__ = ["train", "frontend_stubs", "main"]


def _default_ckpt_dirs() -> Sequence[str]:
    root = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    return (os.path.join(root, "a"), os.path.join(root, "b"))


def frontend_stubs(cfg, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A stream batch with the model's front-end stubs added, as the JAX
    trainer adds them: M-RoPE ``position_ids`` (3, B, S), ``0..S-1`` in all
    three streams, for a model that needs them, and zero ``frames`` (B,
    enc_len, d_model) in float32 for an encoder-decoder model."""
    B, S = batch["tokens"].shape
    batch = dict(batch)
    if cfg.needs_position_ids:
        batch["position_ids"] = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    if cfg.enc_dec:
        batch["frames"] = np.zeros((B, cfg.enc_len, cfg.d_model), dtype=np.float32)
    return batch


def train(
    arch: str = "qwen1.5-0.5b",
    *,
    use_reduced: bool = True,
    steps: int = 60,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-3,
    microbatches: int = 1,
    ckpt_dirs: Optional[Sequence[str]] = None,
    async_ckpt: bool = True,
    resume: bool = False,
    log_every: int = 10,
    simulate_failure: Optional[int] = None,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = "cuda",
) -> Dict[str, Any]:
    """Train ``arch`` for ``steps`` steps; returns the losses, gradient norms
    and step times (host clock around each step, ended by a device
    synchronise), and the final parameters and optimizer state.  Raises
    without a card unless ``device="cpu"``."""
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg, vocab=min(cfg.vocab, 2048))
    model = LM(cfg, device=device)
    dev = model.device

    optimizer = AdamW(lr=cosine_with_warmup(lr, warmup=max(steps // 10, 1), total=steps))
    step_fn = make_train_step(model, optimizer, microbatches=microbatches)

    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    opt_state = optimizer.init(params)
    start_step = 0

    mgr = CheckpointManager(replica_dirs=list(ckpt_dirs or _default_ckpt_dirs()),
                            fleet_lams=[2e-4], async_save=async_ckpt, keep=2)
    if resume:
        try:
            (params, opt_state), start_step, _ = mgr.restore((params, opt_state))
            print(f"[train] resumed from step {start_step}")
        except FileNotFoundError:
            print("[train] no checkpoint found; starting fresh")

    stream = (frontend_stubs(cfg, b) for b in SyntheticLM(cfg.vocab, batch, seq, seed=seed))
    data = Prefetcher(stream, depth=2, device=dev)
    losses, grad_norms, step_s = [], [], []
    s = start_step
    try:
        while s < steps:
            batch_t = next(data)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch_t)
            synchronize(dev)
            step_s.append(time.perf_counter() - t0)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            losses.append(loss)
            grad_norms.append(gnorm)
            s += 1
            if s % log_every == 0 or s == steps:
                print(f"[train] step {s:5d}  loss {loss:7.4f}  grad_norm {gnorm:8.3f}  "
                      f"{step_s[-1] * 1e3:7.1f} ms/step", flush=True)
            if mgr.maybe_save((params, opt_state), s):
                print(f"[train] checkpoint @ step {s} (Young-Daly interval "
                      f"{mgr.interval:.0f}s, {len(mgr.replica_dirs)} replicas)")
            if simulate_failure is not None and s == simulate_failure:
                print(f"[train] !! simulated failure at step {s}: dropping state, "
                      f"restoring from replicated checkpoint")
                mgr.wait()
                mgr.save((params, opt_state), s)   # pretend the last checkpoint was here
                mgr.wait()   # an async save must land before the restore reads it
                params = model.init(torch.Generator(device=dev).manual_seed(seed + 99))
                opt_state = optimizer.init(params)
                (params, opt_state), s, _ = mgr.restore((params, opt_state))
                simulate_failure = None
        mgr.wait()
    finally:
        data.close()
    return {
        "first_loss": losses[0],
        "final_loss": float(np.mean(losses[-5:])),
        "losses": losses,
        "grad_norms": grad_norms,
        "step_s": step_s,
        "steps": steps,
        "params": params,
        "opt_state": opt_state,
        "config": cfg,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = train(
        args.arch, use_reduced=args.reduced, steps=args.steps,
        batch=args.batch, seq=args.seq, lr=args.lr,
        microbatches=args.microbatches, resume=args.resume,
        simulate_failure=args.simulate_failure, device=args.device,
    )
    print(f"[train] loss {out['first_loss']:.4f} -> {out['final_loss']:.4f} "
          f"over {out['steps']} steps")


if __name__ == "__main__":
    main()
