"""End-to-end serving driver.

Serves a model with batched requests through the slot-based
continuous-batching engine, then measures the decode-latency-vs-occupancy
interference line ``T = m*k + c`` on real timings.  The third part of the
JAX driver, the ``ServingFleet`` policy comparison, waits for the
orchestration port (ROADMAP.md).

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 64
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Union

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..models import LM, reduced
from ..device import synchronize
from ..serve.engine import ServingEngine, measure_interference

__all__ = ["main", "serve_demo"]


def serve_demo(arch: str = "qwen1.5-0.5b", n_requests: int = 64,
               max_batch: int = 8, max_seq: int = 128, seed: int = 0,
               device: Optional[Union[str, torch.device]] = "cuda"):
    """The JAX ``serve_demo``'s parts 1-2 on a reduced config: batched
    requests through the engine, then the interference fit."""
    cfg = reduced(get_config(arch), n_layers=2, vocab=512)
    model = LM(cfg, device=device)
    params = model.init(torch.Generator(device=model.device).manual_seed(seed))
    rng = np.random.default_rng(seed)

    # -- 1) real engine, batched requests --------------------------------------
    eng = ServingEngine(model, params, max_batch=max_batch, max_seq=max_seq)
    pending = [
        (f"req{i}", rng.integers(0, cfg.vocab, int(rng.integers(4, 16))).tolist(),
         int(rng.integers(8, 32)))
        for i in range(n_requests)
    ]
    done = {}
    t0 = time.perf_counter()
    steps = 0
    while len(done) < n_requests:
        while pending and eng.free_slots():
            rid, prompt, n_new = pending.pop()
            eng.add_request(rid, prompt, n_new)
        done.update(eng.step())
        steps += 1
    synchronize(model.device)
    wall = time.perf_counter() - t0
    n_tok = sum(len(v) for v in done.values())
    print(f"[serve] {n_requests} requests, {n_tok} tokens in {wall:.2f}s on "
          f"{model.device} ({n_tok/wall:.1f} tok/s, {steps} engine steps, "
          f"batch occupancy {n_tok/steps:.2f})")

    # -- 2) interference linearity on real timings ------------------------------
    m, c, r2, samples = measure_interference(
        model, params, batch_sizes=(1, 2, 4, 8), max_seq=max_seq, iters=10)
    print(f"[serve] decode-step latency fits T = m*k + c: "
          f"m={m*1e3:.3f} ms/seq, c={c*1e3:.3f} ms, R^2={r2:.4f}")
    for k, dt in samples:
        print(f"         k={k}: {dt*1e3:.2f} ms  (fit {(m*k+c)*1e3:.2f} ms)")
    return {"throughput_tok_s": n_tok / wall, "interference": (m, c, r2),
            "outputs": done}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCHS)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    serve_demo(args.arch, n_requests=args.requests, max_batch=args.max_batch,
               device=args.device)


if __name__ == "__main__":
    main()
