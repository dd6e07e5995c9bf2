"""End-to-end serving driver.

Serves a model with batched requests through the slot-based
continuous-batching engine, measures the decode-latency-vs-occupancy
interference line ``T = m*k + c`` on real timings, then drives the IBDASH
fleet scheduler with the measured coefficients and compares policies (the
fleet's decisions run on the same device as the model).

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
from ..serve.scheduler import ServingFleet, serving_interference_model

__all__ = ["main", "serve_demo", "fleet_interference"]


def fleet_interference(m: float, c: float):
    """The fleet's replica interference table from a measured decode line
    ``T = m*k + c``, as the JAX ``serve_demo`` builds it (long requests
    cost ``3m`` and ``6c``).  A slope fitted below zero enters as 0: where
    the decode step is host-bound, a co-batched sequence adds less than
    the timing noise, and the table refuses negative coefficients."""
    m = max(m, 0.0)
    return serving_interference_model(m_short=m, c_short=c, m_long=3 * m, c_long=6 * c)


def serve_demo(arch: str = "qwen1.5-0.5b", n_requests: int = 64,
               max_batch: int = 8, max_seq: int = 128, seed: int = 0,
               device: Optional[Union[str, torch.device]] = "cuda"):
    """The JAX ``serve_demo`` on a reduced config: batched requests through
    the engine, the interference fit, then the fleet policy comparison
    with the measured ``(m, c)``.  Returns the fleet's rows and, beside
    the JAX ``serve_demo``'s keys, the served tokens as ``"outputs"``."""
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

    # -- 3) fleet scheduling with the measured coefficients ---------------------
    im = fleet_interference(m, c)
    print("[serve] fleet policy comparison (16 replicas, 50% spot"
          + (", the negative slope taken as 0" if m < 0 else "") + "):")
    rows = {}
    for pol in ("ibdash", "petrel", "lavea", "round_robin"):
        fleet = ServingFleet(im, policy=pol, n_replicas=16, seed=seed,
                             device=model.device)
        res = fleet.run(n_requests=600, arrival_window=8.0, seed=seed + 1)
        rows[pol] = (res.avg_service_time, res.prob_failure)
        print(f"         {pol:12s} avg latency {res.avg_service_time*1e3:7.1f} ms"
              f"   failure rate {res.prob_failure:6.3f}")
    return {"throughput_tok_s": n_tok / wall, "interference": (m, c, r2),
            "fleet": rows, "outputs": done}


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
