"""Open loop: requests arrive at their due times (``traffic.open_loop``)
whether or not earlier ones have finished.  Each request's times count from
when it was due; after the window the loop serves on until every request
due in it has its first token (at most the mix's ``drain_s``), so a request
that waited is late, not missing."""
from __future__ import annotations

import time

from .. import serving
from ..trace import Tracer
from ..traffic import open_loop

check = serving.check


def run(rec, seed, device, trace, t_start, log) -> None:
    import torch

    mix = rec.cell.mix
    log(f"[setup] imports and context {time.perf_counter() - t_start:.3f} s")
    eng = serving.setup(rec, seed, device, log)
    reqs = open_loop(mix, rec.seconds, seed, rec.model["vocab"])
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    tracer = (Tracer(mix["trace"], rec.seconds, serving.counters, sync,
                     cuda=device.type == "cuda") if trace else None)
    if tracer is not None:
        tracer.warm()
    loop = serving.ServeLoop(eng, reqs, tracer=tracer)
    rec.setup_s = time.perf_counter() - t_start
    rec.elapsed = loop.run(rec.seconds, mix["drain_s"])
    rec.requests = reqs
    rec.attempted = len(reqs)
    rec.failed = sum(r.first is None for r in reqs)
    late = sorted(r.admitted - r.due for r in reqs if r.admitted is not None)
    if late:
        log(f"[serve] {len(reqs)} requests due in {rec.seconds} s, {rec.failed} without a "
            f"first token after the drain; admitted late by median "
            f"{1e3 * late[len(late) // 2]:.1f} ms, max {1e3 * late[-1]:.1f} ms; "
            f"{loop.steps} steps, {sum(r.done is not None for r in reqs)} finished")
    occ = serving.occupancy(rec.model, loop, rec.elapsed)
    log(f"[serve] busy slots a step in the window: mean {occ['busy_mean']:.2f}, max "
        f"{occ['busy_max']} of {occ['slots']}; their KV cache mean "
        f"{occ['live_bytes_mean'] / 1e9:.3f} GB, max {occ['live_bytes_max'] / 1e9:.3f} GB, "
        f"of {occ['reserved_bytes'] / 1e9:.3f} GB reserved")
    serving.finish(rec, loop, device)
