"""Find the highest rate an open-loop serving cell sustains, once, on the
card: one engine, the cell's mix at each rate for ``--seconds``, in one
process (``--max-batch`` sizes the engine's slots in place of the
configuration's).  A rate is sustained while the loop admits requests no
later at the end of the window than at its start and every request due in
the window has its first token when it closes.  Each rate's line also says
how many slots its steps kept busy and how much KV cache those held.

    python3 -m port_bench.sweep --workload minitron-8b.rag --rates 4,6,8,10 --seconds 20
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from port_bench import serving
from port_bench.harness import ROOT, Record, load_cell, use_program
from port_bench.traffic import open_loop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=4242)
    ap.add_argument("--max-batch", type=int, default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    use_program()
    device = torch.device("cuda", 0)
    with open(ROOT / "BENCHMARK.json") as f:
        cell = load_cell(json.load(f), args.workload,
                         {"config": {"serve": {"max_batch": args.max_batch}}}
                         if args.max_batch else None)
    rec = Record(cell, args.seconds)
    eng = serving.setup(rec, args.seed, device, print)
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(cell.mix, rate_per_s=rate)
        reqs = open_loop(mix, args.seconds, args.seed, rec.model["vocab"])
        loop = serving.ServeLoop(eng, reqs)
        loop.run(args.seconds, 0.0)
        served = [r for r in reqs if r.first is not None]
        late = np.asarray([r.admitted - r.due for r in served])
        half = [r.admitted - r.due for r in served if r.due < args.seconds / 2]
        last = [r.admitted - r.due for r in served if r.due >= args.seconds / 2]
        ttft = np.asarray([r.first - r.due for r in served])
        row = {"rate": rate, "due": len(reqs), "unserved": len(reqs) - len(served),
               "ttft_p50_ms": 1e3 * float(np.median(ttft)),
               "ttft_p95_ms": 1e3 * float(np.percentile(ttft, 95)),
               "late_first_half_ms": 1e3 * float(np.mean(half)) if half else None,
               "late_second_half_ms": 1e3 * float(np.mean(last)) if last else None,
               "late_max_ms": 1e3 * float(late.max()), "steps": loop.steps,
               "prefill_ms": 1e3 * float(np.mean([s.t1 - s.t0 for s in loop.spans
                                                  if s.name == "prefill"])),
               "step_ms": 1e3 * float(np.mean([s.t1 - s.t0 for s in loop.spans
                                               if s.name == "step"]))}
        row.update(serving.occupancy(rec.model, loop, args.seconds))
        print(json.dumps(row), flush=True)
        while eng.active:
            eng.step()
    return 0


if __name__ == "__main__":
    sys.exit(main())
