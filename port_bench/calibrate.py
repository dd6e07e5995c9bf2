"""The readings a cell's limits are set from, on the card, in one process.

    python3 -m port_bench.calibrate --workload minitron-8b.rag --seeds 1001-1012 \\
        --seconds 15 --controls 3 [--faults 3]

For each seed it runs the cell's driver as a run does (the cell's own
load, a window of ``--seconds``) and prints one JSON line: the numbers the
check compares for the program, and on the first ``--controls`` seeds the
same numbers for the control (the reference in float8 put in the
program's place).  A training cell, on the first ``--faults`` seeds, also
runs the program with each of ``faults.TRAIN`` planted.  The last line
holds each number's lower reading (the most any seed of the program gave)
and upper readings (the least the control, and each fault, gave).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from port_bench import faults
from port_bench.harness import (ROOT, Record, driver, jax_modules, load_cell,
                                reference, use_program)


def seeds(text: str):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def one(cell, seed, seconds, device, fault=None):
    """A run's set-up and window, with ``fault`` planted if given."""
    import contextlib

    ctx = contextlib.nullcontext()
    if fault is not None:
        ctx = (faults.train_fault if cell.mix["driver"] == "train" else faults.serve_fault)(fault)
    rec = Record(cell, seconds)
    with ctx:
        driver(cell.mix["driver"]).run(rec, seed, device, False, time.perf_counter(), log)
    return rec


def serve_numbers(rec, ref, device, controls):
    from port_bench import serving

    r = serving.readings(rec, ref, device, ("fp8",) if controls else ())
    out = {"max_logit_gap": float(r["program"].max())}
    if controls:
        out["control.max_logit_gap"] = float(r["fp8"].max())
    out["checked"] = rec.state.get("checked")
    return out


def train_numbers(rec, ref, device, controls):
    from port_bench.drivers import train

    out = train.readings(rec, ref, device, "f32")
    if controls:
        out.update({f"control.{k}": v for k, v in train.readings(rec, ref, device, "fp8").items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="first-last")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: no readings", file=sys.stderr)
        return 2
    use_program()
    device = torch.device("cuda", 0)
    with open(ROOT / "BENCHMARK.json") as f:
        cell = load_cell(json.load(f), args.workload)
    ref = reference(cell.config["family"])
    numbers = train_numbers if cell.mix["driver"] == "train" else serve_numbers
    rows = []
    for i, seed in enumerate(seeds(args.seeds)):
        t = time.perf_counter()
        rec = one(cell, seed, args.seconds, device)
        row = {"seed": seed, **numbers(rec, ref, device, i < args.controls)}
        del rec
        gc.collect()
        torch.cuda.empty_cache()
        if cell.mix["driver"] == "train" and i < args.faults:
            for kind in faults.TRAIN:
                frec = one(cell, seed, args.seconds, device, kind)
                from port_bench.drivers import train

                row.update({f"{kind}.{k}": v for k, v in
                            train.readings(frec, ref, device, "f32").items()})
                del frec
                gc.collect()
                torch.cuda.empty_cache()
        row["s"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for key in rows[0]:
        vals = [r[key] for r in rows if isinstance(r.get(key), float)]
        if not vals:
            continue
        summary[key] = min(vals) if "." in key else max(vals)
    found = jax_modules()
    if found:
        print(f"JAX loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps({"lower_and_upper": summary, "seeds": len(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
