"""Run one cell of the port's benchmark on the card and print its result.

    python3 -m port_bench.run --workload minitron-8b.rag --seed 7 --seconds 40 --trace 0

Run from the root of a checkout.  It drives ``repro_torch`` (``src/``) on
the CUDA card(s) the cell asks for; without them it prints no result and
exits with 2.  Earlier lines of standard output and standard error say
what happened (device, power limit, peak memory, requests, the trace's
event counts); the last line of standard output is the result, one JSON
object, with ``checks`` (each number compared beside its limit) last; the
last lines of standard error repeat those numbers.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from port_bench.harness import ROOT, jax_modules, run_cell, use_program  # noqa: E402


def log(msg: str) -> None:
    print(msg, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    use_program()
    device = torch.device("cuda", 0)
    log(f"[device] {torch.cuda.get_device_name(device)} x {torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      device, T_START, log=log)
    log(f"[device] name and power limit after the window: {power_limit()}")
    found = jax_modules()
    if found:
        print(f"the run loaded JAX or the JAX package: {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    log(f"[device] peak memory {result['device']['memory_peak_bytes']} bytes")
    for key, val in result["checks"].items():
        print(f"[check] {key} {val['value']!r} limit {val['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
