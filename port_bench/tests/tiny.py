"""Tiny sizes of every cell, for the CPU tests: a two-layer model of the
same family and shapes, short prompts, a window of about a second."""
import copy
import json
import time

import torch

from port_bench.harness import ROOT, run_cell, use_program

MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab": 512}
SERVE = {"rate_per_s": 10.0,
         "prompt": {"median": 24, "sigma": 0.5, "min": 8, "max": 48},
         "output": {"median": 8, "sigma": 0.5, "min": 4, "max": 16},
         "warmup_prompts": [8, 48], "warmup_new": 2, "drain_s": 30,
         "check": {"min_tokens": 64, "max_requests": 8},
         "trace": {"at": [0.3, 0.6], "seconds": 0.3}}
SHRINK = {
    "minitron-8b.rag": {"config": {"model": MODEL, "serve": {"max_batch": 4, "max_seq": 128}},
                        "traffic": SERVE, "limits": {"max_logit_gap": 0.02}},
    "qwen1.5-0.5b.train": {"config": {"model": dict(MODEL, n_kv_heads=4)},
                           "traffic": {"batch": 2, "seq": 16,
                                       "trace": {"at": [0.3, 0.6], "steps": 2}},
                           "limits": {"loss_gap": 2e-3, "grad_gap": 0.02, "change_gap": 0.05,
                                      "median_grad_gap": 0.01}},
}
CPU = torch.device("cpu")


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def run(cell, seed=7, seconds=1.0, trace=False, shrink=None, log=lambda _: None):
    use_program()
    return run_cell(bench(), cell, seed, seconds, trace, CPU, time.perf_counter(),
                    shrink=shrink or copy.deepcopy(SHRINK[cell]), log=log)
