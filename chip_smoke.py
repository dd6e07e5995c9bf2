"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing the run with a non-zero exit if anything is wrong:

1. device    requires CUDA; prints the card's name and power limit.
2. build     builds every CUDA kernel from ``src/repro_torch/csrc`` for
             sm_90a in one parallel build and prints nvcc's register and
             shared-memory reports.
3. kernels   holds each kernel against its plain PyTorch version on the
             card at the main paths' shapes (the WKV kernel also under a
             strong decay; the bf16 attention, decode and WKV kernels also
             against the plain version on their inputs cast up to float32),
             and times both (and, for attention and decode,
             ``scaled_dot_product_attention`` as a yardstick); the bf16
             attention kernel at the training shape and at the dense
             prefill shape, the WKV kernel at 128, 200 and 512 tokens (a
             CUDA graph of calls, so the gaps between its three passes
             count), and the host's time a call of each; checks by the
             profiler that a call of attention or decode runs one kernel on
             the card and a WKV call three.
4. serve     serves requests through ``ServingEngine`` on full-width
             RWKV6-3B in bf16 (random weights from a seed) and checks that
             every prefill went through the WKV kernel, that the tokens are
             valid ids, and one prefill's logits against the plain WKV.
5. fit       fits ``T = m*k + c`` to decode-step latency with
             ``measure_interference``.
6. dense     serves the same requests through ``ServingEngine`` on
             full-width Minitron-8B in bf16 with a KV cache and checks that
             every prefill went through the tensor-core attention kernel and every
             decode step through the decode kernel, that the tokens are
             valid ids, one prefill's logits against the plain attention
             and a few decode steps' logits against the plain decode
             attention (in bf16 and in a float32 copy); fits
             ``T = m*k + c`` on this model and profiles one decode step.
7. train     trains full-width Qwen1.5-0.5B in bf16 through
             ``repro_torch.launch.train.train`` (B=4, S=2048, 6 steps) and
             checks that every attention layer's forward ran the tensor-core
             attention kernel, that losses and gradient norms are finite, that step
             1 agrees with the same step through the plain attention (in
             bf16 and in a float32 copy), and that a checkpoint of the final
             state restores leaf for leaf.
8. place     the IBDASH placement core through ``repro_torch.api``: the
             four float64 decision kernels and the stable queue selection
             against their plain numpy versions, bit for bit, at G=1024
             rows and D=100,000 devices (exact ties, infeasible rows, +inf
             entries), with their times; one wave on the 100,000-device
             ``multi_tier`` fleet through ``orchestrate_batch`` for each
             kernel-backed policy, equal to the same wave on the CPU and
             launching its kernels; a 10,000-device wave equal to the
             scalar ``batched=False`` path; and ``run_one`` at the paper's
             100 devices and 1000 instances a cycle (``mix`` with a fused
             burst, ``churn`` with ``replan``), equal to the same run on
             the CPU instance for instance.  Prints a ``place`` JSON line.
9. stream    the streaming service, the serving fleet and the exporters
             through ``repro_torch``, each run on the card and on the CPU
             and held equal (``==``; only the two wall-clock metrics
             ``wave_plan_s`` and ``placements_per_sec`` left out):
             ``benchmarks/bench_stream.py``'s overload point (100 devices,
             Poisson arrivals at 240/s over 45 s, queue 256, waves of 30)
             with admission and as the no-admission baseline, each equal
             to the committed ``BENCH_stream.json`` (read as a file); the
             admitted run once more traced, its attribution report,
             summary and Chrome trace equal on both devices, the trace
             valid and its instance ledger rebuilt from the JSON alone;
             the fleet comparison of the JAX ``serve_demo`` (16 replicas, 600
             requests over 8 s; ibdash, petrel, lavea, round_robin, then
             ibdash fused, behind admission and under churn with replan)
             fed by the dense phase's fit.  Every IBDASH ``decide_batch``
             pool of at least ``BATCH_KERNEL_MIN_ROWS`` rows must launch
             the queue and scan kernels once.  Prints a ``stream`` line.

The ``place`` and ``stream`` lines come before the ``kernels`` line.  The line before the
last is a JSON object with each kernel's launches on
its main path (calls of its wrapper), the kernels a call runs on the card,
its error against the plain version, its time, the plain version's time,
its bound and the library call's time; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.api import (  # noqa: E402
    Orchestrator,
    SimConfig,
    make_cluster,
    make_policy,
    make_profile,
    orchestrate_batch,
    run_one,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import batched  # noqa: E402
from repro_torch.core.policy import IBDASHPolicy  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    attribution_report,
    format_report,
    json_summary,
    ledger_from_trace,
    to_chrome_trace,
    validate_chrome_trace,
)
from repro_torch.launch.serve import fleet_interference  # noqa: E402
from repro_torch.serve.scheduler import ServingFleet  # noqa: E402
from repro_torch.stream import (  # noqa: E402
    AdmissionConfig,
    StreamingOrchestrator,
    default_streams,
    WALL_CLOCK_METRICS,
    poisson_arrivals,
    without_wall_clock,
)
from repro_torch.sim.apps import APP_BUILDERS  # noqa: E402
from repro_torch.sim.runner import policy_for  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.kernels.build import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import smem_bytes as attn_smem_bytes  # noqa: E402
from repro_torch.kernels.flash_attention import tile_plan  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode, split_plan  # noqa: E402
from repro_torch.kernels.flash_decode import smem_bytes as decode_smem_bytes  # noqa: E402
from repro_torch.kernels.ref import attention_ref, decode_attention_ref, rwkv6_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import KERNELS_PER_CALL as WKV_KERNELS_PER_CALL  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel_chunk, rwkv6_scan, smem_bytes  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.layers import torch_dtype  # noqa: E402
from repro_torch.optim.optimizers import AdamW, global_norm  # noqa: E402
from repro_torch.optim.schedules import cosine_with_warmup  # noqa: E402
from repro_torch.serve.engine import ServingEngine, measure_interference  # noqa: E402
from repro_torch.train.step import make_train_step, value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
# FP64 outside the tensor cores (same data sheet): the decision kernels' type.
F64_OPS_PER_S = 34e12

H, N = 40, 64                       # RWKV6-3B: 40 heads of size 64
KERNEL_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
# Prefill logits through the WKV kernel against the plain WKV (prefill_check):
# in float32, max |difference| within this share of max |logit| (the kernel's
# f32 error, about 1e-6 of |y|, grown through 32 layers); in bf16, RMS distance
# from the float32 plain logits within this factor of the plain bf16 path's.
LOGITS_F32_TOL = 1e-3
BF16_NOISE_FACTOR = 2.0
# The bf16 WKV kernel also against rwkv6_ref on its inputs cast up to
# float32: beyond the rounding of its bf16 y (half an ulp, at most 2^-8 of
# |y|), at most this share of max |y|, room for its products' TF32 operands
# (at most 2.4e-4 of max |y| at the kernel_phase shapes on an H100, so about
# 2x that); S_T, whose update stays in f32, within the f32 KERNEL_TOL.
WKV_BF16_UPCAST_TOL = 5e-4
SERVE_PROMPTS = (64, 128, 80, 200, 512, 16, 33, 256, 97, 20)
SERVE_NEW_TOKENS = (16, 32, 24, 20, 16, 32, 18, 28, 16, 24)

# Attention kernel against attention_ref: float32 at 1e-4 abs + rel (the
# JAX sweep's 3e-5, widened for the card's other summation order); bf16 at
# the sweep's 3e-2.
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# The bf16 attention kernel also against attention_ref on its inputs cast up
# to float32: beyond the rounding of its bf16 output (half an ulp, at most
# 2^-8 of |o|), at most ATTN_BF16_UPCAST_TOL abs, room for the rounding of P
# to bf16 (at most 2.6e-3 at the ATTN_CASES shapes on an H100, so about 2x
# that); and its RMS distance from that reference at most BF16_NOISE_FACTOR
# times the plain bf16 path's, which rounds its weights too.
BF16_HALF_ULP = 2.0 ** -8
ATTN_BF16_UPCAST_TOL = 5e-3
# (B, S, Hq, Hk, D, causal, window, dtypes): the training shape, the dense
# serving path's longest prefill (Minitron-8B's GQA heads at D=128), and a
# windowed, non-causal, ragged case at D=32
ATTN_CASES = (
    (4, 2048, 16, 16, 64, True, None, (torch.bfloat16,)),
    (1, 512, 32, 8, 128, True, None, (torch.float32, torch.bfloat16)),
    (1, 200, 4, 2, 32, False, 128, (torch.float32, torch.bfloat16)),
)
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS = "qwen1.5-0.5b", 4, 2048, 6

DENSE_ARCH, SERVE_B, SERVE_C = "minitron-8b", 8, 1024
# Decode kernel against decode_attention_ref: the attention tolerances (the
# JAX sweep's 3e-2 in bf16; its 3e-5 in f32 widened to 1e-4 for the card's
# summation order).  (B, C, Hq, Hk, D, lengths): the serving shape with the
# lengths the first eight served prompts give at their first decode step
# and with every slot valid, D=64 MHA, and MQA with a ragged C (not a
# multiple of the 64-slot tile); lengths 1 and C.
SERVE_LENGTHS = tuple(n + 1 for n in SERVE_PROMPTS[:SERVE_B])
DECODE_CASES = (
    (SERVE_B, SERVE_C, 32, 8, 128, SERVE_LENGTHS),
    (SERVE_B, SERVE_C, 32, 8, 128, (SERVE_C,) * SERVE_B),
    (4, 512, 16, 16, 64, (1, 512, 300, 77)),
    (3, 1000, 16, 1, 128, (1, 1000, 999)),
)
# the decode kernel is timed over this many layers' caches in turn, so each
# launch finds its K and V outside the 50 MB L2 as a decode step does
DECODE_TIMING_LAYERS = 16
# The bf16 decode kernel also against decode_attention_ref on its inputs cast
# up to float32 (no rounding of the weights), abs: the kernel's roundings are
# then its bf16 weights (as the plain bf16 path rounds them) and its output.
DECODE_BF16_UPCAST_TOL = 1e-2
DECODE_CHECK_STEPS = 4
# Step 1 through the attention kernel against the same step through the
# plain attention, same weights and batch: in a float32 copy, loss and
# gradient norm within this relative tolerance (the kernel's f32 error, about
# 1e-6 of |o|, grown through 24 layers and a 151936-way softmax).
TRAIN_F32_RTOL = 1e-4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` on the card over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wkv_inputs(B, T, dtype, gen, dev, strong_decay=False):
    """WKV inputs at the served model's heads; with ``strong_decay`` half the
    channels decay as w = exp(-exp(x + 2)), so the cumulative log-decay of a
    16-token sub-chunk falls below -87 and its exponential underflows in f32."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    r, k, v = randn(B, T, H, N) * 0.5, randn(B, T, H, N) * 0.5, randn(B, T, H, N)
    w = torch.exp(-torch.exp(randn(B, T, H, N) - 2.0))      # decay in (0, 1)
    if strong_decay:
        w[..., : N // 2] = torch.exp(-torch.exp(randn(B, T, H, N // 2) + 2.0))
    return dict(r=r.to(dtype), k=k.to(dtype), v=v.to(dtype), w=w,
                u=randn(H, N) * 0.2, S0=randn(B, H, N, N) * 0.1)


def wkv_cost(B: int, T: int, elem_bytes: int, chunk: int, sub: int = 16):
    """(bytes, SIMT operations, product operations) the WKV scan needs for
    these shapes, counted as the kernel splits the work: chunks of ``chunk``
    tokens, A factored over sub-chunks of ``sub``.

    Bytes: r, k, v and y in the activation dtype and w in f32, each read or
    written once; u, S0 and S_T in f32 (the kernel's per-chunk scratch not
    counted).  Per (b, h) and chunk of L valid tokens, SIMT operations
    (f32 in both instantiations): the state increment (k e^{total-cum})^T v
    and the carry S <- e^{total} S + dS; A's diagonal sub-chunk blocks
    (subtract, exp, two multiplies, add a term below the diagonal; the u
    term on it); the log, cumulative sum and decay factors.  Product
    operations (TF32 tensor cores in bf16, SIMT in f32): (r e^{cum_exc}) @ S,
    A's blocks below the diagonal sub-chunks as products of factors, and
    A @ v over i <= t.  A ragged last chunk counts its valid tokens only.
    """
    nbytes = B * T * H * N * (4 * elem_bytes + 4) + H * N * 4 + 2 * B * H * N * N * 4
    simt = prod = 0
    for t0 in range(0, T, chunk):
        L = min(chunk, T - t0)
        subs = [min(sub, L - s0) for s0 in range(0, L, sub)]
        simt += 2 * L * N * N + 2 * N * N + 3 * L * N
        simt += sum(5 * (l * (l - 1) // 2) * N + 3 * l * N for l in subs)
        prod += 2 * L * N * N + 2 * (L * (L - 1) // 2 + L) * N
        prod += sum(2 * subs[q] * subs[p] * N for q in range(len(subs)) for p in range(q))
    return nbytes, B * H * simt, B * H * prod


def wkv_bound(T: int, chunk: int):
    """``(bound ms, bound_by, line)`` of the bf16 WKV scan at B=1: the larger
    of its bytes over the memory rate and its operations over their rates,
    SIMT at the f32 peak and the products at the TF32 peak, the larger of
    the two (the pipes run side by side)."""
    nbytes, simt, prod = wkv_cost(1, T, 2, chunk)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(simt / F32_OPS_PER_S, prod / TF32_OPS_PER_S) * 1e3
    line = (f"{nbytes} bytes -> {t_bytes:.4f} ms, {simt} f32 SIMT ops -> "
            f"{simt / F32_OPS_PER_S * 1e3:.4f} ms, {prod} TF32 product ops -> "
            f"{prod / TF32_OPS_PER_S * 1e3:.4f} ms")
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", line


def pass_name(kernel: str) -> str:
    """``state``, ``carry`` or ``output`` for a WKV pass's kernel name."""
    m = re.search(r"rwkv6_(\w+?)_kernel", kernel)
    return m.group(1) if m else kernel[:60]


def kernel_phase(dev):
    """The WKV kernel against its plain version at the main path's shapes
    (the bf16 kernel also against the plain version on its inputs cast up
    to float32), then its times at 128, 200 and 512 tokens."""
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    cases = [(B, T, False) for B in (1, 8) for T in (64, 128, 80, 512)] + [(1, 512, True)]
    for B, T, strong in cases:
        for dtype in (torch.float32, torch.bfloat16):
            inp = wkv_inputs(B, T, dtype, gen, dev, strong_decay=strong)
            if strong:
                sub = float(torch.log(inp["w"][:, :16, :, : N // 2]).sum(1).min())
                check(sub < -87, f"strong decay: a sub-chunk's log-decay {sub:.1f} >= -87")
            y, s = rwkv6_scan(**inp)
            torch.cuda.synchronize()
            yr, sr = rwkv6_ref(**inp)
            tol = KERNEL_TOL[dtype]
            errs = []
            for got, want in ((y, yr), (s, sr)):
                got, want = got.float(), want.float()
                check(bool(torch.isfinite(got).all()), f"non-finite output B={B} T={T}")
                over = (got - want).abs() - (tol + tol * want.abs())
                errs.append(float((got - want).abs().max()))
                check(float(over.max()) <= 0, f"kernel disagrees B={B} T={T} {dtype}: "
                      f"max abs err {errs[-1]:.3e} beyond {tol} abs+rel")
            worst = max(worst, *errs)
            upcast = ""
            if dtype == torch.bfloat16:
                yu, su = rwkv6_ref(**{**inp, **{key: inp[key].float() for key in "rkv"}})
                scale = float(yu.abs().max())
                beyond = float(((y.float() - yu).abs() - BF16_HALF_ULP * yu.abs()).max())
                tol32 = KERNEL_TOL[torch.float32]
                s_over = float(((s - su).abs() - (tol32 + tol32 * su.abs())).max())
                case = f"B={B} T={T}{' strong decay' if strong else ''}"
                check(beyond <= WKV_BF16_UPCAST_TOL * scale,
                      f"bf16 WKV kernel {case}: y is {beyond:.3e} beyond its rounding from "
                      f"the float32 plain version, beyond {WKV_BF16_UPCAST_TOL} of max |y| "
                      f"{scale:.3f}")
                check(s_over <= 0, f"bf16 WKV kernel {case}: S_T beyond {tol32} abs+rel of "
                      f"the float32 plain version")
                upcast = (f"; against the float32 plain version on these inputs y "
                          f"{beyond:.3e} beyond 2^-8 of |y| = {beyond / scale:.3e} of max |y| "
                          f"{scale:.3f} (tol {WKV_BF16_UPCAST_TOL} of it), S_T "
                          f"{float((s - su).abs().max()):.3e} (tol {tol32} abs+rel)")
                del yu, su
            print(f"[kernels] rwkv6_scan B={B} T={T} {str(dtype)[6:]}"
                  f"{' strong decay' if strong else ''}: max abs err y {errs[0]:.3e}, "
                  f"S_T {errs[1]:.3e} (tol {tol} abs+rel){upcast}", flush=True)
    timing, chunk = {}, kernel_chunk()
    for T in (128, 200, 512):
        inp = wkv_inputs(1, T, torch.bfloat16, gen, dev)
        call = lambda: rwkv6_scan(**inp)   # noqa: E731
        per_call = kernels_per_call(call)
        check(per_call == WKV_KERNELS_PER_CALL,
              f"one rwkv6_scan call ran {per_call} kernels on the card, not "
              f"{WKV_KERNELS_PER_CALL}")
        # a call's device time, its passes and the gaps between them, with
        # the host's launch rate out of the way; and by pass
        ms = graph_ms(call, calls=20)
        passes = device_times(call, iters=50)
        by_pass = ", ".join(f"{pass_name(name)} {t:.4f} ms" for name, t in passes.items())
        plain_ms = time_ms(lambda: rwkv6_ref(**inp), iters=3, warmup=1)
        bound, bound_by, cost = wkv_bound(T, chunk)
        us = host_us(call, ATTN_HOST_CALLS)
        timing[T] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, host_us=us,
                         bound_by=bound_by, kernels_per_call=per_call)
        print(f"[kernels] rwkv6_scan B=1 T={T} H={H} N={N} bf16, {per_call} kernels on the "
              f"card a call: {ms:.4f} ms a call (CUDA graph of 20 calls, by CUDA events; "
              f"kernel time by pass: {by_pass}; gaps {ms - sum(passes.values()):.4f} ms), "
              f"host {us:.2f} us a call; plain version {plain_ms:.3f} ms; bound {bound:.4f} ms "
              f"({cost}; counted at the kernel's {chunk}-token chunks), "
              f"{100 * bound / ms:.1f}% of bound", flush=True)
    return worst, timing


def serve_requests_for(cfg):
    """The served requests: prompts of SERVE_PROMPTS tokens drawn from seed
    0 over the model's vocabulary, SERVE_NEW_TOKENS new tokens each."""
    rng = np.random.default_rng(0)
    return [(f"req{i}", rng.integers(0, cfg.vocab, n).tolist(), m)
            for i, (n, m) in enumerate(zip(SERVE_PROMPTS, SERVE_NEW_TOKENS))]


def serve(engine, requests):
    """Admit requests as slots free up and step until all have finished,
    each prefill and step timed on the host clock after a synchronise.
    Returns ``(done, prefill seconds, step seconds, wall seconds)``."""
    pending, done = list(requests), {}
    prefill_s, step_s = [], []
    t_start = time.perf_counter()
    while len(done) < len(requests):
        while pending and engine.free_slots():
            t = time.perf_counter()
            engine.add_request(*pending.pop(0))
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        done.update(engine.step())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    return done, prefill_s, step_s, time.perf_counter() - t_start


def report_serve(tag, cfg, requests, done, prefill_s, step_s, wall):
    """Check that every request got its tokens, each a valid id, and print
    the served set's times."""
    for rid, prompt, n_new in requests:
        toks = done[rid]
        check(len(toks) == n_new + 1, f"{rid}: {len(toks)} tokens, wanted {n_new + 1}")
        check(all(0 <= t < cfg.vocab for t in toks), f"{rid}: token id out of range")
    n_tok = sum(len(t) for t in done.values())
    print(f"[{tag}] {len(requests)} requests (prompts {list(SERVE_PROMPTS)}), "
          f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s, "
          f"{len(step_s)} decode steps at batch 8", flush=True)
    print(f"[{tag}] prefill ms per request: median {1e3 * np.median(prefill_s):.2f}, "
          f"by prompt length (in order, the first one cold) "
          f"{[(n, round(1e3 * x, 2)) for n, x in zip(SERVE_PROMPTS, prefill_s)]}", flush=True)
    print(f"[{tag}] decode step ms: median {1e3 * np.median(step_s):.2f}, "
          f"min {1e3 * min(step_s):.2f}, max {1e3 * max(step_s):.2f}", flush=True)


def serve_phase(dev):
    cfg = get_config("rwkv6-3b")
    model = LM(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.recurrent.head_size}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.dtype}; {n_params} parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)

    requests = serve_requests_for(cfg)
    engine = ServingEngine(model, params, max_batch=8, max_seq=1024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    rwkv6_scan.launches = 0
    done, prefill_s, step_s, wall = serve(engine, requests)
    launches = rwkv6_scan.launches

    check(launches == cfg.n_layers * len(requests),
          f"rwkv6_scan launched {launches} times for {len(requests)} prefills "
          f"of {cfg.n_layers} layers")
    report_serve("serve", cfg, requests, done, prefill_s, step_s, wall)
    print(f"[serve] rwkv6_scan launches {launches} = {cfg.n_layers} layers x "
          f"{len(requests)} prefills; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    rid, prompt, _ = requests[3]
    lg = prefill_check("serve", model, params, prompt, "WKV kernel vs plain WKV",
                       mix_fn=rwkv6_ref)
    check(int(lg.argmax()) == done[rid][0], "prefill is not deterministic")
    longest = max(requests, key=lambda req: len(req[1]))
    engine = ServingEngine(model, params, max_batch=8, max_seq=1024)
    engine.add_request(*longest)
    profile_report("serve", lambda: engine.add_request(f"{longest[0]}-again", *longest[1:]))
    del engine
    return model, params, launches


def hold_logits(tag, what, kern16, plain16, kern32, plain32):
    """A kernel path's logits held against the plain path's, in float32 and
    in bf16.

    In float32 (the same weights cast up) the two must agree to
    LOGITS_F32_TOL of max |logit|.  In bf16 both paths round every
    activation, and 32 layers of random weights amplify a one-ulp difference
    into visible logit differences, so the kernel's bf16 logits are held
    against the float32 plain logits: their RMS distance may be at most
    BF16_NOISE_FACTOR times the plain bf16 path's own RMS distance from
    them."""
    for name, lg in (("bf16", kern16), ("float32", kern32)):
        check(bool(torch.isfinite(lg).all()), f"non-finite {name} logits: {what}")

    def rms(a, b):
        return float((a - b).square().mean().sqrt())

    def agree(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())

    scale32 = float(plain32.abs().max())
    err32 = float((kern32 - plain32).abs().max())
    rms_kern, rms_plain = rms(kern16, plain32), rms(plain16, plain32)
    print(f"[{tag}] {what}: float32 max abs diff {err32:.4e} (max |logit| {scale32:.4f}, "
          f"tol {LOGITS_F32_TOL} of it); bf16 max abs diff "
          f"{float((kern16 - plain16).abs().max()):.4e}; RMS from float32 plain: kernel bf16 "
          f"{rms_kern:.4e}, plain bf16 {rms_plain:.4e} (tol {BF16_NOISE_FACTOR}x); greedy "
          f"tokens of kernel bf16 agree with plain bf16 {agree(kern16, plain16):.3f}, with "
          f"plain float32 {agree(kern16, plain32):.3f}", flush=True)
    check(err32 <= LOGITS_F32_TOL * scale32,
          f"float32 logits differ by {err32:.4e}, beyond {LOGITS_F32_TOL} x {scale32:.4f}: {what}")
    check(rms_kern <= BF16_NOISE_FACTOR * rms_plain,
          f"bf16 logits are {rms_kern:.4e} RMS from float32, beyond {BF16_NOISE_FACTOR} x "
          f"the plain path's {rms_plain:.4e}: {what}")


def prefill_check(tag, model, params, prompt, what, **plain):
    """One prompt's prefill logits through the kernels, held against the
    same prefill through the plain versions that ``plain`` hands to ``LM``
    (``mix_fn=rwkv6_ref``, ``attn_fn=attention_ref``) by ``hold_logits``.
    Returns the kernels' bf16 logits."""
    cfg, dev = model.cfg, model.device
    tokens = torch.tensor([prompt], device=dev)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _tree_map(lambda t: t.float(), params)

    def prefill(c, p, hooks):
        m = LM(c, device=dev, **hooks)
        with torch.inference_mode():
            lg, _ = m.prefill(p, {"tokens": tokens}, m.init_cache(1, len(prompt)))
        return lg.float()

    kern16, plain16 = prefill(cfg, params, {}), prefill(cfg, params, plain)
    kern32, plain32 = prefill(cfg32, params32, {}), prefill(cfg32, params32, plain)
    del params32
    torch.cuda.empty_cache()
    hold_logits(tag, f"prefill logits, {len(prompt)} tokens, {what}",
                kern16, plain16, kern32, plain32)
    return kern16


def fit_phase(tag, model, params, prefill_kernels=(), step_kernels=()):
    """Fit ``T = m*k + c`` with ``measure_interference`` and check that each
    probe prefill launched every kernel of ``prefill_kernels`` and each
    probe step every kernel of ``step_kernels``, once a layer."""
    sizes, warmup, iters = (1, 2, 4, 8), 3, 10
    for kern in (*prefill_kernels, *step_kernels):
        kern.launches = 0
    m, c, r2, samples = measure_interference(
        model, params, batch_sizes=sizes, max_seq=SERVE_C, iters=iters, warmup=warmup)
    n = model.cfg.n_layers
    for kern, calls, what in ([(k, sum(sizes), "probe prefills") for k in prefill_kernels]
                              + [(k, len(sizes) * (warmup + iters), "probe steps")
                                 for k in step_kernels]):
        check(kern.launches == n * calls,
              f"{kern.__name__} launched {kern.launches} times for {calls} {what}")
    check(bool(np.isfinite([m, c, r2]).all()), "non-finite interference fit")
    print(f"[{tag}] decode-step latency T = m*k + c: m={m * 1e3:.4f} ms/seq, "
          f"c={c * 1e3:.4f} ms, R^2={r2:.4f}", flush=True)
    for k, dt in samples:
        print(f"[{tag}]   k={k}: {dt * 1e3:.3f} ms (fit {(m * k + c) * 1e3:.3f} ms)", flush=True)
    return m, c, r2


def dense_phase(dev):
    """Serve the requests on full-width Minitron-8B with a KV cache; then the
    prefill and decode checks, the interference fit and a profiled decode
    step on the same model.  Returns the decode kernel's launches in the
    served set and the fit ``(m, c, r2)``."""
    cfg = get_config(DENSE_ARCH)
    model = LM(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[dense] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim} ({cfg.n_kv_heads} kv), d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.dtype}; {n_params} parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)

    requests = serve_requests_for(cfg)
    engine = ServingEngine(model, params, max_batch=SERVE_B, max_seq=SERVE_C)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    flash_attention.launches = flash_decode.launches = rwkv6_scan.launches = 0
    flash_attention.wgmma_launches = flash_attention.simt_launches = 0
    done, prefill_s, step_s, wall = serve(engine, requests)
    attn_launches, launches = flash_attention.launches, flash_decode.launches
    peak = torch.cuda.max_memory_allocated()

    check(attn_launches == cfg.n_layers * len(requests),
          f"flash_attention launched {attn_launches} times for {len(requests)} prefills "
          f"of {cfg.n_layers} layers")
    check(flash_attention.wgmma_launches == attn_launches and flash_attention.simt_launches == 0,
          f"of {attn_launches} bf16 attention launches {flash_attention.wgmma_launches} went "
          f"through the tensor-core kernel, {flash_attention.simt_launches} the SIMT kernel")
    check(launches == cfg.n_layers * len(step_s),
          f"flash_decode launched {launches} times for {len(step_s)} decode steps "
          f"of {cfg.n_layers} layers")
    check(rwkv6_scan.launches == 0, "the dense serving path launched the WKV kernel")
    report_serve("dense", cfg, requests, done, prefill_s, step_s, wall)
    print(f"[dense] flash_attention launches {attn_launches} = {cfg.n_layers} layers x "
          f"{len(requests)} prefills, all through the tensor-core kernel; flash_decode launches {launches} = {cfg.n_layers} "
          f"layers x {len(step_s)} decode steps; peak memory {peak / 2**30:.2f} GiB", flush=True)
    del engine
    torch.cuda.empty_cache()

    rid, prompt, _ = requests[4]
    lg = prefill_check("dense", model, params, prompt,
                       "attention kernel vs plain attention", attn_fn=attention_ref)
    check(int(lg.argmax()) == done[rid][0], "prefill is not deterministic")
    decode_check(model, params, requests, done)
    fit = fit_phase("dense", model, params, (flash_attention,), (flash_decode,))
    engine = ServingEngine(model, params, max_batch=SERVE_B, max_seq=SERVE_C)
    for req in requests[:SERVE_B]:
        engine.add_request(*req)
    engine.step()
    profile_report("dense", engine.step)
    return launches, fit


def decode_check(model, params, requests, done):
    """A few decode steps from one prefilled cache through the decode kernel,
    held against the same steps through the plain decode attention.

    The first SERVE_B requests are prefilled into one engine; from a copy
    of its cache each path runs DECODE_CHECK_STEPS steps on the same tokens
    (the prefill's greedy tokens, then tokens drawn from a seed), held by
    ``hold_logits`` with the float32 paths' weights and cache cast up."""
    cfg, dev = model.cfg, model.device
    engine = ServingEngine(model, params, max_batch=SERVE_B, max_seq=SERVE_C)
    for req in requests[:SERVE_B]:
        engine.add_request(*req)
    check(engine.tokens.tolist() == [done[rid][0] for rid, _, _ in requests[:SERVE_B]],
          "prefill is not deterministic")
    rng = np.random.default_rng(3)
    feed = [engine.tokens.clone()] + [
        torch.as_tensor(rng.integers(0, cfg.vocab, SERVE_B), device=dev)
        for _ in range(DECODE_CHECK_STEPS - 1)]
    pos0, caches0 = engine.pos.clone(), engine.caches
    del engine

    def decode(c, p, decode_fn):
        m = LM(c, device=dev, decode_fn=decode_fn)
        dt = torch_dtype(c.dtype)
        caches = _tree_map(lambda t: t.to(dt, copy=True) if t.is_floating_point()
                           else t.clone(), caches0)
        out = []
        with torch.inference_mode():
            for t in range(DECODE_CHECK_STEPS):
                lg, caches = m.decode_step(p, feed[t], pos0 + t, caches)
                out.append(lg.float())
        return torch.stack(out)

    kern16, plain16 = decode(cfg, params, None), decode(cfg, params, decode_attention_ref)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _tree_map(lambda t: t.float(), params)
    kern32 = decode(cfg32, params32, None)
    plain32 = decode(cfg32, params32, decode_attention_ref)
    del params32, caches0
    torch.cuda.empty_cache()
    hold_logits("dense", f"decode logits, {DECODE_CHECK_STEPS} steps at batch {SERVE_B}, "
                "decode kernel vs plain decode attention", kern16, plain16, kern32, plain32)


def attention_cost(B, S, Hq, Hk, D, elem_bytes, causal=True, window=None):
    """(bytes, operations) attention needs for these shapes: q, k, v read
    and o written once; 4*D operations (a multiply and an add in q.k and in
    p.v) for each (query, key) pair the masks let in, counted exactly."""
    i = np.arange(S)
    hi = i + 1 if causal else np.full(S, S)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(S, dtype=int)
    pairs = int((hi - lo).sum()) * B * Hq
    nbytes = (2 * B * S * Hq * D + 2 * B * S * Hk * D) * elem_bytes
    return nbytes, 4 * D * pairs


# The attention kernel is timed at the training shape and at the dense
# serving path's longest prefill (Minitron-8B's GQA heads), the latter over
# this many copies of its inputs in turn so each launch finds them outside
# the 50 MB L2, as a prefill does (the training shape's 67 MB exceed L2).
# The training shape is timed by CUDA events over back-to-back launches; the
# dense prefill shape, whose kernel takes less time than a call takes on the
# host, by the device time torch.profiler sees (device_ms).
ATTN_TIMED = (("train", TRAIN_B, TRAIN_S, 16, 16, 64, 1, "events"),
              ("dense prefill", 1, 512, 32, 8, 128, 8, "device"))
# the host's time per call is measured over this many back-to-back calls
ATTN_HOST_CALLS = 200


def host_us(fn, calls: int) -> float:
    """The host's time per call of ``fn`` over ``calls`` back-to-back calls,
    not waiting for the card (the launch queue holds them all)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def attention_phase(dev):
    """The attention kernel against attention_ref, then its times at the
    training shape and the dense prefill shape beside the plain version's
    and the library call's, and the host's time per call at the dense
    prefill shape.  Returns the worst error and ``{shape name: timing}``."""
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for B, S, Hq, Hk, D, causal, window, dtypes in ATTN_CASES:
        for dtype in dtypes:
            q = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(dtype)
            k = torch.randn((B, S, Hk, D), generator=gen, device=dev).to(dtype)
            v = torch.randn((B, S, Hk, D), generator=gen, device=dev).to(dtype)
            out = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            ref = attention_ref(q, k, v, causal=causal, window=window)
            got, want = out.float(), ref.float()
            check(bool(torch.isfinite(got).all()), f"non-finite attention output S={S}")
            tol = ATTN_TOL[dtype]
            err = float((got - want).abs().max())
            over = float(((got - want).abs() - (tol + tol * want.abs())).max())
            check(over <= 0, f"attention kernel disagrees B={B} S={S} Hq={Hq} Hk={Hk} D={D} "
                  f"causal={causal} window={window} {dtype}: max abs err {err:.3e} "
                  f"beyond {tol} abs+rel")
            worst = max(worst, err)
            upcast = ""
            if dtype == torch.bfloat16:
                up = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                   window=window)
                beyond = float(((got - up).abs() - BF16_HALF_ULP * up.abs()).max())
                rms_kern = float((got - up).square().mean().sqrt())
                rms_plain = float((want - up).square().mean().sqrt())
                case = f"B={B} S={S} Hq={Hq} Hk={Hk} D={D} causal={causal} window={window}"
                check(beyond <= ATTN_BF16_UPCAST_TOL,
                      f"bf16 attention kernel {case} is {beyond:.3e} beyond its output's "
                      f"rounding from the float32 plain version, beyond {ATTN_BF16_UPCAST_TOL}")
                check(rms_kern <= BF16_NOISE_FACTOR * rms_plain,
                      f"bf16 attention kernel {case}: RMS distance {rms_kern:.3e} from the "
                      f"float32 plain version, beyond {BF16_NOISE_FACTOR}x the plain bf16 "
                      f"path's {rms_plain:.3e}")
                upcast = (f"; against the float32 plain version on these inputs "
                          f"{beyond:.3e} beyond 2^-8 of |o| (tol {ATTN_BF16_UPCAST_TOL} abs), "
                          f"RMS {rms_kern:.3e} vs the plain bf16 path's {rms_plain:.3e} "
                          f"(tol {BF16_NOISE_FACTOR}x)")
                del up
            print(f"[kernels] flash_attention B={B} S={S} Hq={Hq} Hk={Hk} D={D} "
                  f"causal={causal} window={window} {str(dtype)[6:]}: max abs err "
                  f"{err:.3e} (tol {tol} abs+rel){upcast}", flush=True)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    timing = {}
    for name, B, S, Hq, Hk, D, n, clock in ATTN_TIMED:
        q, k, v = (torch.randn((n, B, S, H_, D), generator=gen, device=dev).to(torch.bfloat16)
                   for H_ in (Hq, Hk, Hk))
        qt, kt, vt = (t.transpose(2, 3).contiguous() for t in (q, k, v))   # (n, B, H, S, D)
        timer = time_ms if clock == "events" else device_ms
        iters = 20 * n
        per_call = kernels_per_call(lambda: flash_attention(q[0], k[0], v[0], causal=True))
        check(per_call == 1, f"one flash_attention call ran {per_call} kernels on the card")
        ms = timer(layers(lambda i: flash_attention(q[i], k[i], v[i], causal=True), n), iters)
        plain_ms = timer(layers(lambda i: attention_ref(q[i], k[i], v[i], causal=True), n),
                         iters=3, warmup=1)
        library_ms = timer(layers(lambda i: sdpa(qt[i], kt[i], vt[i], is_causal=True,
                                                 enable_gqa=Hq != Hk), n), iters)
        lib_err = float((sdpa(qt[0], kt[0], vt[0], is_causal=True, enable_gqa=Hq != Hk)
                         .transpose(1, 2).float()
                         - attention_ref(q[0], k[0], v[0], causal=True).float()).abs().max())
        nbytes, ops = attention_cost(B, S, Hq, Hk, D, 2)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        plan = tile_plan(B, S, Hq, Hk)
        timing[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                            bound_by="bytes" if t_bytes >= t_ops else "operations",
                            kernels_per_call=per_call)
        print(f"[kernels] flash_attention {name} shape B={B} S={S} Hq={Hq} Hk={Hk} D={D} "
              f"causal bf16, {per_call} kernel on the card a call, {clock} time ({plan['blocks']} blocks of {plan['tokens_per_block']} tokens x "
              f"{plan['heads_per_block']} heads): {ms:.4f} ms; "
              f"plain version {plain_ms:.3f} ms; scaled_dot_product_attention "
              f"{library_ms:.4f} ms (max abs diff from the plain version {lib_err:.3e}); bound "
              f"{bound:.4f} ms ({nbytes} bytes -> {t_bytes:.4f} ms, {ops} bf16 ops -> "
              f"{t_ops:.4f} ms), {100 * bound / ms:.2f}% of bound; {ops / ms / 1e9:.1f} TFLOP/s",
              flush=True)
        if name == "dense prefill":
            # the bf16 call encodes three tensor maps on the host; the f32 call
            # of the same shape encodes none
            host = {}
            for dtype in (torch.bfloat16, torch.float32):
                q1, k1, v1 = (t[0].to(dtype) for t in (q, k, v))
                host[dtype] = host_us(lambda: flash_attention(q1, k1, v1, causal=True),
                                      ATTN_HOST_CALLS)
            bf16_us, f32_us = host[torch.bfloat16], host[torch.float32]
            print(f"[kernels] flash_attention {name} shape, host time per call over "
                  f"{ATTN_HOST_CALLS} back-to-back calls: bf16 {bf16_us:.2f} us, f32 "
                  f"{f32_us:.2f} us (the bf16 call's tensor maps and alignment check "
                  f"{bf16_us - f32_us:.2f} us)", flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return worst, timing


def ptxas_report(report):
    """``(kernel, registers, spill stores, spill loads)`` for each entry
    function in an ``nvcc -Xptxas -v`` report, names demangled where
    ``c++filt`` is present."""
    rows, name, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
        rows = [(n.replace("(anonymous namespace)::", ""), *r[1:])
                for n, r in zip(names, rows)]
    except (OSError, subprocess.SubprocessError):
        pass
    return rows


def layers(fn, n):
    """A call that runs ``fn(0)``, ``fn(1)``, ..., ``fn(n-1)``, ``fn(0)``, ...
    on successive calls."""
    i = itertools.count()
    return lambda: fn(next(i) % n)


def decode_cost(B, Hq, Hk, D, lengths, elem_bytes):
    """(bytes, operations) decode attention needs for these inputs: q read
    and o written once, k and v read once up to each row's length, the
    lengths themselves; 4*D operations (a multiply and an add in q.k and in
    p.v) for each (query head, valid slot) pair."""
    n = int(sum(lengths))
    nbytes = (2 * B * Hq * D + 2 * n * Hk * D) * elem_bytes + 4 * B
    return nbytes, 4 * D * Hq * n


def device_times(fn, iters: int, warmup: int = 3) -> dict:
    """Device time of ``fn`` per call by kernel name, in ms: the card's
    kernel times over ``iters`` calls under torch.profiler, over ``iters``.
    Gaps between kernels, which the host's launch rate sets for calls this
    short, are not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / iters / 1e3
    check(sum(by_name.values()) > 0, "the profiler saw no device time")
    return by_name


def kernels_per_call(fn) -> int:
    """The kernels one call of ``fn`` runs on the card, by torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def graph_ms(fn, calls: int, replays: int = 10) -> float:
    """Device time of ``fn`` per call with the host out of the way: ``calls``
    calls captured in one CUDA graph, its replays timed by CUDA events.  The
    gaps between dependent kernels count; the host's launch rate does not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, replays) / calls
    del graph
    return ms


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time of ``fn`` per call, all its kernels summed (``device_times``)."""
    return sum(device_times(fn, iters, warmup).values())


def decode_phase(dev):
    """The decode kernel against decode_attention_ref, then its device time
    at the serving shape beside the plain version's and the library call's,
    each over DECODE_TIMING_LAYERS layers' caches in turn."""
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
    for B, C, Hq, Hk, D, lengths in DECODE_CASES:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dtype)
            k = torch.randn((B, C, Hk, D), generator=gen, device=dev).to(dtype)
            v = torch.randn((B, C, Hk, D), generator=gen, device=dev).to(dtype)
            out = flash_decode(q, k, v, lens)
            torch.cuda.synchronize()
            got, want = out.float(), decode_attention_ref(q, k, v, lens).float()
            check(bool(torch.isfinite(got).all()), f"non-finite decode output C={C}")
            tol = ATTN_TOL[dtype]
            err = float((got - want).abs().max())
            over = float(((got - want).abs() - (tol + tol * want.abs())).max())
            check(over <= 0, f"decode kernel disagrees B={B} C={C} Hq={Hq} Hk={Hk} D={D} "
                  f"lengths={list(lengths)} {dtype}: max abs err {err:.3e} beyond {tol} abs+rel")
            worst = max(worst, err)
            upcast = ""
            if dtype == torch.bfloat16:
                up = decode_attention_ref(q.float(), k.float(), v.float(), lens)
                err_up = float((got - up).abs().max())
                check(err_up <= DECODE_BF16_UPCAST_TOL,
                      f"bf16 decode kernel B={B} C={C} Hq={Hq} Hk={Hk} D={D} is {err_up:.3e} "
                      f"from the float32 plain version on its inputs, beyond "
                      f"{DECODE_BF16_UPCAST_TOL}")
                upcast = (f"; against the float32 plain version on these inputs {err_up:.3e} "
                          f"(tol {DECODE_BF16_UPCAST_TOL} abs)")
            print(f"[kernels] flash_decode B={B} C={C} Hq={Hq} Hk={Hk} D={D} lengths "
                  f"{list(lengths)} {str(dtype)[6:]}: max abs err {err:.3e} "
                  f"(tol {tol} abs+rel){upcast}", flush=True)

    B, C, Hq, Hk, D, L = SERVE_B, SERVE_C, 32, 8, 128, DECODE_TIMING_LAYERS
    bf16 = torch.bfloat16
    q = torch.randn((L, B, Hq, D), generator=gen, device=dev).to(bf16)
    k = torch.randn((L, B, C, Hk, D), generator=gen, device=dev).to(bf16)
    v = torch.randn((L, B, C, Hk, D), generator=gen, device=dev).to(bf16)
    kt, vt = (t.transpose(2, 3).contiguous() for t in (k, v))        # (L, B, Hk, C, D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timing = {}
    for name, lengths in (("served", SERVE_LENGTHS), ("full", (C,) * B)):
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        mask = (torch.arange(C, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        lib = sdpa(q[0][:, :, None], kt[0], vt[0], attn_mask=mask, enable_gqa=True)[:, :, 0]
        lib_err = float((lib.float() - decode_attention_ref(q[0], k[0], v[0], lens).float())
                        .abs().max())

        ms = device_ms(layers(lambda i: flash_decode(q[i], k[i], v[i], lens), L), 4 * L)
        plain_ms = device_ms(layers(lambda i: decode_attention_ref(q[i], k[i], v[i], lens), L),
                             L)
        library_ms = device_ms(layers(lambda i: sdpa(q[i][:, :, None], kt[i], vt[i],
                                                      attn_mask=mask, enable_gqa=True), L), 4 * L)
        nbytes, ops = decode_cost(B, Hq, Hk, D, lengths, 2)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        timing[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                            bound_by="bytes" if t_bytes >= t_ops else "operations")
        if name == "served":
            # one kernel on the card a call, and the host's time a call
            per_call = kernels_per_call(lambda: flash_decode(q[0], k[0], v[0], lens))
            check(per_call == 1, f"one flash_decode call ran {per_call} kernels on the card")
            timing["kernels_per_call"] = per_call
            timing["host_us"] = host_us(lambda: flash_decode(q[0], k[0], v[0], lens),
                                        ATTN_HOST_CALLS)
            print(f"[kernels] flash_decode {per_call} kernel on the card a call; host time per "
                  f"call over {ATTN_HOST_CALLS} back-to-back calls {timing['host_us']:.2f} us",
                  flush=True)
        print(f"[kernels] flash_decode B={B} C={C} Hq={Hq} Hk={Hk} D={D} bf16, lengths "
              f"{name} (sum {sum(lengths)}), (split_keys, nsplit) "
              f"{split_plan(B, Hk, C, torch.cuda.get_device_properties(0).multi_processor_count)}"
              f": device {ms:.4f} ms a launch; plain version {plain_ms:.4f} ms; "
              f"scaled_dot_product_attention {library_ms:.4f} ms (max abs diff from the plain "
              f"version {lib_err:.3e}); bound {bound:.4f} ms ({nbytes} bytes -> "
              f"{t_bytes:.4f} ms, {ops} bf16 ops -> {t_ops:.4f} ms), {100 * bound / ms:.1f}% "
              f"of bound", flush=True)
    del q, k, v, kt, vt
    torch.cuda.empty_cache()
    return worst, timing


def plain_attention(q, k, v, causal=True, window=None):
    """attention_ref, recomputed in the backward pass rather than keeping
    its (B, H, S, S) weights for all 24 layers: the same function and
    gradient, in the memory the kernel's path takes."""
    return checkpoint(attention_ref, q, k, v, use_reentrant=False,
                      causal=causal, window=window)


def step_one(cfg, dev, attn_fn, f32=False):
    """Loss and gradient norm of the first training step of ``train()``
    (bf16 weights from seed 0, the stream's first batch) through ``attn_fn``
    (None: the kernel), in bf16 or in a float32 copy of the same weights."""
    params = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32")
        params = tree_map(lambda t: t.float(), params)
    batch = to_device(next(iter(SyntheticLM(cfg.vocab, TRAIN_B, TRAIN_S, seed=0))), dev)
    loss, _, grads = value_and_grad(LM(cfg, device=dev, attn_fn=attn_fn), params, batch)
    gnorm = float(global_norm(grads))
    del params, grads
    torch.cuda.empty_cache()
    return float(loss), gnorm


# kernel-name fragments of the profile's groups, first match wins
PROFILE_GROUPS = (
    ("attention kernel", ("flash_attention_",)),
    ("decode kernel", ("flash_decode",)),
    ("WKV kernel", ("rwkv6_",)),
    ("matrix products", ("gemm", "xmma", "nvjet", "cutlass", "Kernel2")),
    ("softmax", ("softmax",)),
    ("reductions", ("reduce",)),
    ("copies and casts", ("copy", "Memcpy", "Memset", "cat", "index")),
)


def profile_report(tag, fn):
    """Run ``fn`` once under torch.profiler and print device time by kernel
    group and the top kernels, and the device's busy share of the call (the
    union of kernel intervals over the call's host-clock time, which the
    profiler itself lengthens)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"[{tag}] profile: the profiler saw no device time", flush=True)
        return
    by_name, spans = {}, []
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    total = sum(by_name.values())
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["other elementwise"] = 0.0
    for name, us in by_name.items():
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)),
                     "other elementwise")
        groups[group] += us
    print(f"[{tag}] profile: {wall_us / 1e3:.2f} ms on the host clock under the "
          f"profiler, {len(kernels)} device events, device busy {busy / 1e3:.2f} ms "
          f"({100 * busy / wall_us:.1f}%), kernel time {total / 1e3:.2f} ms", flush=True)
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        if us > 0:
            print(f"[{tag}]   {group}: {us / 1e3:.2f} ms ({100 * us / total:.1f}%)", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[{tag}]   kernel {us / 1e3:9.3f} ms  {name[:110]}", flush=True)


def profile_step(cfg, dev, params, opt_state):
    """One more training step, under torch.profiler."""
    step = make_train_step(LM(cfg, device=dev),
                           AdamW(lr=cosine_with_warmup(3e-3, 1, TRAIN_STEPS)))
    batch = to_device(next(iter(SyntheticLM(cfg.vocab, TRAIN_B, TRAIN_S, seed=1))), dev)
    profile_report("train", lambda: step(params, opt_state, batch))


def train_phase(dev):
    cfg = get_config(TRAIN_ARCH)
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim} ({cfg.n_kv_heads} kv), d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.dtype}; B={TRAIN_B} S={TRAIN_S}, {TRAIN_STEPS} steps",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        flash_attention.launches = rwkv6_scan.launches = 0
        flash_attention.wgmma_launches = flash_attention.simt_launches = 0
        out = train(TRAIN_ARCH, use_reduced=False, steps=TRAIN_STEPS, batch=TRAIN_B,
                    seq=TRAIN_S, ckpt_dirs=[str(Path(tmp) / "run")], log_every=1,
                    device=dev)
        launches = flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        check(launches == cfg.n_layers * TRAIN_STEPS,
              f"flash_attention launched {launches} times for {TRAIN_STEPS} forward "
              f"passes of {cfg.n_layers} layers")
        check(flash_attention.wgmma_launches == launches and flash_attention.simt_launches == 0,
              f"of {launches} bf16 attention launches {flash_attention.wgmma_launches} went "
              f"through the tensor-core kernel, {flash_attention.simt_launches} the SIMT kernel")
        check(rwkv6_scan.launches == 0, "the training path launched the WKV kernel")
        check(bool(np.isfinite(out["losses"]).all() and np.isfinite(out["grad_norms"]).all()),
              f"non-finite loss or gradient norm: {out['losses']} {out['grad_norms']}")
        n_params = sum(t.numel() for t in tree_leaves(out["params"]))
        print(f"[train] {n_params} parameters", flush=True)
        step_ms = 1e3 * np.asarray(out["step_s"])
        print(f"[train] losses {[round(x, 5) for x in out['losses']]}; gradient norms "
              f"{[round(x, 5) for x in out['grad_norms']]}", flush=True)
        print(f"[train] step ms {[round(float(x), 2) for x in step_ms]} (the first cold): "
              f"median {np.median(step_ms):.2f}, min {step_ms.min():.2f}, "
              f"max {step_ms.max():.2f}; {TRAIN_B * TRAIN_S / np.median(step_ms) * 1e3:.1f} "
              f"tokens/s at the median; peak memory {peak / 2**30:.2f} GiB; "
              f"flash_attention launches {launches} = {cfg.n_layers} layers x "
              f"{TRAIN_STEPS} forward passes, all through the tensor-core kernel", flush=True)

        profile_step(cfg, dev, out["params"], out["opt_state"])
        state = (out["params"], out["opt_state"])
        mgr = CheckpointManager(replica_dirs=[str(Path(tmp) / "final")])
        t = time.perf_counter()
        mgr.save(state, TRAIN_STEPS)
        back, step, _ = mgr.restore(state)
        same = all(torch.equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(tree_leaves(back), tree_leaves(state)))
        n_leaves = len(tree_leaves(state))
        check(step == TRAIN_STEPS and same, "the restored checkpoint differs from the state")
        print(f"[train] checkpoint of the final state ({n_leaves} leaves, "
              f"{sum(x.numel() * x.element_size() for x in tree_leaves(state)) / 2**30:.2f} GiB) "
              f"saved and restored leaf for leaf equal in {time.perf_counter() - t:.1f} s",
              flush=True)
        kern16 = (out["losses"][0], out["grad_norms"][0])
        del out, state, back
        torch.cuda.empty_cache()

    step1_check(cfg, dev, kern16)
    return launches, peak


def step1_check(cfg, dev, kern16):
    """Step 1 through the kernel against the plain attention, same weights
    and batch.  In a float32 copy: loss and gradient norm within
    TRAIN_F32_RTOL.  In bf16 both paths round every activation, so the
    kernel's bf16 step is held against the float32 plain step: its distance
    may be at most BF16_NOISE_FACTOR times the plain bf16 step's own
    distance, or 2^-9 (half a bf16 ulp) of the value, whichever is larger."""
    plain16 = step_one(cfg, dev, plain_attention)
    kern32 = step_one(cfg, dev, None, f32=True)
    plain32 = step_one(cfg, dev, plain_attention, f32=True)
    for i, name in enumerate(("loss", "gradient norm")):
        ref = plain32[i]
        err32 = abs(kern32[i] - ref)
        d_kern, d_plain = abs(kern16[i] - ref), abs(plain16[i] - ref)
        allowed = max(BF16_NOISE_FACTOR * d_plain, 2.0 ** -9 * abs(ref))
        print(f"[train] step 1 {name}: kernel bf16 {kern16[i]:.6f}, plain bf16 "
              f"{plain16[i]:.6f}, kernel f32 {kern32[i]:.6f}, plain f32 {ref:.6f}; f32 "
              f"rel diff {err32 / abs(ref):.3e} (tol {TRAIN_F32_RTOL}); bf16 distance from "
              f"plain f32: kernel {d_kern:.3e}, plain {d_plain:.3e} (allowed {allowed:.3e})",
              flush=True)
        check(err32 <= TRAIN_F32_RTOL * abs(ref),
              f"float32 step 1 {name}: kernel {kern32[i]} vs plain {ref}")
        check(d_kern <= allowed, f"bf16 step 1 {name}: kernel {kern16[i]} is {d_kern:.3e} "
              f"from the float32 plain step, beyond {allowed:.3e}")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: _tree_map(fn, val) for key, val in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, val) for val in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for val in tree:
            yield from _leaves(val)
    else:
        yield tree

# -- phase 8: the placement core ------------------------------------------------
PLACE_G, PLACE_D = 1024, 100_000        # decision kernels, bit for bit
PLACE_WAVE_D, PLACE_WAVE_B = 100_000, 16    # a wave on the 100k-device fleet
PLACE_SCALAR_D, PLACE_SCALAR_B = 10_000, 64  # a wave against the scalar path
PLACE_SCHEMES = ("ibdash", "churn_aware", "lavea", "round_robin", "tier_escalation")
PLACE_BUDGET = 4.0                      # tier_escalation's latency budget (s)
PLACE_TIMED = 10                        # timed calls of each decision kernel
# Each policy's kernels: a wave must launch each of these at least once.
PLACE_KERNELS = {
    "ibdash": (batched.select_queue, batched.ibdash_scan_kernel),
    "churn_aware": (batched.select_queue, batched.ibdash_scan_kernel),
    "lavea": (batched.lavea_kernel,),
    "round_robin": (batched.round_robin_kernel,),
    "tier_escalation": (batched.tier_escalation_kernel,),
}
# The JAX kernel each decision kernel takes the place of.
PLACE_REPLACES = {
    "select_queue": "src/repro/core/batched.py:581",
    "ibdash_scan_kernel": "src/repro/core/batched.py:476",
    "lavea_kernel": "src/repro/core/batched.py:521",
    "round_robin_kernel": "src/repro/core/batched.py:525",
    "tier_escalation_kernel": "src/repro/core/batched.py:531",
}
# run_one at the paper's fleet and burst (§V-G): 100 devices, 1000
# instances a cycle, SimConfig's 20 cycles.  The fused burst plans each
# cycle in one wave (the decision kernels run); churn with replan plans
# each arrival as it comes (pools of a few rows take the scalar rule) and
# costs 1.2-1.7 s of host time a cycle on the H100 machine (this phase's
# own runs), so it is cut to 6 cycles to keep the phase near two minutes.
PLACE_RUNS = (
    dict(scenario="mix", fused_burst=True),
    dict(scenario="churn", recovery="replan", n_cycles=6),
)


def decision_inputs(dev):
    """Inputs of the decision kernels at G x D on the card, from seed 8:
    half the rows integer-valued totals and queues (exact ties at every
    minimum), half continuous; +inf in about 1% of the totals; every 97th
    row wholly infeasible, every 89th with one feasible device, one row
    all +inf but feasible; pf in [0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    G, D = PLACE_G, PLACE_D
    total = torch.rand(G, D, generator=gen, device=dev, dtype=torch.float64) * 50
    ints = torch.randint(1, 200, (G // 2, D), generator=gen, device=dev).double()
    total[: G // 2] = ints
    total[torch.rand(G, D, generator=gen, device=dev) < 0.01] = float("inf")
    total[5] = float("inf")
    pf = torch.rand(G, D, generator=gen, device=dev, dtype=torch.float64)
    queue = torch.randint(0, 6, (G, D), generator=gen, device=dev).double()
    queue[G // 2:] += torch.rand(G - G // 2, D, generator=gen, device=dev, dtype=torch.float64)
    feasible = torch.rand(G, D, generator=gen, device=dev) < 0.9
    feasible[::97] = False
    feasible[1::89] = False
    feasible[1::89, 7] = True
    tiers = torch.randint(0, 3, (D,), generator=gen, device=dev)
    cursor = 12345
    sizes = feasible.sum(dim=1)
    before = torch.cumsum(sizes > 0, 0) - (sizes > 0).long()
    targets = torch.where(sizes > 0, (cursor + before) % sizes.clamp(min=1), 0)
    return dict(total=total, pf=pf, queue=queue, feasible=feasible, tiers=tiers,
                targets=targets)


def decision_bytes(name, G, D, k):
    """Bytes each decision kernel must move at these shapes: every input read
    once, every output written once."""
    f64, i64 = 8, 8
    return {
        "select_queue": G * D * f64 + G * k * i64,
        "ibdash_scan_kernel": 2 * G * k * f64 + G * i64 + G * (k - 1),
        "lavea_kernel": G * D * f64 + G * D + G * i64,
        "round_robin_kernel": G * D + 2 * G * i64,
        "tier_escalation_kernel": G * D * f64 + G * D + D * i64 + G * i64,
    }[name]


def decision_ops(name, G, D, k, n_tiers):
    """Float64 operations each decision kernel does on these inputs: the
    comparisons of a sort (D log2 D a row), a masked select and a compare a
    candidate for an argmin, a sum and a compare for the prefix count, and
    the scan's dozen operations a row and step."""
    return {
        "select_queue": G * D * max(D.bit_length() - 1, 1),
        "ibdash_scan_kernel": 12 * G * (k - 1),
        "lavea_kernel": 2 * G * D,
        "round_robin_kernel": 3 * G * D,
        "tier_escalation_kernel": (n_tiers + 1) * 3 * G * D,
    }[name]


def decision_phase(dev):
    """The decision kernels and the queue selection against their plain
    numpy versions, bit for bit, then their device and host times."""
    inp = decision_inputs(dev)
    host = {key: val.cpu().numpy() for key, val in inp.items()}
    G, D = PLACE_G, PLACE_D
    gamma, alpha, beta = 3, 0.5, 0.1
    k = min(gamma + 1, D - 1) + 1
    n_tiers = int(host["tiers"].max()) + 1
    masked = torch.where(inp["feasible"], inp["total"], float("inf"))
    masked_h = np.where(host["feasible"], host["total"], np.inf)
    order = batched.select_queue(masked, k)
    order_h = order.cpu().numpy()
    s_total = torch.gather(inp["total"], 1, order)
    s_pf = torch.gather(inp["pf"], 1, order)
    n_feas = inp["feasible"].sum(dim=1)
    n_feas_h = host["feasible"].sum(axis=1)
    calls = {
        "select_queue": (lambda: batched.select_queue(masked, k),
                         lambda: batched.select_queue_plain(masked_h, k)),
        "ibdash_scan_kernel": (
            lambda: batched.ibdash_scan_kernel(s_total, s_pf, n_feas, alpha, beta, gamma),
            lambda: batched.ibdash_scan_plain(
                np.take_along_axis(host["total"], order_h, 1),
                np.take_along_axis(host["pf"], order_h, 1), n_feas_h, alpha, beta, gamma)),
        "lavea_kernel": (lambda: batched.lavea_kernel(inp["queue"], inp["feasible"]),
                         lambda: batched.lavea_plain(host["queue"], host["feasible"])),
        "round_robin_kernel": (
            lambda: batched.round_robin_kernel(inp["feasible"], inp["targets"]),
            lambda: batched.round_robin_plain(host["feasible"], host["targets"])),
        "tier_escalation_kernel": (
            lambda: batched.tier_escalation_kernel(inp["total"], inp["feasible"], inp["tiers"],
                                                   PLACE_BUDGET * 10, n_tiers),
            lambda: batched.tier_escalation_plain(host["total"], host["feasible"], host["tiers"],
                                                  PLACE_BUDGET * 10, n_tiers)),
    }
    out = {}
    for name, (kern, plain) in calls.items():
        got = kern().cpu().numpy()
        t = time.perf_counter()
        with np.errstate(invalid="ignore"):     # inf / inf in rows all +inf, as in numpy
            want = plain()
        plain_ms = (time.perf_counter() - t) * 1e3
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name}: {got.shape} {got.dtype} against the plain {want.shape} {want.dtype}")
        n_diff = int((got != want).sum())
        check(n_diff == 0, f"{name} differs from its plain version at {n_diff} entries "
                           f"(G={G}, D={D})")
        ms = time_ms(kern, PLACE_TIMED)
        busy = device_ms(kern, PLACE_TIMED)
        us = host_us(kern, PLACE_TIMED)
        nbytes = decision_bytes(name, G, D, k)
        ops = decision_ops(name, G, D, k, n_tiers)
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F64_OPS_PER_S * 1e3
        bound = max(by_bytes, by_ops)
        out[name] = dict(ms=ms, kernel_ms=busy, host_us=us, plain_ms=plain_ms, bound_ms=bound,
                         bound_by="bytes" if by_bytes >= by_ops else "operations",
                         bytes=nbytes, ops=ops, mismatches=n_diff)
        print(f"[place] {name} G={G} D={D} float64: equal to its plain version at every "
              f"entry ({got.size} outputs); {ms:.4f} ms a call by CUDA events "
              f"({PLACE_TIMED} calls back to back), kernels' time {busy:.4f} ms, host "
              f"{us:.1f} us a call; plain numpy version {plain_ms:.1f} ms; bound {bound:.4f} ms "
              f"({nbytes:,} bytes at 3.35 TB/s: {by_bytes:.4f} ms; {ops:,} f64 operations at "
              f"34 TFLOP/s: {by_ops:.4f} ms), {100 * bound / ms:.1f}% of bound", flush=True)
    ties_ok = near_tie_check(dev, alpha, beta, gamma)
    rows_inf = int((~host["feasible"]).all(axis=1).sum())
    ties = int((host["total"][: G // 2] == host["total"][: G // 2].min(axis=1, keepdims=True))
               .sum(axis=1).mean())
    print(f"[place] decision inputs: {rows_inf} wholly infeasible rows, "
          f"{int(np.isinf(host['total']).sum()):,} +inf totals, {ties} devices tied at each "
          f"integer row's minimum on average; replicas accepted by the scan: "
          f"{int(calls['ibdash_scan_kernel'][0]().sum())}; at line 34's exact ties "
          f"{ties_ok}", flush=True)
    del inp, masked, order, s_total, s_pf
    torch.cuda.empty_cache()
    return out


def near_tie_check(dev, alpha, beta, gamma, G=PLACE_G, K=5) -> str:
    """The scan kernel on rows whose first replica candidate sits at the
    exact tie of Algorithm 1's line 34 (``w_new == w_s`` in exact
    arithmetic), so only the rounding of the four float64 operations of
    the weight update decides: a fused multiply-add on the card would flip
    some rows.  Must equal the plain version."""
    rng = np.random.default_rng(9)
    best = rng.uniform(0.5, 3.0, G)
    ratio = 1 + rng.integers(1, 20, (G, K - 1)) / 64
    comb0 = rng.uniform(0.3, 0.9, G)
    pf1 = 1 - alpha * (ratio[:, 0] - 1) / ((1 - alpha) * comb0)
    s_total = np.concatenate([best[:, None], best[:, None] * ratio], axis=1)
    s_pf = np.clip(np.concatenate([comb0[:, None], pf1[:, None],
                                   rng.uniform(0, 1, (G, K - 2))], axis=1), 0.0, 1.0)
    n_feas = np.full(G, K)
    want = batched.ibdash_scan_plain(s_total, s_pf, n_feas, alpha, beta, gamma)
    got = batched.ibdash_scan_kernel(
        *(torch.from_numpy(a).to(dev) for a in (s_total, s_pf, n_feas)),
        alpha, beta, gamma).cpu().numpy()
    n_diff = int((got != want).sum())
    check(n_diff == 0, f"ibdash_scan_kernel differs from its plain version at {n_diff} "
                       f"entries on rows at line 34's exact ties")
    return (f"{int(want[:, 0].sum())} of {G} rows accept their first candidate, "
            f"equal to the plain version")


def wave_apps(B, seed=1):
    """B seeded application instances (the four paper apps) and their
    arrival times over the paper's 1.5 s window, so every app's rows are
    distinct context rows and every policy's pool reaches its kernel."""
    rng = np.random.default_rng(seed)
    builders = list(APP_BUILDERS.values())
    apps = [builders[int(rng.integers(len(builders)))]().relabel(f"#{i}") for i in range(B)]
    times = np.sort(rng.uniform(0.0, 1.5, B)).tolist()
    return apps, times


def same_plans(tag, got, want):
    """Plans equal placement for placement, estimates included."""
    check(len(got) == len(want), f"{tag}: {len(got)} plans against {len(want)}")
    for a, b in zip(got, want):
        check(a.feasible == b.feasible and a.infeasible_task == b.infeasible_task
              and a.est_latency == b.est_latency and set(a.tasks) == set(b.tasks),
              f"{tag}: plan of {a.app.name} differs")
        for name, ta in a.tasks.items():
            tb = b.tasks[name]
            check([(r.did, r.est_exec, r.est_upload, r.est_transfer, r.pred_fail)
                   for r in ta.replicas]
                  == [(r.did, r.est_exec, r.est_upload, r.est_transfer, r.pred_fail)
                      for r in tb.replicas]
                  and ta.est_start == tb.est_start and ta.est_latency == tb.est_latency,
                  f"{tag}: placement of {name} differs")


def timed_decisions(policy) -> list:
    """Wrap ``policy.decide_batch`` so the one entry of the returned list
    sums its wall time (the decision kernels, their copies and the host's
    fan-out of the decisions)."""
    spent, inner = [0.0], policy.decide_batch

    def decide_batch(batch):
        t = time.perf_counter()
        try:
            return inner(batch)
        finally:
            spent[0] += time.perf_counter() - t

    policy.decide_batch = decide_batch
    return spent


def forbid_dense(*_a, **_k):
    raise RuntimeError("a dense (D, D) link matrix was built while planning a wave")


def wave_phase(dev):
    """One wave for each kernel-backed policy on the 100k-device multi-tier
    fleet, on the card and on the CPU, and a 10k-device wave against the
    scalar path."""
    out = {}
    for D, B in ((PLACE_WAVE_D, PLACE_WAVE_B), (PLACE_SCALAR_D, PLACE_SCALAR_B)):
        t = time.perf_counter()
        profile = make_profile(seed=0, device=dev)
        cluster = make_cluster(profile, scenario="multi_tier", n_devices=D, seed=0,
                               horizon=20.0, dt=0.5)
        cluster.link_bw = forbid_dense
        apps, times = wave_apps(B)
        n_tasks = sum(app.n_tasks for app in apps)
        print(f"[place] multi_tier fleet of {D:,} devices built in "
              f"{time.perf_counter() - t:.1f} s; a wave of {B} apps ({n_tasks} tasks)", flush=True)
        for scheme in PLACE_SCHEMES:
            cfg = SimConfig(seed=0, latency_budget=PLACE_BUDGET, device=dev.type)
            policy = policy_for(scheme, profile, cfg)
            orchestrate_batch(apps, cluster, policy, times=times)        # warm-up
            policy = policy_for(scheme, profile, cfg)
            decide_s = timed_decisions(policy)
            for kern in batched.DECISION_KERNELS:
                kern.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            plans = orchestrate_batch(apps, cluster, policy, times=times)
            wave_s = time.perf_counter() - t
            launches = {kern.__name__: kern.launches for kern in batched.DECISION_KERNELS}
            for kern in PLACE_KERNELS[scheme]:
                check(kern.launches > 0, f"{scheme} wave at D={D} launched no {kern.__name__}")
            if D == PLACE_WAVE_D:
                ref = orchestrate_batch(apps, cluster, policy_for(
                    scheme, profile, SimConfig(seed=0, latency_budget=PLACE_BUDGET,
                                               device="cpu")), times=times)
                same_plans(f"{scheme} wave at D={D}, cuda against cpu", plans, ref)
                against = "the same wave on the CPU"
                if scheme == "ibdash":     # the policy by name, on the call's device
                    by_name = orchestrate_batch(apps, cluster, "ibdash", times=times,
                                                device="cuda")
                    same_plans(f"ibdash by name at D={D}", by_name, plans)
                    against += " and to the policy given by name with device='cuda'"
            else:
                ref = orchestrate_batch(apps, cluster, policy_for(scheme, profile, cfg),
                                        times=times, batched=False)
                same_plans(f"{scheme} wave at D={D}, batched against scalar", plans, ref)
                against = "the scalar batched=False path"
            placed = sum(len(p.tasks) for p in plans)
            out[f"{scheme}@{D}"] = dict(wave_ms=wave_s * 1e3, decide_ms=decide_s[0] * 1e3,
                                        instances_per_s=B / wave_s,
                                        tasks_per_s=placed / wave_s, launches=launches)
            print(f"[place] {scheme} wave, D={D:,}, B={B}: {wave_s * 1e3:.1f} ms "
                  f"({decide_s[0] * 1e3:.1f} ms of it in decide_batch), "
                  f"{B / wave_s:.1f} instances/s, {placed / wave_s:.1f} tasks placed/s; "
                  f"kernel calls {launches}; equal to {against}", flush=True)
        del cluster
    return out


def run_phase(dev):
    """run_one at the paper's scale on the card, held instance for instance
    against the same run on the CPU."""
    out = {}
    for kw in PLACE_RUNS:
        tag = ",".join(f"{k}={v}" for k, v in kw.items())
        for kern in batched.DECISION_KERNELS:
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        res = run_one("ibdash", SimConfig(device="cuda", **kw))
        wall = time.perf_counter() - t
        launches = {kern.__name__: kern.launches for kern in batched.DECISION_KERNELS}
        peak = torch.cuda.max_memory_allocated() - before
        t = time.perf_counter()
        ref = run_one("ibdash", SimConfig(device="cpu", **kw))
        cpu_wall = time.perf_counter() - t
        same_result(f"run_one {tag}", res, ref)
        if kw.get("fused_burst"):
            check(launches["ibdash_scan_kernel"] > 0, f"run_one {tag} launched no scan kernel")
        check(np.isfinite(res.avg_service_time) and 0.0 <= res.prob_failure <= 1.0,
              f"run_one {tag}: avg_service_time {res.avg_service_time}, "
              f"prob_failure {res.prob_failure}")
        cfg, full = SimConfig(**kw), SimConfig().n_cycles
        cut = "uncut" if cfg.n_cycles == full else f"cut from {full} for time"
        out[tag] = dict(n_cycles=cfg.n_cycles, instances=res.n,
                        avg_service_time=res.avg_service_time, prob_failure=res.prob_failure,
                        wall_s=wall, cpu_wall_s=cpu_wall, peak_bytes=peak, launches=launches)
        print(f"[place] run_one ibdash {tag}: {cfg.n_devices} devices, {cfg.n_cycles} cycles "
              f"of {cfg.instances_per_cycle} instances ({cut}), {res.n} instances; "
              f"avg_service_time {res.avg_service_time:.6f} s, prob_failure "
              f"{res.prob_failure:.6f}; {wall:.2f} s on cuda ({cpu_wall:.2f} s on cpu), "
              f"peak device memory {peak / 2**20:.1f} MiB above what the process held "
              f"before; kernel calls {launches}; equal "
              f"to the CPU run instance for instance", flush=True)
    return out


def place_phase(dev):
    """Phase 8: the decision kernels, waves and run_one; returns the place line."""
    t = time.perf_counter()
    kernels = decision_phase(dev)
    waves = wave_phase(dev)
    runs = run_phase(dev)
    wave_launches = {}
    for scheme in PLACE_SCHEMES:
        for name, n in waves[f"{scheme}@{PLACE_WAVE_D}"]["launches"].items():
            wave_launches[name] = wave_launches.get(name, 0) + n
    line = {"place": {
        "kernels": [dict(name=name, replaces=PLACE_REPLACES[name],
                         launches=wave_launches[name], **vals)
                    for name, vals in kernels.items()],
        "waves": waves, "runs": runs, "G": PLACE_G, "D": PLACE_D,
        "seconds": time.perf_counter() - t,
    }}
    print(f"[place] phase took {line['place']['seconds']:.1f} s", flush=True)
    return line

# -- phase 9: the streaming service, the serving fleet and the exporters -------
# benchmarks/bench_stream.py's overload point, with its constants: 100
# devices of the mixed fleet, Poisson arrivals at 240/s over 45 s from seed
# 7, a 256-deep admission queue, waves of at most 30 every 0.25 s tick, SLOs
# of 6 s (critical) and 30 s (best effort); the baseline runs with no
# admission and no wave cap.  Its committed results are read from the file.
STREAM_D, STREAM_RATE, STREAM_HORIZON = 100, 240.0, 45.0
STREAM_QUEUE_CAP, STREAM_WAVE_CAP, STREAM_TICK = 256, 30, 0.25
STREAM_SLO = (6.0, 30.0)
BENCH_STREAM = Path(__file__).resolve().parent / "BENCH_stream.json"
# the deterministic columns of a BENCH_stream.json row (all but its wall
# time and placement rate, which are read off the host's clock)
BENCH_COLUMNS = ("n_arrivals", "shed_rate", "shed", "completed", "lost", "deadline_missed",
                 "deadline_missed_critical", "p50_critical", "p99_critical", "p999_critical",
                 "p99_best_effort")
# The JAX serve_demo's fleet comparison (src/repro/launch/serve.py:64-76):
# 16 replicas from seed 0, 600 requests over an 8 s window from seed 1; then
# ibdash fused, behind the admission queue, and under churn with replan.
FLEET_POLICIES = ("ibdash", "petrel", "lavea", "round_robin")
FLEET_RUNS = tuple((pol, {}, {}) for pol in FLEET_POLICIES) + (
    ("ibdash", {}, dict(fused=True)),
    ("ibdash", {}, dict(admission=AdmissionConfig())),
    ("ibdash", dict(churn=True, recovery="replan"), {}),
)
CPU = torch.device("cpu")


@contextlib.contextmanager
def ibdash_pools():
    """Record the distinct-row count of every IBDASH-family ``decide_batch``
    call while the block runs (degraded policies made inside the service
    included): the calls whose pool reaches ``BATCH_KERNEL_MIN_ROWS`` must
    each launch the queue and scan kernels once, the others take the
    scalar rule."""
    sizes, inner = [], IBDASHPolicy.decide_batch

    def decide_batch(self, batch):
        sizes.append(batch.n_distinct)
        return inner(self, batch)

    IBDASHPolicy.decide_batch = decide_batch
    try:
        yield sizes
    finally:
        IBDASHPolicy.decide_batch = inner


def same_result(tag, a, b):
    """Two SimResults agree instance for instance and device for device."""
    check(a.n == b.n and np.array_equal(a.load_per_device, b.load_per_device),
          f"{tag}: load per device differs between cuda and cpu")
    check([dataclasses.astuple(r) for r in a.instances]
          == [dataclasses.astuple(r) for r in b.instances],
          f"{tag}: an instance record differs between cuda and cpu")
    check(repr((a.avg_service_time, a.prob_failure)) == repr((b.avg_service_time, b.prob_failure)),
          f"{tag}: average service time or failure rate differs between cuda and cpu")


def same_stream(tag, a, b):
    """Two StreamResults agree exactly, but for the wall-clock metrics."""
    same_result(tag, a.result, b.result)
    check(a.n_arrivals == b.n_arrivals and a.stats == b.stats,
          f"{tag}: the engine's counters differ between cuda and cpu")
    check([dataclasses.astuple(r) for r in a.shed_log]
          == [dataclasses.astuple(r) for r in b.shed_log],
          f"{tag}: the shed log differs between cuda and cpu")
    check(json.dumps(without_wall_clock(a.metrics), sort_keys=True)
          == json.dumps(without_wall_clock(b.metrics), sort_keys=True),
          f"{tag}: a metric differs between cuda and cpu")


def bench_row(res):
    """A StreamResult in bench_stream.measure's columns."""
    c = res.metrics["counters"]
    return {
        "n_arrivals": res.n_arrivals, "shed_rate": res.shed_rate, "shed": res.stats["shed"],
        "completed": res.stats["completed"], "lost": res.stats["lost"],
        "deadline_missed": c.get("deadline_missed", 0),
        "deadline_missed_critical": c.get("deadline_missed_latency_critical", 0),
        "p50_critical": res.p("p50", "latency_critical"),
        "p99_critical": res.p("p99", "latency_critical"),
        "p999_critical": res.p("p999", "latency_critical"),
        "p99_best_effort": res.p("p99", "best_effort"),
    }


def counted_run(dev, fn):
    """Run ``fn`` with the decision kernels' counts at 0 and IBDASH's pools
    recorded; returns its result and what was counted (wall seconds, the
    kernels' launches, the decide_batch calls and those at or above the
    kernels' row threshold, and on the card the peak memory above what the
    process held before)."""
    for kern in batched.DECISION_KERNELS:
        kern.launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    with ibdash_pools() as pools:
        t = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t
    counts = dict(
        wall_s=wall, launches={kern.__name__: kern.launches for kern in batched.DECISION_KERNELS},
        decide_batch_calls=len(pools),
        kernel_pools=sum(g >= batched.BATCH_KERNEL_MIN_ROWS for g in pools),
        peak_bytes=torch.cuda.max_memory_allocated() - before if dev.type == "cuda" else None)
    if dev.type == "cuda":
        check(counts["launches"]["ibdash_scan_kernel"] == counts["launches"]["select_queue"]
              == counts["kernel_pools"],
              f"{counts['kernel_pools']} IBDASH pools of at least "
              f"{batched.BATCH_KERNEL_MIN_ROWS} rows, but {counts['launches']} kernel launches")
    return out, counts


def overload_run(dev, admission, trace=False):
    """bench_stream.measure's overload point through the port's API on
    ``dev``: returns the service and its result."""
    profile = make_profile(seed=0, device=dev)
    cluster = make_cluster(profile, scenario="stream", n_devices=STREAM_D, seed=0,
                           horizon=STREAM_HORIZON * 6.0 + 120.0)
    orch = Orchestrator(cluster, make_policy("ibdash", alpha=0.5, beta=0.1, gamma=3,
                                             lats_model=profile.lats_model, device=dev),
                        trace=trace)
    arrivals = poisson_arrivals(default_streams(slo_critical=STREAM_SLO[0],
                                                slo_best_effort=STREAM_SLO[1]),
                                STREAM_RATE, STREAM_HORIZON, seed=7)
    service = StreamingOrchestrator(
        orch, admission=AdmissionConfig(queue_cap=STREAM_QUEUE_CAP) if admission else None,
        wave_cap=STREAM_WAVE_CAP if admission else None, tick=STREAM_TICK)
    return service, service.run(arrivals)


def describe(counts) -> str:
    peak = counts["peak_bytes"]
    return (f"{counts['wall_s']:.2f} s, {counts['decide_batch_calls']} decide_batch calls "
            f"({counts['kernel_pools']} pools of >= {batched.BATCH_KERNEL_MIN_ROWS} rows), "
            f"kernel launches {counts['launches']}, peak device memory "
            + (f"{peak / 2**20:.1f} MiB above what the process held before"
               if peak is not None else "not measured (cpu)"))


def overload_phase(cuda):
    """(a) The overload point with and without admission, on the card and
    on the CPU, equal to each other and to BENCH_stream.json."""
    bench = json.loads(BENCH_STREAM.read_text())["results"]
    out, results = {}, {}
    for point, admission in (("overload", True), ("overload_baseline", False)):
        runs = {}
        for name, dev in (("cuda", cuda), ("cpu", CPU)):
            (_, res), counts = counted_run(dev, lambda: overload_run(dev, admission))
            runs[name] = res
            counts["placements_per_sec"] = res.metrics["gauges"]["placements_per_sec"]
            out.setdefault(point, {})[name] = counts
            print(f"[stream] {point} on {name}: {res.n_arrivals} arrivals, shed "
                  f"{res.stats['shed']}, completed {res.stats['completed']}, lost "
                  f"{res.stats['lost']}, p99_critical {res.p('p99')!r}; "
                  f"{counts['placements_per_sec']:.1f} placements/s; {describe(counts)}",
                  flush=True)
        same_stream(f"{point} run", runs["cuda"], runs["cpu"])
        row, want = bench_row(runs["cuda"]), bench[point]
        for col in BENCH_COLUMNS:
            check(row[col] == want[col],
                  f"{point}: {col} {row[col]!r} against BENCH_stream.json's {want[col]!r}")
        out[point]["bench"] = row
        results[point] = runs["cuda"]
        print(f"[stream] {point}: equal on cuda and cpu (records, shed log, counters, every "
              f"metric but {', '.join(WALL_CLOCK_METRICS)}) and to BENCH_stream.json in "
              f"{len(BENCH_COLUMNS)} columns (shed {row['shed']}, completed {row['completed']}, "
              f"lost {row['lost']}, p99_critical {row['p99_critical']!r})", flush=True)
    return out, results["overload"]


def export_phase(cuda, untraced):
    """(b) The admitted overload once more, traced, on the card and on
    the CPU: equal reports and summaries, the same Chrome trace string for
    string, valid, and the ledger rebuilt from the exported JSON alone."""
    docs = {}
    for name, dev in (("cuda", cuda), ("cpu", CPU)):
        t = time.perf_counter()
        # trace=True: an empty Tracer() is falsy (it has a length), and the
        # Orchestrator of both packages reads a falsy trace as "off"
        service, res = overload_run(dev, True, trace=True)
        run_s = time.perf_counter() - t
        tracer = service.orch.trace
        t = time.perf_counter()
        report = attribution_report(tracer)
        summary = json_summary(tracer, service.metrics)
        summary["metrics"] = without_wall_clock(summary["metrics"])
        text = json.dumps(to_chrome_trace(tracer))
        docs[name] = (res, repr(report), format_report(report),
                      json.dumps(summary, sort_keys=True), text)
        print(f"[stream] traced overload on {name}: run {run_s:.2f} s, report and export "
              f"{time.perf_counter() - t:.2f} s; {len(tracer.spans)} spans, Chrome trace "
              f"{len(text)} bytes", flush=True)
    check([dataclasses.astuple(dataclasses.replace(r, tid=-1))
           for r in docs["cuda"][0].result.instances]
          == [dataclasses.astuple(r) for r in untraced.result.instances],
          "tracing changed an instance record of the overload run (trace ids aside)")
    (res, report, text_report, summary, text), cpu_doc = docs["cuda"], docs["cpu"]
    same_stream("traced overload", res, cpu_doc[0])
    check(report == cpu_doc[1] and text_report == cpu_doc[2],
          "attribution_report differs between cuda and cpu")
    check(summary == cpu_doc[3], "json_summary differs between cuda and cpu")
    check(text == cpu_doc[4], "the Chrome trace JSON differs between cuda and cpu")
    n_events = validate_chrome_trace(json.loads(text))
    ledger = ledger_from_trace(json.loads(text))
    want = {"admitted": res.n_arrivals, "completed": res.stats["completed"],
            "lost": res.stats["lost"], "shed": res.stats["shed"]}
    check(ledger == want, f"ledger from the exported trace {ledger} against the run's {want}")
    print(f"[stream] exports equal on cuda and cpu (attribution report, json_summary, "
          f"Chrome trace string for string); {n_events} events valid; ledger from the trace "
          f"alone {ledger}", flush=True)
    return dict(events=n_events, trace_bytes=len(text), ledger=ledger)


def fleet_phase(cuda, fit):
    """(c) The serving fleet fed by the card's full-width dense fit, on the
    card and on the CPU, equal run for run."""
    m, c, r2 = fit
    im = fleet_interference(m, c)
    print(f"[stream] fleet interference from {DENSE_ARCH}'s fit on the card: m={m!r} s/seq"
          + (" (below zero, taken as 0)" if m < 0 else "")
          + f", c={c!r} s (R^2 {r2:.4f}); long requests 3m, 6c", flush=True)
    out = {}
    for pol, fleet_kw, run_kw in FLEET_RUNS:
        tag = pol + "".join(f",{k}" for k in {**fleet_kw, **run_kw})
        runs = {}
        for name, dev in (("cuda", cuda), ("cpu", CPU)):
            fleet = ServingFleet(im, policy=pol, n_replicas=16, seed=0, device=dev, **fleet_kw)
            res, counts = counted_run(dev, lambda: fleet.run(
                n_requests=600, arrival_window=8.0, seed=1, **run_kw))
            runs[name] = (fleet, res)
            counts.update(avg_latency_s=res.avg_service_time, failure_rate=res.prob_failure,
                          device_down=fleet.engine.stats.device_down,
                          replica_deaths=fleet.engine.stats.replica_deaths)
            out.setdefault(tag, {})[name] = counts
            print(f"[stream] fleet {tag} on {name}: avg latency "
                  f"{res.avg_service_time * 1e3:.3f} ms, failure rate {res.prob_failure:.6f}, "
                  f"{counts['device_down']} replica departures; {describe(counts)}", flush=True)
        (fleet, res), (fleet_c, res_c) = runs["cuda"], runs["cpu"]
        same_result(f"fleet {tag}", res, res_c)
        check(fleet.engine.stats.as_dict() == fleet_c.engine.stats.as_dict(),
              f"fleet {tag}: the engine's counters differ between cuda and cpu")
        if "admission" in run_kw:
            same_stream(f"fleet {tag}", res.stream, res_c.stream)
        if run_kw.get("fused"):
            check(out[tag]["cuda"]["launches"]["ibdash_scan_kernel"] > 0,
                  f"fleet {tag} launched no scan kernel")
        check(np.isfinite(res.avg_service_time) and 0.0 <= res.prob_failure <= 1.0,
              f"fleet {tag}: avg latency {res.avg_service_time}, failure rate {res.prob_failure}")
    print(f"[stream] {len(FLEET_RUNS)} fleet runs equal on cuda and cpu", flush=True)
    return out


def stream_phase(dev, fit):
    """Phase 9: the overload point, its exports and the serving fleet, each
    run on ``dev`` and on the CPU; returns the stream line."""
    t = time.perf_counter()
    overload, admitted = overload_phase(dev)
    export = export_phase(dev, admitted)
    fleet = fleet_phase(dev, fit)
    launched = sum(runs["cuda"]["launches"]["ibdash_scan_kernel"]
                   for runs in (*overload.values(), *fleet.values()))
    check(launched > 0, "phase 9 launched no decision kernel on the card")
    line = {"stream": {"overload": overload, "export": export, "fleet": fleet,
                       "fit": dict(zip(("m", "c", "r2"), fit)),
                       "seconds": time.perf_counter() - t}}
    print(f"[stream] phase took {line['stream']['seconds']:.1f} s", flush=True)
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = gpu_line()
    print(card, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t = time.perf_counter()
    reports = build(["rwkv6_scan", "flash_attention", "flash_decode"])
    print(f"[build] all three kernels built in parallel in {time.perf_counter() - t:.1f} s",
          flush=True)
    for name, report in reports.items():
        print(f"[build] {name}:", flush=True)
        for line in report.splitlines() or ["(library already built)"]:
            print(f"[build]   {line}", flush=True)
    print(f"[build] rwkv6_scan dynamic shared memory per block of its output pass at "
          f"N={N}: {smem_bytes(N)} bytes (256 threads a block)", flush=True)
    print(f"[build] flash_attention dynamic shared memory per block: bf16 (wgmma) "
          + ", ".join(f"D={d} {attn_smem_bytes(d)} bytes" for d in (32, 64, 128))
          + "; f32 (SIMT) "
          + ", ".join(f"D={d} {attn_smem_bytes(d, torch.float32)} bytes" for d in (32, 64, 128))
          + " (bf16: 160 threads a block, two blocks an SM; f32: 256 threads)", flush=True)
    for kern, regs, st, ld in ptxas_report(reports.get("flash_attention", "")):
        print(f"[build] flash_attention {kern}: {regs} registers, spill stores {st} bytes, "
              f"spill loads {ld} bytes", flush=True)
    print(f"[build] flash_decode dynamic shared memory per block: bf16 "
          + ", ".join(f"D={d} {decode_smem_bytes(d)} bytes" for d in (32, 64, 128))
          + "; f32 "
          + ", ".join(f"D={d} {decode_smem_bytes(d, torch.float32)} bytes"
                      for d in (32, 64, 128))
          + " (128 threads a block)", flush=True)
    for name in ("rwkv6_scan", "flash_decode"):
        for kern, regs, st, ld in ptxas_report(reports.get(name, "")):
            print(f"[build] {name} {kern}: {regs} registers, spill stores {st} bytes, "
                  f"spill loads {ld} bytes", flush=True)

    worst, timing = kernel_phase(dev)
    attn_worst, attn_t = attention_phase(dev)
    dec_worst, dec_t = decode_phase(dev)
    flash_attention.launches = flash_decode.launches = 0
    model, params, launches = serve_phase(dev)
    check(flash_attention.launches == 0 and flash_decode.launches == 0,
          "the RWKV6 serving path launched an attention kernel")
    fit_phase("fit", model, params, (rwkv6_scan,))
    del model, params
    torch.cuda.empty_cache()
    dec_launches, dense_fit = dense_phase(dev)
    torch.cuda.empty_cache()
    attn_launches, _ = train_phase(dev)
    torch.cuda.empty_cache()
    place = place_phase(dev)
    torch.cuda.empty_cache()
    stream = stream_phase(dev, dense_fit)

    main_t, dec_main, attn_main = timing[512], dec_t["served"], attn_t["train"]
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(place), flush=True)
    print(json.dumps(stream), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "rwkv6_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:99",
        "launches": launches,
        "kernels_per_call": main_t["kernels_per_call"],
        "max_abs_err": worst,
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:97",
        "launches": attn_launches,
        "kernels_per_call": attn_main["kernels_per_call"],
        "max_abs_err": attn_worst,
        "ms": attn_main["ms"],
        "plain_ms": attn_main["plain_ms"],
        "bound_ms": attn_main["bound_ms"],
        "bound_by": attn_main["bound_by"],
        "library_ms": attn_main["library_ms"],
    }, {
        "name": "flash_decode",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:76",
        "launches": dec_launches,
        "kernels_per_call": dec_t["kernels_per_call"],
        "max_abs_err": dec_worst,
        "ms": dec_main["ms"],
        "plain_ms": dec_main["plain_ms"],
        "bound_ms": dec_main["bound_ms"],
        "bound_by": dec_main["bound_by"],
        "library_ms": dec_main["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
