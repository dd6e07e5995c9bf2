"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing the run with a non-zero exit if anything is wrong:

1. device    requires CUDA; prints the card's name and power limit.
2. build     builds every CUDA kernel from ``src/repro_torch/csrc`` for
             sm_90a and prints nvcc's register and shared-memory report.
3. kernels   holds each kernel against its plain PyTorch version on the
             card at the main path's shapes, and times both.
4. serve     serves requests through ``ServingEngine`` on full-width
             RWKV6-3B in bf16 (random weights from a seed) and checks that
             every prefill went through the WKV kernel, that the tokens are
             valid ids, and one prefill's logits against the plain WKV.
5. fit       fits ``T = m*k + c`` to decode-step latency with
             ``measure_interference``.

The line before the last is a JSON object with each kernel's launches on
the serving path, its error against the plain version, its time, the plain
version's time and its bound; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.build import build  # noqa: E402
from repro_torch.kernels.ref import rwkv6_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import chunk_for, rwkv6_scan, smem_bytes  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.serve.engine import ServingEngine, measure_interference  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

H, N = 40, 64                       # RWKV6-3B: 40 heads of size 64
KERNEL_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
# Prefill logits through the WKV kernel against the plain WKV (prefill_check):
# in float32, max |difference| within this share of max |logit| (the kernel's
# f32 error, about 1e-6 of |y|, grown through 32 layers); in bf16, RMS distance
# from the float32 plain logits within this factor of the plain bf16 path's.
LOGITS_F32_TOL = 1e-3
BF16_NOISE_FACTOR = 2.0
SERVE_PROMPTS = (64, 128, 80, 200, 512, 16, 33, 256, 97, 20)
SERVE_NEW_TOKENS = (16, 32, 24, 20, 16, 32, 18, 28, 16, 24)


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


def wkv_inputs(B, T, dtype, gen, dev):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    r, k, v = randn(B, T, H, N) * 0.5, randn(B, T, H, N) * 0.5, randn(B, T, H, N)
    w = torch.exp(-torch.exp(randn(B, T, H, N) - 2.0))      # decay in (0, 1)
    return dict(r=r.to(dtype), k=k.to(dtype), v=v.to(dtype), w=w,
                u=randn(H, N) * 0.2, S0=randn(B, H, N, N) * 0.1)


def wkv_cost(B: int, T: int, elem_bytes: int):
    """(bytes, f32 operations) the chunked WKV scan needs for these shapes.

    Bytes: r, k, v and y in the activation dtype and w in f32, each read or
    written once; u, S0 and S_T in f32.  Operations, per (b, h) and chunk of
    L valid tokens: (r e^cum_exc) @ S; the decay-weighted A below the
    diagonal (subtract, exp, two multiplies, add per term) and its u
    diagonal; A @ v over i <= t; the state update; the log, cumsum and decay
    factors.  A ragged last chunk counts its valid tokens only.
    """
    nbytes = B * T * H * N * (4 * elem_bytes + 4) + H * N * 4 + 2 * B * H * N * N * 4
    c = chunk_for(T)
    ops = 0
    for t0 in range(0, T, c):
        L = min(c, T - t0)
        below = L * (L - 1) // 2
        ops += (2 * L * N * N + 5 * below * N + 3 * L * N
                + 2 * (below + L) * N + 2 * L * N * N + N * N + 3 * L * N)
    return nbytes, B * H * ops


def kernel_phase(dev):
    """The WKV kernel against its plain version at the main path's shapes."""
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for B in (1, 8):
        for T in (64, 128, 80, 512):
            for dtype in (torch.float32, torch.bfloat16):
                inp = wkv_inputs(B, T, dtype, gen, dev)
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
                print(f"[kernels] rwkv6_scan B={B} T={T} {str(dtype)[6:]} chunk={chunk_for(T)}: "
                      f"max abs err y {errs[0]:.3e}, S_T {errs[1]:.3e} (tol {tol} abs+rel)",
                      flush=True)
    timing = {}
    for T in (128, 512):
        inp = wkv_inputs(1, T, torch.bfloat16, gen, dev)
        ms = time_ms(lambda: rwkv6_scan(**inp), iters=50)
        plain_ms = time_ms(lambda: rwkv6_ref(**inp), iters=3, warmup=1)
        nbytes, ops = wkv_cost(1, T, 2)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        timing[T] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by="bytes" if t_bytes >= t_ops else "operations")
        print(f"[kernels] rwkv6_scan B=1 T={T} H={H} N={N} bf16: {ms:.4f} ms; "
              f"plain version {plain_ms:.3f} ms; bound {bound:.4f} ms "
              f"({nbytes} bytes -> {t_bytes:.4f} ms, {ops} f32 ops -> {t_ops:.4f} ms), "
              f"{100 * bound / ms:.1f}% of bound", flush=True)
    return worst, timing


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

    rng = np.random.default_rng(0)
    requests = [(f"req{i}", rng.integers(0, cfg.vocab, n).tolist(), m)
                for i, (n, m) in enumerate(zip(SERVE_PROMPTS, SERVE_NEW_TOKENS))]
    engine = ServingEngine(model, params, max_batch=8, max_seq=1024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    rwkv6_scan.launches = 0
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
    wall = time.perf_counter() - t_start
    launches = rwkv6_scan.launches

    check(launches == cfg.n_layers * len(requests),
          f"rwkv6_scan launched {launches} times for {len(requests)} prefills "
          f"of {cfg.n_layers} layers")
    for rid, prompt, n_new in requests:
        toks = done[rid]
        check(len(toks) == n_new + 1, f"{rid}: {len(toks)} tokens, wanted {n_new + 1}")
        check(all(0 <= t < cfg.vocab for t in toks), f"{rid}: token id out of range")
    n_tok = sum(len(t) for t in done.values())
    print(f"[serve] {len(requests)} requests (prompts {list(SERVE_PROMPTS)}), "
          f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s, "
          f"{len(step_s)} decode steps at batch 8", flush=True)
    print(f"[serve] prefill ms per request: median {1e3 * np.median(prefill_s):.2f}, "
          f"by prompt length (in order, the first one cold) "
          f"{[(n, round(1e3 * x, 2)) for n, x in zip(SERVE_PROMPTS, prefill_s)]}", flush=True)
    print(f"[serve] decode step ms: median {1e3 * np.median(step_s):.2f}, "
          f"min {1e3 * min(step_s):.2f}, max {1e3 * max(step_s):.2f}", flush=True)
    print(f"[serve] rwkv6_scan launches {launches} = {cfg.n_layers} layers x "
          f"{len(requests)} prefills; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    rid, prompt, _ = requests[3]
    lg = prefill_check(model, params, prompt)
    check(int(lg.argmax()) == done[rid][0], "prefill is not deterministic")
    return model, params, launches


def prefill_check(model, params, prompt):
    """One prompt's prefill logits through the WKV kernel, held against the
    same prefill through the plain WKV, in float32 and in bf16.

    In float32 (the same weights cast up) the two must agree to
    LOGITS_F32_TOL of max |logit|.  In bf16 both paths round every
    activation, and 32 layers of random weights amplify a one-ulp difference
    in y into visible logit differences, so the kernel's bf16 logits are
    held against the float32 plain logits: their RMS distance may be at most
    BF16_NOISE_FACTOR times the plain bf16 path's own RMS distance from
    them.  Returns the kernel's bf16 logits."""
    cfg, dev = model.cfg, model.device
    tokens = torch.tensor([prompt], device=dev)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _tree_map(lambda t: t.float(), params)

    def prefill(c, p, mix_fn):
        m = LM(c, device=dev, mix_fn=mix_fn)
        with torch.inference_mode():
            lg, _ = m.prefill(p, {"tokens": tokens}, m.init_cache(1, len(prompt)))
        return lg.float()

    kern16, plain16 = prefill(cfg, params, None), prefill(cfg, params, rwkv6_ref)
    kern32, plain32 = prefill(cfg32, params32, None), prefill(cfg32, params32, rwkv6_ref)
    del params32
    for name, lg in (("bf16", kern16), ("float32", kern32)):
        check(bool(torch.isfinite(lg).all()), f"non-finite {name} prefill logits")

    def rms(a, b):
        return float((a - b).square().mean().sqrt())

    scale32 = float(plain32.abs().max())
    err32 = float((kern32 - plain32).abs().max())
    rms_kern, rms_plain = rms(kern16, plain32), rms(plain16, plain32)
    print(f"[serve] prefill logits, {len(prompt)} tokens, WKV kernel vs plain WKV: "
          f"float32 max abs diff {err32:.4e} (max |logit| {scale32:.4f}, tol "
          f"{LOGITS_F32_TOL} of it); bf16 max abs diff {float((kern16 - plain16).abs().max()):.4e}; "
          f"RMS from float32 plain: kernel bf16 {rms_kern:.4e}, plain bf16 {rms_plain:.4e} "
          f"(tol {BF16_NOISE_FACTOR}x); greedy token kernel {int(kern16.argmax())}, "
          f"plain {int(plain16.argmax())}, float32 {int(plain32.argmax())}", flush=True)
    check(err32 <= LOGITS_F32_TOL * scale32,
          f"float32 prefill logits differ by {err32:.4e}, beyond {LOGITS_F32_TOL} x {scale32:.4f}")
    check(rms_kern <= BF16_NOISE_FACTOR * rms_plain,
          f"bf16 prefill logits are {rms_kern:.4e} RMS from float32, beyond "
          f"{BF16_NOISE_FACTOR} x the plain path's {rms_plain:.4e}")
    return kern16


def fit_phase(model, params):
    rwkv6_scan.launches = 0
    m, c, r2, samples = measure_interference(
        model, params, batch_sizes=(1, 2, 4, 8), max_seq=1024, iters=10)
    check(rwkv6_scan.launches == model.cfg.n_layers * 15,
          f"rwkv6_scan launched {rwkv6_scan.launches} times for 15 probe prefills")
    check(bool(np.isfinite([m, c, r2]).all()), "non-finite interference fit")
    print(f"[fit] decode-step latency T = m*k + c: m={m * 1e3:.4f} ms/seq, "
          f"c={c * 1e3:.4f} ms, R^2={r2:.4f}", flush=True)
    for k, dt in samples:
        print(f"[fit]   k={k}: {dt * 1e3:.3f} ms (fit {(m * k + c) * 1e3:.3f} ms)", flush=True)


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
    reports = build(["rwkv6_scan"])
    for name, report in reports.items():
        print(f"[build] {name} ({time.perf_counter() - t:.1f} s):", flush=True)
        for line in report.splitlines() or ["(library already built)"]:
            print(f"[build]   {line}", flush=True)
    print(f"[build] rwkv6_scan dynamic shared memory per block at N={N}: "
          f"chunk 64 {smem_bytes(N, 64)} bytes, chunk 16 {smem_bytes(N, 16)} bytes "
          f"(256 threads a block)", flush=True)

    worst, timing = kernel_phase(dev)
    model, params, launches = serve_phase(dev)
    fit_phase(model, params)

    main_t = timing[512]
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "rwkv6_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:99",
        "launches": launches,
        "max_abs_err": worst,
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
