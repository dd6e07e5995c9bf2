"""Training steps back to back: one ``make_train_step`` step object with its
model and AdamW state, built in set-up and driven from the seed through its
first ``check_steps`` steps, then handed, the same object, to the window.
Every batch comes from the same feed: (B, S + 1) token ids uniform over the
vocabulary from the seed, the labels the next token, so every row differs.

The window keeps at most two steps in flight (it waits for the one before
last before it queues another), so the host clock follows the card.

The check holds the first steps against the plain reference (float32,
TF32 off), from the same initial weights and batches: each step's loss,
the first step's gradient as AdamW got it (its first moment after one step
over ``1 - b1``), and the parameters' change after the last checked step,
read before the window's first step moves them.  Each layer's slice of a
stacked leaf counts as a leaf; the gradient and the change are each taken
by the worst leaf: the gap between the program's norm and the reference's,
over the larger of the reference's norm of that leaf and of the median
leaf.  A leaf whose reference gradient is under a thousandth of the median
leaf's moves by round-off alone and is left out of the change.  The
gradient is also taken by the median leaf's gap over its own norm, which
small leaves (biases, norm scales) do not swing.
"""
from __future__ import annotations

import gc
import time
from collections import deque
from typing import Dict, List, Tuple

import numpy as np

from ..trace import Span, Tracer, annotate

FEED_STREAM = 0x7A11


def counters() -> Dict[str, int]:
    from repro_torch.kernels.flash_attention import flash_attention

    return {"flash_attention": flash_attention.launches}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def run(rec, seed, device, trace, t_start, log) -> None:
    import torch

    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import LM
    from repro_torch.optim.optimizers import AdamW
    from repro_torch.train.step import make_train_step

    from ..weights import make_dense

    m, mix = rec.model, rec.cell.mix
    B, S, o = mix["batch"], mix["seq"], mix["optimizer"]
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    marks = [("imports and context", time.perf_counter())]
    model = LM(ModelConfig(**m), device=device)
    params = make_dense(m, seed, device)
    params0 = _clone(params)
    opt = AdamW(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                weight_decay=o["weight_decay"], clip_norm=o["clip_norm"])
    state = opt.init(params)
    step = make_train_step(model, opt)
    sync()
    marks.append(("weights and optimizer state", time.perf_counter()))
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) ^ FEED_STREAM) % 2 ** 64)

    def feed():
        ids = torch.randint(0, m["vocab"], (B, S + 1), generator=gen, device=device)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}

    batches, losses, mom1 = [], [], None
    for t in range(1, mix["check_steps"] + 1):
        batch = feed()
        batches.append({k: v.clone() for k, v in batch.items()})
        params, state, out = step(params, state, batch)
        losses.append(out["loss"])
        if t == 1:
            mom1 = _clone(state["m"])
        sync()
        marks.append((f"check step {t}", time.perf_counter()))
    params_k = _clone(params)
    sync()
    rec.state.update(params0=params0, batches=batches, losses=[float(x) for x in losses],
                     mom1=mom1, params_k=params_k, b1=o["b1"])
    tracer = Tracer(mix["trace"], rec.seconds, counters, sync, cuda=cuda) if trace else None
    if tracer is not None:
        tracer.warm()
    rec.setup_s = time.perf_counter() - t_start
    marks.append(("the rest", t_start + rec.setup_s))
    took = [(name, t - (marks[i - 1][1] if i else t_start)) for i, (name, t) in enumerate(marks)]
    log("[setup] " + ", ".join(f"{name} {s:.3f} s" for name, s in took))

    t0 = time.perf_counter()
    inflight: deque = deque()
    spans: List[Span] = []
    window_losses = []
    n = 0
    while True:
        now = time.perf_counter() - t0
        if tracer is not None:
            tracer.tick(now, n)
        if now >= rec.seconds:
            break
        t_a = time.perf_counter() - t0
        with annotate(tracer, "bench.step"):
            params, state, out = step(params, state, feed())
        window_losses.append(out["loss"])
        n += 1
        spans.append(Span("train_step", t_a, time.perf_counter() - t0, {"B": B, "S": S}))
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
            if len(inflight) >= 2:
                inflight.popleft().synchronize()
    if tracer is not None:
        tracer.close(time.perf_counter() - t0)
    sync()
    rec.elapsed = time.perf_counter() - t0
    rec.steps, rec.spans = n, spans
    lw = np.asarray([float(x) for x in window_losses])
    rec.attempted, rec.failed = n, int((~np.isfinite(lw)).sum())
    if cuda:
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    if tracer is not None:
        rec.trace, rec.trace_attempts = tracer.finish(), tracer.attempts
    log(f"[train] B={B} S={S}: {n} steps in {rec.elapsed:.3f} s; set-up losses "
        f"{rec.state['losses']}; window loss first {lw[:1]} last {lw[-1:]}")
    del model, params, state, step, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def _slices(named: Dict[str, "object"]) -> Dict[str, "object"]:
    """Each layer's slice of a stacked (``segments``) leaf as a leaf of its
    own; other leaves whole."""
    out = {}
    for name, x in named.items():
        if name.startswith("segments."):
            for i in range(x.shape[0]):
                out[f"{name}[{i}]"] = x[i]
        else:
            out[name] = x
    return out


def _norms(named) -> Dict[str, float]:
    import torch

    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in named.items()}


def _gap(prog: Dict[str, float], ref: Dict[str, float], keep) -> Tuple[float, str]:
    keys = [k for k in ref if keep(k)]
    med = float(np.median([ref[k] for k in keys]))
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def readings(rec, ref, device, prec: str = "f32") -> Dict[str, float]:
    """The numbers compared, for the program against the float32 reference
    (``prec="f32"``), or for the reference at ``prec`` put in the program's
    place (``"fp8"``: the control)."""
    import torch

    ref.exact_matmul()
    st = rec.state
    m, o = rec.model, rec.cell.mix["optimizer"]
    batches = [(b["tokens"], b["labels"]) for b in st["batches"]]
    p0 = dict(ref.leaves(st["params0"]))

    def change(after):
        return _slices({k: after[k].float() - v.float() for k, v in p0.items()})

    want = ref.train_steps(m, st["params0"], batches, o, "f32")
    g_ref, d_ref = _slices(want["grads1"]), change(want["params"])
    if prec == "f32":
        losses = st["losses"]
        g_prog = _slices({k: v.float() / (1 - st["b1"]) for k, v in ref.leaves(st["mom1"])})
        d_prog = change(dict(ref.leaves(st["params_k"])))
    else:
        got = ref.train_steps(m, st["params0"], batches, o, prec)
        losses, g_prog, d_prog = got["losses"], _slices(got["grads1"]), change(got["params"])
    gn_ref, gn_prog = _norms(g_ref), _norms(g_prog)
    med_g = float(np.median(list(gn_ref.values())))
    moved = {k for k, v in gn_ref.items() if v >= 1e-3 * med_g}
    grad_gap, g_worst = _gap(gn_prog, gn_ref, lambda k: True)
    change_gap, d_worst = _gap(_norms(d_prog), _norms(d_ref), lambda k: k in moved)
    loss_gap = max(abs(a - b) for a, b in zip(losses, want["losses"]))
    median_grad_gap = float(np.median([abs(gn_prog[k] - gn_ref[k]) / gn_ref[k]
                                       for k in gn_ref if gn_ref[k] > 0]))
    st["check_detail"] = (f"losses {losses} against {want['losses']}; worst gradient leaf "
                          f"{g_worst}, worst change leaf {d_worst}; "
                          f"{len(gn_ref) - len(moved)} of {len(gn_ref)} leaves left out of "
                          f"the change (reference gradient under 1e-3 of the median leaf's)")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "median_grad_gap": median_grad_gap}


def check(rec, ref, device, log) -> Dict[str, Dict[str, float]]:
    got = readings(rec, ref, device)
    log(f"[check] {rec.state['check_detail']}")
    lim = rec.cell.limits
    return {k: {"value": float(v), "limit": lim[k]} for k, v in got.items()}
