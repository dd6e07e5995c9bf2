"""The admission loop of the serving driver: ``serve_demo``'s loop from
``repro_torch/launch/serve.py``, frozen here and timed.  Admit each
request that is due into a free slot (``ServingEngine.add_request``, which
prefills it and returns after its first token is on the host), then decode
one step for every slot (``ServingEngine.step``, which returns after the
step's tokens are on the host).  Every call is a span on the host clock;
every token gets the time its call returned.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from .trace import Span, Tracer, annotate
from .traffic import Request

__all__ = ["ServeLoop"]


class ServeLoop:
    """Drives one ``ServingEngine`` over a list of requests, each admitted
    no earlier than its ``due`` time, and records what happened."""

    def __init__(self, engine, requests: Sequence[Request], tracer: Optional[Tracer] = None):
        self.engine = engine
        self.requests = list(requests)
        self.tracer = tracer
        self.pending = deque(sorted(self.requests, key=lambda r: r.due))
        self.waiting: deque = deque()
        self.slot_req: Dict[int, Request] = {}
        # each slot's next position, as the engine keeps it on the device:
        # set at admission, advanced for every slot, busy or idle, each step
        self.pos = np.zeros(engine.max_batch, dtype=np.int64)
        self.spans: List[Span] = []
        self.steps = 0
        self.t0 = 0.0

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def admit(self, req: Request) -> None:
        eng = self.engine
        t_a = self.now()
        with annotate(self.tracer, "bench.prefill"):
            slot = eng.add_request(req.rid, req.prompt, req.n_out)
        t_b = self.now()
        req.admitted, req.first = t_a, t_b
        req.tokens = eng.slots[slot].generated      # the engine's own list, which it extends
        req.token_times = [t_b]
        self.slot_req[slot] = req
        self.pos[slot] = len(req.prompt)
        self.spans.append(Span("prefill", t_a, t_b, {"tokens": len(req.prompt)}))

    def step(self) -> None:
        eng = self.engine
        cap = eng.max_seq
        lengths = np.minimum(self.pos + 1, cap)
        t_a = self.now()
        with annotate(self.tracer, "bench.step"):
            finished = eng.step()
        t_b = self.now()
        self.steps += 1
        busy = list(self.slot_req)
        self.spans.append(Span("step", t_a, t_b, {"batch": len(busy),
                                                   "live_slots": int(lengths[busy].sum())}))
        for slot, req in list(self.slot_req.items()):
            req.token_times.append(t_b)
            if req.rid in finished:
                req.tokens, req.done = finished[req.rid], t_b
                del self.slot_req[slot]
        self.pos += 1

    def run(self, seconds: float, drain_s: float = 0.0) -> float:
        """Serve until ``seconds`` into the window; then on until every
        request due in the window has its first token, for at most
        ``drain_s`` more.  Returns the window's length as served: the
        time the last call that started inside it returned."""
        self.t0 = time.perf_counter()
        end = None
        while True:
            now = self.now()
            if self.tracer is not None:
                self.tracer.tick(now)
            if end is None and now >= seconds:
                end = now
                if self.tracer is not None:
                    self.tracer.close(now)
            if end is not None:
                unserved = any(r.first is None for r in self.requests)
                if not unserved or now >= seconds + drain_s:
                    return end
            while self.pending and self.pending[0].due <= now:
                self.waiting.append(self.pending.popleft())
            while self.waiting and self.engine.free_slots():
                self.admit(self.waiting.popleft())
            if self.slot_req:
                self.step()
            elif self.pending:
                time.sleep(max(0.0, min(self.pending[0].due, seconds) - self.now()))
            elif end is None:
                time.sleep(max(0.0, seconds - self.now()))


# -- set-up and check, shared by the serving drivers -------------------------------
def counters() -> Dict[str, int]:
    """The port's own launch counts of its two attention kernels."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode

    return {"flash_attention": flash_attention.launches, "flash_decode": flash_decode.launches}


def setup(rec, seed: int, device, log) -> "object":
    """The model, the benchmark's weights and the engine of ``rec``'s cell,
    warmed up on the mix's ``warmup_prompts`` (each prefill shape's kernels
    and a decode step at the engine's batch, which every step has)."""
    import torch

    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import ServingEngine

    from .traffic import warmup_requests
    from .weights import make_dense

    config, mix = rec.cell.config, rec.cell.mix
    m = config["model"]
    t = [time.perf_counter()]
    model = LM(ModelConfig(**m), device=device)
    params = make_dense(m, seed, device)
    eng = ServingEngine(model, params, **config["serve"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t.append(time.perf_counter())
    for req in warmup_requests(mix, seed, m["vocab"]):
        eng.add_request(req.rid, req.prompt, req.n_out)
    while eng.active:
        eng.step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t.append(time.perf_counter())
    log(f"[setup] weights and cache {t[1] - t[0]:.3f} s, warm-up {t[2] - t[1]:.3f} s")
    rec.state.update(model=model, params=params, engine=eng, seed=seed)
    return eng


def occupancy(model: Dict, loop: ServeLoop, until: float) -> Dict[str, float]:
    """What the steps that started before ``until`` kept in use: busy slots
    a step (mean, max) and the busy slots' KV cache in bytes (mean, max),
    beside the slots and the cache bytes the engine reserves."""
    steps = [s for s in loop.spans if s.name == "step" and s.t0 < until]
    from .weights import torch_dtype

    per_slot = (2 * model["n_layers"] * model["n_kv_heads"] * model["head_dim"]
                * torch_dtype(model["dtype"]).itemsize)
    busy = np.asarray([s.attrs["batch"] for s in steps] or [0])
    live = per_slot * np.asarray([s.attrs["live_slots"] for s in steps] or [0])
    eng = loop.engine
    return {"busy_mean": float(busy.mean()), "busy_max": int(busy.max()),
            "slots": eng.max_batch, "live_bytes_mean": float(live.mean()),
            "live_bytes_max": int(live.max()),
            "reserved_bytes": per_slot * eng.max_batch * eng.max_seq}


def finish(rec, loop: ServeLoop, device) -> None:
    """Read what the window left: spans, the device's peak memory."""
    import torch

    rec.spans = loop.spans
    rec.steps = loop.steps
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    if loop.tracer is not None:
        rec.trace = loop.tracer.finish()
        rec.trace_attempts = loop.tracer.attempts


def sample(rec) -> List[Request]:
    """The requests the reference checks: drawn from the seed among those
    the window finished, the one with the most served tokens first, then in
    the drawn order until the mix's ``check.min_tokens`` served tokens or
    ``check.max_requests`` requests."""
    from .traffic import seed_rng

    done = [r for r in rec.requests if r.done is not None]
    if not done:
        return []
    chk = rec.cell.mix["check"]
    order = [done[i] for i in seed_rng(rec.state["seed"], 3).permutation(len(done))]
    longest = max(done, key=lambda r: len(r.tokens))
    picked, n = [longest], len(longest.tokens)
    for r in order:
        if n >= chk["min_tokens"] or len(picked) >= chk["max_requests"]:
            break
        if r is not longest:
            picked.append(r)
            n += len(r.tokens)
    return picked


def readings(rec, ref, device, controls: Sequence[str] = ()) -> Dict[str, np.ndarray]:
    """The gap of every served token of the sample below the float32
    reference's best logit at its position (``"program"``), and, for each
    precision in ``controls``, the gap of the token that the reference at
    that precision puts first.  Frees the engine first."""
    import gc

    import torch

    for key in ("engine", "model"):
        rec.state.pop(key, None)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref.exact_matmul()
    m, params = rec.model, rec.state["params"]
    picked = sample(rec)
    if not picked:
        return {}
    seqs, keep, served = [], [], []
    for r in picked:
        toks = np.concatenate([r.prompt, np.asarray(r.tokens[:-1], dtype=np.int64)])
        seqs.append(torch.as_tensor(toks, device=device))
        keep.append(len(r.prompt) - 1)
        served.append(torch.as_tensor(np.asarray(r.tokens, dtype=np.int64), device=device))
    h32 = ref.hidden_states(m, params, seqs, keep, "f32")
    w = ref.head(m, params)
    out = {"program": torch.cat([ref.logit_gaps(w, h, t) for h, t in zip(h32, served)])}
    for prec in controls:
        hq = ref.hidden_states(m, params, seqs, keep, prec)
        out[prec] = torch.cat([ref.logit_gaps(w, h, None, h_first=q) for h, q in zip(h32, hq)])
    rec.state["checked"] = (len(picked), sum(len(r.tokens) for r in picked))
    return {k: v.double().cpu().numpy() for k, v in out.items()}


def check(rec, ref, device, log) -> Dict[str, Dict[str, float]]:
    """The widest gap by which a served token's logit lies below the float32
    reference's best, over the sample, against the cell's limit.  With no
    finished request to check the value is None, which is not correct."""
    gaps = readings(rec, ref, device).get("program")
    value = float(gaps.max()) if gaps is not None and gaps.size else None
    n_req, n_tok = rec.state.get("checked", (0, 0))
    log(f"[check] {n_req} finished requests, {n_tok} served tokens against the float32 "
        f"reference; widest gap below its best logit {value}")
    return {"max_logit_gap": {"value": value, "limit": rec.cell.limits["max_logit_gap"]}}
