"""Open loop, as ``serve_open`` runs it (``traffic.open_loop`` and the
admission loop of ``serving.py``), for a model of any served family:
the configuration's nested groups (``mla``, ``moe``) become the program's
dataclasses, its ``family`` picks the maker of the benchmark's weights
(``make_dense`` for ``dense``, ``make_moe`` for ``moe``), and the run logs
the cache its busy slots kept in use in the family's own layout (a latent
cache under MLA).  Where the program counts the claims its experts computed
(``LM.expert_load``), the run logs them over the window and its drain
against the tokens computed times ``top_k``, and the expert load's most
over its mean.  The check (:func:`check`) holds those claims to the tokens
times ``top_k``, and a sample of the served requests, the one served in the
highest slot among them, to the float32 reference: the 90th percentile of
the served tokens' gaps below the reference's best logit, and the widest of
the sampled requests' median gaps."""
from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np

from .. import costs_moe, serving
from ..trace import Tracer
from ..traffic import Request, open_loop, seed_rng, warmup_requests
from ..weights import make_dense
from ..weights_moe import make_moe

WEIGHTS = {"dense": make_dense, "moe": make_moe}


class Loop(serving.ServeLoop):
    """``serving.ServeLoop`` that keeps the slot each request was served in
    (``slot_of``, by request id)."""

    def __init__(self, engine, requests, tracer=None):
        super().__init__(engine, requests, tracer=tracer)
        self.slot_of: Dict[str, int] = {}

    def admit(self, req: Request) -> None:
        super().admit(req)
        self.slot_of[req.rid] = next(s for s, r in self.slot_req.items() if r is req)


def model_config(m: Dict):
    """The program's ``ModelConfig`` of a configuration's ``model`` group,
    its ``mla`` and ``moe`` groups as the program's dataclasses."""
    from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

    nested = {"mla": MLAConfig, "moe": MoEConfig}
    return ModelConfig(**{k: nested[k](**v) if k in nested and v is not None else v
                          for k, v in m.items()})


def setup(rec, seed: int, device, log):
    """The model, the benchmark's weights and the engine of ``rec``'s cell,
    warmed up on the mix's ``warmup_prompts`` (each prefill shape, and the
    decode step at the engine's batch, which the warm-up captures)."""
    import torch

    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import ServingEngine

    config, mix = rec.cell.config, rec.cell.mix
    m = config["model"]
    t = [time.perf_counter()]
    model = LM(model_config(m), device=device)
    params = WEIGHTS[config["family"]](m, seed, device)
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


def occupancy(m: Dict, loop: serving.ServeLoop, until: float) -> Dict[str, float]:
    """``serving.occupancy``, with an MLA model's cache bytes a token: the
    latent ``c_kv``, ``k_pe`` and position of every layer."""
    if m.get("attention") != "mla":
        return serving.occupancy(m, loop, until)
    per_token = costs_moe.cache_bytes(m)
    steps = [s for s in loop.spans if s.name == "step" and s.t0 < until]
    busy = np.asarray([s.attrs["batch"] for s in steps] or [0])
    live = per_token * np.asarray([s.attrs["live_slots"] for s in steps] or [0])
    eng = loop.engine
    return {"busy_mean": float(busy.mean()), "busy_max": int(busy.max()),
            "slots": eng.max_batch, "live_bytes_mean": float(live.mean()),
            "live_bytes_max": int(live.max()),
            "reserved_bytes": per_token * eng.max_batch * eng.max_seq}


def expert_claims(rec, loop: serving.ServeLoop, load0, log) -> None:
    """The claims each MoE layer's experts computed since ``load0`` (the
    program's counter before the window), against the tokens the window and
    its drain computed (every prompt's, and every slot's each step) times
    ``top_k``; kept in ``rec.state["claims"]``, with ``dropped``: the most
    any layer's claims lie from that count (a claim dropped, or computed
    twice), a whole number that the check holds under its limit of 0.5, so
    that one claim off reads incorrect."""
    load = getattr(rec.state["model"], "expert_load", None)
    if load is None or load0 is None:
        return
    per = (load - load0).cpu().numpy()                       # (MoE layers, E)
    tokens = (sum(s.attrs["tokens"] for s in loop.spans if s.name == "prefill")
              + loop.steps * loop.engine.max_batch)
    want = tokens * rec.model["moe"]["top_k"]
    sums = per.sum(axis=1)
    ratio = per.max(axis=1) / np.maximum(per.mean(axis=1), 1e-9)
    rec.state["claims"] = {"per_layer": sums.tolist(), "want": int(want),
                           "dropped": int(np.abs(want - sums).max()),
                           "load_max_over_mean": float(ratio.max())}
    log(f"[experts] claims a layer {int(sums.min())}-{int(sums.max())} against {tokens} tokens "
        f"x {rec.model['moe']['top_k']} = {want} ({'all' if (sums == want).all() else 'NOT all'}"
        f" computed); expert load max over mean {ratio.mean():.3f} by layer on average, "
        f"{ratio.max():.3f} at most")


def sample(rec) -> List[Request]:
    """The requests the reference checks, among those the run served (each
    request admitted, over the tokens it was served, finished or not): the
    one with the most served tokens, the one served in the highest slot (a
    fault confined to some rows of the batch shows there first), then
    others in an order drawn from the seed until the mix's
    ``check.min_tokens`` served tokens or ``check.max_requests`` requests."""
    done = [r for r in rec.requests if r.tokens]
    if not done:
        return []
    chk = rec.cell.mix["check"]
    slot_of = rec.state["slot_of"]
    first = (max(done, key=lambda r: len(r.tokens)), max(done, key=lambda r: slot_of[r.rid]))
    picked = {r.rid: r for r in first}
    n = sum(len(r.tokens) for r in picked.values())
    for i in seed_rng(rec.state["seed"], 3).permutation(len(done)):
        if n >= chk["min_tokens"] or len(picked) >= chk["max_requests"]:
            break
        if done[i].rid not in picked:
            picked[done[i].rid] = done[i]
            n += len(done[i].tokens)
    return list(picked.values())


def readings(rec, ref, device, controls: Sequence[str] = ()) -> Dict[str, List[np.ndarray]]:
    """For each request of :func:`sample`, the gap of every served token below
    the float32 reference's best logit at its position (``"program"``), and,
    for each precision in ``controls``, the gap of the token that the
    reference at that precision puts first.  Frees the engine first."""
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
    out = {"program": [ref.logit_gaps(w, h, t) for h, t in zip(h32, served)]}
    for prec in controls:
        hq = ref.hidden_states(m, params, seqs, keep, prec)
        out[prec] = [ref.logit_gaps(w, h, None, h_first=q) for h, q in zip(h32, hq)]
    rec.state["checked"] = (len(picked), sum(len(r.tokens) for r in picked))
    return {k: [g.double().cpu().numpy() for g in v] for k, v in out.items()}


def gap_numbers(gaps: Sequence[np.ndarray]) -> Dict[str, float]:
    """What the check compares of the sampled requests' gaps: the 90th
    percentile over every served token (a fault in a tenth of the tokens
    reads there), and the widest of the requests' own medians (a fault in
    one request, or in the slots it held, reads there)."""
    return {"q90_logit_gap": float(np.quantile(np.concatenate(gaps), 0.9)),
            "request_median_gap": float(max(np.median(g) for g in gaps))}


def check(rec, ref, device, log) -> Dict[str, Dict[str, float]]:
    """The claims the experts dropped (:func:`expert_claims`), and the
    gaps of :func:`readings` by :func:`gap_numbers`, against the cell's
    limits.  Not the widest gap of one token, nor one median over the whole
    sample: over 26 expert layers a rounding that flips one near tie of the
    router moves a token's later layers whole, and such flips cascade, so
    the widest gap of a few hundred tokens is as wide for the program in
    bf16 as for the reference in float8 (``PERF.md`` section 2), while a
    median over all tokens misses a fault that touches a minority of them.
    With no request served, or no counter of claims, a value is None,
    which is not correct."""
    gaps = readings(rec, ref, device).get("program")
    nums = (gap_numbers(gaps) if gaps else
            {"q90_logit_gap": None, "request_median_gap": None})
    claims = rec.state.get("claims")
    nums["dropped_claims"] = claims["dropped"] if claims else None
    n_req, n_tok = rec.state.get("checked", (0, 0))
    every = np.concatenate(gaps) if gaps else np.zeros(0)
    log(f"[check] {n_req} served requests, {n_tok} served tokens against the float32 "
        f"reference; gap below its best logit: 90th percentile {nums['q90_logit_gap']}, "
        f"widest request median {nums['request_median_gap']}, median "
        f"{float(np.median(every)) if every.size else None}, widest "
        f"{float(every.max()) if every.size else None}; claims dropped {nums['dropped_claims']}")
    return {k: {"value": v, "limit": rec.cell.limits[k]} for k, v in nums.items()}


def run(rec, seed, device, trace, t_start, log) -> None:
    import torch

    mix = rec.cell.mix
    log(f"[setup] imports and context {time.perf_counter() - t_start:.3f} s")
    eng = setup(rec, seed, device, log)
    reqs = open_loop(mix, rec.seconds, seed, rec.model["vocab"])
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    tracer = (Tracer(mix["trace"], rec.seconds, serving.counters, sync,
                     cuda=device.type == "cuda") if trace else None)
    if tracer is not None:
        tracer.warm()
    loop = Loop(eng, reqs, tracer=tracer)
    rec.state["slot_of"] = loop.slot_of
    load = getattr(rec.state["model"], "expert_load", None)
    load0 = load.clone() if load is not None else None
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
    occ = occupancy(rec.model, loop, rec.elapsed)
    log(f"[serve] busy slots a step in the window: mean {occ['busy_mean']:.2f}, max "
        f"{occ['busy_max']} of {occ['slots']}; their cache mean "
        f"{occ['live_bytes_mean'] / 1e9:.3f} GB, max {occ['live_bytes_max'] / 1e9:.3f} GB, "
        f"of {occ['reserved_bytes'] / 1e9:.3f} GB reserved")
    expert_claims(rec, loop, load0, log)
    serving.finish(rec, loop, device)
