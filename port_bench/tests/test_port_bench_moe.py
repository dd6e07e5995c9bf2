"""The ``moonlight-16b-a3b.chat`` cell's files at a tiny size on the CPU:
the cell end to end (``--trace 0`` and ``1``), its check against each
serving fault, a dropped claim and the float8 control, the sample it
checks, the configuration against the published one, the weights against
the port's layout, ``costs_moe`` against hand arithmetic, the reference
against a loop token by token, and the seven readers on a synthetic
session (None where the program has no such spans)."""
import contextlib
import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from port_bench import costs_moe, faults
from port_bench.harness import ROOT, Record, load_cell, reader, run_cell, use_program
from port_bench.reference import moe as ref
from port_bench.reference.dense import leaves
from port_bench.weights_moe import make_moe

from .test_port_bench_cells import KEYS
from .tiny import CPU, bench

use_program()

from repro_torch.obs import runtime  # noqa: E402
from repro_torch.obs.tracing import Span  # noqa: E402

CELL = "moonlight-16b-a3b.chat"
# this cell's own tiny sizes: three layers (one dense, two with experts), 8 experts, top 3
MODEL = {"n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 4, "head_dim": 16,
         "d_ff": 96, "vocab": 300,
         "mla": {"kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                 "v_head_dim": 16},
         "moe": {"n_experts": 8, "top_k": 3, "d_expert": 32}}
SHRINK = {"config": {"model": MODEL, "serve": {"max_batch": 4, "max_seq": 128}},
          "traffic": {"rate_per_s": 10.0,
                      "prompt": {"median": 24, "sigma": 0.5, "min": 8, "max": 48},
                      "output": {"median": 8, "sigma": 0.5, "min": 4, "max": 16},
                      "warmup_prompts": [8, 48], "warmup_new": 2, "drain_s": 30,
                      "check": {"min_tokens": 64, "max_requests": 8},
                      "trace": {"at": [0.3, 0.6], "seconds": 0.3}},
          "limits": {"q90_logit_gap": 0.02, "request_median_gap": 0.01, "dropped_claims": 0.5}}
READERS = ("decode_step_ms.chat", "decode_graph_pct.chat", "decode_device_ms.chat",
           "decode_roofline_pct.chat", "moe_prefill_ms.chat", "mla_prefill_ms.chat")


def tiny_model(**over):
    m = load_cell(bench(), CELL, {"config": {"model": MODEL}}).config["model"]
    return dict(m, **over)


def run(seed=2 ** 31 + 77, trace=False, log=lambda _: None):
    return run_cell(bench(), CELL, seed, 1.0, trace, CPU, time.perf_counter(),
                    shrink=copy.deepcopy(SHRINK), log=log)


# -- the cell end to end ---------------------------------------------------------------
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_cell_end_to_end(trace):
    lines = []
    out = json.loads(json.dumps(run(trace=trace, log=lines.append)))
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert {k: v["limit"] for k, v in out["checks"].items()} == SHRINK["limits"]
    assert all(v["value"] <= v["limit"] for v in out["checks"].values())
    if not trace:
        assert set(out["metrics"]) == {"setup_s", "tpot_p95_ms"}
    # every claim computed: the counter's claims a layer equal the tokens times top_k
    (claims,) = [line for line in lines if line.startswith("[experts]")]
    assert "(all computed)" in claims


def test_every_claim_is_counted_and_the_cache_is_latent():
    rec_state = {}
    lines = []
    from port_bench.drivers import serve_open_any

    real = serve_open_any.expert_claims

    def keep(rec, loop, load0, log):
        real(rec, loop, load0, log)
        rec_state.update(rec.state["claims"])

    serve_open_any.expert_claims = keep
    try:
        run(log=lines.append)
    finally:
        serve_open_any.expert_claims = real
    assert rec_state["per_layer"] == [rec_state["want"]] * 2 and rec_state["want"] > 0
    assert rec_state["dropped"] == 0
    assert rec_state["load_max_over_mean"] >= 1.0
    (occ,) = [line for line in lines if "reserved" in line]
    reserved = 4 * 128 * costs_moe.cache_bytes(tiny_model())
    assert f"of {reserved / 1e9:.3f} GB reserved" in occ


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); "
            "from port_bench.tests.test_port_bench_moe import run; run(trace=True); "
            "from port_bench.harness import jax_modules; print('LOADED', jax_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout


# -- the check --------------------------------------------------------------------------
@contextlib.contextmanager
def claims_dropped():
    """The capacity route in the dropless route's place: claims beyond an
    expert's capacity are dropped, and the counter takes none."""
    import repro_torch.models.transformer as transformer

    orig = transformer.moe_apply

    def capacity(cfg, p, x, dispatch=None, load=None):
        return orig(cfg, p, x, dispatch="einsum", load=load)

    transformer.moe_apply = capacity
    try:
        yield
    finally:
        transformer.moe_apply = orig


@pytest.mark.parametrize("kind", faults.SERVE + ("claims_dropped",))
def test_serving_fault_reads_incorrect(kind):
    with (claims_dropped() if kind == "claims_dropped" else faults.serve_fault(kind)):
        out = run()
    assert out["correct"] is False, out["checks"]
    if kind == "claims_dropped":
        assert out["checks"]["dropped_claims"]["value"] > 0


def test_half_batch_reads_in_the_request_median():
    """The fault gives the batch's upper rows the lower rows' logits: only
    the request the sample takes from the highest slot holds them."""
    with faults.serve_fault("half_batch"):
        out = run()
    checks = out["checks"]
    assert checks["request_median_gap"]["value"] > checks["request_median_gap"]["limit"]


def _served(rid, n, slot):
    from port_bench.traffic import Request

    r = Request(rid, np.arange(4), n)
    r.tokens = list(range(n))
    return r, slot


def test_sample_takes_the_longest_and_the_highest_slot_first():
    rec = Record(load_cell(bench(), CELL, copy.deepcopy(SHRINK)), 1.0)
    reqs = [_served("a", 5, 0), _served("b", 40, 1), _served("c", 3, 3), _served("d", 9, 2),
            _served("e", 0, 2)]
    rec.requests = [r for r, _ in reqs]
    rec.state.update(seed=5, slot_of={r.rid: s for r, s in reqs})
    from port_bench.drivers.serve_open_any import sample

    picked = [r.rid for r in sample(rec)]
    assert picked[:2] == ["b", "c"] and sorted(picked) == ["a", "b", "c", "d"]
    rec.cell.mix["check"]["min_tokens"] = 40
    assert [r.rid for r in sample(rec)] == ["b", "c"]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_float8_control_reads_incorrect(seed):
    """The cell's own numbers: the program's under every limit, the
    reference in float8 in the program's place over one of them."""
    from port_bench.drivers import serve_open_any
    from port_bench.harness import reference

    cell = load_cell(bench(), CELL, copy.deepcopy(SHRINK))
    rec = Record(cell, 1.0)
    serve_open_any.run(rec, seed, CPU, False, time.perf_counter(), lambda _: None)
    r = serve_open_any.readings(rec, reference("moe"), CPU, ("fp8",))
    prog, ctl = (serve_open_any.gap_numbers(r[k]) for k in ("program", "fp8"))
    assert all(v <= cell.limits[k] for k, v in prog.items()), prog
    assert any(v > cell.limits[k] for k, v in ctl.items()), ctl


# -- the configuration and the weights ---------------------------------------------------
def test_config_holds_the_published_widths():
    conf = json.loads((ROOT / "port_bench/configs/moonlight-16b-a3b.json").read_text())
    pub = conf["published"]
    # the published config's keys at the top level too, with the same values
    assert {k: conf[k] for k in pub} == pub and conf["reduced"] == []
    m = conf["model"]
    assert (m["n_layers"], m["d_model"], m["n_heads"], m["d_ff"], m["vocab"]) == (
        27, 2048, 16, 11264, 163840)
    assert m["mla"] == {"q_lora_rank": None, "kv_lora_rank": 512, "qk_nope_head_dim": 128,
                        "qk_rope_head_dim": 64, "v_head_dim": 128}
    moe = m["moe"]
    assert (moe["n_experts"], moe["top_k"], moe["d_expert"], moe["n_shared_experts"]) == (
        pub["n_routed_experts"], pub["num_experts_per_tok"], pub["moe_intermediate_size"],
        pub["n_shared_experts"])
    assert moe["n_dense_layers"] == pub["first_k_dense_replace"]
    assert moe["routed_scaling"] == pub["routed_scaling_factor"] and moe["router_bias"]
    assert moe["router_act"] == pub["scoring_func"] and moe["dispatch"] == "dropless"
    assert m["norm_eps"] == pub["rms_norm_eps"] and m["rope_theta"] == pub["rope_theta"]
    assert "deployment" in conf and "rotate-half" in conf["as_the_port_runs_it"]
    assert costs_moe.param_count(m) == 15_960_110_208
    assert costs_moe.cache_bytes(m) == 31_212


def test_weights_laid_out_as_the_port_makes_them():
    from port_bench.drivers.serve_open_any import model_config
    from repro_torch.models.transformer import LM

    m = tiny_model()
    mine = make_moe(m, 1, CPU)
    port = LM(model_config(m), device=CPU).init(torch.Generator().manual_seed(0))

    def shapes(tree):
        return [(k, tuple(v.shape), v.dtype) for k, v in leaves(tree)]

    assert shapes(mine) == shapes(port)
    assert sum(t.numel() for _, t in leaves(mine)) == costs_moe.param_count(m)
    bias = mine["segments"][1]["ffn"]["router"]["bias"].float()
    assert 0.005 < float(bias.std()) < 0.05


# -- the arithmetic -------------------------------------------------------------------------
def test_costs_by_hand():
    """d 64, 4 heads of 16 + 8 (v 16), rank 32, no q-LoRA; 8 experts of 32,
    top 3, 2 shared; one dense layer of 96 and two with experts; vocab 300,
    untied; a router bias."""
    m = tiny_model(dtype="float32")
    # MLA: q 64*4*24 + kv down 64*40 + kv_norm 32 + up 32*4*32 + out 4*16*64
    assert costs_moe.mla_params(m) == 6144 + 2560 + 32 + 4096 + 4096
    # two norms, MLA, a SwiGLU of 96 / a router 64*8 + 8, 8 experts 3*64*32, shared 3*64*64
    assert costs_moe.layer_params(m, False) == 128 + 16928 + 18432
    assert costs_moe.layer_params(m, True) == 128 + 16928 + 520 + 49152 + 12288
    assert costs_moe.param_count(m) == 19200 + 64 + 35488 + 2 * 79016 + 19200
    assert costs_moe.cache_bytes(m) == 3 * (40 * 2 + 4)
    # 2 busy tokens choose 8 (1 - (5/8)**2) = 4.875 of 8 experts a layer, so 2 x 3.125
    # experts of 6144 go unread
    assert costs_moe.experts_read(m, 2) == pytest.approx(4.875)
    assert costs_moe.experts_read(tiny_model(), 0) == 0
    assert costs_moe.decode_step_bytes(m, 2, 10) == pytest.approx(
        (231984 - 19200 - 2 * 3.125 * 6144) * 2 + 10 * 252)
    # per slot 2 x (3 layers' projections 12800, the dense SwiGLU 18432, two expert layers'
    # router 512 and 3 + 2 experts of 6144, the head 19200, absorbed q and v 3*4*32*32);
    # per cached token 2 x 3 layers x 4 heads x (2*32 + 8)
    per_slot = 3 * 12800 + 18432 + 2 * (512 + 5 * 6144) + 19200 + 12288
    assert costs_moe.decode_step_flops(m, 2, 10) == 2 * 2 * per_slot + 2 * 3 * 4 * 10 * 72
    assert costs_moe.decode_least_s(m, 2, 10) == pytest.approx(351288 / 3.35e12)


# -- the reference --------------------------------------------------------------------------
def _token_by_token(m, params, seq):
    """The model's final hidden states written as loops: each position's
    query against the keys up to it, one head at a time, and each token's
    chosen experts one at a time, in float32."""
    eps, H = m["norm_eps"], m["n_heads"]
    a_ = m["mla"]
    dn, dr, dv, r = (a_["qk_nope_head_dim"], a_["qk_rope_head_dim"], a_["v_head_dim"],
                     a_["kv_lora_rank"])

    def rms(x, s):
        return x / torch.sqrt((x * x).mean() + eps) * s

    def rot(x, t):          # rotate-half RoPE of one vector at position t
        half = x.shape[0] // 2
        out = torch.empty_like(x)
        for i in range(half):
            ang = t / m["rope_theta"] ** (i / half)
            c, s = math.cos(ang), math.sin(ang)
            out[i], out[i + half] = x[i] * c - x[i + half] * s, x[i + half] * c + x[i] * s
        return out

    xs = [params["embed"]["embedding"][t].float() for t in seq.tolist()]
    for li in range(m["n_layers"]):
        p = ref.layer_weights(m, params, li)
        at = p["attn"]
        hs = [rms(x, p["norm1"]["scale"]) for x in xs]
        q = [(h @ at["wq"]["w"]).reshape(H, dn + dr) for h in hs]
        kv = [h @ at["wdkv"]["w"] for h in hs]
        c = [rms(v[:r], at["kv_norm"]["scale"]) for v in kv]
        kpe = [rot(v[r:], t) for t, v in enumerate(kv)]
        kn = [(ci @ at["wuk"]["w"]).reshape(H, dn) for ci in c]
        vv = [(ci @ at["wuv"]["w"]).reshape(H, dv) for ci in c]
        new = []
        for t in range(len(xs)):
            heads = []
            for h in range(H):
                qh = torch.cat([q[t][h, :dn], rot(q[t][h, dn:], t)])
                sc = torch.stack([qh @ torch.cat([kn[s][h], kpe[s]]) for s in range(t + 1)])
                w = torch.softmax(sc / math.sqrt(dn + dr), dim=0)
                heads.append(sum(w[s] * vv[s][h] for s in range(t + 1)))
            new.append(xs[t] + torch.cat(heads) @ at["wo"]["w"])
        xs = new
        out = []
        for x in xs:
            h = rms(x, p["norm2"]["scale"])
            ffn = p["ffn"]

            def swiglu(wi, wg, wo):
                return (F.silu(h @ wg) * (h @ wi)) @ wo

            if not p["experts"]:
                y = swiglu(ffn["wi"]["w"], ffn["wg"]["w"], ffn["wo"]["w"])
            else:
                s = torch.sigmoid(h @ ffn["router"]["w"])
                bias = ffn["router"]["bias"]
                chosen = sorted(range(s.shape[0]), key=lambda e: -float(s[e] + bias[e]))
                chosen = chosen[:m["moe"]["top_k"]]
                total = sum(float(s[e]) for e in chosen)
                ex = ffn["experts"]
                y = sum(float(s[e]) / total * m["moe"]["routed_scaling"]
                        * swiglu(ex["wi"][e], ex["wg"][e], ex["wo"][e]) for e in chosen)
                sh = ffn["shared"]
                y = y + swiglu(sh["wi"]["w"], sh["wg"]["w"], sh["wo"]["w"])
            out.append(x + y)
        xs = out
    return torch.stack([rms(x, params["final_norm"]["scale"].float()) for x in xs])


def test_reference_against_a_loop_token_by_token():
    m = tiny_model(dtype="float32")
    params = make_moe(m, 3, CPU)
    seq = torch.tensor([5, 17, 250, 3, 99, 42, 7])
    got = ref.hidden_states(m, params, [seq], [0])[0]
    want = _token_by_token(m, params, seq)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_the_float8_control_reads_wider_than_the_program():
    """On the served run's own requests: the gaps of the reference in float8
    above the program's (bf16 weights, a bf16 cache, the dropless route),
    by each number the check compares."""
    from port_bench.drivers import serve_open_any
    from port_bench.harness import reference

    cell = load_cell(bench(), CELL, copy.deepcopy(SHRINK))
    rec = Record(cell, 1.0)
    serve_open_any.run(rec, 2 ** 31 + 5, CPU, False, time.perf_counter(), lambda _: None)
    r = serve_open_any.readings(rec, reference("moe"), CPU, ("fp8",))
    assert len(r["program"]) == len(r["fp8"]) == rec.state["checked"][0] > 1
    prog, ctl = (serve_open_any.gap_numbers(r[k]) for k in ("program", "fp8"))
    assert all(ctl[k] > prog[k] for k in prog), (prog, ctl)
    # the share of tokens off the reference's best, too
    frac = {k: float((np.concatenate(r[k]) > 0).mean()) for k in r}
    assert frac["fp8"] > 2 * frac["program"]


# -- the readers ------------------------------------------------------------------------------
MS = 1_000_000


def _span(kind, sid, parent, t0, t1, device_ms=None, **attrs):
    a = {"id": sid, "parent": parent, **attrs}
    if device_ms is not None:
        a["device_ms"] = device_ms
    return Span(kind, 5, int(t0 * MS), int(t1 * MS), attrs=a)


def _session(backbone=True):
    """One prefill of two layers (MLA 3 + 4 ms, MoE 5 ms) and two replayed
    decode steps (their backbones 40 and 50 ms, heads 2 and 4 ms on the card;
    50 and 70 ms on the host), then a stray backbone outside any step."""
    out = [_span("serve.add_request", 1, None, 0, 20),
           _span("model.prefill", 2, 1, 1, 19, device_ms=15.0),
           _span("model.mla", 3, 2, 1, 2, device_ms=3.0),
           _span("model.mla", 4, 2, 3, 4, device_ms=4.0),
           _span("model.moe", 5, 2, 5, 6, device_ms=5.0),
           _span("model.logits", 6, 2, 7, 8, device_ms=1.0)]
    sid = 7
    for i, (host, bb, head) in enumerate(((50, 40.0, 2.0), (70, 50.0, 4.0))):
        t = 100 + 100 * i
        out.append(_span("serve.step", sid, None, t, t + host))
        out.append(_span("model.decode_step", sid + 1, sid, t, t + 1, replay=True))
        if backbone:
            out.append(_span("model.backbone", sid + 2, sid + 1, t, t + 1, device_ms=bb))
        out.append(_span("model.logits", sid + 3, sid + 1, t, t + 1, device_ms=head))
        sid += 4
    out.append(_span("model.backbone", sid, None, 900, 901, device_ms=1000.0))
    return out


class _Trace:
    t0, t1, busy_s, window_s = 0.0, 10.0, 6.0, 8.0


def _record(traced=True):
    from port_bench.trace import Span as HarnessSpan

    rec = Record(load_cell(bench(), CELL), 1.0)
    rec.trace = _Trace() if traced else None
    rec.spans = [HarnessSpan("step", 1.0, 1.1, {"batch": 64, "live_slots": 64 * 1500}),
                 HarnessSpan("step", 2.0, 2.1, {"batch": 32, "live_slots": 32 * 1000})]
    return rec


@pytest.mark.parametrize("name,want", [("decode_step_ms.chat", 60.0),
                                       ("decode_graph_pct.chat", 100.0),
                                       ("decode_device_ms.chat", 48.0),
                                       ("moe_prefill_ms.chat", 5.0),
                                       ("mla_prefill_ms.chat", 7.0),
                                       ("device_idle_pct.chat", 25.0)])
def test_readers_on_a_synthetic_session(name, want, monkeypatch):
    monkeypatch.setattr(runtime, "profile_spans", _session)
    assert reader(name)(_record()) == pytest.approx(want)


def test_roofline_reader_on_a_synthetic_session(monkeypatch):
    monkeypatch.setattr(runtime, "profile_spans", _session)
    rec = _record()
    least = (costs_moe.decode_least_s(rec.model, 64, 96000)
             + costs_moe.decode_least_s(rec.model, 32, 32000)) / 2
    assert reader("decode_roofline_pct.chat")(rec) == pytest.approx(100.0 * 1e3 * least / 48.0)
    assert 15 < 100.0 * 1e3 * least / 48.0 < 25


@pytest.mark.parametrize("name", READERS + ("device_idle_pct.chat",))
def test_none_without_a_kept_profile(name, monkeypatch):
    monkeypatch.setattr(runtime, "profile_spans", _session)
    assert reader(name)(_record(traced=False)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_where_the_program_has_no_runtime_spans(name, monkeypatch):
    monkeypatch.setattr(runtime, "profile_spans", lambda: [])
    assert reader(name)(_record()) is None
    monkeypatch.setitem(sys.modules, "repro_torch.obs.runtime", None)   # a program without them
    assert reader(name)(_record()) is None


@pytest.mark.parametrize("name", ("decode_device_ms.chat", "decode_roofline_pct.chat"))
def test_none_where_replays_open_no_backbone_span(name, monkeypatch):
    """The parent's program: its replays open ``model.decode_step`` and
    ``model.logits`` but no ``model.backbone``."""
    monkeypatch.setattr(runtime, "profile_spans", lambda: _session(backbone=False))
    assert reader(name)(_record()) is None
