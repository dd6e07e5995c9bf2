"""The decode step as CUDA graphs (``LM.decode_graph``, ``ServingEngine.step``).

On the CPU: the engine keeps its ``tokens``, ``pos`` and cache tensors (their
storage) over admissions and steps and makes no graph; a model with a kernel
hook, or on the CPU, is not captured; a graph runs only the model it was
made from; the kernels' counters are read and advanced together; no span
records while a stream captures.

On a card (``-m cuda``): for every served family, six requests through two
slots (slots reused, idle slots running on), each step of the graphed engine
gives bit for bit the logits of the eager step run on a copy of its state by
a twin with the same kernels (an LM with ``decode_fn=ops.decode_attention``,
whose hook keeps its step eager), and the same launches counted; a model
swapped into the engine after its capture runs its own step; a graphed
step's spans under ``runtime.enable()`` (a replay's ``model.backbone``
among them); and a profile of replays holding
every decode launch counted.  These tests import neither JAX nor the JAX
package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_graph.py
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import counts, ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models import LM, reduced
from repro_torch.models.transformer import DecodeGraph
from repro_torch.obs import runtime
from repro_torch.serve.engine import ServingEngine

# six requests (prompt length, new tokens) through two slots
SHAPES = [(12, 3), (5, 9), (12, 4), (20, 2), (5, 6), (12, 5)]
# every served family: (architecture, overrides of its reduced config)
FAMILIES = {
    "dense": ("qwen1.5-0.5b", {}),
    "dense-bf16": ("minitron-8b", {"dtype": "bfloat16"}),
    "vlm": ("qwen2-vl-72b", {}),
    "moe": ("qwen2-moe-a2.7b", {}),
    "moe-mla": ("deepseek-v3-671b", {}),
    "hybrid": ("recurrentgemma-9b", {}),
    "rwkv6": ("rwkv6-3b", {}),
    "float8-kv": ("minitron-8b", {"dtype": "bfloat16", "kv_dtype": "float8_e4m3fn"}),
}


def _requests(vocab, seed=10):
    rng = np.random.default_rng(seed)
    return [(f"req{i}", rng.integers(0, vocab, n).tolist(), m)
            for i, (n, m) in enumerate(SHAPES)]


def _serve(engine, requests):
    """Admit requests as slots free up and step until all have finished;
    returns the tokens and the number of steps."""
    pending, done, steps = list(requests), {}, 0
    while len(done) < len(requests):
        while pending and engine.free_slots():
            engine.add_request(*pending.pop(0))
        done.update(engine.step())
        steps += 1
    return done, steps


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for val in tree.values() for x in _leaves(val)]
    if isinstance(tree, (list, tuple)):
        return [x for val in tree for x in _leaves(val)]
    return [] if tree is None else [tree]


def _tiny(device="cpu", **kw):
    cfg = reduced(get_config("qwen1.5-0.5b"))
    model = LM(cfg, device=device, **kw)
    return model, model.init(torch.Generator(device=device).manual_seed(0))


# -- on the CPU --------------------------------------------------------------------
def test_engine_keeps_its_tensors_and_makes_no_graph_on_the_cpu():
    model, params = _tiny()
    eng = ServingEngine(model, params, max_batch=2, max_seq=32)
    tensors = [eng.tokens, eng.pos] + _leaves(eng.caches)
    ptrs = [t.data_ptr() for t in tensors]
    done, steps = _serve(eng, _requests(model.cfg.vocab))
    assert len(done) == len(SHAPES) and steps > len(SHAPES)
    assert [t.data_ptr() for t in [eng.tokens, eng.pos] + _leaves(eng.caches)] == ptrs
    assert eng.graph is None and eng.captures == 0 and eng.replays == 0


def test_decode_graph_needs_a_card_and_no_kernel_hook():
    model, params = _tiny()
    assert model.decode_capturable
    for kw in ({"decode_fn": ops.decode_attention}, {"attn_fn": ops.attention},
               {"mix_fn": ops.rwkv6}):
        assert not LM(model.cfg, device="cpu", **kw).decode_capturable
    caches = model.init_cache(2, 16)
    tokens, pos = torch.zeros(2, dtype=torch.long), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="no CUDA graph"):
        model.decode_graph(params, tokens, pos, caches)


def test_counters_are_read_and_advanced_together(monkeypatch):
    monkeypatch.setattr(flash_decode, "launches", 5)
    monkeypatch.setattr(flash_decode, "kind_launches", {"a": 1})
    monkeypatch.setattr(flash_attention, "launches", 2)
    monkeypatch.setattr(rwkv6_scan, "launches", 0)
    before = counts.snapshot()
    flash_decode.launches += 3
    flash_decode.kind_launches["a"] += 2
    flash_decode.kind_launches["b"] = 1
    delta = counts.since(before)
    assert delta[("flash_decode", "launches")] == 3
    assert delta[("flash_decode", "kind_launches")] == {"a": 2, "b": 1}
    assert delta[("flash_attention", "launches")] == 0
    counts.add(delta, -1)                     # what a capture counted, taken back
    before[("flash_decode", "kind_launches")]["b"] = 0
    assert counts.snapshot() == before
    counts.add(delta)
    counts.add(delta)                         # two replays
    assert flash_decode.launches == 11 and flash_decode.kind_launches == {"a": 5, "b": 2}
    assert flash_attention.launches == 2 and rwkv6_scan.launches == 0


class _StubGraph:
    """A stand-in for an engine's graph on the CPU: its call runs the model
    it was made from eagerly on the engine's tensors and counts a replay."""

    serves = DecodeGraph.serves

    def __init__(self, engine):
        self.model = engine.model
        self.args = (engine.params, engine.tokens, engine.pos, engine.caches)
        self.captures = self.replays = 0

    def __call__(self):
        self.replays += 1
        return self.model.decode_step(*self.args)[0]


def test_a_graph_runs_only_the_model_it_was_made_from():
    model, params = _tiny()
    eng = ServingEngine(model, params, max_batch=2, max_seq=32)
    stub = eng.graph = _StubGraph(eng)
    eng.add_request("r0", [1, 2, 3], 8)
    eng.step()
    assert (stub.replays, eng.replays) == (1, 1)
    calls = []

    def hook(q, k, v, lengths):
        calls.append(k.data_ptr())
        return ops.decode_attention(q, k, v, lengths)

    eng.model = LM(model.cfg, device="cpu", decode_fn=hook)
    eng.step()                        # the hooked model steps eagerly: its hook runs
    assert len(calls) == model.cfg.n_layers and stub.replays == 1 and eng.graph is stub
    eng.model = model
    eng.step()                        # its model back: the graph runs again
    assert len(calls) == model.cfg.n_layers and (stub.replays, eng.replays) == (2, 2)
    assert not stub.serves(model, dict(params), eng.caches)
    assert not stub.serves(model, params, list(eng.caches))


def test_no_span_records_while_a_stream_captures(monkeypatch):
    runtime.drain()
    runtime.enable()
    try:
        model, params = _tiny()
        eng = ServingEngine(model, params, max_batch=2, max_seq=32)
        eng.add_request("r0", [1, 2, 3], 4)
        runtime.drain()
        with monkeypatch.context() as patch:
            patch.setattr(torch.cuda, "is_initialized", lambda: True)
            patch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
            eng.step()
        assert runtime.drain() == []
        eng.step()
        spans = runtime.drain()
    finally:
        runtime.disable()
    steps = [s for s in spans if s.kind == "model.decode_step"]
    assert len(steps) == 1 and steps[0].attrs["replay"] is False


# -- on a card ----------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_clone(v) for v in tree]
    return None if tree is None else tree.clone()


def _beside_its_eager_twin(engine, twin, out):
    """Before each of ``engine``'s steps, run ``twin``'s eager step on a copy
    of the engine's state; record in ``out`` both steps' logits and the
    launches each counted."""
    real = engine._decode

    def decode():
        before = counts.snapshot()
        want = twin.decode_step(engine.params, engine.tokens.clone(), engine.pos.clone(),
                                _clone(engine.caches))[0]
        want_counts = counts.since(before)
        before = counts.snapshot()
        got = real()
        out.append((got.clone(), want, counts.since(before), want_counts))
        return got

    engine._decode = decode


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(FAMILIES))
def test_graphed_engine_gives_the_eager_tokens(cuda_device, family):
    """Each step of the graphed engine against the eager step of a twin that
    runs the same kernels in the same order on a copy of the same state (its
    ``decode_fn`` hook keeps it eager): every slot's logits, busy or idle,
    bit for bit."""
    arch, over = FAMILIES[family]
    cfg = reduced(get_config(arch), **over)
    graphed = LM(cfg, device=cuda_device)
    twin = LM(cfg, device=cuda_device, decode_fn=ops.decode_attention)
    assert graphed.decode_capturable and not twin.decode_capturable
    params = graphed.init(torch.Generator(device=cuda_device).manual_seed(3))
    reqs = _requests(cfg.vocab)
    eng = ServingEngine(graphed, params, max_batch=2, max_seq=32)
    steps = []
    _beside_its_eager_twin(eng, twin, steps)
    done, n = _serve(eng, reqs)
    assert {rid: len(t) for rid, t in done.items()} == {r[0]: r[2] + 1 for r in reqs}
    assert n == len(steps) and eng.captures == 1 and eng.replays == n - 1
    for i, (got, want, got_counts, want_counts) in enumerate(steps):
        assert torch.equal(got, want), \
            f"step {i}: max |diff| {(got.float() - want.float()).abs().max().item()}"
        assert got_counts == want_counts, f"step {i}"


@pytest.mark.cuda
def test_a_model_swapped_in_after_the_capture_runs_its_own_step(cuda_device):
    model, params = _tiny(cuda_device)
    eng = ServingEngine(model, params, max_batch=2, max_seq=32)
    eng.add_request("r0", [1, 2, 3], 20)
    for _ in range(3):
        eng.step()
    assert (eng.captures, eng.replays) == (1, 2)
    (cache,) = eng.caches
    seen = []

    def hook(q, k, v, lengths):
        seen.append(k.data_ptr())
        return ops.decode_attention(q, k, v, lengths)

    eng.model = LM(model.cfg, device=cuda_device, decode_fn=hook)
    eng.step()
    assert seen == [cache["k"][i].data_ptr() for i in range(model.cfg.n_layers)]
    assert (eng.captures, eng.replays) == (1, 2)
    eng.model = model
    eng.step()
    assert (eng.captures, eng.replays) == (1, 3) and len(seen) == model.cfg.n_layers
    other = LM(model.cfg, device=cuda_device)
    eng.model = other
    for _ in range(3):                # a graph of its own: warm-up, capture, replay
        eng.step()
    assert (eng.captures, eng.replays) == (2, 5) and eng.graph.model is other


@pytest.mark.cuda
def test_no_collection_runs_inside_the_capture(cuda_device, monkeypatch):
    """A collection inside the capture that frees a dead graph (here one left
    in a reference cycle) destroys it, which the capture forbids: the
    collector is off while the step is captured, and on again after."""
    model, params = _tiny(cuda_device)
    dead = ServingEngine(model, params, max_batch=2, max_seq=32)
    dead.add_request("r0", [1, 2, 3], 10)
    for _ in range(3):
        dead.step()
    dead.cycle = dead
    del dead
    collecting = []
    backbone = LM._backbone

    def watched(self, *args, **kw):
        if torch.cuda.is_current_stream_capturing():
            collecting.append(gc.isenabled())
            if gc.isenabled():
                gc.collect()
        return backbone(self, *args, **kw)

    monkeypatch.setattr(LM, "_backbone", watched)
    eng = ServingEngine(model, params, max_batch=2, max_seq=32)
    eng.add_request("r0", [1, 2, 3], 10)
    for _ in range(3):
        eng.step()
    assert collecting == [False] and gc.isenabled()
    assert (eng.captures, eng.replays) == (1, 2)


@pytest.mark.cuda
def test_graphed_step_records_the_eager_spans(cuda_device):
    model, params = _tiny(cuda_device)
    runtime.drain()
    runtime.enable()
    try:
        eng = ServingEngine(model, params, max_batch=2, max_seq=32)
        eng.add_request("r0", [1, 2, 3], 10)
        for _ in range(5):
            eng.step()
        spans = runtime.drain()
    finally:
        runtime.disable()
    ids = {s.attrs["id"]: s for s in spans}

    def parent(s):
        return ids[s.attrs["parent"]].kind if s.attrs["parent"] is not None else None

    steps = [s for s in spans if s.kind == "model.decode_step"]
    heads = [s for s in spans if s.kind == "model.logits" and parent(s) != "model.prefill"]
    backbones = [s for s in spans if s.kind == "model.backbone"]
    assert (eng.captures, eng.replays) == (1, 4)
    # each replay's backbone under its step, with the card's time; the eager step has none
    assert [parent(s) for s in backbones] == ["model.decode_step"] * 4
    assert all(s.attrs.get("device_ms", 0) > 0 for s in backbones)
    assert [s.attrs["replay"] for s in steps] == [False, True, True, True, True]
    assert [parent(s) for s in steps] == ["serve.step"] * 5
    # the capture recorded none: one head a step, each under its step
    assert [parent(s) for s in heads] == ["model.decode_step"] * 5
    assert [s.attrs.get("device_ms", 0) > 0 for s in steps + heads] == [True] * 10, \
        [(s.kind, s.attrs) for s in steps + heads]


@pytest.mark.cuda
def test_profile_holds_the_replayed_decode_kernels(cuda_device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, params = _tiny(cuda_device)
    eng = ServingEngine(model, params, max_batch=2, max_seq=32)
    eng.add_request("r0", [1, 2, 3], 100)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    before = flash_decode.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
    counted = flash_decode.launches - before
    seen = sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and "flash_decode" in e.name())
    assert counted == 4 * model.cfg.n_layers
    assert seen >= counted
