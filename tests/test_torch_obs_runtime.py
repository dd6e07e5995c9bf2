"""The runtime's spans (``repro_torch.obs.runtime``) on the CPU.

With no profile running and the runtime not enabled, a tiny engine's
admissions, 50 decode steps and a training step record nothing, read no
clock of the runtime's and never enter ``record_function``.  Under
``torch.profiler.profile(activities=[CPU])`` the same calls record the tree
of the ten kinds in ``RUNTIME_SCHEMA`` that a dense model opens (an MLA
and an expert layer's ``model.mla`` and ``model.moe``:
``test_torch_moe_dropless.py``; a replay's ``model.backbone``:
``test_torch_decode_graph.py``): each child inside its parent's
interval, the request ids carried, and a ``user_annotation`` of each span's
kind in the profile's events.  Two profiles are two sessions, the second
dropping the first's spans; a span on the CPU has no device events; ``span-parity`` audits ``span(...)`` calls.
"""
import textwrap
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.analysis as torch_lint
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM
from repro_torch.obs import runtime
from repro_torch.obs.tracing import RUNTIME_SCHEMA
from repro_torch.optim.optimizers import AdamW
from repro_torch.serve.engine import ServingEngine
from repro_torch.train.step import make_train_step

from test_analysis import REPO

CFG = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, dtype="float32")
SERVE_KINDS = ("serve.add_request", "serve.step", "serve.readback", "model.prefill",
               "model.decode_step", "model.logits")
TRAIN_KINDS = ("train.step", "train.forward", "train.backward", "train.optimizer")
# an MLA layer's and an expert layer's spans (a dense model opens neither), and a
# replayed decode graph's backbone (a card's; test_torch_decode_graph.py)
LAYER_KINDS = ("model.mla", "model.moe")
GRAPH_KINDS = ("model.backbone",)


@pytest.fixture
def parts():
    """A tiny model, its engine, and a train step on its own parameters;
    the runtime left as the test found it."""
    runtime.disable()
    runtime.drain()
    model = LM(CFG, device="cpu")
    gen = torch.Generator().manual_seed(0)
    eng = ServingEngine(model, model.init(gen), max_batch=3, max_seq=64)
    params = model.init(torch.Generator().manual_seed(1))
    opt = AdamW(lr=1e-3)
    train = {"step": make_train_step(model, opt), "params": params, "state": opt.init(params),
             "batch": {"tokens": torch.randint(0, CFG.vocab, (2, 8), generator=gen),
                       "labels": torch.randint(0, CFG.vocab, (2, 8), generator=gen)}}
    yield eng, train
    runtime.disable()
    runtime.drain()


def _serve(eng, steps):
    for i in range(2):
        eng.add_request(f"r{i}", list(range(3 + i, 11 + i)), 10 ** 6)
    for _ in range(steps):
        eng.step()


def _train(train):
    train["params"], train["state"], _ = train["step"](train["params"], train["state"],
                                                      train["batch"])


def test_off_records_nothing_and_enters_no_record_function(parts, monkeypatch):
    eng, train = parts
    calls = Counter()

    def counting(real, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        return wrapped

    monkeypatch.setattr(runtime, "record_function",
                        counting(runtime.record_function, "record_function"))
    monkeypatch.setattr(runtime.time, "perf_counter_ns",
                        counting(runtime.time.perf_counter_ns, "clock"))
    _serve(eng, 50)
    _train(train)
    assert runtime.drain() == [] and runtime.profile_spans() == []
    assert calls == Counter()


def _by_id(spans):
    return {s.attrs["id"]: s for s in spans}


def _parent(s, ids):
    return ids[s.attrs["parent"]].kind if s.attrs["parent"] is not None else None


def test_profile_records_the_tree(parts):
    eng, train = parts
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(eng, 3)
        _train(train)
    spans = runtime.profile_spans()
    kinds = Counter(s.kind for s in spans)
    assert set(kinds) == set(SERVE_KINDS + TRAIN_KINDS)
    assert set(RUNTIME_SCHEMA) == set(SERVE_KINDS + TRAIN_KINDS + LAYER_KINDS + GRAPH_KINDS)
    assert kinds["serve.add_request"] == 2 and kinds["serve.step"] == 3
    assert kinds["model.prefill"] == 2 and kinds["model.decode_step"] == 3
    assert kinds["serve.readback"] == 5
    assert kinds["train.step"] == kinds["train.forward"] == kinds["train.backward"] == 1
    assert kinds["train.optimizer"] == 1
    ids = _by_id(spans)
    want = {"serve.add_request": {None}, "serve.step": {None},
            "serve.readback": {"serve.add_request", "serve.step"},
            "model.prefill": {"serve.add_request"}, "model.decode_step": {"serve.step"},
            "model.logits": {"model.prefill", "model.decode_step", "train.forward"},
            "train.step": {None}, "train.forward": {"train.step"},
            "train.backward": {"train.step"}, "train.optimizer": {"train.step"}}
    for s in spans:
        assert _parent(s, ids) in want[s.kind], s
        assert s.t0 <= s.t1
        if s.attrs["parent"] is not None:
            p = ids[s.attrs["parent"]]
            assert p.t0 <= s.t0 and s.t1 <= p.t1, (s, p)
        assert "device_ms" not in s.attrs          # a CPU model: no device events
    # each model.logits under a decode step is that step's head
    under = Counter(_parent(s, ids) for s in spans if s.kind == "model.logits")
    assert under == Counter({"model.prefill": 2, "model.decode_step": 3, "train.forward": 1})
    assert [s.attrs["rid"] for s in spans if s.kind == "serve.add_request"] == ["r0", "r1"]
    assert all(s.attrs["rid"] == ["r0", "r1"] for s in spans if s.kind == "serve.step")
    # every span is a user_annotation of its kind in the profile's events
    notes = Counter(e.name() for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation())
    assert all(notes[k] == n for k, n in kinds.items()), (notes, kinds)


def test_two_profiles_are_two_sessions(parts):
    eng, _ = parts
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(eng, 2)
    first = runtime.profile_spans()
    eng.step()                                    # a span that finds no profile
    with profile(activities=[ProfilerActivity.CPU]):
        eng.step()
    second = runtime.profile_spans()
    assert first and second
    assert {s.tid for s in second} == {first[0].tid + 1}
    assert {s.attrs["id"] for s in first}.isdisjoint(s.attrs["id"] for s in second)
    assert Counter(s.kind for s in second) == Counter(
        {"serve.step": 1, "model.decode_step": 1, "model.logits": 1, "serve.readback": 1})
    # the second profile dropped the first's spans: only its own are left
    assert [s.attrs["id"] for s in runtime.drain()] == [s.attrs["id"] for s in second]
    assert runtime.drain() == []


def test_a_new_profile_keeps_the_enabled_spans(parts):
    """Spans recorded under enable() with no profile wait for drain(); a new
    profile session drops only the older sessions' spans."""
    eng, _ = parts
    with profile(activities=[ProfilerActivity.CPU]):
        eng.step()
    runtime.enable()
    eng.step()                                    # session 0: kept for drain()
    with profile(activities=[ProfilerActivity.CPU]):
        eng.step()
    latest = runtime.profile_spans()
    kept = runtime.drain()
    assert {s.tid for s in kept} == {0, latest[0].tid}
    assert sum(s.tid == 0 for s in kept) == len(latest) == 4


def test_enabled_without_a_profile_is_session_zero(parts):
    eng, _ = parts
    runtime.enable()
    eng.step()
    spans = runtime.drain()
    assert {s.tid for s in spans} == {0}
    assert Counter(s.kind for s in spans) == Counter(
        {"serve.step": 1, "model.decode_step": 1, "model.logits": 1, "serve.readback": 1})
    assert runtime.profile_spans() == []


def test_device_span_on_the_cpu_has_no_events(parts):
    runtime.enable()
    with runtime.span("model.logits", device=torch.device("cpu")) as sp:
        assert sp
        torch.ones(4).sum()
    (got,) = runtime.drain()
    assert got.kind == "model.logits" and "device_ms" not in got.attrs
    assert got.closed and got.attrs["parent"] is None


def test_unknown_kind_raises_only_when_recording(parts):
    with runtime.span("serve.nonexistent") as sp:       # off: nothing checked
        assert not sp
    runtime.enable()
    with pytest.raises(ValueError, match="RUNTIME_SCHEMA"):
        runtime.span("serve.nonexistent")


# -- span-parity over span(...) calls --------------------------------------------------
def _run_parity(paths, root, options):
    cfg = torch_lint.LintConfig(
        exclude=(), select=("span-parity",),
        rules={"span-parity": torch_lint.RuleSettings(paths=("",), options=options)})
    return torch_lint.Analyzer(cfg, root=str(root)).run([str(p) for p in paths])


def test_span_parity_flags_computed_and_unknown_runtime_kinds(tmp_path):
    src = tmp_path / "emit.py"
    src.write_text(textwrap.dedent('''
        from repro_torch.obs.runtime import span


        def go(kind):
            with span("serve.step"):
                pass
            with span(kind):
                pass
            with span("serve.bogus", device=None):
                pass
            return re.match("a", "a").span(0), runtime.span("model.logits")
    '''))
    report = _run_parity([src], tmp_path, {"src_paths": ("",), "test_paths": ()})
    msgs = sorted((f.line, f.message) for f in report.findings)
    assert [line for line, _ in msgs] == [8, 10]
    assert "string literal" in msgs[0][1] and "RUNTIME_SCHEMA" in msgs[1][1]


def test_span_parity_pins_the_ten_runtime_kinds():
    """Over the port's sources with only the simulator's obs tests scanned,
    each kind of RUNTIME_SCHEMA is emitted and reported unpinned; with this
    file scanned instead, none is (its literals pin all thirteen)."""
    def unpinned(test_file):
        report = _run_parity([REPO / "src" / "repro_torch", REPO / test_file], REPO,
                             {"test_paths": (test_file,)})
        return {k for f in report.findings for k in RUNTIME_SCHEMA if repr(k) in f.message}

    assert unpinned("tests/test_torch_obs.py") == set(RUNTIME_SCHEMA)
    assert unpinned("tests/test_torch_obs_runtime.py") == set()
    assert _run_parity([REPO / "src" / "repro_torch"], REPO, {}).findings == []
