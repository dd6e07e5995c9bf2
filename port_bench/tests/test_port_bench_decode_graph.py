"""The reader of ``decode_graph_pct.rag``: the share of the kept profile's
decode steps that replayed the step's CUDA graphs, from the ``replay``
attribute of the program's ``model.decode_step`` spans; None without a kept
profile, without runtime spans, and where no step carries the attribute (the
parent's program).  On a card (``-m cuda``), where the engine replays its
decode step: the check passes the program and fails each serving fault."""
import contextlib
import copy
import sys
import time

import pytest

from port_bench import faults
from port_bench.harness import reader, run_cell, use_program

from .test_port_bench_program_spans import _record, _serve_session
from .tiny import MODEL, SHRINK, bench

use_program()

from repro_torch.obs import runtime  # noqa: E402

NAME = "decode_graph_pct.rag"


def _replayed(flags):
    """The synthetic serving session with its ``model.decode_step`` spans
    marked, in order, as replays or not."""
    session, steps = _serve_session(), iter(flags)
    for s in session:
        if s.kind == "model.decode_step":
            s.attrs["replay"] = next(steps)
    return session


@pytest.mark.parametrize("flags,want", [((True, True), 100.0), ((False, True), 50.0),
                                        ((False, False), 0.0)])
def test_share_on_a_synthetic_session(flags, want, monkeypatch):
    monkeypatch.setattr(runtime, "profile_spans", lambda: _replayed(flags))
    assert reader(NAME)(_record("minitron-8b.rag")) == pytest.approx(want)


def test_none_where_no_step_carries_the_attribute(monkeypatch):
    monkeypatch.setattr(runtime, "profile_spans", _serve_session)
    assert reader(NAME)(_record("minitron-8b.rag")) is None


def test_none_without_a_kept_profile(monkeypatch):
    monkeypatch.setattr(runtime, "profile_spans", lambda: _replayed((True, True)))
    assert reader(NAME)(_record("minitron-8b.rag", traced=False)) is None


def test_none_where_the_program_has_no_runtime_spans(monkeypatch):
    monkeypatch.setattr(runtime, "profile_spans", lambda: [])
    assert reader(NAME)(_record("minitron-8b.rag")) is None
    monkeypatch.setitem(sys.modules, "repro_torch.obs.runtime", None)   # the parent's program
    assert reader(NAME)(_record("minitron-8b.rag")) is None


@pytest.mark.cuda
@pytest.mark.parametrize("kind", (None,) + faults.SERVE)
def test_the_check_holds_the_replayed_step_on_the_card(card, kind, monkeypatch):
    """The tiny ``rag`` cell on the card, under the cell's own limit, at a
    head size the decode kernel takes, and at a rate that keeps every slot
    busy at times (the card's steps are short, and ``half_batch`` shows only
    in the batch's second half): the program reads correct, and a serving
    fault planted before the run, so captured with the step, reads
    incorrect."""
    from repro_torch.models.transformer import DecodeGraph

    replays = []
    replay = DecodeGraph._replay
    monkeypatch.setattr(DecodeGraph, "_replay", lambda self: replays.append(1) or replay(self))
    shrink = copy.deepcopy(SHRINK["minitron-8b.rag"])
    del shrink["limits"]
    shrink["config"]["model"] = dict(MODEL, d_model=128, head_dim=32)
    shrink["traffic"]["rate_per_s"] = 200.0
    with faults.serve_fault(kind) if kind else contextlib.nullcontext():
        out = run_cell(bench(), "minitron-8b.rag", 3300000007, 1.0, False, card,
                       time.perf_counter(), shrink=shrink, log=lambda _: None)
    assert replays
    assert out["correct"] is (kind is None), out["checks"]
