"""The readers of the program's own spans (``program_spans.py`` and the
seven metrics that use it): None without a kept profile or where the
program has no runtime spans, and the right means on a synthetic session."""
import sys

import pytest

from port_bench.harness import Record, load_cell, reader, use_program

from .tiny import bench

use_program()

from repro_torch.obs import runtime  # noqa: E402
from repro_torch.obs.tracing import Span  # noqa: E402

RAG = ("decode_step_ms.rag", "decode_dispatch_ms.rag", "logits_device_ms.rag",
       "prefill_device_ms.rag")
TRAIN = ("train_forward_ms.train", "train_backward_ms.train", "train_optimizer_ms.train")
MS = 1_000_000          # ns


def _span(kind, sid, parent, t0_ms, t1_ms, device_ms=None, session=3):
    attrs = {"id": sid, "parent": parent}
    if device_ms is not None:
        attrs["device_ms"] = device_ms
    return Span(kind, session, int(t0_ms * MS), int(t1_ms * MS), attrs=attrs)


def _serve_session():
    """Two decode steps (50 and 40 ms on the host; their dispatch 30 and 20,
    their heads 4 and 2 ms on the card), one admission (its prefill 70 ms on
    the card, whose own head, 9 ms, is not a decode step's), and a stray
    ``model.logits`` outside any step."""
    return [
        _span("serve.add_request", 1, None, 0, 90),
        _span("model.prefill", 2, 1, 1, 80, device_ms=70.0),
        _span("model.logits", 3, 2, 70, 79, device_ms=9.0),
        _span("serve.readback", 4, 1, 80, 90),
        _span("serve.step", 5, None, 100, 150),
        _span("model.decode_step", 6, 5, 100, 130, device_ms=45.0),
        _span("model.logits", 7, 6, 125, 129, device_ms=4.0),
        _span("serve.readback", 8, 5, 130, 150),
        _span("serve.step", 9, None, 200, 240),
        _span("model.decode_step", 10, 9, 200, 220, device_ms=35.0),
        _span("model.logits", 11, 10, 215, 219, device_ms=2.0),
        _span("model.logits", 12, None, 300, 301, device_ms=100.0),
    ]


def _train_session():
    """Two steps, the first of two microbatches."""
    out, sid = [], 0
    for step, micro in ((0, 2), (1, 1)):
        sid += 1
        root = sid
        out.append(_span("train.step", root, None, 1000 * step, 1000 * step + 900))
        for _ in range(micro):
            sid += 1
            out.append(_span("train.forward", sid, root, 0, 1, device_ms=300.0))
            sid += 1
            out.append(_span("train.backward", sid, root, 1, 2, device_ms=600.0))
        sid += 1
        out.append(_span("train.optimizer", sid, root, 2, 3, device_ms=50.0))
    return out


def _record(cell, traced=True):
    rec = Record(load_cell(bench(), cell), 1.0)
    rec.trace = object() if traced else None
    return rec


@pytest.mark.parametrize("name", RAG + TRAIN)
def test_none_without_a_kept_profile(name, monkeypatch):
    cell = "minitron-8b.rag" if name.endswith(".rag") else "qwen1.5-0.5b.train"
    monkeypatch.setattr(runtime, "profile_spans",
                        lambda: _serve_session() + _train_session())
    assert reader(name)(_record(cell, traced=False)) is None


@pytest.mark.parametrize("name", RAG + TRAIN)
def test_none_where_the_program_has_no_runtime_spans(name, monkeypatch):
    cell = "minitron-8b.rag" if name.endswith(".rag") else "qwen1.5-0.5b.train"
    monkeypatch.setattr(runtime, "profile_spans", lambda: [])
    assert reader(name)(_record(cell)) is None
    monkeypatch.setitem(sys.modules, "repro_torch.obs.runtime", None)   # the parent's program
    assert reader(name)(_record(cell)) is None


@pytest.mark.parametrize("name,want", [("decode_step_ms.rag", 45.0),
                                       ("decode_dispatch_ms.rag", 25.0),
                                       ("logits_device_ms.rag", 3.0),
                                       ("prefill_device_ms.rag", 70.0)])
def test_serve_readers_on_a_synthetic_session(name, want, monkeypatch):
    monkeypatch.setattr(runtime, "profile_spans", _serve_session)
    assert reader(name)(_record("minitron-8b.rag")) == pytest.approx(want)


@pytest.mark.parametrize("name,want", [("train_forward_ms.train", 450.0),
                                       ("train_backward_ms.train", 900.0),
                                       ("train_optimizer_ms.train", 50.0)])
def test_train_readers_on_a_synthetic_session(name, want, monkeypatch):
    monkeypatch.setattr(runtime, "profile_spans", _train_session)
    assert reader(name)(_record("qwen1.5-0.5b.train")) == pytest.approx(want)
