"""The runtime's spans: the serving engine's, the model's and the trainer's
boundaries, on the host clock and in the profiler's own trace.

    with span("serve.step") as sp:
        if sp:                         # a live span (the no-op one is falsy)
            sp.set(rid=[...])
        ...

The vocabulary is :data:`repro_torch.obs.tracing.RUNTIME_SCHEMA`; each call
site passes its kind as a literal from it (the ``span-parity`` lint rule
audits that), and :func:`span` rejects an unknown kind when it records.

**On and off.**  A span records only while a torch profiler runs
(``torch.autograd.profiler._is_profiler_enabled``) or after :func:`enable`.
Otherwise :func:`span` returns one shared no-op context: it allocates
nothing, reads no clock and never enters ``record_function`` (which costs
about 10 us with the profiler off, where the check costs well under 0.1 us).

**What a span records.**  One :class:`~repro_torch.obs.tracing.Span`:
``kind``; ``tid`` the profile session it fell in (0 when no profile ran,
under :func:`enable` alone); ``t0``/``t1`` in ns of ``time.perf_counter_ns``;
``attrs["id"]`` and ``attrs["parent"]`` (the id of the innermost span open
on the same thread, or None); ``attrs["rid"]`` the request id or ids, where
given; and ``attrs["device_ms"]`` for a device span.  The request ids join
the spans to the requests: an admission to its request, a decode step to
the requests it advanced, so the gap between two tokens of one request
splits into its steps and the other requests' admissions between them.  While a profile runs,
the span is also a ``record_function(kind)`` range, so the profile holds it
as a ``user_annotation`` on the clock of the device's kernels.

**Device time.**  ``span(kind, device=d)`` with ``d`` a CUDA device also
records two ``torch.cuda.Event(enable_timing=True)`` on ``d``'s current
stream, at open and at close: ``device_ms`` is the stream's elapsed time
from the span's first queued work to its last (the open event completes when
the work queued before the span has).  It is the card's busy time only where
the card stays behind the host all through the span: where the host paces
the work, it counts the card's idle gaps too.  Nothing
synchronises while the span runs; the events are resolved when
:func:`profile_spans` or :func:`drain` reads them.  On another device no
events are recorded and the span has no ``device_ms``.

**Sessions.**  The session number goes up when a span finds a profiler
running after the last span found none.  So two profiles with no span
between them count as one session.  A new session drops the older
sessions' spans and their unread events.

**Capture.**  No span records while the current CUDA stream captures a
graph: a capture runs the step's code without running its work, and the
graph's replays open the step's spans themselves.

Spans stay in memory: :func:`profile_spans` returns the closed spans of the
latest session, :func:`drain` hands over everything recorded and clears it.
Spans recorded under :func:`enable` with no profile running are kept until
:func:`drain`: an operator who enables the runtime drains it too.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, List, Optional

import torch
from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

from .tracing import RUNTIME_SCHEMA, Span

__all__ = ["span", "enable", "disable", "profile_spans", "drain"]


class _Off:
    """The span of a runtime that records nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Recorder:
    """The process's record of runtime spans."""

    def __init__(self) -> None:
        self.enabled = False
        self.profiled = False     # did the last span find a profiler running
        self.session = 0
        self.ids = itertools.count(1)
        self.lock = threading.Lock()     # the session and the list, across threads
        self.spans: List[Span] = []
        self.pending: List[tuple] = []      # (span, start event, end event)
        self.local = threading.local()

    def stack(self) -> List[Span]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def resolve(self) -> None:
        with self.lock:
            pending, self.pending = self.pending, []
        for sp, ev0, ev1 in pending:
            ev1.synchronize()
            sp.attrs["device_ms"] = ev0.elapsed_time(ev1)


_REC = _Recorder()


class _Live:
    """One recording span, as a context manager."""

    __slots__ = ("span", "device", "rf", "events")

    def __init__(self, sp: Span, device, profiled: bool):
        self.span = sp
        self.device = device
        self.rf = record_function(sp.kind) if profiled else None
        self.events = None

    def __bool__(self) -> bool:
        return True

    def set(self, **attrs) -> None:
        """Add attributes to the span (``rid=`` and others) while it is open."""
        self.span.attrs.update(attrs)

    def __enter__(self) -> "_Live":
        _REC.stack().append(self.span)
        self.span.t0 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__enter__()
        dev = self.device
        if dev is not None and getattr(dev, "type", None) == "cuda":
            stream = torch.cuda.current_stream(dev)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        return self

    def __exit__(self, *exc) -> bool:
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
            with _REC.lock:
                _REC.pending.append((self.span, *self.events))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.span.t1 = time.perf_counter_ns()
        stack = _REC.stack()
        if stack and stack[-1] is self.span:
            stack.pop()
        return False


def span(kind: str, *, rid: Any = None, device: Optional[torch.device] = None):
    """A context manager that records a span of ``kind`` (a key of
    ``RUNTIME_SCHEMA``) while a profile runs or the runtime is enabled, and
    does nothing otherwise.  ``rid``: the request id or ids; ``device``: the
    device the span's work runs on (a CUDA device adds the card's time).
    The live span's ``set(**attrs)`` adds attributes while it is open."""
    profiled = _profiler._is_profiler_enabled
    if not (profiled or _REC.enabled):
        _REC.profiled = False
        return _OFF
    if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
        return _OFF
    if kind not in RUNTIME_SCHEMA:
        raise ValueError(f"unknown runtime span kind {kind!r}; add it to RUNTIME_SCHEMA "
                         "(obs/tracing.py) first")
    stack = _REC.stack()
    attrs = {"id": next(_REC.ids), "parent": stack[-1].attrs["id"] if stack else None}
    if rid is not None:
        attrs["rid"] = rid
    with _REC.lock:
        if profiled and not _REC.profiled:
            _REC.session += 1
            _REC.spans = [s for s in _REC.spans if s.tid == 0]
            _REC.pending = [p for p in _REC.pending if p[0].tid == 0]
        _REC.profiled = profiled
        sp = Span(kind, _REC.session if profiled else 0, 0, float("nan"), attrs=attrs)
        _REC.spans.append(sp)
    return _Live(sp, device, profiled)


def enable() -> None:
    """Record spans whether or not a profile runs (an operator's switch);
    the spans are kept until :func:`drain` reads them."""
    _REC.enabled = True


def disable() -> None:
    """Record spans only while a profile runs again (the default)."""
    _REC.enabled = False


def profile_spans() -> List[Span]:
    """The closed spans of the latest profile session, in the order they
    opened, with device times resolved; empty before the first profile."""
    _REC.resolve()
    if not _REC.session:
        return []
    return [s for s in _REC.spans if s.tid == _REC.session and s.closed]


def drain() -> List[Span]:
    """Every span recorded, in the order they opened, with device times
    resolved; the record is cleared (spans still open are handed over too,
    with ``t1`` NaN)."""
    _REC.resolve()
    with _REC.lock:
        out, _REC.spans = _REC.spans, []
    return out

