"""The traced run's reading of the card: ``torch.profiler`` over a span of
the window, reduced to device time by kernel, the card's busy and idle
time, and the idle gaps labelled by what the harness was doing.

The arithmetic is a frozen copy of ``chip_smoke.py``'s ``profile_report``
(the union of device intervals over the span's length) and of its rule
that a profile which missed events is taken again: each span counts the
launches of the port's kernels that the program's own counters say were
made, against the kernel events the profile holds.  A profile that holds
fewer is dropped and another span is taken later in the window; it is
never read as a shorter time.  Imports nothing of the program.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["Span", "TraceResult", "Tracer", "annotate", "reduce_events", "KERNELS"]

# the port's hand-written kernels, by a fragment of their device names
KERNELS = {
    "flash_attention": ("flash_attention_wgmma_kernel", "flash_attention_simt_kernel"),
    "flash_decode": ("flash_decode_kernel", "flash_decode_f32_kernel",
                     "flash_decode_split_kernel"),
}
TRACE_SPAN = "bench.trace"


@dataclass
class Span:
    """A harness call into the program, on the host clock relative to the
    window's start."""
    name: str
    t0: float
    t1: float
    attrs: Dict = field(default_factory=dict)


@dataclass
class TraceResult:
    t0: float                      # the profiled span on the host clock (window-relative)
    t1: float
    window_s: float                # its length on the profiler's clock
    busy_s: float                  # union of device intervals within it
    by_name: Dict[str, float]      # device seconds by kernel name
    idle: Dict[str, float]         # idle seconds by what the host was doing
    seen: Dict[str, int]           # kernel events seen, by port kernel
    expected: Dict[str, int]       # launches the program counted, by port kernel

    def kernel_s(self, kernel: str) -> float:
        frags = KERNELS[kernel]
        return sum(s for name, s in self.by_name.items() if any(f in name for f in frags))


class annotate:
    """``record_function(name)`` while a profile runs, nothing otherwise."""

    def __init__(self, tracer: Optional["Tracer"], name: str):
        self.rf = record_function(name) if tracer is not None and tracer.active else None

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class _Innermost:
    """The innermost of a set of intervals covering a time: the latest to
    start of those that cover it.  Intervals sorted by start, with a running
    maximum of their ends, so a look walks back only over intervals that
    could still cover the time."""

    def __init__(self, ivals: List[Tuple[int, int, str]]):
        ivals = sorted(ivals)
        self.starts = [a for a, _, _ in ivals]
        self.ends = [b for _, b, _ in ivals]
        self.names = [n for _, _, n in ivals]
        self.reach, top = [], -1
        for b in self.ends:
            top = max(top, b)
            self.reach.append(top)

    def at(self, t: int, default: str) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.reach[i] > t:
            if self.ends[i] > t:
                return self.names[i]
            i -= 1
        return default


def _interval(e) -> Tuple[int, int]:
    """(start, end) in ns, from whichever clock this torch's event gives."""
    if hasattr(e, "start_ns"):
        a = e.start_ns()
        return a, a + e.duration_ns()
    a = int(e.start_us() * 1000)
    return a, a + int(e.duration_us() * 1000)


def _kind(e) -> str:
    """The event's kineto activity kind where this torch tells it; else a
    device event counts as device work and a host event as an operator."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if hasattr(e, "is_user_annotation") and e.is_user_annotation():
        return "user_annotation"
    return "kernel" if e.device_type() == DeviceType.CUDA else "cpu_op"


def reduce_events(events: Sequence) -> Optional[Tuple[float, float, Dict[str, float],
                                                       Dict[str, int], Dict[str, float]]]:
    """``(window_s, busy_s, device seconds by name, device events by name,
    idle seconds by label)`` from a profile's raw events, over the
    ``bench.trace`` annotation's span; None if the profile holds no such
    span."""
    span = None
    device, phases, ops = [], [], []
    for e in events:
        name = e.name()
        a, b = _interval(e)
        on_card = e.device_type() == DeviceType.CUDA
        if name.startswith("bench."):          # the harness's own annotations
            if on_card:
                continue
            if name == TRACE_SPAN:
                span = (a, b)
            else:
                phases.append((a, b, name))
        elif on_card:
            if _kind(e) not in ("gpu_user_annotation", "user_annotation"):
                device.append((a, b, name))
        elif _kind(e) == "cpu_op":
            ops.append((a, b, name))
    if span is None:
        return None
    lo, hi = span
    by_name: Dict[str, float] = {}
    count: Dict[str, int] = {}
    clipped = []
    for a, b, name in device:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
            count[name] = count.get(name, 0) + 1
            clipped.append((a, b))
    busy = _union(clipped)
    phase, op = _Innermost(phases), _Innermost(ops)
    idle: Dict[str, float] = {}
    t = lo
    for a, b in busy + [(hi, hi)]:
        if a > t:
            mid = (a + t) // 2
            label = f"{phase.at(mid, 'bench.loop')[len('bench.'):]}: {op.at(mid, 'python')}"
            idle[label] = idle.get(label, 0.0) + (a - t) / 1e9
        t = max(t, b)
    return (hi - lo) / 1e9, sum(b - a for a, b in busy) / 1e9, by_name, count, idle


class Tracer:
    """Profiles spans of the window at the planned shares of it, until one
    holds every launch of the port's kernels that the program counted.

    ``counters()`` returns the program's launch counts by port kernel.  The
    driver calls :meth:`tick` between its calls into the program, with the
    device idle or synchronised.  Only the traced run makes one."""

    def __init__(self, plan: Dict, seconds: float, counters: Callable[[], Dict[str, int]],
                 sync: Callable[[], None], cuda: bool = True):
        self.starts = [f * seconds for f in plan["at"]]
        self.length = plan.get("seconds")
        self.steps = plan.get("steps")
        self.counters, self.sync = counters, sync
        self.activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.prof = None
        self.rf = None
        self.active = False
        self.result: Optional[TraceResult] = None
        self._kept = None
        self.attempts: List[Tuple[Dict[str, int], Dict[str, int], float]] = []
        self._t0 = 0.0
        self._c0: Dict[str, int] = {}
        self._calls = 0

    def warm(self) -> None:
        """One throwaway profile, in set-up: the first profile of a process
        starts the profiler's device tracing, which takes seconds."""
        import torch

        self.sync()
        with profile(activities=self.activities):
            torch.zeros(1, device="cuda" if ProfilerActivity.CUDA in self.activities
                        else "cpu").add_(1)
            self.sync()

    def tick(self, now: float, calls: int = 0) -> None:
        """``now``: seconds into the window; ``calls``: the driver's count of
        its steps so far (for a plan in steps)."""
        if not self.active:
            if self.starts and now >= self.starts[0]:
                self.starts.pop(0)
                self._start(now, calls)
            return
        done = (calls - self._calls >= self.steps if self.steps
                else now - self._t0 >= self.length)
        if done:
            self._stop(now)

    def close(self, now: float) -> None:
        if self.active:
            self._stop(now)

    def _start(self, now: float, calls: int) -> None:
        t = time.perf_counter()
        self.sync()
        self._c0 = dict(self.counters())
        self.prof = profile(activities=self.activities)
        self.prof.start()
        self.rf = record_function(TRACE_SPAN)
        self.rf.__enter__()
        self.active = True
        self._t0, self._calls = now + (time.perf_counter() - t), calls

    def _stop(self, now: float) -> None:
        self.sync()
        self.rf.__exit__(None, None, None)
        self.prof.stop()
        self.active = False
        c1 = self.counters()
        expected = {k: c1[k] - self._c0.get(k, 0) for k in c1}
        t = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        seen = {k: 0 for k in KERNELS}
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                name = e.name()
                for k, frags in KERNELS.items():
                    if any(f in name for f in frags):
                        seen[k] += 1
        self.attempts.append((expected, seen, time.perf_counter() - t))
        if all(seen.get(k, 0) >= n for k, n in expected.items()):
            self._kept = (self._t0, now, events, seen, expected)
            self.starts = []

    def finish(self) -> Optional[TraceResult]:
        """After the window: the kept profile reduced (None if no profile
        held every launch, or the card was never busy in it)."""
        kept, self._kept = self._kept, None
        if kept is None:
            return None
        t0, t1, events, seen, expected = kept
        reduced = reduce_events(events)
        if reduced is None or reduced[1] <= 0:
            return None
        window_s, busy_s, by_name, _, idle = reduced
        self.result = TraceResult(t0, t1, window_s, busy_s, by_name, idle, seen, expected)
        return self.result
