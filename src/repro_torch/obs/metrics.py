"""The unified metrics layer: counters / gauges / exact-quantile
histograms, the get-or-create registry, and the engine's typed counter
view.

This is the one home for metrics primitives — :mod:`repro.stream.metrics`
re-exports from here for backward compatibility.  Two kinds of consumer:

  * the **streaming service** registers free-form named series in a
    :class:`MetricsRegistry` (admitted/shed per SLO class, e2e latency
    histograms, queue-depth samples) and exports them as JSON;
  * the **engine** keeps its instance/churn ledger in :class:`EngineStats`
    — a *typed* counter bundle over the frozen :data:`ENGINE_COUNTERS`
    name set.  A misspelled counter name raises ``AttributeError`` at the
    point of use instead of silently minting a new key, and the
    conservation identity ``admitted == completed + lost + shed`` is
    checked in exactly one place (:meth:`EngineStats.check_conservation`).

Histograms store raw observations (the service sees at most a few hundred
thousand instances per run) so quantiles are exact rather than
sketch-approximate; ``summary()`` reduces them to the export shape.
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ENGINE_COUNTERS",
    "EngineStats",
]


class Counter:
    """Monotone event count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Exact-quantile histogram over raw observations."""

    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    def quantile(self, q: float) -> float:
        if not self.values:
            return float("nan")
        return float(np.quantile(np.asarray(self.values), q))

    def summary(self) -> Dict[str, float]:
        if not self.values:
            return {"count": 0}
        arr = np.asarray(self.values)
        return {
            "count": int(arr.size),
            "mean": float(arr.mean()),
            "p50": float(np.quantile(arr, 0.50)),
            "p99": float(np.quantile(arr, 0.99)),
            "p999": float(np.quantile(arr, 0.999)),
            "max": float(arr.max()),
        }


class MetricsRegistry:
    """Get-or-create registry + interval sampler.

    ``sample(t)`` appends one row — every counter and gauge value at
    instant ``t`` — to :attr:`samples`; the service calls it on its
    configured interval so the export carries the time series, not just
    the final totals."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.samples: List[Dict[str, float]] = []

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name)
        return h

    def sample(self, t: float) -> Dict[str, float]:
        row: Dict[str, float] = {"t": float(t)}
        for name, c in self.counters.items():
            row[name] = c.value
        for name, g in self.gauges.items():
            row[name] = g.value
        self.samples.append(row)
        return row

    def snapshot(self) -> dict:
        """The full export shape (JSON-serialisable)."""
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {
                k: h.summary() for k, h in sorted(self.histograms.items())
            },
            "samples": self.samples,
        }

    def to_json(self, path: Optional[str] = None, indent: int = 2) -> str:
        text = json.dumps(self.snapshot(), indent=indent)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text


# The engine's complete counter vocabulary, frozen.  Instance ledger:
# admitted == completed + lost + shed (shed is charged by the stream
# admission layer).  The rest are churn-runtime counters.
ENGINE_COUNTERS: Tuple[str, ...] = (
    "admitted",
    "completed",
    "shed",
    "device_down",
    "device_up",
    "replica_deaths",
    "task_failovers",
    "replans",
    "recovered",
    "lost",
    "salvages",
    "salvaged",
)


class EngineStats:
    """Typed view over the engine's counters.

    ``__slots__`` over :data:`ENGINE_COUNTERS` makes every counter a plain
    ``int`` attribute — ``stats.completed += 1`` — and turns a misspelled
    name into an immediate ``AttributeError`` on both read and write
    (where a plain dict would silently mint a new key and drift the
    conservation ledger).  Mapping-style access (``stats["lost"]``,
    ``dict(stats)``, iteration) is kept for existing consumers, with the
    same typo behaviour.
    """

    __slots__ = ENGINE_COUNTERS

    def __init__(self, **initial: int):
        for key in ENGINE_COUNTERS:
            setattr(self, key, 0)
        for key, v in initial.items():
            setattr(self, key, int(v))      # unknown key -> AttributeError

    # -- mapping compatibility --------------------------------------------------
    def __getitem__(self, key: str) -> int:
        return getattr(self, key)

    def __setitem__(self, key: str, value: int) -> None:
        setattr(self, key, value)

    def __contains__(self, key: object) -> bool:
        return key in ENGINE_COUNTERS

    def __iter__(self) -> Iterator[str]:
        return iter(ENGINE_COUNTERS)

    def __len__(self) -> int:
        return len(ENGINE_COUNTERS)

    def keys(self) -> Tuple[str, ...]:
        return ENGINE_COUNTERS

    def items(self) -> Iterator[Tuple[str, int]]:
        return ((k, getattr(self, k)) for k in ENGINE_COUNTERS)

    def values(self) -> Iterator[int]:
        return (getattr(self, k) for k in ENGINE_COUNTERS)

    def as_dict(self) -> Dict[str, int]:
        return {k: getattr(self, k) for k in ENGINE_COUNTERS}

    def __eq__(self, other: object) -> bool:
        if isinstance(other, EngineStats):
            return self.as_dict() == other.as_dict()
        if isinstance(other, dict):
            return self.as_dict() == other
        return NotImplemented

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={getattr(self, k)}" for k in ENGINE_COUNTERS)
        return f"EngineStats({body})"

    # -- the conservation identity, checked in one place ------------------------
    def check_conservation(self) -> None:
        """``admitted == completed + lost + shed``; RuntimeError on drift —
        the regression guard for the counter bookkeeping (asserted by
        ``Engine.drain`` and recomputable from traces alone via
        :func:`repro.obs.export.ledger_from_trace`)."""
        settled = self.completed + self.lost + self.shed
        if self.admitted != settled:
            raise RuntimeError(
                f"instance-counter drift: admitted {self.admitted} != "
                f"completed {self.completed} + lost {self.lost} + shed "
                f"{self.shed}"
            )

    def to_registry(self, registry: MetricsRegistry,
                    prefix: str = "engine_") -> None:
        """Publish the current counter values into a unified registry (the
        stream service calls this before exporting, so one snapshot
        carries service metrics AND the engine ledger)."""
        for key in ENGINE_COUNTERS:
            registry.counter(prefix + key).value = getattr(self, key)
