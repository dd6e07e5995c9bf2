"""The harness: finds a cell's configuration, traffic mix, driver, limits and
metric readers by the names in ``BENCHMARK.json``, runs the driver, reads
the metrics, decides ``correct`` and builds the result line.

Everything that belongs to one configuration, mix, cell or metric is a
file of its own under ``port_bench/``:

    configs/<config>.json          the configuration as it is run
    traffic/<mix>.json             a mix's parameters; its "driver" names
    drivers/<driver>.py            the loop that runs it (``run``, ``check``)
    reference/<family>.py          the plain reference of a model family
    cells/<cell>.json              the limits of the cell's comparison
    metrics/<metric>.py            a metric's reader: ``read(record)``

A reader returns None where it finds nothing to read, and the metric is
then left out of the line.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SRC = ROOT / "src"

__all__ = ["Cell", "Record", "load_cell", "run_cell", "reader", "metric_names",
           "JAX_MODULES", "jax_modules", "use_program"]

# top-level module names the port must never load: JAX, its libraries and
# the JAX package (compared whole: the port is ``repro_torch``)
JAX_MODULES = ("jax", "jaxlib", "flax", "repro")


def use_program() -> None:
    """Put the checkout's ``src/`` on the import path, where the program
    (``repro_torch``) lives."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))


def jax_modules() -> List[str]:
    """The loaded modules whose top-level name is one of JAX_MODULES."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in JAX_MODULES)


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _merge(base: Dict, over: Optional[Dict]) -> Dict:
    out = dict(base)
    for key, val in (over or {}).items():
        out[key] = _merge(out[key], val) if isinstance(val, dict) and isinstance(
            out.get(key), dict) else val
    return out


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def metric_names(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The cell's metrics of ``kind`` ("end_to_end" or "per_layer"): those
    whose ``workloads`` name it, or that have no ``workloads``."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def load_cell(bench: Dict, name: str, shrink: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``bench``, with its files read.  ``shrink``
    overrides parts of them (the tests' tiny sizes): ``{"config": {...},
    "traffic": {...}, "limits": {...}}``."""
    shrink = shrink or {}
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _merge(_json(ROOT / conf["file"]), shrink.get("config"))
    mix = _merge(_json(HERE / "traffic" / f"{entry['traffic']}.json"), shrink.get("traffic"))
    path = HERE / "cells" / f"{name}.json"
    limits = _merge(_json(path) if path.exists() else {}, shrink.get("limits"))
    return Cell(name, entry["chips"], config, mix, limits,
                metric_names(bench, name, "end_to_end"), metric_names(bench, name, "per_layer"))


@dataclass
class Record:
    """What a run did, for the readers: the window on the host clock, the
    harness's spans around its calls into the program, the requests or
    steps, and the traced span (traced runs only)."""
    cell: Cell
    seconds: float
    setup_s: float = 0.0
    elapsed: float = 0.0
    spans: List[Any] = field(default_factory=list)
    requests: List[Any] = field(default_factory=list)
    steps: int = 0
    trace: Any = None
    trace_attempts: List[Any] = field(default_factory=list)
    memory_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    state: Dict[str, Any] = field(default_factory=dict)   # the driver's, for its check

    @property
    def model(self) -> Dict:
        return self.cell.config["model"]


def reader(name: str) -> Callable[[Record], Optional[float]]:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"port_bench.drivers.{name}")


def reference(family: str):
    return importlib.import_module(f"port_bench.reference.{family}")


def run_cell(bench: Dict, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, shrink: Optional[Dict] = None,
             log: Callable[[str], None] = print) -> Dict:
    """Run one cell and return its result line (a dict), with ``checks``,
    the numbers compared beside their limits, last."""
    cell = load_cell(bench, name, shrink)
    drv = driver(cell.mix["driver"])
    rec = Record(cell, seconds)
    drv.run(rec, seed, device, trace, t_start, log)
    log(f"[run] {name} seed {seed}: set-up {rec.setup_s:.3f} s, window {rec.elapsed:.3f} s")
    for expected, seen, took in rec.trace_attempts:
        log(f"[trace] launches the program counted {expected}, kernel events the profile "
            f"holds {seen}, read in {took:.2f} s")
    if trace and rec.trace is None:
        log("[trace] no profile held every launch: the trace's metrics are left out")
    checks = drv.check(rec, reference(cell.config["family"]), device, log)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out: Dict[str, Any] = {
        "correct": all(v["value"] is not None and v["value"] <= v["limit"]
                       for v in checks.values()),
        "attempted": rec.attempted,
        "failed": rec.failed,
        "metrics": metrics,
        "device": device_info(device, cell.chips, rec),
    }
    if trace and rec.trace is not None:
        tr = rec.trace
        out["breakdown"] = {
            "device_ops": [[k, v] for k, v in sorted(tr.by_name.items(),
                                                     key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[k, v] for k, v in sorted(tr.idle.items(),
                                                    key=lambda kv: -kv[1])[:10]],
        }
    out["checks"] = checks
    return out


def device_info(device, chips: int, rec: Record) -> Dict:
    import torch

    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": int(rec.memory_peak_bytes)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": int(rec.memory_peak_bytes)}
    if rec.trace is not None:
        info["busy_s"] = rec.trace.busy_s
        info["window_s"] = rec.trace.window_s
    return info
