"""DAG representation of applications and the paper's staging transform.

The paper (IBDASH, §IV-B) represents each application instance as a DAG
``G = (V, E)`` whose nodes are tasks and whose edges are execution/data
dependencies.  Before orchestration the DAG is *stagerized*: the stage of a
node is the length of the longest path from any source node ("modified
Breadth-First Search" in the paper).  All tasks inside one stage are
mutually independent and may run in parallel; stage ``i+1`` starts only
after stage ``i`` fully completes.

This module is pure Python (no JAX) — it is shared by the edge simulator
(the paper's own evaluation) and by the distributed-training runtime, which
re-uses the same staging logic to schedule pipeline/checkpoint/reduce task
graphs across pods.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "TaskSpec",
    "AppDAG",
    "app_stage",
    "topological_order",
    "validate_dag",
]


@dataclass(frozen=True)
class TaskSpec:
    """One task (node) of an application DAG.

    Attributes mirror the paper's notation (Table II):
      ttype       index into the task-type table ``T = {T_1..T_N}``
      deps        names of prerequisite tasks, ``D(T_i)``
      out_bytes   size of the task's output data ``T(i)_d`` handed to children
      model_id    required model artifact ``M(T_i)`` (None when task needs none)
      model_bytes size of ``M(T_i)`` (0 when ``model_id`` is None)
      mem_bytes   memory footprint ``H(T_i)`` (data + model resident set)
      work        abstract amount of compute (used by the profiler to derive
                  per-device base latencies; not part of the paper's notation)
    """

    name: str
    ttype: int
    deps: Tuple[str, ...] = ()
    out_bytes: float = 0.0
    model_id: Optional[str] = None
    model_bytes: float = 0.0
    mem_bytes: float = 0.0
    work: float = 1.0


@dataclass
class AppDAG:
    """An application instance: a named DAG of :class:`TaskSpec`."""

    name: str
    tasks: Dict[str, TaskSpec]
    # Filled in by ``finalize`` (cached staging results).
    stages: List[List[str]] = field(default_factory=list)
    stage_of: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.stages:
            self.finalize()

    # -- construction helpers -------------------------------------------------
    @classmethod
    def from_tasks(cls, name: str, tasks: Iterable[TaskSpec]) -> "AppDAG":
        return cls(name=name, tasks={t.name: t for t in tasks})

    def finalize(self) -> "AppDAG":
        validate_dag(self.tasks)
        self.stage_of = app_stage(self.tasks)
        n_stages = 1 + max(self.stage_of.values()) if self.stage_of else 0
        self.stages = [[] for _ in range(n_stages)]
        for tname in topological_order(self.tasks):
            self.stages[self.stage_of[tname]].append(tname)
        return self

    # -- queries ---------------------------------------------------------------
    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def children(self, name: str) -> List[str]:
        return [t.name for t in self.tasks.values() if name in t.deps]

    def sources(self) -> List[str]:
        return [t.name for t in self.tasks.values() if not t.deps]

    def sinks(self) -> List[str]:
        have_child = {d for t in self.tasks.values() for d in t.deps}
        return [n for n in self.tasks if n not in have_child]

    def critical_path_len(self) -> int:
        """Number of stages == longest chain length (in tasks)."""
        return self.n_stages

    def relabel(self, suffix: str) -> "AppDAG":
        """Clone the DAG with every task renamed ``<name><suffix>`` (used to
        instantiate many concurrent application instances)."""
        remap = {n: n + suffix for n in self.tasks}
        tasks = {
            remap[n]: TaskSpec(
                name=remap[n],
                ttype=t.ttype,
                deps=tuple(remap[d] for d in t.deps),
                out_bytes=t.out_bytes,
                model_id=t.model_id,
                model_bytes=t.model_bytes,
                mem_bytes=t.mem_bytes,
                work=t.work,
            )
            for n, t in self.tasks.items()
        }
        return AppDAG(name=self.name, tasks=tasks)


def validate_dag(tasks: Dict[str, TaskSpec]) -> None:
    """Raise ``ValueError`` on dangling deps or cycles."""
    for t in tasks.values():
        for d in t.deps:
            if d not in tasks:
                raise ValueError(f"task {t.name!r} depends on unknown task {d!r}")
    # Kahn's algorithm to detect cycles.
    indeg = {n: len(t.deps) for n, t in tasks.items()}
    frontier = [n for n, d in indeg.items() if d == 0]
    seen = 0
    children: Dict[str, List[str]] = {n: [] for n in tasks}
    for t in tasks.values():
        for d in t.deps:
            children[d].append(t.name)
    while frontier:
        n = frontier.pop()
        seen += 1
        for c in children[n]:
            indeg[c] -= 1
            if indeg[c] == 0:
                frontier.append(c)
    if seen != len(tasks):
        raise ValueError("application graph contains a cycle")


def topological_order(tasks: Dict[str, TaskSpec]) -> List[str]:
    """Deterministic topological order (stable w.r.t. insertion order)."""
    order: List[str] = []
    indeg = {n: len(t.deps) for n, t in tasks.items()}
    children: Dict[str, List[str]] = {n: [] for n in tasks}
    for t in tasks.values():
        for d in t.deps:
            children[d].append(t.name)
    frontier = [n for n in tasks if indeg[n] == 0]  # insertion order
    while frontier:
        n = frontier.pop(0)
        order.append(n)
        for c in children[n]:
            indeg[c] -= 1
            if indeg[c] == 0:
                frontier.append(c)
    return order


def app_stage(tasks: Dict[str, TaskSpec]) -> Dict[str, int]:
    """Paper §IV-B: ``the stage of a node is the length of the longest path
    from the start node`` — computed with a DP over a topological order (the
    paper's 'modified BFS')."""
    stage: Dict[str, int] = {}
    for n in topological_order(tasks):
        deps = tasks[n].deps
        stage[n] = 0 if not deps else 1 + max(stage[d] for d in deps)
    return stage
