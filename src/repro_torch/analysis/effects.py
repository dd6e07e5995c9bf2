"""Bottom-up interprocedural effect inference.

Given the :class:`~repro_torch.analysis.callgraph.CallGraph`, compute for every
project function the set of effects it may perform *transitively*:

  * ``cluster-mutation`` — calls a :data:`MUTATORS` method on anything
    other than its own bare ``self``/``cls``
  * ``param-mutation:<name>`` — stores through one of its parameters
    (attribute/subscript assignment or ``object.__setattr__``), directly
    or by passing that parameter into a callee that mutates it
  * ``global-rng`` — draws from ``np.random.*`` / stdlib ``random`` /
    torch's default generator (a ``torch.randn`` & co. without
    ``generator=``), or reseeds it (``torch.manual_seed``)
  * ``wall-clock`` — reads ``time.time``/``time.time_ns``
  * ``host-sync`` — forces a device→host transfer (``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
    ``torch.cuda.synchronize()``)
  * ``io`` — touches the filesystem

Propagation runs over Tarjan's strongly-connected components in reverse
topological order, so mutual recursion converges in one pass.  Every
transitive effect carries a **witness**: the chain of call sites that
reaches the base effect, which the rules render as
``decide -> _helper -> ctx.cluster.apply()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .callgraph import CallGraph, FuncInfo, ModuleSummary

__all__ = ["Effect", "EffectEngine", "PARAM_MUTATION", "engine_for"]

PARAM_MUTATION = "param-mutation"


@dataclass(frozen=True)
class Effect:
    """One (possibly transitive) effect of a function.

    ``chain`` is the witness: ``((qualname, path, lineno), ...)`` for each
    call hop, ending at the function whose body contains the base effect.
    ``origin`` is the base-effect description, e.g. ``np.random.shuffle()``.
    For a direct effect the chain has length one (the function itself) and
    ``site_line`` is the base effect's own line; for a transitive effect
    ``site_line`` is the line of the *first call hop* inside the function
    the rule is reporting on.
    """

    kind: str                     # e.g. "global-rng" or "param-mutation:ctx"
    origin: str                   # base-effect description
    origin_line: int              # line of the base effect in its own file
    chain: Tuple[Tuple[str, str, int], ...]   # (qualname, path, lineno) hops
    site_line: int                # line to anchor a finding on

    @property
    def transitive(self) -> bool:
        return len(self.chain) > 1

    def render_chain(self) -> str:
        """``decide -> _helper -> np.random.shuffle()`` (short names)."""
        hops = [q.rsplit(".", 1)[-1] for q, _, _ in self.chain]
        return " -> ".join(hops + [self.origin])


def _short_kind(kind: str) -> str:
    return kind.split(":", 1)[0]


class EffectEngine:
    """Fixed-point effect propagation over the project call graph.

    Built once per run from the shared per-rule summaries; both the
    purity and RNG rules query the same instance (memoised in the
    ``ProjectContext`` store under the key ``"effect-engine"``).
    """

    STORE_KEY = "effect-engine"

    def __init__(self, summaries: Sequence[ModuleSummary]):
        self.graph = CallGraph(summaries)
        self._effects: Dict[str, List[Effect]] = {}
        self._compute()

    # -- public API ----------------------------------------------------------
    def effects_of(self, qualname: str) -> List[Effect]:
        return self._effects.get(qualname, [])

    def function(self, qualname: str) -> Optional[FuncInfo]:
        return self.graph.functions.get(qualname)

    def functions_named(self, name: str) -> List[FuncInfo]:
        return [f for f in self.graph.functions.values() if f.name == name]

    # -- SCC condensation (iterative Tarjan) ---------------------------------
    def _sccs(self) -> List[List[str]]:
        graph = {
            q: sorted({rc.callee for rc in self.graph.edges(fi)})
            for q, fi in self.graph.functions.items()
        }
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Dict[str, bool] = {}
        stack: List[str] = []
        sccs: List[List[str]] = []
        counter = [0]

        for root in graph:
            if root in index:
                continue
            work: List[Tuple[str, int]] = [(root, 0)]
            while work:
                node, ei = work[-1]
                if ei == 0:
                    index[node] = low[node] = counter[0]
                    counter[0] += 1
                    stack.append(node)
                    on_stack[node] = True
                advanced = False
                succs = graph[node]
                while ei < len(succs):
                    nxt = succs[ei]
                    ei += 1
                    if nxt not in index:
                        work[-1] = (node, ei)
                        work.append((nxt, 0))
                        advanced = True
                        break
                    if on_stack.get(nxt):
                        low[node] = min(low[node], index[nxt])
                if advanced:
                    continue
                work.pop()
                if low[node] == index[node]:
                    comp: List[str] = []
                    while True:
                        w = stack.pop()
                        on_stack[w] = False
                        comp.append(w)
                        if w == node:
                            break
                    sccs.append(comp)
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
        return sccs  # already reverse-topological (callees first)

    # -- propagation ---------------------------------------------------------
    def _compute(self) -> None:
        funcs = self.graph.functions
        for scc in self._sccs():
            members = set(scc)
            # seed with direct (base) effects
            for q in scc:
                fi = funcs[q]
                eff: List[Effect] = []
                hop = ((q, fi.path, fi.lineno),)
                for be in fi.effects:
                    eff.append(Effect(
                        kind=be.kind, origin=be.desc,
                        origin_line=be.lineno, chain=hop,
                        site_line=be.lineno,
                    ))
                for pname, (line, desc) in fi.param_mutations.items():
                    eff.append(Effect(
                        kind=f"{PARAM_MUTATION}:{pname}", origin=desc,
                        origin_line=line, chain=hop, site_line=line,
                    ))
                self._effects[q] = eff
            # iterate within the SCC until no new (kind, origin) pairs appear
            changed = True
            guard = 0
            while changed and guard < 64:
                changed = False
                guard += 1
                for q in scc:
                    fi = funcs[q]
                    mine = self._effects[q]
                    seen = {(e.kind, e.origin, e.chain) for e in mine}
                    for rc in self.graph.edges(fi):
                        callee_eff = self._effects.get(rc.callee, [])
                        for e in callee_eff:
                            lifted = self._lift(fi, rc, e)
                            if lifted is None:
                                continue
                            key = (lifted.kind, lifted.origin, lifted.chain)
                            if key in seen:
                                continue
                            if len(lifted.chain) > 12:
                                continue  # depth guard inside cycles
                            seen.add(key)
                            mine.append(lifted)
                            if rc.callee in members:
                                changed = True

    def _lift(self, caller: FuncInfo, rc, e: Effect) -> Optional[Effect]:
        """Translate a callee effect into the caller's frame."""
        hop = ((caller.qualname, caller.path, rc.site.lineno),)
        if not e.kind.startswith(PARAM_MUTATION + ":"):
            return Effect(
                kind=e.kind, origin=e.origin, origin_line=e.origin_line,
                chain=hop + e.chain, site_line=rc.site.lineno,
            )
        # param-mutation: map the callee's mutated parameter back to the
        # caller-local name passed at this call site.
        callee = self.graph.functions.get(rc.callee)
        if callee is None:
            return None
        pname = e.kind.split(":", 1)[1]
        params = list(callee.params)
        if rc.skip_first_param and params:
            params = params[1:]
        local: Optional[str] = None
        try:
            idx = params.index(pname)
        except ValueError:
            idx = -1
        if 0 <= idx < len(rc.site.pos_args):
            local = rc.site.pos_args[idx]
        if local is None:
            for kw, val in rc.site.kw_args:
                if kw == pname:
                    local = val
                    break
        if local is None:
            return None
        if local in ("self", "cls"):
            # mutating own state through a helper — not a param mutation
            # from the caller's point of view
            return None
        if local not in caller.params:
            return None  # a local object, mutation doesn't escape caller
        return Effect(
            kind=f"{PARAM_MUTATION}:{local}", origin=e.origin,
            origin_line=e.origin_line, chain=hop + e.chain,
            site_line=rc.site.lineno,
        )


# The purity and rng rules finalize over the SAME file set in one run;
# summaries are interned by content hash (see callgraph), so identical
# summary identity tuples mean an identical graph — share the engine.
_ENGINE_MEMO: Dict[Tuple[int, ...], EffectEngine] = {}


def engine_for(summaries: Sequence[ModuleSummary]) -> EffectEngine:
    key = tuple(sorted(id(s) for s in summaries))
    eng = _ENGINE_MEMO.get(key)
    if eng is None:
        eng = EffectEngine(summaries)
        _ENGINE_MEMO[key] = eng
        if len(_ENGINE_MEMO) > 64:       # fixture matrices build many tiny graphs
            _ENGINE_MEMO.pop(next(iter(_ENGINE_MEMO)))
    return eng
