"""policy-purity: ``decide``/``decide_batch`` bodies must stay pure.

The invariant: planning and state mutation are split — a policy is
a pure function ``PolicyContext -> TaskDecision`` and the ONLY blessed
mutation path is ``cluster.apply(plan)`` (undoable, outside the policy).
A policy that calls a cluster mutator or writes through its context
corrupts speculative what-if sweeps, breaks batched==scalar parity (the
batched kernel would miss the side effect), and poisons DRL rollouts that
replay the same snapshot.

Flags, inside any function named ``decide``/``decide_batch``:
  * calls to the cluster mutators ``apply``, ``add_interval``,
    ``cancel_from``, ``mark_down``/``mark_up``, ``set_bandwidth``,
    ``install_forecast``, ``refresh_topology``, ``undo`` on any receiver
    other than ``self`` (stateful policies may advance their OWN rng or
    cursor — that is defined row-order state, not fleet state);
  * attribute/subscript stores through a non-``self`` parameter
    (``ctx.total = ...``, ``batch.fleet.alive[0] = ...``);
  * ``object.__setattr__(ctx, ...)`` back-doors into frozen contexts.

The rule is *interprocedural*: ``finalize`` builds the project
call graph (:mod:`..callgraph`) and the bottom-up effect sets
(:mod:`..effects`), so ``decide -> _helper -> ctx.cluster.apply()`` is a
finding even though no single body shows both ends — the full call chain
appears in the message.  The per-file pass above stays as the fallback
for direct violations (and for files the call graph cannot resolve).
"""
from __future__ import annotations

import ast
from typing import Iterator, Set

from ..astutil import dotted_name, param_names, walk_functions
from ..effects import PARAM_MUTATION, engine_for
from ..callgraph import summarize_module
from ..framework import FileContext, Finding, ProjectContext, Rule, register_rule

MUTATORS = frozenset({
    "apply",
    "add_interval",
    "cancel_from",
    "mark_down",
    "mark_up",
    "set_bandwidth",
    "install_forecast",
    "refresh_topology",
    "undo",
})

_POLICY_METHODS = ("decide", "decide_batch")


def _root_name(node: ast.AST):
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


@register_rule
class PolicyPurityRule(Rule):
    name = "policy-purity"
    severity = "error"
    description = (
        "decide/decide_batch may not call cluster mutators or assign "
        "through their context/snapshot arguments (pure orchestrate vs "
        "mutating apply)"
    )
    default_paths = ("",)

    def check_file(self, ctx: FileContext, project: ProjectContext
                   ) -> Iterator[Finding]:
        for fn in walk_functions(ctx.tree):
            if fn.name not in _POLICY_METHODS:
                continue
            params: Set[str] = set(param_names(fn))
            foreign = params - {"self", "cls"}
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    yield from self._check_call(ctx, fn, node, foreign)
                elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    targets = (
                        node.targets if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    for tgt in targets:
                        if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                            root = _root_name(tgt)
                            if root in foreign:
                                yield self.finding(
                                    ctx, tgt,
                                    f"`{fn.name}` stores through its argument "
                                    f"`{root}` — contexts/snapshots are frozen "
                                    "read-only views; a policy must return a "
                                    "decision, not mutate its inputs",
                                )

    def finalize(self, project: ProjectContext) -> Iterator[Finding]:
        """Transitive pass: flag policy entry points whose *callees* mutate
        the cluster or the policy's own context arguments."""
        summaries = []
        for fctx in project.files:
            try:
                summaries.append(
                    summarize_module(fctx.path, fctx.source, fctx.tree)
                )
            except (SyntaxError, RecursionError):  # pragma: no cover
                continue
        if not summaries:
            return
        engine = engine_for(summaries)
        emitted: Set[tuple] = set()
        for entry in sorted(
            (f for name in _POLICY_METHODS
             for f in engine.functions_named(name)),
            key=lambda f: (f.path, f.lineno),
        ):
            foreign = set(entry.params) - {"self", "cls"}
            for eff in engine.effects_of(entry.qualname):
                if not eff.transitive:
                    continue   # direct violations belong to check_file
                if eff.kind == "cluster-mutation":
                    what = f"calls cluster mutator `{eff.origin}`"
                elif (eff.kind.startswith(PARAM_MUTATION + ":")
                        and eff.kind.split(":", 1)[1] in foreign):
                    what = (
                        "mutates its argument "
                        f"`{eff.kind.split(':', 1)[1]}`"
                    )
                else:
                    continue
                msg = (
                    f"`{entry.name}` {what} through the call chain "
                    f"`{eff.render_chain()}` — placement is pure; only "
                    "`cluster.apply(plan)` outside the policy may commit state"
                )
                key = (entry.path, eff.site_line, msg)
                if key in emitted:
                    continue
                emitted.add(key)
                yield self.finding(entry.path, eff.site_line, msg)

    def _check_call(self, ctx: FileContext, fn: ast.FunctionDef,
                    call: ast.Call, foreign: Set[str]) -> Iterator[Finding]:
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr in MUTATORS:
            # only a method on the policy ITSELF (bare `self.x()`) is own
            # state; `self.cluster.apply()` still mutates the fleet
            bare_self = (
                isinstance(func.value, ast.Name)
                and func.value.id in ("self", "cls")
            )
            recv = _root_name(func.value) or dotted_name(func.value) or "<expr>"
            if not bare_self:
                yield self.finding(
                    ctx, call,
                    f"`{fn.name}` calls cluster mutator `{recv}.{func.attr}()` "
                    "— placement is pure; only `cluster.apply(plan)` outside "
                    "the policy may commit state",
                )
        elif dotted_name(func) == "object.__setattr__" and call.args:
            first = call.args[0]
            if isinstance(first, ast.Name) and first.id in foreign:
                yield self.finding(
                    ctx, call,
                    f"`{fn.name}` writes into frozen argument "
                    f"`{first.id}` via object.__setattr__",
                )
