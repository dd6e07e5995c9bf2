"""span-parity: every span kind the port emits must be in its schema and
pinned by its test suite.

The observability contract (repro_torch.obs): emitters pass the span
``kind`` as a string literal from the port's
:data:`repro_torch.obs.tracing.SPAN_SCHEMA` (the simulator's ``Tracer``)
or :data:`repro_torch.obs.tracing.RUNTIME_SCHEMA` (the runtime's
``span(kind, ...)`` or ``runtime.span(kind, ...)``), so the whole
span vocabulary is statically enumerable.  Emissions are audited under ``src/repro_torch``
and pins counted in the port's tests (``tests/test_torch_*``).  This rule enforces the three
halves of that contract:

  * a ``Tracer.add_span`` / ``open_span`` / ``event`` or runtime
    ``span`` call whose kind argument is NOT a string literal defeats
    static auditing — finding at the call site;
  * a literal kind that is missing from its schema table would raise at
    runtime (the tracer validates) but should be caught at lint time —
    finding at the call site;
  * a kind emitted somewhere in src but never named in any scanned test
    file has no behavioural pin (nothing fails if its emission silently
    disappears) — finding anchored at the obs test file, mirroring
    registry-parity.

Like registry-parity, the rule stays silent about test pins when no test
files were scanned (e.g. ``python -m repro_torch.analysis src``).
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from ..framework import FileContext, Finding, ProjectContext, Rule, register_rule

# Tracer emission methods whose second positional argument is a span kind.
_EMIT_METHODS = ("add_span", "open_span", "event")
# The runtime's emission function, whose first positional argument is a kind:
# called as ``span(...)`` or ``runtime.span(...)`` (not ``match.span(0)``).
_RUNTIME_EMIT = "span"


def _live_schema(name: str) -> Tuple[str, ...]:
    from repro_torch.obs import tracing

    return tuple(getattr(tracing, name))


def _kind_arg(call: ast.Call, position: int) -> Optional[ast.expr]:
    """The span-kind argument of an emission call: positional ``position``
    (1 after a tracer's tid, 0 for the runtime's ``span``) or the ``kind=``
    keyword."""
    if len(call.args) > position:
        return call.args[position]
    for kw in call.keywords:
        if kw.arg == "kind":
            return kw.value
    return None


def _emission(node: ast.AST) -> Optional[Tuple[str, str, int]]:
    """``(callee, schema name, kind position)`` of an emission call, else None."""
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr in _EMIT_METHODS:
        return f".{func.attr}", "SPAN_SCHEMA", 1
    if (isinstance(func, ast.Name) and func.id == _RUNTIME_EMIT) or (
            isinstance(func, ast.Attribute) and func.attr == _RUNTIME_EMIT
            and isinstance(func.value, ast.Name) and func.value.id == "runtime"):
        return _RUNTIME_EMIT, "RUNTIME_SCHEMA", 0
    return None


@register_rule
class SpanParityRule(Rule):
    name = "span-parity"
    severity = "error"
    description = (
        "every span kind emitted via Tracer.add_span/open_span/event or the "
        "runtime's span() must be a string literal, present in SPAN_SCHEMA "
        "or RUNTIME_SCHEMA, and named in the scanned port test suite "
        "(repro_torch.obs contract)"
    )
    default_paths = ("",)
    TEST_PATHS_OPTION = "test_paths"      # prefixes that count as test files
    SRC_PATHS_OPTION = "src_paths"        # prefixes whose emissions are audited
    SCHEMA_OPTION = "schema"              # SPAN_SCHEMA override (fixtures)

    def _test_paths(self) -> Tuple[str, ...]:
        return tuple(self.options.get(self.TEST_PATHS_OPTION, ("tests/test_torch_",)))

    def _src_paths(self) -> Tuple[str, ...]:
        return tuple(self.options.get(self.SRC_PATHS_OPTION, ("src/repro_torch",)))

    def check_file(self, ctx: FileContext, project: ProjectContext
                   ) -> Iterator[Finding]:
        if any(ctx.path.startswith(p) for p in self._test_paths()):
            literals: Set[str] = project.store.setdefault(
                "span_test_literals", set())  # type: ignore[assignment]
            test_files: List[str] = project.store.setdefault(
                "span_test_files", [])  # type: ignore[assignment]
            test_files.append(ctx.path)
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.Constant) and isinstance(node.value, str):
                    literals.add(node.value)
        if not any(ctx.path.startswith(p) for p in self._src_paths()):
            return
        emits: List[Tuple[str, str, str, int]] = project.store.setdefault(
            "span_emits", [])  # type: ignore[assignment]
        for node in ast.walk(ctx.tree):
            found = _emission(node)
            if found is None:
                continue
            method, schema, position = found
            kind = _kind_arg(node, position)
            if kind is None:
                continue
            if not (isinstance(kind, ast.Constant)
                    and isinstance(kind.value, str)):
                yield self.finding(
                    ctx, node,
                    f"span kind passed to {method}() must be a "
                    f"string literal from {schema} — a computed kind "
                    "defeats the static span audit",
                )
                continue
            emits.append((schema, kind.value, ctx.path, node.lineno))

    def finalize(self, project: ProjectContext) -> Iterator[Finding]:
        emits: List[Tuple[str, str, str, int]] = project.store.get(
            "span_emits", [])  # type: ignore[assignment]
        if not emits:
            return
        schemas = {}
        for name in sorted({s for s, _, _, _ in emits}):
            given = self.options.get(self.SCHEMA_OPTION) if name == "SPAN_SCHEMA" else None
            try:
                schemas[name] = tuple(given) if given is not None else _live_schema(name)
            except Exception as e:  # schema unimportable in this env
                first = next(e_ for e_ in emits if e_[0] == name)
                yield self.finding(
                    first[2], first[3],
                    f"could not import repro_torch.obs.tracing.{name} to "
                    f"cross-check emitted span kinds: {e!r}",
                )
                return
        for schema, kind, path, line in emits:
            if kind not in schemas[schema]:
                yield self.finding(
                    path, line,
                    f"span kind {kind!r} is not in {schema} — add it to "
                    "the schema table (and obs/README.md) or fix the typo",
                )
        test_files: List[str] = project.store.get(
            "span_test_files", [])  # type: ignore[assignment]
        if not test_files:
            return
        literals: Set[str] = project.store.get(
            "span_test_literals", set())  # type: ignore[assignment]
        anchor = self._anchor(test_files)
        for schema, kind in sorted({(s, k) for s, k, _, _ in emits}):
            if kind in schemas[schema] and kind not in literals:
                yield self.finding(
                    anchor, 1,
                    f"span kind {kind!r} is emitted in src but never named "
                    "in the scanned test suite — it has no behavioural pin "
                    "(add it to the obs suite)",
                )

    @staticmethod
    def _anchor(test_files: List[str]) -> str:
        for path in test_files:
            if "test_torch_obs" in path:
                return path
        return test_files[0]
