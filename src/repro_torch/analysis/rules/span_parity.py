"""span-parity: every span kind the port emits must be in its SPAN_SCHEMA
and pinned by its test suite.

The observability contract (repro_torch.obs): emitters pass the span
``kind`` as a string literal from the port's
:data:`repro_torch.obs.tracing.SPAN_SCHEMA`, so the whole span vocabulary
is statically enumerable.  Emissions are audited under ``src/repro_torch``
and pins counted in the port's tests (``tests/test_torch_*``).  This rule enforces the three
halves of that contract:

  * a ``Tracer.add_span`` / ``open_span`` / ``event`` call whose kind
    argument is NOT a string literal defeats static auditing — finding at
    the call site;
  * a literal kind that is missing from the schema table would raise at
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


def _live_schema() -> Tuple[str, ...]:
    from repro_torch.obs.tracing import SPAN_SCHEMA

    return tuple(SPAN_SCHEMA)


def _kind_arg(call: ast.Call) -> Optional[ast.expr]:
    """The span-kind argument of an emission call: positional #2
    (after tid) or the ``kind=`` keyword."""
    if len(call.args) >= 2:
        return call.args[1]
    for kw in call.keywords:
        if kw.arg == "kind":
            return kw.value
    return None


@register_rule
class SpanParityRule(Rule):
    name = "span-parity"
    severity = "error"
    description = (
        "every span kind emitted via Tracer.add_span/open_span/event must "
        "be a string literal, present in SPAN_SCHEMA, and named in the "
        "scanned port test suite (repro_torch.obs contract)"
    )
    default_paths = ("",)
    TEST_PATHS_OPTION = "test_paths"      # prefixes that count as test files
    SRC_PATHS_OPTION = "src_paths"        # prefixes whose emissions are audited
    SCHEMA_OPTION = "schema"              # schema override (fixtures)

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
        emits: List[Tuple[str, str, int]] = project.store.setdefault(
            "span_emits", [])  # type: ignore[assignment]
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _EMIT_METHODS):
                continue
            kind = _kind_arg(node)
            if kind is None:
                continue
            if not (isinstance(kind, ast.Constant)
                    and isinstance(kind.value, str)):
                yield self.finding(
                    ctx, node,
                    f"span kind passed to .{node.func.attr}() must be a "
                    "string literal from SPAN_SCHEMA — a computed kind "
                    "defeats the static span audit",
                )
                continue
            emits.append((kind.value, ctx.path, node.lineno))

    def finalize(self, project: ProjectContext) -> Iterator[Finding]:
        emits: List[Tuple[str, str, int]] = project.store.get(
            "span_emits", [])  # type: ignore[assignment]
        if not emits:
            return
        schema = self.options.get(self.SCHEMA_OPTION)
        if schema is None:
            try:
                schema = _live_schema()
            except Exception as e:  # schema unimportable in this env
                yield self.finding(
                    emits[0][1], emits[0][2],
                    f"could not import repro_torch.obs.tracing.SPAN_SCHEMA to "
                    f"cross-check emitted span kinds: {e!r}",
                )
                return
        schema = tuple(schema)
        for kind, path, line in emits:
            if kind not in schema:
                yield self.finding(
                    path, line,
                    f"span kind {kind!r} is not in SPAN_SCHEMA — add it to "
                    "the schema table (and obs/README.md) or fix the typo",
                )
        test_files: List[str] = project.store.get(
            "span_test_files", [])  # type: ignore[assignment]
        if not test_files:
            return
        literals: Set[str] = project.store.get(
            "span_test_literals", set())  # type: ignore[assignment]
        anchor = self._anchor(test_files)
        for kind in sorted({k for k, _, _ in emits}):
            if kind in schema and kind not in literals:
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
