"""registry-parity: every policy/recovery the port registers must be pinned
by the port's test suite.

The invariant: every scheme in ``available_policies()`` ships
a batched decision kernel AND a scalar twin proven bit-identical by the
parity harness (``tests/test_torch_placement.py``), and every recovery
strategy in ``available_recoveries()`` is exercised by the churn suite.
The registries are the port's own (:mod:`repro_torch.core.policy`,
:mod:`repro_torch.core.recovery`), and only the port's tests
(``tests/test_torch_*``) count as pins.
A scheme that is registered but never named in a test file has *no parity
pin* — its batched and scalar paths can silently diverge, which is exactly
the failure mode the parity suites exist to prevent.

Mechanism: while walking the configured test paths the rule collects every
string literal; at finalize it imports the live registries (or takes them
from rule options, for fixtures) and reports any registered name that no
scanned test file ever mentions.  When no test files were scanned (e.g.
``python -m repro_torch.analysis src``) the rule stays silent rather than
guessing.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from ..framework import FileContext, Finding, ProjectContext, Rule, register_rule


def _live_registries() -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    from repro_torch.core.policy import available_policies
    from repro_torch.core.recovery import available_recoveries

    return tuple(available_policies()), tuple(available_recoveries())


@register_rule
class RegistryParityRule(Rule):
    name = "registry-parity"
    severity = "error"
    description = (
        "every name in available_policies()/available_recoveries() must "
        "appear in the scanned port test suite (batched/scalar parity pins)"
    )
    default_paths = ("",)
    TEST_PATHS_OPTION = "test_paths"      # prefixes that count as test files
    POLICIES_OPTION = "policies"          # registry overrides (fixtures)
    RECOVERIES_OPTION = "recoveries"

    def _test_paths(self) -> Tuple[str, ...]:
        return tuple(self.options.get(self.TEST_PATHS_OPTION, ("tests/test_torch_",)))

    def check_file(self, ctx: FileContext, project: ProjectContext
                   ) -> Iterator[Finding]:
        if any(ctx.path.startswith(p) for p in self._test_paths()):
            literals: Set[str] = project.store.setdefault("literals", set())  # type: ignore[assignment]
            test_files: List[str] = project.store.setdefault("test_files", [])  # type: ignore[assignment]
            test_files.append(ctx.path)
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.Constant) and isinstance(node.value, str):
                    literals.add(node.value)
        return iter(())

    def finalize(self, project: ProjectContext) -> Iterator[Finding]:
        test_files: List[str] = project.store.get("test_files", [])  # type: ignore[assignment]
        if not test_files:
            return
        literals: Set[str] = project.store.get("literals", set())  # type: ignore[assignment]
        policies = self.options.get(self.POLICIES_OPTION)
        recoveries = self.options.get(self.RECOVERIES_OPTION)
        if policies is None or recoveries is None:
            try:
                live_p, live_r = _live_registries()
            except Exception as e:  # registries unimportable in this env
                yield self.finding(
                    test_files[0], 1,
                    f"could not import the policy/recovery registries to "
                    f"cross-check parity pins: {e!r}",
                )
                return
            policies = live_p if policies is None else policies
            recoveries = live_r if recoveries is None else recoveries
        anchor = self._anchor(test_files)
        for name in policies:
            if name not in literals:
                yield self.finding(
                    anchor, 1,
                    f"registered policy {name!r} is never named in the "
                    "scanned test suite — it has no batched/scalar parity "
                    "pin (add it to the parity harness)",
                )
        for name in recoveries:
            if name not in literals:
                yield self.finding(
                    anchor, 1,
                    f"registered recovery {name!r} is never named in the "
                    "scanned test suite — add it to the churn/recovery "
                    "suite",
                )

    @staticmethod
    def _anchor(test_files: List[str]) -> str:
        for path in test_files:
            if "test_torch_placement" in path:
                return path
        return test_files[0]
