"""unit-consistency: seconds, bytes, bytes/s and probabilities may not be
mixed by ``+``/``-``/comparison on the pricing paths.

Eq. (2)'s total latency sums three *seconds* terms — ``exec_lat``,
``model_bytes / upload_bw`` and ``out_bytes / link_bw[src, dst]`` — and
the scalar shims' receiver-only-bandwidth bug is exactly what happens when a bytes
term slips into that sum without its dividing bandwidth.  This rule runs
the :mod:`..units` dataflow over every function in scope: names are
seeded from the core-API table (plus ``*_bytes``/``*_bw``/``n_*`` …
suffix rules), units propagate through assignments and arithmetic, and a
finding fires only when BOTH operands of an add/compare are known and
disagree (or a transcendental is applied to a dimensioned value).

Options:
  * ``units`` — ``{name: unit}`` entries merged over the default table
    (unit strings: ``s``, ``B``, ``B/s``, ``1/s``, ``prob``, ``count``,
    ``dimensionless``)
  * ``drop_units`` — names to remove from the table (when a repo area
    reuses a table name with a different meaning)
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

from ..astutil import walk_functions
from ..framework import FileContext, Finding, ProjectContext, Rule, register_rule
from ..units import (
    DEFAULT_SUFFIXES,
    DEFAULT_TABLE,
    Unit,
    UnitChecker,
    parse_unit,
)


@register_rule
class UnitConsistencyRule(Rule):
    name = "unit-consistency"
    severity = "error"
    description = (
        "units-of-measure dataflow on the pricing paths: no seconds+bytes "
        "adds, no mixed-unit comparisons, no exp/log of dimensioned values"
    )
    # the port's pricing arithmetic lives here; examples/benchmarks wrap it
    default_paths = ("src/repro_torch/core", "src/repro_torch/stream")

    def __init__(self, options=None) -> None:
        super().__init__(options)
        table: Dict[str, Unit] = {
            name: parse_unit(u) for name, u in DEFAULT_TABLE.items()
        }
        for name, u in dict(self.options.get("units", {})).items():
            table[name] = parse_unit(u)
        for name in tuple(self.options.get("drop_units", ())):
            table.pop(name, None)
        suffixes: Tuple[Tuple[str, Unit], ...] = tuple(
            (pat, parse_unit(u)) for pat, u in DEFAULT_SUFFIXES
        )
        self._checker = UnitChecker(table, suffixes)

    def check_file(self, ctx: FileContext, project: ProjectContext
                   ) -> Iterator[Finding]:
        for fn in walk_functions(ctx.tree):
            for p in self._checker.check_function(fn):
                yield self.finding(ctx, p.lineno, p.message, col=p.col)
