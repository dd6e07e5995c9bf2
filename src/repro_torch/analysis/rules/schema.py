"""snapshot-schema: every FleetSnapshot site must agree with the ONE
declared leaf schema.

The invariant: ``FleetSnapshot``'s leaf order IS its dataclass field
order (the numpy converter and ``FleetSnapshot.validate`` iterate
``fields()``).  The schema has already drifted 12 -> 13 -> 15 -> 17 leaves
as the fleet model grew; a construction site that goes positional, or misses a new
leaf, reorders/omits leaves *silently* — the decision kernels then read
the wrong tensor with no shape error in sight.  The single source of
truth is the port's :data:`repro_torch.core.batched.FLEET_SNAPSHOT_SCHEMA`; this rule
checks, statically:

  * the ``FleetSnapshot`` dataclass declares exactly those fields in that
    order (and stays ``frozen=True``);
  * every ``FleetSnapshot(...)`` call is keyword-only and its keyword set
    equals the schema exactly (a ``**splat`` construction is accepted —
    the converter builds from the authoritative field list).

The runtime twin is ``FleetSnapshot.validate()``, asserted on every
``ClusterState.snapshot()`` under ``__debug__``.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Sequence, Tuple

from ..astutil import dotted_name, has_kwsplat, keyword_names
from ..framework import FileContext, Finding, ProjectContext, Rule, register_rule

_CLASS = "FleetSnapshot"


def _declared_schema() -> Tuple[str, ...]:
    from repro_torch.core.batched import FLEET_SNAPSHOT_SCHEMA

    return tuple(FLEET_SNAPSHOT_SCHEMA)


@register_rule
class SnapshotSchemaRule(Rule):
    name = "snapshot-schema"
    severity = "error"
    description = (
        "FleetSnapshot dataclass fields and every construction site must "
        "match FLEET_SNAPSHOT_SCHEMA exactly (keyword-only; no positional "
        "leaf drift)"
    )
    default_paths = ("",)
    SCHEMA_OPTION = "schema"      # override for fixture tests

    def _schema(self) -> Tuple[str, ...]:
        override = self.options.get(self.SCHEMA_OPTION)
        if override is not None:
            return tuple(override)  # type: ignore[arg-type]
        return _declared_schema()

    def check_file(self, ctx: FileContext, project: ProjectContext
                   ) -> Iterator[Finding]:
        schema = self._schema()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef) and node.name == _CLASS:
                yield from self._check_classdef(ctx, node, schema)
            elif isinstance(node, ast.Call):
                name = dotted_name(node.func)
                if name == _CLASS or (name and name.endswith("." + _CLASS)):
                    yield from self._check_construction(ctx, node, schema)

    # -- the dataclass declaration -------------------------------------------
    def _check_classdef(self, ctx: FileContext, node: ast.ClassDef,
                        schema: Sequence[str]) -> Iterator[Finding]:
        fields = tuple(
            stmt.target.id
            for stmt in node.body
            if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name)
        )
        if fields != tuple(schema):
            yield self.finding(
                ctx, node,
                f"{_CLASS} declares leaves {list(fields)} but the declared "
                f"schema is {list(schema)} — field order IS leaf "
                "order; update FLEET_SNAPSHOT_SCHEMA and every construction "
                "site together",
            )
        if not self._is_frozen_dataclass(node):
            yield self.finding(
                ctx, node,
                f"{_CLASS} must be @dataclass(frozen=True) — snapshots are "
                "immutable views shared across waves",
            )

    @staticmethod
    def _is_frozen_dataclass(node: ast.ClassDef) -> bool:
        for dec in node.decorator_list:
            if isinstance(dec, ast.Call) and dotted_name(dec.func) in (
                "dataclass", "dataclasses.dataclass"
            ):
                for kw in dec.keywords:
                    if kw.arg == "frozen" and isinstance(kw.value, ast.Constant):
                        return bool(kw.value.value)
        return False

    # -- construction sites ---------------------------------------------------
    def _check_construction(self, ctx: FileContext, call: ast.Call,
                            schema: Sequence[str]) -> Iterator[Finding]:
        if call.args:
            yield self.finding(
                ctx, call,
                f"positional {_CLASS} construction — leaf order has drifted "
                "12->13->15->17 as the model grew; pass every leaf by keyword so the "
                "next schema change cannot silently reorder leaves",
            )
        if has_kwsplat(call):
            # FleetSnapshot(**dict(zip(fields, vals))): the unflattener —
            # built from the authoritative field list, nothing to check
            return
        names = [n for n, _ in keyword_names(call)]
        missing = [s for s in schema if s not in names]
        unknown = [n for n in names if n not in schema]
        dupes = sorted({n for n in names if names.count(n) > 1})
        if missing and not call.args:
            yield self.finding(
                ctx, call,
                f"{_CLASS} construction misses schema leaves {missing} — "
                "every construction site must produce the full "
                f"{len(schema)}-leaf snapshot",
            )
        if unknown:
            yield self.finding(
                ctx, call,
                f"{_CLASS} construction passes unknown leaves {unknown} "
                f"(schema: {list(schema)})",
            )
        if dupes:
            yield self.finding(
                ctx, call, f"{_CLASS} construction repeats leaves {dupes}",
            )
