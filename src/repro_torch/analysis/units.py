"""Units-of-measure dataflow for the pricing paths.

The paper's Eq. (2) prices a placement as
``exec + model_bytes / upload_bw + out_bytes / link_bw[src, dst]`` —
seconds, bytes and bytes/second all flow through the same float arrays,
and the receiver-only-bandwidth bug of the scalar shims showed what happens when a bytes
term meets a seconds term without the dividing bandwidth.  This module
gives the linter a tiny unit system to catch that class statically:

  * :class:`Unit` — a signed exponent vector over the base dimensions
    ``s`` (seconds) and ``B`` (bytes), plus a *tag* for the dimensionless
    families worth keeping apart: ``prob`` (probabilities) and ``count``
    (cardinalities).  Tags survive same-tag arithmetic (``pf * pf`` is
    still a probability) and wash out against anything else.
  * a seeding table — the core API names with known units (``total``,
    ``upload``, ``deadline`` … are seconds; ``model_bytes``/``out_bytes``
    bytes; ``link_bw``/``up_bw`` bytes/s; ``pf``/``survival``
    probabilities; ``lam`` a hazard rate 1/s) plus suffix rules
    (``*_bytes``, ``*_bw``, ``*_lat``, ``n_*``, ``*_count`` …).  Rule
    options can extend/override the table per repo area.
  * :class:`UnitChecker` — intraprocedural forward propagation through
    assignments and expressions of one function.  Parameters and
    attribute reads seed from the table; any name assigned locally is
    *blocked* from table seeding (a local ``budget = len(queue)`` must
    not inherit the seconds of a ``budget`` API elsewhere).

Flagged (only when BOTH sides are known — silence is the failure mode of
every unit checker that guesses):
  * ``+``/``-``/comparison between different dimensions
    (``out_bytes + latency``) or between different tags (``pf > n_feas``)
  * ``exp``/``log``/``sqrt`` of a dimensioned quantity — a missing
    normalising divide (``exp(-lam * dt)`` is fine: 1/s x s cancels).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Set, Tuple

__all__ = [
    "Unit",
    "parse_unit",
    "DEFAULT_TABLE",
    "DEFAULT_SUFFIXES",
    "UnitChecker",
    "UnitProblem",
]


@dataclass(frozen=True)
class Unit:
    """Exponents over base dims + a dimensionless-family tag."""

    dims: Tuple[Tuple[str, int], ...] = ()     # sorted ((base, exp), ...)
    tag: Optional[str] = None                  # "prob" | "count" | None

    @staticmethod
    def of(tag: Optional[str] = None, **dims: int) -> "Unit":
        d = tuple(sorted((k, v) for k, v in dims.items() if v))
        return Unit(dims=d, tag=tag)

    @property
    def dimensionless(self) -> bool:
        return not self.dims

    def _combine(self, other: "Unit", sign: int) -> "Unit":
        acc = dict(self.dims)
        for base, exp in other.dims:
            acc[base] = acc.get(base, 0) + sign * exp
        tag = self.tag if self.tag == other.tag else None
        return Unit.of(tag=tag, **acc)

    def mul(self, other: "Unit") -> "Unit":
        return self._combine(other, +1)

    def div(self, other: "Unit") -> "Unit":
        return self._combine(other, -1)

    def compatible(self, other: "Unit") -> bool:
        """May the two be added/compared?  Same dims, and tags that don't
        contradict (an untagged dimensionless value mixes with either
        family)."""
        if self.dims != other.dims:
            return False
        return (
            self.tag == other.tag or self.tag is None or other.tag is None
        )

    def __str__(self) -> str:
        if self.tag is not None and not self.dims:
            return self.tag
        if not self.dims:
            return "dimensionless"
        num = [b if e == 1 else f"{b}^{e}" for b, e in self.dims if e > 0]
        den = [b if e == -1 else f"{b}^{-e}" for b, e in self.dims if e < 0]
        if num and den:
            return "/".join(["*".join(num), "*".join(den)])
        if den:
            return "1/" + "*".join(den)
        return "*".join(num)


SECONDS = Unit.of(s=1)
BYTES = Unit.of(B=1)
BYTES_PER_S = Unit.of(B=1, s=-1)
PER_S = Unit.of(s=-1)
PROB = Unit.of(tag="prob")
COUNT = Unit.of(tag="count")
DIMLESS = Unit.of()

_NAMED = {
    "s": SECONDS,
    "seconds": SECONDS,
    "B": BYTES,
    "bytes": BYTES,
    "B/s": BYTES_PER_S,
    "bytes/s": BYTES_PER_S,
    "1/s": PER_S,
    "prob": PROB,
    "count": COUNT,
    "dimensionless": DIMLESS,
}


def parse_unit(text: str) -> Unit:
    """Parse the unit strings used by the rule's options table."""
    try:
        return _NAMED[text.strip()]
    except KeyError:
        raise ValueError(
            f"unknown unit {text!r}; one of {sorted(_NAMED)}"
        ) from None


# The core API vocabulary.  Everything here is load-bearing somewhere in
# core/ or stream/ — keep names OUT of this table when the repo uses them
# with more than one meaning (e.g. `budget`: seconds for the tier-
# escalation latency budget, a row count in admission.pop_wave).
DEFAULT_TABLE: Dict[str, str] = {
    # seconds
    "t": "s",
    "dt": "s",
    "horizon": "s",
    "deadline": "s",
    "latency": "s",
    "latency_budget": "s",
    "exec_lat": "s",
    "upload": "s",
    "transfer": "s",
    "total": "s",
    "t_start": "s",
    "stage_offset": "s",
    "join_times": "s",
    "surv_grid": "s",
    "est": "s",
    "wait": "s",
    "e2e": "s",
    "finished": "s",
    "elapsed": "s",
    # bytes
    "model_bytes": "B",
    "out_bytes": "B",
    "in_bytes": "B",
    "mem_total": "B",
    "mem_required": "B",
    # bandwidths
    "bandwidth": "B/s",
    "bandwidths": "B/s",
    "link_bw": "B/s",
    "up_bw": "B/s",
    "down_bw": "B/s",
    "upload_bw": "B/s",
    "backhaul_bw": "B/s",
    "backhaul": "B/s",
    # probabilities
    "pf": "prob",
    "survival": "prob",
    "survival_pool": "prob",
    "alpha": "prob",
    "beta": "prob",
    # hazard rates (per-second): lam * dt is dimensionless
    "lam": "1/s",
    "lams": "1/s",
    # cardinalities
    "n_feas": "count",
    "queue_len": "count",
    "n_devices": "count",
    "n_rows": "count",
    "gamma": "count",
}

# (suffix/prefix pattern, unit) — matched when the exact table misses.
DEFAULT_SUFFIXES: Tuple[Tuple[str, str], ...] = (
    ("*_bytes", "B"),
    ("*_bw", "B/s"),
    ("*_lat", "s"),
    ("*_latency", "s"),
    ("*_deadline", "s"),
    ("*_seconds", "s"),
    ("n_*", "count"),
    ("*_count", "count"),
    ("*_len", "count"),
    ("*_depth", "count"),
)

_TRANSCENDENTALS = {"exp", "log", "log1p", "expm1", "log2", "log10", "sqrt"}

# numpy-style wrappers whose result carries the first array argument's unit
_PASSTHROUGH = {
    "abs", "asarray", "array", "maximum", "minimum", "max", "min", "sum",
    "mean", "median", "clip", "sort", "cumsum", "broadcast_to", "full_like",
    "zeros_like", "ones_like", "ascontiguousarray", "take_along_axis",
    "nan_to_num", "squeeze", "reshape", "ravel", "copy", "astype",
}
# where(cond, a, b): unit comes from the VALUE arguments
_WHERE = {"where"}


@dataclass(frozen=True)
class UnitProblem:
    lineno: int
    col: int
    message: str


class UnitChecker:
    """Forward unit propagation through one function body."""

    def __init__(self, table: Dict[str, Unit],
                 suffixes: Tuple[Tuple[str, Unit], ...]):
        self.table = table
        self.suffixes = suffixes

    # -- seeding -------------------------------------------------------------
    def lookup(self, name: str) -> Optional[Unit]:
        unit = self.table.get(name)
        if unit is not None:
            return unit
        import fnmatch

        for pat, u in self.suffixes:
            if fnmatch.fnmatchcase(name, pat):
                return u
        return None

    # -- per-function check --------------------------------------------------
    def check_function(self, fn: ast.AST) -> List[UnitProblem]:
        problems: List[UnitProblem] = []
        assigned = _assigned_names(fn)
        env: Dict[str, Optional[Unit]] = {}
        # parameters seed from the table even when reassigned later
        for pname in _params(fn):
            env[pname] = self.lookup(pname)

        def resolve_name(name: str) -> Optional[Unit]:
            if name in env:
                return env[name]
            if name in assigned:
                return None         # local not yet assigned on this path
            return self.lookup(name)

        def ev(node: ast.AST) -> Optional[Unit]:
            if isinstance(node, ast.Name):
                return resolve_name(node.id)
            if isinstance(node, ast.Attribute):
                return self.lookup(node.attr)
            if isinstance(node, ast.Subscript):
                return ev(node.value)
            if isinstance(node, ast.UnaryOp):
                return ev(node.operand)
            if isinstance(node, ast.IfExp):
                return ev(node.body) or ev(node.orelse)
            if isinstance(node, ast.BinOp):
                lu, ru = ev(node.left), ev(node.right)
                if isinstance(node.op, (ast.Add, ast.Sub)):
                    if lu is not None and ru is not None \
                            and not lu.compatible(ru):
                        problems.append(UnitProblem(
                            node.lineno, node.col_offset,
                            f"mixed-unit arithmetic: `{lu}` "
                            f"{'+' if isinstance(node.op, ast.Add) else '-'} "
                            f"`{ru}` — a conversion (divide by a bandwidth/"
                            "rate?) is missing",
                        ))
                        return None
                    return lu if lu is not None else ru
                if isinstance(node.op, ast.Mult):
                    if lu is not None and ru is not None:
                        return lu.mul(ru)
                    return None
                if isinstance(node.op, (ast.Div, ast.FloorDiv)):
                    if lu is not None and ru is not None:
                        return lu.div(ru)
                    return None
                if isinstance(node.op, ast.Mod):
                    return lu
                return None
            if isinstance(node, ast.Compare):
                left = node.left
                lu = ev(left)
                for op, right in zip(node.ops, node.comparators):
                    ru = ev(right)
                    if lu is not None and ru is not None \
                            and not lu.compatible(ru) \
                            and isinstance(op, (ast.Lt, ast.LtE, ast.Gt,
                                                ast.GtE, ast.Eq, ast.NotEq)):
                        problems.append(UnitProblem(
                            right.lineno, right.col_offset,
                            f"mixed-unit comparison: `{lu}` vs `{ru}` — "
                            "these measure different things",
                        ))
                    lu, left = ru, right
                return DIMLESS
            if isinstance(node, ast.Call):
                return ev_call(node)
            if isinstance(node, ast.Constant):
                return None         # bare numbers adopt the context's unit
            return None

        def ev_call(call: ast.Call) -> Optional[Unit]:
            func = call.func
            attr = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else None
            )
            if attr in _TRANSCENDENTALS and call.args:
                arg_u = ev(call.args[0])
                if arg_u is not None and not arg_u.dimensionless:
                    problems.append(UnitProblem(
                        call.lineno, call.col_offset,
                        f"`{attr}()` of a dimensioned quantity (`{arg_u}`) "
                        "— normalise first (divide by a rate/scale)",
                    ))
                return DIMLESS if attr != "sqrt" else None
            if attr in _WHERE and len(call.args) >= 3:
                a, b = ev(call.args[1]), ev(call.args[2])
                if a is not None and b is not None and not a.compatible(b):
                    problems.append(UnitProblem(
                        call.lineno, call.col_offset,
                        f"`where()` merges mixed units: `{a}` vs `{b}`",
                    ))
                return a if a is not None else b
            if attr in _PASSTHROUGH and call.args:
                return ev(call.args[0])
            if attr == "astype" and isinstance(func, ast.Attribute):
                return ev(func.value)
            return None

        def do_assign(target: ast.AST, unit: Optional[Unit]) -> None:
            if isinstance(target, ast.Name):
                env[target.id] = unit
            elif isinstance(target, (ast.Tuple, ast.List)):
                for elt in target.elts:
                    do_assign(elt, None)
            # attribute/subscript stores don't update the env

        for node in _walk_own_body(fn):
            if isinstance(node, ast.Assign):
                unit = ev(node.value)
                for tgt in node.targets:
                    do_assign(tgt, unit)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                do_assign(node.target, ev(node.value))
            elif isinstance(node, ast.AugAssign):
                # x += expr is x = x + expr
                synth = ast.BinOp(
                    left=node.target, op=node.op, right=node.value
                )
                ast.copy_location(synth, node)
                unit = ev(synth)
                if isinstance(node.target, ast.Name):
                    env[node.target.id] = unit
            elif isinstance(node, ast.For):
                # iterating an array yields elements of the same unit
                do_assign(node.target, ev(node.iter))
            elif isinstance(node, (ast.If, ast.While)):
                ev(node.test)
            elif isinstance(node, ast.Return) and node.value is not None:
                ev(node.value)
            elif isinstance(node, ast.Assert):
                ev(node.test)
            elif isinstance(node, ast.Expr):
                ev(node.value)
        return problems


def _params(fn: ast.AST) -> List[str]:
    args = getattr(fn, "args", None)
    if args is None:
        return []
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return names


def _assigned_names(fn: ast.AST) -> Set[str]:
    """Every bare name the function assigns anywhere (incl. loop targets,
    with-as, comprehension targets) — blocked from table seeding."""
    names: Set[str] = set(_params(fn))

    def collect(target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            names.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                collect(elt)
        elif isinstance(target, ast.Starred):
            collect(target.value)

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                collect(tgt)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            collect(node.target)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            collect(node.target)
        elif isinstance(node, ast.withitem) and node.optional_vars:
            collect(node.optional_vars)
        elif isinstance(node, ast.comprehension):
            collect(node.target)
        elif isinstance(node, ast.NamedExpr):
            collect(node.target)
    return names


def _walk_own_body(fn: ast.AST) -> Iterator[ast.AST]:
    """Statements/expressions of ``fn`` in source order, skipping nested
    function/class bodies (they get their own checker pass) but entering
    control-flow blocks."""
    stack = list(reversed(getattr(fn, "body", [])))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        for field_name in ("body", "orelse", "finalbody"):
            for child in reversed(getattr(node, field_name, []) or []):
                stack.append(child)
        for handler in getattr(node, "handlers", []) or []:
            for child in reversed(handler.body):
                stack.append(child)
