"""AST lint framework enforcing the port's orchestration contracts.

The port keeps the JAX package's load-bearing invariants — pure
``orchestrate`` vs mutating ``apply``, per-``(seed, id)`` common-random-
number streams, the declared
:data:`~repro_torch.core.batched.FLEET_SNAPSHOT_SCHEMA` leaf layout,
float64 decision kernels bit-identical to their numpy twins — which
otherwise exist only as convention plus runtime parity tests.  Each has been
violated at least once (ghost occupancy, reshuffled churn streams, silently
stale topology caches; see CHANGES.md).  This package turns them into lint
rules that fire at analysis time, before a 100k-device run or a DRL
training job ever executes.

The framework is deliberately small and dependency-free:

  * :class:`Rule` — one invariant.  ``check_file`` visits a parsed module;
    ``finalize`` runs once after the whole tree was walked (for cross-file
    rules like registry-parity).  Rules self-register via
    :func:`register_rule`.
  * :class:`LintConfig` / :class:`RuleSettings` — per-rule severity and
    *path scoping*: a rule only fires on files whose repo-relative path
    starts with one of its configured prefixes (``""`` = everywhere).
  * Suppressions — ``# repro-lint: disable=<rule>[,<rule>...]`` on the
    finding's line silences it; ``# repro-lint: disable-file=<rule>``
    anywhere in the file silences the whole module.  ``all`` matches every
    rule.  Suppressed findings are counted, not lost — and a suppression
    that silences *nothing* is itself reported as a ``useless-suppression``
    warning (stale disables may not rot in place).
  * :class:`Analyzer` — walks the paths, parses each ``*.py`` once, runs
    the scoped rules, applies suppressions (to per-file AND finalize-time
    findings), and returns findings sorted by location.  A file that fails
    to parse yields a ``parse-error`` finding instead of crashing the run.
"""
from __future__ import annotations

import ast
import fnmatch
import io
import os
import re
import time
import tokenize
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Set, Tuple, Type

__all__ = [
    "Finding",
    "FileContext",
    "ProjectContext",
    "Rule",
    "RuleSettings",
    "LintConfig",
    "Analyzer",
    "SuppressionTable",
    "register_rule",
    "available_rules",
    "SEVERITIES",
]

SEVERITIES = ("error", "warning")

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Za-z0-9_,\- ]+)")
_SUPPRESS_FILE_RE = re.compile(r"#\s*repro-lint:\s*disable-file=([A-Za-z0-9_,\- ]+)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    severity: str          # "error" | "warning"
    path: str              # repo-relative (or as-given) path
    line: int              # 1-based
    col: int               # 0-based
    message: str

    def to_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.severity}[{self.rule}] {self.message}"
        )


@dataclass
class FileContext:
    """One parsed module handed to every scoped rule."""

    path: str                     # repo-relative posix path
    source: str
    tree: ast.Module
    lines: List[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.lines:
            self.lines = self.source.splitlines()

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


@dataclass
class ProjectContext:
    """Cross-file state for ``Rule.finalize``: the scoped files each rule
    saw plus a free-form per-rule scratch store filled during
    ``check_file``."""

    files: List[FileContext] = field(default_factory=list)
    store: Dict[str, object] = field(default_factory=dict)
    root: str = ""                # analyzer root (abs path of rel paths)


class Rule:
    """Base class: one statically-checkable orchestration contract.

    Subclasses set ``name`` (the id used in reports, config, and
    suppression comments), ``severity``, ``description`` (one line, shown
    by ``--list-rules``) and ``default_paths`` (repo-relative prefixes the
    rule applies to by default; ``("",)`` = everywhere).
    """

    name: str = ""
    severity: str = "error"
    description: str = ""
    default_paths: Tuple[str, ...] = ("",)

    def __init__(self, options: Optional[Dict[str, object]] = None) -> None:
        self.options: Dict[str, object] = dict(options or {})

    # -- hooks ---------------------------------------------------------------
    def check_file(self, ctx: FileContext, project: ProjectContext
                   ) -> Iterator[Finding]:
        return iter(())

    def finalize(self, project: ProjectContext) -> Iterator[Finding]:
        return iter(())

    # -- helpers -------------------------------------------------------------
    def finding(self, ctx_or_path, node_or_line, message: str,
                col: Optional[int] = None) -> Finding:
        path = ctx_or_path.path if isinstance(ctx_or_path, FileContext) else str(ctx_or_path)
        if isinstance(node_or_line, ast.AST):
            line = getattr(node_or_line, "lineno", 1)
            c = getattr(node_or_line, "col_offset", 0) if col is None else col
        else:
            line = int(node_or_line)
            c = 0 if col is None else col
        return Finding(self.name, self.severity, path, line, c, message)


# -- rule registry -------------------------------------------------------------

_RULES: Dict[str, Type[Rule]] = {}


def register_rule(cls: Type[Rule]) -> Type[Rule]:
    if not cls.name:
        raise ValueError(f"rule class {cls.__name__} has no name")
    if cls.name in _RULES:
        raise ValueError(f"duplicate rule name {cls.name!r}")
    if cls.severity not in SEVERITIES:
        raise ValueError(f"rule {cls.name!r}: bad severity {cls.severity!r}")
    _RULES[cls.name] = cls
    return cls


def available_rules() -> Tuple[str, ...]:
    _load_builtin_rules()
    return tuple(sorted(_RULES))


def rule_class(name: str) -> Type[Rule]:
    _load_builtin_rules()
    return _RULES[name]


def _load_builtin_rules() -> None:
    # importing the package registers every built-in rule exactly once
    from . import rules as _  # noqa: F401


# -- configuration -------------------------------------------------------------

@dataclass(frozen=True)
class RuleSettings:
    """Per-rule knobs: on/off, severity override, path scope, rule options."""

    enabled: bool = True
    severity: Optional[str] = None          # None = the rule's own default
    paths: Optional[Tuple[str, ...]] = None  # None = the rule's default_paths
    options: Dict[str, object] = field(default_factory=dict)


@dataclass(frozen=True)
class LintConfig:
    """Analyzer configuration.

    ``exclude`` holds glob patterns matched against repo-relative paths;
    the default excludes the deliberately-violating lint fixtures under
    ``tests/fixtures/lint/``.  ``rules`` maps rule name -> settings; rules
    absent from the map run with their class defaults.  ``select`` limits
    the run to the named rules (None = all registered).
    """

    exclude: Tuple[str, ...] = ("tests/fixtures/lint/*", "*/fixtures/lint/*")
    rules: Dict[str, RuleSettings] = field(default_factory=dict)
    select: Optional[Tuple[str, ...]] = None

    def settings(self, name: str) -> RuleSettings:
        return self.rules.get(name, RuleSettings())

    def permissive(self) -> "LintConfig":
        """Every rule everywhere, no excludes — what the fixture tests use."""
        rules = {
            name: replace(self.settings(name), paths=("",))
            for name in available_rules()
        }
        return replace(self, exclude=(), rules=rules)


def _rel(path: str, root: str) -> str:
    try:
        rel = os.path.relpath(path, root)
    except ValueError:           # different drive (windows) — keep absolute
        rel = path
    return rel.replace(os.sep, "/")


def _match_scope(path: str, prefixes: Tuple[str, ...]) -> bool:
    return any(path.startswith(p) for p in prefixes)


def _excluded(path: str, patterns: Tuple[str, ...]) -> bool:
    return any(fnmatch.fnmatch(path, pat) for pat in patterns)


def _iter_comments(source: str) -> Iterator[Tuple[int, str]]:
    """(lineno, text) of each comment token; falls back to a raw line scan
    when the source does not tokenize (the caller already parsed it, so
    this is belt-and-braces for exotic encodings)."""
    try:
        toks = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        for i, line in enumerate(source.splitlines(), start=1):
            if "#" in line:
                yield i, line[line.index("#"):]
        return
    for tok in toks:
        if tok.type == tokenize.COMMENT:
            yield tok.start[0], tok.string


@dataclass
class _SuppEntry:
    """One ``repro-lint: disable[-file]=`` comment: where it sits, which
    rules it names, and how many findings each named rule suppressed."""

    line: int                     # 1-based line of the comment itself
    file_level: bool
    hits: Dict[str, int]          # rule name (or "all") -> findings silenced


class SuppressionTable:
    """All suppression comments of one file, with hit accounting."""

    def __init__(self, source: str):
        self.entries: List[_SuppEntry] = []
        # only real COMMENT tokens count — a disable marker inside a string
        # literal (e.g. test code building fixture sources) must neither
        # suppress anything nor be reported as a stale suppression
        for lineno, comment in _iter_comments(source):
            if "repro-lint" not in comment:
                continue
            m = _SUPPRESS_FILE_RE.search(comment)
            file_level = bool(m)
            if not m:
                m = _SUPPRESS_RE.search(comment)
            if not m:
                continue
            rules = [r.strip() for r in m.group(1).split(",") if r.strip()]
            if rules:
                self.entries.append(_SuppEntry(
                    line=lineno, file_level=file_level,
                    hits={r: 0 for r in rules},
                ))

    def suppress(self, fnd: Finding) -> bool:
        """True (and count the hit) when some entry silences ``fnd``."""
        hit = False
        for e in self.entries:
            if not (e.file_level or e.line == fnd.line):
                continue
            for key in (fnd.rule, "all"):
                if key in e.hits:
                    e.hits[key] += 1
                    hit = True
                    break
        return hit

    def useless(self, ran_rules: Set[str]) -> Iterator[Tuple[int, str]]:
        """(line, rule-name) for every named rule that silenced nothing.

        Only rules that actually RAN on this file are judged — a disable
        for a rule outside this run's selection might be load-bearing."""
        for e in self.entries:
            for rule, n in e.hits.items():
                if n:
                    continue
                if rule == "all":
                    if ran_rules:
                        yield e.line, rule
                elif rule in ran_rules:
                    yield e.line, rule


@dataclass
class LintReport:
    """Everything one Analyzer.run produced."""

    findings: List[Finding]
    suppressed: int
    files_scanned: int
    rules_run: Tuple[str, ...]
    elapsed_s: float = 0.0        # wall-clock of the whole run (CI budget log)

    @property
    def errors(self) -> int:
        return sum(1 for f in self.findings if f.severity == "error")

    @property
    def warnings(self) -> int:
        return sum(1 for f in self.findings if f.severity == "warning")

    @property
    def exit_code(self) -> int:
        return 1 if self.errors else 0


class Analyzer:
    """Walk paths, parse modules once, run every scoped rule, apply
    suppressions, finalize cross-file rules."""

    def __init__(self, config: Optional[LintConfig] = None,
                 root: Optional[str] = None) -> None:
        self.config = config or LintConfig()
        self.root = os.path.abspath(root or os.getcwd())
        _load_builtin_rules()
        names = self.config.select or available_rules()
        unknown = [n for n in names if n not in _RULES]
        if unknown:
            raise ValueError(
                f"unknown rules {unknown}; available: {list(available_rules())}"
            )
        self._rules: List[Tuple[Rule, Tuple[str, ...], Optional[str]]] = []
        for name in names:
            st = self.config.settings(name)
            if not st.enabled:
                continue
            cls = _RULES[name]
            rule = cls(options=st.options)
            paths = st.paths if st.paths is not None else cls.default_paths
            self._rules.append((rule, paths, st.severity))

    # -- file discovery ------------------------------------------------------
    def _iter_py_files(self, paths: Iterable[str]) -> Iterator[str]:
        seen = set()
        for p in paths:
            ap = os.path.abspath(p)
            if os.path.isfile(ap):
                if ap.endswith(".py") and ap not in seen:
                    seen.add(ap)
                    yield ap
            elif os.path.isdir(ap):
                for dirpath, dirnames, filenames in os.walk(ap):
                    dirnames[:] = sorted(
                        d for d in dirnames
                        if d not in {"__pycache__", ".git", ".pytest_cache"}
                    )
                    for fn in sorted(filenames):
                        if fn.endswith(".py"):
                            fp = os.path.join(dirpath, fn)
                            if fp not in seen:
                                seen.add(fp)
                                yield fp

    # -- driver --------------------------------------------------------------
    def run(self, paths: Iterable[str]) -> LintReport:
        t0 = time.perf_counter()
        projects: Dict[str, ProjectContext] = {
            rule.name: ProjectContext(root=self.root) for rule, _, _ in self._rules
        }
        findings: List[Finding] = []
        suppressed = 0
        n_files = 0
        supp_tables: Dict[str, SuppressionTable] = {}
        ran_rules: Dict[str, Set[str]] = {}
        for fp in self._iter_py_files(paths):
            rel = _rel(fp, self.root)
            if _excluded(rel, self.config.exclude):
                continue
            n_files += 1
            try:
                with open(fp, "r", encoding="utf-8") as f:
                    source = f.read()
                tree = ast.parse(source, filename=rel)
            except (SyntaxError, UnicodeDecodeError) as e:
                lineno = getattr(e, "lineno", 1) or 1
                findings.append(Finding(
                    "parse-error", "error", rel, int(lineno), 0,
                    f"could not parse: {e.__class__.__name__}: {e}",
                ))
                continue
            table = supp_tables[rel] = SuppressionTable(source)
            ran_rules[rel] = set()
            ctx = FileContext(path=rel, source=source, tree=tree)
            for rule, scope, sev_override in self._rules:
                if not _match_scope(rel, scope):
                    continue
                ran_rules[rel].add(rule.name)
                project = projects[rule.name]
                project.files.append(ctx)
                for fnd in rule.check_file(ctx, project):
                    if sev_override:
                        fnd = replace(fnd, severity=sev_override)
                    if table.suppress(fnd):
                        suppressed += 1
                    else:
                        findings.append(fnd)
        # finalize-time (cross-file) findings honour suppressions too: the
        # transitive rules anchor findings at real source lines, and a
        # justified inline disable must silence those the same way
        for rule, _, sev_override in self._rules:
            for fnd in rule.finalize(projects[rule.name]):
                if sev_override:
                    fnd = replace(fnd, severity=sev_override)
                table = supp_tables.get(fnd.path)
                if table is not None and table.suppress(fnd):
                    suppressed += 1
                else:
                    findings.append(fnd)
        # a disable that silenced nothing is itself a (warning) finding —
        # stale suppressions from old fix-up passes may not rot in place
        for rel, table in supp_tables.items():
            for line, rule_name in table.useless(ran_rules[rel]):
                fnd = Finding(
                    "useless-suppression", "warning", rel, line, 0,
                    f"suppression `disable={rule_name}` matched no finding "
                    "of that rule in this run — remove the stale comment "
                    "(or fix the rule name)",
                )
                if not table.suppress(fnd):
                    findings.append(fnd)
        findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        return LintReport(
            findings=findings,
            suppressed=suppressed,
            files_scanned=n_files,
            rules_run=tuple(r.name for r, _, _ in self._rules),
            elapsed_s=time.perf_counter() - t0,
        )
