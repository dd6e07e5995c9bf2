"""Project-wide call graph over the scanned files.

The transitive contract rules (``policy-purity``, ``rng-discipline``) need
to see *through* helpers: ``decide -> _helper -> ctx.cluster.apply()`` is a
purity violation even though no single function body shows both the policy
entry point and the mutator call.  This module builds the inter-procedural
substrate:

  * :class:`ModuleSummary` — everything one file contributes: its dotted
    module name, defined functions/methods (with their raw call sites and
    *base* effects, see :mod:`.effects`), classes with their base-class
    names, and the import table.  Summaries are pure data — JSON
    round-trippable — and memoised by **content hash**, so repeated runs
    (the fixture test matrix, a warm CI cache) never re-walk an unchanged
    file's AST.
  * :class:`CallGraph` — resolves raw call sites against the project:
    local functions, ``from m import f`` targets (re-export chains
    followed), ``mod.f`` through import aliases, ``self.m()``/``super().m()``
    through the class hierarchy.  Unresolvable calls (third-party,
    dynamic dispatch) are simply absent — the analysis under-approximates,
    which is the right polarity for a linter.

Resolution is name-based and best-effort by design: the repo's contracts
live in statically-known helper chains, not in dynamic dispatch.
"""
from __future__ import annotations

import ast
import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .astutil import dotted_name, param_names

__all__ = [
    "BaseEffect",
    "CallSite",
    "FuncInfo",
    "ModuleSummary",
    "CallGraph",
    "summarize_module",
    "module_name_for",
    "load_summary_cache",
    "save_summary_cache",
    "summary_cache_stats",
    "torch_global_rng",
    "host_sync",
]

# Cluster mutators (kept in sync with rules.purity.MUTATORS — the single
# list is re-exported there to avoid a cycle).
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

# np.random attributes that are construction, not global-state draws
# (mirrors rules.rng._ALLOWED_NP_RANDOM).
_ALLOWED_NP_RANDOM = {
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937",
}

_IO_CALLS = {
    "open",
    "os.remove", "os.unlink", "os.makedirs", "os.mkdir", "os.rename",
    "shutil.copy", "shutil.copytree", "shutil.rmtree", "shutil.move",
    "json.dump", "pickle.dump", "np.save", "numpy.save", "np.savez",
}
_IO_METHOD_ATTRS = {"write_text", "write_bytes", "to_csv", "savefig"}

# torch functions that draw from the default generator unless they are given
# ``generator=`` (rules.rng reads them through torch_global_rng)
_TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "normal", "bernoulli", "multinomial",
}
# calls that reseed torch's default generators: global state either way
_TORCH_RESEEDS = {
    "torch.manual_seed", "torch.seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
}
# tensor methods that bring a value to the host and wait for the device
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}


@dataclass(frozen=True)
class BaseEffect:
    """One intra-procedural effect occurrence inside a function body."""

    kind: str          # cluster-mutation | global-rng | wall-clock | host-sync | io
    lineno: int
    desc: str          # e.g. "ctx.cluster.apply()" or "np.random.shuffle()"

    def to_dict(self) -> dict:
        return {"kind": self.kind, "lineno": self.lineno, "desc": self.desc}

    @staticmethod
    def from_dict(d: dict) -> "BaseEffect":
        return BaseEffect(str(d["kind"]), int(d["lineno"]), str(d["desc"]))


@dataclass(frozen=True)
class CallSite:
    """One call expression inside a function body, pre-resolution.

    ``target_kind`` says how to resolve ``target``:
      * ``"name"``   — bare ``f(...)``: local function / from-import
      * ``"self"``   — ``self.m(...)`` / ``cls.m(...)``: method lookup
      * ``"super"``  — ``super().m(...)``: base-class method lookup
      * ``"dotted"`` — ``alias.attr(...)``: module alias or local class

    ``pos_args``/``kw_args`` carry the *caller-local names* passed as bare
    ``Name`` arguments (None for any other expression) — the data the
    effect engine needs to propagate parameter mutations through calls.
    """

    lineno: int
    target_kind: str
    target: str
    pos_args: Tuple[Optional[str], ...] = ()
    kw_args: Tuple[Tuple[str, Optional[str]], ...] = ()

    def to_dict(self) -> dict:
        return {
            "lineno": self.lineno, "target_kind": self.target_kind,
            "target": self.target, "pos_args": list(self.pos_args),
            "kw_args": [list(kv) for kv in self.kw_args],
        }

    @staticmethod
    def from_dict(d: dict) -> "CallSite":
        return CallSite(
            int(d["lineno"]), str(d["target_kind"]), str(d["target"]),
            tuple(d["pos_args"]),
            tuple((str(k), v) for k, v in d["kw_args"]),
        )


@dataclass
class FuncInfo:
    """One function or method, with its raw call sites and base effects."""

    qualname: str                 # "repro_torch.core.policy.IBDASHPolicy.decide"
    module: str
    cls: Optional[str]
    name: str
    path: str                     # repo-relative posix path
    lineno: int
    params: Tuple[str, ...]       # declared order, `self` included
    calls: Tuple[CallSite, ...] = ()
    effects: Tuple[BaseEffect, ...] = ()
    # param name -> (lineno, description) for direct stores through it
    param_mutations: Dict[str, Tuple[int, str]] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "qualname": self.qualname, "module": self.module,
            "cls": self.cls, "name": self.name, "path": self.path,
            "lineno": self.lineno, "params": list(self.params),
            "calls": [c.to_dict() for c in self.calls],
            "effects": [e.to_dict() for e in self.effects],
            "param_mutations": {
                k: list(v) for k, v in self.param_mutations.items()
            },
        }

    @staticmethod
    def from_dict(d: dict) -> "FuncInfo":
        return FuncInfo(
            qualname=str(d["qualname"]), module=str(d["module"]),
            cls=d["cls"], name=str(d["name"]), path=str(d["path"]),
            lineno=int(d["lineno"]), params=tuple(d["params"]),
            calls=tuple(CallSite.from_dict(c) for c in d["calls"]),
            effects=tuple(BaseEffect.from_dict(e) for e in d["effects"]),
            param_mutations={
                k: (int(v[0]), str(v[1]))
                for k, v in d["param_mutations"].items()
            },
        )


@dataclass
class ModuleSummary:
    """Everything one file contributes to the project call graph."""

    path: str
    module: str                               # dotted module name
    functions: Dict[str, FuncInfo]            # qualname -> info
    classes: Dict[str, Tuple[str, ...]]       # class name -> raw base names
    import_modules: Dict[str, str]            # alias -> dotted module
    import_names: Dict[str, Tuple[str, str]]  # name -> (module, attr)

    def to_dict(self) -> dict:
        return {
            "path": self.path, "module": self.module,
            "functions": {q: f.to_dict() for q, f in self.functions.items()},
            "classes": {c: list(b) for c, b in self.classes.items()},
            "import_modules": dict(self.import_modules),
            "import_names": {k: list(v) for k, v in self.import_names.items()},
        }

    @staticmethod
    def from_dict(d: dict) -> "ModuleSummary":
        return ModuleSummary(
            path=str(d["path"]), module=str(d["module"]),
            functions={
                q: FuncInfo.from_dict(f) for q, f in d["functions"].items()
            },
            classes={c: tuple(b) for c, b in d["classes"].items()},
            import_modules=dict(d["import_modules"]),
            import_names={
                k: (str(v[0]), str(v[1]))
                for k, v in d["import_names"].items()
            },
        )


def module_name_for(path: str) -> str:
    """Dotted module name for a repo-relative path:
    ``src/repro_torch/core/x.py`` -> ``repro_torch.core.x``, ``tests/foo.py`` -> ``tests.foo``; ``__init__``
    names the package itself."""
    p = path[:-3] if path.endswith(".py") else path
    if p.startswith("src/"):
        p = p[4:]
    parts = [seg for seg in p.split("/") if seg]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


# -- per-file extraction (memoised by content hash) ----------------------------

_SUMMARY_MEMO: Dict[str, ModuleSummary] = {}
_MEMO_HITS = [0, 0]  # [hits, misses] — exposed for the cache tests/CI log


def summary_cache_stats() -> Tuple[int, int]:
    """(hits, misses) of the content-hash summary memo."""
    return _MEMO_HITS[0], _MEMO_HITS[1]


def _content_key(path: str, source: str) -> str:
    h = hashlib.sha256()
    # this linter's summaries carry torch effects: a cache file written by
    # another linter over the same sources never answers for them
    h.update(b"repro_torch.analysis\0")
    h.update(path.encode())
    h.update(b"\0")
    h.update(source.encode())
    return h.hexdigest()


def summarize_module(path: str, source: str,
                     tree: Optional[ast.Module] = None) -> ModuleSummary:
    """Extract (or recall, keyed by content hash) one file's summary."""
    key = _content_key(path, source)
    cached = _SUMMARY_MEMO.get(key)
    if cached is not None:
        _MEMO_HITS[0] += 1
        return cached
    _MEMO_HITS[1] += 1
    if tree is None:
        tree = ast.parse(source, filename=path)
    summary = _extract(path, tree)
    _SUMMARY_MEMO[key] = summary
    return summary


def load_summary_cache(file: str) -> int:
    """Pre-warm the memo from a JSON cache file; returns entries loaded."""
    try:
        with open(file, "r", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return 0
    n = 0
    for key, d in data.get("summaries", {}).items():
        try:
            _SUMMARY_MEMO[key] = ModuleSummary.from_dict(d)
            n += 1
        except (KeyError, TypeError, ValueError):
            continue
    return n


def save_summary_cache(file: str) -> int:
    """Persist the memo as JSON keyed by content hash; returns entries."""
    data = {
        "version": 1,
        "summaries": {k: s.to_dict() for k, s in _SUMMARY_MEMO.items()},
    }
    with open(file, "w", encoding="utf-8") as f:
        json.dump(data, f)
    return len(_SUMMARY_MEMO)


def _root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def torch_global_rng(call: ast.Call) -> Optional[str]:
    """``torch.randn(...)`` & co. without ``generator=`` (a ``**`` splat may
    carry one, and is let pass), or a reseed of torch's default generators:
    the call's description, else None."""
    name = dotted_name(call.func)
    if name is None:
        return None
    if name in _TORCH_RESEEDS:
        return f"{name}()"
    if (name.startswith("torch.") and name[len("torch."):] in _TORCH_DRAWS
            and not any(kw.arg in ("generator", None) for kw in call.keywords)):
        return f"{name}()"
    return None


def host_sync(call: ast.Call) -> Optional[str]:
    """A call that waits for the device and brings a value to the host:
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``
    (or ``device="cpu"``) and ``torch.cuda.synchronize()``; its description,
    else None."""
    func = call.func
    if dotted_name(func) == "torch.cuda.synchronize":
        return "torch.cuda.synchronize()"
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr in _HOST_SYNC_METHODS and not call.args:
        return f".{func.attr}()"
    if func.attr == "to":
        targets = call.args[:1] + [kw.value for kw in call.keywords if kw.arg == "device"]
        if any(isinstance(t, ast.Constant) and isinstance(t.value, str)
               and t.value.startswith("cpu") for t in targets):
            return '.to("cpu")'
    return None


def _base_effects_of_call(call: ast.Call) -> Iterator[BaseEffect]:
    name = dotted_name(call.func)
    func = call.func
    # cluster mutators on any receiver other than bare self/cls
    if isinstance(func, ast.Attribute) and func.attr in MUTATORS:
        bare_self = (
            isinstance(func.value, ast.Name)
            and func.value.id in ("self", "cls")
        )
        if not bare_self:
            recv = dotted_name(func.value) or _root_name(func.value) or "<expr>"
            yield BaseEffect(
                "cluster-mutation", call.lineno, f"{recv}.{func.attr}()"
            )
    if name:
        if name.startswith(("np.random.", "numpy.random.")):
            attr = name.split(".", 2)[2].split(".", 1)[0]
            if attr not in _ALLOWED_NP_RANDOM:
                yield BaseEffect("global-rng", call.lineno, f"{name}()")
        elif name.startswith("random."):
            yield BaseEffect("global-rng", call.lineno, f"{name}()")
        elif name in ("time.time", "time.time_ns"):
            yield BaseEffect("wall-clock", call.lineno, f"{name}()")
        elif name in _IO_CALLS:
            yield BaseEffect("io", call.lineno, f"{name}()")
        else:
            draw = torch_global_rng(call)
            if draw is not None:
                yield BaseEffect("global-rng", call.lineno, draw)
    sync = host_sync(call)
    if sync is not None:
        yield BaseEffect("host-sync", call.lineno, sync)
    elif isinstance(func, ast.Attribute) and func.attr in _IO_METHOD_ATTRS:
        yield BaseEffect("io", call.lineno, f".{func.attr}()")


def _call_site(call: ast.Call) -> Optional[CallSite]:
    """Classify one call expression into a resolvable CallSite (or None)."""
    func = call.func
    pos = tuple(
        a.id if isinstance(a, ast.Name) else None
        for a in call.args if not isinstance(a, ast.Starred)
    )
    kws = tuple(
        (kw.arg, kw.value.id if isinstance(kw.value, ast.Name) else None)
        for kw in call.keywords if kw.arg is not None
    )
    if isinstance(func, ast.Name):
        return CallSite(call.lineno, "name", func.id, pos, kws)
    if isinstance(func, ast.Attribute):
        base = func.value
        if isinstance(base, ast.Name) and base.id in ("self", "cls"):
            return CallSite(call.lineno, "self", func.attr, pos, kws)
        if (isinstance(base, ast.Call) and isinstance(base.func, ast.Name)
                and base.func.id == "super"):
            return CallSite(call.lineno, "super", func.attr, pos, kws)
        dn = dotted_name(func)
        if dn is not None:
            return CallSite(call.lineno, "dotted", dn, pos, kws)
    return None


def _extract(path: str, tree: ast.Module) -> ModuleSummary:
    module = module_name_for(path)
    summary = ModuleSummary(
        path=path, module=module, functions={}, classes={},
        import_modules={}, import_names={},
    )
    pkg_parts = module.split(".")

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                summary.import_modules[
                    alias.asname or alias.name.split(".", 1)[0]
                ] = alias.name if alias.asname else alias.name.split(".", 1)[0]
                if alias.asname:
                    summary.import_modules[alias.asname] = alias.name
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                # relative import: resolve against this module's package
                base = pkg_parts[:-node.level] if node.level <= len(pkg_parts) else []
                mod = ".".join(base + ([mod] if mod else []))
            for alias in node.names:
                if alias.name == "*":
                    continue
                summary.import_names[alias.asname or alias.name] = (
                    mod, alias.name
                )

    def visit_function(fn, cls_name: Optional[str]) -> None:
        qual = ".".join(
            [module] + ([cls_name] if cls_name else []) + [fn.name]
        )
        params = param_names(fn)
        pset = set(params)
        calls: List[CallSite] = []
        effects: List[BaseEffect] = []
        param_mut: Dict[str, Tuple[int, str]] = {}
        # nested defs/lambdas are attributed to the enclosing function —
        # a closure's effects escape through the function that created it
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Call):
                effects.extend(_base_effects_of_call(sub))
                site = _call_site(sub)
                if site is not None:
                    calls.append(site)
                # object.__setattr__(param, ...) back-door
                if (dotted_name(sub.func) == "object.__setattr__"
                        and sub.args
                        and isinstance(sub.args[0], ast.Name)
                        and sub.args[0].id in pset
                        and sub.args[0].id not in ("self", "cls")):
                    param_mut.setdefault(
                        sub.args[0].id,
                        (sub.lineno, f"object.__setattr__({sub.args[0].id}, ...)"),
                    )
            elif isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (
                    sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                )
                for tgt in targets:
                    if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                        root = _root_name(tgt)
                        if root in pset and root not in ("self", "cls"):
                            param_mut.setdefault(
                                root, (tgt.lineno, f"store through {root}")
                            )
        summary.functions[qual] = FuncInfo(
            qualname=qual, module=module, cls=cls_name, name=fn.name,
            path=path, lineno=fn.lineno, params=params,
            calls=tuple(calls), effects=tuple(effects),
            param_mutations=param_mut,
        )

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            visit_function(node, None)
        elif isinstance(node, ast.ClassDef):
            bases = tuple(
                b for b in (dotted_name(base) for base in node.bases)
                if b is not None
            )
            summary.classes[node.name] = bases
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    visit_function(item, node.name)
    return summary


# -- project graph -------------------------------------------------------------

@dataclass(frozen=True)
class ResolvedCall:
    """A call edge resolved to a project function."""

    site: CallSite
    callee: str                   # qualname
    skip_first_param: bool        # True when callee's `self` is bound


class CallGraph:
    """Resolve the raw call sites of a set of summaries project-wide."""

    def __init__(self, summaries: Sequence[ModuleSummary]):
        self.summaries = list(summaries)
        self.by_module: Dict[str, ModuleSummary] = {}
        for s in self.summaries:
            self.by_module[s.module] = s
        self.functions: Dict[str, FuncInfo] = {}
        for s in self.summaries:
            self.functions.update(s.functions)

    # -- module lookup -------------------------------------------------------
    def _module(self, dotted: str) -> Optional[ModuleSummary]:
        s = self.by_module.get(dotted)
        if s is not None:
            return s
        # unique-suffix fallback: scanned roots may sit below sys.path roots
        tail = "." + dotted
        hits = [m for m in self.by_module if m == dotted or m.endswith(tail)]
        if len(hits) == 1:
            return self.by_module[hits[0]]
        return None

    def _function(self, module: str, attr: str,
                  _depth: int = 0) -> Optional[FuncInfo]:
        """``module.attr`` as a project function, following re-exports."""
        s = self._module(module)
        if s is None or _depth > 4:
            return None
        fi = s.functions.get(f"{s.module}.{attr}")
        if fi is not None:
            return fi
        reexp = s.import_names.get(attr)
        if reexp is not None:
            return self._function(reexp[0], reexp[1], _depth + 1)
        return None

    def _method(self, module: str, cls: str, meth: str,
                seen: Optional[Set[Tuple[str, str]]] = None,
                skip_own: bool = False) -> Optional[FuncInfo]:
        """Method lookup through the (project-visible) class hierarchy."""
        seen = seen or set()
        if (module, cls) in seen:
            return None
        seen.add((module, cls))
        s = self._module(module)
        if s is None:
            return None
        if not skip_own:
            fi = s.functions.get(f"{s.module}.{cls}.{meth}")
            if fi is not None:
                return fi
        for base in s.classes.get(cls, ()):
            base_mod, base_cls = self._resolve_class(s, base)
            if base_cls is None:
                continue
            fi = self._method(base_mod, base_cls, meth, seen)
            if fi is not None:
                return fi
        return None

    def _resolve_class(self, s: ModuleSummary, raw: str
                       ) -> Tuple[str, Optional[str]]:
        """A raw base-class name -> (module, class) in the project."""
        if "." in raw:
            alias, cls = raw.rsplit(".", 1)
            mod = s.import_modules.get(alias)
            return (mod or alias), cls
        if raw in s.classes:
            return s.module, raw
        imp = s.import_names.get(raw)
        if imp is not None:
            return imp[0], imp[1]
        return s.module, None

    # -- call resolution -----------------------------------------------------
    def resolve(self, caller: FuncInfo, site: CallSite
                ) -> Optional[ResolvedCall]:
        s = self.by_module.get(caller.module)
        if s is None:
            return None
        if site.target_kind == "name":
            fi = s.functions.get(f"{s.module}.{site.target}")
            if fi is None:
                imp = s.import_names.get(site.target)
                if imp is not None:
                    fi = self._function(imp[0], imp[1])
            if fi is not None:
                return ResolvedCall(site, fi.qualname, skip_first_param=False)
        elif site.target_kind == "self" and caller.cls is not None:
            fi = self._method(caller.module, caller.cls, site.target)
            if fi is not None:
                return ResolvedCall(site, fi.qualname, skip_first_param=True)
        elif site.target_kind == "super" and caller.cls is not None:
            fi = self._method(
                caller.module, caller.cls, site.target, skip_own=True
            )
            if fi is not None:
                return ResolvedCall(site, fi.qualname, skip_first_param=True)
        elif site.target_kind == "dotted":
            head, attr = site.target.rsplit(".", 1)
            if "." not in head:
                mod = s.import_modules.get(head)
                if mod is not None:
                    fi = self._function(mod, attr)
                    if fi is not None:
                        return ResolvedCall(site, fi.qualname, False)
                if head in s.classes:       # ClassName.method(...)
                    fi = self._method(s.module, head, attr)
                    if fi is not None:
                        return ResolvedCall(site, fi.qualname, False)
            else:
                alias = head.split(".", 1)[0]
                mod = s.import_modules.get(alias)
                if mod is not None:
                    full = mod + head[len(alias):]
                    fi = self._function(full, attr)
                    if fi is not None:
                        return ResolvedCall(site, fi.qualname, False)
        return None

    def edges(self, caller: FuncInfo) -> Iterator[ResolvedCall]:
        for site in caller.calls:
            rc = self.resolve(caller, site)
            if rc is not None and rc.callee != caller.qualname:
                yield rc
