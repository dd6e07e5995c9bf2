"""rng-discipline: every random draw must come from an explicitly seeded
generator, and simulated code must not read the wall clock.

The invariant (the common-random-numbers contract): all stochastic
generators derive one ``np.random.Generator`` per logical stream from an
explicit ``seed``/``SeedSequence`` key — ``(seed, device_id)`` for churn
lifetimes, ``(seed, stream_index)`` for arrivals — so adding a device or a
stream never reshuffles any other stream's draws, and two runs with equal
seeds are bit-identical.  Global-state draws (``np.random.rand`` & co.,
and torch's ``torch.randn`` & co. without ``generator=``, or
``torch.manual_seed``), the stdlib ``random`` module, unseeded
``default_rng()``, and bare ``time.time()`` inside ``src/repro_torch`` all
break that contract silently:
the run still *looks* deterministic until a fleet-size change or a wall
clock poisons a DRL rollout.

An interprocedural ``finalize`` pass: a policy entry point
(``decide``/``decide_batch``) that reaches a global-state draw or a bare
``time.time()`` *through helpers* is flagged with the full call chain —
``decide_batch -> util -> np.random.shuffle()``.  The per-file checks
above remain the fallback for direct violations.
"""
from __future__ import annotations

import ast
from typing import Iterator, Set

from ..astutil import call_name
from ..callgraph import summarize_module, torch_global_rng
from ..effects import engine_for
from ..framework import FileContext, Finding, ProjectContext, Rule, register_rule

_POLICY_METHODS = ("decide", "decide_batch")

# np.random attributes that are construction/typing, not global-state draws
_ALLOWED_NP_RANDOM = {
    "default_rng",
    "Generator",
    "SeedSequence",
    "BitGenerator",
    "PCG64",
    "PCG64DXSM",
    "Philox",
    "SFC64",
    "MT19937",
}

_NP_RANDOM_PREFIXES = ("np.random.", "numpy.random.")


@register_rule
class RngDisciplineRule(Rule):
    name = "rng-discipline"
    severity = "error"
    description = (
        "random draws must come from generators keyed by explicit "
        "seed/SeedSequence arguments or seeded torch.Generators; no global "
        "np.random or torch state, no stdlib `random`, no bare time.time() "
        "in src/repro_torch"
    )
    default_paths = ("",)          # the draw checks apply everywhere scanned
    # the wall-clock check is scoped separately: benchmarks/ legitimately
    # wall-clock their own harness, the simulator must not
    TIME_PATHS_OPTION = "time_call_paths"
    DEFAULT_TIME_PATHS = ("src/repro_torch",)

    def check_file(self, ctx: FileContext, project: ProjectContext
                   ) -> Iterator[Finding]:
        time_paths = tuple(
            self.options.get(self.TIME_PATHS_OPTION, self.DEFAULT_TIME_PATHS)
        )
        check_time = any(ctx.path.startswith(p) for p in time_paths)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "random" or alias.name.startswith("random."):
                        yield self.finding(
                            ctx, node,
                            "stdlib `random` uses hidden global state; key a "
                            "`np.random.default_rng(seed)` stream instead "
                            "(the common-random-numbers contract)",
                        )
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if mod == "random":
                    yield self.finding(
                        ctx, node,
                        "stdlib `random` uses hidden global state; key a "
                        "`np.random.default_rng(seed)` stream instead "
                        "(the common-random-numbers contract)",
                    )
                elif mod in ("numpy.random", "np.random"):
                    for alias in node.names:
                        if alias.name not in _ALLOWED_NP_RANDOM:
                            yield self.finding(
                                ctx, node,
                                f"`from numpy.random import {alias.name}` pulls "
                                "a global-state draw function; use an explicit "
                                "Generator (`default_rng(seed)`)",
                            )
            elif isinstance(node, ast.Call):
                name = call_name(node)
                if name is None:
                    continue
                if name.startswith(_NP_RANDOM_PREFIXES):
                    attr = name.split(".", 2)[2]
                    head = attr.split(".", 1)[0]
                    if head not in _ALLOWED_NP_RANDOM:
                        yield self.finding(
                            ctx, node,
                            f"global np.random draw `{name}()` — draws must "
                            "come from a per-stream `default_rng(seed)` "
                            "Generator so streams never reshuffle each other",
                        )
                    elif head == "default_rng" and self._unseeded(node):
                        yield self.finding(
                            ctx, node,
                            "`default_rng()` without an explicit seed is "
                            "OS-entropy nondeterminism; derive the generator "
                            "from a seed/SeedSequence argument",
                        )
                elif name.endswith("default_rng") and self._unseeded(node):
                    # e.g. `from numpy.random import default_rng; default_rng()`
                    yield self.finding(
                        ctx, node,
                        "`default_rng()` without an explicit seed is "
                        "OS-entropy nondeterminism; derive the generator from "
                        "a seed/SeedSequence argument",
                    )
                elif torch_global_rng(node) is not None:
                    yield self.finding(
                        ctx, node,
                        f"global torch draw `{torch_global_rng(node)}` — "
                        "torch's default generator is one hidden stream for "
                        "the whole process; pass a `torch.Generator` seeded "
                        "from the stream's key as `generator=`",
                    )
                elif check_time and name in ("time.time", "time.time_ns"):
                    yield self.finding(
                        ctx, node,
                        f"bare `{name}()` in simulated code — the sim owns "
                        "virtual time; inject a clock parameter (wall-clock "
                        "interval measurement should use time.perf_counter/"
                        "time.monotonic)",
                    )

    def finalize(self, project: ProjectContext) -> Iterator[Finding]:
        """Transitive pass: policy entry points reaching global-RNG draws
        or wall-clock reads through helper chains."""
        time_paths = tuple(
            self.options.get(self.TIME_PATHS_OPTION, self.DEFAULT_TIME_PATHS)
        )
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
            check_time = any(entry.path.startswith(p) for p in time_paths)
            for eff in engine.effects_of(entry.qualname):
                if not eff.transitive:
                    continue   # direct draws belong to check_file
                if eff.kind == "global-rng":
                    why = (
                        "draws from hidden global RNG state — draws must come "
                        "from a per-stream `default_rng(seed)` Generator"
                    )
                elif eff.kind == "wall-clock" and check_time:
                    why = (
                        "reads the wall clock inside simulated code — the sim "
                        "owns virtual time; inject a clock parameter"
                    )
                else:
                    continue
                msg = (
                    f"`{entry.name}` reaches `{eff.origin}` through the call "
                    f"chain `{eff.render_chain()}` — {why}"
                )
                key = (entry.path, eff.site_line, msg)
                if key in emitted:
                    continue
                emitted.add(key)
                yield self.finding(entry.path, eff.site_line, msg)

    @staticmethod
    def _unseeded(call: ast.Call) -> bool:
        if call.keywords:
            return False
        if not call.args:
            return True
        return (
            len(call.args) == 1
            and isinstance(call.args[0], ast.Constant)
            and call.args[0].value is None
        )
