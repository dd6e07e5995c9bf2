"""jit-hygiene: no host syncs or tensor-valued branching inside the port's
decision kernels.

The invariant: the decision kernels in ``core/batched.py`` are eager
float64 torch ops, one IEEE operation per numpy operation of the scalar
rule, bit-identical to their numpy twins on any device.  A ``.item()`` /
``.cpu()`` / ``float()`` / ``np.asarray`` inside one waits for the card
and brings a value to the host on every call, and a Python ``if``/``while``
on a tensor decides on the host what the scalar rule decides per row — the
kernel then diverges from its twin on exactly the inputs the parity suite
doesn't cover, and a CUDA graph could no longer capture it.

Detection (the counterpart of the JAX rule's ``jax.jit`` detection): a
function is a kernel when the module's ``DECISION_KERNELS`` tuple names it,
or when its body bumps a ``.launches`` counter.  A parameter annotated
``torch.Tensor`` is traced; the others (``k``, ``alpha``, ``n_tiers``…) are
static, as ``static_argnums`` are, and may be branched on.  Values assigned
from traced parameters are traced too (one forward taint pass), as are the
parameters of closures defined inside a kernel.  Flags, inside a kernel:
``float()``/``int()``/``bool()`` of a traced value, any host-sync effect
(:func:`..callgraph.host_sync`), an ``np.*`` call on a traced value, and a
Python ``if``/``while`` on a traced value.
"""
from __future__ import annotations

import ast
from typing import Iterator, Set

from ..astutil import call_name, dotted_name, names_in, param_names, walk_functions
from ..callgraph import host_sync
from ..framework import FileContext, Finding, ProjectContext, Rule, register_rule

_KERNEL_TABLE = "DECISION_KERNELS"
_TENSOR_TYPES = {"torch.Tensor", "Tensor"}
_HOST_CASTS = {"float", "int", "bool", "complex"}
_NP_PREFIXES = ("np.", "numpy.")


def _table_names(tree: ast.Module) -> Set[str]:
    """The function names a module-level ``DECISION_KERNELS = (...)`` lists."""
    names: Set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if any(isinstance(t, ast.Name) and t.id == _KERNEL_TABLE for t in targets) \
                    and node.value is not None:
                names |= {n.id for n in ast.walk(node.value) if isinstance(n, ast.Name)}
    return names


def _bumps_launches(fn: ast.FunctionDef) -> bool:
    return any(isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Attribute)
               and node.target.attr == "launches" for node in ast.walk(fn))


def _traced_params(fn: ast.FunctionDef) -> Set[str]:
    a = fn.args
    return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
            if p.annotation is not None and dotted_name(p.annotation) in _TENSOR_TYPES}


@register_rule
class JitHygieneRule(Rule):
    name = "jit-hygiene"
    severity = "error"
    description = (
        "no .item()/.cpu()/float()/np.asarray host syncs and no Python "
        "branching on tensors inside the float64 decision kernels "
        "(bit-identical to their numpy twins)"
    )
    # the decision kernels live in core/batched.py; widen via config when
    # new kernel modules appear
    default_paths = ("src/repro_torch/core",)

    def check_file(self, ctx: FileContext, project: ProjectContext
                   ) -> Iterator[Finding]:
        table = _table_names(ctx.tree)
        for fn in walk_functions(ctx.tree):
            if fn.name in table or _bumps_launches(fn):
                yield from self._check_body(ctx, fn)

    def _check_body(self, ctx: FileContext, fn: ast.FunctionDef) -> Iterator[Finding]:
        tainted: Set[str] = _traced_params(fn)
        # one forward taint pass: names assigned from traced values are traced
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                if names_in(node.value) & tainted:
                    for tgt in node.targets:
                        for leaf in ast.walk(tgt):
                            if isinstance(leaf, ast.Name):
                                tainted.add(leaf.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                # closures run on the kernel's tensors: their params are traced
                tainted |= set(param_names(node)) - {"self"}
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = call_name(node)
                sync = host_sync(node)
                if sync is not None:
                    yield self.finding(
                        ctx, node,
                        f"`{sync}` inside decision kernel `{fn.name}` waits for "
                        "the device and brings a value to the host on every "
                        "call; keep the value on the device (torch.where)",
                    )
                elif name in _HOST_CASTS and node.args and not all(
                    isinstance(a, ast.Constant) for a in node.args
                ):
                    if names_in(node.args[0]) & tainted:
                        yield self.finding(
                            ctx, node,
                            f"`{name}()` on a tensor inside decision kernel "
                            f"`{fn.name}` is a host sync; use tensor casts "
                            "(`.to(dtype)`) instead",
                        )
                elif name and name.startswith(_NP_PREFIXES):
                    if any(names_in(a) & tainted for a in node.args):
                        yield self.finding(
                            ctx, node,
                            f"numpy call `{name}()` on a tensor inside "
                            f"decision kernel `{fn.name}` leaves the device; "
                            "use the torch equivalent",
                        )
            elif isinstance(node, (ast.If, ast.While)):
                hot = names_in(node.test) & tainted
                if hot:
                    kind = "if" if isinstance(node, ast.If) else "while"
                    yield self.finding(
                        ctx, node,
                        f"Python `{kind}` on tensor value(s) {sorted(hot)} "
                        f"inside decision kernel `{fn.name}` decides on the "
                        "host what the scalar rule decides per row — use "
                        "torch.where (or pass the argument as a plain Python "
                        "value, not a tensor)",
                    )
