"""kernel-hygiene: audit what the port's registered kernels run.

AST lint cannot see what a call dispatches to — a float32 constant baked
into a bit-identical float64 kernel, an ``.item()`` deep in a helper, a wave
size that reaches a kernel unpadded, or a KV cache rebuilt instead of
written in place are all invisible until a run is slow or a parity test
fails.  This rule runs the kernels under a dispatch recorder over a size
sweep (see :mod:`..kernel_audit`) and turns every contract breach into a
finding.

Audit targets:
  * the built-in table (:func:`..kernel_audit.builtin_targets`) covering
    ``core/batched.py``'s float64 decision kernels, ``kernels/ops.py``'s
    entry points (on the meta device here) and the serving engine's
    in-place decode and prefill — each audited only when its defining file
    is in the scanned set;
  * any scanned module exporting a top-level ``TORCH_AUDIT_TARGETS`` list of
    :class:`~repro_torch.analysis.kernel_audit.KernelSpec` (how test
    fixtures describe themselves) — the module is imported by path at
    finalize time.  The name differs from the JAX linter's
    ``AUDIT_TARGETS``, which that linter imports and would take for its own.
"""
from __future__ import annotations

import ast
import hashlib
import importlib.util
import os
from typing import Iterator, List

from ..framework import FileContext, Finding, ProjectContext, Rule, register_rule
from ..kernel_audit import KernelSpec, audit_spec, builtin_targets

_TARGETS_NAME = "TORCH_AUDIT_TARGETS"


@register_rule
class KernelHygieneRule(Rule):
    name = "kernel-hygiene"
    severity = "error"
    description = (
        "dispatch-level audit of the port's kernels: float64 end to end in "
        "the decision kernels, no host round trips, bounded shapes across "
        "the fleet-size sweep, caches written in place"
    )
    default_paths = ("",)

    def check_file(self, ctx: FileContext, project: ProjectContext
                   ) -> Iterator[Finding]:
        for node in ctx.tree.body:
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target] if isinstance(node, ast.AnnAssign)
                else []
            )
            for tgt in targets:
                if isinstance(tgt, ast.Name) and tgt.id == _TARGETS_NAME:
                    project.store.setdefault("targets", []).append(
                        (ctx.path, node.lineno)
                    )
        return iter(())

    def finalize(self, project: ProjectContext) -> Iterator[Finding]:
        scanned = {fctx.path: fctx for fctx in project.files}
        for path, specs in builtin_targets().items():
            fctx = scanned.get(path)
            if fctx is None:
                continue
            for spec in specs:
                line = _anchor_line(fctx, spec.anchor)
                for msg in audit_spec(spec):
                    yield self.finding(path, line, msg)
        for path, lineno in project.store.get("targets", []):
            try:
                specs = _load_targets(project.root, path)
            except Exception as e:
                yield self.finding(
                    path, lineno,
                    f"could not import {_TARGETS_NAME} module: "
                    f"{type(e).__name__}: {e}",
                )
                continue
            for spec in specs:
                fctx = scanned.get(path)
                line = (
                    _anchor_line(fctx, spec.anchor)
                    if fctx is not None and spec.anchor else lineno
                )
                for msg in audit_spec(spec):
                    yield self.finding(path, line, msg)


def _anchor_line(fctx: FileContext, anchor) -> int:
    if anchor:
        for i, text in enumerate(fctx.lines, start=1):
            if anchor in text:
                return i
    return 1


def _load_targets(root: str, path: str) -> List[KernelSpec]:
    abspath = os.path.join(root, path) if root else path
    modname = "_repro_torch_lint_audit_" + hashlib.sha1(
        abspath.encode()
    ).hexdigest()[:12]
    spec = importlib.util.spec_from_file_location(modname, abspath)
    if spec is None or spec.loader is None:
        raise ImportError(f"no import spec for {abspath}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    targets = getattr(module, _TARGETS_NAME, [])
    if not isinstance(targets, (list, tuple)):
        raise TypeError(f"{_TARGETS_NAME} must be a list of KernelSpec")
    return [t for t in targets if isinstance(t, KernelSpec)]
