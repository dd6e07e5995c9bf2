"""repro_torch.analysis — the orchestration-contract linter of the port.

Statically enforces the port's load-bearing invariants, against the port's
own sources of truth (its policy registry, ``SPAN_SCHEMA`` and
``FLEET_SNAPSHOT_SCHEMA``), with the rule names of the JAX package's
linter, so one suppression comment serves both:

  * ``rng-discipline``   — per-(seed, id) common-random-number streams; no
                           global numpy, stdlib or torch draws
  * ``policy-purity``    — pure ``decide``/``decide_batch``, mutate only
                           via ``cluster.apply``
  * ``snapshot-schema``  — the declared FleetSnapshot leaf schema
  * ``jit-hygiene``      — no host syncs / tensor-valued branching in the
                           float64 decision kernels
  * ``deprecation``      — no scalar-bandwidth shims; tier/link-matrix API
  * ``registry-parity``  — every registered scheme has a test-suite pin
  * ``span-parity``      — every emitted span kind is in the schema and
                           pinned by a test
  * ``unit-consistency`` — no seconds+bytes on the pricing paths
  * ``kernel-hygiene``   — the dispatch-level audit of the port's kernels
                           (:mod:`.kernel_audit`)

Run ``python -m repro_torch.analysis src tests benchmarks examples``;
suppress a deliberate finding with ``# repro-lint: disable=<rule>`` on its
line (plus a justification comment) or ``# repro-lint: disable-file=<rule>``.
Imports nothing of JAX and nothing of the JAX package.
"""
from .framework import (
    Analyzer,
    FileContext,
    Finding,
    LintConfig,
    LintReport,
    ProjectContext,
    Rule,
    RuleSettings,
    available_rules,
    register_rule,
    rule_class,
)
from .reporters import render_json, render_text, report_dict

__all__ = [
    "Analyzer",
    "FileContext",
    "Finding",
    "LintConfig",
    "LintReport",
    "ProjectContext",
    "Rule",
    "RuleSettings",
    "available_rules",
    "register_rule",
    "rule_class",
    "render_json",
    "render_text",
    "report_dict",
]
