"""CLI: ``python -m repro_torch.analysis [paths ...]``.

Exits 1 when any error-severity finding survives suppressions — warnings
never fail the run.  ``--json FILE`` writes the machine-readable report
(the CI artifact) alongside the text output.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .callgraph import (
    load_summary_cache,
    save_summary_cache,
    summary_cache_stats,
)
from .framework import Analyzer, LintConfig, available_rules, rule_class
from .reporters import render_json, render_sarif, render_text

DEFAULT_PATHS = ("src", "tests", "benchmarks", "examples")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Statically enforce the port's orchestration contracts "
        "(rng streams, policy purity, snapshot schema, decision-kernel "
        "hygiene, deprecations, registry and span parity, units, the kernel "
        "audit).",
    )
    ap.add_argument(
        "paths", nargs="*",
        help=f"files/directories to scan (default: {' '.join(DEFAULT_PATHS)})",
    )
    ap.add_argument(
        "--select", metavar="RULES",
        help="comma-separated subset of rules to run",
    )
    ap.add_argument(
        "--json", metavar="FILE", dest="json_out",
        help="also write the JSON report to FILE (the CI artifact)",
    )
    ap.add_argument(
        "--sarif", metavar="FILE", dest="sarif_out",
        help="also write a SARIF 2.1.0 report to FILE (for GitHub "
        "code-scanning upload / PR annotations)",
    )
    ap.add_argument(
        "--cache", metavar="FILE", dest="cache_file",
        help="warm the call-graph summary memo from FILE before the run "
        "and persist it after (JSON, keyed by file content hash)",
    )
    ap.add_argument(
        "--format", choices=("text", "json", "sarif"), default="text",
        help="stdout format (default: text)",
    )
    ap.add_argument(
        "--all-paths", action="store_true",
        help="ignore per-rule path scoping and default excludes "
        "(used by the fixture tests)",
    )
    ap.add_argument(
        "--list-rules", action="store_true",
        help="list registered rules and exit",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for name in available_rules():
            cls = rule_class(name)
            scope = ", ".join(p or "<everywhere>" for p in cls.default_paths)
            print(f"{name:18s} [{cls.severity:7s}] ({scope}) {cls.description}")
        return 0

    select = None
    if args.select:
        select = tuple(r.strip() for r in args.select.split(",") if r.strip())
    config = LintConfig(select=select)
    if args.all_paths:
        config = config.permissive()
    paths = args.paths or [p for p in DEFAULT_PATHS if os.path.isdir(p)]
    if not paths:
        print("no paths to scan", file=sys.stderr)
        return 2
    if args.cache_file and os.path.exists(args.cache_file):
        n = load_summary_cache(args.cache_file)
        print(f"summary cache: loaded {n} entr(y/ies) from "
              f"{args.cache_file}", file=sys.stderr)

    report = Analyzer(config).run(paths)

    if args.format == "json":
        sys.stdout.write(render_json(report))
    elif args.format == "sarif":
        sys.stdout.write(render_sarif(report))
    else:
        print(render_text(report))
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            f.write(render_json(report))
    if args.sarif_out:
        with open(args.sarif_out, "w", encoding="utf-8") as f:
            f.write(render_sarif(report))
    if args.cache_file:
        n = save_summary_cache(args.cache_file)
        hits, misses = summary_cache_stats()
        print(f"summary cache: saved {n} entr(y/ies) to {args.cache_file} "
              f"({hits} hit(s), {misses} miss(es) this run)",
              file=sys.stderr)
    return report.exit_code


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:     # `... | head` closed the pipe mid-report
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(1)
