"""Text, JSON and SARIF reporters for lint reports.

SARIF 2.1.0 is the format GitHub's code-scanning upload understands, so
the CI lint job can render findings as PR annotations instead of a text
artifact nobody opens.
"""
from __future__ import annotations

import json
from typing import Dict, List

from .framework import LintReport

__all__ = ["render_text", "render_json", "render_sarif", "report_dict"]


def render_text(report: LintReport) -> str:
    lines = [f.format() for f in report.findings]
    lines.append(
        f"{len(report.findings)} finding(s) "
        f"({report.errors} error(s), {report.warnings} warning(s)), "
        f"{report.suppressed} suppressed, "
        f"{report.files_scanned} file(s) scanned "
        f"in {report.elapsed_s:.2f}s"
    )
    return "\n".join(lines)


def report_dict(report: LintReport) -> Dict[str, object]:
    return {
        "version": 1,
        "files_scanned": report.files_scanned,
        "rules_run": list(report.rules_run),
        "errors": report.errors,
        "warnings": report.warnings,
        "suppressed": report.suppressed,
        "elapsed_s": round(report.elapsed_s, 3),
        "findings": [f.to_dict() for f in report.findings],
    }


def render_json(report: LintReport) -> str:
    return json.dumps(report_dict(report), indent=2, sort_keys=True) + "\n"


def sarif_dict(report: LintReport) -> Dict[str, object]:
    """SARIF 2.1.0 log: one run, one driver, rule metadata for every rule
    that ran or produced a finding (parse-error/useless-suppression are
    synthesized by the framework, not registered)."""
    from .framework import available_rules, rule_class

    registered = set(available_rules())
    rule_ids: List[str] = list(report.rules_run)
    for f in report.findings:
        if f.rule not in rule_ids:
            rule_ids.append(f.rule)
    rules = []
    for rid in rule_ids:
        if rid in registered:
            cls = rule_class(rid)
            desc, level = cls.description, cls.severity
        elif rid == "parse-error":
            desc, level = "file failed to parse", "error"
        else:
            desc, level = "framework-synthesized finding", "warning"
        rules.append({
            "id": rid,
            "shortDescription": {"text": desc or rid},
            "defaultConfiguration": {"level": level},
        })
    results = [
        {
            "ruleId": f.rule,
            "ruleIndex": rule_ids.index(f.rule),
            "level": f.severity,
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path,
                        "uriBaseId": "%SRCROOT%",
                    },
                    "region": {
                        "startLine": max(f.line, 1),
                        "startColumn": f.col + 1,
                    },
                },
            }],
        }
        for f in report.findings
    ]
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": "repro-torch-analysis",
                    "informationUri":
                        "https://github.com/invalid/repro#static-analysis",
                    "rules": rules,
                },
            },
            "results": results,
            "columnKind": "utf16CodeUnits",
        }],
    }


def render_sarif(report: LintReport) -> str:
    return json.dumps(sarif_dict(report), indent=2, sort_keys=True) + "\n"
