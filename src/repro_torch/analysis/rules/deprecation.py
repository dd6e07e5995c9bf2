"""deprecation: no new code on the scalar-bandwidth shims.

The invariant: transfers are priced on the *link* —
``bw_eff[s, d] = min(up[s], down[d], backhaul[tier[s], tier[d]])`` — not
on a per-device scalar.  The scalar surface survives only as
compatibility shims, and every remaining use is a site where a
heterogeneous fleet silently mis-prices a transfer:

  * ``Device(bandwidth=B)`` — the symmetric shim; pass ``up_bw=``/
    ``down_bw=`` (and ``tier=``) instead;
  * ``cluster.bandwidths()`` / ``snapshot.bandwidths`` — the receiver-only
    ``(D,)`` vector; use ``link_bw()`` / ``up_bandwidths()`` /
    ``down_bandwidths()``;
  * ``transfer_latency(...)`` / ``upload_latency(...)`` — the removed
    Scheduler helpers whose scalar-bandwidth arithmetic predates the
    link matrix entirely.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..astutil import dotted_name
from ..framework import FileContext, Finding, ProjectContext, Rule, register_rule

_LEGACY_CALLS = {
    "transfer_latency":
        "the scalar-bandwidth `transfer_latency` shim predates the link "
        "model; price transfers with `cluster.link_row(src)[dst]`",
    "upload_latency":
        "the scalar-bandwidth `upload_latency` shim predates the link "
        "model; price uploads with `cluster.upload_bw()[dst]`",
    "bandwidths":
        "`bandwidths()` is the deprecated receiver-only (D,) vector; use "
        "`link_row()` / `up_bandwidths()` / `down_bandwidths()`",
}


@register_rule
class DeprecationRule(Rule):
    name = "deprecation"
    severity = "error"
    description = (
        "no Device(bandwidth=), cluster.bandwidths(), or scalar-bandwidth "
        "transfer_latency/upload_latency — use the tier/link-matrix API"
    )
    default_paths = ("",)

    def check_file(self, ctx: FileContext, project: ProjectContext
                   ) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func) or ""
            tail = name.rsplit(".", 1)[-1]
            if tail == "Device":
                for kw in node.keywords:
                    if kw.arg == "bandwidth":
                        yield self.finding(
                            ctx, kw.value,
                            "Device(bandwidth=) is the deprecated symmetric "
                            "scalar shim; pass up_bw=/down_bw= (and tier=) — "
                            "the link matrix prices the slow direction",
                        )
            elif isinstance(node.func, ast.Attribute) and tail in _LEGACY_CALLS:
                yield self.finding(ctx, node, _LEGACY_CALLS[tail])
