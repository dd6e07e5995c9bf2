"""Build the port's placement dataclasses from plain numpy fields.

The JAX package's :class:`FleetSnapshot` and :class:`BatchedPolicyContext`
have the same fields, in the same order, as the port's
(:data:`~repro_torch.core.batched.FLEET_SNAPSHOT_SCHEMA` holds the 17
snapshot leaves), so a context built by either package can be handed to the
other's ``decide_batch`` as a dict of numpy arrays keyed by field name.
This is how one wave's context is fed to both packages' policies.
"""
from __future__ import annotations

from dataclasses import fields
from typing import Any, Mapping

import numpy as np

from .batched import FLEET_SNAPSHOT_SCHEMA, BatchedPolicyContext, FleetSnapshot

__all__ = ["snapshot_from_numpy", "batch_from_numpy"]

_BATCH_FIELDS = tuple(f.name for f in fields(BatchedPolicyContext))


def _check_keys(kind: str, got, want) -> None:
    if set(got) != set(want):
        raise ValueError(
            f"{kind} fields differ: missing {sorted(set(want) - set(got))}, "
            f"unknown {sorted(set(got) - set(want))}"
        )


def snapshot_from_numpy(leaves: Mapping[str, Any]) -> FleetSnapshot:
    """The port's :class:`FleetSnapshot` from its 17 leaves keyed by name:
    ``t`` a number, every other leaf an array (kept on the host)."""
    _check_keys("FleetSnapshot", leaves, FLEET_SNAPSHOT_SCHEMA)
    vals = {n: np.asarray(leaves[n]) for n in FLEET_SNAPSHOT_SCHEMA if n != "t"}
    return FleetSnapshot(t=float(leaves["t"]), **vals).validate()


def batch_from_numpy(fields_: Mapping[str, Any]) -> BatchedPolicyContext:
    """The port's :class:`BatchedPolicyContext` from its fields keyed by
    name: ``tasks`` a sequence of task names, ``fleet`` the snapshot's
    leaves keyed by name (see :func:`snapshot_from_numpy`), every other
    field an array."""
    _check_keys("BatchedPolicyContext", fields_, _BATCH_FIELDS)
    vals = {
        n: np.asarray(fields_[n]) for n in _BATCH_FIELDS
        if n not in ("tasks", "fleet")
    }
    return BatchedPolicyContext(
        tasks=tuple(str(t) for t in fields_["tasks"]),
        fleet=snapshot_from_numpy(fields_["fleet"]),
        **vals,
    )
