"""Fault-tolerance runtime: failure detection, elastic re-meshing, straggler
mitigation via IBDASH-style replication, and availability-driven policies.
"""
from .runtime import FleetMonitor, ElasticPlan, plan_remesh, PodState
from .straggler import StragglerMitigator, BackupDecision

__all__ = [
    "FleetMonitor",
    "PodState",
    "ElasticPlan",
    "plan_remesh",
    "StragglerMitigator",
    "BackupDecision",
]
