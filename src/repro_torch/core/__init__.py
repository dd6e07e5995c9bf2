"""IBDASH core: DAG staging, interference model, availability prediction,
cluster state, and the pure policy/orchestration API, ported from the JAX
package's ``core`` with the same module paths.

Algorithm 1 and the baselines are pure ``decide(ctx) -> TaskDecision``
policies in :mod:`repro_torch.core.policy`; their batched ``decide_batch``
paths run the float64 torch decision kernels of
:mod:`repro_torch.core.batched` on the policy's device (the card unless the
caller names the CPU).  :func:`repro_torch.core.orchestrator.orchestrate`
builds the array-native contexts on the host and assembles a :class:`Plan`;
:meth:`repro_torch.core.cluster.ClusterState.apply` is the single mutation
path (with undo tokens).
"""
from .availability import (
    LAMBDA_CED,
    LAMBDA_MIX,
    LAMBDA_PED,
    availability,
    fit_failure_rate,
    gang_failure_rate,
    prob_fail_during,
    sample_lifetime,
    young_daly_interval,
)
from .cluster import (
    TIER_CLOUD,
    TIER_DEVICE,
    TIER_EDGE_SERVER,
    TIER_NAMES,
    ApplyToken,
    ClusterState,
    Device,
)
from .dag import AppDAG, TaskSpec, app_stage, topological_order, validate_dag
from .interference import InterferenceModel, fit_linear_interference
from .orchestrator import (
    IBDASHConfig,
    Placement,
    Plan,
    Replica,
    TaskPlacement,
    orchestrate,
    orchestrate_batch,
)
from .recovery import (
    FailFastRecovery,
    FailoverRecovery,
    RecoveryStrategy,
    ReplanRecovery,
    available_recoveries,
    make_recovery,
    register_recovery,
)
from .policy import (
    IBDASHPolicy,
    LAVEAPolicy,
    LaTSModel,
    LaTSPolicy,
    PetrelPolicy,
    Policy,
    PolicyContext,
    RandomPolicy,
    RoundRobinPolicy,
    TaskDecision,
    TierEscalationPolicy,
    available_policies,
    make_policy,
    register_policy,
)

__all__ = [
    "AppDAG",
    "TaskSpec",
    "app_stage",
    "topological_order",
    "validate_dag",
    "InterferenceModel",
    "fit_linear_interference",
    "ApplyToken",
    "ClusterState",
    "Device",
    "TIER_DEVICE",
    "TIER_EDGE_SERVER",
    "TIER_CLOUD",
    "TIER_NAMES",
    "IBDASHConfig",
    "Placement",
    "Plan",
    "Replica",
    "TaskPlacement",
    "orchestrate",
    "orchestrate_batch",
    "Policy",
    "PolicyContext",
    "TaskDecision",
    "register_policy",
    "make_policy",
    "available_policies",
    "RecoveryStrategy",
    "FailFastRecovery",
    "FailoverRecovery",
    "ReplanRecovery",
    "register_recovery",
    "make_recovery",
    "available_recoveries",
    "IBDASHPolicy",
    "RandomPolicy",
    "RoundRobinPolicy",
    "LAVEAPolicy",
    "PetrelPolicy",
    "LaTSPolicy",
    "TierEscalationPolicy",
    "LaTSModel",
    "availability",
    "prob_fail_during",
    "sample_lifetime",
    "fit_failure_rate",
    "young_daly_interval",
    "gang_failure_rate",
    "LAMBDA_MIX",
    "LAMBDA_CED",
    "LAMBDA_PED",
]
