"""The planner (ROADMAP A17): calibrated device profiles, the cost model,
plan selection and its audit, and the warm-start plan cache.

  * :mod:`profile` — versioned, cited constants; the packaged ``h100``
    profile fitted on the card; :func:`profile.calibrate` on a device;
  * :mod:`cost_model` — the analytic per-strategy cost from a profile;
  * :mod:`plan` — :func:`plan.plan_join` and the ``--plan explain`` table;
  * :mod:`audit` — the plan-vs-actual table and PLANDRIFT;
  * :mod:`calibrate` — robust fits of the constants from run-ledger rows
    (observability/ledger.py) and the staleness of a profile;
  * :mod:`cache` — the engine's converged capacities (and plans) on disk.

The JAX package's jaxpr gate (``static_memory_gate``) is not applicable
(ROADMAP A18e) and ``critpath_for_explain`` waits for A18d.
"""

from tpu_radix_join_torch.planner.audit import (actuals_for_explain,
                                                audit_plan, phase_snapshot)
from tpu_radix_join_torch.planner.cache import ManifestMismatch, PlanCache
from tpu_radix_join_torch.planner.calibrate import (UnderSampledError,
                                                    detect_stale,
                                                    diff_profiles,
                                                    fit_profile)
from tpu_radix_join_torch.planner.cost_model import (
    ServingContext, StrategyCost, Workload, enumerate_serving_strategies)
from tpu_radix_join_torch.planner.plan import (JoinPlan, PlanError,
                                               PlanInfeasibleError,
                                               explain_table, plan_join)
from tpu_radix_join_torch.planner.profile import (DeviceProfile,
                                                  ProfileError, calibrate,
                                                  format_provenance,
                                                  load_profile,
                                                  resolve_profile)

__all__ = [
    "DeviceProfile", "JoinPlan", "ManifestMismatch", "PlanCache",
    "PlanError", "PlanInfeasibleError", "ProfileError", "ServingContext",
    "StrategyCost", "UnderSampledError", "Workload", "actuals_for_explain",
    "audit_plan", "calibrate", "detect_stale", "diff_profiles",
    "enumerate_serving_strategies", "explain_table", "fit_profile",
    "format_provenance", "load_profile", "phase_snapshot", "plan_join",
    "resolve_profile",
]
