"""The plan cache a resident session warms from, with the device profile
and plan it is keyed under (the part of ROADMAP A17 the join service
needs; the cost model, ``plan_join`` and calibration wait there):

  * :mod:`profile` — :class:`DeviceProfile`, :func:`load_profile` (the
    port's ``"h100"`` profile, every constant unset);
  * :mod:`plan` — :class:`JoinPlan` and its serialisation;
  * :mod:`cache` — :class:`PlanCache`: the engine's converged window
    capacities (and plans) on disk, with an in-process hot layer, on the
    port's checkpoint discipline.
"""

from tpu_radix_join_torch.planner.cache import ManifestMismatch, PlanCache
from tpu_radix_join_torch.planner.plan import JoinPlan, PlanError
from tpu_radix_join_torch.planner.profile import (DeviceProfile,
                                                  ProfileError, load_profile)

__all__ = ["DeviceProfile", "JoinPlan", "ManifestMismatch", "PlanCache",
           "PlanError", "ProfileError", "load_profile"]
