"""Plan-vs-actual audit: the cost model's prediction against the clock.

The port's copy of ``tpu_radix_join/planner/audit.py``.  After a planned
join, :func:`audit_plan` compares the plan's ``predicted_ms`` (and its
per-term breakdown) with what the registry measured and records:

  * ``counters["PLANDRIFT"]`` — |actual - predicted| as a percent of the
    prediction (a gauge: each audited join overwrites it);
  * ``meta["plan_vs_actual"]`` — the table (strategy, predicted and actual
    ms, drift, per-term rows with their measured twins where one exists),
    which the run ledger keeps and ``--plan explain`` reads;
  * a ``plan_drift`` event.

Only the shuffle term has a measured twin (JMPI, under the phase split);
the other terms land in JPROC together, so the JTOTAL comparison carries
the signal.  ``times0`` (a :func:`phase_snapshot` taken before the join)
makes the audit a delta, so a registry that accumulates several joins
audits the last one.  The JAX package's critical-path pricing
(``critical_path=``, ``critpath_for_explain``) waits for A18d's
``critpath.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

from tpu_radix_join_torch.performance.measurements import (JHIST, JMPI,
                                                           JPROC, JTOTAL,
                                                           PLANDRIFT,
                                                           SDISPATCH,
                                                           SWINALLOC)

#: phase tags the audit snapshots and differences (the measured side)
PHASE_TAGS = (JTOTAL, JHIST, JMPI, JPROC, SWINALLOC, SDISPATCH)

#: cost-model term -> measured tag, where a 1:1 twin exists
_TERM_TAG = {"shuffle": JMPI}


def phase_snapshot(measurements) -> Dict[str, float]:
    """Pre-join ``times_us`` snapshot for a delta-based audit."""
    return {k: measurements.times_us.get(k, 0.0) for k in PHASE_TAGS}


def audit_plan(plan, measurements, repeats: int = 1,
               times0: Optional[Dict[str, float]] = None) -> Optional[dict]:
    """Record the plan-vs-actual table of the join that just ran.

    ``plan`` is a JoinPlan or its dict; ``repeats`` divides the measured
    JTOTAL down to the one join ``predicted_ms`` speaks of.  Returns the
    table (also ``meta["plan_vs_actual"]``), or None when nothing ran (no
    JTOTAL since ``times0``)."""
    m = measurements
    if m is None or plan is None:
        return None
    pd = plan if isinstance(plan, dict) else plan.to_dict()
    t0 = times0 or {}
    delta_ms = {}
    for tag in PHASE_TAGS:
        cur = m.times_us.get(tag)
        if cur is None and tag not in t0:
            continue
        delta_ms[tag] = ((cur or 0.0) - t0.get(tag, 0.0)) / 1e3
    jt_ms = delta_ms.get(JTOTAL, 0.0)
    if jt_ms <= 0:
        return None
    reps = max(1, int(repeats))
    actual_ms = jt_ms / reps
    predicted_ms = float(pd.get("predicted_ms") or 0.0)
    drift_pct = (round(100.0 * abs(actual_ms - predicted_ms) / predicted_ms,
                       2) if predicted_ms > 0 else None)
    terms = []
    for term, pred in (pd.get("predicted_terms") or {}).items():
        tag = _TERM_TAG.get(term)
        act = (round(delta_ms[tag] / reps, 3)
               if tag is not None and tag in delta_ms else None)
        terms.append({"term": term, "predicted_ms": round(float(pred), 3),
                      "actual_ms": act})
    table = {
        "strategy": pd.get("strategy", ""),
        "engine": pd.get("engine", ""),
        "profile_name": pd.get("profile_name", ""),
        "predicted_ms": round(predicted_ms, 3),
        "actual_ms": round(actual_ms, 3),
        "drift_pct": drift_pct,
        "repeats": reps,
        "terms": terms,
        "measured_ms": {k: round(v / reps, 3) for k, v in delta_ms.items()},
    }
    m.meta["plan_vs_actual"] = table
    if drift_pct is not None:
        m.counters[PLANDRIFT] = int(round(drift_pct))
    m.event("plan_drift", strategy=table["strategy"],
            predicted_ms=table["predicted_ms"],
            actual_ms=table["actual_ms"], drift_pct=drift_pct)
    return table


def actuals_for_explain(table: Optional[dict]) -> Optional[dict]:
    """An audit table shaped for explain_table's ``actuals`` columns:
    {strategy, actual_ms, drift_pct}; None passes through."""
    if not table:
        return None
    return {"strategy": table.get("strategy"),
            "actual_ms": table.get("actual_ms"),
            "drift_pct": table.get("drift_pct")}
