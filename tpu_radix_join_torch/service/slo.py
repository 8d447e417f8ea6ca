"""SLO accounting: per-tenant latency percentiles and outcome rates.

The port's copy of ``tpu_radix_join/service/slo.py``.  The recorder keeps
every query's latency and distills:

  * ``slo_p50_ms`` / ``slo_p95_ms`` / ``slo_p99_ms`` — overall, and the
    same three a tenant;
  * ``admission_rejection_rate`` / ``deadline_miss_rate`` /
    ``degraded_rate`` — outcome rates over everything submitted.

``snapshot()`` feeds the serve loop's summary line.  Percentiles are
nearest-rank on the sorted sample (no interpolation), so a small run's
p99 is its worst query.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

PERCENTILES = (50, 95, 99)


def nearest_rank(sorted_vals: List[float], pct: float) -> float:
    """Nearest-rank percentile of an already-sorted non-empty list."""
    if not sorted_vals:
        raise ValueError("no samples")
    rank = max(1, -(-len(sorted_vals) * pct // 100))   # ceil
    return sorted_vals[int(rank) - 1]


class SLORecorder:
    """Accumulates per-query outcomes; distills SLO tags on demand."""

    def __init__(self):
        self._lat_ms: Dict[str, List[float]] = collections.defaultdict(list)
        self.completed = 0          # queries that ran to a terminal outcome
        self.ok = 0
        self.failed = 0             # classified failures (ran, didn't pass)
        self.rejected = 0           # never ran: admission refusals
        self.deadline_missed = 0
        self.degraded = 0           # served by the fallback engine

    # ------------------------------------------------------------- recording
    def record(self, tenant: str, latency_ms: float, *, ok: bool,
               failure_class: Optional[str] = None,
               degraded: bool = False) -> None:
        """One executed query (admitted, ran, produced an outcome)."""
        self._lat_ms[tenant].append(float(latency_ms))
        self.completed += 1
        if ok:
            self.ok += 1
        else:
            self.failed += 1
        if failure_class == "deadline_exceeded":
            self.deadline_missed += 1
        if degraded:
            self.degraded += 1

    def record_rejection(self) -> None:
        """One admission refusal (the query never executed, so it has no
        latency sample — rejections shape the rate tags only)."""
        self.rejected += 1

    # ------------------------------------------------------------ distilling
    def percentiles(self, tenant: Optional[str] = None) -> Dict[str, float]:
        """{"p50_ms": ..., "p95_ms": ..., "p99_ms": ...} for one tenant or
        (None) the whole service; empty dict when no samples yet."""
        if tenant is None:
            vals = [v for vs in self._lat_ms.values() for v in vs]
        else:
            vals = list(self._lat_ms.get(tenant, ()))
        if not vals:
            return {}
        vals.sort()
        return {f"p{p}_ms": round(nearest_rank(vals, p), 3)
                for p in PERCENTILES}

    def tenants(self) -> List[str]:
        return sorted(self._lat_ms)

    def snapshot(self) -> dict:
        """Flat SLO tag dict: heartbeat tick, final report, and BENCH JSON
        all speak this vocabulary."""
        submitted = self.completed + self.rejected
        out = {
            "queries_submitted": submitted,
            "queries_ok": self.ok,
            "queries_failed": self.failed,
            "queries_rejected": self.rejected,
            "admission_rejection_rate": round(
                self.rejected / submitted, 4) if submitted else 0.0,
            "deadline_miss_rate": round(
                self.deadline_missed / submitted, 4) if submitted else 0.0,
            "degraded_rate": round(
                self.degraded / submitted, 4) if submitted else 0.0,
        }
        overall = self.percentiles()
        out.update({f"slo_{k}": v for k, v in overall.items()})
        for tenant in self.tenants():
            for k, v in self.percentiles(tenant).items():
                out[f"slo_{tenant}_{k}"] = v
        return out
