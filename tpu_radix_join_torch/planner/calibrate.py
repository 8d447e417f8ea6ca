"""Profile calibration: fit REQUIRED_CONSTANTS from ledger evidence.

The port's copy of ``tpu_radix_join/planner/calibrate.py``.  It reads the
run ledger (observability/ledger.py), extracts per-constant samples from
the row kinds that carry them, robust-fits each constant, and emits a
schema-v3 profile whose provenance blocks cite the run ids behind every
number.

Per-constant sample extraction:

  * ``sort_stage_unit_ms`` — bench rows of the single-device join
    throughput, inverted through the stage model
    ``t = unit * (M / SORT_REF) * U(M)`` at the packed union;
  * ``dispatch_floor_ms`` — run rows: the SDISPATCH floor, and the JTOTAL
    of runs of at most 64K tuples;
  * ``ici_bytes_per_s`` — run rows: WIREBYTES / JMPI;
  * ``partition_pass_unit_ms`` — ``--partition-bench``-shaped rows: the
    grouping kernel's wall over two passes at the row's element count;
  * ``radix_sort_pass_unit_ms`` — ``--sort-bench``-shaped rows: the radix
    kernel's wall over the digit passes the row's key bound ran;
  * anything — ``kind="obs"`` rows carry a pre-reduced
    ``{"constant": ..., "value": ...}`` observation (the extension point
    ``chip_smoke.py``'s phase (u) writes its probes through).

Staleness: a persistently drifting plan (PLANDRIFT, planner/audit.py)
indicts the constant behind its dominant cost term; ``detect_stale``
flags constants whose drift recurs, which ``--plan explain`` shows.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

from tpu_radix_join_torch.planner.profile import (SORT_REF_ELEMS,
                                                  DeviceProfile,
                                                  load_profile,
                                                  sort_stage_units)

#: cost-model term -> the profile constant that prices it
#: (cost_model.py's stage models; ``overlap`` is a negative credit and
#: ``probe``/``sort`` both ride the sort emitter's unit)
TERM_TO_CONSTANT = {
    # the sort term rides plan_sort's chosen arm — xla rows price it by
    # the stage unit, pallas rows by radix_sort_pass_unit_ms; staleness
    # attribution keeps the stage unit as the default blame (the xla arm
    # is the one the committed evidence fitted; a drifting pallas row
    # shows up in --sort-bench refits instead)
    "sort": "sort_stage_unit_ms",
    "probe": "sort_stage_unit_ms",
    "scan": "hbm_gbps",
    "stage": "hbm_gbps",
    "pack": "hbm_gbps",
    "shuffle": "ici_bytes_per_s",
    "dispatch": "dispatch_floor_ms",
    "scatter": "scatter_loop_melems_s",
    # destination grouping under plan_partition: the fused-pallas arm is
    # priced by the partition pass unit; the sort arm folds into the same
    # term (its drift still indicts the partition row in --plan explain)
    "partition": "partition_pass_unit_ms",
}

#: the bench metric whose stage model we can invert for the sort unit
BENCH_SORT_METRIC = "single_chip_join_throughput"

#: --partition-bench A/B rows: the fused arm's wall and element count
#: invert directly to ms per million tuples per pass (the kernel makes
#: two passes, csrc/partition.cu)
BENCH_PARTITION_METRIC = "partition_fused_speedup"

#: --sort-bench A/B rows: the Pallas radix arm's kernel wall inverts to
#: ms per million tuples per digit pass (the row carries the pass count
#: its key bound actually ran, so bounded rows fit the same unit)
BENCH_RADIX_SORT_METRIC = "radix_sort_speedup"

#: runs at or below this global size are pure dispatch floor
SMALL_RUN_ELEMS = 1 << 16

#: fits below this sample count are refused: a single sample has no
#: spread to report a CI from
DEFAULT_MIN_SAMPLES = 2

DEFAULT_DRIFT_THRESHOLD_PCT = 25.0
DEFAULT_MIN_PERSIST = 3


class UnderSampledError(ValueError):
    """The ledger holds too few samples to fit anything at the requested
    ``min_samples`` — the caller must gather evidence, not get a profile
    that merely echoes its base."""


@dataclasses.dataclass(frozen=True)
class Sample:
    """One reduced observation of one constant, traceable to its row."""

    value: float
    run_id: str


@dataclasses.dataclass(frozen=True)
class Fit:
    """Robust fit of one constant: the median estimate plus the spread
    evidence the provenance block publishes."""

    value: float
    n: int
    ci95: Tuple[float, float]
    residual: float                     # MAD / |median|, relative spread
    runs: Tuple[str, ...]


# ------------------------------------------------------------ sample extraction
def _sort_unit_from_bench(row: dict) -> Optional[Sample]:
    if row.get("metric") != BENCH_SORT_METRIC:
        return None
    value = float(row.get("value") or 0.0)
    size = int(row.get("size") or 0)
    if value <= 0 or size <= 0:
        return None
    union = 2 * size                    # packed R||S union the sort sees
    t_ms = union / value * 1e3          # measured wall from throughput
    units = (union / SORT_REF_ELEMS) * sort_stage_units(union)
    if units <= 0:
        return None
    return Sample(t_ms / units, str(row.get("run_id", "?")))


def _partition_unit_from_bench(row: dict) -> Optional[Sample]:
    """Invert a --partition-bench row to ms/Mtuple/pass: the fused arm's
    kernel wall over two passes at the row's element count (the bench also
    publishes the reduced ``partition_unit_ms`` tag; recomputing from the
    primary measurement keeps the fit independent of the reduction)."""
    if row.get("metric") != BENCH_PARTITION_METRIC:
        return None
    size = int(row.get("size") or 0)
    kernel_ms = float(row.get("partition_kernel_ms") or 0.0)
    rid = str(row.get("run_id", "?"))
    if size > 0 and kernel_ms > 0:
        return Sample(kernel_ms / (2.0 * size / 1e6), rid)
    unit = float(row.get("partition_unit_ms") or 0.0)
    if unit > 0:
        return Sample(unit, rid)
    return None


def _radix_sort_unit_from_bench(row: dict) -> Optional[Sample]:
    """Invert a --sort-bench row to ms/Mtuple/pass: the Pallas arm's slot
    kernel wall over the digit passes the row's key bound ran (the bench
    also publishes the reduced ``sort_pass_unit_ms`` tag; recomputing
    from the primary measurement keeps the fit independent of the
    reduction)."""
    if row.get("metric") != BENCH_RADIX_SORT_METRIC:
        return None
    size = int(row.get("size") or 0)
    passes = int(row.get("sort_passes") or 0)
    kernel_ms = float(row.get("sort_kernel_ms") or 0.0)
    rid = str(row.get("run_id", "?"))
    if size > 0 and passes > 0 and kernel_ms > 0:
        return Sample(kernel_ms / (passes * size / 1e6), rid)
    unit = float(row.get("sort_pass_unit_ms") or 0.0)
    if unit > 0:
        return Sample(unit, rid)
    return None


def collect_samples(rows: List[dict]) -> Dict[str, List[Sample]]:
    """Constant -> samples, pooled across every row kind that carries
    evidence for it.  Rows that lack a given signal simply contribute
    nothing — a ledger of pure bench rows fits only the sort unit."""
    out: Dict[str, List[Sample]] = {}

    def add(key: str, value: float, run_id) -> None:
        if value > 0 and math.isfinite(value):
            out.setdefault(key, []).append(Sample(value, str(run_id)))

    for row in rows:
        kind = row.get("kind")
        rid = row.get("run_id", "?")
        if kind == "bench":
            s = _sort_unit_from_bench(row)
            if s is not None:
                out.setdefault("sort_stage_unit_ms", []).append(s)
            s = _partition_unit_from_bench(row)
            if s is not None:
                out.setdefault("partition_pass_unit_ms", []).append(s)
            s = _radix_sort_unit_from_bench(row)
            if s is not None:
                out.setdefault("radix_sort_pass_unit_ms", []).append(s)
        elif kind == "run":
            times = row.get("times_us") or {}
            counters = row.get("counters") or {}
            wl = row.get("workload") or {}
            sd_us = float(times.get("SDISPATCH") or 0.0)
            if sd_us > 0:
                add("dispatch_floor_ms", sd_us / 1e3, rid)
            # tiny-run intercept: at <= 64K tuples the whole wall is floor
            jt_us = float(times.get("JTOTAL") or 0.0)
            gsize = int(wl.get("global_size") or 0)
            if jt_us > 0 and 0 < gsize <= SMALL_RUN_ELEMS:
                add("dispatch_floor_ms", jt_us / 1e3, rid)
            wire = float(counters.get("WIREBYTES") or 0.0)
            jmpi_us = float(times.get("JMPI") or 0.0)
            if wire > 0 and jmpi_us > 0:
                add("ici_bytes_per_s", wire / (jmpi_us / 1e6), rid)
        elif kind == "obs":
            key = row.get("constant")
            if isinstance(key, str) and key:
                try:
                    add(key, float(row.get("value")), rid)
                except (TypeError, ValueError):
                    pass
    return out


# ----------------------------------------------------------------- robust fit
def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    pos = q * (len(sorted_vals) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def robust_fit(samples: List[Sample]) -> Fit:
    """Median estimate with MAD residual and an IQR-based ~95% CI
    (med +/- 1.58 * IQR / sqrt(n), the boxplot-notch approximation) —
    robust to the occasional cold-cache or contended-run outlier that a
    mean fit would chase."""
    if not samples:
        raise UnderSampledError("robust_fit needs at least one sample")
    vals = sorted(s.value for s in samples)
    n = len(vals)
    med = _quantile(vals, 0.5)
    mad = _quantile(sorted(abs(v - med) for v in vals), 0.5)
    iqr = _quantile(vals, 0.75) - _quantile(vals, 0.25)
    half = 1.58 * iqr / math.sqrt(n)
    ci = (min(med - half, med), max(med + half, med))
    residual = mad / abs(med) if med else 0.0
    runs = []
    for s in samples:                   # unique, first-seen order
        if s.run_id not in runs:
            runs.append(s.run_id)
    return Fit(value=med, n=n, ci95=ci, residual=residual,
               runs=tuple(runs))


# ---------------------------------------------------------------- profile fit
def fit_profile(rows: List[dict],
                base: Optional[DeviceProfile] = None,
                name: Optional[str] = None,
                min_samples: int = DEFAULT_MIN_SAMPLES,
                fitted_at: Optional[float] = None,
                ) -> Tuple[DeviceProfile, Dict[str, Fit]]:
    """Fit every constant the ledger has >= ``min_samples`` samples for;
    the rest keep the base profile's cited value.  EVERY constant leaves
    with a provenance block — fitted ones cite their run ids and CI,
    inherited ones say so explicitly (``origin: "committed"``) — so the
    schema-v3 acceptance bar ("provenance on every constant") holds even
    for a sparse ledger.  Raises UnderSampledError when nothing fits."""
    base = base or load_profile()
    fitted_at = time.time() if fitted_at is None else float(fitted_at)
    samples = collect_samples(rows)
    fits: Dict[str, Fit] = {}
    constants: Dict[str, dict] = {}
    for key, entry in base.constants.items():
        pool = samples.get(key) or []
        if len(pool) >= max(1, int(min_samples)):
            fit = robust_fit(pool)
            fits[key] = fit
            constants[key] = {
                "value": fit.value,
                "source": (f"fit:ledger n={fit.n} "
                           f"(was: {entry.get('source', 'uncited')})"),
                "provenance": {
                    "origin": "fit", "runs": list(fit.runs)[:8],
                    "n": fit.n,
                    "ci95": [fit.ci95[0], fit.ci95[1]],
                    "residual": round(fit.residual, 6),
                    "fitted_at_epoch_s": round(fitted_at, 3)},
            }
        else:
            constants[key] = {
                "value": entry["value"],
                "source": entry.get("source", "uncited"),
                "provenance": {"origin": "committed", "runs": [],
                               "n": len(pool)},
            }
    if not fits:
        raise UnderSampledError(
            f"no constant has >= {min_samples} ledger samples "
            f"(sampled: { {k: len(v) for k, v in samples.items()} })")
    prof = DeviceProfile(
        name=name or f"{base.name}+fitted",
        constants=constants,
        notes=(f"fitted from ledger ({sum(f.n for f in fits.values())} "
               f"samples across {len(fits)} constants); unfitted "
               f"constants inherited from {base.name}"))
    return prof, fits


# ------------------------------------------------------------------ staleness
def _dominant_constant(table: dict) -> Optional[str]:
    """The constant behind the audit table's dominant cost term:
    prefer the term with the largest measured-vs-predicted gap (only the
    shuffle term has a measured twin), else the largest predicted term.
    Terms with no priced constant (overlap credit) never attract blame."""
    best_key, best_score = None, -1.0
    for t in table.get("terms") or []:
        key = TERM_TO_CONSTANT.get(t.get("term"))
        if key is None:
            continue
        pred = float(t.get("predicted_ms") or 0.0)
        if pred <= 0:
            continue
        act = t.get("actual_ms")
        score = abs(float(act) - pred) if act is not None else pred
        if score > best_score:
            best_key, best_score = key, score
    return best_key


def detect_stale(rows: List[dict],
                 threshold_pct: float = DEFAULT_DRIFT_THRESHOLD_PCT,
                 min_persist: int = DEFAULT_MIN_PERSIST) -> Dict[str, dict]:
    """Constants whose predicted cost keeps missing the clock: each
    audited run row with ``drift_pct >= threshold_pct`` blames its
    dominant term's constant; a constant blamed ``min_persist`` or more
    times is stale.  Returns ``{constant: {hits, mean_drift_pct, runs}}``
    (only the stale ones — usable directly as format_provenance's
    ``stale`` argument)."""
    blame: Dict[str, dict] = {}
    for row in rows:
        if row.get("kind") != "run":
            continue
        table = row.get("plan_vs_actual")
        if not isinstance(table, dict):
            continue
        drift = table.get("drift_pct")
        if drift is None or float(drift) < threshold_pct:
            continue
        key = _dominant_constant(table)
        if key is None:
            continue
        info = blame.setdefault(key, {"hits": 0, "drifts": [], "runs": []})
        info["hits"] += 1
        info["drifts"].append(float(drift))
        rid = str(row.get("run_id", "?"))
        if rid not in info["runs"]:
            info["runs"].append(rid)
    out: Dict[str, dict] = {}
    for key, info in blame.items():
        if info["hits"] >= max(1, int(min_persist)):
            out[key] = {"hits": info["hits"],
                        "mean_drift_pct": round(
                            sum(info["drifts"]) / len(info["drifts"]), 1),
                        "runs": info["runs"][:8]}
    return out


def diff_profiles(a: DeviceProfile, b: DeviceProfile) -> List[dict]:
    """Per-constant relative deltas between two profiles (b vs a), for
    the fitted-vs-packaged table ``chip_smoke.py``'s phase (u) prints;
    an unset constant's value is None."""
    out = []
    for key in sorted(set(a.constants) | set(b.constants)):
        va = a.value(key) if a.is_set(key) else None
        vb = b.value(key) if b.is_set(key) else None
        rel = (abs(vb - va) / abs(va)
               if va not in (None, 0) and vb is not None else None)
        out.append({"constant": key, "a": va, "b": vb,
                    "rel_delta": round(rel, 4) if rel is not None else None})
    return out
