"""Strategy selection: enumerate, cost, pick, explain.

The port's copy of ``tpu_radix_join/planner/plan.py`` (plan schema v5).
:func:`plan_join` turns a (profile, workload) pair into a
:class:`JoinPlan` — the knobs the command line feeds ``JoinConfig`` —
and the full per-strategy cost table, so ``--plan explain`` shows why the
winner won.  A plan saved by either package loads in the other.

JAX's ``static_memory_gate`` walks a jaxpr's live set (``analysis/jaxpr``);
the port has no jaxpr (ROADMAP A18e records it as not applicable), so
``plan_join(static_gate=True)`` and :func:`explain_table`'s ``static=``
column refuse by name.  Its ``critpath=`` column is the measured
critical path (planner/audit.py ``critpath_for_explain``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

from tpu_radix_join_torch.core.config import _not_ported
from tpu_radix_join_torch.ops.merge_count import MAX_MERGE_KEY
from tpu_radix_join_torch.planner.cost_model import (StrategyCost, Workload,
                                                     enumerate_strategies,
                                                     network_fanout_bits,
                                                     pick_chunk_tuples,
                                                     plan_exchange, plan_sort,
                                                     wide_sort_factor)
from tpu_radix_join_torch.planner.profile import DeviceProfile

#: v2 ``grid_pipeline``; v3 ``exchange_codec`` / ``exchange_stages``; v4
#: ``predicted_terms``; v5 ``sort_impl``.  Older files load with the
#: fields' defaults.
PLAN_SCHEMA_VERSION = 5


class PlanError(ValueError):
    """No feasible strategy, or a malformed plan file."""


class PlanInfeasibleError(PlanError):
    """No cost row is feasible for the workload under the armed memory
    budget: refused at plan time with the retry taxonomy's class."""

    failure_class = "plan_infeasible"


@dataclasses.dataclass(frozen=True)
class JoinPlan:
    """The planner's decision, in command-line vocabulary.  ``engine`` routes
    between the in-core join (HashJoin) and the out-of-core grid
    (ops/chunked.py); the other fields map onto JoinConfig and the command
    line; ``strategy`` / ``predicted_ms`` / ``predicted_terms`` record the
    winning cost row."""

    engine: str                       # "incore" | "chunked"
    fused: bool = True                # False -> measure_phases
    probe: str = "sort"               # "sort" | "bucket"
    two_level: bool = False
    key_range: str = "auto"           # "narrow" | "full" | "auto"
    network_fanout_bits: int = 5
    local_fanout_bits: int = 5
    chunk_tuples: Optional[int] = None   # chunked engine only
    grid_pipeline: str = "auto"          # "off" | "on" | "auto"
    exchange_codec: str = "off"          # "off" | "pack"
    exchange_stages: int = 1             # 1 = fused, k > 1 staged
    #: the sort arm of the winning row's flat sorts (cost_model.plan_sort):
    #: "pallas" binds K2, "xla" the library baseline arm, "auto" leaves
    #: every sort site on the engine's default
    sort_impl: str = "auto"
    pipeline_repeats: bool = False
    strategy: str = ""
    predicted_ms: float = 0.0
    #: the winning row's per-term ms, the predicted half of the
    #: plan-vs-actual audit (planner/audit.py)
    predicted_terms: dict = dataclasses.field(default_factory=dict)
    profile_name: str = ""
    schema_version: int = PLAN_SCHEMA_VERSION

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, doc: dict) -> "JoinPlan":
        doc = dict(doc)
        version = int(doc.get("schema_version", 1))
        if version > PLAN_SCHEMA_VERSION:
            raise PlanError(
                f"plan schema_version {version} is newer than this build "
                f"understands (<= {PLAN_SCHEMA_VERSION})")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - known
        if unknown:
            raise PlanError(f"unknown plan fields {sorted(unknown)}")
        if doc.get("engine") not in ("incore", "chunked"):
            raise PlanError(f"plan engine must be incore|chunked, "
                            f"got {doc.get('engine')!r}")
        return cls(**doc)

    def save(self, path: str) -> str:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "JoinPlan":
        try:
            with open(path) as f:
                return cls.from_dict(json.load(f))
        except (OSError, json.JSONDecodeError) as e:
            raise PlanError(f"unreadable plan file {path}: {e!r}") from e

    def config_kwargs(self) -> dict:
        """JoinConfig overrides this plan implies (in-core engine only)."""
        return {
            "probe_algorithm": self.probe,
            "two_level": self.two_level,
            "key_range": self.key_range,
            "network_fanout_bits": self.network_fanout_bits,
            "local_fanout_bits": self.local_fanout_bits,
            "measure_phases": not self.fused,
            "exchange_codec": self.exchange_codec,
            "exchange_stages": self.exchange_stages,
            "sort_impl": self.sort_impl,
        }


def plan_join(profile: DeviceProfile, workload: Workload,
              static_gate: bool = False
              ) -> Tuple[JoinPlan, List[StrategyCost]]:
    """Pick the cheapest feasible strategy (ties break toward the earlier
    row: fused before split, narrow before full) and bind it to
    command-line knobs.  ``static_gate=True`` (JAX's jaxpr live-set gate)
    is not applicable to the port and raises NotImplementedError."""
    if static_gate:
        raise _not_ported("plan_join(static_gate=True), the jaxpr "
                          "live-set gate,",
                          "queue A, A18e: not applicable, the port has no "
                          "jaxpr")
    costs = enumerate_strategies(profile, workload)
    feasible = [c for c in costs if c.feasible]
    if not feasible:
        raise PlanInfeasibleError(
            "no feasible strategy for this workload — every cost row is "
            "infeasible:\n" + explain_table(costs))
    best = min(feasible, key=lambda c: c.cost_ms)
    bits = network_fanout_bits(workload)
    xplan = plan_exchange(profile, workload, fanout_bits=bits)
    kw = dict(network_fanout_bits=bits,
              exchange_codec=xplan.codec,
              exchange_stages=xplan.stages,
              pipeline_repeats=workload.repeats > 1,
              strategy=best.strategy, predicted_ms=best.cost_ms,
              predicted_terms={k: round(v, 4)
                               for k, v in best.terms.items()},
              profile_name=profile.name)
    if best.strategy in ("chunked_grid", "chunked_grid_pipelined"):
        # the one-rank grid never exchanges: the codec fields stay inert
        plan = JoinPlan(engine="chunked",
                        chunk_tuples=pick_chunk_tuples(profile, workload),
                        grid_pipeline=("on" if best.strategy.endswith(
                            "_pipelined") else "off"),
                        key_range="auto" if workload.key_bound is None
                        else ("full" if not _narrow(workload) else "narrow"),
                        pipeline_repeats=False,
                        **{k: v for k, v in kw.items()
                           if k not in ("pipeline_repeats", "exchange_codec",
                                        "exchange_stages")})
    elif best.strategy == "incore_fused_twolevel":
        plan = JoinPlan(engine="incore", probe="bucket", two_level=True,
                        key_range="auto", **kw)
    else:
        # incore_{fused,split}_sort_{narrow,full}
        fused = "_fused_" in best.strategy
        narrow = best.strategy.endswith("_narrow")
        key_range = "narrow" if narrow else "full"
        if workload.key_bits == 64:
            key_range = "auto"     # wide keys have no range discipline
        # re-price the winning row's sort with enumerate_strategies'
        # geometry and bind its arm, so the command line forces it
        full_factor = (wide_sort_factor(profile) if workload.key_bits == 64
                       else profile.value("full_range_sort_factor"))
        splan = plan_sort(
            profile, workload.union_per_node,
            lanes=(1 if narrow else workload.lanes),
            key_bound=(None if narrow else workload.key_bound),
            key_bits=workload.key_bits,
            lane_factor=(1.0 if narrow else full_factor))
        plan = JoinPlan(engine="incore", fused=fused, key_range=key_range,
                        sort_impl=splan.impl, **kw)
        if not fused:
            # the split cannot pipeline (a fence a program)
            plan = dataclasses.replace(plan, pipeline_repeats=False)
    return plan, costs


def _narrow(w: Workload) -> bool:
    return (w.key_bits == 32
            and (w.key_bound is None or w.key_bound - 1 <= MAX_MERGE_KEY))


#: what ``--plan explain`` says each bound sort arm runs in the port
_SORT_ARMS = {"pallas": "(LSD radix kernel K2, csrc/radix_sort.cu)",
              "xla": "(library baseline arm, stable torch.sort)"}


def explain_table(costs: List[StrategyCost],
                  chosen: Optional[JoinPlan] = None,
                  actuals: Optional[dict] = None,
                  static: Optional[dict] = None,
                  critpath: Optional[dict] = None) -> str:
    """Human-readable per-strategy predicted-cost table (``--plan
    explain``), one column a term.  ``actuals`` (planner/audit.py
    ``actuals_for_explain``) adds ``actual_ms`` / ``drift%`` on the row
    that ran.  ``critpath`` (planner/audit.py ``critpath_for_explain``)
    adds the ``critical_path`` column: the measured bounding rank's path
    length on the row of the strategy that ran, what ``predicted_ms``
    should be priced against.  ``static`` is the JAX package's jaxpr
    column: the port has no jaxpr, and passing one raises
    NotImplementedError."""
    if static is not None:
        raise _not_ported("explain_table(static=)",
                          "queue A, A18e: not applicable, the port has no "
                          "jaxpr")
    term_keys: List[str] = []
    for c in costs:
        for k in c.terms:
            if k not in term_keys:
                term_keys.append(k)
    header = (["strategy", "feasible", "predicted_ms"]
              + (["actual_ms", "drift%"] if actuals else [])
              + (["critical_path"] if critpath else [])
              + [f"{k}_ms" for k in term_keys] + ["note"])
    rows = []
    for c in costs:
        mark = " *" if chosen is not None and c.strategy == chosen.strategy \
            else ""
        act_cells = []
        if actuals:
            if c.strategy == actuals.get("strategy"):
                a, d = actuals.get("actual_ms"), actuals.get("drift_pct")
                act_cells = [f"{a:.1f}" if a is not None else "-",
                             f"{d:.1f}" if d is not None else "-"]
            else:
                act_cells = ["", ""]
        cp_cells = []
        if critpath:
            b = critpath.get("bound_ms")
            if c.strategy == critpath.get("strategy") and b is not None:
                cp_cells = [f"{b:.1f}@r{critpath.get('bound_rank')}"]
            else:
                cp_cells = [""]
        rows.append([c.strategy + mark,
                     "yes" if c.feasible else "NO",
                     f"{c.cost_ms:.1f}" if c.feasible else "-"]
                    + act_cells
                    + cp_cells
                    + [f"{c.terms[k]:.1f}" if k in c.terms else ""
                       for k in term_keys]
                    + [c.note])
    widths = [max(len(header[i]), *(len(r[i]) for r in rows))
              for i in range(len(header))]

    def fmt(cells):
        return "| " + " | ".join(c.ljust(widths[i])
                                 for i, c in enumerate(cells)) + " |"

    lines = [fmt(header),
             "|" + "|".join("-" * (w + 2) for w in widths) + "|"]
    lines += [fmt(r) for r in rows]
    if chosen is not None:
        lines.append(f"chosen: {chosen.strategy} "
                     f"(predicted {chosen.predicted_ms:.1f} ms/join, "
                     f"profile {chosen.profile_name})")
        if chosen.engine == "incore":
            lines.append(
                f"exchange: codec={chosen.exchange_codec} "
                f"stages={chosen.exchange_stages} "
                f"({'fused' if chosen.exchange_stages <= 1 else 'staged'} "
                f"all_to_all)")
            lines.append(
                f"sort: impl={chosen.sort_impl} "
                + _SORT_ARMS.get(chosen.sort_impl,
                                 "(runtime auto-select per sort site)"))
    if critpath and critpath.get("bound_ms") is not None:
        wf = critpath.get("wait_fraction")
        lines.append(
            f"critical path: {critpath['bound_ms']:.1f} ms bound by "
            f"rank {critpath.get('bound_rank')}"
            + (f" (wait fraction {wf * 100:.1f}%)" if wf is not None
               else "")
            + " — plan terms priced against the bounding rank")
    return "\n".join(lines)
