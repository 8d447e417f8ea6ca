"""Seeded chaos soak of the crash-only fleet.

The fleet part of ``tpu_radix_join/robustness/chaos.py``: the verdict
vocabulary (``pass`` | ``classified`` | ``violation``), the replayable
:class:`Schedule`, :class:`RunOutcome`, and the ``fleet.worker_kill``
soak (:data:`FLEET_SITES`, :func:`generate_fleet_schedule`,
:class:`FleetChaosRunner`, :func:`soak_fleet`).  The soak invariant: every
query dispatched through a
:class:`~tpu_radix_join_torch.service.fleet.FleetSupervisor` under a
seeded worker-kill schedule returns exactly one outcome, oracle exact or
classified, and the journal audit counts no double execution.  A silent
wrong count, an unclassified outcome, a vanished query or an escaped
exception is a VIOLATION, and a violating run writes a forensics bundle
naming its ``(seed, arms)``.

The join-path runners of the JAX module (``CHAOS_SITES``, which names the
``engine.device_init`` site, ``ChaosRunner`` / ``soak`` / ``shrink``, the
recovery runner and the session runner) are ROADMAP A18c.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Callable, Dict, List, Optional, Tuple

from tpu_radix_join_torch.robustness import faults

PASS = "pass"
CLASSIFIED = "classified"
VIOLATION = "violation"


def _violation_bundle(m, schedule: "Schedule", detail: str,
                      bundle_dir: Optional[str]) -> Optional[str]:
    """Forensics bundle for a soak VIOLATION: the run's registry + ring
    plus the violating ``(seed, arms)`` schedule.  Never escalates — a
    bundle-write error must not turn the harness's verdict into a crash."""
    if not bundle_dir:
        return None
    try:
        from tpu_radix_join_torch.observability.postmortem import write_bundle
        return write_bundle(bundle_dir, m, reason="chaos_violation",
                            failure_class=None, chaos=schedule,
                            extra={"detail": detail})
    except Exception:           # noqa: BLE001 — forensics must not mask
        return None


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A replayable fault schedule: the injector seed plus the armed
    ``(site, arm-kwargs)`` pairs.  Determinism is inherited from
    :class:`faults.FaultInjector` (per-site ``random.Random(seed:site)``),
    so ``(seed, arms)`` IS the repro."""

    seed: int
    arms: Tuple[Tuple[str, Tuple[Tuple[str, int], ...]], ...]

    def arm_dicts(self) -> List[Tuple[str, Dict[str, int]]]:
        return [(site, dict(kw)) for site, kw in self.arms]

    def to_json(self) -> Dict[str, Any]:
        return {"seed": self.seed,
                "arms": [[site, dict(kw)] for site, kw in self.arms]}

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "Schedule":
        return cls(seed=int(obj["seed"]),
                   arms=tuple((str(site),
                               tuple(sorted((str(k), int(v))
                                            for k, v in kw.items())))
                              for site, kw in obj["arms"]))

    def without(self, index: int) -> "Schedule":
        return dataclasses.replace(
            self, arms=self.arms[:index] + self.arms[index + 1:])


@dataclasses.dataclass(frozen=True)
class RunOutcome:
    schedule: Schedule
    status: str                       # PASS | CLASSIFIED | VIOLATION
    failure_class: Optional[str]      # set when CLASSIFIED
    matches: Optional[int]            # set when the join returned
    detail: str = ""
    bundle: Optional[str] = None      # forensics bundle path (violations)

    def to_json(self) -> Dict[str, Any]:
        out = {"schedule": self.schedule.to_json(), "status": self.status,
               "failure_class": self.failure_class,
               "matches": self.matches, "detail": self.detail}
        if self.bundle:
            # the repro artifact names the evidence next to the (seed,
            # arms) pair; absent for non-violating runs (shape stable)
            out["bundle"] = self.bundle
        return out


# --------------------------------------------------------------------- fleet
#: sites the fleet supervisor's dispatch loop consults (service/fleet.py):
#: the worker-kill site fires right after a query hits a worker's pipe, so
#: the hit index IS the dispatched-query index (replay attempts re-consult
#: it — a schedule can kill the replay's worker too)
FLEET_SITES: Tuple[str, ...] = (
    faults.FLEET_WORKER_KILL,
)


def generate_fleet_schedule(seed: int, queries: int = 4) -> Schedule:
    """One ``fleet.worker_kill`` arm at a seeded dispatch index — mid-
    stream worker death, fully determined by ``seed``.  Kept to a single
    site (the only one the supervisor consults) so shrinking degenerates
    to "the kill did it"; the interesting variation is WHERE in the
    stream the kill lands."""
    rng = random.Random(seed)
    site = rng.choice(FLEET_SITES)
    return Schedule(seed=seed,
                    arms=((site, (("at", rng.randint(1, max(1, queries))),)),))


class FleetChaosRunner:
    """Executes ``fleet.worker_kill`` schedules against ONE resident
    :class:`~tpu_radix_join_torch.service.fleet.FleetSupervisor`.

    The supervisor is shared across runs by design: worker boot is the
    expensive part (a torch import and, on the card, a CUDA context per
    subprocess), and a crash-only supervisor is *supposed* to keep serving
    across arbitrary worker deaths — reusing it across schedules IS the
    soak.  The invariant per run: **every dispatched query returns exactly
    one outcome, oracle-exact (``matches == expected``) or classified, the
    journal audit counts zero double-executions, and the supervisor
    survives the stream**.  An escaped exception, an unclassified
    outcome, a silent wrong count, or ``double_exec > 0`` is a
    VIOLATION.

    ``batched=True`` dispatches each run's queries as ONE co-batchable
    group through ``dispatch_batch`` (the supervisor must have a batch
    window armed) — the worker-kill site then fires between the group's
    back-to-back request writes, i.e. MID-BATCH, and the invariant holds
    that failover re-dispatches the stranded members without a single
    double-execution.
    """

    def __init__(self, supervisor, queries: int = 3, size: int = 1 << 10,
                 data_seed: int = 0, bundle_dir: Optional[str] = None,
                 batched: bool = False):
        self.supervisor = supervisor
        self.queries = queries
        self.size = size
        self.data_seed = data_seed
        self.bundle_dir = bundle_dir
        self.batched = batched
        self.measurements: List[Any] = []

    def run(self, schedule: Schedule) -> RunOutcome:
        out = self._run(schedule)
        if out.status == VIOLATION and self.measurements:
            out = dataclasses.replace(out, bundle=_violation_bundle(
                self.measurements[-1], schedule, out.detail,
                self.bundle_dir))
        return out

    def _run(self, schedule: Schedule) -> RunOutcome:
        from tpu_radix_join_torch.service import UNCLASSIFIED
        sup = self.supervisor
        m = sup.measurements
        if m is not None:
            self.measurements.append(m)
        inj = faults.FaultInjector(seed=schedule.seed, measurements=m)
        for site, kw in schedule.arm_dicts():
            inj.arm(site, **kw)
        outs = []
        try:
            with inj:
                # seed-qualified ids keep fingerprints distinct across
                # runs — the journal dedup must only collapse genuine
                # re-submissions, not the soak's fresh queries
                requests = [{"query_id": f"s{schedule.seed}q{i}",
                             "tenant": f"t{i % 2}",
                             "tuples_per_node": self.size,
                             "seed": self.data_seed}
                            for i in range(self.queries)]
                if self.batched:
                    # one co-batchable group through dispatch_batch: the
                    # kill arm lands between the group's request writes
                    outs = sup.dispatch_batch(requests)
                else:
                    for request in requests:
                        outs.append(sup.dispatch(request))
        except Exception as e:      # noqa: BLE001 — the invariant itself
            return RunOutcome(schedule, VIOLATION, None, None,
                              f"supervisor died at query {len(outs)}: {e!r}")
        detail = " ".join(
            f"{o.get('query_id')}={o.get('status')}/{o.get('failure_class')}"
            for o in outs)
        audit = sup.journal.audit()
        if audit.double_exec:
            return RunOutcome(schedule, VIOLATION, None, None,
                              f"{audit.double_exec} double-executed "
                              f"fingerprint(s) in the journal: {detail}")
        for o in outs:
            if o is None:
                return RunOutcome(schedule, VIOLATION, None, None,
                                  f"query vanished without an outcome: "
                                  f"{detail}")
            if o.get("failure_class") == UNCLASSIFIED:
                return RunOutcome(schedule, VIOLATION, None, o.get("matches"),
                                  f"unclassified query outcome: {detail}")
            if (o.get("status") == "ok" and o.get("expected") is not None
                    and o.get("matches") != o.get("expected")):
                return RunOutcome(
                    schedule, VIOLATION, None, o.get("matches"),
                    f"silent wrong count on {o.get('query_id')}: "
                    f"{o.get('matches')} != oracle {o.get('expected')} "
                    f"({detail})")
        classes = sorted({o["failure_class"] for o in outs
                          if o.get("failure_class")
                          and o["failure_class"] != "ok"})
        last_ok = next((o.get("matches") for o in reversed(outs)
                        if o.get("status") == "ok"), None)
        if not classes:
            return RunOutcome(schedule, PASS, None, last_ok, detail)
        return RunOutcome(schedule, CLASSIFIED, ",".join(classes),
                          last_ok, detail)


def soak_fleet(runs: int, base_seed: int = 0,
               runner: Optional[FleetChaosRunner] = None,
               supervisor=None,
               on_outcome: Optional[Callable[[RunOutcome], None]] = None):
    """N seeded ``fleet.worker_kill`` streams through one
    :class:`FleetChaosRunner`: ``(outcomes, summary)``, the summary
    counting the verdicts, the failure classes and the supervisor-side
    exactly-once accounting (failovers, replays, restarts, the final
    journal audit)."""
    if runner is None:
        if supervisor is None:
            raise ValueError("soak_fleet needs a runner or a supervisor")
        runner = FleetChaosRunner(supervisor)
    outcomes = []
    for i in range(runs):
        out = runner.run(generate_fleet_schedule(base_seed + i,
                                                 runner.queries))
        outcomes.append(out)
        if on_outcome:
            on_outcome(out)
    sup = runner.supervisor
    audit = sup.journal.audit()
    summary = {
        "runs": runs,
        "base_seed": base_seed,
        "queries_per_run": runner.queries,
        "pass": sum(o.status == PASS for o in outcomes),
        "classified": sum(o.status == CLASSIFIED for o in outcomes),
        "violations": sum(o.status == VIOLATION for o in outcomes),
        "failure_classes": sorted({c for o in outcomes if o.failure_class
                                   for c in o.failure_class.split(",")}),
        "failovers": sup.failovers,
        "replays": sup.replays,
        "worker_restarts": sup.restarts,
        "double_exec": audit.double_exec,
        "unacked": audit.unacked,
    }
    return outcomes, summary
