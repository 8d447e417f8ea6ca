"""Seeded chaos soaks with shrinking fault-schedule repros.

The port's copy of ``tpu_radix_join/robustness/chaos.py``.  The soak
invariant: every run, under any schedule of injected faults, either passes
or ends in a classified failure (``diagnostics["failure_class"]`` or an
exception carrying one).  A run that returns ``ok=True`` with a wrong
count, or dies unclassified, is a VIOLATION, and writes a forensics bundle
naming its ``(seed, arms)``.

  * the join path: :func:`generate_schedule` over :data:`CHAOS_SITES`,
    :class:`ChaosRunner` and :func:`soak`;
  * elastic recovery: :func:`generate_recovery_schedule` over
    :data:`RECOVERY_SITES` (rank death, rank join, a straggler),
    :class:`RecoveryChaosRunner` and :func:`soak_recovery`;
  * the resident session: :func:`generate_session_schedule`,
    :class:`SessionChaosRunner` and :func:`soak_session`;
  * the crash-only fleet: :data:`FLEET_SITES`,
    :func:`generate_fleet_schedule`, :class:`FleetChaosRunner` and
    :func:`soak_fleet` (every dispatched query returns exactly one
    outcome, and the journal audit counts no double execution);
  * :func:`shrink`, greedy delta debugging of a violating schedule, and
    :func:`write_repro`, its replayable record.

The schedules are pure Python (``random.Random(seed)``), equal to JAX's for
equal seeds.  A runner takes the engine's ``device`` and ``group``: over a
process group every rank runs the same schedules and reaches the same
verdicts (JAX's ``num_nodes=4`` in one process is a four-rank world).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from tpu_radix_join_torch.robustness import faults
from tpu_radix_join_torch.robustness.retry import DEVICE_UNAVAILABLE

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


# ------------------------------------------------------------ join path
#: sites the ``join_arrays`` path consults, the arms that can fire in a
#: soak run (the grid, checkpoint, stream and connect sites only fire on
#: the out-of-core and connect paths)
CHAOS_SITES: Tuple[str, ...] = (
    faults.SHUFFLE_OVERFLOW,
    faults.DEVICE_INIT,
    faults.EXCHANGE_CORRUPT,
)

#: the failure class of an :class:`faults.InjectedFault` raised at a site
#: (the corrupting sites surface through the engine's own classes)
_SITE_CLASSES = {faults.DEVICE_INIT: DEVICE_UNAVAILABLE}


def generate_schedule(seed: int) -> Schedule:
    """1-3 distinct arms over :data:`CHAOS_SITES`, fixed by ``seed``.  The
    corruption and device-init sites are consulted once a run, so their
    arm is ``at=1``; the shuffle-overflow site once an attempt, so its hit
    varies (``at=2`` injects into an attempt already retried)."""
    rng = random.Random(seed)
    sites = rng.sample(CHAOS_SITES, rng.randint(1, len(CHAOS_SITES)))
    arms = []
    for site in sites:
        at = rng.randint(1, 2) if site == faults.SHUFFLE_OVERFLOW else 1
        arms.append((site, (("at", at),)))
    return Schedule(seed=seed, arms=tuple(arms))


class ChaosRunner:
    """Runs fault schedules against one cached engine, on ``device`` (the
    card unless the caller asks for the CPU) over ``group`` (a process
    group of ``num_nodes`` ranks, each running the same schedules, or None
    at one rank).

    The engine is built once and reused over the soak, so the
    ``engine.device_init`` site, which fires in the constructor in
    production, is consulted at the top of each run.  The inputs have a
    known count: R's keys are a permutation of 1..n and S's are uniform
    over 1..n, so every outer tuple matches exactly one inner tuple and the
    count is ``n``; any injected damage moves it off the oracle.  Each rank
    joins its contiguous shard of the global lanes, and the elastic path
    regenerates them whole (``HashJoin.elastic_inputs``)."""

    def __init__(self, num_nodes: int = 4, size: int = 1 << 12,
                 verify: str = "check", data_seed: int = 0,
                 config_overrides: Optional[Dict[str, Any]] = None,
                 bundle_dir: Optional[str] = None, device="cuda",
                 group=None):
        from tpu_radix_join_torch.core.config import JoinConfig
        from tpu_radix_join_torch.operators.hash_join import HashJoin
        from tpu_radix_join_torch.performance.measurements import (
            Measurements)
        self._measurements_cls = Measurements
        self.bundle_dir = bundle_dir
        self.oracle = size
        rng = np.random.default_rng(data_seed)
        self._rk = (rng.permutation(size) + 1).astype(np.uint32)
        self._sk = rng.integers(1, size + 1, size=size).astype(np.uint32)
        self._rid = np.arange(size, dtype=np.uint32)
        cfg = JoinConfig(num_nodes=num_nodes, verify=verify,
                         **(config_overrides or {}))
        self.config = cfg
        self.engine = HashJoin(cfg, device=device, group=group)
        self.engine.elastic_inputs = lambda: (self._rk, None, self._sk, None)
        self.measurements: List[Any] = []   # one registry a run, in order

    def _batches(self):
        """This rank's shards as fresh lanes a run: the exchange-corruption
        site damages its input in place, which must not leak into the next
        run."""
        from tpu_radix_join_torch.data.tuples import (TupleBatch,
                                                      lane_from_numpy)
        world = self.engine.world
        n = self.oracle // world.size
        lo = world.rank * n
        dev = self.engine.device
        rid = lane_from_numpy(self._rid[lo:lo + n], dev)
        return (TupleBatch(key=lane_from_numpy(self._rk[lo:lo + n], dev),
                           rid=rid),
                TupleBatch(key=lane_from_numpy(self._sk[lo:lo + n], dev),
                           rid=rid.clone()))

    def run(self, schedule: Schedule) -> RunOutcome:
        out = self._run(schedule)
        if out.status == VIOLATION:
            out = dataclasses.replace(out, bundle=_violation_bundle(
                self.measurements[-1], schedule, out.detail,
                self.bundle_dir))
        return out

    def _bind(self, m) -> None:
        """The run's registry hook: the base runner's engine records no
        counters; :class:`RecoveryChaosRunner` points the engine at the
        run's registry so RANKLOST, RECOVERN and MEPOCH land where the
        soak reads them."""

    def _run(self, schedule: Schedule) -> RunOutcome:
        m = self._measurements_cls()
        self.measurements.append(m)
        self._bind(m)
        inj = faults.FaultInjector(seed=schedule.seed, measurements=m)
        for site, kw in schedule.arm_dicts():
            inj.arm(site, **kw)
        try:
            with inj:
                # the constructor's site, consulted a run (the engine is
                # cached)
                faults.check(faults.DEVICE_INIT, m)
                result = self.engine.join_arrays(*self._batches())
        except faults.InjectedFault as e:
            cls = getattr(e, "failure_class", None) or _SITE_CLASSES.get(
                e.site)
            if cls is None:
                return RunOutcome(schedule, VIOLATION, None, None,
                                  f"unclassified injected fault: {e!r}")
            return RunOutcome(schedule, CLASSIFIED, cls, None, repr(e))
        except Exception as e:      # noqa: BLE001 — the invariant itself
            cls = getattr(e, "failure_class", None)
            if cls is None:
                return RunOutcome(schedule, VIOLATION, None, None,
                                  f"unclassified exception: {e!r}")
            return RunOutcome(schedule, CLASSIFIED, cls, None, repr(e))
        if result.ok:
            if result.matches != self.oracle:
                return RunOutcome(
                    schedule, VIOLATION, None, result.matches,
                    f"silent wrong count: {result.matches} != oracle "
                    f"{self.oracle}")
            return RunOutcome(schedule, PASS, None, result.matches)
        cls = (result.diagnostics or {}).get("failure_class")
        if not cls or cls == "ok":
            return RunOutcome(schedule, VIOLATION, cls, result.matches,
                              "ok=False without a failure class")
        return RunOutcome(schedule, CLASSIFIED, cls, result.matches)


def _summary(runs: int, base_seed: int, verify: str, outcomes) -> dict:
    return {
        "runs": runs,
        "base_seed": base_seed,
        "verify": verify,
        "pass": sum(o.status == PASS for o in outcomes),
        "classified": sum(o.status == CLASSIFIED for o in outcomes),
        "violations": sum(o.status == VIOLATION for o in outcomes),
    }


def soak(runs: int, base_seed: int = 0, runner: Optional[ChaosRunner] = None,
         verify: str = "check",
         on_outcome: Optional[Callable[[RunOutcome], None]] = None):
    """N seeded schedules (seeds ``base_seed .. base_seed + runs - 1``)
    through one runner; returns ``(outcomes, summary)``.  Asserting the
    no-violation invariant is the caller's job."""
    runner = runner or ChaosRunner(verify=verify)
    outcomes = []
    for i in range(runs):
        out = runner.run(generate_schedule(base_seed + i))
        outcomes.append(out)
        if on_outcome:
            on_outcome(out)
    summary = _summary(runs, base_seed, runner.config.verify, outcomes)
    summary["failure_classes"] = sorted({o.failure_class for o in outcomes
                                         if o.failure_class})
    return outcomes, summary


#: the recovery soak's vocabulary: the join path's sites and the
#: membership sites (rank death and rank join, consulted at every phase
#: boundary: hit 1 is "start", 2 "sized", 3 on the attempts' "probe", so a
#: seeded hit is a seeded boundary) and ``compute.straggle`` (once a join)
RECOVERY_SITES: Tuple[str, ...] = CHAOS_SITES + (
    faults.RANK_DEATH, faults.RANK_JOIN, faults.COMPUTE_STRAGGLE)


def generate_recovery_schedule(seed: int) -> Schedule:
    """One ``membership.rank_death`` arm at a seeded boundary (``at`` in
    1..3), about half the time a ``membership.rank_join`` arm at its own
    (an admission around the death), about half a ``compute.straggle``
    (a slow rank racing the death: whichever fires first owns the abort),
    and 0-2 arms of :data:`CHAOS_SITES`."""
    rng = random.Random(seed)
    arms = [(faults.RANK_DEATH, (("at", rng.randint(1, 3)),))]
    if rng.random() < 0.5:
        arms.append((faults.RANK_JOIN, (("at", rng.randint(1, 3)),)))
    if rng.random() < 0.5:
        arms.append((faults.COMPUTE_STRAGGLE, (("at", 1),)))
    for site in rng.sample(CHAOS_SITES, rng.randint(0, 2)):
        at = rng.randint(1, 2) if site == faults.SHUFFLE_OVERFLOW else 1
        arms.append((site, (("at", at),)))
    return Schedule(seed=seed, arms=tuple(arms))


class RecoveryChaosRunner(ChaosRunner):
    """:class:`ChaosRunner` with the elastic path armed.

    The engine runs ``elastic``: a fired ``membership.rank_death`` must end
    in the oracle count (recovered, PASS), never a hang or an overclaim;
    an escaping loss still classifies as ``rank_lost``.  Network partitions
    default to 8 (``network_fanout_bits=3``): each recovered partition is
    its own masked out-of-core grid.  Every run gets a fresh one-lease
    membership view (``elastic_grow`` on, so ``membership.rank_join``
    admissions start from a clean epoch) and a fresh partition manifest
    (the hedge's fence), in a directory of its own under this runner's,
    each rank its own: every rank of a world runs the simulated
    single-process mesh of the JAX runner, and its counters equal JAX's.
    The straggle factor is seeded a schedule (``random.Random(
    f"{seed}:straggle")``) and hedging is on.  After every run the manifest
    is audited: a PASS whose winning lines do not sum to the oracle is a
    double count, a VIOLATION."""

    def __init__(self, num_nodes: int = 4, size: int = 1 << 11,
                 verify: str = "check", data_seed: int = 0,
                 config_overrides: Optional[Dict[str, Any]] = None,
                 bundle_dir: Optional[str] = None, device="cuda",
                 group=None):
        overrides = dict(config_overrides or {})
        overrides.setdefault("network_fanout_bits", 3)
        super().__init__(num_nodes=num_nodes, size=size, verify=verify,
                         data_seed=data_seed, config_overrides=overrides,
                         bundle_dir=bundle_dir, device=device, group=group)
        self.engine.elastic = True
        self.engine.elastic_grow = True
        self.engine.hedge = "on"
        self.engine.straggle_unit_s = 0.02   # a bounded soak
        self.audits: List[Dict[str, Any]] = []   # one manifest audit a run
        self._dir = tempfile.mkdtemp(prefix="tpu_rj_chaos_")

    def _bind(self, m) -> None:
        from tpu_radix_join_torch.robustness.checkpoint import (
            PartitionManifest)
        from tpu_radix_join_torch.robustness.membership import (
            LeaseBoard, MembershipView)
        self.engine.measurements = m
        # fresh membership and manifest a run: epochs, admissions and
        # fence lines must not leak across schedules (a long lease, so an
        # injected joiner's one lease never lapses)
        run_dir = os.path.join(self._dir, f"run{len(self.measurements)}")
        board = LeaseBoard(run_dir, rank=0, num_ranks=1, lease_s=300.0,
                           measurements=m)
        self.engine.membership = MembershipView(board, measurements=m)
        self.engine.partition_manifest = PartitionManifest(
            os.path.join(run_dir, "parts.manifest"),
            fingerprint={"chaos_oracle": self.oracle}, measurements=m)
        self.engine._straggler_detector = None

    def run(self, schedule: Schedule) -> RunOutcome:
        self.engine.straggle_factor = random.Random(
            f"{schedule.seed}:straggle").uniform(2.0, 6.0)
        out = super().run(schedule)
        aud = self.engine.partition_manifest.audit()
        self.audits.append(aud)
        if out.status == PASS and aud["total"] != self.oracle:
            out = dataclasses.replace(
                out, status=VIOLATION,
                detail=f"manifest double-count: winning lines sum to "
                       f"{aud['total']} != oracle {self.oracle} "
                       f"(fenced_duplicates={aud['fenced_duplicates']})")
            out = dataclasses.replace(out, bundle=_violation_bundle(
                self.measurements[-1], schedule, out.detail,
                self.bundle_dir))
        return out

    def close(self) -> None:
        """Remove the runs' lease and manifest directories."""
        shutil.rmtree(self._dir, ignore_errors=True)


def soak_recovery(runs: int, base_seed: int = 0,
                  runner: Optional[RecoveryChaosRunner] = None,
                  on_outcome: Optional[Callable[[RunOutcome], None]] = None):
    """N seeded recovery schedules through one elastic runner.  The
    summary adds the recovery signals to the base invariant's fields:
    ``ranklost``, ``rankjoin``, ``recovered_partitions``, ``max_epoch``,
    ``hedged`` / ``hedgewin`` / ``specwaste``, ``wdogtrip`` (which must
    stay 0: a recovered run never books a watchdog death) and
    ``manifest_exact``, the runs whose manifest audit summed to the
    oracle."""
    from tpu_radix_join_torch.performance.measurements import (
        HEDGED, HEDGEWIN, MEPOCH, RANKJOIN, RANKLOST, RECOVERN, SPECWASTE,
        WDOGTRIP)
    runner = runner or RecoveryChaosRunner()
    outcomes = []
    for i in range(runs):
        out = runner.run(generate_recovery_schedule(base_seed + i))
        outcomes.append(out)
        if on_outcome:
            on_outcome(out)
    regs = runner.measurements[-runs:]

    def total(key):
        return sum(int(m.counters.get(key, 0)) for m in regs)

    summary = _summary(runs, base_seed, runner.config.verify, outcomes)
    summary.update({
        "failure_classes": sorted({o.failure_class for o in outcomes
                                   if o.failure_class}),
        "ranklost": total(RANKLOST),
        "rankjoin": total(RANKJOIN),
        "hedged": total(HEDGED),
        "hedgewin": total(HEDGEWIN),
        "specwaste": total(SPECWASTE),
        "recovered_partitions": total(RECOVERN),
        "max_epoch": max((int(m.counters.get(MEPOCH, 0)) for m in regs),
                         default=0),
        "wdogtrip": total(WDOGTRIP),
        "manifest_exact": sum(
            a["total"] == runner.oracle
            for a in getattr(runner, "audits", [])[-runs:]),
    })
    return outcomes, summary


#: sites a resident serve loop consults a query: the dispatch outage
#: (service/session.py) and the engine's sites, and ``serve.cache_poison``
#: (a stored result-cache entry corrupted in place: the digest check must
#: drop it, so a poisoned cache can cause a miss, never a wrong count)
SESSION_SITES: Tuple[str, ...] = (
    faults.BACKEND_DISPATCH,
    faults.SHUFFLE_OVERFLOW,
    faults.EXCHANGE_CORRUPT,
    faults.CACHE_POISON,
)


def generate_session_schedule(seed: int, queries: int = 6) -> Schedule:
    """1-3 arms over :data:`SESSION_SITES`, each firing at a seeded query
    (every session site is consulted once a query, so the hit is the
    query's index)."""
    rng = random.Random(seed)
    sites = rng.sample(SESSION_SITES, rng.randint(1, len(SESSION_SITES)))
    arms = []
    for site in sites:
        arms.append((site, (("at", rng.randint(1, max(1, queries - 1))),)))
    return Schedule(seed=seed, arms=tuple(arms))


class SessionChaosRunner:
    """Runs fault schedules against a resident :class:`JoinSession` on
    ``device`` over ``group``.

    Each run streams ``queries`` requests through one fresh session while
    the arms fire at seeded queries.  The invariant is the service's
    failure isolation: every query ends in a classified outcome and the
    session survives the stream; an unclassified query, a silent wrong
    count or an exception out of the serve loop is a VIOLATION.  The
    breaker trips at once and never cools down (threshold 1, cooldown 0),
    so one ``backend.dispatch`` outage runs the trip, the degraded serve,
    the half-open probe and the close in one short stream."""

    def __init__(self, num_nodes: int = 4, size: int = 1 << 12,
                 verify: str = "check", queries: int = 6,
                 data_seed: int = 0,
                 config_overrides: Optional[Dict[str, Any]] = None,
                 bundle_dir: Optional[str] = None, device="cuda",
                 group=None):
        from tpu_radix_join_torch.core.config import (JoinConfig,
                                                      ServiceConfig)
        from tpu_radix_join_torch.performance.measurements import (
            Measurements)
        self._measurements_cls = Measurements
        self.bundle_dir = bundle_dir
        self.size = size
        self.queries = queries
        self.data_seed = data_seed
        self.device = device
        self.group = group
        self.config = JoinConfig(num_nodes=num_nodes, verify=verify,
                                 **(config_overrides or {}))
        # a live result cache (every lap shares its contents), which gives
        # the cache-poison arm a stored entry to corrupt
        self.service = ServiceConfig(breaker_threshold=1,
                                     breaker_cooldown_s=0.0,
                                     result_cache_max=4)
        self.measurements: List[Any] = []   # one registry a run, in order

    def run(self, schedule: Schedule) -> RunOutcome:
        out = self._run(schedule)
        if out.status == VIOLATION:
            out = dataclasses.replace(out, bundle=_violation_bundle(
                self.measurements[-1], schedule, out.detail,
                self.bundle_dir))
        return out

    def _run(self, schedule: Schedule) -> RunOutcome:
        from tpu_radix_join_torch.service import (UNCLASSIFIED, JoinSession,
                                                  QueryRequest)
        m = self._measurements_cls()
        self.measurements.append(m)
        inj = faults.FaultInjector(seed=schedule.seed, measurements=m)
        for site, kw in schedule.arm_dicts():
            inj.arm(site, **kw)
        session = JoinSession(self.config, self.service, measurements=m,
                              device=self.device, group=self.group)
        outs = []
        try:
            with inj:
                for i in range(self.queries):
                    # three contents in turn: the first lap executes, later
                    # laps hit the result cache, so the engine's arms and
                    # the cache-poison arm both see live consultations
                    request = QueryRequest(
                        query_id=f"q{i}", tuples_per_node=self.size,
                        seed=self.data_seed + (i % 3))
                    session.submit(request)
                    outs.append(session.run_next())
        except Exception as e:      # noqa: BLE001 — the invariant itself
            return RunOutcome(schedule, VIOLATION, None, None,
                              f"session died at query {len(outs)}: {e!r}")
        finally:
            session.close()
        detail = " ".join(f"{o.query_id}={o.status}/{o.failure_class}"
                          for o in outs)
        for o in outs:
            if o.failure_class == UNCLASSIFIED:
                return RunOutcome(schedule, VIOLATION, None, o.matches,
                                  f"unclassified query outcome: {detail}")
            if (o.status == "ok" and o.expected is not None
                    and o.matches != o.expected):
                return RunOutcome(
                    schedule, VIOLATION, None, o.matches,
                    f"silent wrong count on {o.query_id}: {o.matches} != "
                    f"oracle {o.expected} ({detail})")
        classes = sorted({o.failure_class for o in outs
                          if o.failure_class != "ok"})
        last_ok = next((o.matches for o in reversed(outs)
                        if o.status == "ok"), None)
        if not classes:
            return RunOutcome(schedule, PASS, None, last_ok, detail)
        return RunOutcome(schedule, CLASSIFIED, ",".join(classes),
                          last_ok, detail)


def soak_session(runs: int, base_seed: int = 0,
                 runner: Optional[SessionChaosRunner] = None,
                 verify: str = "check",
                 on_outcome: Optional[Callable[[RunOutcome], None]] = None):
    """N seeded session streams (:func:`generate_session_schedule`) through
    one :class:`SessionChaosRunner`; the return shape of :func:`soak`."""
    runner = runner or SessionChaosRunner(verify=verify)
    outcomes = []
    for i in range(runs):
        out = runner.run(generate_session_schedule(base_seed + i,
                                                   runner.queries))
        outcomes.append(out)
        if on_outcome:
            on_outcome(out)
    summary = _summary(runs, base_seed, runner.config.verify, outcomes)
    summary["queries_per_run"] = runner.queries
    summary["failure_classes"] = sorted({
        c for o in outcomes if o.failure_class
        for c in o.failure_class.split(",")})
    return outcomes, summary


def shrink(schedule: Schedule,
           violates: Callable[[Schedule], bool]) -> Schedule:
    """Greedy ddmin over arms: drop any arm whose removal keeps the
    schedule violating, to a fixpoint.  Every candidate is re-run (the
    decisions are seed-deterministic, so a kept reduction replays), which
    gives a 1-minimal repro."""
    if not violates(schedule):
        raise ValueError("shrink() needs a violating schedule to start from")
    shrunk = True
    while shrunk and len(schedule.arms) > 1:
        shrunk = False
        for i in range(len(schedule.arms)):
            cand = schedule.without(i)
            if violates(cand):
                schedule = cand
                shrunk = True
                break
    return schedule


def write_repro(outcome: RunOutcome, path) -> str:
    """Write a violating run's repro, the ``(seed, arms)`` pair and what
    went wrong, as one JSON line, and return the line (the soak command
    lines print it, so it outlives the file)."""
    line = json.dumps(outcome.to_json(), sort_keys=True)
    with open(path, "w") as f:
        f.write(line + "\n")
    return line


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
