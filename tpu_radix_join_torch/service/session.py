"""JoinSession: the resident, admission-controlled join service.

The port of ``tpu_radix_join/service/session.py``.  A one-shot command
pays the process start, the kernels' first load, the sizing pass and a
readback on every invocation; a :class:`JoinSession` keeps them warm
across many queries:

  * the **engine** — one ``HashJoin`` on the session's device (``cuda``
    unless the caller asks for ``cpu``), built once;
  * the **plan cache** (planner/cache.py) — the first query's converged
    window capacities warm-start every later query of the same shapes
    past the sizing pass (no JHIST);
  * **placed relations** — a small LRU of generated device inputs.

Three serving fast paths sit before the engine, in price order: the
result cache (a repeated query is answered with no execution), the delta
merge (an incremental query sorts only its Δ on K2 and merges it into a
device-resident sorted union, ``served_by="delta_merge"``) and, under a
batch window, micro-batching (queries of one signature served by one
fused K2 sort and probe, ``served_by="batched"``).  In front sit the
robustness pieces, each classified: the admission queue (bounded depth,
tenant quotas -> ``admission_rejected``), per-query deadlines enforced
between phases through the engine's ``cancel`` hook
(``deadline_exceeded``), and the circuit breaker, whose open state serves
from the degraded CPU engine (robustness/degrade.py): an explicit mode,
counted (QDEGRADED, a ``degrade`` event) and stamped on every outcome.
Two exits leave the device, and both are counted: the breaker's degraded
engine, and ``_execute_batched``'s isolation boundary, which retries a
failed fused group one query at a time (a ``batch_fallback`` event).
Every exception inside a query becomes a classified
:class:`QueryOutcome`; only construction errors and interrupts propagate.

**Over several ranks** (``group=``, one rank a GPU) every rank runs the
same session on the same request stream.  A host decision that precedes
a collective must be the same on every rank, so the session's clock is
rank 0's, broadcast at each read over a gloo group of the session's own
(deadlines, the breaker's cooldown and the cache's TTL then decide alike
everywhere), and a local step that can fail on one rank alone (placing a
relation, a fused program) ends with an exchange of errors, after which
every rank raises the first failing rank's.  The fused delta and batched
programs (unsharded in JAX, ``session.py:418-655``) run **on every
rank**, each on the whole relations, so every rank holds the same
resident unions and reports the same counts and outcomes; none of them
issues a collective.  The degraded CPU engine joins over the same gloo
group.

``ledger=`` (observability/ledger.py) appends one ``query`` row an
executed query.  The liveness and observability plane (ROADMAP A16b step
1, A18d): every executed query stamps its ``query_id`` and ``tenant`` into
the flight recorder's context; ``forensics_dir=`` writes a bundle for each
failed query (observability/postmortem.py) and sets the outcome's
``bundle``; :meth:`JoinSession.attach_heartbeat` starts a metrics sampler
whose tick carries the SLO, breaker and cache state (and, with
``membership=``, writes this rank's lease); :meth:`JoinSession.
attach_watchdog` starts a hang watchdog whose kill reaches the engine
through the session's cancel hook; the NCOMPILE delta of a query after
the first is the recompile-storm canary; with a span tracer attached to
the registry, each executed query's critical path (observability/
critpath.py, the tracer's window of that query) joins
``recent_critical_paths``, the last 8, which ``/statusz`` serves as
``critical_paths``.  ``membership=`` (a ``MembershipView``, over one rank
or several), ``elastic=True``, ``elastic_grow=`` and ``hedge=`` /
``hedge_threshold=`` are threaded onto every engine the session builds,
the degraded CPU engine too: the epoch keys the result cache and
residency and stamps the manifest's lines, and a query that loses a rank
is recovered on the survivors (ok and exact, ``query_recovered`` in the
registry, the lost ranks in the outcome's detail), regrown or hedged.
``partition_manifest=`` (robustness/checkpoint.PartitionManifest) is
threaded the same way, and each successful join records its partitions
there.  Over several ranks an attached watchdog's kill is rank 0's,
broadcast at every cancel point.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import pickle
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from tpu_radix_join_torch.core.config import (JoinConfig, ServiceConfig,
                                              _not_ported)
from tpu_radix_join_torch.data.tuples import (U32_MASK, lane_from_numpy,
                                              lane_to_numpy)
from tpu_radix_join_torch.performance.measurements import (
    BATCHN, BATCHQ, COMPILEMS, DELTAMERGE, JHIST, MEPOCH, NCOMPILE, QDEADLINE,
    QDEGRADED, QWARM, RANKLOST, RECOVERMS, RECOVERN)
from tpu_radix_join_torch.robustness import faults as _faults
from tpu_radix_join_torch.robustness.recovery import relation_inputs
from tpu_radix_join_torch.robustness.retry import (BACKEND_UNAVAILABLE,
                                                   DEADLINE_EXCEEDED, OK)
from tpu_radix_join_torch.service.admission import (AdmissionQueue,
                                                    AdmissionRejected)
from tpu_radix_join_torch.service.breaker import HALF_OPEN, CircuitBreaker
from tpu_radix_join_torch.service.deadline import Deadline, DeadlineExceeded
from tpu_radix_join_torch.service.resident import ResidentStateManager
from tpu_radix_join_torch.service.resultcache import (ResultCache,
                                                      content_fingerprint)
from tpu_radix_join_torch.service.slo import SLORecorder
from tpu_radix_join_torch.utils.hostsync import host_readback

#: unclassified-exception sentinel: a query that dies without a
#: failure_class still yields a terminal outcome (the session survives)
UNCLASSIFIED = "unclassified"


class BackendUnavailable(ConnectionError):
    """The device backend failed a query-time dispatch."""

    failure_class = BACKEND_UNAVAILABLE


class RankError(RuntimeError):
    """Another rank's exception, carried across ranks by its repr and
    failure class (for an exception that does not pickle)."""

    def __init__(self, message: str, failure_class: Optional[str] = None):
        super().__init__(message)
        self.failure_class = failure_class

    def __reduce__(self):
        return (RankError, (str(self), self.failure_class))


def _portable(exc: BaseException) -> BaseException:
    """``exc`` when it survives pickling, else a :class:`RankError`."""
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:   # noqa: BLE001 — any pickling failure
        return RankError(repr(exc), getattr(exc, "failure_class", None))


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """One join request as the serve loop admits it (JSONL line shape)."""

    query_id: str
    tenant: str = "default"
    tuples_per_node: int = 1 << 16
    outer_kind: str = "unique"          # unique | modulo | zipf
    modulo: Optional[int] = None
    zipf_theta: float = 0.75
    seed: int = 1234
    repeats: int = 1
    deadline_s: Optional[float] = None  # None -> ServiceConfig default
    #: incremental query: this many new tuples per node appended to the
    #: session-resident inner relation since the last query, served by the
    #: delta merge when residency is on (resident_budget_bytes > 0)
    delta_tuples_per_node: int = 0

    @classmethod
    def from_json(cls, obj: dict) -> "QueryRequest":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - fields
        if unknown:
            raise ValueError(f"unknown request fields: {sorted(unknown)}")
        if "query_id" not in obj:
            raise ValueError("request needs a query_id")
        return cls(**obj)


@dataclasses.dataclass
class QueryOutcome:
    """Terminal, classified verdict for one submitted query."""

    query_id: str
    tenant: str
    status: str                     # ok | failed | rejected
    failure_class: str              # "ok" when status == "ok"
    latency_ms: float
    matches: Optional[int] = None
    expected: Optional[int] = None
    engine: str = "primary"         # primary | cpu_fallback
    degraded: bool = False
    warm: bool = False              # sizing pass skipped (plan-cache hit)
    breaker_state: str = "closed"
    detail: str = ""
    bundle: Optional[str] = None    # forensics bundle path, failed queries
    #: the serving path of the answer: execute (full engine run),
    #: cache_hit, batched (fused multi-query program), delta_merge
    served_by: str = "execute"

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["latency_ms"] = round(self.latency_ms, 3)
        if out.get("bundle") is None:
            out.pop("bundle", None)
        return out


class JoinSession:
    """Resident engine + admission queue + breaker + SLO accounting.

    Single-threaded: one query at a time.  Construction builds the primary
    engine on ``device`` over ``group`` (a process group of
    ``config.num_nodes`` ranks, or None at one rank); ``submit`` /
    ``run_next`` / ``drain`` / ``run_next_batch`` serve queries;
    ``close`` releases what the session owns (idempotent)."""

    def __init__(self, config: JoinConfig,
                 service: Optional[ServiceConfig] = None,
                 measurements=None, plan_cache=None, profile: str = "h100",
                 clock: Callable[[], float] = time.monotonic,
                 device="cuda", group=None,
                 forensics_dir: Optional[str] = None,
                 ledger=None, membership=None, elastic: bool = False,
                 partition_manifest=None, elastic_grow: bool = False,
                 hedge: str = "off", hedge_threshold: float = 0.5):
        from tpu_radix_join_torch.operators.hash_join import HashJoin
        from tpu_radix_join_torch.parallel.world import make_world

        self.config = config
        #: the membership view (robustness/membership.py): its epoch keys
        #: the result cache and residency, every engine of the session
        #: scans it at the join's phase boundaries, and the lease it reads
        #: is this rank's liveness (:meth:`attach_heartbeat` writes it)
        self.membership = membership
        self.elastic = elastic
        #: growth and hedging, threaded onto every engine like the view: a
        #: session admits ranks (``elastic_grow``) and hedges stragglers
        #: (``hedge``, ``hedge_threshold``)
        self.elastic_grow = elastic_grow
        self.hedge = hedge
        self.hedge_threshold = hedge_threshold
        #: the partition manifest every engine of the session records its
        #: successful joins' partitions into (None: none)
        self.partition_manifest = partition_manifest
        #: failed queries drop a forensics bundle here
        #: (observability/postmortem.py), stamped with the query_id the
        #: flight recorder's context carried during the query
        self.forensics_dir = forensics_dir
        self.service = service or ServiceConfig()
        self.measurements = measurements
        #: the run ledger (observability/ledger.py): when set, every
        #: executed query appends one ``kind="query"`` row
        self.ledger = ledger
        self._cache_tmp = None
        if plan_cache is None:
            # a resident session warms by default: an ephemeral cache that
            # dies with the session
            import tempfile

            from tpu_radix_join_torch.planner import PlanCache, load_profile
            self._cache_tmp = tempfile.TemporaryDirectory(
                prefix="join_session_plan_cache_")
            plan_cache = PlanCache(self._cache_tmp.name,
                                   load_profile(profile),
                                   measurements=measurements)
        self.plan_cache = plan_cache
        self.engine = HashJoin(config, device=device, group=group,
                               measurements=measurements,
                               plan_cache=plan_cache)
        self._wire_elastic(self.engine)
        self.device = self.engine.device
        world = self.engine.world
        #: the gloo group of the session's own agreement and of the
        #: degraded engine (None at one rank)
        self._host_group = None
        if world.size > 1:
            import torch.distributed as dist
            self._host_group = dist.new_group(
                dist.get_process_group_ranks(group), backend="gloo")
        self._host_world = make_world(world.size, self._host_group)
        self._clock = (clock if world.size == 1 else
                       lambda: self._host_world.broadcast_object(clock()))
        self.queue = AdmissionQueue(self.service.max_queue_depth,
                                    self.service.tenant_quota,
                                    measurements=measurements)
        self.breaker = CircuitBreaker(self.service.breaker_threshold,
                                      self.service.breaker_cooldown_s,
                                      clock=self._clock,
                                      measurements=measurements)
        self.slo = SLORecorder()
        self._cpu_engine = None         # built on the first open-state query
        self._place_cache: "collections.OrderedDict" = \
            collections.OrderedDict()
        #: whole-query reuse keyed by content fingerprint (disabled unless
        #: result_cache_max > 0)
        self.result_cache = ResultCache(self.service.result_cache_max,
                                        self.service.result_cache_ttl_s,
                                        measurements=measurements,
                                        clock=self._clock)
        #: device-resident sorted inner lanes for the delta merge (disabled
        #: unless resident_budget_bytes > 0)
        self.resident = ResidentStateManager(
            self.service.resident_budget_bytes, measurements=measurements)
        #: host mirror of each resident lane's key multiset: the exactness
        #: oracle of incremental queries
        self._resident_host: Dict = {}
        #: per-relation incremental-probe state: the outer spec the running
        #: totals were accumulated under, the running total and oracle, and
        #: the host-sorted outer lane (its device twin lives in
        #: ``self.resident`` under a ("probe", ...) key)
        self._resident_probe: Dict = {}
        self.batches_fused = 0          # fused device programs dispatched
        self.batch_queries_fused = 0    # queries served through them
        self._recompile_storms = 0
        self._sampler = None            # attached heartbeat, owned if set
        self._watchdog = None           # attached hang watchdog, owned
        self._watchdog_kw: Optional[dict] = None
        #: the watchdog's verdict waiting for the running query's next
        #: cancel point (:meth:`kill`), and that query's deadline
        self._killed: Optional[BaseException] = None
        self._deadline: Optional[Deadline] = None
        #: one heartbeat of this rank's lease a sampler tick
        self._lease_extra = (None if membership is None else
                             membership.board.sampler_extra(
                                 epoch_of=membership.epoch_of,
                                 status_of=membership.my_status))
        self._closed = False
        #: recent outcomes only; the SLO recorder owns the aggregates
        self.outcomes: "collections.deque" = collections.deque(
            maxlen=self.service.outcomes_keep)
        #: the last 8 executed queries' critical paths, each the attached
        #: tracer's window of its query (``/statusz`` critical_paths)
        self.recent_critical_paths: "collections.deque" = \
            collections.deque(maxlen=8)

    # ----------------------------------------------------------- agreement
    def _agreed(self, fn: Callable):
        """``fn()``, a step that may fail on one rank alone; over several
        ranks the ranks then exchange their errors, and every rank raises
        the first failing rank's (that rank its own), so none is left in a
        collective the others skipped."""
        world = self._host_world
        if world.size == 1:
            return fn()
        out, err = None, None
        try:
            out = fn()
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:          # noqa: BLE001 — exchanged below
            err = e
        errs = world.gather_objects(None if err is None else _portable(err))
        first = next((i for i, e in enumerate(errs) if e is not None), None)
        if first is not None:
            if first == world.rank:
                raise err
            raise errs[first]
        return out

    # ----------------------------------------------------------- admission
    def submit(self, request: QueryRequest) -> None:
        """Admit ``request`` or raise :class:`AdmissionRejected` (already
        SLO-accounted; :meth:`rejection_outcome` makes its outcome)."""
        if self._closed:
            raise RuntimeError("session is closed")
        try:
            self.queue.submit(request)
        except AdmissionRejected:
            self.slo.record_rejection()
            raise

    def rejection_outcome(self, request: QueryRequest,
                          exc: AdmissionRejected) -> QueryOutcome:
        out = QueryOutcome(
            query_id=request.query_id, tenant=request.tenant,
            status="rejected", failure_class=exc.failure_class,
            latency_ms=0.0, breaker_state=self.breaker.state,
            detail=f"{exc.reason}: {exc}")
        self.outcomes.append(out)
        return out

    # ------------------------------------------------------------- serving
    def run_next(self) -> Optional[QueryOutcome]:
        """Serve the oldest admitted query; None when the queue is empty.
        The tenant's slot is released on every outcome path."""
        request = self.queue.pop()
        if request is None:
            return None
        try:
            return self._serve_one(request)
        finally:
            self.queue.done(request)

    def _serve_one(self, request: QueryRequest) -> QueryOutcome:
        hit = self.try_cache(request)
        if hit is not None:
            return hit
        if request.delta_tuples_per_node > 0:
            return self._execute_delta(request)
        out = self._execute(request)
        self._cache_put(request, out)
        return out

    def drain(self, on_outcome: Optional[Callable] = None,
              batched: Optional[bool] = None) -> List[QueryOutcome]:
        """Serve every admitted query; ``batched`` (default: whether a
        batch window is set) groups co-batchable queued queries into fused
        programs through :meth:`run_next_batch`."""
        if batched is None:
            batched = self.service.batch_window_ms > 0
        outs = []
        while True:
            batch = (self.run_next_batch() if batched
                     else _as_list(self.run_next()))
            if not batch:
                return outs
            for out in batch:
                outs.append(out)
                if on_outcome is not None:
                    on_outcome(out)

    def run_next_batch(self) -> List[QueryOutcome]:
        """Pop the oldest admitted query and every queued query that can
        share its fused program (same :func:`batch_signature`, up to
        ``batch_max_queries``), and serve them as one; a singleton takes
        the normal tiers; [] when the queue is empty."""
        from tpu_radix_join_torch.service.microbatch import batch_signature
        first = self.queue.pop()
        if first is None:
            return []
        group = [first]
        try:
            if (self.service.batch_window_ms > 0
                    and first.delta_tuples_per_node == 0):
                sig = batch_signature(first)
                group += self.queue.pop_matching(
                    lambda r: (batch_signature(r) == sig
                               and r.delta_tuples_per_node == 0),
                    self.service.batch_max_queries - 1)
            if len(group) == 1:
                return [self._serve_one(first)]
            return self._execute_batched(group)
        finally:
            for request in group:
                self.queue.done(request)

    # ----------------------------------------------------- result cache tier
    def _epoch(self) -> Optional[int]:
        return self.membership.epoch if self.membership is not None else None

    def _content_fp(self, request: QueryRequest) -> str:
        return content_fingerprint(
            request, config_fp=dataclasses.asdict(self.config),
            epoch=self._epoch())

    def try_cache(self, request: QueryRequest) -> Optional[QueryOutcome]:
        """Serve ``request`` from the result cache without executing, or
        None on a miss.  Callers may short-circuit before admission: a hit
        never takes a queue slot or a tenant quota.  Incremental queries
        never cache-serve (their answer depends on session state)."""
        if (self.result_cache.max_entries == 0
                or request.delta_tuples_per_node > 0):
            return None
        t0 = time.perf_counter()
        payload = self.result_cache.get(self._content_fp(request),
                                        epoch=self._epoch())
        if payload is None:
            return None
        out = QueryOutcome(
            query_id=request.query_id, tenant=request.tenant,
            status="ok", failure_class=OK,
            latency_ms=(time.perf_counter() - t0) * 1e3,
            matches=payload.get("matches"), expected=payload.get("expected"),
            engine=payload.get("engine", "primary"),
            warm=True, breaker_state=self.breaker.state,
            detail="result cache hit", served_by="cache_hit")
        self.slo.record(request.tenant, out.latency_ms, ok=True)
        self.outcomes.append(out)
        return out

    def _cache_put(self, request: QueryRequest, out: QueryOutcome) -> None:
        """Store a clean primary success for future content hits."""
        if (self.result_cache.max_entries == 0
                or request.delta_tuples_per_node > 0
                or out.status != "ok" or out.degraded
                or out.matches is None):
            return
        self.result_cache.put(
            self._content_fp(request),
            {"matches": out.matches, "expected": out.expected,
             "engine": out.engine},
            epoch=self._epoch())

    # ------------------------------------------------------ micro-batch tier
    def _host_lanes(self, request: QueryRequest):
        """(inner key lane, outer key lane, exact expected count, key
        bound) of one request's whole relations: the fast paths run on key
        lanes, not the distributed pipeline.  The lanes are generated on
        the session's device (the bits of the JAX package's host arm); the
        oracle without a closed form counts on the host."""
        from tpu_radix_join_torch.data.relation import host_join_count
        inner, outer, expected = self._relations(request)
        r_keys = inner.generate(self.device).key
        s_keys = outer.generate(self.device).key
        if expected is None:
            expected = host_join_count(lane_to_numpy(r_keys),
                                       lane_to_numpy(s_keys))
        return r_keys, s_keys, expected, max(inner.key_bound(),
                                             outer.key_bound())

    def _execute_batched(self, group: List[QueryRequest]
                         ) -> List[QueryOutcome]:
        """Serve ``group`` (>= 2 same-signature queries) through one fused
        program (ops/merge_delta.batched_merge_count: one K2 sort, one
        probe): per-query counts stay exact through the composite query
        tag.  Any error inside the fused path retries the whole group one
        query at a time (a ``batch_fallback`` event), so a poisoned query
        classifies alone."""
        from tpu_radix_join_torch.ops.merge_delta import (
            batch_feasible, compiled_batched_merge_count)
        m = self.measurements
        svc = self.service
        t0 = time.perf_counter()

        def deadlines():
            out = []
            for request in group:
                budget = (request.deadline_s if request.deadline_s is not None
                          else svc.default_deadline_s)
                deadline = Deadline(budget, clock=self._clock)
                deadline.check("admitted")
                out.append(deadline)
            return out

        def fused():
            lanes = [self._host_lanes(r) for r in group]
            key_bound = max(kb for _, _, _, kb in lanes)
            if not batch_feasible(len(group), key_bound):
                raise ValueError(
                    f"batch of {len(group)} at key_bound {key_bound} "
                    f"overflows the composite word")
            r_sizes = tuple(int(rk.numel()) for rk, _, _, _ in lanes)
            s_sizes = tuple(int(sk.numel()) for _, sk, _, _ in lanes)
            fn = compiled_batched_merge_count(r_sizes, s_sizes, key_bound)
            r_cat = torch.cat([rk for rk, _, _, _ in lanes])
            s_cat = torch.cat([sk for _, sk, _, _ in lanes])
            for _ in range(max(1, group[0].repeats)):
                counts = fn(r_cat, s_cat, sort_impl=self.config.sort_impl)
            return [e for _, _, e, _ in lanes], lane_to_numpy(counts)

        try:
            # the deadlines read the clock, which is rank 0's over several
            # ranks: every rank decides alike, outside the agreed step
            dls = deadlines()
            expected, counts = self._agreed(fused)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:           # noqa: BLE001 — isolation boundary
            if m is not None:
                m.event("batch_fallback", size=len(group),
                        error=repr(e)[:200])
            return [self._serve_one(r) for r in group]
        latency_ms = (time.perf_counter() - t0) * 1e3
        self.batches_fused += 1
        self.batch_queries_fused += len(group)
        if m is not None:
            m.incr(BATCHN)
            m.incr(BATCHQ, len(group))
        outs = []
        for request, exp, deadline, n in zip(group, expected, dls, counts):
            status, cls, detail = "ok", OK, f"fused batch of {len(group)}"
            try:
                deadline.check("batched")
            except DeadlineExceeded as e:
                status, cls, detail = "failed", DEADLINE_EXCEEDED, str(e)
                if m is not None:
                    m.incr(QDEADLINE)
            out = QueryOutcome(
                query_id=request.query_id, tenant=request.tenant,
                status=status, failure_class=cls, latency_ms=latency_ms,
                matches=int(n), expected=int(exp),
                breaker_state=self.breaker.state, detail=detail,
                served_by="batched")
            self.slo.record(request.tenant, latency_ms,
                            ok=(status == "ok"),
                            failure_class=None if cls == OK else cls)
            self.outcomes.append(out)
            if status == "ok":
                self._cache_put(request, out)
            outs.append(out)
        return outs

    # ------------------------------------------------------ delta-merge tier
    def _delta_keys(self, start: int, count: int, seed: int) -> np.ndarray:
        """The Δ new inner keys appended at mirror length ``start``: fresh
        keys in [start, start + count), shuffled by numpy's seeded
        generator (the JAX package's bits), disjoint from the resident
        union (the base is a unique permutation of [0, N))."""
        from tpu_radix_join_torch.ops.merge_delta import MAX_SERVE_KEY
        if start + count > MAX_SERVE_KEY:
            raise ValueError(
                f"resident union would reach {start + count}, past the "
                f"presorted-probe key ceiling {MAX_SERVE_KEY}")
        keys = np.arange(start, start + count, dtype=np.uint32)
        np.random.default_rng(seed + start).shuffle(keys)
        return keys

    def _execute_delta(self, request: QueryRequest) -> QueryOutcome:
        """Serve one incremental query: sort only the Δ lane (K2), merge
        it into the device-resident sorted union and probe — O(N+Δ)
        (``served_by="delta_merge"``).  A cold relation (first sight, or
        evicted under the byte budget) pays one full sort (K2) and seeds
        residency (``served_by="execute"``).  The oracle is a host mirror
        of the union, counted by numpy."""
        from tpu_radix_join_torch.data.relation import host_join_count
        from tpu_radix_join_torch.ops.merge_count import (
            merge_count_presorted, presort_keys)
        from tpu_radix_join_torch.ops.merge_delta import (
            compiled_delta_merge_count, compiled_delta_merge_increment)
        m = self.measurements
        svc = self.service
        dev = self.device
        t0 = time.perf_counter()
        status, cls, detail, served_by = "ok", OK, "", "execute"
        matches = expected = None
        try:
            budget = (request.deadline_s if request.deadline_s is not None
                      else svc.default_deadline_s)
            deadline = Deadline(budget, clock=self._clock)
            deadline.check("admitted")
            inner, outer, _ = self._relations(request)
            nodes = self.config.num_nodes
            delta_n = request.delta_tuples_per_node * nodes
            rkey = ("delta", inner.global_size, request.seed,
                    request.tuples_per_node)
            epoch = self._epoch()
            rprobe = ("probe", inner.global_size, request.seed,
                      request.tuples_per_node)
            outer_fp = (request.outer_kind, request.modulo,
                        request.zipf_theta, request.repeats,
                        outer.global_size)
            lane = self.resident.get(rkey, epoch)
            mirror = self._resident_host.get(rkey)
            if lane is None and mirror is not None:
                # lane evicted but the mirror survives: rebuild residency
                # with one full sort and drop the running probe totals
                mirror = None
                self._resident_host.pop(rkey, None)
                self._resident_probe.pop(rkey, None)
            base_len = len(mirror) if mirror is not None else inner.global_size
            delta_np = self._delta_keys(base_len, delta_n, request.seed)
            probe = s_lane = None
            if lane is not None:     # (a lookup refreshes the LRU order)
                probe = self._resident_probe.get(rkey)
                s_lane = self.resident.get(rprobe, epoch)
            incremental = (probe is not None
                           and probe["outer_fp"] == outer_fp
                           and probe["union_len"] == base_len
                           and s_lane is not None)
            # the outer lane is generated only where it is probed: the
            # incremental path counts the Δ against the resident sorted
            # outer lane alone
            s_dev = s_host = None
            if not incremental:
                def outer_lanes():
                    keys = outer.generate(dev).key
                    return keys, np.sort(lane_to_numpy(keys))
                s_dev, s_host = self._agreed(outer_lanes)
            deadline.check("generated")

            def merged():
                """(union, matches, expected, mirror, probe or None): the
                device work and its host oracle."""
                delta = lane_from_numpy(delta_np, dev)
                if lane is None:
                    base = inner.generate(dev).key
                    mirror2 = np.concatenate([lane_to_numpy(base), delta_np])
                    union = presort_keys(torch.cat([base, delta]),
                                         self.config.sort_impl)
                    n = int(host_readback(
                        merge_count_presorted(union, s_dev))) & U32_MASK
                    return (union, n, host_join_count(mirror2, s_host),
                            mirror2, None)
                mirror2 = np.concatenate([mirror, delta_np])
                if incremental:
                    # unchanged outer: probe only the Δ against the
                    # resident sorted outer lane (counts are additive)
                    fn = compiled_delta_merge_increment(
                        lane.numel(), delta.numel(), s_lane.numel())
                    union, inc = fn(lane, delta, s_lane,
                                    sort_impl=self.config.sort_impl)
                    ds = np.sort(delta_np)
                    sh = probe["s_sorted_host"]
                    exp = probe["expected"] + int(
                        (np.searchsorted(sh, ds, side="right")
                         - np.searchsorted(sh, ds, side="left")).sum())
                    return (union,
                            probe["total"] + (int(host_readback(inc))
                                              & U32_MASK),
                            exp, mirror2, probe)
                fn = compiled_delta_merge_count(lane.numel(), delta.numel(),
                                                s_dev.numel())
                union, total = fn(lane, delta, s_dev,
                                  sort_impl=self.config.sort_impl)
                return (union, int(host_readback(total)) & U32_MASK,
                        host_join_count(mirror2, s_host), mirror2, None)

            union, matches, expected, mirror, probe = self._agreed(merged)
            seed_probe = probe is None
            if lane is None:
                detail = "cold relation: full sort seeded residency"
            else:
                if not seed_probe:
                    detail = ("incremental probe: Δ counted against the "
                              "resident sorted outer lane")
                self.resident.note_merge(rkey)
                served_by = "delta_merge"
                if m is not None:
                    m.incr(DELTAMERGE)
            deadline.check("merged")

            def keep():
                self.resident.put(rkey, union, epoch)
                self._resident_host[rkey] = mirror
                if seed_probe and self.resident.budget_bytes:
                    # (re)seed the incremental-probe state under the same
                    # budget; with residency off the outer is never sorted
                    if self.resident.put(rprobe, presort_keys(
                            s_dev, self.config.sort_impl), epoch):
                        self._resident_probe[rkey] = {
                            "outer_fp": outer_fp, "union_len": len(mirror),
                            "total": matches, "expected": expected,
                            "s_sorted_host": s_host}
                    else:
                        self._resident_probe.pop(rkey, None)
                elif not seed_probe:
                    probe["union_len"] = len(mirror)
                    probe["total"] = matches
                    probe["expected"] = expected

            self._agreed(keep)
        except DeadlineExceeded as e:
            status, cls, detail = "failed", DEADLINE_EXCEEDED, str(e)
            if m is not None:
                m.incr(QDEADLINE)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:           # noqa: BLE001 — isolation boundary
            status = "failed"
            cls = getattr(e, "failure_class", None) or UNCLASSIFIED
            detail = repr(e)[:500]
            if m is not None:
                m.event("query_failed", query_id=request.query_id,
                        failure_class=cls, error=repr(e)[:200])
        latency_ms = (time.perf_counter() - t0) * 1e3
        out = QueryOutcome(
            query_id=request.query_id, tenant=request.tenant,
            status=status, failure_class=cls, latency_ms=latency_ms,
            matches=matches, expected=expected,
            breaker_state=self.breaker.state, detail=detail,
            served_by=served_by)
        self.slo.record(request.tenant, latency_ms, ok=(status == "ok"),
                        failure_class=None if cls == OK else cls)
        self.outcomes.append(out)
        return out

    # ------------------------------------------------------------ internals
    def _wire_elastic(self, engine) -> None:
        """Thread the session's membership view, elastic flags and
        partition manifest onto an engine (``_wire_elastic``,
        session.py:655-666): the primary at construction, the CPU engine
        when it is built, so a rank loss seen on either path fences
        both."""
        engine.membership = self.membership
        engine.elastic = self.elastic
        engine.partition_manifest = self.partition_manifest
        engine.elastic_grow = self.elastic_grow
        engine.hedge = self.hedge
        engine.hedge_threshold = self.hedge_threshold

    def _degraded_engine(self):
        """The CPU engine, built once on first use (the breaker's
        open-state serving path, robustness/degrade.py), over the
        session's gloo group when it has several ranks."""
        if self._cpu_engine is None:
            from tpu_radix_join_torch.robustness.degrade import (
                build_cpu_engine)
            self._cpu_engine, info = build_cpu_engine(
                self.config, measurements=self.measurements,
                plan_cache=self.plan_cache, host_group=self._host_group)
            self._wire_elastic(self._cpu_engine)
            m = self.measurements
            if m is not None:
                m.event("degrade", to="cpu", num_nodes=info["num_nodes"],
                        reason="breaker_open")
        return self._cpu_engine

    def _relations(self, request: QueryRequest):
        """(inner, outer, expected) for the request's workload: the CLI's
        construction, sized by the session's config."""
        from tpu_radix_join_torch.data.relation import Relation

        nodes = self.config.num_nodes
        global_size = request.tuples_per_node * nodes
        inner = Relation(global_size, nodes, "unique", seed=request.seed)
        outer_kw = {}
        if request.outer_kind == "modulo":
            outer_kw["modulo"] = request.modulo or max(1, global_size // 4)
        elif request.outer_kind == "zipf":
            outer_kw["zipf_theta"] = request.zipf_theta
            outer_kw["key_domain"] = global_size
        outer = Relation(global_size, nodes, request.outer_kind,
                         seed=request.seed + 1, **outer_kw)
        return inner, outer, inner.expected_matches(outer)

    def _place(self, engine, rel, tag: str, request: QueryRequest):
        """Placed-batch LRU: re-serving a workload skips its generation."""
        key = (id(engine), tag, rel.global_size, rel.kind, request.seed,
               request.outer_kind, request.modulo, request.zipf_theta)
        if key in self._place_cache:
            self._place_cache.move_to_end(key)
            return self._place_cache[key]
        batch = engine.place(rel)
        self._place_cache[key] = batch
        while len(self._place_cache) > self.service.place_cache_max:
            self._place_cache.popitem(last=False)
        return batch

    def placed_bytes(self) -> int:
        """Device bytes held by the placed-relation LRU."""
        return sum(int(lane.nbytes) for batch in self._place_cache.values()
                   for lane in batch if lane is not None)

    def _execute(self, request: QueryRequest) -> QueryOutcome:
        m = self.measurements
        svc = self.service
        budget = (request.deadline_s if request.deadline_s is not None
                  else svc.default_deadline_s)
        deadline = Deadline(budget, clock=self._clock)
        primary = self.breaker.allow_primary()
        probing = primary and self.breaker.state == HALF_OPEN
        engine = self.engine if primary else self._degraded_engine()
        tracer = m.tracer if m is not None else None
        win0_us = tracer.now_us() if tracer is not None else None
        t0 = time.perf_counter()
        jhist0 = m.times_us.get(JHIST, 0.0) if m is not None else 0.0
        nc0 = m.counters.get(NCOMPILE, 0) if m is not None else 0
        completed_before = self.slo.completed
        span = (m.span("query", query_id=request.query_id,
                       tenant=request.tenant,
                       engine="primary" if primary else "cpu_fallback",
                       probe=probing)
                if m is not None else contextlib.nullcontext())
        self._deadline = deadline
        engine.cancel = self._cancel
        if m is not None:
            # every ring record inside this query carries its query_id: a
            # bundle cut mid-query attributes its evidence
            m.flightrec.set_context(query_id=request.query_id,
                                    tenant=request.tenant)
        status, cls, detail = "ok", OK, ""
        matches = expected = bundle = None
        try:
            with span:
                if primary and _faults.fires(_faults.BACKEND_DISPATCH, m):
                    # an injectable per-query backend outage; its
                    # production twin is the mapping of raw connection
                    # errors below
                    raise BackendUnavailable(
                        f"injected backend outage (query "
                        f"{request.query_id})")
                deadline.check("admitted")
                inner, outer, expected = self._relations(request)
                deadline.check("generated")
                r_batch, s_batch = self._agreed(lambda: (
                    self._place(engine, inner, "r", request),
                    self._place(engine, outer, "s", request)))
                deadline.check("placed")
                # an elastic recovery regenerates the query's relations on
                # the host, never from the group's tensors
                engine.elastic_inputs = relation_inputs(inner, outer)
                try:
                    result = engine.join_arrays(
                        r_batch, s_batch,
                        key_bound=max(inner.key_bound(), outer.key_bound()),
                        repeats=request.repeats)
                finally:
                    engine.elastic_inputs = None
                matches = result.matches
                cls = (result.diagnostics or {}).get(
                    "failure_class") or (OK if result.ok else UNCLASSIFIED)
                status = "ok" if result.ok else "failed"
                if (result.diagnostics or {}).get("recovered"):
                    # a rank loss the elastic path absorbed: the outcome is
                    # ok and exact, and the mesh change is evidence
                    if m is not None:
                        m.event("query_recovered",
                                query_id=request.query_id,
                                epoch=result.diagnostics.get(
                                    "membership_epoch"),
                                lost_ranks=result.diagnostics.get(
                                    "lost_ranks"))
                    detail = ("recovered from rank loss: "
                              + str(result.diagnostics.get(
                                    "lost_ranks")))[:500]
                if status == "failed":
                    detail = str({k: v for k, v in
                                  (result.diagnostics or {}).items()
                                  if k != "failure_class"})[:500]
        except DeadlineExceeded as e:
            status, cls, detail = "failed", DEADLINE_EXCEEDED, str(e)
            if m is not None:
                m.incr(QDEADLINE)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:           # noqa: BLE001 — isolation boundary
            status = "failed"
            cls = getattr(e, "failure_class", None)
            if cls is None and isinstance(
                    e, (ConnectionError, TimeoutError, OSError)):
                # a raw transport error is the production form of
                # backend_unavailable
                cls = BACKEND_UNAVAILABLE
            if cls is None:
                cls = UNCLASSIFIED
            detail = repr(e)[:500]
            # a watchdog's verdict carries the bundle it wrote at the trip
            bundle = getattr(e, "bundle", None)
            if m is not None:
                m.event("query_failed", query_id=request.query_id,
                        failure_class=cls, error=repr(e)[:200])
        finally:
            engine.cancel = None
            self._end_query_watch(request)
        latency_ms = (time.perf_counter() - t0) * 1e3
        trips0 = self.breaker.trips
        # warm = the sizing pass did not run this query (a plan-cache hit):
        # the JHIST column did not move
        warm = (status == "ok" and m is not None
                and m.times_us.get(JHIST, 0.0) == jhist0
                and self.slo.completed > 0)
        if m is not None:
            if warm:
                m.incr(QWARM)
            if not primary:
                m.incr(QDEGRADED)
        if primary:
            if cls == OK:
                self.breaker.record_success()
            else:
                self.breaker.record_failure(cls)
        if status == "failed" and self.forensics_dir and bundle is None:
            reason = ("breaker_trip" if self.breaker.trips > trips0
                      else ("deadline_exceeded" if cls == DEADLINE_EXCEEDED
                            else "query_failed"))
            bundle = self._write_bundle(request, reason, cls, detail)
        # the recompile-storm canary: NCOMPILE rising after the session
        # has completed queries means a kernel library loaded mid-service
        # (observability/compilemon.py: a first-use build, which a warm
        # session has already paid)
        nc_delta = (m.counters.get(NCOMPILE, 0) - nc0) if m is not None else 0
        if nc_delta and completed_before > 0:
            self._recompile_storms += 1
            if m is not None:
                m.event("recompile_storm", query_id=request.query_id,
                        ncompile_delta=nc_delta,
                        completed=completed_before)
            if self._recompile_storms <= 3:      # warn, don't spam
                print(f"[OBS] recompile storm: query {request.query_id} "
                      f"triggered {nc_delta} kernel build(s) after "
                      f"{completed_before} completed queries",
                      file=sys.stderr)
        if m is not None:
            m.flightrec.clear_context("query_id", "tenant")
        out = QueryOutcome(
            query_id=request.query_id, tenant=request.tenant,
            status=status, failure_class=cls, latency_ms=latency_ms,
            matches=matches, expected=expected,
            engine="primary" if primary else "cpu_fallback",
            degraded=not primary, warm=warm,
            breaker_state=self.breaker.state, detail=detail,
            bundle=bundle)
        self.slo.record(request.tenant, latency_ms, ok=(status == "ok"),
                        failure_class=None if cls == OK else cls,
                        degraded=not primary)
        self.outcomes.append(out)
        if tracer is not None:
            # the query's own critical path, its window of the resident
            # tracer's stream; a path failure is an event, never the
            # query's
            try:
                from tpu_radix_join_torch.observability.critpath import (
                    critical_path_from_tracer)
                cp = critical_path_from_tracer(
                    tracer, window_us=(win0_us, tracer.now_us()))
                cp["query_id"] = request.query_id
                self.recent_critical_paths.append(cp)
            except Exception as e:   # noqa: BLE001 — isolation boundary
                m.event("critpath_error", error=repr(e)[:200])
        if self.ledger is not None:
            # a ledger write failure is an event, never the query's
            try:
                self.ledger.append("query", {
                    "query_id": request.query_id, "tenant": request.tenant,
                    "trace_id": (m.meta.get("trace_id")
                                 if m is not None else None),
                    "status": status, "failure_class": cls,
                    "latency_ms": round(latency_ms, 3),
                    "warm": warm, "engine": out.engine,
                    "tuples_per_node": request.tuples_per_node,
                    "repeats": request.repeats,
                    "ncompile": nc_delta or None})
            except Exception as e:   # noqa: BLE001 — isolation boundary
                if m is not None:
                    m.event("ledger_error", error=repr(e)[:200])
        return out

    def _write_bundle(self, request: QueryRequest, reason: str,
                      cls: str, detail: str) -> Optional[str]:
        """Forensics bundle of one failed query; a write error is an event
        on the registry, never a new failure for the query."""
        try:
            from tpu_radix_join_torch.observability.postmortem import (
                write_bundle)
            return write_bundle(
                self.forensics_dir, self.measurements, reason=reason,
                failure_class=cls, config=self.config,
                extra={"query_id": request.query_id,
                       "tenant": request.tenant,
                       "breaker_state": self.breaker.state,
                       "detail": detail})
        except Exception as e:     # noqa: BLE001 — forensics must not mask
            if self.measurements is not None:
                self.measurements.event("bundle_error", error=repr(e)[:200])
            return None

    # ------------------------------------------------------------ watchdog
    def kill(self, exc: BaseException) -> None:
        """The watchdog's kill path: ``exc`` is raised at the running
        query's next cancel point (a phase boundary or the ``backend.stall``
        poll), before its deadline is consulted — the hang's verdict
        outranks the budget clock, as JAX's ``engine_killer`` rebinding
        does.  The verdict waits on the session, not on the engine's hook,
        so resetting the hook cannot drop it while the query runs."""
        self._killed = exc

    def _cancel(self, phase: str) -> None:
        """The engine's cancel hook while a query runs.  Over several ranks
        with a watchdog attached the kill is one decision: rank 0's,
        broadcast over the session's gloo group, every rank dropping its
        own."""
        exc = self._killed
        if self._watchdog is not None and self._host_world.size > 1:
            exc = self._host_world.broadcast_object(
                None if exc is None else _portable(exc))
            self._killed = None
        if exc is not None:
            self._killed = None
            raise exc
        if self._deadline is not None:
            self._deadline.check(phase)

    def _end_query_watch(self, request: QueryRequest) -> None:
        """After a query: a tripped watchdog is joined (its kill is then
        delivered or pending) and a fresh one armed for the next query; a
        kill no cancel point took (the query had passed its last one) is
        recorded and dropped, and never reaches the next query."""
        self._deadline = None
        wd = self._watchdog
        if wd is not None and wd.tripped:
            wd.stop()
            self._watchdog = self._new_watchdog()
        if self._killed is not None:
            self._killed = None
            if self.measurements is not None:
                self.measurements.event("watchdog_kill_undelivered",
                                        query_id=request.query_id)

    def _new_watchdog(self):
        from tpu_radix_join_torch.observability.watchdog import Watchdog
        return Watchdog(self.measurements, kill=self.kill,
                        bundle_dir=self.forensics_dir,
                        membership=self.membership, config=self.config,
                        **self._watchdog_kw).start()

    def attach_watchdog(self, timeout_s: float,
                        poll_s: Optional[float] = None):
        """Start a hang watchdog owned by this session (stopped by
        :meth:`close`; observability/watchdog.py): a query whose registry
        records nothing for ``timeout_s`` with a phase open ends as
        ``backend_unavailable``, its bundle (with every thread's stack, in
        ``forensics_dir``) on the outcome; the watchdog is re-armed for the
        next query.  A second call replaces the watchdog.  Over several
        ranks every rank attaches its own, and a kill is rank 0's
        watchdog's verdict, broadcast at each cancel point (as the stall
        cap is), so every rank cancels at the same boundary."""
        if self.measurements is None:
            raise ValueError("the watchdog reads the registry's flight "
                             "recorder: pass measurements=")
        if self._watchdog is not None:
            self._watchdog.stop()
        self._watchdog_kw = {"timeout_s": float(timeout_s),
                             "poll_s": poll_s}
        self._watchdog = self._new_watchdog()
        return self._watchdog

    # ----------------------------------------------------------- lifecycle
    def attach_heartbeat(self, path: str, interval_s: float):
        """Start a metrics heartbeat owned by this session (stopped by
        :meth:`close`): every tick carries the SLO, breaker, queue and
        cache state beside the counter registry, the session's card's
        memory, and, with a membership view, this rank's lease, written
        on the tick."""
        from tpu_radix_join_torch.observability.metrics import MetricsSampler
        self._sampler = MetricsSampler(path, interval_s,
                                       measurements=self.measurements,
                                       extra=self.heartbeat_tick,
                                       device=self.device)
        self._sampler.start()
        return self._sampler

    def fastpath_stats(self) -> dict:
        """The fast paths' state: result-cache hit rates, residency bytes
        and fused-batch totals."""
        return {"cache": self.result_cache.stats(),
                "resident": self.resident.stats(),
                "batch": {"fused_batches": self.batches_fused,
                          "fused_queries": self.batch_queries_fused},
                "placed_bytes": self.placed_bytes(),
                "place_cache_entries": len(self._place_cache),
                "place_cache_max": self.service.place_cache_max}

    def _heartbeat_extra(self) -> dict:
        """The service state a heartbeat tick and ``/statusz/service``
        show: SLO, breaker, queue depth, placed bytes, the caches and the
        membership view; host values and tensor sizes only."""
        out = {"slo": self.slo.snapshot(),
               "breaker": self.breaker.snapshot(),
               "queue_depth": self.queue.depth(),
               "placed_bytes": self.placed_bytes()}
        if self.result_cache.max_entries:
            out["result_cache"] = self.result_cache.stats()
        if self.resident.budget_bytes:
            out["resident"] = self.resident.stats()
        if self.membership is not None:
            out["membership"] = {"epoch": self.membership.epoch,
                                 "lost": sorted(self.membership.lost),
                                 "survivors": self.membership.survivors}
        return out

    def heartbeat_tick(self) -> dict:
        """One heartbeat tick's extra: :meth:`_heartbeat_extra` and, with
        a membership view, this rank's lease, written now."""
        out = self._heartbeat_extra()
        if self._lease_extra is not None:
            out.update(self._lease_extra())
        return out

    def summary(self) -> dict:
        """Final serve report: SLO tags and breaker, queue and cache
        state; ``ncompile`` / ``compile_ms`` count the first-use kernel
        builds an installed compile monitor heard."""
        out = self.slo.snapshot()
        out.update(breaker_state=self.breaker.state,
                   breaker_trips=self.breaker.trips,
                   breaker_probes=self.breaker.probes,
                   queue_rejected=self.queue.rejected,
                   placed_bytes=self.placed_bytes())
        if self.result_cache.max_entries:
            cache = self.result_cache.stats()
            out["cache_hits"] = cache["hits"]
            out["cache_hit_rate"] = cache["hit_rate"]
        if self.batches_fused:
            out["fused_batches"] = self.batches_fused
            out["fused_queries"] = self.batch_queries_fused
        if self.resident.budget_bytes:
            res = self.resident.stats()
            out["resident_bytes"] = res["resident_bytes"]
            out["delta_merges"] = res["merges"]
        m = self.measurements
        if m is not None:
            out["warm_queries"] = int(m.counters.get(QWARM, 0))
            out["degraded_queries"] = int(m.counters.get(QDEGRADED, 0))
            out["ncompile"] = int(m.counters.get(NCOMPILE, 0))
            out["compile_ms"] = int(m.counters.get(COMPILEMS, 0))
            out["recompile_storms"] = self._recompile_storms
            if m.counters.get(RANKLOST):
                out["ranks_lost"] = int(m.counters.get(RANKLOST, 0))
                out["membership_epoch"] = int(m.counters.get(MEPOCH, 0))
                out["recovered_partitions"] = int(m.counters.get(RECOVERN, 0))
                out["recover_ms"] = int(m.counters.get(RECOVERMS, 0))
        return out

    def close(self) -> None:
        """Release what the session owns: the heartbeat and watchdog
        threads, placed batches, resident lanes, cached results and the
        ephemeral plan cache.  Idempotent; the session refuses new
        submissions after."""
        if self._closed:
            return
        self._closed = True
        for owned in (self._sampler, self._watchdog):
            if owned is not None:
                owned.stop()
        self._sampler = self._watchdog = None
        self._place_cache.clear()
        self.result_cache.invalidate()
        self.resident.invalidate()
        self._resident_host.clear()
        self._resident_probe.clear()
        self._cpu_engine = None
        if self._cache_tmp is not None:
            self._cache_tmp.cleanup()
            self._cache_tmp = None

    def __enter__(self) -> "JoinSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _as_list(out: Optional[QueryOutcome]) -> List[QueryOutcome]:
    return [out] if out is not None else []
