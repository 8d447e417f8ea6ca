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
executed query, as JAX's does without its ``trace_id`` and ``ncompile``
(ROADMAP A18d).  Not ported here: forensics bundles, the heartbeat
sampler, elastic membership and hedging (ROADMAP A18), and the fleet
supervisor (A16b); their constructor arguments raise
``NotImplementedError``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import pickle
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from tpu_radix_join_torch.core.config import (JoinConfig, ServiceConfig,
                                              _not_ported)
from tpu_radix_join_torch.data.tuples import (U32_MASK, lane_from_numpy,
                                              lane_to_numpy)
from tpu_radix_join_torch.performance.measurements import (
    BATCHN, BATCHQ, COMPILEMS, DELTAMERGE, JHIST, NCOMPILE, QDEADLINE,
    QDEGRADED, QWARM)
from tpu_radix_join_torch.robustness import faults as _faults
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
    bundle: Optional[str] = None    # forensics bundle (ROADMAP A18): None
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

        for name, value, off in (
                ("forensics_dir", forensics_dir, None),
                ("membership", membership, None),
                ("elastic", elastic, False),
                ("partition_manifest", partition_manifest, None),
                ("elastic_grow", elastic_grow, False),
                ("hedge", hedge, "off")):
            if value != off:
                raise _not_ported(f"JoinSession({name}={value!r})",
                                  "queue A, A18: host-side modules")
        del hedge_threshold        # read only with hedging (A18)
        self.config = config
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
        self._closed = False
        #: recent outcomes only; the SLO recorder owns the aggregates
        self.outcomes: "collections.deque" = collections.deque(
            maxlen=self.service.outcomes_keep)

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
        return None                     # no membership yet (ROADMAP A18)

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
                    n = int(merge_count_presorted(union, s_dev)) & U32_MASK
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
                    return (union, probe["total"] + (int(inc) & U32_MASK),
                            exp, mirror2, probe)
                fn = compiled_delta_merge_count(lane.numel(), delta.numel(),
                                                s_dev.numel())
                union, total = fn(lane, delta, s_dev,
                                  sort_impl=self.config.sort_impl)
                return (union, int(total) & U32_MASK,
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
        t0 = time.perf_counter()
        jhist0 = m.times_us.get(JHIST, 0.0) if m is not None else 0.0
        span = (m.span("query", query_id=request.query_id,
                       tenant=request.tenant,
                       engine="primary" if primary else "cpu_fallback",
                       probe=probing)
                if m is not None else contextlib.nullcontext())
        engine.cancel = deadline.check
        status, cls, detail = "ok", OK, ""
        matches = expected = None
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
                result = engine.join_arrays(
                    r_batch, s_batch,
                    key_bound=max(inner.key_bound(), outer.key_bound()),
                    repeats=request.repeats)
                matches = result.matches
                cls = (result.diagnostics or {}).get(
                    "failure_class") or (OK if result.ok else UNCLASSIFIED)
                status = "ok" if result.ok else "failed"
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
            if m is not None:
                m.event("query_failed", query_id=request.query_id,
                        failure_class=cls, error=repr(e)[:200])
        finally:
            engine.cancel = None
        latency_ms = (time.perf_counter() - t0) * 1e3
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
        out = QueryOutcome(
            query_id=request.query_id, tenant=request.tenant,
            status=status, failure_class=cls, latency_ms=latency_ms,
            matches=matches, expected=expected,
            engine="primary" if primary else "cpu_fallback",
            degraded=not primary, warm=warm,
            breaker_state=self.breaker.state, detail=detail)
        self.slo.record(request.tenant, latency_ms, ok=(status == "ok"),
                        failure_class=None if cls == OK else cls,
                        degraded=not primary)
        self.outcomes.append(out)
        if self.ledger is not None:
            # a ledger write failure is an event, never the query's
            try:
                self.ledger.append("query", {
                    "query_id": request.query_id, "tenant": request.tenant,
                    "status": status, "failure_class": cls,
                    "latency_ms": round(latency_ms, 3),
                    "warm": warm, "engine": out.engine,
                    "tuples_per_node": request.tuples_per_node,
                    "repeats": request.repeats})
            except Exception as e:   # noqa: BLE001 — isolation boundary
                if m is not None:
                    m.event("ledger_error", error=repr(e)[:200])
        return out

    # ----------------------------------------------------------- lifecycle
    def attach_heartbeat(self, path: str, interval_s: float):
        raise _not_ported("JoinSession.attach_heartbeat",
                          "queue A, A18: host-side modules")

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

    def summary(self) -> dict:
        """Final serve report: SLO tags and breaker, queue and cache
        state.  ``ncompile`` / ``compile_ms`` read counters nothing of the
        port ticks yet (the compile monitor is ROADMAP A18)."""
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
        return out

    def close(self) -> None:
        """Release what the session owns: placed batches, resident lanes,
        cached results and the ephemeral plan cache.  Idempotent; the
        session refuses new submissions after."""
        if self._closed:
            return
        self._closed = True
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
