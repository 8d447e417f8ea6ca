"""Crash-only fleet supervisor: N serve workers, exactly-once queries.

The port's copy of ``tpu_radix_join/service/fleet.py``: the same ring, the
same journal discipline, the same worker states and the same statusz,
readiness and summary shapes.  One serve process is mortal; the
:class:`FleetSupervisor` owns N worker subprocesses (each running the
port's ``main --serve -`` JSONL loop over a pipe), routes queries to them
by consistent hash on tenant, health-checks them by their lease heartbeat
(two missed beats = lapse, the rank-lapse rule of
robustness/membership.py), restarts dead workers with exponential backoff,
and quarantines crash-loopers through the
:class:`~tpu_radix_join_torch.service.breaker.CircuitBreaker` state
machine (K deaths without an intervening served query trips the slot
open; the cooldown is the quarantine window, the half-open probe is the
restart attempt; tenants re-hash onto the surviving ring the moment the
slot leaves it).

Correctness across crashes is the :class:`~tpu_radix_join_torch.service.
journal.QueryJournal`'s exactly-once discipline:

  * **intent before dispatch** — an accepted query is journaled before
    any worker sees it, so no crash can vanish it;
  * **outcome before reply** — a worker's verdict is journaled before
    the client reads it, so a lost response is re-*served* from the
    journal, never re-*executed* (fingerprint dedup);
  * **replay on death** — a worker that dies mid-query leaves an
    unacknowledged intent; the supervisor replays it on a healthy
    worker (``FAILOVER``/``REPLAYN``), and a restarted supervisor
    replays every unacknowledged intent before taking new work (a
    journal the JAX package's supervisor wrote included: same schema).

The soak invariant (chaos ``fleet.worker_kill``, robustness/chaos.py
``soak_fleet``): every accepted query gets exactly one outcome — oracle
exact or classified — and the journal audit's ``double_exec`` stays 0.

Graceful drain: ``drain()`` (SIGTERM in ``main --fleet``) stops
admission, finishes in-flight queries under their deadlines, closes the
workers' stdin so each serve loop exits cleanly and withdraws its own
lease, and leaves the journal with zero unacknowledged intents — no
query stranded, no lease left to lapse.

The supervisor makes no CUDA call: the card holds contexts only for the
workers, and each worker runs on the ``--device`` its command line names
(``main --fleet`` passes its own through ``worker_args``).
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from tpu_radix_join_torch.performance.measurements import (DOUBLEEXEC,
                                                           FAILOVER, JDEPTH,
                                                           REPLAYN, WINCARN,
                                                           WRESTART)
from tpu_radix_join_torch.robustness import faults
from tpu_radix_join_torch.robustness.retry import (BACKEND_UNAVAILABLE,
                                                   REQUEST_ERROR)
from tpu_radix_join_torch.service.breaker import OPEN, CircuitBreaker
from tpu_radix_join_torch.service.journal import (QueryJournal,
                                                  request_fingerprint)
from tpu_radix_join_torch.service.microbatch import SIGNATURE_FIELDS
from tpu_radix_join_torch.service.resultcache import (ResultCache,
                                                      content_fingerprint)

#: ring resolution: virtual nodes per worker slot — enough that losing
#: one of a handful of workers re-hashes only its own tenants
_VNODES = 32

#: replay attempts per query before the supervisor gives up and returns
#: a classified failure (every attempt burned a worker incarnation)
_MAX_ATTEMPTS_SLACK = 2


def ring_points(slots: List[int], vnodes: int = _VNODES):
    """The consistent-hash ring for ``slots``: sorted (position, slot)
    pairs, positions drawn per (slot, vnode) so membership changes move
    only the departed slot's arcs."""
    pts = []
    for s in slots:
        for v in range(vnodes):
            h = hashlib.md5(f"w{s}:{v}".encode()).hexdigest()[:8]
            pts.append((int(h, 16), s))
    pts.sort()
    return pts


def route_tenant(tenant: str, slots: List[int],
                 vnodes: int = _VNODES) -> Optional[int]:
    """Owner slot for ``tenant`` on the ring over ``slots`` (None when the
    ring is empty).  Deterministic in (tenant, membership): the same
    tenant re-hashes to the same survivor whenever the same slot set is
    healthy — what keeps a tenant's warm capacity caches on one worker."""
    if not slots:
        return None
    pts = ring_points(sorted(set(slots)), vnodes)
    h = int(hashlib.md5(f"t:{tenant}".encode()).hexdigest()[:8], 16)
    for pos, slot in pts:
        if pos >= h:
            return slot
    return pts[0][1]            # wrap around


class _Worker:
    """One supervised serve subprocess: pipes, lease dir, incarnation,
    backoff state, and the crash-loop breaker for its slot."""

    def __init__(self, slot: int, work_dir: str, breaker: CircuitBreaker):
        self.slot = slot
        self.work_dir = work_dir          # per-incarnation artifacts live here
        self.breaker = breaker            # slot-scoped: survives incarnations
        self.proc: Optional[subprocess.Popen] = None
        self.incarnations = 0             # spawns, lifetime of the slot
        self.deaths = 0
        self.backoff_s = 0.0
        self.not_before = 0.0             # monotonic gate for the next spawn
        self.spawned_mono = 0.0
        self.queries_served = 0
        self._outq: "queue.Queue[Optional[dict]]" = queue.Queue()
        self._reader: Optional[threading.Thread] = None

    @property
    def incarnation_id(self) -> str:
        return f"w{self.slot}i{self.incarnations}"

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    @property
    def quarantined(self) -> bool:
        return self.breaker.state == OPEN

    def lease_dir(self) -> str:
        return os.path.join(self.work_dir, "leases")

    def lease_age_s(self) -> Optional[float]:
        """Age of the worker's own heartbeat lease (rank 0 of its private
        board), or None when it has not written one yet (booting) or
        withdrew it (clean exit)."""
        try:
            with open(os.path.join(self.lease_dir(),
                                   "lease_r0.json")) as f:
                lease = json.load(f)
            return max(0.0, time.time() - float(lease["t_epoch_s"]))
        except (OSError, ValueError, KeyError):
            return None

    def drain_events(self) -> List[dict]:
        """Everything the reader thread has queued (non-blocking)."""
        out = []
        while True:
            try:
                ev = self._outq.get_nowait()
            except queue.Empty:
                return out
            if ev is not None:
                out.append(ev)

    def next_event(self, timeout: float) -> Optional[dict]:
        """Next stdout JSON event, or None on timeout/EOF (the caller
        distinguishes via :attr:`alive`)."""
        try:
            return self._outq.get(timeout=timeout)
        except queue.Empty:
            return None


class FleetSupervisor:
    """Crash-only pool of ``--serve -`` workers behind one dispatch API.

    Single dispatcher thread by design (mirrors JoinSession's
    single-threaded serving contract): ``dispatch`` is the only mutator
    of routing state, so the exactly-once bookkeeping needs no locks
    beyond each worker's stdout reader queue.
    """

    def __init__(self, workers: int, worker_args: List[str],
                 work_dir: str, measurements=None,
                 lease_s: float = 5.0, missed_beats: int = 2,
                 boot_grace_s: float = 120.0,
                 restart_backoff_s: float = 0.25,
                 restart_backoff_max_s: float = 10.0,
                 crash_loop_threshold: int = 3,
                 crash_loop_window_s: float = 60.0,
                 dispatch_timeout_s: float = 300.0,
                 python: Optional[str] = None,
                 env: Optional[dict] = None,
                 clock: Callable[[], float] = time.monotonic,
                 result_cache_max: int = 0,
                 result_cache_ttl_s: Optional[float] = None,
                 batch_window_ms: float = 0.0):
        if workers < 1:
            raise ValueError("fleet needs at least one worker")
        self.num_workers = workers
        self.worker_args = list(worker_args)
        self.work_dir = work_dir
        self.measurements = measurements
        self.lease_s = float(lease_s)
        self.missed_beats = int(missed_beats)
        self.boot_grace_s = float(boot_grace_s)
        self.restart_backoff_s = float(restart_backoff_s)
        self.restart_backoff_max_s = float(restart_backoff_max_s)
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        self._python = python or sys.executable
        self._env = env
        self._clock = clock
        os.makedirs(work_dir, exist_ok=True)
        self.journal = QueryJournal(work_dir)
        self.workers: Dict[int, _Worker] = {}
        for slot in range(workers):
            wdir = os.path.join(work_dir, f"worker{slot}")
            os.makedirs(wdir, exist_ok=True)
            # the slot's crash-loop breaker: K deaths with no served query
            # in between trip it OPEN (quarantine); the cooldown is the
            # quarantine window W; allow_primary()'s half-open promotion
            # is the restart probe, closed again by the first served query
            self.workers[slot] = _Worker(slot, wdir, CircuitBreaker(
                failure_threshold=crash_loop_threshold,
                cooldown_s=crash_loop_window_s, clock=clock,
                measurements=measurements))
        self.draining = False
        self.started = False
        #: supervisor-side result cache: a content hit is answered at the
        #: supervisor, journaled intent+outcome under the submission's
        #: fingerprint (exactly-once holds unchanged), and never reaches
        #: a worker.  Keyed by content + the worker config (worker_args
        #: determine what every worker computes).
        self.result_cache = ResultCache(result_cache_max,
                                        result_cache_ttl_s,
                                        measurements=measurements)
        #: when > 0 the router keys on the batch signature instead of the
        #: tenant, so co-batchable queries from DIFFERENT tenants land on
        #: the same worker and actually meet in its coalescing window
        self.batch_window_ms = float(batch_window_ms)
        #: tenant -> slot of the last routed query (statusz affinity view)
        self.batch_affinity: Dict[str, int] = {}
        # counters mirrored locally so summary() works without a registry
        self.failovers = 0
        self.replays = 0
        self.restarts = 0
        self.journal_served = 0     # outcomes re-served from the journal
        self.peak_depth = 0
        self.queries = 0

    @property
    def lapse_window_s(self) -> float:
        """Two-missed-beats staleness bound — the LeaseBoard rank-lapse
        rule applied to worker heartbeats."""
        return self.lease_s * self.missed_beats

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Spawn the boot pool.  Replaying a previous incarnation's
        unacknowledged intents is the caller's move (:meth:`replay_
        unacknowledged`) so it can route the replayed outcomes to its
        client."""
        if self.started:
            return
        self.started = True
        for slot in range(self.num_workers):
            self._spawn(self.workers[slot])

    def _worker_cmd(self, w: _Worker) -> List[str]:
        # the worker IS the existing serve loop: stdin JSONL in, outcome
        # JSON lines out.  --elastic on + --metrics-interval give it a
        # heartbeating lease (the sampler tick carries the lease write,
        # main's serve wiring), which is the health signal we read.
        beat = max(0.1, self.lease_s / 2.0)
        return [self._python, "-m", "tpu_radix_join_torch.main",
                "--serve", "-", *self.worker_args,
                "--elastic", "on",
                "--lease-dir", w.lease_dir(),
                "--rank-lease-s", str(self.lease_s),
                "--rank-missed-beats", str(self.missed_beats),
                "--metrics-interval", str(beat),
                "--timeline-dir", w.work_dir]

    def _spawn(self, w: _Worker) -> None:
        w.incarnations += 1
        env = dict(self._env if self._env is not None else os.environ)
        # the worker must import this package regardless of the
        # supervisor's cwd — prepend the package root, keep the rest
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else pkg_root)
        # the incarnation id rides into the worker's flight-recorder
        # context (main's serve wiring) so its forensics bundles group
        # per incarnation (observability/postmortem.py merge_bundles)
        env["TPU_RJ_WORKER_INCARNATION"] = w.incarnation_id
        # stale lease files from the previous incarnation must not read
        # as a live heartbeat
        try:
            os.remove(os.path.join(w.lease_dir(), "lease_r0.json"))
        except OSError:
            pass
        w.proc = subprocess.Popen(
            self._worker_cmd(w), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, bufsize=1, env=env)
        w.spawned_mono = self._clock()
        w._outq = queue.Queue()
        w._reader = threading.Thread(
            target=self._read_worker, args=(w, w.proc),
            name=f"fleet-{w.incarnation_id}", daemon=True)
        w._reader.start()
        m = self.measurements
        if m is not None:
            m.incr(WINCARN)
            m.event("worker_spawn", slot=w.slot,
                    incarnation=w.incarnation_id, pid=w.proc.pid)

    @staticmethod
    def _read_worker(w: _Worker, proc: subprocess.Popen) -> None:
        """Reader thread: worker stdout JSON lines -> the slot's queue;
        EOF pushes a None sentinel so a blocked dispatcher wakes."""
        outq = w._outq
        try:
            for line in proc.stdout:
                line = line.strip()
                if not line:
                    continue
                try:
                    outq.put(json.loads(line))
                except ValueError:
                    continue       # torn/no-JSON chatter is not protocol
        except (OSError, ValueError):
            pass
        outq.put(None)

    # --------------------------------------------------------------- health
    def worker_state(self, w: _Worker) -> str:
        """``serving`` | ``booting`` | ``stale`` | ``quarantined`` |
        ``backoff`` | ``dead`` — the statusz vocabulary and the routing
        predicate (only ``serving``/``booting`` take traffic)."""
        if w.quarantined:
            return "quarantined"
        if not w.alive:
            return ("backoff"
                    if self._clock() < w.not_before else "dead")
        age = w.lease_age_s()
        if age is None:
            boot_for = self._clock() - w.spawned_mono
            return "booting" if boot_for <= self.boot_grace_s else "stale"
        return "serving" if age <= self.lapse_window_s else "stale"

    def routable_slots(self) -> List[int]:
        """Slots eligible for new queries right now: alive, not
        quarantined, heartbeat fresh (or still inside boot grace) — the
        consistent-hash ring's live membership."""
        return [s for s, w in sorted(self.workers.items())
                if self.worker_state(w) in ("serving", "booting")]

    def _restartable(self) -> List[_Worker]:
        now = self._clock()
        out = []
        for w in self.workers.values():
            if w.alive:
                continue
            if now < w.not_before:
                continue
            # a quarantined slot restarts only when its breaker half-opens
            # (allow_primary promotes OPEN -> HALF_OPEN after cooldown);
            # the restarted incarnation is the health probe
            if not w.breaker.allow_primary():
                continue
            out.append(w)
        return out

    def _ensure_capacity(self, deadline: float) -> Optional[int]:
        """A routable slot, restarting dead workers (with backoff) as
        needed; None when every slot stays down past ``deadline``."""
        while True:
            live = self.routable_slots()
            if live:
                return live[0]
            for w in self._restartable():
                self.restarts += 1
                m = self.measurements
                if m is not None:
                    m.incr(WRESTART)
                self._spawn(w)
            if self.routable_slots():
                continue
            if self._clock() >= deadline:
                return None
            time.sleep(0.05)

    # -------------------------------------------------------------- routing
    def _batch_signature(self, request: dict) -> Optional[str]:
        """The request's co-batchability class as a ring key, or None when
        batching is off — mirrors service/microbatch.batch_signature over
        the wire dict (same fields, same defaults as QueryRequest)."""
        if self.batch_window_ms <= 0:
            return None
        defaults = {"tuples_per_node": 1 << 16, "outer_kind": "unique",
                    "modulo": None, "zipf_theta": 0.75, "repeats": 1}
        sig = tuple(request.get(f, defaults[f]) for f in SIGNATURE_FIELDS)
        return f"sig:{sig}"

    def pick_worker(self, tenant: str,
                    signature: Optional[str] = None) -> Optional[_Worker]:
        """The tenant's ring owner among live slots — or, when a batch
        ``signature`` is given (batching enabled), the SIGNATURE's ring
        owner, so co-batchable queries from different tenants land on one
        worker and meet in its coalescing window.  The load signal is
        deliberately coarse for a closed-loop dispatcher: ring ownership
        keeps warm capacity caches on one worker; ledger/heartbeat load
        (queries served, lease age) surfaces in statusz for operators and
        re-balances only through membership changes."""
        slot = route_tenant(signature or tenant, self.routable_slots())
        if slot is not None:
            self.batch_affinity[tenant] = slot
        return self.workers[slot] if slot is not None else None

    # ------------------------------------------------------------- dispatch
    def _gauge_depth(self) -> None:
        depth = self.journal.depth()
        if depth > self.peak_depth:
            self.peak_depth = depth
            m = self.measurements
            if m is not None:
                # gauge discipline (MEPOCH-style): counter holds the max
                cur = int(m.counters.get(JDEPTH, 0))
                if depth > cur:
                    m.incr(JDEPTH, depth - cur)

    def _classified_failure(self, request: dict, detail: str) -> dict:
        return {"query_id": request.get("query_id"),
                "tenant": request.get("tenant", "default"),
                "status": "failed", "failure_class": BACKEND_UNAVAILABLE,
                "latency_ms": 0.0, "matches": None, "expected": None,
                "engine": "fleet", "degraded": True, "warm": False,
                "breaker_state": "open", "detail": detail}

    def _kill(self, w: _Worker, sig=signal.SIGKILL) -> None:
        if w.proc is not None and w.proc.poll() is None:
            try:
                os.kill(w.proc.pid, sig)
            except OSError:
                pass

    def kill_worker(self, slot: int) -> None:
        """SIGKILL one worker — the ``fleet.worker_kill`` chaos action."""
        self._kill(self.workers[slot])

    def _on_death(self, w: _Worker, why: str) -> None:
        self._kill(w)                       # hung counts as dead: finish it
        try:
            w.proc.wait(timeout=10.0)
        except (subprocess.TimeoutExpired, OSError):
            pass
        w.deaths += 1
        # exponential backoff before the next incarnation; the breaker
        # additionally quarantines a crash-looping slot outright
        w.backoff_s = (self.restart_backoff_s if not w.backoff_s
                       else min(w.backoff_s * 2.0,
                                self.restart_backoff_max_s))
        w.not_before = self._clock() + w.backoff_s
        w.breaker.record_failure(BACKEND_UNAVAILABLE)
        m = self.measurements
        if m is not None:
            m.event("worker_death", slot=w.slot,
                    incarnation=w.incarnation_id, why=why,
                    deaths=w.deaths, backoff_s=round(w.backoff_s, 3),
                    quarantined=w.quarantined)

    def dispatch(self, request: dict, replayed: bool = False,
                 fp: Optional[str] = None) -> dict:
        """Serve one request exactly once; returns the outcome dict.

        The full WAL discipline: dedup against journaled outcomes first
        (a re-submitted or replayed query whose outcome exists is served
        from the journal, never re-executed), then the supervisor-side
        result cache (a content hit is journaled intent+outcome under the
        submission fingerprint and answered without touching a worker),
        then intent-journal, dispatch, outcome-journal.  A worker death
        mid-query fails the query over to a healthy worker (``FAILOVER``
        + ``REPLAYN``); only when every slot is down/quarantined past the
        dispatch deadline does the query end as a *classified* failure —
        still exactly one outcome.

        ``fp`` overrides the computed submission fingerprint — the replay
        path passes the journaled intent's fp verbatim so a replayed
        query's outcome always lands under the intent it acknowledges,
        even across builds whose canonicalization differs."""
        if self.draining:
            return self._classified_failure(request, "fleet draining: "
                                            "admission stopped")
        self.queries += 1
        fp = fp or request_fingerprint(request)
        prior = self.journal.outcome_for(fp)
        if prior is not None:
            # journaled-outcome/lost-response dedup: the answer exists,
            # the execution must not happen again
            self.journal_served += 1
            out = dict(prior)
            out["fleet"] = {"served_from_journal": True, "fp": fp}
            return out
        cached = self._try_cache(request, fp)
        if cached is not None:
            return cached
        deadline = self._clock() + max(
            self.dispatch_timeout_s,
            float(request.get("deadline_s") or 0.0))
        m = self.measurements
        attempt = 0
        max_attempts = self.num_workers + _MAX_ATTEMPTS_SLACK
        while True:
            attempt += 1
            if attempt > max_attempts or self._clock() >= deadline:
                out = self._classified_failure(
                    request, f"fleet exhausted {attempt - 1} dispatch "
                             f"attempt(s); no worker completed the query")
                self.journal.append_outcome(fp, out)
                self._gauge_depth()
                return out
            slot = self._ensure_capacity(deadline)
            if slot is None:
                out = self._classified_failure(
                    request, "no healthy worker (all dead or quarantined)")
                self.journal.append_outcome(fp, out)
                self._gauge_depth()
                return out
            w = self.pick_worker(request.get("tenant", "default"),
                                 signature=self._batch_signature(request))
            if w is None:
                continue
            self.journal.append_intent(request, fp=fp, worker=w.slot,
                                       incarnation=w.incarnation_id,
                                       attempt=attempt)
            if attempt > 1:
                self.replays += 1
                if m is not None:
                    m.incr(REPLAYN)
            self._gauge_depth()
            try:
                w.proc.stdin.write(json.dumps(request) + "\n")
                w.proc.stdin.flush()
            except (OSError, ValueError):
                self._on_death(w, "stdin_broken")
                self._count_failover(m)
                continue
            # chaos: SIGKILL the routed worker mid-query — the request is
            # on its pipe, the outcome must come from a survivor instead
            if faults.fires(faults.FLEET_WORKER_KILL, m):
                self.kill_worker(w.slot)
            out = self._await_outcome(w, request, deadline)
            if out is None:
                self._on_death(w, "died_mid_query")
                self._count_failover(m)
                continue
            self.journal.append_outcome(fp, out, worker=w.slot)
            w.queries_served += 1
            w.breaker.record_success()
            w.backoff_s = 0.0
            self._gauge_depth()
            self._cache_put(request, out)
            out = dict(out)
            out["fleet"] = {"worker": w.slot,
                            "incarnation": w.incarnation_id,
                            "attempts": attempt, "replayed": replayed
                            or attempt > 1}
            return out

    def dispatch_batch(self, requests: List[dict]) -> List[dict]:
        """Serve a co-batchable group through ONE worker: every request is
        intent-journaled and written to the signature's ring owner
        back-to-back — so the worker's serve loop sees the whole group
        pending and coalesces it into a fused device program — then the
        outcomes are awaited and journaled in order.  A worker death
        mid-batch (the ``fleet.worker_kill`` chaos site fires per written
        query) fails the UNANSWERED remainder over through the normal
        one-query path under the same fingerprints — already-journaled
        outcomes dedup, so every query still gets exactly one outcome and
        ``double_exec`` stays 0."""
        if len(requests) <= 1 or self.batch_window_ms <= 0:
            return [self.dispatch(r) for r in requests]
        m = self.measurements
        outs: Dict[int, dict] = {}
        pend: List[tuple] = []           # (index, request, fp) to execute
        for i, request in enumerate(requests):
            if self.draining:
                outs[i] = self._classified_failure(
                    request, "fleet draining: admission stopped")
                continue
            self.queries += 1
            fp = request_fingerprint(request)
            prior = self.journal.outcome_for(fp)
            if prior is not None:
                self.journal_served += 1
                out = dict(prior)
                out["fleet"] = {"served_from_journal": True, "fp": fp}
                outs[i] = out
                continue
            cached = self._try_cache(request, fp)
            if cached is not None:
                outs[i] = cached
                continue
            pend.append((i, request, fp))
        if pend:
            deadline = self._clock() + self.dispatch_timeout_s
            slot = self._ensure_capacity(deadline)
            w = (self.pick_worker(
                    pend[0][1].get("tenant", "default"),
                    signature=self._batch_signature(pend[0][1]))
                 if slot is not None else None)
            alive = w is not None
            if alive:
                for i, request, fp in pend:
                    self.journal.append_intent(request, fp=fp, worker=w.slot,
                                               incarnation=w.incarnation_id,
                                               attempt=1)
                    try:
                        w.proc.stdin.write(json.dumps(request) + "\n")
                        w.proc.stdin.flush()
                    except (OSError, ValueError):
                        alive = False
                        break
                    if faults.fires(faults.FLEET_WORKER_KILL, m):
                        self.kill_worker(w.slot)
                self._gauge_depth()
            died = not alive
            for i, request, fp in pend:
                out = (self._await_outcome(w, request, deadline)
                       if not died else None)
                if out is None:
                    # worker lost mid-batch: the batch retries UNBATCHED —
                    # each unanswered query fails over individually, its
                    # journaled fp riding along so dedup and the audit
                    # see one submission, one outcome
                    if not died:
                        died = True
                        self._on_death(w, "died_mid_batch")
                        self._count_failover(m)
                    outs[i] = self.dispatch(request, replayed=True, fp=fp)
                    continue
                self.journal.append_outcome(fp, out, worker=w.slot)
                w.queries_served += 1
                w.breaker.record_success()
                w.backoff_s = 0.0
                self._cache_put(request, out)
                out = dict(out)
                out["fleet"] = {"worker": w.slot,
                                "incarnation": w.incarnation_id,
                                "attempts": 1, "replayed": False,
                                "batched": len(pend)}
                outs[i] = out
            self._gauge_depth()
        return [outs[i] for i in range(len(requests))]

    # ---------------------------------------------------------- result cache
    def _content_fp(self, request: dict) -> str:
        # worker_args ARE the fleet's join config: every worker is spawned
        # from them, so they are the config component of content identity
        return content_fingerprint(request,
                                   config_fp={"worker_args":
                                              list(self.worker_args)})

    def _try_cache(self, request: dict, fp: str) -> Optional[dict]:
        """Answer ``request`` from the supervisor-side result cache, or
        None.  A hit is journaled intent+outcome under the submission
        fingerprint ``fp`` — the WAL sees the same accepted/answered pair
        as an executed query, so replay, dedup, and the double_exec audit
        are oblivious to where the answer came from."""
        if self.result_cache.max_entries == 0:
            return None
        payload = self.result_cache.get(self._content_fp(request))
        if payload is None:
            return None
        out = {"query_id": request.get("query_id"),
               "tenant": request.get("tenant", "default"),
               "status": "ok", "failure_class": "ok", "latency_ms": 0.0,
               "matches": payload.get("matches"),
               "expected": payload.get("expected"),
               "engine": payload.get("engine", "primary"),
               "degraded": False, "warm": True,
               "breaker_state": "closed", "detail": "result cache hit",
               "served_by": "cache_hit"}
        self.journal.append_intent(request, fp=fp)
        self.journal.append_outcome(fp, out)
        out = dict(out)
        out["fleet"] = {"served_from_cache": True, "fp": fp}
        return out

    def _cache_put(self, request: dict, out: dict) -> None:
        if (self.result_cache.max_entries == 0
                or out.get("status") != "ok" or out.get("degraded")
                or out.get("matches") is None
                or request.get("delta_tuples_per_node")):
            return
        self.result_cache.put(
            self._content_fp(request),
            {"matches": out.get("matches"), "expected": out.get("expected"),
             "engine": out.get("engine", "primary")})

    def _count_failover(self, m) -> None:
        self.failovers += 1
        if m is not None:
            m.incr(FAILOVER)

    def _await_outcome(self, w: _Worker, request: dict,
                       deadline: float) -> Optional[dict]:
        """The worker's outcome event for this request, or None when the
        worker died (EOF) or went silent past the deadline (hung ==
        dead: crash-only has no third state)."""
        qid = request.get("query_id")
        while True:
            remaining = deadline - self._clock()
            if remaining <= 0:
                return None
            ev = w.next_event(min(remaining, 0.5))
            if ev is None:
                if not w.alive:
                    return None          # EOF sentinel or dead process
                continue                 # idle tick; keep waiting
            kind = ev.get("event")
            if kind == "outcome" and ev.get("query_id") == qid:
                out = {k: v for k, v in ev.items() if k != "event"}
                return out
            if kind == "request_error" and ev.get("query_id") == qid:
                # the worker refused the line: classify, don't retry —
                # a malformed request is the client's bug on any worker
                return {"query_id": qid,
                        "tenant": request.get("tenant", "default"),
                        "status": "failed",
                        "failure_class": REQUEST_ERROR,
                        "latency_ms": 0.0,
                        "detail": str(ev.get("error"))}
            # stale outcome from a superseded attempt, summary chatter,
            # etc. — not ours, keep reading

    # --------------------------------------------------------------- replay
    def replay_unacknowledged(
            self, emit: Optional[Callable[[dict], None]] = None
            ) -> List[dict]:
        """Serve every unacknowledged journal intent (a previous
        incarnation's accepted-but-unanswered queries) on the current
        pool — the restart half of exactly-once.  Queries whose outcome
        IS journaled are skipped here; they re-serve through the dedup
        path when the client re-submits."""
        outs = []
        m = self.measurements
        for row in self.journal.unacknowledged():
            request = row.get("request") or {}
            self.replays += 1
            if m is not None:
                m.incr(REPLAYN)
            # the intent row's fp rides through verbatim: the replayed
            # outcome must acknowledge THAT intent even if this build's
            # canonicalization would fingerprint the request differently
            out = self.dispatch(request, replayed=True, fp=row.get("fp"))
            outs.append(out)
            if emit:
                emit(out)
        return outs

    # ---------------------------------------------------------------- drain
    def drain(self, timeout_s: float = 60.0) -> dict:
        """Graceful shutdown: stop admission, close every worker's stdin
        (the serve loop's EOF -> summary -> clean exit -> lease
        withdrawal path), wait for exits, and report the final journal
        audit.  In-flight queries finished before drain was called —
        the dispatcher is single-threaded, so reaching here means no
        query is mid-pipe."""
        self.draining = True
        for w in self.workers.values():
            if w.alive:
                try:
                    w.proc.stdin.close()
                except OSError:
                    pass
        deadline = self._clock() + timeout_s
        for w in self.workers.values():
            if w.proc is None:
                continue
            try:
                w.proc.wait(timeout=max(0.1, deadline - self._clock()))
            except subprocess.TimeoutExpired:
                self._kill(w)          # a worker that ignores EOF is hung
                try:
                    w.proc.wait(timeout=5.0)
                except (subprocess.TimeoutExpired, OSError):
                    pass
        # a cleanly-exited worker withdrew its own lease (main's
        # finally); what remains is the stale lease of a killed
        # incarnation — every process is dead now, so the supervisor
        # sweeps them: no lease left to lapse
        swept = []
        for s, w in self.workers.items():
            lease = os.path.join(w.lease_dir(), "lease_r0.json")
            if os.path.exists(lease):
                try:
                    os.remove(lease)
                    swept.append(s)
                except OSError:
                    pass
        audit = self.journal.audit()
        m = self.measurements
        if m is not None and audit.double_exec:
            m.incr(DOUBLEEXEC, audit.double_exec)
        leases = [s for s, w in self.workers.items()
                  if os.path.exists(os.path.join(w.lease_dir(),
                                                 "lease_r0.json"))]
        if m is not None:
            m.event("fleet_drain", unacked=audit.unacked,
                    double_exec=audit.double_exec,
                    leases_left=leases, leases_swept=swept)
        return {"unacked": audit.unacked,
                "double_exec": audit.double_exec,
                "leases_left": leases,
                "leases_swept": swept}

    def close(self) -> None:
        """Hard stop (idempotent): drain if not already, then make sure
        nothing is left running."""
        if not self.draining:
            self.drain()
        for w in self.workers.values():
            self._kill(w)

    # -------------------------------------------------------------- statusz
    def statusz_section(self) -> dict:
        """The ``--statusz`` fleet section: per-worker health /
        incarnation / backoff / breaker, journal depth, replay
        counters."""
        audit = self.journal.audit()
        workers = {}
        for slot, w in sorted(self.workers.items()):
            age = w.lease_age_s()
            workers[f"w{slot}"] = {
                "state": self.worker_state(w),
                "pid": w.proc.pid if w.proc is not None else None,
                "incarnation": w.incarnations,
                "incarnation_id": w.incarnation_id,
                "deaths": w.deaths,
                "backoff_s": round(w.backoff_s, 3),
                "breaker": w.breaker.snapshot(),
                "queries_served": w.queries_served,
                "lease_age_s": round(age, 3) if age is not None else None}
        out = {"workers": workers,
               "routable": self.routable_slots(),
               "draining": self.draining,
               "journal": {"depth": audit.unacked,
                           "peak_depth": self.peak_depth,
                           "path": self.journal.path,
                           **audit.to_json()},
               "queries": self.queries,
               "failovers": self.failovers,
               "replays": self.replays,
               "restarts": self.restarts,
               "journal_served": self.journal_served}
        if self.result_cache.max_entries:
            out["cache"] = self.result_cache.stats()
        if self.batch_window_ms > 0:
            out["batch"] = {"window_ms": self.batch_window_ms,
                            "affinity": dict(self.batch_affinity)}
        return out

    def readiness(self) -> dict:
        """``/healthz`` provider: the fleet is ready while it admits work
        and at least one worker can take a query."""
        if self.draining:
            return {"ok": False, "reason": "draining"}
        if not self.routable_slots():
            return {"ok": False, "reason": "no_healthy_worker"}
        return {"ok": True}

    # -------------------------------------------------------------- summary
    def summary(self) -> dict:
        audit = self.journal.audit()
        return {"workers": self.num_workers,
                "queries": self.queries,
                "failover": self.failovers,
                "replayn": self.replays,
                "worker_restarts": self.restarts,
                "incarnations": sum(w.incarnations
                                    for w in self.workers.values()),
                "journal_served": self.journal_served,
                "jdepth": self.peak_depth,
                "unacked": audit.unacked,
                "double_exec": audit.double_exec,
                "cache_hits": self.result_cache.hits,
                "cache_hit_rate": self.result_cache.stats()["hit_rate"],
                "quarantined": [s for s, w in self.workers.items()
                                if w.quarantined]}
