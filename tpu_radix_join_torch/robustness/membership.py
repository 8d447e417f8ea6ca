"""Lease-based rank membership with epoch fencing.

The port's copy of ``tpu_radix_join/robustness/membership.py``: host code
over files, with nothing of the device in it.

  * **Leases** — every rank heartbeats a small epoch-stamped JSON lease
    (``lease_r<rank>.json``) into a shared run directory
    (:class:`LeaseBoard`).  The beat rides an existing cadence: the
    metrics sampler's tick through :meth:`LeaseBoard.sampler_extra`, or a
    caller's loop.  A write is atomic (tmp + ``os.replace``) and never
    raises: a full disk must not kill a healthy rank.
  * **Lapse detection** — a rank whose lease is older than the lapse
    window (``missed_beats`` x ``lease_s``; a rank that never wrote one,
    once that window has passed since the board was made) is lapsed.
    Wall-clock timestamps (``time.time``) are the only clock comparable
    across processes; the window is seconds-coarse.
  * **Epoch fencing** — :class:`MembershipView` turns lapses into a
    declaration: the rank joins ``lost``, RANKLOST ticks and the membership
    epoch bumps (MEPOCH).  Work stamped with an older epoch is rejected by
    :meth:`MembershipView.fence` raising :class:`StaleEpoch`.
  * **Admission** — a new process writes a ``joining`` lease and every
    member's next :meth:`MembershipView.check` admits it once, one fenced
    epoch bump a batch (RANKJOIN).  A rank declared lost re-enters only
    that way, at a later epoch.

Every rank computes the same view from the shared directory, with no
coordinator.  The join engine scans it at every phase boundary
(``HashJoin._check_cancel``: its own heartbeat, admissions, then lapses)
and exports its manifest progress on every beat (``progress_of``); a
newcomer catches up with the incumbents' fences through
:meth:`MembershipView.sync_epoch`.  A serve worker's lease is its
liveness, which a supervisor reads by its age.

The watchdog's bridge is duck-typed: :meth:`MembershipView.suspect`
returns a :class:`RankLost` when a lapsed lease explains a stall, else
None, and the watchdog asks it before classifying the stall
``backend_unavailable``.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from tpu_radix_join_torch.performance.measurements import (MEPOCH,
                                                           RANKJOIN,
                                                           RANKLOST)
from tpu_radix_join_torch.robustness.retry import RANK_JOIN, RANK_LOST


class RankLost(ConnectionError):
    """A peer rank's lease lapsed (or its death was injected) mid-run.

    Deliberately NOT blind-retryable (see retry.py's class catalog): the
    remedy is elastic recovery (fence the epoch, re-plan on the survivors,
    resume at partition granularity; robustness/recovery.py), never a
    same-shape rerun, which would block on the same dead collective."""

    failure_class = RANK_LOST

    def __init__(self, rank: int, epoch: int, detail: str = ""):
        super().__init__(
            f"rank {rank} lost at membership epoch {epoch}"
            + (f": {detail}" if detail else ""))
        self.rank = rank
        self.epoch = epoch
        # forensics bundles fold this in next to the error repr
        # (main._emit_failure_bundle), same contract as CoordinatorTimeout
        self.bundle_extra = {"lost_rank": rank, "membership_epoch": epoch}


class RankJoined(RuntimeError):
    """A joining rank was admitted mid-join (the epoch bumped under us).

    NOT a failure — control flow for the elastic wrapper: in-flight work
    is stamped with the pre-admission epoch, so the engine finishes the
    join on the *grown* membership (recovery's re-expansion path with
    ``joined_ranks``) instead of dispatching stale-epoch collectives.
    Raised only when growth handling is enabled (``elastic_grow``)."""

    failure_class = RANK_JOIN

    def __init__(self, ranks, epoch: int):
        ranks = tuple(int(r) for r in ranks)
        super().__init__(
            f"rank(s) {list(ranks)} admitted at membership epoch {epoch} — "
            f"re-plan on the grown mesh")
        self.ranks = ranks
        self.epoch = epoch
        self.bundle_extra = {"joined_ranks": list(ranks),
                             "membership_epoch": epoch}


class StaleEpoch(RuntimeError):
    """Epoch-fenced rejection: work stamped with an old membership epoch
    reached a collective/dispatch boundary after the mesh shrank.  Shares
    the ``rank_lost`` failure class — the *cause* is the lost rank; the
    fence merely converts what would have been a deadlock into a
    classified exit the recovery path owns."""

    failure_class = RANK_LOST

    def __init__(self, stamped: int, current: int):
        super().__init__(
            f"stale membership epoch: work stamped epoch {stamped} but the "
            f"mesh is at epoch {current} — re-plan on the survivor mesh")
        self.stamped = stamped
        self.current = current


@dataclass(frozen=True)
class Lease:
    """One rank's most recent heartbeat.

    ``status`` is ``"member"`` for a participating rank or ``"joining"``
    for a newcomer awaiting admission; ``partitions_done`` mirrors the
    rank's partition manifest's progress at beat time (-1 = unknown or no
    manifest; ``HashJoin`` installs ``progress_of`` when it joins with
    both a view and a manifest) — the per-rank progress clock a straggler
    detector reads (robustness/straggler.py)."""

    rank: int
    epoch: int
    t_epoch_s: float
    pid: int
    host: str
    seq: int
    status: str = "member"
    partitions_done: int = -1


class LeaseBoard:
    """Per-rank lease files in a shared run directory.

    File ``lease_r<rank>.json`` holds one :class:`Lease` as JSON; writes
    are atomic (tmp + ``os.replace``) so a reader never observes a torn
    lease, and :meth:`heartbeat` never raises — losing one heartbeat to
    a transient I/O error must not kill a healthy rank (the same
    durability-beats-availability rule as checkpoint saves).
    """

    def __init__(self, run_dir: str, rank: int, num_ranks: int,
                 lease_s: float = 5.0,
                 clock: Callable[[], float] = time.time,
                 measurements=None, missed_beats: int = 2):
        if lease_s <= 0:
            raise ValueError(f"lease_s must be positive, got {lease_s}")
        if missed_beats < 1:
            raise ValueError(f"missed_beats must be >= 1, got {missed_beats}")
        self.run_dir = run_dir
        self.rank = int(rank)
        self.num_ranks = int(num_ranks)
        self.lease_s = float(lease_s)
        self.missed_beats = int(missed_beats)
        self.clock = clock
        self.measurements = measurements
        #: optional zero-arg progress hook: every heartbeat folds its value
        #: in as ``partitions_done`` — liveness and progress ride one beat
        self.progress_of: Optional[Callable[[], int]] = None
        self._seq = 0
        # heartbeat() runs on the metrics-sampler daemon tick (via
        # sampler_extra) AND on the main thread's join loop — unguarded,
        # both racers share one ``<path>.tmp.<pid>`` scratch name, so a
        # torn interleaving can replace a half-written lease
        self._lock = threading.Lock()
        self._t0 = clock()      # grace anchor for never-heartbeated ranks
        os.makedirs(run_dir, exist_ok=True)

    def lease_path(self, rank: int) -> str:
        return os.path.join(self.run_dir, f"lease_r{rank}.json")

    @property
    def lapse_window_s(self) -> float:
        """Seconds of silence before a rank is lapsed: ``missed_beats``
        consecutive lease windows (one slow device pass on a healthy
        rank costs one beat, not a death certificate)."""
        return self.lease_s * self.missed_beats

    # ------------------------------------------------------------ heartbeat
    def heartbeat(self, epoch: int = 0, status: str = "member") -> dict:
        """Write this rank's lease; returns the lease dict (merged into
        sampler ticks by :meth:`sampler_extra`).  Never raises.

        ``status="joining"`` is the admission request: a newcomer beats
        with it until every member's view has admitted the rank."""
        with self._lock:
            self._seq += 1
            done = -1
            if self.progress_of is not None:
                try:
                    done = int(self.progress_of())
                except Exception:
                    done = -1       # progress is advisory, never lethal
            rec = {"rank": self.rank, "epoch": int(epoch),
                   "t_epoch_s": self.clock(), "pid": os.getpid(),
                   "host": socket.gethostname(), "seq": self._seq,
                   "status": str(status), "partitions_done": done}
            path = self.lease_path(self.rank)
            tmp = f"{path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    json.dump(rec, f)
                    f.flush()
                os.replace(tmp, path)
            except OSError as e:
                rec = dict(rec, error=repr(e))
                m = self.measurements
                if m is not None:
                    m.event("lease_write_failed", rank=self.rank,
                            error=repr(e))
                try:
                    os.remove(tmp)
                except OSError:
                    pass
            return rec

    def sampler_extra(self, epoch_of: Optional[Callable[[], int]] = None,
                      status_of: Optional[Callable[[], str]] = None
                      ) -> Callable[[], dict]:
        """A zero-arg hook for ``MetricsSampler(extra=...)``: every sampler
        tick heartbeats the lease and folds it into the metrics record —
        liveness rides the telemetry cadence instead of a second thread
        (and doubles as the secondary beat that keeps a healthy rank
        under the ``missed_beats`` lapse threshold during long device
        passes).  ``epoch_of`` supplies the current membership epoch per
        tick (e.g. ``view.epoch_of``); ``status_of`` the lease status
        (e.g. ``view.my_status`` on a joining process)."""
        def _extra() -> dict:
            ep = epoch_of() if epoch_of is not None else 0
            st = status_of() if status_of is not None else "member"
            return {"lease": self.heartbeat(ep, status=st)}
        return _extra

    # -------------------------------------------------------------- reading
    def read(self, rank: int) -> Optional[Lease]:
        """The rank's current lease, or None (missing/torn files read as
        absent — a torn lease is indistinguishable from a dead writer
        and ages out the same way)."""
        try:
            with open(self.lease_path(rank)) as f:
                d = json.load(f)
            return Lease(rank=int(d["rank"]), epoch=int(d["epoch"]),
                         t_epoch_s=float(d["t_epoch_s"]), pid=int(d["pid"]),
                         host=str(d.get("host", "")), seq=int(d.get("seq", 0)),
                         status=str(d.get("status", "member")),
                         partitions_done=int(d.get("partitions_done", -1)))
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            return None

    def discover(self) -> List[int]:
        """Every rank with a lease file in the run directory, including
        ranks beyond the boot ``num_ranks`` — how members notice a
        newcomer's ``joining`` lease without being told its rank."""
        ranks = set(range(self.num_ranks))
        try:
            names = os.listdir(self.run_dir)
        except OSError:
            names = []
        for name in names:
            if name.startswith("lease_r") and name.endswith(".json"):
                try:
                    ranks.add(int(name[len("lease_r"):-len(".json")]))
                except ValueError:
                    continue
        return sorted(ranks)

    @staticmethod
    def next_rank(run_dir: str, floor: int = 0) -> int:
        """The first unused rank id in ``run_dir`` at or above ``floor``
        — how a joining process picks its rank without a coordinator
        (deterministic from shared state, like everything else here)."""
        taken = set()
        try:
            names = os.listdir(run_dir)
        except OSError:
            names = []
        for name in names:
            if name.startswith("lease_r") and name.endswith(".json"):
                try:
                    taken.add(int(name[len("lease_r"):-len(".json")]))
                except ValueError:
                    continue
        r = int(floor)
        while r in taken:
            r += 1
        return r

    def snapshot(self, ranks=None) -> Dict[int, Lease]:
        """Current leases for ``ranks`` (default: every discovered rank,
        so joiners show up)."""
        ranks = self.discover() if ranks is None else ranks
        return {r: lease for r in ranks
                if (lease := self.read(r)) is not None}

    def lapsed(self, now: Optional[float] = None, ranks=None) -> List[int]:
        """Ranks whose lease age exceeds :attr:`lapse_window_s` —
        ``missed_beats`` consecutive windows without a beat, so one long
        device pass is a missed beat, not a lapse.  A rank that never
        wrote a lease lapses once the same window has elapsed since this
        board was created (startup grace: a slow-booting peer is not
        declared dead before it had a full window to appear).  ``ranks``
        overrides the scanned domain (the membership view passes its
        possibly-grown member set)."""
        now = self.clock() if now is None else now
        out = []
        for r in (range(self.num_ranks) if ranks is None else sorted(ranks)):
            if r == self.rank:
                continue          # self-liveness is tautological
            lease = self.read(r)
            anchor = self._t0 if lease is None else lease.t_epoch_s
            if now - anchor > self.lapse_window_s:
                out.append(r)
        return out

    def withdraw(self, rank: int) -> None:
        """Delete a rank's lease — the chaos/test hook for simulating an
        instant death without waiting out the lapse window."""
        try:
            os.remove(self.lease_path(rank))
        except OSError:
            pass


class MembershipView:
    """Fenced membership state derived from a :class:`LeaseBoard`.

    ``epoch`` starts at 0 (the boot mesh) and bumps once per
    :meth:`check` batch that declares new losses OR admits new joiners —
    ``MEPOCH`` counts the bumps, so the counter *is* the epoch.
    Membership changes only through fenced batches: a rank that
    re-appears after being declared lost must rejoin through the
    ``joining``-lease admission path at a future epoch, never silently
    re-enter the current one — its in-flight state is gone.
    """

    def __init__(self, board: LeaseBoard, measurements=None):
        self.board = board
        self.measurements = measurements
        self.epoch = 0
        self.lost: set = set()
        #: ranks admitted beyond (or back into) the boot mesh, in
        #: admission order — recovery's ``joined_ranks`` input
        self.joined: set = set()

    # epoch accessor shaped for LeaseBoard.sampler_extra(epoch_of=...)
    def epoch_of(self) -> int:
        return self.epoch

    @property
    def members(self) -> set:
        """The membership domain: boot ranks plus every admitted joiner
        (``lost`` ranks stay in the domain — they are members that died,
        which is what the lapse scan must keep asserting)."""
        return set(range(self.board.num_ranks)) | self.joined

    @property
    def survivors(self) -> List[int]:
        return sorted(r for r in self.members if r not in self.lost)

    def is_live(self, rank: int) -> bool:
        return rank in self.members and rank not in self.lost

    def my_status(self) -> str:
        """This process's lease status: ``"joining"`` until its own view
        admits it (shaped for ``sampler_extra(status_of=...)``)."""
        return "member" if self.is_live(self.board.rank) else "joining"

    def _declare(self, ranks: List[int], cause: str) -> List[int]:
        fresh = [r for r in ranks if r not in self.lost]
        if not fresh:
            return []
        self.lost.update(fresh)
        self.epoch += 1
        m = self.measurements
        if m is not None:
            # context first: the MEPOCH/RANKLOST records below — and every
            # later HEDGED/HEDGEWIN/RANKJOIN tick — must carry the epoch
            # they happened under, not leave forensics to infer it from
            # neighboring records
            m.flightrec.set_context(membership_epoch=self.epoch)
            m.incr(MEPOCH)
            m.incr(RANKLOST, len(fresh))
            m.event("rank_lost", ranks=fresh, epoch=self.epoch, cause=cause,
                    survivors=len(self.survivors))
        return fresh

    def _admit(self, ranks: List[int], cause: str) -> List[int]:
        """The growth mirror of :meth:`_declare`: admit a batch of
        joining ranks with ONE epoch bump (a host bringing up several
        processes joins in one fence, not N).  A previously-lost rank
        re-enters here — at the new epoch, as promised."""
        fresh = [r for r in ranks if not self.is_live(r)]
        if not fresh:
            return []
        for r in fresh:
            self.lost.discard(r)
            self.joined.add(r)
        self.epoch += 1
        m = self.measurements
        if m is not None:
            m.flightrec.set_context(membership_epoch=self.epoch)
            m.incr(MEPOCH)
            m.incr(RANKJOIN, len(fresh))
            m.event("rank_join", ranks=fresh, epoch=self.epoch, cause=cause,
                    members=len(self.survivors))
        return fresh

    def _scan_joiners(self, now: Optional[float] = None) -> List[int]:
        """Discovered ranks with a *fresh* ``joining`` lease that are not
        live members.  Staleness matters: a joiner that died before
        admission must age out of its request, not be admitted into a
        mesh it can no longer serve."""
        now = self.board.clock() if now is None else now
        out = []
        for r in self.board.discover():
            if self.is_live(r):
                continue
            lease = self.board.read(r)
            if (lease is not None and lease.status == "joining"
                    and now - lease.t_epoch_s <= self.board.lapse_window_s):
                out.append(r)
        return out

    def check(self, now: Optional[float] = None) -> List[int]:
        """Scan leases; admit fresh joiners, then declare newly lapsed
        ranks lost (one epoch bump per admission batch and one per loss
        batch regardless of how many ranks moved together — a host loss
        takes its ranks in one fence, not N).  Returns the newly lost
        ranks (admissions are visible via :attr:`joined` and the epoch).
        Cheap enough for phase-boundary polling: one small-file read per
        peer."""
        self._admit(self._scan_joiners(now), cause="joining_lease")
        return self._declare(self.board.lapsed(now, ranks=self.members),
                             cause="lease_lapse")

    def sync_epoch(self) -> int:
        """Adopt the highest epoch any live lease carries — how a joiner
        (booted at epoch 0) catches up with a mesh whose incumbents
        already fenced through losses/admissions it never observed.
        Never rewinds."""
        for lease in self.board.snapshot().values():
            if lease.epoch > self.epoch:
                self.epoch = lease.epoch
        return self.epoch

    def declare_lost(self, rank: int, cause: str = "declared") -> int:
        """Explicit declaration (watchdog suspicion confirmed, chaos
        injection).  Withdraws the lease too so every survivor's next
        scan converges on the same verdict.  Returns the new epoch."""
        self.board.withdraw(rank)
        self._declare([rank], cause=cause)
        return self.epoch

    # --------------------------------------------------------------- fencing
    def fence(self, stamped_epoch: int) -> None:
        """Reject work stamped with an old epoch (see :class:`StaleEpoch`)."""
        if stamped_epoch != self.epoch:
            raise StaleEpoch(stamped_epoch, self.epoch)

    def require_live(self, rank: int) -> None:
        if rank in self.lost:
            raise RankLost(rank, self.epoch, "rank already declared lost")

    # ------------------------------------------------------- watchdog bridge
    def suspect(self) -> Optional[RankLost]:
        """The watchdog's stall triage: a stalled collective *plus* a
        lapsed lease is a dead peer, not a downed backend.  Runs a lease
        scan; if any rank is (or just became) lost, returns a
        :class:`RankLost` for the watchdog to deliver — recovery owns it
        from there.  Returns None when every peer is live (the stall is
        the backend's fault; the watchdog keeps its
        ``backend_unavailable`` verdict)."""
        self.check()
        if not self.lost:
            return None
        rank = min(self.lost)
        return RankLost(rank, self.epoch, "lease lapsed during stall")
