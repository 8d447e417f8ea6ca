"""Hang watchdog: a phase-progress monitor over the flight recorder.

The port's copy of ``tpu_radix_join/observability/watchdog.py``.  A hung
launch or collective blocks the host thread with no exception, and the
run stalls until someone kills it.  This monitor turns that into a
classified ``backend_unavailable`` outcome with forensics:

  * **progress signal** — the registry's flight recorder timestamps every
    begin / end / incr / event; a phase timer left open (``m._starts``
    non-empty) while the ring stays quiet for ``timeout_s`` means the
    pipeline stopped making progress (an idle session between queries has
    no open phase and is not a hang);
  * **evidence first** — on a trip the watchdog dumps every live thread's
    stack and, given a forensics directory, writes a post-mortem bundle
    before it tries the kill, so a thread that never reaches a cancel
    point still leaves a black box behind;
  * **kill path** — the engine's cooperative ``cancel`` hook
    (operators/hash_join.py ``_check_cancel``): :func:`engine_killer`
    rebinds it to raise :class:`HangDetected` at the next phase boundary
    or stall poll (``backend.stall`` spins there); a serving session
    passes its own ``kill`` (service/session.py), which its per-query
    hook reads before the deadline's.  Once the hang is established, its
    verdict outranks the budget clock.

The limit of the kill path: a host thread blocked inside a readback
(``.item()``, ``.cpu()``, ``torch.cuda.synchronize``) behind a kernel that
truly hangs on the card reaches no cancel point, so the raise never lands
and only the evidence does — the stacks show the thread in that call, and
the bundle is on disk.  Ending such a process is its supervisor's job.

The watchdog is a daemon thread; ``stop()`` (or the context manager's
exit) joins it.  One trip an instance: after firing it only waits for
``stop``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from tpu_radix_join_torch.observability.flightrec import dump_all_stacks

#: mirrors robustness.retry.BACKEND_UNAVAILABLE without importing the
#: robustness package from the observability layer (kept dependency-free
#: so flightrec/watchdog can be wired into Measurements itself)
BACKEND_UNAVAILABLE = "backend_unavailable"

DEFAULT_TIMEOUT_S = 30.0


class HangDetected(RuntimeError):
    """A watched run made no recorded progress for the timeout window."""

    failure_class = BACKEND_UNAVAILABLE

    def __init__(self, idle_s: float, open_phases, bundle: Optional[str]):
        phases = sorted(open_phases)
        super().__init__(
            f"watchdog: no progress for {idle_s:.1f}s with open phase(s) "
            f"{phases}; classified {BACKEND_UNAVAILABLE}"
            + (f"; bundle at {bundle}" if bundle else ""))
        self.idle_s = idle_s
        self.open_phases = phases
        self.bundle = bundle


class Watchdog:
    """Monitor one Measurements registry for stalled progress.

    ``kill(exc)`` is invoked once on trip with the :class:`HangDetected`
    instance; use :func:`engine_killer` to target a HashJoin's ``cancel``
    hook.  ``bundle_kw`` is forwarded to postmortem.write_bundle (plan,
    config, chaos schedule, ...) so the bundle written at trip time is as
    complete as the terminal-failure one.
    """

    def __init__(self, measurements, timeout_s: float = DEFAULT_TIMEOUT_S,
                 kill: Optional[Callable] = None,
                 bundle_dir: Optional[str] = None,
                 poll_s: Optional[float] = None,
                 membership=None,
                 **bundle_kw):
        self.measurements = measurements
        self.timeout_s = float(timeout_s)
        self.kill = kill
        self.bundle_dir = bundle_dir
        #: duck-typed membership view (robustness/membership.py — the
        #: observability layer stays import-free of robustness): an object
        #: with ``suspect() -> Optional[Exception]``.  On a trip the
        #: watchdog asks it FIRST — a stalled collective plus a lapsed
        #: lease is a dead peer (``rank_lost``, recoverable), not a downed
        #: backend (``backend_unavailable``, terminal).
        self.membership = membership
        self.bundle_kw = bundle_kw
        # poll fast enough that a trip lands well inside one timeout
        # window even for sub-second test timeouts
        self.poll_s = poll_s if poll_s is not None \
            else max(0.01, min(1.0, self.timeout_s / 5.0))
        self.tripped = False
        self.exc: Optional[Exception] = None   # HangDetected or the
                                               # membership view's RankLost
        self.bundle_path: Optional[str] = None
        self.stacks = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="join-watchdog", daemon=True)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Watchdog":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- monitor
    def _run(self) -> None:
        m = self.measurements
        while not self._stop.wait(self.poll_s):
            # progress = something recorded recently OR nothing in flight
            # (an idle session between queries is not a hang)
            if not m._starts:
                continue
            idle = m.flightrec.idle_s()
            if idle >= self.timeout_s:
                self._trip(idle)
                return

    def _suspect(self):
        """Stall triage: ask the membership view whether a lapsed lease
        explains the stall.  Returns the exception to deliver (``None``
        means no membership / all peers live — keep the hang verdict)."""
        if self.membership is None:
            return None
        try:
            return self.membership.suspect()
        except Exception as e:   # noqa: BLE001 — triage must not mask
            self.measurements.event("membership_suspect_error",
                                    error=repr(e)[:200])
            return None

    def _trip(self, idle_s: float) -> None:
        m = self.measurements
        # one-shot trip on the only watchdog thread; readers
        # synchronize via stop()'s join before touching these
        self.tripped = True
        open_phases = list(m._starts)
        self.stacks = dump_all_stacks()
        from tpu_radix_join_torch.performance.measurements import WDOGTRIP
        # "suspect rank, check leases, fence" before "kill self": a dead
        # peer's stall is recoverable and must not be booked as a
        # watchdog death (the chaos soak asserts WDOGTRIP==0 for
        # recovered runs)
        rank_exc = self._suspect()
        cls = getattr(rank_exc, "failure_class", BACKEND_UNAVAILABLE)
        reason = "rank_lost" if rank_exc is not None else "watchdog_trip"
        if rank_exc is None:
            m.incr(WDOGTRIP)
        m.event("watchdog_trip", idle_s=round(idle_s, 3),
                open_phases=sorted(open_phases),
                failure_class=cls)
        if self.bundle_dir:
            try:
                from tpu_radix_join_torch.observability.postmortem import \
                    write_bundle
                self.bundle_path = write_bundle(
                    self.bundle_dir, measurements=m,
                    reason=reason,
                    failure_class=cls,
                    stacks=self.stacks,
                    extra={"idle_s": round(idle_s, 3),
                           "open_phases": sorted(open_phases)},
                    **self.bundle_kw)
            except Exception as e:   # noqa: BLE001 — forensics must not
                m.event("bundle_error", error=repr(e)[:200])  # mask the hang
        if rank_exc is not None:
            rank_exc.bundle = self.bundle_path
            self.exc = rank_exc
        else:
            self.exc = HangDetected(
                idle_s, open_phases, self.bundle_path)
        if self.kill is not None:
            try:
                self.kill(self.exc)
            except Exception as e:   # noqa: BLE001
                m.event("watchdog_kill_error", error=repr(e)[:200])


def engine_killer(engine) -> Callable:
    """Kill-path factory for a HashJoin-like engine: rebinds the
    cooperative ``cancel`` hook so the hung thread raises the watchdog's
    exception at its next ``_check_cancel`` (phase boundary or stall
    poll)."""

    def _kill(exc: Exception) -> None:
        def _raise(phase: str, _exc=exc):
            raise _exc
        engine.cancel = _raise

    return _kill
