"""Seeded, deterministic fault injection at named sites.

The port's copy of the injector of ``tpu_radix_join/robustness/faults.py``
(``:95-251``) with the sites the out-of-core grid, the chunk stream, the
checkpoints, the process-group connect (``parallel/multihost.initialize``),
the join engine's construction (``engine.device_init``), its retry loops
(``engine.shuffle_overflow``), its
exchange (``exchange.corrupt_lane``), its cancel hook (``backend.stall``)
and its phase boundaries (``membership.rank_death``, ``membership.rank_join``,
``compute.straggle``),
the join service (``backend.dispatch``, ``serve.cache_poison``) and the
fleet supervisor (``fleet.worker_kill``) consult.  An armed
:class:`FaultInjector` decides from its seed whether a site fires on each
hit; a fired site raises (a simulated kill or transient error) or tells its
caller to damage its own state (a sentinel key in a streamed lane, a
flipped key bit before the exchange)::

    with FaultInjector(seed=7).arm(faults.GRID_KILL, at=3, exc=InjectedKill):
        chunked_join_grid(...)        # the third pair raises InjectedKill

Injectors nest; only the innermost one is consulted.  Per-site decisions
come from ``random.Random(f"{seed}:{site}")``, so the same seed and the
same hits replay the same failures.  The site strings are the JAX
package's, but each package consults its own registry: an injector armed
in one never fires in the other.
"""

from __future__ import annotations

import difflib
import random
import warnings
from typing import Dict, List, Optional, Tuple

from tpu_radix_join_torch.performance.measurements import FINJECT
from tpu_radix_join_torch.robustness.retry import BACKEND_UNAVAILABLE

GRID_KILL = "grid.mid_chunk_kill"          # hard kill between chunk pairs
GRID_TRANSIENT = "grid.transient"          # retryable per-pair hiccup
STREAM_CORRUPT = "stream.corrupt_lane"     # sentinel-damaged key lane
CKPT_SAVE = "checkpoint.save"              # checkpoint write I/O error
CKPT_LOAD = "checkpoint.load"              # checkpoint read I/O error
COORD_CONNECT = "multihost.coordinator_connect"   # process-group connect
SHUFFLE_OVERFLOW = "engine.shuffle_overflow"   # a reported outer shortfall
DEVICE_INIT = "engine.device_init"         # the card is unavailable at
                                           # engine construction
                                           # (robustness/degrade.py)
EXCHANGE_CORRUPT = "exchange.corrupt_lane"     # a bit-flipped outer key
BACKEND_DISPATCH = "backend.dispatch"      # a query's dispatch fails
                                           # (service/session.py)
BACKEND_STALL = "backend.stall"            # the engine spins at its cancel
                                           # hook, as a hung collective would
RANK_DEATH = "membership.rank_death"       # a rank dies at a phase boundary:
                                           # the survivors fence the epoch
                                           # and recover (robustness/
                                           # recovery.py), never hang
RANK_JOIN = "membership.rank_join"         # a newcomer's ``joining`` lease
                                           # appears mid-run: the view admits
                                           # it and the join re-expands
COMPUTE_STRAGGLE = "compute.straggle"      # a live rank slows down: hedged
                                           # (robustness/straggler.py), never
                                           # declared dead
FLEET_WORKER_KILL = "fleet.worker_kill"    # SIGKILL a fleet worker right
                                           # after its query hit the pipe:
                                           # the supervisor must journal-
                                           # replay the query on a healthy
                                           # worker (service/fleet.py)
CACHE_POISON = "serve.cache_poison"        # a stored result-cache entry is
                                           # corrupted in place; the read's
                                           # digest check must drop it

SITES = (GRID_KILL, GRID_TRANSIENT, STREAM_CORRUPT, CKPT_SAVE, CKPT_LOAD,
         COORD_CONNECT, SHUFFLE_OVERFLOW, DEVICE_INIT, EXCHANGE_CORRUPT,
         BACKEND_DISPATCH, BACKEND_STALL, RANK_DEATH, RANK_JOIN,
         COMPUTE_STRAGGLE, FLEET_WORKER_KILL, CACHE_POISON)


class InjectedFault(RuntimeError):
    """Raised by :meth:`FaultInjector.check` when a site fires."""

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected fault at {site!r} (hit {hit})")
        self.site = site
        self.hit = hit


class InjectedKill(InjectedFault):
    """Simulated hard kill (mid-grid death): never retried in-process."""


class TransientFault(InjectedFault):
    """Simulated transient error: safe to retry, classified as an
    unavailable backend so :func:`retry.is_retryable_class` accepts it."""

    failure_class = BACKEND_UNAVAILABLE


class _Arm:
    def __init__(self, site: str, seed: int, at, p, times, exc):
        self.site = site
        if at is not None and not isinstance(at, (tuple, list, set, frozenset)):
            at = (at,)
        self.at = frozenset(int(a) for a in at) if at is not None else None
        self.p = p
        self.times = times if times is not None else (
            len(self.at) if self.at is not None else None)
        self.exc = exc
        self.hits = 0
        self.fired = 0
        self._rng = random.Random(f"{seed}:{site}")

    def decide(self) -> bool:
        self.hits += 1
        if self.times is not None and self.fired >= self.times:
            return False
        if self.at is not None:
            fire = self.hits in self.at
        elif self.p is not None:
            fire = self._rng.random() < self.p
        else:
            fire = True
        if fire:
            self.fired += 1
        return fire


class FaultInjector:
    """Context-manager fault registry.  ``measurements`` (optional)
    receives one ``FINJECT`` and a ``fault`` event per fire."""

    def __init__(self, seed: int = 0, measurements=None):
        self.seed = seed
        self.measurements = measurements
        self._arms: Dict[str, _Arm] = {}
        #: every (site, hit) that fired, in order: the replay record a
        #: forensics bundle keeps
        self.history: List[Tuple[str, int]] = []

    def arm(self, site: str, *, at=None, p: Optional[float] = None,
            times: Optional[int] = None, exc=None) -> "FaultInjector":
        """Arm ``site``; returns self.  ``at``: 1-based hit index (or
        indices) to fire at; ``p``: per-hit probability; neither: every
        hit.  ``times`` caps the fires (default ``len(at)``).  ``exc``: what
        :meth:`check` raises (default :class:`InjectedFault`)."""
        if site not in SITES:
            near = difflib.get_close_matches(site, SITES, n=1, cutoff=0.6)
            hint = f"; did you mean {near[0]!r}?" if near else ""
            warnings.warn(
                f"arming unknown fault site {site!r}: no code of the port "
                f"consults it, so this arm will never fire{hint}",
                RuntimeWarning, stacklevel=2)
        self._arms[site] = _Arm(site, self.seed, at, p, times, exc)
        return self

    def fires(self, site: str, measurements=None) -> bool:
        arm = self._arms.get(site)
        if arm is None or not arm.decide():
            return False
        self.history.append((site, arm.hits))
        for m in (self.measurements, measurements):
            if m is not None:
                m.incr(FINJECT)
                m.event("fault", site=site, hit=arm.hits)
        return True

    def check(self, site: str, measurements=None) -> None:
        """Raise the armed exception if ``site`` fires on this hit."""
        if not self.fires(site, measurements):
            return
        arm = self._arms[site]
        exc = arm.exc or InjectedFault
        if isinstance(exc, type) and issubclass(exc, InjectedFault):
            raise exc(site, arm.hits)
        raise exc(f"injected fault at {site!r} (hit {arm.hits})")

    def site_stats(self) -> Dict[str, Dict[str, int]]:
        """``{site: {"hits": n, "fired": n}}`` of every armed site: what a
        join stamps into ``diagnostics["fault_sites"]``."""
        return {site: {"hits": arm.hits, "fired": arm.fired}
                for site, arm in self._arms.items()}

    def hits(self, site: str) -> int:
        arm = self._arms.get(site)
        return arm.hits if arm else 0

    def fired(self, site: str) -> int:
        arm = self._arms.get(site)
        return arm.fired if arm else 0

    def __enter__(self) -> "FaultInjector":
        _STACK.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _STACK.remove(self)


_STACK: List[FaultInjector] = []


def active() -> Optional[FaultInjector]:
    """The innermost active injector, or None."""
    return _STACK[-1] if _STACK else None


def fires(site: str, measurements=None) -> bool:
    """False when no injector is active."""
    inj = active()
    return inj.fires(site, measurements) if inj is not None else False


def check(site: str, measurements=None) -> None:
    """Raise if ``site`` is armed and fires (no-op without an injector)."""
    inj = active()
    if inj is not None:
        inj.check(site, measurements)
