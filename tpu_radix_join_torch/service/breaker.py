"""Circuit breaker over the primary (device) engine.

The port's copy of ``tpu_radix_join/service/breaker.py``:

  * **closed** — queries run on the primary engine.  Consecutive failures
    of a *tripping* class (``backend_unavailable``, ``retries_exhausted``,
    ``device_unavailable`` by default) count toward ``failure_threshold``;
    a success resets the streak.
  * **open** — queries route to the degraded CPU engine
    (robustness/degrade.py) with no primary dispatch.  After
    ``cooldown_s`` the breaker half-opens.
  * **half-open** — one query goes to the primary as a health probe
    (``BRKPROBE``).  Success closes the breaker; failure re-opens it.

Failures of other classes (capacity, corruption, deadline, key contract)
indict the query, not the backend, and never move the breaker.
Transitions are counted (``BRKTRIP`` / ``BRKPROBE``) and recorded as
events (``breaker_open`` / ``breaker_half_open`` / ``breaker_closed``).
The clock is injectable for fake-time tests.
"""

from __future__ import annotations

import time
from typing import Callable, FrozenSet, Optional

from tpu_radix_join_torch.performance.measurements import BRKPROBE, BRKTRIP
from tpu_radix_join_torch.robustness.retry import (BACKEND_UNAVAILABLE,
                                                   DEVICE_UNAVAILABLE,
                                                   RETRIES_EXHAUSTED)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: failure classes that indict the backend rather than the query
DEFAULT_TRIPPING: FrozenSet[str] = frozenset({
    BACKEND_UNAVAILABLE, RETRIES_EXHAUSTED, DEVICE_UNAVAILABLE})


class CircuitBreaker:
    """Consecutive-failure breaker with half-open health probes."""

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 30.0,
                 tripping: FrozenSet[str] = DEFAULT_TRIPPING,
                 clock: Callable[[], float] = time.monotonic,
                 measurements=None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.tripping = frozenset(tripping)
        self._clock = clock
        self.measurements = measurements
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        self.trips = 0          # lifetime closed/half-open -> open count
        self.probes = 0         # lifetime half-open probes dispatched

    # ---------------------------------------------------------------- routing
    def allow_primary(self) -> bool:
        """Route decision for the next query: True = dispatch on the
        primary engine; False = serve degraded.  Promotes OPEN ->
        HALF_OPEN once the cooldown has elapsed — the query that sees the
        promotion IS the health probe (record_success/record_failure
        resolves it)."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if (self._clock() - self.opened_at) < self.cooldown_s:
                return False
            self._transition(HALF_OPEN)
        # HALF_OPEN admits exactly one primary probe; concurrent callers
        # (none today — the session is single-threaded) would serialize on
        # the session loop anyway
        self.probes += 1
        m = self.measurements
        if m is not None:
            m.incr(BRKPROBE)
        return True

    # ------------------------------------------------------------- resolution
    def record_success(self) -> None:
        """A primary-engine query completed ok (or failed for a reason
        that does not indict the backend)."""
        self.consecutive_failures = 0
        if self.state == HALF_OPEN:
            self._transition(CLOSED)

    def record_failure(self, failure_class: Optional[str]) -> bool:
        """Account a primary-engine failure; returns True when this
        failure tripped (or re-tripped) the breaker.  Non-tripping classes
        reset the streak like successes do — see module docstring."""
        if failure_class not in self.tripping:
            self.record_success()
            return False
        if self.state == HALF_OPEN:
            self._trip(failure_class)        # probe failed: straight back
            return True
        self.consecutive_failures += 1
        if (self.state == CLOSED
                and self.consecutive_failures >= self.failure_threshold):
            self._trip(failure_class)
            return True
        return False

    # -------------------------------------------------------------- internals
    def _trip(self, failure_class: str) -> None:
        self.trips += 1
        m = self.measurements
        if m is not None:
            m.incr(BRKTRIP)
        self._transition(OPEN, failure_class=failure_class)

    def _transition(self, state: str, **detail) -> None:
        prev, self.state = self.state, state
        if state == OPEN:
            self.opened_at = self._clock()
            self.consecutive_failures = 0
        m = self.measurements
        if m is not None:
            m.event(f"breaker_{state}", prev=prev,
                    trips=self.trips, **detail)

    def snapshot(self) -> dict:
        return {"state": self.state, "trips": self.trips,
                "probes": self.probes,
                "consecutive_failures": self.consecutive_failures}
