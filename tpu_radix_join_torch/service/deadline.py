"""Per-query latency budgets with cooperative cancellation.

The port's copy of ``tpu_radix_join/service/deadline.py``.  A
:class:`Deadline` is armed when the query is admitted and consulted
between pipeline phases (the engine's ``cancel`` hook,
operators/hash_join.py, and the session's own phase boundaries), never
mid-launch, so a cancelled query leaves no half-written device state.  An
expired check raises :class:`DeadlineExceeded`, which carries the
``deadline_exceeded`` failure class.  The clock is injectable: tests drive
expiry mid-phase with a fake clock, and a session over several ranks
passes rank 0's clock to every rank (service/session.py), so every rank
expires at the same boundary.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from tpu_radix_join_torch.robustness.retry import DEADLINE_EXCEEDED


class DeadlineExceeded(RuntimeError):
    """A query's latency budget expired between phases."""

    failure_class = DEADLINE_EXCEEDED

    def __init__(self, budget_s: float, elapsed_s: float, phase: str):
        super().__init__(
            f"deadline {budget_s:.3f}s exceeded after {elapsed_s:.3f}s "
            f"(at phase {phase!r})")
        self.budget_s = budget_s
        self.elapsed_s = elapsed_s
        self.phase = phase


class Deadline:
    """Wall-clock budget for one query; ``budget_s=None`` never expires.

    ``check(phase)`` is the cooperative cancellation point — cheap enough
    to call between every phase (one clock read), and a no-op object
    (:func:`Deadline.unlimited`) keeps call sites branch-free.
    """

    def __init__(self, budget_s: Optional[float],
                 clock: Callable[[], float] = time.monotonic):
        if budget_s is not None and budget_s < 0:
            raise ValueError("deadline budget must be >= 0 (or None)")
        self.budget_s = budget_s
        self._clock = clock
        self._t0 = clock()

    @classmethod
    def unlimited(cls) -> "Deadline":
        return cls(None)

    def elapsed_s(self) -> float:
        return self._clock() - self._t0

    def remaining_s(self) -> Optional[float]:
        """Seconds left (never negative), or None when unlimited."""
        if self.budget_s is None:
            return None
        return max(0.0, self.budget_s - self.elapsed_s())

    def expired(self) -> bool:
        return (self.budget_s is not None
                and self.elapsed_s() >= self.budget_s)

    def check(self, phase: str = "") -> None:
        """Raise :class:`DeadlineExceeded` when the budget is spent.
        Signature matches the engine's ``cancel(phase)`` hook, so a
        Deadline plugs in directly as the cancellation callable."""
        if self.expired():
            raise DeadlineExceeded(self.budget_s, self.elapsed_s(), phase)
