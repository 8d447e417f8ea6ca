"""Retry policies and the machine-readable failure-class taxonomy.

The port's copy of ``tpu_radix_join/robustness/retry.py:70-242``: the
failure-class strings stamped into ``diagnostics["failure_class"]``,
:func:`classify_diagnostics` over the join's flag vector,
:class:`RetryPolicy` (exponential backoff with deterministic jitter),
:class:`RetriesExhausted` and :func:`execute`, which the out-of-core grid
runs each chunk pair under.  The strings are the JAX package's, so both
packages' diagnostics read alike.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

from tpu_radix_join_torch.performance.measurements import BACKOFFMS, RETRYN

# ------------------------------------------------------------ failure classes
OK = "ok"
CAPACITY_OVERFLOW = "capacity_overflow"
KEY_CONTRACT = "key_contract"
CONSERVATION = "conservation"
COUNT_OVERFLOW_RISK = "count_overflow_risk"
DATA_CORRUPTION = "data_corruption"
DEVICE_UNAVAILABLE = "device_unavailable"
COORDINATOR_TIMEOUT = "coordinator_timeout"
INTERRUPTED = "interrupted"
CHECKPOINT_MISMATCH = "checkpoint_mismatch"
RETRIES_EXHAUSTED = "retries_exhausted"
BACKEND_UNAVAILABLE = "backend_unavailable"
ADMISSION_REJECTED = "admission_rejected"
REQUEST_ERROR = "request_error"
DEADLINE_EXCEEDED = "deadline_exceeded"
RANK_LOST = "rank_lost"
RANK_JOIN = "rank_join"
PLAN_INFEASIBLE = "plan_infeasible"

#: diagnostics flags -> class, in priority order: fatal flags outrank
#: capacity shortfalls, so a key-contract violation never looks retryable
#: because an overflow flag fired in the same attempt
_FATAL_FLAGS = (
    ("key_contract_violations", KEY_CONTRACT),
    ("conservation_violations", CONSERVATION),
    ("data_corruption_partitions", DATA_CORRUPTION),
    ("count_overflow_risk", COUNT_OVERFLOW_RISK),
)
_CAPACITY_FLAGS = ("shuffle_overflow_r_tuples", "shuffle_overflow_s_tuples",
                   "local_overflow", "hot_overflow")


def classify_diagnostics(diag: dict) -> str:
    """Map a ``JoinResult.diagnostics`` dict to a failure-class string."""
    for flag, cls in _FATAL_FLAGS:
        if diag.get(flag, 0):
            return cls
    if any(diag.get(flag, 0) for flag in _CAPACITY_FLAGS):
        return CAPACITY_OVERFLOW
    return OK


#: classes a same-config rerun can fix: a sizing shortfall (regrow and
#: rerun) or a transient infrastructure error (re-dispatch on the same
#: shapes).  Everything else is fatal for the attempt.
RETRYABLE_SIZING = frozenset({CAPACITY_OVERFLOW})
RETRYABLE_TRANSIENT = frozenset({BACKEND_UNAVAILABLE, COORDINATOR_TIMEOUT})
DEFAULT_RETRYABLE = RETRYABLE_SIZING | RETRYABLE_TRANSIENT


def is_retryable_class(failure_class: str,
                       policy: Optional["RetryPolicy"] = None) -> bool:
    """Whether ``failure_class`` is retryable under ``policy`` (its
    ``retryable_classes``; :data:`DEFAULT_RETRYABLE` without a policy)."""
    classes = (policy.retryable_classes if policy is not None
               else DEFAULT_RETRYABLE)
    return failure_class in classes


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter.

    ``delay_s(attempt)`` is the sleep after failed attempt ``attempt``
    (0-based): ``base_delay_s * multiplier**attempt`` capped at
    ``max_delay_s``, then scaled by a factor in ``[1 - jitter, 1 + jitter]``
    drawn from ``Random((seed << 16) ^ attempt)``, so a schedule replays.
    ``max_elapsed_s`` (optional) stops :func:`execute` retrying once that
    much wall-clock time has passed since the first attempt."""

    max_attempts: int = 3
    base_delay_s: float = 0.5
    multiplier: float = 2.0
    max_delay_s: float = 30.0
    jitter: float = 0.0
    seed: int = 0
    max_elapsed_s: Optional[float] = None
    #: failure classes :func:`is_retryable_class` accepts under this policy
    retryable_classes: frozenset = DEFAULT_RETRYABLE

    def delay_s(self, attempt: int) -> float:
        d = min(self.max_delay_s,
                self.base_delay_s * self.multiplier ** attempt)
        if self.jitter and d > 0:
            u = random.Random((self.seed << 16) ^ attempt).random()
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return d

    def schedule(self) -> Tuple[float, ...]:
        """The full backoff schedule (one sleep between each attempt pair)."""
        return tuple(self.delay_s(a) for a in range(self.max_attempts - 1))


class RetriesExhausted(RuntimeError):
    """A retryable failure persisted through every attempt."""

    failure_class = RETRIES_EXHAUSTED

    def __init__(self, label: str, attempts: int, last_error: BaseException):
        super().__init__(
            f"{label}: {attempts} attempt(s) exhausted; last error: "
            f"{last_error!r}")
        self.label = label
        self.attempts = attempts
        self.last_error = last_error


def execute(fn: Callable, policy: RetryPolicy, *,
            retryable: Tuple[Type[BaseException], ...] = (
                ConnectionError, TimeoutError, OSError),
            sleep: Callable[[float], None] = time.sleep,
            clock: Callable[[], float] = time.monotonic,
            measurements=None,
            on_retry: Optional[Callable] = None,
            label: str = "retry") -> object:
    """Call ``fn()`` under ``policy``.

    An exception in ``retryable``, or one whose ``failure_class`` is
    retryable under ``policy``, backs off and retries (``RETRYN`` and
    ``BACKOFFMS`` counters and a ``retry`` event per attempt); anything
    else propagates at once.  When the attempts or the ``max_elapsed_s``
    budget run out, raises :class:`RetriesExhausted` chaining the last
    error.  ``sleep`` and ``clock`` are injectable for tests."""

    def _should_retry(e: BaseException) -> bool:
        if isinstance(e, retryable):
            return True
        cls = getattr(e, "failure_class", None)
        return cls is not None and is_retryable_class(cls, policy)

    t0 = clock()
    last: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except Exception as e:
            if not _should_retry(e):
                raise
            last = e
            out_of_time = (policy.max_elapsed_s is not None
                           and clock() - t0 >= policy.max_elapsed_s)
            if attempt == policy.max_attempts - 1 or out_of_time:
                raise RetriesExhausted(label, attempt + 1, last) from last
            delay = policy.delay_s(attempt)
            if measurements is not None:
                measurements.incr(RETRYN)
                measurements.incr(BACKOFFMS, int(delay * 1000))
                measurements.event("retry", site=label, attempt=attempt + 1,
                                   delay_s=round(delay, 6), error=repr(e))
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
    raise RetriesExhausted(label, policy.max_attempts, last) from last
