"""Admission-controlled query queue with per-tenant quotas.

The port's copy of ``tpu_radix_join/service/admission.py``: the resident
session's front door, a bounded FIFO that classifies every refusal.  Two
rules, checked in order at :meth:`AdmissionQueue.submit`:

  * **depth** — at most ``max_depth`` queries pending over all tenants;
  * **quota** — at most ``tenant_quota`` in-flight queries a tenant, so
    one chatty tenant cannot occupy the whole queue.

A refusal raises :class:`AdmissionRejected` with the
``admission_rejected`` failure class and a ``reason`` (``queue_full`` |
``tenant_quota``); the serve loop turns it into a classified outcome line.
One lock guards the deque and the per-tenant counts.
"""

from __future__ import annotations

import collections
import threading
from typing import Deque, Dict, Optional

from tpu_radix_join_torch.performance.measurements import QADMIT, QREJECT
from tpu_radix_join_torch.robustness.retry import ADMISSION_REJECTED

QUEUE_FULL = "queue_full"
TENANT_QUOTA = "tenant_quota"


class AdmissionRejected(RuntimeError):
    """Query refused at the door (never started executing)."""

    failure_class = ADMISSION_REJECTED

    def __init__(self, reason: str, detail: str):
        super().__init__(f"admission rejected ({reason}): {detail}")
        self.reason = reason


class AdmissionQueue:
    """Bounded FIFO of pending requests with per-tenant quotas.

    ``submit`` admits or raises; ``pop`` hands the oldest pending request
    to the session; ``done`` releases the tenant's slot once the query's
    outcome is recorded (a popped-but-running query still counts against
    its tenant — the quota bounds *in-flight* work, not just queue
    residency, or a tenant could dodge it by keeping exactly one query
    running).
    """

    def __init__(self, max_depth: int = 64, tenant_quota: int = 8,
                 measurements=None):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        if tenant_quota < 1:
            raise ValueError("tenant_quota must be >= 1")
        self.max_depth = max_depth
        self.tenant_quota = tenant_quota
        self.measurements = measurements
        self._lock = threading.Lock()
        self._pending: Deque[object] = collections.deque()
        self._in_flight: Dict[str, int] = collections.defaultdict(int)
        self.admitted = 0
        self.rejected = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)

    def depth(self) -> int:
        return len(self)

    def tenant_load(self, tenant: str) -> int:
        with self._lock:
            return self._in_flight[tenant]

    def submit(self, request) -> None:
        """Admit ``request`` (anything with a ``tenant`` attribute) or
        raise :class:`AdmissionRejected`.  The rejection is recorded as a
        counter + trace event before raising, so dashboards see rejections
        even when the caller swallows the exception."""
        tenant = getattr(request, "tenant", "default")
        m = self.measurements
        with self._lock:
            if len(self._pending) >= self.max_depth:
                reason, detail = QUEUE_FULL, (
                    f"queue depth {len(self._pending)} at max_depth "
                    f"{self.max_depth}")
            elif self._in_flight[tenant] >= self.tenant_quota:
                reason, detail = TENANT_QUOTA, (
                    f"tenant {tenant!r} has {self._in_flight[tenant]} "
                    f"in-flight queries at quota {self.tenant_quota}")
            else:
                self._pending.append(request)
                self._in_flight[tenant] += 1
                self.admitted += 1
                if m is not None:
                    m.incr(QADMIT)
                return
            self.rejected += 1
        if m is not None:
            m.incr(QREJECT)
            m.event("admission_rejected", tenant=tenant, reason=reason,
                    query_id=getattr(request, "query_id", None))
        raise AdmissionRejected(reason, detail)

    def pop(self) -> Optional[object]:
        """Oldest pending request, or None when the queue is empty.  The
        tenant's slot stays held until :meth:`done`."""
        with self._lock:
            return self._pending.popleft() if self._pending else None

    def pop_matching(self, pred, limit: int) -> list:
        """Up to ``limit`` pending requests satisfying ``pred``, removed
        in FIFO order; non-matching requests keep their relative order.
        The micro-batch coalescer's group-pull (service/session.py
        ``run_next_batch``): tenant slots stay held until :meth:`done`,
        exactly as with :meth:`pop`."""
        if limit <= 0:
            return []
        taken: list = []
        with self._lock:
            keep = collections.deque()
            while self._pending:
                request = self._pending.popleft()
                if len(taken) < limit and pred(request):
                    taken.append(request)
                else:
                    keep.append(request)
            self._pending = keep
        return taken

    def done(self, request) -> None:
        """Release the tenant slot taken at submit (call exactly once per
        popped request, on every outcome path)."""
        tenant = getattr(request, "tenant", "default")
        with self._lock:
            if self._in_flight[tenant] > 0:
                self._in_flight[tenant] -= 1

    def rejection_rate(self) -> float:
        total = self.admitted + self.rejected
        return self.rejected / total if total else 0.0
