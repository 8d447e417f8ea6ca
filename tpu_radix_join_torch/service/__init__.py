"""Resident join service: admission-controlled sessions with deadlines, a
backend circuit breaker, per-query failure isolation, the serving fast
paths and the crash-only fleet (the port of ``tpu_radix_join/service``).

Public surface:

  * :class:`JoinSession` / :class:`QueryRequest` / :class:`QueryOutcome`
    — the resident engine and its per-query verdicts (session.py);
  * :class:`AdmissionQueue` / :class:`AdmissionRejected` — the bounded,
    per-tenant front door (admission.py);
  * :class:`Deadline` / :class:`DeadlineExceeded` — cooperative per-query
    budgets (deadline.py);
  * :class:`CircuitBreaker` — closed / open / half-open routing over the
    device engine (breaker.py);
  * :class:`SLORecorder` — per-tenant latency percentiles and outcome
    rates (slo.py);
  * :class:`QueryJournal` / :func:`request_fingerprint` — the
    intent/outcome journal and a submission's fingerprint (journal.py);
  * :class:`ResultCache` / :func:`content_fingerprint` — whole-query
    reuse keyed by relation content (resultcache.py);
  * :class:`MicroBatcher` / :func:`batch_signature` — bounded-window
    coalescing into fused device programs (microbatch.py);
  * :class:`ResidentStateManager` — byte-budgeted device-resident sorted
    unions behind the O(N+Δ) delta merge (resident.py);
  * :class:`FleetSupervisor` / :func:`ring_points` / :func:`route_tenant`
    — N ``--serve -`` worker processes behind one consistent-hash router,
    exactly-once through the journal (fleet.py).
"""

from tpu_radix_join_torch.service.admission import (AdmissionQueue,
                                                    AdmissionRejected)
from tpu_radix_join_torch.service.breaker import (CLOSED, HALF_OPEN, OPEN,
                                                  CircuitBreaker)
from tpu_radix_join_torch.service.deadline import Deadline, DeadlineExceeded
from tpu_radix_join_torch.service.fleet import (FleetSupervisor, ring_points,
                                                route_tenant)
from tpu_radix_join_torch.service.journal import (JournalAudit, QueryJournal,
                                                  request_fingerprint)
from tpu_radix_join_torch.service.microbatch import (MicroBatcher,
                                                     batch_signature)
from tpu_radix_join_torch.service.resident import ResidentStateManager
from tpu_radix_join_torch.service.resultcache import (ResultCache,
                                                      content_fingerprint)
from tpu_radix_join_torch.service.session import (BackendUnavailable,
                                                  JoinSession, QueryOutcome,
                                                  QueryRequest, UNCLASSIFIED)
from tpu_radix_join_torch.service.slo import SLORecorder, nearest_rank

__all__ = [
    "AdmissionQueue", "AdmissionRejected",
    "CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN",
    "Deadline", "DeadlineExceeded",
    "FleetSupervisor", "ring_points", "route_tenant",
    "JournalAudit", "QueryJournal", "request_fingerprint",
    "JoinSession", "QueryRequest", "QueryOutcome", "BackendUnavailable",
    "UNCLASSIFIED",
    "MicroBatcher", "batch_signature",
    "ResidentStateManager",
    "ResultCache", "content_fingerprint",
    "SLORecorder", "nearest_rank",
]
