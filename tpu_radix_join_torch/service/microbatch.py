"""Inter-query micro-batching: bounded-window coalescing of small joins.

The port's copy of ``tpu_radix_join/service/microbatch.py``.  Storms of
small joins each pay a launch and readback floor for microseconds of
work.  The coalescer holds arriving queries for at most
``batch_window_ms``, groups those whose key lanes can share one device
program, and the session fuses each group into one K2 sort and one probe
(:func:`~tpu_radix_join_torch.ops.merge_delta.batched_merge_count`).

Two queries share a batch only when they agree on :func:`batch_signature`
(tuples_per_node, outer_kind, modulo, zipf_theta, repeats); seeds and
query ids may differ, since the composite query tag keeps every query's
keys apart and the fused counts are exact.

Failure isolation (service/session.py ``_execute_batched``): a query
whose deadline would expire inside the window is served alone at once,
and a fused batch that fails is retried one query at a time.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

from tpu_radix_join_torch.ops.merge_delta import batch_feasible

#: request fields that must agree for two queries to share one fused
#: device program (they shape the generated lanes / key distribution)
SIGNATURE_FIELDS = ("tuples_per_node", "outer_kind", "modulo", "zipf_theta",
                    "repeats")


def batch_signature(request) -> Tuple:
    """The co-batchability class of one request: the tuple of fields two
    queries must share to fuse into one program."""
    return tuple(getattr(request, f) for f in SIGNATURE_FIELDS)


class MicroBatcher:
    """Bounded-window query coalescer.

    Owns NO threads: the serving loop calls :meth:`offer` as queries
    arrive and :meth:`due` before blocking, and flushes the returned
    groups itself — single-threaded like the session, deterministic
    under test (inject ``clock``).

    ``window_ms == 0`` disables coalescing: every offer is immediately
    due as a singleton group, so the caller needs no mode switch.
    """

    def __init__(self, window_ms: float, max_queries: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        if window_ms < 0:
            raise ValueError("window_ms must be >= 0")
        if max_queries < 2:
            raise ValueError("max_queries must be >= 2")
        self.window_ms = window_ms
        self.max_queries = max_queries
        self._clock = clock
        #: signature -> (window-open timestamp, pending requests)
        self._pending: Dict[Tuple, Tuple[float, List]] = {}
        self.offered = 0
        self.fused_batches = 0
        self.fused_queries = 0
        self.solo = 0

    # ------------------------------------------------------------- intake
    def offer(self, request, key_bound: int) -> Optional[List]:
        """Admit one request to its signature window.  Returns a ready
        group (list of requests) the caller must dispatch NOW, or None
        if the request is parked awaiting the window:

          * coalescing disabled, batch infeasible for the key bound, or
            a deadline too tight for the window -> ``[request]`` alone;
          * the window hit ``max_queries`` -> the full group, fused.
        """
        self.offered += 1
        if self.window_ms == 0 or not batch_feasible(self.max_queries,
                                                     key_bound):
            self.solo += 1
            return [request]
        deadline = getattr(request, "deadline_s", None)
        if deadline is not None and deadline * 1000.0 <= self.window_ms:
            # the window would eat the whole deadline: serve it alone now
            self.solo += 1
            return [request]
        sig = batch_signature(request)
        opened, group = self._pending.get(sig, (self._clock(), []))
        group.append(request)
        if len(group) >= self.max_queries:
            del self._pending[sig]
            self._note_flush(group)
            return group
        self._pending[sig] = (opened, group)
        return None

    # -------------------------------------------------------------- flush
    def due(self, now: Optional[float] = None) -> List[List]:
        """Groups whose window has expired (possibly singletons), in
        window-open order.  The serving loop calls this before blocking
        on input and after the wait hinted by :meth:`next_deadline_s`."""
        now = self._clock() if now is None else now
        ready: List[Tuple[float, List]] = []
        for sig in list(self._pending):
            opened, group = self._pending[sig]
            if (now - opened) * 1000.0 >= self.window_ms:
                del self._pending[sig]
                ready.append((opened, group))
        ready.sort(key=lambda t: t[0])
        for _, group in ready:
            self._note_flush(group)
        return [group for _, group in ready]

    def flush(self) -> List[List]:
        """Every pending group regardless of window age — drain/shutdown
        path, so no parked query is ever lost to a closing session."""
        groups = [group for _, group in sorted(self._pending.values(),
                                               key=lambda t: t[0])]
        self._pending.clear()
        for group in groups:
            self._note_flush(group)
        return groups

    def next_deadline_s(self) -> Optional[float]:
        """Seconds until the oldest open window expires (<= 0 = overdue),
        or None when nothing is parked — the serving loop's poll timeout."""
        if not self._pending:
            return None
        oldest = min(opened for opened, _ in self._pending.values())
        return (self.window_ms / 1000.0) - (self._clock() - oldest)

    def _note_flush(self, group: List) -> None:
        if len(group) >= 2:
            self.fused_batches += 1
            self.fused_queries += len(group)
        else:
            self.solo += 1

    # ---------------------------------------------------------- reporting
    def pending(self) -> int:
        return sum(len(g) for _, g in self._pending.values())

    def stats(self) -> dict:
        """The coalescer's counts and window."""
        fused = self.fused_queries
        total = fused + self.solo
        return {"window_ms": self.window_ms,
                "max_queries": self.max_queries,
                "pending": self.pending(),
                "offered": self.offered,
                "fused_batches": self.fused_batches,
                "fused_queries": fused,
                "solo": self.solo,
                "fuse_ratio": round(fused / total, 4) if total else 0.0}
