"""Counter names and a small recorder for the out-of-core grid.

The counter names of ``tpu_radix_join/performance/measurements.py`` that the
grid, the retry loop, the fault injector and the checkpoints increment, as
the port's own constants.  Every consumer takes its ``measurements``
duck-typed (``incr``, ``span``, ``event``), so the JAX package's
``Measurements`` drives the port's grid as well (the tests compare the two
runs' counters that way).  :class:`Measurements` here keeps only what the
port's command line and ``chip_smoke.py`` read: counters, the host seconds
spent in each named span, and the events.  The full module (timers, the
``.perf`` layout, traces) is ROADMAP A8.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

FINJECT = "FINJECT"        # injected faults fired (robustness/faults.py)
RETRYN = "RETRYN"          # retry attempts (robustness/retry.py)
BACKOFFMS = "BACKOFFMS"    # total retry backoff slept, milliseconds
CKPTSAVE = "CKPTSAVE"      # checkpoints written (robustness/checkpoint.py)
CKPTLOAD = "CKPTLOAD"      # checkpoints resumed from
GRIDPAIRS = "GRIDPAIRS"    # chunk pairs probed by chunked_join_grid (a
                           # resumed run skips completed pairs)
PREFETCH = "PREFETCH"      # chunks staged by the grid's prefetch thread
SORTREUSE = "SORTREUSE"    # grid pair probes that reused the row's presorted
                           # inner chunk: rows x (cols - 1) on a full grid


class Measurements:
    """Counters, per-span host seconds and events of one run.  Spans and
    counters may be recorded from several threads (the grid's prefetch
    thread and its consumer)."""

    def __init__(self):
        self.counters: Dict[str, int] = defaultdict(int)
        self.span_s: Dict[str, float] = defaultdict(float)
        self.span_n: Dict[str, int] = defaultdict(int)
        self.events: List[Tuple[str, dict]] = []
        self._lock = threading.Lock()

    def incr(self, key: str, by: int = 1) -> None:
        with self._lock:
            self.counters[key] += by

    @contextlib.contextmanager
    def span(self, name: str, **args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.span_s[name] += dt
                self.span_n[name] += 1

    def event(self, name: str, **data) -> None:
        with self._lock:
            self.events.append((name, data))
