"""Always-on flight recorder: a bounded ring of recent telemetry.

The port's copy of ``tpu_radix_join/observability/flightrec.py``: a
fixed-capacity ``collections.deque`` of small dicts mirroring what the
Measurements registry does — phase begin/end pairs, counter deltas,
instant events, timeline spans — with no opt-in flag and no I/O on the
hot path.  When a query or a run dies (hang, deadline, breaker trip) the
ring is the last N things the process did, and ``postmortem.write_bundle``
freezes it into the forensics bundle; while a run is alive, ``idle_s()``
is the watchdog's progress signal (time since the registry last recorded
anything: a hung launch stops the clock, a busy phase keeps ticking).

A record holds host values only: the registry passes phase names, host
clock intervals and counter totals, never a tensor, so recording costs no
device readback inside a timed phase.  One deque append a record (the
deque evicts in C), no lock on the writer path (appends on a bounded deque
are atomic under the GIL; the watchdog and bundle readers tolerate a
snapshot torn by one record).

Context stamping (``set_context`` / ``clear_context``) attaches ambient
keys — the serve path's ``query_id`` and ``tenant``, a worker's
``worker_incarnation``, the ``trace_id`` — to every record made while set.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

DEFAULT_CAPACITY = 512


class FlightRecorder:
    """Bounded ring of recent telemetry records.

    Each record is ``{"t_s": <epoch seconds>, "kind": ..., "name": ...}``
    plus the active context keys and any per-record data.  Kinds in use:
    ``begin`` / ``end`` (phase timers), ``incr`` (counter deltas),
    ``gauge`` (counter assignments), ``event`` (instant events),
    ``span`` / ``span_end`` (timeline-only spans).
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 epoch_s: Optional[float] = None,
                 mono_s: Optional[float] = None):
        # paired clock anchors (the registry's and the tracer's): records
        # carry epoch seconds, so the ring aligns with heartbeat samples
        # and merged timelines
        self._mono0 = time.perf_counter() if mono_s is None else mono_s
        self._epoch0 = time.time() if epoch_s is None else epoch_s
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._n_recorded = 0
        self._context: Dict[str, object] = {}
        #: monotonic instant of the most recent record, the watchdog's
        #: progress signal; seeded at construction
        self.last_record_mono = self._mono0

    # ------------------------------------------------------------- context
    def set_context(self, **kv) -> None:
        """Stamp ambient keys (e.g. ``query_id``) onto every future record;
        other context keys are kept."""
        # a rebound dict is an atomic swap for the lock-free writers
        ctx = dict(self._context)
        ctx.update(kv)
        self._context = ctx

    def clear_context(self, *keys) -> None:
        """Drop the named context keys (all of them when called bare)."""
        if not keys:
            self._context = {}
            return
        self._context = {k: v for k, v in self._context.items()
                         if k not in keys}

    @property
    def context(self) -> Dict[str, object]:
        return dict(self._context)

    # -------------------------------------------------------------- writer
    def record(self, kind: str, name: str, **data) -> None:
        now = time.perf_counter()
        rec = {"t_s": round(self._epoch0 + (now - self._mono0), 6),
               "kind": kind, "name": name}
        if self._context:
            rec.update(self._context)
        if data:
            rec.update(data)
        self._ring.append(rec)
        self._n_recorded += 1
        self.last_record_mono = now

    # ------------------------------------------------------------- readers
    def idle_s(self) -> float:
        """Seconds since the last record: the watchdog's progress signal."""
        return time.perf_counter() - self.last_record_mono

    def __len__(self) -> int:
        return len(self._ring)

    def records(self) -> List[dict]:
        """Copy of the ring, oldest first."""
        return list(self._ring)

    def snapshot(self) -> dict:
        """Self-contained dump for bundles: capacity, records ever made
        (the evicted ones counted), the active context, and the surviving
        records oldest first."""
        return {"capacity": self.capacity,
                "recorded": self._n_recorded,
                "context": dict(self._context),
                "records": list(self._ring)}


def dump_all_stacks() -> Dict[str, List[str]]:
    """Formatted stacks of every live thread, keyed ``"name (tid)"``: where
    every thread was when the process stalled.  Uses
    ``sys._current_frames``; safe to call from any thread."""
    import sys
    import traceback
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for tid, frame in sys._current_frames().items():
        label = f"{names.get(tid, 'unknown')} ({tid})"
        out[label] = [ln.rstrip("\n")
                      for ln in traceback.format_stack(frame)]
    return out
