"""Hierarchical span tracer: per-rank Chrome-trace timelines.

The port's copy of ``tpu_radix_join/observability/spans.py``.  The
``.perf`` files record how long each phase took, not when; this tracer
records the registry's tag vocabulary as intervals on a wall-clock-anchored
timeline and exports them per rank as Chrome trace-event JSON (the format
Perfetto and ``chrome://tracing`` load), so host phases, robustness
instant events, planner decisions and the profiler's per-op device summary
land in one view.

Clock discipline: each tracer pins a wall-clock anchor (``epoch_s``) and a
monotonic anchor (``time.perf_counter()``) at the same instant.  Event
timestamps are monotonic microseconds since the anchor; the epoch anchor
rides the file's metadata so the merger (observability/timeline.py) shifts
every rank onto one shared clock.

Wiring: ``Measurements.attach_tracer()`` builds a tracer on the registry's
anchors; every ``start`` / ``stop`` pair then mirrors into a complete span
and every ``Measurements.event`` into an instant event.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

# Perfetto track layout: one process per rank, host phases on tid 0, the
# synthetic device-op summary track (timeline.py) on tid 1
HOST_TID = 0
DEVICE_TID = 1

SPAN_SUFFIX = ".spans.json"


def new_trace_id() -> str:
    return os.urandom(8).hex()


class SpanTracer:
    """Per-rank span recorder; export with :meth:`save`.

    ``tags`` (e.g. the planner's strategy and engine) are stamped into every
    later event's ``args`` and into the file metadata: set them before the
    spans they describe.
    """

    def __init__(self, rank: int = 0, trace_id: Optional[str] = None,
                 tags: Optional[dict] = None,
                 epoch_s: Optional[float] = None,
                 mono_s: Optional[float] = None):
        self.rank = int(rank)
        self.trace_id = trace_id or new_trace_id()
        self.tags: Dict[str, object] = dict(tags or {})
        self.epoch_s = time.time() if epoch_s is None else float(epoch_s)
        self._mono0 = (time.perf_counter() if mono_s is None
                       else float(mono_s))
        # per-name begin stacks: phases re-enter on retry and overlap
        # without strict nesting (JTOTAL ⊃ JMPI ⊃ SNETCOMPL)
        self._open: Dict[str, List[tuple]] = {}
        self.events: List[dict] = []

    # ------------------------------------------------------------------ clock
    def now_us(self) -> float:
        """Microseconds since this tracer's anchors (monotonic)."""
        return (time.perf_counter() - self._mono0) * 1e6

    # ------------------------------------------------------------------- tags
    def set_tags(self, **tags) -> None:
        """Stamp tags (strategy=..., engine=...) onto future events."""
        self.tags.update(tags)

    # ------------------------------------------------------------------ spans
    def begin(self, name: str, **args) -> None:
        self._open.setdefault(name, []).append((self.now_us(), args))

    def end(self, name: str, **args) -> None:
        """Complete the innermost open span of ``name``; an ``end`` with no
        matching ``begin`` is dropped."""
        stack = self._open.get(name)
        if not stack:
            return
        ts, begin_args = stack.pop()
        self.events.append({
            "name": name, "ph": "X", "ts": ts,
            "dur": max(0.0, self.now_us() - ts),
            "pid": self.rank, "tid": HOST_TID,
            "args": {**self.tags, **begin_args, **args},
        })

    @contextlib.contextmanager
    def span(self, name: str, **args):
        self.begin(name, **args)
        try:
            yield self
        finally:
            self.end(name)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker (robustness events, planner decisions)."""
        self.events.append({
            "name": name, "ph": "i", "s": "p",
            "ts": self.now_us(), "pid": self.rank, "tid": HOST_TID,
            "args": {**self.tags, **args},
        })

    # ----------------------------------------------------------------- export
    def _metadata_events(self) -> List[dict]:
        return [
            {"name": "process_name", "ph": "M", "pid": self.rank,
             "args": {"name": f"rank {self.rank}"}},
            {"name": "process_sort_index", "ph": "M", "pid": self.rank,
             "args": {"sort_index": self.rank}},
            {"name": "thread_name", "ph": "M", "pid": self.rank,
             "tid": HOST_TID, "args": {"name": "host phases"}},
        ]

    def to_chrome(self, shift_us: float = 0.0) -> dict:
        """Chrome trace-event JSON object; ``shift_us`` moves this rank's
        events onto a shared clock (the merger's anchor delta)."""
        events = self._metadata_events()
        for ev in self.events:
            ev = dict(ev)
            ev["ts"] = ev["ts"] + shift_us
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {
                "trace_id": self.trace_id,
                "rank": self.rank,
                "epoch_s": self.epoch_s,
                "tags": self.tags,
                "clock": "us since rank epoch anchor (monotonic)",
            },
        }

    def save(self, out_dir: str, device_summary: Optional[dict] = None,
             filename: Optional[str] = None) -> str:
        """Write ``<rank>.spans.json`` atomically; spans still open are
        closed at now and marked ``unclosed`` (a failed run's save keeps
        its outermost span).

        ``device_summary`` (the profiler's per-op breakdown from
        performance/trace.summarize_trace, i.e. ``meta["trace"]``) is
        embedded in the metadata, so the merger grafts a device track next
        to this rank's host phases without reading the trace again."""
        for name in [n for n, stack in self._open.items() if stack]:
            while self._open[name]:
                self.end(name, unclosed=True)
        doc = self.to_chrome()
        if device_summary is not None:
            doc["metadata"]["device_summary"] = device_summary
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            filename or f"{self.rank}{SPAN_SUFFIX}")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path
