"""Merge per-rank span files into one aligned Chrome-trace timeline.

The port's copy of ``tpu_radix_join/observability/timeline.py``.  Each
rank's ``<rank>.spans.json`` (observability/spans.py) carries timestamps
relative to that rank's own wall-clock anchor; the merge shifts every rank
onto the earliest anchor's clock, so host phase spans, instant events and
the grafted device track of every rank share one timeline.

Device track: when a rank's span file embeds the profiler's per-op summary
(``meta["trace"]`` of ``Measurements.trace``, performance/trace.py), its
ops are laid out as a synthetic sequential track (tid 1) under that rank:
the durations are the card's, the order and start offsets a layout, which
each event's ``args`` say.  Without an embedded summary the merger reads
the raw ``*.trace.json`` profiler files under the input directory.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional, Tuple

from tpu_radix_join_torch.observability.spans import DEVICE_TID, SPAN_SUFFIX

# a summary view, not a dump: the heaviest ops, the rest as one tail
DEVICE_TRACK_MAX_OPS = 64


def find_span_files(timeline_dir: str) -> List[str]:
    return sorted(
        glob.glob(os.path.join(timeline_dir, "**", f"*{SPAN_SUFFIX}"),
                  recursive=True))


def _load(path: str) -> Tuple[Optional[dict], Optional[str]]:
    """One span file: (doc, None), or (None, why it was skipped)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        return None, f"unreadable ({e.__class__.__name__}: {e})"
    except ValueError as e:
        return None, f"malformed JSON (torn write? {e})"
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return None, "not a span file (no traceEvents object)"
    return doc, None


def _device_track_events(rank: int, summary: dict, start_us: float,
                         source: str) -> List[dict]:
    """Synthetic sequential layout of a per-op device summary."""
    events = [{
        "name": "thread_name", "ph": "M", "pid": rank, "tid": DEVICE_TID,
        "args": {"name": f"device ops (summary: {summary.get('plane', '?')})"},
    }]
    t = start_us
    ops = sorted(summary.get("ops", {}).items(),
                 key=lambda kv: -kv[1]["us"])
    for name, v in ops[:DEVICE_TRACK_MAX_OPS]:
        events.append({
            "name": name, "ph": "X", "ts": t, "dur": max(0.0, v["us"]),
            "pid": rank, "tid": DEVICE_TID,
            "args": {"count": v.get("count", 1), "source": source,
                     "layout": "sequential summary (durations real, "
                               "offsets synthetic)"},
        })
        t += max(0.0, v["us"])
    if len(ops) > DEVICE_TRACK_MAX_OPS:
        rest = sum(v["us"] for _, v in ops[DEVICE_TRACK_MAX_OPS:])
        events.append({
            "name": f"... {len(ops) - DEVICE_TRACK_MAX_OPS} more ops",
            "ph": "X", "ts": t, "dur": max(0.0, rest),
            "pid": rank, "tid": DEVICE_TID,
            "args": {"source": source, "layout": "tail aggregate"},
        })
    return events


def merge_timeline(timeline_dir: str, out_path: Optional[str] = None,
                   trace_dir: Optional[str] = None) -> Optional[dict]:
    """Merge every ``*.spans.json`` under ``timeline_dir``.

    Returns the merged Chrome-trace object (also written to ``out_path``
    when given), or None when the directory holds no span file.
    ``trace_dir`` (default: ``timeline_dir``) is searched for profiler
    traces only when no span file embeds a device summary.

    A rank killed mid-run leaves a torn or absent span file: unreadable
    files are skipped and named (``metadata["corrupt_files"]``), and ranks
    missing from the world the tracers' ``nodes`` tag declares are listed
    in ``metadata["missing_ranks"]``, so a partial merge says so.
    """
    docs: List[Tuple[str, dict]] = []
    corrupt: List[str] = []
    corrupt_reasons: List[dict] = []
    for path in find_span_files(timeline_dir):
        doc, reason = _load(path)
        if doc is not None:
            docs.append((path, doc))
        else:
            corrupt.append(os.path.basename(path))
            corrupt_reasons.append({"file": os.path.basename(path),
                                    "reason": reason})
    if not docs:
        return None

    anchors = [float(doc.get("metadata", {}).get("epoch_s", 0.0))
               for _, doc in docs]
    t0 = min(anchors)

    merged: List[dict] = []
    ranks = {}
    any_device_summary = False
    min_host_ts = {}
    for (path, doc), epoch_s in zip(docs, anchors):
        md = doc.get("metadata", {})
        rank = int(md.get("rank", 0))
        shift_us = (epoch_s - t0) * 1e6
        ranks[rank] = {
            "file": os.path.basename(path),
            "trace_id": md.get("trace_id"),
            "epoch_s": epoch_s,
            "clock_shift_us": round(shift_us, 3),
            "tags": md.get("tags", {}),
        }
        for ev in doc["traceEvents"]:
            ev = dict(ev)
            if "ts" in ev:
                ev["ts"] = float(ev["ts"]) + shift_us
                key = ev.get("pid", rank)
                if ev.get("ph") == "X":
                    min_host_ts[key] = min(min_host_ts.get(key, ev["ts"]),
                                           ev["ts"])
            merged.append(ev)
        summary = md.get("device_summary")
        if summary:
            any_device_summary = True
            merged.extend(_device_track_events(
                rank, summary, min_host_ts.get(rank, shift_us),
                source=f"{os.path.basename(path)}:metadata.device_summary"))

    if not any_device_summary:
        # fallback: raw profiler traces beside the span files
        from tpu_radix_join_torch.performance.trace import summarize_trace
        scan = trace_dir or timeline_dir
        try:
            summary = summarize_trace(scan)
        except Exception:
            summary = None
        if summary:
            rank0 = min(ranks)
            merged.extend(_device_track_events(
                rank0, summary, min_host_ts.get(rank0, 0.0),
                source=f"profiler trace scan of {scan}"))

    # the expected world: the largest ``nodes`` tag any rank declared
    expected = 0
    for info in ranks.values():
        try:
            expected = max(expected, int(info["tags"].get("nodes", 0)))
        except (TypeError, ValueError):
            pass
    missing = sorted(set(range(expected)) - set(ranks))
    doc = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "metadata": {
            "t0_epoch_s": t0,
            "ranks": {str(r): info for r, info in sorted(ranks.items())},
            "clock": "us since earliest rank epoch anchor",
            "expected_ranks": expected or len(ranks),
            "missing_ranks": missing,
            "corrupt_files": corrupt,
            "corrupt_file_reasons": corrupt_reasons,
            "partial": bool(missing or corrupt),
        },
    }
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        tmp = f"{out_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, out_path)
    return doc
