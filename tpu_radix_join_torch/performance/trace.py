"""Profiler traces: per-op device time from ``torch.profiler``.

Counterpart of ``tpu_radix_join/performance/trace.py``, which decodes the
xplane files ``jax.profiler.trace`` writes.  Here :func:`profile` brackets
a block with ``torch.profiler`` (CPU and, with a card, CUDA activities) and
exports its Chrome trace as ``<rank>.trace.json`` into the trace
directory; :func:`summarize_trace` reads it back into the JAX function's
shape:

  * the device plane (``/device:GPU:<i>``): the card's kernel, memset and
    memcpy intervals; ``busy_us`` is their union over every stream (the
    cycles analog the registry records as CTOTAL) and ``ops`` their time
    and count by name;
  * without a CUDA timeline, the busiest host thread's CPU ops
    (``/host:CPU``), whose nested frames overlap: no CTOTAL is taken from
    it, as the JAX package takes none from a host plane.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import torch

#: Chrome-trace categories of work on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profile(trace_dir: str, rank: int = 0):
    """``torch.profiler.profile`` around the block (CUDA activity when a
    card is visible); on exit the Chrome trace lands in
    ``trace_dir/<rank>.trace.json``."""
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, f"{rank}.trace.json"))


def find_trace_files(trace_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(trace_dir, "**", "*.trace.json"),
                            recursive=True))


def is_device_plane(name: str) -> bool:
    """Whether a plane name denotes an accelerator (vs host) timeline."""
    n = name.lower()
    return n.startswith("/device:") or "tpu" in n or "gpu" in n


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """Microseconds covered by the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _ops_table(events) -> Dict[str, dict]:
    ops: Dict[str, List[float]] = {}
    for e in events:
        acc = ops.setdefault(e["name"], [0.0, 0])
        acc[0] += float(e["dur"])
        acc[1] += 1
    return {name: {"us": us, "count": n}
            for name, (us, n) in sorted(ops.items(), key=lambda kv: -kv[1][0])}


def summarize_events(events) -> Optional[dict]:
    """The plane summary of one Chrome trace's events: the busiest card
    (by busy time) if any event ran on one, else the busiest host thread
    (by summed CPU-op time); None when the trace holds neither."""
    device: Dict[int, list] = {}
    host: Dict[Tuple[int, int], list] = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat") in DEVICE_CATEGORIES:
            idx = e.get("args", {}).get("device", e.get("pid"))
            device.setdefault(idx if isinstance(idx, int) else 0,
                              []).append(e)
        elif e.get("cat") == "cpu_op":
            host.setdefault((e["pid"], e["tid"]), []).append(e)
    best = None
    for idx, evs in device.items():
        busy = union_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                         for e in evs])
        if best is None or busy > best["busy_us"]:
            best = {"plane": f"/device:GPU:{idx}", "busy_us": busy,
                    "ops": _ops_table(evs)}
    if best is not None:
        return best
    for evs in host.values():
        busy = sum(float(e["dur"]) for e in evs)
        if best is None or busy > best["busy_us"]:
            best = {"plane": "/host:CPU", "busy_us": busy,
                    "ops": _ops_table(evs)}
    return best


def summarize_trace(trace_dir: str) -> Optional[dict]:
    """``{"plane", "busy_us", "ops": {op: {"us", "count"}}}`` (heaviest op
    first) for the busiest plane of the traces under ``trace_dir``, a
    device plane before any host plane; None without a readable trace."""
    best = None
    for path in find_trace_files(trace_dir):
        with open(path) as f:
            summary = summarize_events(json.load(f).get("traceEvents", []))
        if summary is None:
            continue
        rank = (is_device_plane(summary["plane"]), summary["busy_us"])
        if best is None or rank > best[0]:
            best = (rank, summary)
    return best[1] if best else None


def top_ops(summary: dict, k: int = 12) -> List[Tuple[str, float, int]]:
    """[(op, total_us, count)] for the k heaviest ops of a summary."""
    items = [(name, v["us"], v["count"]) for name, v in summary["ops"].items()]
    items.sort(key=lambda t: -t[1])
    return items[:k]
