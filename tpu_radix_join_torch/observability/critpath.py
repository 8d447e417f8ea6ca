"""Cross-rank critical-path attribution over exported span timelines.

The port's copy of ``tpu_radix_join/observability/critpath.py``, over the
port's span streams (observability/spans.py, timeline.py): the same
functions give the same dicts for the same span documents, whichever
package wrote them.  The span tracer records *what* each rank did and
*when*, the timeline merge aligns the clocks; this module reconstructs
the causal DAG of one join from the per-rank streams and walks its
critical path:

  * **nodes** — phase spans per rank;
  * **cross-rank edges** — sync points every rank must rendezvous at:
    the histogram ``all_reduce`` (JHIST), the exchange (JMPI,
    SNETCOMPL, and the JAX package's ``exchange_pack`` /
    ``exchange_stage`` markers), lease-epoch bumps (``rank_lost`` /
    ``rank_join`` instants) and manifest first-writer-wins claims
    (``hedge_claim`` instants).  The k-th occurrence of a sync span across
    ranks forms one barrier, complete when the slowest rank arrives, so
    the path between consecutive barriers runs through the *bounding*
    rank of the later one.

Each segment of the bounding rank's time splits into ``compute`` (ordinary
phase spans), ``collective_wait`` (exchange spans and any gap no span
covers) and ``straggle`` (hedge, recovery and regrow spans, plus the
barrier skew: how far the bounding rank's arrival trailed the median
peer).

**The span vocabulary.**  The port's registry timers mirror into spans
under the JAX package's tags (JTOTAL, JHIST, SWINALLOC, JMPI, SNETCOMPL,
SLOCPREP, JPROC, BPBUILD, BPPROBE, JCOMPILE), and its grid, checkpoint
and service spans carry JAX's names (``grid_pair``, ``prefetch``,
``presort``, ``readback_flush``, ``ckpt_load``, ``query``), so the
classes below are JAX's without a map.  Two differ: the port resolves
the wire plan inside the sizing pass and runs the staged exchange inside
JMPI, so it emits no ``exchange_pack`` / ``exchange_stage`` marker and
its exchange barrier is JMPI's.  The elastic spans (``recovery``,
``regrow``, ``hedge``, ``recover_partition``) and the ``hedge_claim``
instants are JAX's, so a stream of either package classes the same.

Partial-tolerant: a torn or missing rank degrades the result to a partial
path with a warning, never a crash.  Every entry point returns a plain
dict (ms) that serializes into ``meta["critical_path"]``, ledger rows,
``/statusz`` and post-mortem bundles.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from tpu_radix_join_torch.observability.spans import HOST_TID, SPAN_SUFFIX

# --------------------------------------------------------------------------
# phase vocabulary → path classes
# --------------------------------------------------------------------------

# umbrella spans cover the whole run / query; they are the envelope, not
# path segments, and are excluded from coverage
UMBRELLA_PHASES = frozenset({"JTOTAL", "CTOTAL", "query"})

# spans that imply a cross-rank rendezvous: histogram all_reduce, the
# all_to_all exchange and its staged variants, window-completion fences
BARRIER_PHASES = ("JHIST", "exchange_pack", "JMPI", "exchange_stage",
                  "SNETCOMPL")

# time inside these spans is collective/wait, not local compute
COLLECTIVE_PHASES = frozenset({"JMPI", "SNETCOMPL", "MWINWAIT",
                               "exchange_pack", "exchange_stage"})

# robustness detours: time here exists only because a peer straggled,
# died, or joined — straggle class, attributed to the causing rank
STRAGGLE_PHASES = frozenset({"hedge", "recovery", "regrow"})

# classification priority when spans nest (exchange inside JPROC → that
# window is collective); higher wins
_PRIO_WAIT, _PRIO_COMPUTE, _PRIO_COLLECTIVE, _PRIO_STRAGGLE = 0, 1, 2, 3
_CLASS_NAMES = {_PRIO_WAIT: "collective_wait", _PRIO_COMPUTE: "compute",
                _PRIO_COLLECTIVE: "collective_wait",
                _PRIO_STRAGGLE: "straggle"}


def _phase_prio(name: str) -> Optional[int]:
    if name in UMBRELLA_PHASES:
        return None
    if name in STRAGGLE_PHASES:
        return _PRIO_STRAGGLE
    if name in COLLECTIVE_PHASES:
        return _PRIO_COLLECTIVE
    return _PRIO_COMPUTE


# --------------------------------------------------------------------------
# stream ingestion
# --------------------------------------------------------------------------

def stream_from_tracer(tracer) -> dict:
    """In-memory stream from a live SpanTracer (the local rank's view —
    lets the command line print a [CRITPATH] line without a file round-trip)."""
    return {
        "rank": int(tracer.rank),
        "trace_id": tracer.trace_id,
        "epoch_s": float(tracer.epoch_s),
        "tags": dict(tracer.tags),
        "events": list(tracer.events),
        "file": None,
    }


def _stream_from_doc(path: str, doc: dict) -> Optional[dict]:
    md = doc.get("metadata", {})
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return None
    return {
        "rank": int(md.get("rank", 0)),
        "trace_id": md.get("trace_id"),
        "epoch_s": float(md.get("epoch_s", 0.0)),
        "tags": md.get("tags", {}) or {},
        "events": events,
        "file": os.path.basename(path),
    }


def load_streams(timeline_dir: str, trace_id: Optional[str] = None,
                 ) -> Tuple[List[dict], List[str]]:
    """Load per-rank span streams from ``timeline_dir``.

    Files are correlated by **trace identity**, not directory mtime: with
    ``trace_id`` given only matching files join the group; otherwise the
    largest trace-id cohort wins (latest epoch anchor breaks ties), so a
    directory holding several runs' exports still yields one coherent
    join.  Unreadable files degrade to warnings, never exceptions.
    """
    # local import: timeline depends on spans only, no cycle back here
    from tpu_radix_join_torch.observability.timeline import (
        _load, find_span_files)
    warnings: List[str] = []
    streams: List[dict] = []
    for path in find_span_files(timeline_dir):
        doc, reason = _load(path)
        if doc is None:
            warnings.append(f"skipped {os.path.basename(path)}: {reason}")
            continue
        st = _stream_from_doc(path, doc)
        if st is None:
            warnings.append(f"skipped {os.path.basename(path)}: "
                            "no traceEvents list")
            continue
        streams.append(st)
    if not streams:
        return [], warnings

    if trace_id:
        chosen = trace_id
    else:
        cohorts: Dict[str, List[dict]] = {}
        for st in streams:
            cohorts.setdefault(st["trace_id"] or "", []).append(st)
        chosen = max(cohorts,
                     key=lambda t: (len(cohorts[t]),
                                    max(s["epoch_s"] for s in cohorts[t])))
    kept = [s for s in streams if (s["trace_id"] or "") == (chosen or "")]
    dropped = len(streams) - len(kept)
    if dropped:
        warnings.append(f"{dropped} span file(s) from other trace_ids "
                        f"ignored (selected trace {chosen or '<none>'})")
    if not kept:       # requested trace_id matched nothing: say so
        warnings.append(f"no span files match trace_id {chosen}")
    # one stream per rank: newest anchor wins on duplicates
    by_rank: Dict[int, dict] = {}
    for st in kept:
        prev = by_rank.get(st["rank"])
        if prev is None or st["epoch_s"] >= prev["epoch_s"]:
            by_rank[st["rank"]] = st
    if len(by_rank) < len(kept):
        warnings.append(f"{len(kept) - len(by_rank)} duplicate rank "
                        "file(s) superseded by newer anchors")
    return [by_rank[r] for r in sorted(by_rank)], warnings


def _aligned_spans(streams: Sequence[dict]) -> Tuple[dict, dict, List[str]]:
    """Shift every rank onto the earliest epoch anchor (the timeline
    merge discipline) and index complete host spans / instants per rank.
    Returns (spans_by_rank, instants_by_rank, warnings); timestamps µs on
    the shared clock."""
    warnings: List[str] = []
    t0 = min(st["epoch_s"] for st in streams)
    spans: Dict[int, List[dict]] = {}
    instants: Dict[int, List[dict]] = {}
    for st in streams:
        shift = (st["epoch_s"] - t0) * 1e6
        rank = st["rank"]
        torn = 0
        for ev in st["events"]:
            ph = ev.get("ph")
            if ev.get("tid", HOST_TID) != HOST_TID:
                continue
            if ph == "X":
                args = ev.get("args") or {}
                if args.get("unclosed"):
                    torn += 1
                spans.setdefault(rank, []).append({
                    "name": ev.get("name", "?"),
                    "ts": float(ev.get("ts", 0.0)) + shift,
                    "dur": max(0.0, float(ev.get("dur", 0.0))),
                    "args": args,
                })
            elif ph == "i":
                instants.setdefault(rank, []).append({
                    "name": ev.get("name", "?"),
                    "ts": float(ev.get("ts", 0.0)) + shift,
                    "args": ev.get("args") or {},
                })
        if torn:
            warnings.append(f"rank {rank}: {torn} span(s) torn open at "
                            "save (crash/cancel path) — durations "
                            "truncated at export time")
    for lst in spans.values():
        lst.sort(key=lambda s: s["ts"])
    for lst in instants.values():
        lst.sort(key=lambda s: s["ts"])
    return spans, instants, warnings


# --------------------------------------------------------------------------
# DAG: barriers (cross-rank edges) + classified coverage (node weights)
# --------------------------------------------------------------------------

def _median(vals: Sequence[float]) -> float:
    vs = sorted(vals)
    n = len(vs)
    return vs[n // 2] if n % 2 else 0.5 * (vs[n // 2 - 1] + vs[n // 2])


def _build_barriers(spans_by_rank: Dict[int, List[dict]]) -> List[dict]:
    """k-th occurrence of each sync-phase span across ranks = one
    barrier; completion = slowest arrival."""
    if len(spans_by_rank) < 2:
        return []
    occ: Dict[Tuple[str, int], Dict[int, float]] = {}
    for rank, spans in spans_by_rank.items():
        counts: Dict[str, int] = {}
        for sp in spans:
            name = sp["name"]
            if name not in BARRIER_PHASES:
                continue
            k = counts.get(name, 0)
            counts[name] = k + 1
            occ.setdefault((name, k), {})[rank] = sp["ts"] + sp["dur"]
    barriers = []
    for (name, k), arrivals in occ.items():
        if len(arrivals) < 2:
            continue        # a lone rank's span is a node, not an edge
        t = max(arrivals.values())
        bounding = max(arrivals, key=lambda r: arrivals[r])
        skew = max(0.0, t - _median(list(arrivals.values())))
        barriers.append({
            "name": name, "occurrence": k, "t_us": t,
            "bounding_rank": bounding, "skew_us": skew,
            "arrivals_us": dict(arrivals),
        })
    barriers.sort(key=lambda b: b["t_us"])
    return barriers


def _classified_window(spans: Sequence[dict], a: float, b: float,
                       ) -> Tuple[Dict[int, float], Dict[str, float]]:
    """Sweep the owner rank's spans over window [a, b]: at every instant
    the highest-priority covering span class wins (nesting-safe); gaps
    class as wait.  Returns (class_prio→µs, phase name→µs on path)."""
    bounds: List[Tuple[float, int, int, str]] = []
    for sp in spans:
        prio = _phase_prio(sp["name"])
        if prio is None:
            continue
        s, e = max(a, sp["ts"]), min(b, sp["ts"] + sp["dur"])
        if e > s:
            bounds.append((s, 1, prio, sp["name"]))
            bounds.append((e, -1, prio, sp["name"]))
    acc = {_PRIO_WAIT: 0.0, _PRIO_COMPUTE: 0.0,
           _PRIO_COLLECTIVE: 0.0, _PRIO_STRAGGLE: 0.0}
    phase_us: Dict[str, float] = {}
    if not bounds:
        acc[_PRIO_WAIT] = max(0.0, b - a)
        return acc, phase_us
    bounds.sort(key=lambda x: (x[0], -x[1]))
    # active[prio] -> {name: depth}
    active: Dict[int, Dict[str, int]] = {p: {} for p in acc}
    prev = a
    i = 0
    while i <= len(bounds):
        t = bounds[i][0] if i < len(bounds) else b
        t = min(max(t, a), b)
        if t > prev:
            top = max((p for p in active if active[p]),
                      default=_PRIO_WAIT)
            acc[top] += t - prev
            if active.get(top):
                name = next(iter(active[top]))
                phase_us[name] = phase_us.get(name, 0.0) + (t - prev)
            prev = t
        if i == len(bounds):
            break
        _, delta, prio, name = bounds[i]
        d = active[prio]
        d[name] = d.get(name, 0) + delta
        if d[name] <= 0:
            d.pop(name, None)
        i += 1
    if b > prev:
        acc[_PRIO_WAIT] += b - prev
    return acc, phase_us


# --------------------------------------------------------------------------
# hedge / recovery claims
# --------------------------------------------------------------------------

def _hedge_summary(spans_by_rank: Dict[int, List[dict]],
                   instants_by_rank: Dict[int, List[dict]],
                   t_start: float, t_end: float) -> Optional[dict]:
    """Condense manifest first-writer-wins claims + hedge events into a
    shortening estimate.  Measured basis when the straggler's own stream
    is visible (its late arrival vs the claim that released the
    barrier); projected basis otherwise (rate-extrapolated from the
    hedge event's progress counters)."""
    claims: List[dict] = []
    hedge_events: List[dict] = []
    for rank, insts in instants_by_rank.items():
        for ev in insts:
            if ev["name"] == "hedge_claim":
                claims.append({"rank": rank, "t_ms": ev["ts"] / 1e3,
                               **{k: ev["args"].get(k)
                                  for k in ("partition", "owner", "epoch")
                                  if k in ev["args"]}})
            elif ev["name"] in ("hedge", "straggle"):
                hedge_events.append({"rank": rank, "t_us": ev["ts"],
                                     "args": ev["args"]})
    if not claims and not hedge_events:
        return None
    straggler = None
    for ev in hedge_events:
        if ev["args"].get("straggler") is not None:
            straggler = int(ev["args"]["straggler"])
            break

    saved_ms = None
    basis = None
    claim_t = max((c["t_ms"] * 1e3 for c in claims), default=None)
    if claim_t is not None and straggler is not None:
        strag_spans = spans_by_rank.get(straggler)
        if strag_spans:
            # measured: the claim released the barrier at claim_t; the
            # straggler itself only arrived at its last span end
            arrival = max(sp["ts"] + sp["dur"] for sp in strag_spans)
            saved_ms = max(0.0, (arrival - claim_t) / 1e3)
            basis = "measured"
        else:
            for ev in hedge_events:
                args = ev["args"]
                try:
                    progress = float(args.get("progress", 0.0))
                    outstanding = float(args.get("outstanding", 0.0))
                except (TypeError, ValueError):
                    continue
                elapsed = max(0.0, ev["t_us"] - t_start)
                if progress > 0 and outstanding > 0 and elapsed > 0:
                    # rate-extrapolate the straggler's finish had nobody
                    # reclaimed its partitions
                    projected = t_start + elapsed * (
                        (progress + outstanding) / progress)
                    saved_ms = max(0.0, (projected - t_end) / 1e3)
                    basis = "projected"
                    break
                if progress == 0 and outstanding > 0 and elapsed > 0:
                    # stalled straggler: it finished nothing in `elapsed`,
                    # so each outstanding partition costs > elapsed — a
                    # conservative floor on the finish nobody waited for
                    projected = ev["t_us"] + outstanding * elapsed
                    saved_ms = max(0.0, (projected - t_end) / 1e3)
                    basis = "projected"
                    break
    return {
        "claims": claims,
        "n_claims": len(claims),
        "straggler": straggler,
        "saved_ms_estimate": (round(saved_ms, 3)
                              if saved_ms is not None else None),
        "basis": basis,
    }


# --------------------------------------------------------------------------
# the path itself
# --------------------------------------------------------------------------

def compute_critical_path(streams: Sequence[dict],
                          warnings: Optional[List[str]] = None,
                          window_us: Optional[Tuple[float, float]] = None,
                          ) -> dict:
    """Reconstruct the critical path over aligned per-rank streams.

    Returns a plain-dict report (ms units) with the path length, the
    bounding rank, compute / collective-wait / straggle fractions,
    per-rank attribution, the barrier list, and any hedge shortening —
    or a degraded ``{"error": ...}`` dict when no usable spans exist
    (degrade, never raise: this runs on crash-path artifacts).
    """
    warnings = list(warnings or [])
    streams = [s for s in streams if s and s.get("events")]
    if not streams:
        return {"error": "no span streams", "warnings": warnings,
                "partial": True}
    spans_by_rank, instants_by_rank, torn_warn = _aligned_spans(streams)
    warnings.extend(torn_warn)
    spans_by_rank = {r: s for r, s in spans_by_rank.items() if s}
    if not spans_by_rank:
        return {"error": "no complete spans in any stream",
                "warnings": warnings, "partial": True}

    if window_us is not None:
        lo, hi = window_us
        spans_by_rank = {
            r: [s for s in sp if s["ts"] < hi and s["ts"] + s["dur"] > lo]
            for r, sp in spans_by_rank.items()}
        spans_by_rank = {r: s for r, s in spans_by_rank.items() if s}
        instants_by_rank = {
            r: [e for e in iv if lo <= e["ts"] <= hi]
            for r, iv in instants_by_rank.items()}
        if not spans_by_rank:
            return {"error": "no spans in window", "warnings": warnings,
                    "partial": True}

    # envelope: prefer the JTOTAL umbrella (single-rank path length ==
    # measured JTOTAL by construction); fall back to the event hull
    jt_starts, jt_ends, jt_durs = [], [], {}
    for rank, spans in spans_by_rank.items():
        for sp in spans:
            if sp["name"] in UMBRELLA_PHASES:
                jt_starts.append(sp["ts"])
                jt_ends.append(sp["ts"] + sp["dur"])
                jt_durs[rank] = max(jt_durs.get(rank, 0.0), sp["dur"])
    if jt_starts:
        t_start, t_end = min(jt_starts), max(jt_ends)
        # a hedge/recovery detour is causally part of the join even when
        # the umbrella aborted before it (the straggle abort ends JTOTAL,
        # then the reclaimed partitions re-execute under a straggle-phase
        # span): extend the envelope so the detour lands on the path
        for spans in spans_by_rank.values():
            for sp in spans:
                if (sp["name"] in STRAGGLE_PHASES
                        and sp["ts"] >= t_start):
                    t_end = max(t_end, sp["ts"] + sp["dur"])
    else:
        t_start = min(sp["ts"] for s in spans_by_rank.values() for sp in s)
        t_end = max(sp["ts"] + sp["dur"]
                    for s in spans_by_rank.values() for sp in s)
        warnings.append("no JTOTAL umbrella span found; envelope taken "
                        "from the event hull")
    if window_us is not None:
        t_start = max(t_start, window_us[0])
        t_end = min(t_end, window_us[1])
    path_us = max(0.0, t_end - t_start)
    if path_us <= 0.0:
        return {"error": "empty envelope", "warnings": warnings,
                "partial": True}

    # missing ranks: the contiguous-rank convention (0..max) — a hole
    # means a peer died before saving; path degrades to partial
    present = sorted(spans_by_rank)
    missing = sorted(set(range(max(present) + 1)) - set(present))
    if missing:
        warnings.append(f"rank(s) {missing} missing from the trace "
                        "cohort; path is partial")

    barriers = _build_barriers(spans_by_rank)
    barriers = [b for b in barriers if t_start < b["t_us"] <= t_end]

    # rank bounding the finish line owns the tail segment
    last_end = {r: max(sp["ts"] + sp["dur"] for sp in s)
                for r, s in spans_by_rank.items()}
    tail_owner = max(last_end, key=lambda r: last_end[r])

    segments: List[dict] = []
    totals = {"compute": 0.0, "collective_wait": 0.0, "straggle": 0.0}
    attribution: Dict[int, float] = {}
    phase_on_path: Dict[str, float] = {}
    peer_wait_us = 0.0
    prev = t_start
    cut_points = [(b["t_us"], b) for b in barriers] + [(t_end, None)]
    for t_cut, barrier in cut_points:
        if t_cut <= prev:
            continue
        owner = barrier["bounding_rank"] if barrier else tail_owner
        acc, phase_us = _classified_window(
            spans_by_rank.get(owner, []), prev, t_cut)
        seg_len = t_cut - prev
        compute = acc[_PRIO_COMPUTE]
        collective = acc[_PRIO_COLLECTIVE] + acc[_PRIO_WAIT]
        straggle = acc[_PRIO_STRAGGLE]
        if barrier:
            # barrier skew = the bounding rank's excess over the median
            # peer: reclassify that much of its compute as straggle (the
            # amount one slow rank cost everyone waiting at the fence)
            carve = min(barrier["skew_us"], compute)
            compute -= carve
            straggle += carve
            peer_wait_us += sum(
                max(0.0, barrier["t_us"] - arr)
                for r, arr in barrier["arrivals_us"].items() if r != owner)
        totals["compute"] += compute
        totals["collective_wait"] += collective
        totals["straggle"] += straggle
        for name, us in phase_us.items():
            phase_on_path[name] = phase_on_path.get(name, 0.0) + us
        attribution[owner] = attribution.get(owner, 0.0) + seg_len
        segments.append({
            "rank": owner,
            "start_ms": round((prev - t_start) / 1e3, 3),
            "dur_ms": round(seg_len / 1e3, 3),
            "via": (f"{barrier['name']}#{barrier['occurrence']}"
                    if barrier else "finish"),
            "compute_ms": round(compute / 1e3, 3),
            "collective_wait_ms": round(collective / 1e3, 3),
            "straggle_ms": round(straggle / 1e3, 3),
            "skew_ms": round((barrier["skew_us"] if barrier else 0.0)
                             / 1e3, 3),
        })
        prev = t_cut

    bounding_rank = max(attribution, key=lambda r: attribution[r])
    denom = max(path_us, 1e-9)
    fractions = {k: round(v / denom, 4) for k, v in totals.items()}
    wait_fraction = round(
        (totals["collective_wait"] + totals["straggle"]) / denom, 4)
    jtotal_ms = (max(jt_durs.values()) / 1e3) if jt_durs else None
    top_phase = (max(phase_on_path, key=lambda n: phase_on_path[n])
                 if phase_on_path else None)

    # lease-epoch bumps ride the path as annotations (cross-rank edges
    # from the membership layer)
    epoch_bumps = []
    for rank, insts in instants_by_rank.items():
        for ev in insts:
            if ev["name"] in ("rank_lost", "rank_join"):
                epoch_bumps.append({
                    "rank": rank, "event": ev["name"],
                    "t_ms": round((ev["ts"] - t_start) / 1e3, 3),
                    "epoch": ev["args"].get("epoch")})
    epoch_bumps.sort(key=lambda e: e["t_ms"])

    return {
        "trace_id": streams[0].get("trace_id"),
        "ranks": present,
        "missing_ranks": missing,
        "partial": bool(missing
                        or any("torn" in w for w in warnings)),
        "warnings": warnings,
        "path_ms": round(path_us / 1e3, 3),
        "jtotal_ms": (round(jtotal_ms, 3)
                      if jtotal_ms is not None else None),
        "bounding_rank": bounding_rank,
        "fractions": fractions,
        "wait_fraction": wait_fraction,
        "attribution_ms": {str(r): round(us / 1e3, 3)
                           for r, us in sorted(attribution.items())},
        "top_phase": ({"name": top_phase, "rank": bounding_rank,
                       "ms": round(phase_on_path[top_phase] / 1e3, 3)}
                      if top_phase else None),
        "phase_ms": {n: round(us / 1e3, 3)
                     for n, us in sorted(phase_on_path.items(),
                                         key=lambda kv: -kv[1])},
        "barriers": [{
            "name": b["name"], "occurrence": b["occurrence"],
            "t_ms": round((b["t_us"] - t_start) / 1e3, 3),
            "bounding_rank": b["bounding_rank"],
            "skew_ms": round(b["skew_us"] / 1e3, 3),
            "arrivals_ms": {str(r): round((a - t_start) / 1e3, 3)
                            for r, a in sorted(b["arrivals_us"].items())},
        } for b in barriers],
        "peer_wait_ms": round(peer_wait_us / 1e3, 3),
        "segments": segments,
        "epoch_bumps": epoch_bumps,
        "hedge": _hedge_summary(spans_by_rank, instants_by_rank,
                                t_start, t_end),
    }


def critical_path_for_dir(timeline_dir: str,
                          trace_id: Optional[str] = None) -> dict:
    """Load span files under ``timeline_dir`` (trace-id correlated) and
    compute the critical path; degraded dict on empty/unreadable dirs."""
    streams, warnings = load_streams(timeline_dir, trace_id=trace_id)
    if not streams:
        return {"error": f"no span files ({SPAN_SUFFIX}) usable under "
                         f"{timeline_dir}",
                "warnings": warnings, "partial": True}
    return compute_critical_path(streams, warnings=warnings)


def critical_path_from_tracer(tracer, window_us=None) -> dict:
    """Path over the local rank's in-memory spans (no file round-trip)."""
    return compute_critical_path([stream_from_tracer(tracer)],
                                 window_us=window_us)


# --------------------------------------------------------------------------
# rendering
# --------------------------------------------------------------------------

def format_summary(res: dict) -> str:
    """One-line body for the ``[CRITPATH]`` log line."""
    if "error" in res:
        return f"unavailable ({res['error']})"
    f = res["fractions"]
    parts = [f"path_ms={res['path_ms']:.1f}"]
    if res.get("jtotal_ms") is not None:
        parts.append(f"jtotal_ms={res['jtotal_ms']:.1f}")
    parts.append(f"bound=rank{res['bounding_rank']}")
    parts.append(f"compute={f['compute'] * 100:.1f}%")
    parts.append(f"wait={f['collective_wait'] * 100:.1f}%")
    parts.append(f"straggle={f['straggle'] * 100:.1f}%")
    top = res.get("top_phase")
    if top:
        parts.append(f"top={top['name']}@r{top['rank']}:{top['ms']:.1f}ms")
    parts.append(f"barriers={len(res.get('barriers', []))}")
    hedge = res.get("hedge")
    if hedge and hedge.get("n_claims"):
        saved = hedge.get("saved_ms_estimate")
        parts.append(
            f"hedge_claims={hedge['n_claims']}"
            + (f" saved_ms~{saved:.1f}" if saved is not None else ""))
    if res.get("trace_id"):
        parts.append(f"trace={res['trace_id']}")
    if res.get("partial"):
        parts.append("PARTIAL")
    return " ".join(parts)


def render_report(res: dict) -> str:
    """Multi-line human report (post-mortem bundles, ``render_bundle``)."""
    lines: List[str] = []
    if "error" in res:
        lines.append(f"critical path unavailable: {res['error']}")
        for w in res.get("warnings", []):
            lines.append(f"  WARNING: {w}")
        return "\n".join(lines)
    f = res["fractions"]
    lines.append(f"critical path: {res['path_ms']:.1f} ms across "
                 f"{len(res['ranks'])} rank(s)"
                 + (" [PARTIAL]" if res.get("partial") else ""))
    if res.get("trace_id"):
        lines.append(f"  trace_id: {res['trace_id']}")
    if res.get("jtotal_ms") is not None:
        jt = res["jtotal_ms"]
        delta = (abs(res["path_ms"] - jt) / jt * 100.0) if jt else 0.0
        lines.append(f"  measured JTOTAL: {jt:.1f} ms "
                     f"(path within {delta:.1f}%)")
    lines.append(f"  bounding rank: {res['bounding_rank']}   "
                 f"compute {f['compute'] * 100:.1f}% / "
                 f"collective-wait {f['collective_wait'] * 100:.1f}% / "
                 f"straggle {f['straggle'] * 100:.1f}%")
    attr = res.get("attribution_ms", {})
    if attr:
        top = sorted(attr.items(), key=lambda kv: -kv[1])[:4]
        lines.append("  attribution: " + "  ".join(
            f"rank{r}={ms:.1f}ms" for r, ms in top))
    for b in res.get("barriers", []):
        lines.append(f"  barrier {b['name']}#{b['occurrence']} "
                     f"@{b['t_ms']:.1f}ms bound=rank{b['bounding_rank']} "
                     f"skew={b['skew_ms']:.1f}ms")
    for seg in res.get("segments", []):
        lines.append(f"  segment rank{seg['rank']} via {seg['via']}: "
                     f"{seg['dur_ms']:.1f}ms (compute "
                     f"{seg['compute_ms']:.1f} / wait "
                     f"{seg['collective_wait_ms']:.1f} / straggle "
                     f"{seg['straggle_ms']:.1f})")
    for e in res.get("epoch_bumps", []):
        lines.append(f"  epoch bump: {e['event']} rank{e['rank']} "
                     f"@{e['t_ms']:.1f}ms epoch={e['epoch']}")
    hedge = res.get("hedge")
    if hedge:
        strag = hedge.get("straggler")
        lines.append(f"  hedge: {hedge['n_claims']} claim(s)"
                     + (f", straggler=rank{strag}"
                        if strag is not None else ""))
        saved = hedge.get("saved_ms_estimate")
        if saved is not None:
            lines.append(f"  hedge shortened the path by ~{saved:.1f} ms "
                         f"({hedge.get('basis')})")
    for w in res.get("warnings", []):
        lines.append(f"  WARNING: {w}")
    return "\n".join(lines)
