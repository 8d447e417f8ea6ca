"""Post-mortem forensics bundles: one self-contained JSON a death.

The port's copy of ``tpu_radix_join/observability/postmortem.py``.  On a
failed served query, a watchdog trip or a terminal classified failure of
the command line, :func:`write_bundle` freezes what a post-mortem needs
into one file:

  * identity: reason, failure class, epoch, rank / host / nodes, query_id
    and trace_id (from the flight recorder's context when the serve path
    stamped one);
  * configuration: the JoinConfig (as a dict) and a stable fingerprint,
    the plan (``meta["plan"]``) and the plan-vs-actual table
    (``meta["plan_vs_actual"]``, planner/audit.py);
  * the black box: the flight recorder's ring, the counter and timer
    registries, the tail of ``meta["events"]``, the tail of the heartbeat
    ``.metrics.jsonl`` when its path is known;
  * the substrate: Python, torch and CUDA versions, the device platform
    and count; every thread's stack when the caller took them (the
    watchdog always does);
  * faults: the active injector's seed, arms, fire history and per-site
    stats, enough to replay the failure.

Bundles are plain JSON, written atomically (tmp + rename), so a bundle
that exists is complete.  Both packages write the same schema (version
1); only the substrate block differs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Optional

BUNDLE_PREFIX = "bundle_"

_EVENTS_TAIL = 80        # most-recent meta["events"] kept in a bundle
_HEARTBEAT_TAIL = 20     # most-recent heartbeat samples kept


def _config_dict(config) -> Optional[dict]:
    if config is None:
        return None
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        return dataclasses.asdict(config)
    if isinstance(config, dict):
        return dict(config)
    return {"repr": repr(config)}


def config_fingerprint(config_dict: Optional[dict]) -> Optional[str]:
    """Stable short hash of a config dict (key-sorted JSON, sha256/16)."""
    if not config_dict:
        return None
    blob = json.dumps(config_dict, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _env_info() -> dict:
    import platform
    import sys
    info = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "pid": os.getpid(),
    }
    try:
        import torch
        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
        # device_count asks the CUDA runtime, never the (possibly hung) stream
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        info["device_count"] = count
        info["device_platform"] = "cuda" if count else "cpu"
    except Exception as e:   # noqa: BLE001 — a dead backend is exactly the
        info["torch_error"] = repr(e)[:200]   # case bundles exist for
    return info


def _chaos_info(chaos=None) -> Optional[dict]:
    """``(seed, arms)`` replay record: from an explicit schedule (an object
    with ``to_json``, such as a chaos runner's violating schedule, or a
    dict) or, failing that, the active FaultInjector.  The bundle's event
    tail carries the run's recovery record (``rank_lost``, ``recovery``,
    ``regrow``, ``hedge``, ``hedge_claim``), which :func:`merge_bundles`
    renders as the recovery timeline."""
    if chaos is not None:
        if hasattr(chaos, "to_json"):
            return chaos.to_json()
        if isinstance(chaos, dict):
            return dict(chaos)
    from tpu_radix_join_torch.robustness import faults as _faults
    inj = _faults.active()
    if inj is None:
        return None
    return {"seed": inj.seed,
            "arms": sorted(inj._arms),
            "history": [list(h) for h in inj.history],
            "site_stats": inj.site_stats()}


def _heartbeat_tail(path: Optional[str]) -> Optional[dict]:
    if not path or not os.path.exists(path):
        return None
    try:
        from tpu_radix_join_torch.observability.metrics import load_samples
        samples = load_samples(path)
    except OSError:
        return None
    return {"path": path, "total_samples": len(samples),
            "tail": samples[-_HEARTBEAT_TAIL:]}


def build_bundle(measurements=None, reason: str = "failure",
                 failure_class: Optional[str] = None, plan=None,
                 config=None, stacks=None, chaos=None,
                 heartbeat_path: Optional[str] = None,
                 extra: Optional[dict] = None) -> dict:
    """Assemble the bundle dict (see module docstring) without touching
    disk — :func:`write_bundle` persists it.  Every section degrades to
    None/absent instead of raising: forensics must not mask the failure
    being forensicked."""
    m = meta = None
    if measurements is not None:
        m, meta = measurements, measurements.meta
    cfg = _config_dict(config)
    if cfg is None and meta is not None and isinstance(
            meta.get("config"), dict):
        cfg = meta["config"]
    bundle: dict = {
        "bundle_version": 1,
        "reason": reason,
        "failure_class": failure_class,
        "created_epoch_s": round(time.time(), 6),
        "env": _env_info(),
        "config": cfg,
        "config_fingerprint": config_fingerprint(cfg),
        "chaos": _chaos_info(chaos),
        "stacks": stacks,
    }
    if m is not None:
        ring = m.flightrec.snapshot()
        qid = ring["context"].get("query_id")
        # trace identity joins this bundle to span files / ledger rows /
        # merged timelines of the same join across every store
        tid = ring["context"].get("trace_id") or meta.get("trace_id")
        bundle.update({
            "rank": m.node_id,
            "host": meta.get("host"),
            "nodes": m.num_nodes,
            "query_id": qid,
            "trace_id": tid,
            "critical_path": meta.get("critical_path"),
            "ring": ring,
            "counters": dict(m.counters),
            "times_us": {k: round(v, 1) for k, v in m.times_us.items()},
            "open_phases": sorted(m._starts),
            "events_tail": list(meta.get("events", []))[-_EVENTS_TAIL:],
            "plan": plan if plan is not None else meta.get("plan"),
            "plan_vs_actual": meta.get("plan_vs_actual"),
            "heartbeat": _heartbeat_tail(
                heartbeat_path or meta.get("heartbeat_path")),
        })
    else:
        bundle["plan"] = plan
        bundle["heartbeat"] = _heartbeat_tail(heartbeat_path)
    if extra:
        bundle["extra"] = dict(extra)
    return bundle


def write_bundle(out_dir: str, measurements=None, reason: str = "failure",
                 failure_class: Optional[str] = None, plan=None,
                 config=None, stacks=None, chaos=None,
                 heartbeat_path: Optional[str] = None,
                 extra: Optional[dict] = None) -> str:
    """Write one forensics bundle into ``out_dir``; returns its path.

    Atomic (tmp + rename), JSON-only, uniquely named by reason + rank +
    nanosecond timestamp.  Ticks the ``PMBUNDLE`` counter and records a
    ``bundle`` event so bundle emission itself is observable (and
    regress-gated: more bundles per round means more deaths)."""
    bundle = build_bundle(measurements=measurements, reason=reason,
                          failure_class=failure_class, plan=plan,
                          config=config, stacks=stacks, chaos=chaos,
                          heartbeat_path=heartbeat_path, extra=extra)
    os.makedirs(out_dir, exist_ok=True)
    rank = bundle.get("rank", 0) or 0
    name = f"{BUNDLE_PREFIX}{reason}_r{rank}_{time.time_ns()}.json"
    path = os.path.join(out_dir, name)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(bundle, f, indent=2, default=str)
    os.replace(tmp, path)
    if measurements is not None:
        from tpu_radix_join_torch.performance.measurements import PMBUNDLE
        measurements.incr(PMBUNDLE)
        measurements.event("bundle", reason=reason, path=path,
                           failure_class=failure_class)
    return path


def load_bundle(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def list_bundles(dir_path: str) -> list:
    """Bundle paths under ``dir_path``, oldest first (name-ordered: the
    nanosecond timestamp in the name sorts chronologically per rank)."""
    if not os.path.isdir(dir_path):
        return []
    return [os.path.join(dir_path, n) for n in sorted(os.listdir(dir_path))
            if n.startswith(BUNDLE_PREFIX) and n.endswith(".json")]


# ------------------------------------------------------------------ rendering
def render_bundle(bundle: dict, ring_tail: int = 20,
                  stacks: bool = True) -> str:
    """Human-readable report of one bundle (tools_postmortem.py)."""
    ln = []
    add = ln.append
    add(f"== bundle: {bundle.get('reason')} "
        f"[{bundle.get('failure_class')}] ==")
    created = bundle.get("created_epoch_s")
    if created:
        add(f"created: {time.strftime('%Y-%m-%d %H:%M:%S', time.gmtime(created))}Z")
    add(f"rank: {bundle.get('rank')} host: {bundle.get('host')} "
        f"nodes: {bundle.get('nodes')}")
    if bundle.get("query_id"):
        add(f"query_id: {bundle['query_id']}")
    if bundle.get("trace_id"):
        add(f"trace_id: {bundle['trace_id']}")
    cp = bundle.get("critical_path")
    if cp and not cp.get("error"):
        from tpu_radix_join_torch.observability.critpath import \
            format_summary
        add(f"critical path: {format_summary(cp)}")
    env = bundle.get("env") or {}
    add("env: " + " ".join(f"{k}={v}" for k, v in sorted(env.items())
                           if v is not None))
    if bundle.get("config_fingerprint"):
        add(f"config_fingerprint: {bundle['config_fingerprint']}")
    plan = bundle.get("plan")
    if plan:
        add(f"plan: strategy={plan.get('strategy')} "
            f"predicted_ms={plan.get('predicted_ms')} "
            f"profile={plan.get('profile_name')}")
    pva = bundle.get("plan_vs_actual")
    if pva:
        add("plan-vs-actual:")
        add(f"  strategy={pva.get('strategy')} "
            f"predicted_ms={pva.get('predicted_ms')} "
            f"actual_ms={pva.get('actual_ms')} "
            f"drift_pct={pva.get('drift_pct')}")
        for row in pva.get("terms", []):
            add(f"    {row.get('term'):<12} predicted_ms="
                f"{row.get('predicted_ms')} actual_ms={row.get('actual_ms')}")
    if bundle.get("open_phases"):
        add(f"open phases at death: {bundle['open_phases']}")
    chaos = bundle.get("chaos")
    if chaos:
        add(f"chaos: seed={chaos.get('seed')} arms={chaos.get('arms')}")
    hb = bundle.get("heartbeat")
    if hb:
        add(f"heartbeat: {hb.get('total_samples')} samples at "
            f"{hb.get('path')}")
    ring = bundle.get("ring") or {}
    recs = ring.get("records", [])
    add(f"flight recorder: {ring.get('recorded', 0)} recorded, "
        f"{len(recs)} retained; last {min(ring_tail, len(recs))}:")
    for rec in recs[-ring_tail:]:
        extras = {k: v for k, v in rec.items()
                  if k not in ("t_s", "kind", "name")}
        tail = f"  {extras}" if extras else ""
        add(f"  {rec.get('t_s')}: {rec.get('kind'):<8} "
            f"{rec.get('name')}{tail}")
    events = bundle.get("events_tail") or []
    if events:
        add(f"events tail ({len(events)}):")
        for ev in events[-10:]:
            extras = {k: v for k, v in ev.items()
                      if k not in ("event", "t_s", "t_epoch_s")}
            add(f"  {ev.get('t_epoch_s')}: {ev.get('event')}"
                + (f"  {extras}" if extras else ""))
    if stacks and bundle.get("stacks"):
        add("thread stacks:")
        for label, frames in bundle["stacks"].items():
            add(f"  -- {label} --")
            for fr in frames:
                for sub in fr.split("\n"):
                    if sub:
                        add(f"    {sub}")
    if bundle.get("extra"):
        add(f"extra: {bundle['extra']}")
    return "\n".join(ln)


def merge_bundles(paths) -> dict:
    """Cross-bundle summary (the merger half of tools_postmortem.py):
    counts by reason and failure class, the time range, per-rank
    presence, and each bundle's one-line identity — the shape a fleet
    report wants before anyone opens individual bundles."""
    reasons: dict = {}
    classes: dict = {}
    ranks: dict = {}
    epochs: dict = {}
    incarnations: dict = {}
    timeline = []
    rows = []
    t_min = t_max = None
    for p in paths:
        try:
            b = load_bundle(p)
        except (OSError, ValueError) as e:
            rows.append({"path": p, "error": repr(e)[:120]})
            continue
        reasons[b.get("reason")] = reasons.get(b.get("reason"), 0) + 1
        fc = b.get("failure_class")
        classes[fc] = classes.get(fc, 0) + 1
        rank = b.get("rank")
        ranks[str(rank)] = ranks.get(str(rank), 0) + 1
        t = b.get("created_epoch_s")
        if t is not None:
            t_min = t if t_min is None else min(t_min, t)
            t_max = t if t_max is None else max(t_max, t)
        pva = b.get("plan_vs_actual") or {}
        # membership epoch: every epoch bump / hedge stamps
        # membership_epoch into the flight-recorder context, so the ring
        # carries it directly — the live context first, else the newest
        # stamped record, else the exception's own stamp in extra.  No
        # more inferring from a neighboring record's MEPOCH gauge.
        ring = b.get("ring") or {}
        mepoch = (ring.get("context") or {}).get("membership_epoch")
        if mepoch is None:
            for rec in reversed(ring.get("records") or []):
                if "membership_epoch" in rec:
                    mepoch = rec["membership_epoch"]
                    break
        if mepoch is None:
            mepoch = (b.get("extra") or {}).get("membership_epoch")
        epochs[str(mepoch)] = epochs.get(str(mepoch), 0) + 1
        # worker incarnation: fleet workers (``main.py --serve`` under the
        # fleet supervisor, ROADMAP A16b step 2) stamp their
        # incarnation id (w<slot>i<n>) into the flight-recorder context at
        # serve start, so a crash-looping slot's bundles — one per death —
        # group into a single per-incarnation timeline instead of reading
        # as unrelated failures.  Same extraction chain as the membership
        # epoch above.
        wincarn = (ring.get("context") or {}).get("worker_incarnation")
        if wincarn is None:
            for rec in reversed(ring.get("records") or []):
                if "worker_incarnation" in rec:
                    wincarn = rec["worker_incarnation"]
                    break
        if wincarn is None:
            wincarn = (b.get("extra") or {}).get("worker_incarnation")
        incarnations[str(wincarn)] = incarnations.get(str(wincarn), 0) + 1
        # the recovery timeline: membership + recovery events from every
        # bundle's event tail, aligned on the cross-process wall clock —
        # losses and recoveries, plus the growth/hedging vocabulary
        # (admissions, hedge fence claims, regrow/hedge recoveries,
        # straggle verdicts)
        for ev in b.get("events_tail") or []:
            if ev.get("event") in ("rank_lost", "recovery", "rank_join",
                                   "hedge_claim", "regrow", "hedge",
                                   "straggle"):
                timeline.append(dict(ev, rank=rank, bundle=p))
        rows.append({"path": p, "reason": b.get("reason"),
                     "failure_class": fc, "rank": rank,
                     "query_id": b.get("query_id"),
                     "trace_id": b.get("trace_id"),
                     "critical_path": b.get("critical_path"),
                     "membership_epoch": mepoch,
                     "worker_incarnation": wincarn,
                     "strategy": pva.get("strategy")
                     or (b.get("plan") or {}).get("strategy"),
                     "drift_pct": pva.get("drift_pct"),
                     "created_epoch_s": t})
    timeline.sort(key=lambda ev: ev.get("t_epoch_s") or 0)
    return {"bundles": len(rows), "by_reason": reasons,
            "by_failure_class": classes, "by_rank": ranks,
            "by_membership_epoch": epochs,
            "by_worker_incarnation": incarnations,
            "recovery_timeline": timeline,
            "t_first": t_min, "t_last": t_max, "rows": rows}
