"""Forensics-bundle renderer/merger CLI (``observability/postmortem.py``).

    python -m tpu_radix_join_torch.tools.postmortem BUNDLE.json
    python -m tpu_radix_join_torch.tools.postmortem forensics/
    python -m tpu_radix_join_torch.tools.postmortem forensics/ --merge
    python -m tpu_radix_join_torch.tools.postmortem a.json b.json \\
        --merge --json

Counterpart of the JAX package's ``tools_postmortem.py``.  A *bundle* is
the self-contained JSON a run emits on any terminal failure, deadline
expiry, breaker trip, watchdog trip, or chaos violation: config
fingerprint, JoinPlan, plan-vs-actual audit table, flight-recorder ring,
heartbeat tail, thread stacks, chaos ``(seed, arms)``, env and device
info.  Rendering turns one bundle into a readable report; ``--merge``
summarizes many (counts by reason/failure class/rank, time range, one row
per bundle) — the shape a fleet report wants before anyone opens
individual bundles.  The bundles of either package read the same.

Exits 0 on success, 1 when any input is unreadable, 2 on usage errors.
"""

import argparse
import json
import os
import sys

from tpu_radix_join_torch.observability.postmortem import (list_bundles,
                                                           load_bundle,
                                                           merge_bundles,
                                                           render_bundle)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_radix_join_torch.tools.postmortem",
        description="Render or merge post-mortem forensics bundles.")
    p.add_argument("paths", nargs="+",
                   help="bundle file(s) and/or directories of bundles")
    p.add_argument("--merge", action="store_true",
                   help="cross-bundle summary instead of per-bundle "
                        "rendering")
    p.add_argument("--json", action="store_true",
                   help="raw JSON output (merge summary, or the loaded "
                        "bundles)")
    p.add_argument("--ring-tail", type=int, default=20,
                   help="flight-recorder records to show per bundle "
                        "(default %(default)s)")
    p.add_argument("--no-stacks", action="store_true",
                   help="omit thread stacks from rendered output")
    return p


def _expand(paths) -> list:
    out = []
    for p in paths:
        if os.path.isdir(p):
            found = list_bundles(p)
            if not found:
                print(f"WARNING: no bundle_*.json under {p}",
                      file=sys.stderr)
            out.extend(found)
        else:
            out.append(p)
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    paths = _expand(args.paths)
    if not paths:
        print("error: no bundles to read", file=sys.stderr)
        return 2
    if args.merge:
        summary = merge_bundles(paths)
        if args.json:
            print(json.dumps(summary, indent=2))
        else:
            print(f"{summary['bundles']} bundle(s), "
                  f"{summary['t_first']} .. {summary['t_last']}")
            print(f"by reason:        {summary['by_reason']}")
            print(f"by failure class: {summary['by_failure_class']}")
            print(f"by rank:          {summary['by_rank']}")
            print(f"by mesh epoch:    {summary['by_membership_epoch']}")
            # fleet workers stamp w<slot>i<n> incarnation ids; a crash-
            # looping slot's bundles then read as one timeline per
            # incarnation.  Suppressed when nothing was stamped (every
            # bundle groups under "None" for non-fleet runs).
            incarn = summary.get("by_worker_incarnation") or {}
            if set(incarn) - {"None"}:
                print(f"by incarnation:   {incarn}")
            if summary["recovery_timeline"]:
                # grouped by membership epoch: every epoch's block reads
                # as one fencing story — what changed the membership
                # (loss/admission), the hedge fence claims written under
                # it, and the recovery that closed it
                print("recovery timeline:")
                by_epoch = {}
                for ev in summary["recovery_timeline"]:
                    by_epoch.setdefault(ev.get("epoch"), []).append(ev)
                for epoch in sorted(by_epoch,
                                    key=lambda e: (e is None, e)):
                    print(f"  membership epoch {epoch}:")
                    for ev in by_epoch[epoch]:
                        what = ev.get("event")
                        if what == "rank_lost":
                            detail = (f"lost={ev.get('ranks')} "
                                      f"cause={ev.get('cause')} "
                                      f"survivors={ev.get('survivors')}")
                        elif what == "rank_join":
                            detail = (f"admitted={ev.get('ranks')} "
                                      f"members={ev.get('members')}")
                        elif what == "hedge_claim":
                            detail = (f"partition={ev.get('partition')} "
                                      f"owner={ev.get('owner')}")
                        elif what == "hedge":
                            detail = (f"straggler={ev.get('straggler')} "
                                      f"progress={ev.get('progress')} "
                                      f"median={ev.get('median')} "
                                      f"outstanding="
                                      f"{ev.get('outstanding')}")
                        elif what == "straggle":
                            detail = (f"victim={ev.get('rank')} "
                                      f"factor={ev.get('factor')}")
                        elif what == "regrow":
                            detail = f"joined={ev.get('joined_ranks')}"
                        else:
                            detail = (f"resumed={ev.get('resumed')} "
                                      f"recomputed={ev.get('recomputed')} "
                                      f"matches={ev.get('matches')}")
                        print(f"    t={ev.get('t_epoch_s')} "
                              f"rank={ev.get('rank')} {what} {detail}")
            for row in summary["rows"]:
                if "error" in row:
                    print(f"  UNREADABLE {row['path']}: {row['error']}")
                    continue
                drift = (f" drift={row['drift_pct']}%"
                         if row.get("drift_pct") is not None else "")
                qid = (f" query={row['query_id']}"
                       if row.get("query_id") else "")
                tid = (f" trace={row['trace_id']}"
                       if row.get("trace_id") else "")
                mep = (f" epoch={row['membership_epoch']}"
                       if row.get("membership_epoch") is not None else "")
                winc = (f" incarnation={row['worker_incarnation']}"
                        if row.get("worker_incarnation") is not None else "")
                print(f"  {row['path']}: {row['reason']} "
                      f"[{row['failure_class']}] rank={row['rank']} "
                      f"strategy={row.get('strategy')}{drift}{qid}{tid}"
                      f"{mep}{winc}")
                # per-query critical-path breakdown: which rank's which
                # phase bounded this bundle's join, and how much of it
                # was waiting (rows without one cost nothing)
                cp = row.get("critical_path")
                if cp and not cp.get("error"):
                    f = cp.get("fractions") or {}
                    top = cp.get("top_phase") or {}
                    print(f"    critical path: {cp.get('path_ms')}ms "
                          f"bound=rank{cp.get('bounding_rank')} "
                          f"compute={f.get('compute', 0) * 100:.0f}% "
                          f"wait={f.get('collective_wait', 0) * 100:.0f}% "
                          f"straggle={f.get('straggle', 0) * 100:.0f}%"
                          + (f" top={top.get('name')}@"
                             f"r{top.get('rank')}:{top.get('ms')}ms"
                             if top else ""))
                    hedge = cp.get("hedge") or {}
                    if hedge.get("n_claims"):
                        saved = hedge.get("saved_ms_estimate")
                        print(f"    hedge: {hedge['n_claims']} claim(s)"
                              + (f", shortened path ~{saved}ms "
                                 f"({hedge.get('basis')})"
                                 if saved is not None else ""))
        bad = sum(1 for r in summary["rows"] if "error" in r)
        return 1 if bad else 0
    rc = 0
    for i, path in enumerate(paths):
        try:
            bundle = load_bundle(path)
        except (OSError, ValueError) as e:
            print(f"error: unreadable bundle {path}: {e!r}",
                  file=sys.stderr)
            rc = 1
            continue
        if args.json:
            print(json.dumps(bundle, indent=2))
            continue
        if i:
            print()
        print(f"# {path}")
        print(render_bundle(bundle, ring_tail=args.ring_tail,
                            stacks=not args.no_stacks))
    return rc


if __name__ == "__main__":
    sys.exit(main())
