"""The evidence report over a directory of runs, and its three emitters.

    python -m tpu_radix_join_torch.tools.make_report DIR
    python -m tpu_radix_join_torch.tools.make_report DIR \\
        --emit-profile OUT.json [--profile-name NAME]
    python -m tpu_radix_join_torch.tools.make_report DIR \\
        --emit-timeline OUT.json
    python -m tpu_radix_join_torch.tools.make_report DIR \\
        --emit-ledger LEDGER_DIR [--bench-dir D]

Counterpart of the JAX package's ``tools_make_report.py``.  Reads every
``perf_*`` directory (``<rank>.perf`` / ``<rank>.info``, what the command
line's ``--output-dir`` writes), every ``trace_*/breakdown.json`` and the
task logs under DIR, and prints a markdown summary: the ``PHASES`` columns
in ms a join net of repeats, JPROCRATE and RESULTS where present, the
traces' sort shares, the tasks' status.

``--emit-profile`` distills the same directory into a planner device
profile (``planner/profile.py``) on the base ``load_profile()``, the
packaged ``h100``: the median SDISPATCH becomes ``dispatch_floor_ms``, a
device-plane sort-discipline ``trace_*/breakdown.json`` becomes
``sort_stage_unit_ms`` through the stage model (``sort_stage_units``), and
every constant cites its artifact; the rest keep the base's values and
citations.

``--emit-timeline`` merges the ``<rank>.spans.json`` files a
``--timeline-dir`` run left under DIR into one Chrome trace on a shared
clock (``observability/timeline.merge_timeline``), warning of missing
ranks and of each unreadable file with its reason.

``--emit-ledger`` backfills the run ledger (``observability/ledger.
ingest_artifacts``): every ``perf_*`` directory under DIR (one level of
nesting allowed) becomes run rows, timestamped by mtime, and every
``BENCH_r*.json`` under ``--bench-dir`` a bench row.  Unlike JAX's tool it
reads no ``BENCH_r*.json`` unless ``--bench-dir`` names where: the repo
root's are the JAX package's TPU runs.  ``python -m
tpu_radix_join_torch.tools.profile_fit fit`` turns the ledger into a
profile.

Exits 0 on success, 1 when there is nothing to merge or to ingest, 2 on
usage or IO errors.
"""

import argparse
import glob
import json
import os
import sys

from tpu_radix_join_torch.performance.measurements import Measurements

PHASES = ("JHIST", "JMPI", "SLOCPREP", "JPROC", "BPBUILD", "BPPROBE",
          "CTOTAL", "SDISPATCH")


def perf_row(d: str):
    """One table row of a ``perf_*`` directory (rank 0's registry), each
    phase in ms a join: divided by the run's ``repeat`` except SDISPATCH
    (a floor a program) and, in a ``--pipeline-repeats`` run, JHIST (one
    sizing pass for the whole batch).  None when it holds no ``.perf``."""
    ms = Measurements.load(d)
    if not ms:
        return None
    m = ms[0]
    repeat = 1
    info_path = os.path.join(d, f"{m.node_id}.info")
    meta = {}
    if os.path.exists(info_path):
        with open(info_path) as f:
            meta = json.load(f)
        repeat = int((meta.get("config") or {}).get("repeat") or 1)
    pipelined = bool((meta.get("config") or {}).get("pipeline_repeats"))
    row = {"dir": os.path.basename(d), "repeat": repeat,
           "pipelined": "y" if pipelined else "",
           "key_range": meta.get("key_range", "")}
    once_per_call = ("JHIST",) if pipelined else ()
    for tag in PHASES:
        if tag in m.times_us:
            div = 1 if (tag == "SDISPATCH" or tag in once_per_call) else repeat
            row[tag] = m.times_us[tag] / div / 1e3
    if "JPROCRATE" in m.counters:
        row["JPROCRATE_M/s"] = m.counters["JPROCRATE"] / 1e6
    if "RESULTS" in m.counters:
        # the registry's value as written: a single join's count for
        # synchronous repeats, the sum in pipelined mode
        row["RESULTS"] = m.counters["RESULTS"]
    return row


def emit_profile(base_dir: str, out_path: str, name: str = None) -> int:
    """Distill ``base_dir``'s runs into a device profile at ``out_path``."""
    from tpu_radix_join_torch.performance.trace import is_device_plane
    from tpu_radix_join_torch.planner.profile import (SORT_REF_ELEMS,
                                                      load_profile,
                                                      sort_stage_units)

    base = load_profile()
    updates = {}

    # the dispatch floor: the median SDISPATCH over ranks and runs, so one
    # outlying dispatch does not define the profile
    floors = []
    for d in sorted(glob.glob(os.path.join(base_dir, "perf_*"))):
        for m in Measurements.load(d) if os.path.isdir(d) else []:
            if "SDISPATCH" in m.times_us:
                floors.append((m.times_us["SDISPATCH"] / 1e3,
                               os.path.basename(d)))
    if floors:
        floors.sort()
        val, src = floors[len(floors) // 2]
        updates["dispatch_floor_ms"] = {
            "value": round(val, 3),
            "source": f"artifact:{base_dir}/{src} SDISPATCH "
                      f"(median of {len(floors)} runs)"}

    # the sort stage unit: the newest device-plane sort-discipline trace
    # breakdown, normalised by the stage model (t / ((M / ref) * U(M)))
    for path in sorted(glob.glob(os.path.join(base_dir, "trace_*",
                                              "breakdown.json")),
                       reverse=True):
        try:
            with open(path) as f:
                bd = json.load(f)
        except (OSError, ValueError):
            continue
        if (bd.get("sort_share") and bd.get("size")
                and bd.get("discipline", "sort") == "sort"
                and is_device_plane(bd.get("plane", ""))):
            union = 2 * int(bd["size"])
            t_sort = bd["busy_us"] * bd["sort_share"] / bd["iters"] / 1e3
            unit = t_sort / ((union / SORT_REF_ELEMS)
                             * sort_stage_units(union))
            updates["sort_stage_unit_ms"] = {
                "value": round(unit, 5),
                "source": f"artifact:{os.path.relpath(path)} "
                          f"(sort_share over {bd['iters']} iters, "
                          f"union {union})"}
            break

    if not updates:
        print(f"WARNING: no distillable measurements under {base_dir}; "
              f"emitting the base profile's committed constants unchanged",
              file=sys.stderr)
    prof = base.replace_constants(
        name=name or f"{base.name}+{os.path.basename(base_dir.rstrip('/'))}",
        **updates)
    try:
        prof.save(out_path)
    except OSError as e:
        print(f"error: cannot write {out_path}: {e}", file=sys.stderr)
        return 2
    print(f"wrote {out_path} ({prof.name}): "
          f"{', '.join(sorted(updates)) or 'no constants refreshed'}")
    return 0


def emit_timeline(base_dir: str, out_path: str) -> int:
    """Merge the rank span files under ``base_dir`` into one Chrome trace."""
    from tpu_radix_join_torch.observability.timeline import merge_timeline

    try:
        doc = merge_timeline(base_dir, out_path=out_path, trace_dir=base_dir)
    except OSError as e:
        print(f"error: cannot write {out_path}: {e}", file=sys.stderr)
        return 2
    if doc is None:
        print(f"ERROR: no *.spans.json under {base_dir} — run the command "
              f"line with --timeline-dir first", file=sys.stderr)
        return 1
    md = doc["metadata"]
    spans = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
    instants = sum(1 for e in doc["traceEvents"] if e.get("ph") == "i")
    print(f"wrote {out_path}: {len(md['ranks'])} rank(s), {spans} spans, "
          f"{instants} instant events on one clock "
          f"(t0={md['t0_epoch_s']:.3f}); load in Perfetto/chrome://tracing")
    # a killed rank leaves no span file, or a torn one: the merge goes on
    # without it, and says so
    if md.get("missing_ranks"):
        print(f"WARNING: missing_ranks={md['missing_ranks']} — "
              f"{len(md['missing_ranks'])} of {md['expected_ranks']} "
              f"expected rank(s) left no readable span file; the timeline "
              f"is PARTIAL", file=sys.stderr)
    if md.get("corrupt_files"):
        reasons = {e["file"]: e["reason"]
                   for e in md.get("corrupt_file_reasons", [])}
        detail = "; ".join(
            f"{f}: {reasons.get(f, 'unknown reason')}"
            for f in md["corrupt_files"])
        print(f"WARNING: skipped {len(md['corrupt_files'])} span "
              f"file(s) — {detail}", file=sys.stderr)
    return 0


def emit_ledger(base_dir: str, out_path: str, bench_dir: str = None) -> int:
    """Backfill the run ledger at ``out_path`` from ``base_dir``'s runs."""
    from tpu_radix_join_torch.observability.ledger import (Ledger,
                                                           ingest_artifacts)

    try:
        counts = ingest_artifacts(base_dir, out_path, bench_dir=bench_dir)
    except OSError as e:
        print(f"error: cannot write {out_path}: {e}", file=sys.stderr)
        return 2
    print(f"wrote {Ledger(out_path).path}: {counts['bench']} bench row(s), "
          f"{counts['run']} run row(s)")
    if counts["bench"] + counts["run"] == 0:
        print(f"WARNING: nothing to ingest under {base_dir}"
              + (f" or {bench_dir}" if bench_dir else ""), file=sys.stderr)
        return 1
    return 0


def report(base: str) -> int:
    """Print the markdown summary of ``base``."""
    print(f"# Evidence summary: {base}\n")

    print("## Task status\n")
    logs = sorted(glob.glob(os.path.join(base, "*.log")))
    names = sorted({os.path.basename(p).split(".a")[0].removesuffix(".log")
                    for p in logs})
    for name in names:
        done = os.path.exists(os.path.join(base, f"{name}.done"))
        attempts = len(glob.glob(os.path.join(base, f"{name}.a*.log")))
        print(f"- {name}: {'DONE' if done else 'pending'}"
              f" ({attempts} attempt{'s' if attempts != 1 else ''})")

    rows = [r for r in (perf_row(d) for d in sorted(
        glob.glob(os.path.join(base, "perf_*"))) if os.path.isdir(d)) if r]
    if rows:
        # the pipelined column only where some run used it
        keys = ["dir", "repeat"] + (
            ["pipelined"] if any(r["pipelined"] for r in rows) else []
        ) + ["key_range"] + [
            k for k in (*PHASES, "JPROCRATE_M/s", "RESULTS")
            if any(k in r for r in rows)]
        print("\n## Perf artifacts (ms/join; SDISPATCH = floor per program)\n")
        print("| " + " | ".join(keys) + " |")
        print("|" + "---|" * len(keys))
        for r in rows:
            cells = []
            for k in keys:
                v = r.get(k, "")
                cells.append(f"{v:.1f}" if isinstance(v, float) else str(v))
            print("| " + " | ".join(cells) + " |")

    traces = sorted(glob.glob(os.path.join(base, "trace_*",
                                           "breakdown.json")))
    if traces:
        print("\n## Trace breakdowns\n")
        for path in traces:
            with open(path) as f:
                bd = json.load(f)
            per_iter = bd["busy_us"] / bd["iters"] / 1e3
            print(f"- {os.path.relpath(path, base)}: plane `{bd['plane']}`, "
                  f"{per_iter:.1f} ms/iter device-busy, "
                  f"sort share {100 * bd['sort_share']:.1f}%")
            top = sorted(bd["ops"].items(), key=lambda kv: -kv[1]["us"])[:5]
            for name, v in top:
                print(f"    - {v['us'] / bd['iters'] / 1e3:8.2f} ms/iter  "
                      f"{name[:80]}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_radix_join_torch.tools.make_report",
        description="Summarise a directory of runs, or distill it into a "
                    "device profile, a merged timeline or ledger rows.")
    p.add_argument("base_dir", help="directory of perf_* / trace_* runs")
    emit = p.add_mutually_exclusive_group()
    emit.add_argument("--emit-profile", metavar="OUT",
                      help="write a device profile distilled from the runs")
    emit.add_argument("--emit-timeline", metavar="OUT",
                      help="write the merged Chrome trace of the span files")
    emit.add_argument("--emit-ledger", metavar="LEDGER",
                      help="append the runs as ledger rows")
    p.add_argument("--profile-name", default=None,
                   help="the emitted profile's name (default "
                        "<base>+<dir name>)")
    p.add_argument("--bench-dir", default=None,
                   help="with --emit-ledger: also ingest BENCH_r*.json "
                        "from this directory")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.isdir(args.base_dir):
        print(f"error: not a directory: {args.base_dir}", file=sys.stderr)
        return 2
    if args.emit_ledger is not None:
        return emit_ledger(args.base_dir, args.emit_ledger, args.bench_dir)
    if args.emit_timeline is not None:
        return emit_timeline(args.base_dir, args.emit_timeline)
    if args.emit_profile is not None:
        return emit_profile(args.base_dir, args.emit_profile,
                            args.profile_name)
    return report(args.base_dir)


if __name__ == "__main__":
    sys.exit(main())
