"""Cross-rank critical-path reporter (``observability/critpath.py``).

    python -m tpu_radix_join_torch.tools.critical_path TIMELINE_DIR
    python -m tpu_radix_join_torch.tools.critical_path TIMELINE_DIR --json
    python -m tpu_radix_join_torch.tools.critical_path TIMELINE_DIR --summary
    python -m tpu_radix_join_torch.tools.critical_path TIMELINE_DIR \\
        --trace-id ID

Counterpart of the JAX package's ``tools_critical_path.py``.  Ingests the
per-rank ``<rank>.spans.json`` exports a ``--timeline-dir`` run leaves
behind (grouped by join-level trace id, so a directory holding several
runs still yields one coherent join), reconstructs the cross-rank causal
DAG, and prints the critical path: which rank's which phase bounded the
wall clock, how much of the path was compute vs collective-wait vs
straggle, per-barrier skew with the bounding rank named, and any manifest
hedge claims with the estimated path shortening.

Partial-tolerant: missing ranks and torn spans degrade to a PARTIAL path
with warnings.  Exits 0 on a usable path (even partial), 1 when no path
could be reconstructed, 2 on usage errors.
"""

import argparse
import json
import os
import sys

from tpu_radix_join_torch.observability.critpath import (
    critical_path_for_dir, format_summary, render_report)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_radix_join_torch.tools.critical_path",
        description="Reconstruct the cross-rank critical path from a "
                    "--timeline-dir of span exports.")
    p.add_argument("timeline_dir",
                   help="directory of <rank>.spans.json exports")
    p.add_argument("--trace-id", default=None,
                   help="only ingest span files of this join-level trace "
                        "id (default: the largest coherent cohort wins)")
    p.add_argument("--json", action="store_true",
                   help="emit the raw result dict instead of the report")
    p.add_argument("--summary", action="store_true",
                   help="one [CRITPATH] line instead of the full report")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.isdir(args.timeline_dir):
        print(f"error: not a directory: {args.timeline_dir}",
              file=sys.stderr)
        return 2
    res = critical_path_for_dir(args.timeline_dir, trace_id=args.trace_id)
    if args.json:
        print(json.dumps(res, indent=2, default=str))
    elif args.summary:
        print(f"[CRITPATH] {format_summary(res)}")
    else:
        print(render_report(res))
    return 1 if "error" in res else 0


if __name__ == "__main__":
    sys.exit(main())
