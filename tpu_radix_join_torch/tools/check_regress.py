"""Perf-regression gate CLI: a fresh result JSON against a baseline.

    python -m tpu_radix_join_torch.tools.check_regress FRESH.json \
        --baseline BASELINE.json
    python -m tpu_radix_join_torch.tools.check_regress FRESH.json \
        --baseline BASELINE.json --threshold 0.25 \
        --tag-threshold JTOTAL=0.10 --allow SWINALLOC

Prints the per-tag delta table (worse% > 0 means the fresh run regressed:
a cost tag grew or a rate tag dropped) and exits

    0  no tag past its threshold (or the baseline has no numeric tags),
    1  at least one regression,
    2  usage / IO errors (unreadable files, bad --tag-threshold spec).

``--strict`` also fails tags present in the baseline but missing from the
fresh result — a silently vanished measurement is itself a signal.

Counterpart of the JAX package's ``tools_check_regress.py``; the
comparison, the tag directions and the table live in the port's
``observability/regress.py`` (tag for tag the JAX gate's), so a result of
either package gates the same way.  Any flat JSON of numeric tags is a
result: a ``Measurements.summary()`` dump, the command line's result line
(``python -m tpu_radix_join_torch.main``), a fleet summary, a
``tools.lint --json`` count.
"""

import argparse
import sys

from tpu_radix_join_torch.observability.regress import (DEFAULT_THRESHOLD,
                                                        check_files,
                                                        parse_tag_thresholds)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_radix_join_torch.tools.check_regress",
        description="Compare a fresh result JSON against a perf baseline.")
    p.add_argument("fresh", help="fresh result (any flat JSON of numeric "
                                 "tags)")
    p.add_argument("--baseline", required=True,
                   help="baseline JSON of the same shape")
    p.add_argument("--threshold", type=float, default=DEFAULT_THRESHOLD,
                   help="default relative worsening allowed per tag "
                        "(default %(default)s)")
    p.add_argument("--tag-threshold", action="append", default=[],
                   metavar="TAG=REL",
                   help="per-tag override, repeatable (e.g. JTOTAL=0.10)")
    p.add_argument("--allow", action="append", default=[], metavar="TAG",
                   help="tag allowed to regress this round, repeatable")
    p.add_argument("--strict", action="store_true",
                   help="also fail baseline tags missing from the fresh "
                        "result")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        tag_thr = parse_tag_thresholds(args.tag_threshold)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        code, report = check_files(
            args.fresh, args.baseline, threshold=args.threshold,
            tag_thresholds=tag_thr, allow=args.allow, strict=args.strict)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(report)
    return code


if __name__ == "__main__":
    sys.exit(main())
