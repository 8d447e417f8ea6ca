"""The port's lint command line: its convention rules as a gating check.

    python -m tpu_radix_join_torch.tools.lint            # all rules
    python -m tpu_radix_join_torch.tools.lint --strict   # stale fails too
    python -m tpu_radix_join_torch.tools.lint --rule sync-point
    python -m tpu_radix_join_torch.tools.lint --no-baseline
    python -m tpu_radix_join_torch.tools.lint --list-rules
    python -m tpu_radix_join_torch.tools.lint --json LINT.json

Counterpart of the JAX package's ``tools_lint.py``.  Prints one
``path:line:rule-id: message`` per live finding plus the suppressed/stale
accounting, and exits

    0  clean (no live finding; under --strict also no stale suppression),
    1  at least one live finding (or a stale suppression under --strict),
    2  usage / IO errors (unknown rule, unreadable file, a baseline
       entry without a reason — suppression reasons are mandatory).

The rules and the walker live in ``tpu_radix_join_torch/analysis/``; the
committed suppression file is ``analysis/LINT_BASELINE.json`` — every
entry carries a one-line reason, and a stale entry (its finding was
fixed) must be removed with the fix.

``--json`` writes ``{"lint_findings": N, ...}``; ``lint_findings`` is
pinned lower-is-better in ``observability/regress.py``, so a finding-count
regression gates through ``tools.check_regress`` like a perf regression.

The runtime twin of the ``sync-point`` rule is the sync guard:
``main.py --transfer-guard disallow`` arms
``torch.cuda.set_sync_debug_mode("error")`` around the join.
"""

import argparse
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_radix_join_torch.tools.lint",
        description="Run the port's AST lint rules over its source.")
    p.add_argument("--rule", action="append", default=[], metavar="ID",
                   help="run only this rule id, repeatable (default: all)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="suppression file (default: tpu_radix_join_torch/"
                        "analysis/LINT_BASELINE.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline: report every finding")
    p.add_argument("--strict", action="store_true",
                   help="stale baseline suppressions also fail (exit 1)")
    p.add_argument("--list-rules", action="store_true",
                   help="print rule ids + docs and exit 0")
    p.add_argument("--json", default=None, metavar="FILE",
                   help="also write machine-readable counts "
                        "({'lint_findings': N, ...})")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from tpu_radix_join_torch.analysis import (LintError, RULES,
                                               default_baseline,
                                               register_builtin_rules,
                                               run_lint)
    register_builtin_rules()
    if args.list_rules:
        for rid in sorted(RULES):
            r = RULES[rid]
            print(f"{rid:18s} [{r.token}-ok] {r.doc}")
        return 0
    baseline = None
    if not args.no_baseline:
        baseline = args.baseline or default_baseline(REPO_ROOT)
        if args.baseline and not os.path.exists(args.baseline):
            print(f"error: baseline {args.baseline} not found",
                  file=sys.stderr)
            return 2
    try:
        res = run_lint(REPO_ROOT, rule_ids=args.rule or None,
                       baseline_path=baseline)
    except LintError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for f in res.findings:
        print(f.render())
    for e in res.stale:
        print(f"stale suppression: {e['rule']} {e['path']} key={e['key']!r}"
              f" — finding no longer fires; remove the entry")
    per_rule = {}
    for f in res.findings:
        per_rule[f.rule] = per_rule.get(f.rule, 0) + 1
    summary = {"lint_findings": len(res.findings),
               "suppressed": len(res.suppressed),
               "stale_baseline": len(res.stale),
               "rules_run": res.rules,
               "per_rule": per_rule}
    if args.json:
        try:
            with open(args.json, "w") as fh:
                json.dump(summary, fh, indent=2)
        except OSError as e:
            print(f"error: cannot write {args.json}: {e}", file=sys.stderr)
            return 2
    code = res.exit_code(strict=args.strict)
    verdict = "clean" if code == 0 else "FINDINGS"
    print(f"lint: {verdict} — {len(res.findings)} finding(s), "
          f"{len(res.suppressed)} baselined, {len(res.stale)} stale "
          f"suppression(s), rules: {', '.join(res.rules)}")
    return code


if __name__ == "__main__":
    sys.exit(main())
