"""Fit, refresh or diff device profiles from a run ledger.

    python -m tpu_radix_join_torch.tools.profile_fit fit --ledger DIR
    python -m tpu_radix_join_torch.tools.profile_fit fit --ledger DIR \\
        --base h100 --out DIR/profile_fitted.json --min-samples 2
    python -m tpu_radix_join_torch.tools.profile_fit refresh --ledger DIR
    python -m tpu_radix_join_torch.tools.profile_fit diff h100 \\
        DIR/profile_fitted.json

Counterpart of the JAX package's ``tools_profile_fit.py``, over the
port's ``planner/calibrate.py``, with its flags; ``--base`` defaults to
``h100``.

``fit`` robust-fits every constant the ledger has ``--min-samples``
samples for (``fit_profile``) and writes a profile whose provenance
blocks cite the run ids, the sample count, the 95% CI and the residual;
the default ``--out`` is the ``profile_fitted.json`` that ``--profile
auto`` prefers while it is fresh.  An under-sampled fit is refused (exit
2): a profile that only echoes its base under a fit's name would poison
the provenance.  The constants kept from the base are listed with their
sample counts.

``refresh`` runs the staleness detection (persistent PLANDRIFT blamed on
each drifting plan's dominant cost term) and re-fits; it exits 1 when it
found stale constants, 0 when none.

``diff`` prints each constant's relative change between two profiles
(names or paths) and exits 1 when one moved past ``--threshold``.

**Only the card's rows fit the card's profile.**  Fitting onto ``h100``
(or a profile fitted from it), a row is a sample only when its
fingerprint's ``device`` names an H100: the tool sets the others aside
and says how many, so no TPU number (the JAX package's backfilled rows
carry no device, or a TPU's) and no CPU run becomes an ``h100`` constant.
JAX's tool has no such rule.

Exits 0 on success, 1 on findings (stale constants, a diff past the
threshold), 2 on usage or IO errors and refused fits.
"""

import argparse
import os
import sys
from typing import List, Tuple

from tpu_radix_join_torch.observability.ledger import (default_ledger_dir,
                                                       load_rows)
from tpu_radix_join_torch.planner.calibrate import (DEFAULT_DRIFT_THRESHOLD_PCT,
                                                    DEFAULT_MIN_PERSIST,
                                                    DEFAULT_MIN_SAMPLES,
                                                    UnderSampledError,
                                                    collect_samples,
                                                    detect_stale,
                                                    diff_profiles,
                                                    fit_profile)
from tpu_radix_join_torch.planner.profile import (DEFAULT_PROFILE,
                                                  FITTED_PROFILE_BASENAME,
                                                  ProfileError,
                                                  format_provenance,
                                                  load_profile)

#: the word a fingerprint's device must hold to fit the card's profile
CARD_DEVICE = "H100"
#: row kinds that carry samples (``calibrate.collect_samples``)
SAMPLE_KINDS = ("run", "bench", "obs")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_radix_join_torch.tools.profile_fit",
        description="Fit, refresh, or diff device profiles from a run "
                    "ledger.")
    sub = p.add_subparsers(dest="cmd", required=True)

    def ledger_args(sp):
        sp.add_argument("--ledger", default=None, metavar="DIR_OR_FILE",
                        help="ledger dir or .jsonl (default: "
                             "$TPU_RADIX_LEDGER_DIR or artifacts/ledger)")
        sp.add_argument("--base", default=DEFAULT_PROFILE,
                        help="base profile name/path for unfitted constants "
                             "(default %(default)s)")
        sp.add_argument("--min-samples", type=int,
                        default=DEFAULT_MIN_SAMPLES,
                        help="refuse to fit a constant from fewer samples "
                             "(default %(default)s)")

    f = sub.add_parser("fit", help="fit a profile from ledger samples")
    ledger_args(f)
    f.add_argument("--out", default=None,
                   help="output profile path (default "
                        f"<ledger dir>/{FITTED_PROFILE_BASENAME})")
    f.add_argument("--name", default=None, help="fitted profile name")

    r = sub.add_parser("refresh", help="detect stale constants and re-fit")
    ledger_args(r)
    r.add_argument("--out", default=None,
                   help="output profile path (default "
                        f"<ledger dir>/{FITTED_PROFILE_BASENAME})")
    r.add_argument("--name", default=None, help="fitted profile name")
    r.add_argument("--drift-threshold", type=float,
                   default=DEFAULT_DRIFT_THRESHOLD_PCT,
                   help="PLANDRIFT percent that counts as a miss "
                        "(default %(default)s)")
    r.add_argument("--min-persist", type=int, default=DEFAULT_MIN_PERSIST,
                   help="misses before a constant is stale "
                        "(default %(default)s)")

    d = sub.add_parser("diff", help="per-constant delta between profiles")
    d.add_argument("a", help="profile name or path (reference)")
    d.add_argument("b", help="profile name or path (candidate)")
    d.add_argument("--threshold", type=float, default=0.25,
                   help="relative delta past which exit is 1 "
                        "(default %(default)s)")
    return p


def _resolve_ledger(args) -> str:
    return args.ledger or default_ledger_dir()


def card_rows(rows: List[dict], base_name: str) -> Tuple[List[dict], int]:
    """The rows that may fit a profile of ``base_name``, and how many were
    set aside: onto ``h100`` (or a profile fitted from it) a sample row
    counts only when its fingerprint's device names an H100."""
    if base_name.split("+")[0] != DEFAULT_PROFILE:
        return rows, 0
    kept = [r for r in rows if r.get("kind") not in SAMPLE_KINDS
            or CARD_DEVICE in str((r.get("fingerprint") or {})
                                  .get("device", ""))]
    return kept, len(rows) - len(kept)


def _fit(args, rows, base, stale=None) -> int:
    ledger = _resolve_ledger(args)
    try:
        prof, fits = fit_profile(rows, base=base, name=args.name,
                                 min_samples=args.min_samples)
    except UnderSampledError as e:
        print(f"error: under-sampled fit refused: {e}", file=sys.stderr)
        return 2
    out = args.out or os.path.join(
        ledger if not ledger.endswith(".jsonl") else os.path.dirname(ledger),
        FITTED_PROFILE_BASENAME)
    try:
        prof.save(out)
    except OSError as e:
        print(f"error: cannot write {out}: {e}", file=sys.stderr)
        return 2
    print(f"fitted {len(fits)}/{len(prof.constants)} constants from "
          f"{len(rows)} ledger rows -> {out}")
    samples = collect_samples(rows)
    kept = [f"{k} (n={len(samples.get(k, []))})" for k in sorted(
        base.constants) if k not in fits]
    if kept:
        print(f"kept from {base.name} (under {args.min_samples} samples): "
              + ", ".join(kept))
    print(format_provenance(prof, stale=stale))
    return 0


def _load_rows(args):
    """The ledger's rows that may fit ``--base``, and the base; prints how
    many rows it set aside.  (None, None, rc) when they cannot be had."""
    ledger = _resolve_ledger(args)
    rows = load_rows(ledger)
    if not rows:
        print(f"error: no ledger rows at {ledger}", file=sys.stderr)
        return None, None, 2
    try:
        base = load_profile(args.base)
    except (ProfileError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return None, None, 2
    rows, dropped = card_rows(rows, base.name)
    if dropped:
        print(f"set aside {dropped} ledger row(s) whose fingerprint names "
              f"no {CARD_DEVICE} (fitting onto {base.name})")
    return rows, base, 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd in ("fit", "refresh"):
        rows, base, rc = _load_rows(args)
        if rc:
            return rc
        if args.cmd == "fit":
            return _fit(args, rows, base)
        stale = detect_stale(rows, threshold_pct=args.drift_threshold,
                             min_persist=args.min_persist)
        rc = _fit(args, rows, base, stale=stale)
        if rc != 0:
            return rc
        if stale:
            print(f"stale constants re-fit: {', '.join(sorted(stale))}")
            return 1            # evidence found: the old profile had aged
        print("no stale constants")
        return 0
    try:
        a, b = load_profile(args.a), load_profile(args.b)
    except (ProfileError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    worst = 0.0
    print(f"{'constant':<24} {'a (' + a.name + ')':>20} "
          f"{'b (' + b.name + ')':>20} {'rel_delta':>10}")
    for r in diff_profiles(a, b):
        rel = r["rel_delta"]
        worst = max(worst, rel or 0.0)
        print(f"{r['constant']:<24} "
              f"{r['a'] if r['a'] is not None else '-':>20} "
              f"{r['b'] if r['b'] is not None else '-':>20} "
              f"{f'{rel:.1%}' if rel is not None else '-':>10}")
    if worst > args.threshold:
        print(f"max relative delta {worst:.1%} exceeds "
              f"--threshold {args.threshold:.1%}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
