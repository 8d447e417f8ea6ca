"""Chaos/soak CLI: N seeded fault schedules, pass-or-classified invariant.

    python -m tpu_radix_join_torch.tools.chaos --runs 25 --base-seed 100
    python -m tpu_radix_join_torch.tools.chaos --runs 10 --demo-shrink
    python -m tpu_radix_join_torch.tools.chaos --device cpu --size 4096
    torchrun --standalone --nproc-per-node 4 \\
        -m tpu_radix_join_torch.tools.chaos --nodes 4 --verify repair

Counterpart of the JAX package's ``tools_chaos.py`` over the port's
``robustness/chaos.py``.  Each run arms a seeded schedule of fault sites,
executes one join on known-oracle inputs with integrity verification on,
and classifies the outcome: ``pass`` (count matches the oracle),
``classified`` (the run failed but named its failure class), or
``violation`` (silent wrong count / unclassified crash).  A violating
schedule is delta-debug-shrunk to a minimal still-violating arm set and
its ``(seed, arms)`` repro is printed and written to --artifact-dir.

The joins run on the card unless ``--device cpu`` asks for the host, as
every entry point of the port.  ``--nodes N`` > 1 runs one rank of an
N-rank process group (torchrun's environment); rank 0 prints.  The JAX
tool's four-node default is a virtual mesh in one process, which the port
has not: its default is one rank.

``--demo-shrink`` runs the harness against a verify-off engine — the
configuration the checksums exist to protect — so the exchange-corruption
arm produces a real silent-wrong-count violation, demonstrating shrink
and repro end to end.  Exits

    0  no violations (invariant held),
    1  at least one violation (repro lines printed above the summary),
    2  usage errors.
"""

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_radix_join_torch.tools.chaos",
        description="Seeded chaos soak over the join engine with "
                    "verification on; shrinks violating schedules to "
                    "minimal replayable repros.")
    p.add_argument("--runs", type=int, default=25,
                   help="number of seeded schedules to execute (default 25)")
    p.add_argument("--base-seed", type=int, default=0,
                   help="schedule seeds are base-seed .. base-seed+runs-1")
    p.add_argument("--verify", choices=("off", "check", "repair"),
                   default="check",
                   help="engine verification mode under chaos (default "
                        "check; off demonstrates the silent-corruption "
                        "violation the harness exists to catch)")
    p.add_argument("--nodes", type=int, default=1,
                   help="ranks of the soak engine; > 1 runs under torchrun "
                        "(default 1)")
    p.add_argument("--size", type=int, default=1 << 12,
                   help="tuples per side; keys are oracle-friendly so the "
                        "true match count is exactly this (default 4096)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain versions")
    p.add_argument("--artifact-dir", default="artifacts/chaos",
                   help="where violating-schedule repro JSONs are written")
    p.add_argument("--demo-shrink", action="store_true",
                   help="force verify=off so corruption arms violate; "
                        "exercises shrink + repro replay and exits 0 iff "
                        "every shrunk repro replays deterministically")
    return p


def _group(args):
    """(process group or None, rank) for ``--nodes``."""
    if args.nodes == 1:
        return None, 0
    import torch.distributed as dist

    from tpu_radix_join_torch.parallel import multihost
    multihost.initialize(device=args.device)
    if dist.get_world_size() != args.nodes:
        raise SystemExit(f"error: --nodes {args.nodes} but the process "
                         f"group has {dist.get_world_size()} ranks")
    return dist.group.WORLD, dist.get_rank()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.runs <= 0:
        print("error: --runs must be positive", file=sys.stderr)
        return 2
    if args.nodes < 1 or args.size % args.nodes:
        print("error: --nodes must be >= 1 and divide --size",
              file=sys.stderr)
        return 2
    from tpu_radix_join_torch.robustness import chaos

    group, rank = _group(args)
    say = print if rank == 0 else (lambda *a, **k: None)
    verify = "off" if args.demo_shrink else args.verify
    # violations drop forensics bundles (observability/postmortem.py)
    # next to the repro JSONs; the repro line names its bundle path
    runner = chaos.ChaosRunner(num_nodes=args.nodes, size=args.size,
                               verify=verify, device=args.device,
                               group=group,
                               bundle_dir=os.path.join(args.artifact_dir,
                                                       "forensics"))

    def show(out):
        cls = f" class={out.failure_class}" if out.failure_class else ""
        detail = f" ({out.detail})" if out.status == chaos.VIOLATION else ""
        say(f"[CHAOS] seed={out.schedule.seed} {out.status}{cls} "
            f"arms={[s for s, _ in out.schedule.arms]}{detail}")

    outcomes, summary = chaos.soak(args.runs, base_seed=args.base_seed,
                                   runner=runner, on_outcome=show)

    replay_failures = 0
    for out in outcomes:
        if out.status != chaos.VIOLATION:
            continue
        shrunk = chaos.shrink(
            out.schedule,
            lambda s: runner.run(s).status == chaos.VIOLATION)
        repro = runner.run(shrunk)
        again = runner.run(shrunk)
        if (repro.status, repro.matches) != (again.status, again.matches):
            replay_failures += 1
            print(f"[CHAOS] WARNING: shrunk seed={shrunk.seed} repro is "
                  f"not deterministic", file=sys.stderr)
        if rank != 0:
            continue
        os.makedirs(args.artifact_dir, exist_ok=True)
        path = os.path.join(args.artifact_dir,
                            f"repro_seed{shrunk.seed}.json")
        say("[CHAOS] repro " + chaos.write_repro(repro, path))
        say(f"[CHAOS] repro written to {path} "
            f"(shrunk {len(out.schedule.arms)} -> {len(shrunk.arms)} arms)")
        if repro.bundle:
            say(f"[CHAOS] forensics bundle {repro.bundle} (render: python "
                f"-m tpu_radix_join_torch.tools.postmortem {repro.bundle})")
    say("[CHAOS] " + json.dumps(summary, sort_keys=True))
    if args.demo_shrink:
        # demo mode: violations are the point; success = every shrunk
        # repro replayed deterministically
        if summary["violations"] == 0:
            print("[CHAOS] demo-shrink produced no violations (no "
                  "corruption arm drawn?) — widen --runs", file=sys.stderr)
            return 1
        return 0 if replay_failures == 0 else 1
    return 0 if summary["violations"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
