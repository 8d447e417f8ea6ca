"""Command line of the port: one join of two generated relations.

The subset of ``tpu_radix_join/main.py`` the port runs, with its flag names
and defaults: the inner relation is unique with seed ``--seed``, the outer
one of ``--outer-kind`` with seed ``--seed + 1``; the join runs through
``HashJoin(JoinConfig(...)).join_arrays`` on the placed relations.
``--nodes N`` runs it over N ranks, one GPU each, launched by torchrun:
every rank generates its shard of each relation (``--tuples-per-node``
tuples), joins over the NCCL process group (gloo with ``--device cpu``)
and checks the result against the oracle; rank 0 prints it.
``--hosts H`` spreads the ranks over H hosts and takes the hierarchical
exchange; ``--skew-threshold`` splits hot partitions (inner side
replicated, outer side spread); ``--retry-backoff`` pauses between
capacity retries.
``--probe bucket`` or ``--two-level`` select the partitioned join;
``--key-range`` picks the sort probe's 32-bit discipline; ``--chunk-size``
streams the probe after the shuffle in slabs; ``--fallback chunked`` lets
a partitioned join short of capacity count out of core.

Rank 0 prints the JAX command line's report
(``tpu_radix_join/main.py:1832-1872``): ``[RESULTS] Tuples / Expected /
Conservation / Throughput`` (and
``failure/<k>`` lines for a failed join), then the registry's ``[PERF]``
lines — or, over several ranks, ``print_results`` of every rank's registry
(``Measurements.gather_all``, which every rank calls) — and ``[PERF] stored
<path>`` with ``--output-dir``, where each rank writes ``<rank>.perf`` and
``<rank>.info``.  ``--measure-phases`` fences the JMPI / SLOCPREP / JPROC
columns, ``--trace`` brackets the joins with the profiler (CTOTAL and the
per-op table; under ``--output-dir``/trace), ``--repeat N`` joins N times
(with ``--pipeline-repeats`` as one ``join_arrays(..., repeats=N)``: sized
once, one readback; not with ``--measure-phases``).  ``--debug-checks``
adds the exchange's per-partition conservation checks; ``--generation
host`` generates the relations with numpy and copies them to the device.
``--exchange-codec pack|auto`` bit-packs the exchange, ``--exchange-stages
K`` exchanges it in K column groups, and ``--verify check|repair``
checksums every network partition across it (repairing out of core, in
``--grid-pipeline``'s mode).  ``--sort-impl`` and ``--partition-impl`` take
JAX's choices: "auto" (and "pallas", "pallas_interpret") runs the kernels at
every ``--network-fanout`` / ``--local-fanout``; "xla" / "sort" runs the
library baseline arm, counted apart and named in the result's
``baseline_arms``.
Its last line is one JSON object: the result, the host-clock join time, and
the registry's ``phases_us`` and ``counters``.
``--serve FILE`` (``-`` = stdin) runs the resident join service instead
(``_run_serve``, service/): one JoinSession serves every JSON request line
of FILE through the result cache (``--result-cache``), micro-batching
(``--batch-window-ms``), the delta merge (``--resident-budget-mb``) or the
engine, behind admission (``--serve-queue-depth``,
``--serve-tenant-quota``, ``--serve-batch``), deadlines
(``--serve-deadline-s``) and the breaker (``--breaker-threshold``,
``--breaker-cooldown-s``), warm-started by the plan cache
(``--plan-cache-dir``, ``--profile``); it prints one outcome line a query
and a summary line, and under torchrun every rank serves the same file and
rank 0 prints.  ``--fleet`` (A16b) and ``--statusz`` (A18) are refused.
``--grid-chunk-tuples N`` runs the out-of-core grid instead (``_run_grid``):
both relations streamed in device-generated chunks of N tuples, every
chunk pair probed once, with checkpoints under ``--checkpoint-dir`` that
``--resume`` continues from (a checkpoint of the JAX package's CLI
resumes here too, and the reverse).
``--plan auto`` prices every execution discipline under ``--profile``'s
constants (planner/: the cost model, ``plan_join``) and runs the cheapest:
its ``[PLAN]`` line, ``meta["plan"]``, the plan's JoinConfig, a chunked
plan's ``--grid-chunk-tuples`` and ``--grid-pipeline``, and the
plan-vs-actual audit (``[PLAN] actual_ms=...``, PLANDRIFT); ``--plan
FILE`` replays a saved plan; ``--plan explain`` prints the cost table and
the profile's provenance and exits 0 without joining.  ``--profile auto``
takes the ledger's fresh ``profile_fitted.json``, else ``h100``;
``--ledger-dir`` appends one run row at exit (and a row a query under
``--serve``).

Usage:
    python -m tpu_radix_join_torch.main --tuples-per-node 20000000
    torchrun --standalone --nproc-per-node 4 -m tpu_radix_join_torch.main --nodes 4
    torchrun --standalone --nproc-per-node 2 -m tpu_radix_join_torch.main --nodes 2 --device cpu
    torchrun --standalone --nproc-per-node 4 -m tpu_radix_join_torch.main --nodes 4 --hosts 2 --device cpu --outer-kind zipf --skew-threshold 4
    python -m tpu_radix_join_torch.main --key-range full --tuples-per-node 20000000
    python -m tpu_radix_join_torch.main --probe bucket --tuples-per-node 20000000
    python -m tpu_radix_join_torch.main --two-level --outer-kind zipf --max-retries 2
    python -m tpu_radix_join_torch.main --device cpu --tuples-per-node 65536
    python -m tpu_radix_join_torch.main --device cpu --output-dir /tmp/perf --measure-phases
    torchrun --standalone --nproc-per-node 2 -m tpu_radix_join_torch.main --nodes 2 --device cpu --chunk-size 1024
    python -m tpu_radix_join_torch.main --grid-chunk-tuples 134217728 --tuples-per-node 1073741824
    python -m tpu_radix_join_torch.main --device cpu --grid-chunk-tuples 4096 --tuples-per-node 16384
    python -m tpu_radix_join_torch.main --pipeline-repeats --repeat 3 --generation host
    torchrun --standalone --nproc-per-node 4 -m tpu_radix_join_torch.main --nodes 4 --device cpu --exchange-codec pack --exchange-stages 4 --verify check
    python -m tpu_radix_join_torch.main --serve requests.jsonl --probe bucket --result-cache 8 --resident-budget-mb 1024
    python -m tpu_radix_join_torch.main --plan auto --tuples-per-node 20000000 --ledger-dir /tmp/ledger
    python -m tpu_radix_join_torch.main --plan explain --profile auto --ledger-dir /tmp/ledger
    torchrun --standalone --nproc-per-node 4 -m tpu_radix_join_torch.main --nodes 4 --device cpu --serve requests.jsonl
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from tpu_radix_join_torch.core.config import PARTITION_IMPLS, SORT_IMPLS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_radix_join_torch",
        description="Radix hash join (PyTorch + CUDA)")
    p.add_argument("--tuples-per-node", type=int, default=1 << 20,
                   help="tuples per relation and rank (reference: 20M, "
                        "main.cpp:70)")
    p.add_argument("--nodes", type=int, default=1,
                   help="ranks of the join, one GPU each; more than 1 needs "
                        "a torchrun launch (torchrun --nproc-per-node N)")
    p.add_argument("--hosts", type=int, default=1,
                   help="hosts the ranks span; >1 takes the hierarchical "
                        "exchange, within each host and then across them")
    p.add_argument("--network-fanout", type=int, default=5,
                   help="network radix bits (Configuration.h:30)")
    p.add_argument("--local-fanout", type=int, default=5)
    p.add_argument("--two-level", action="store_true",
                   help="enable second-level partitioning (Configuration.h:28)")
    p.add_argument("--probe", choices=["sort", "bucket"], default="sort")
    p.add_argument("--key-range", choices=["auto", "narrow", "full"],
                   default="auto",
                   help="32-bit sort-probe discipline: the packed 31-bit "
                        "probe (narrow), the full-range one (full), or per "
                        "join from the key bounds (auto)")
    p.add_argument("--partition-impl",
                   choices=PARTITION_IMPLS,
                   default="auto",
                   help="partition/reorder implementation (ops/radix.py): "
                        "'auto' takes the hand-written histogram (K1) and "
                        "partition (K4) kernels at every fanout, past their "
                        "shared bins on their wide paths; 'pallas' and "
                        "'pallas_interpret' (JAX's kernel names) take them "
                        "too; 'sort' forces the library baseline arm (a "
                        "stable argsort and bincount), counted apart")
    p.add_argument("--sort-impl",
                   choices=SORT_IMPLS,
                   default="auto",
                   help="sort implementation behind every hot reorder "
                        "(ops/sorting.py): 'auto' takes the hand-written "
                        "LSD radix sort (K2), fewer digit passes when key "
                        "bounds shrink the effective width; 'pallas' and "
                        "'pallas_interpret' take it too; 'xla' forces the "
                        "library baseline arm (stable torch.sort), counted "
                        "apart")
    p.add_argument("--assignment", choices=["round_robin", "load_aware"],
                   default="round_robin")
    p.add_argument("--window-sizing", choices=["measured", "static"],
                   default="measured")
    p.add_argument("--chunk-size", type=int, default=None,
                   help="stream the probe in slabs of this many tuples "
                        "(out-of-core LD mode)")
    p.add_argument("--max-retries", type=int, default=0,
                   help="capacity-shortfall retries with doubled shapes "
                        "(grid mode: transient-error retries of a pair)")
    p.add_argument("--retry-backoff", type=float, default=0.0,
                   help="seconds to pause before the first capacity retry "
                        "(doubles each attempt, robustness/retry.py); 0 = "
                        "immediate")
    p.add_argument("--fallback", choices=["none", "chunked"], default="none",
                   help="after --max-retries capacity doublings still "
                        "overflow: 'chunked' degrades to the out-of-core "
                        "count instead of returning ok=False")
    p.add_argument("--verify", choices=["off", "check", "repair"],
                   default="off",
                   help="integrity verification (robustness/verify.py): "
                        "per-partition count/sum/xor checksums of the key "
                        "lanes before the exchange and after it (and after "
                        "the second radix pass on the bucket path); "
                        "'check' fails a mismatched join with "
                        "failure_class=data_corruption, 'repair' recomputes "
                        "the damaged partitions out of core (VREPAIR)")
    p.add_argument("--exchange-codec", choices=["off", "pack", "auto"],
                   default="off",
                   help="exchange wire (data/tuples.make_wire_spec): 'pack' "
                        "bit-packs key remainders and rids to their bounds, "
                        "the block header carrying the counts (one "
                        "collective a relation); 'auto' packs only when the "
                        "packed block beats the raw 8/12 B lanes")
    p.add_argument("--exchange-stages", type=int, default=1, metavar="K",
                   help="staged exchange (parallel/window.py): each block "
                        "buffer in K column groups, K sequenced "
                        "collectives, bounding the live exchange buffer to "
                        "about 1/K; 1 = fused, 0 = auto (4 stages once "
                        "blocks hold 4096 slots)")
    p.add_argument("--grid-chunk-tuples", type=int, default=None,
                   help="run the out-of-core grid join (ops/chunked.py), "
                        "streaming both relations in chunks of this many "
                        "tuples")
    p.add_argument("--grid-pipeline", choices=["off", "on", "auto"],
                   default="auto",
                   help="grid engine: 'on' sorts each inner chunk once per "
                        "row and overlaps prefetch, readbacks and "
                        "checkpoint writes; 'off' is the synchronous loop; "
                        "'auto' pipelines any grid larger than one pair")
    p.add_argument("--checkpoint-dir", default=None,
                   help="grid mode: directory of the checkpoint file, "
                        "saved after every chunk pair (see --resume)")
    p.add_argument("--resume", action="store_true",
                   help="grid mode: resume from the checkpoint in "
                        "--checkpoint-dir (default: a fresh run removes a "
                        "stale checkpoint first)")
    p.add_argument("--skew-threshold", type=float, default=None,
                   help="split partitions heavier than this multiple of the "
                        "mean (replicate inner / spread outer); off by "
                        "default")
    p.add_argument("--outer-kind", choices=["unique", "modulo", "zipf"],
                   default="unique")
    p.add_argument("--modulo", type=int, default=None,
                   help="modulo of the outer keys (default: size // 4)")
    p.add_argument("--zipf-theta", type=float, default=0.75)
    p.add_argument("--seed", type=int, default=1234,
                   help="base seed (reference: srand(1234+nodeId), main.cpp:94)")
    p.add_argument("--debug-checks", action="store_true",
                   help="per-partition conservation invariants "
                        "(JOIN_ASSERT analog; extra passes)")
    p.add_argument("--generation", choices=["auto", "host", "device"],
                   default="auto",
                   help="relation materialization: on-device generation "
                        "(auto/device) or host numpy + copy (host)")
    p.add_argument("--pipeline-repeats", action="store_true",
                   help="run the --repeat joins as one pipelined join: "
                        "sized once, no readback between them, one fence; "
                        "no per-join retry loop")
    p.add_argument("--measure-phases", action="store_true",
                   help="fence each join attempt so .perf carries JMPI, "
                        "SLOCPREP and JPROC columns (costs a synchronize a "
                        "phase)")
    p.add_argument("--output-dir", default=None,
                   help="experiment dir for .perf/.info files (default: none)")
    p.add_argument("--trace", action="store_true",
                   help="bracket the joins with torch.profiler: CTOTAL "
                        "lands in .perf and the per-op device table in "
                        ".info; requires --output-dir")

    def positive_int(v):
        iv = int(v)
        if iv < 1:
            raise argparse.ArgumentTypeError("must be >= 1")
        return iv

    p.add_argument("--repeat", type=positive_int, default=1)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain versions")
    # --- the resident join service (service/) ----------------------------
    p.add_argument("--serve", default=None, metavar="FILE",
                   help="resident service mode: read one JSON query request "
                        "a line from FILE ('-' = stdin), serve them all "
                        "through one JoinSession (engine, kernels and "
                        "converged capacities stay warm), and print one "
                        "outcome JSON line a query and a summary line with "
                        "the SLO percentiles")
    p.add_argument("--serve-batch", type=int, default=1, metavar="N",
                   help="serve mode: submit N requests before draining "
                        "(default 1 = closed loop)")
    p.add_argument("--serve-queue-depth", type=int, default=64,
                   help="serve mode: admission queue depth bound "
                        "(exceeded -> admission_rejected/queue_full)")
    p.add_argument("--serve-tenant-quota", type=int, default=8,
                   help="serve mode: max in-flight queries per tenant "
                        "(exceeded -> admission_rejected/tenant_quota)")
    p.add_argument("--serve-deadline-s", type=float, default=None,
                   metavar="SEC",
                   help="serve mode: default per-query latency budget "
                        "(a request's own deadline_s wins; expiry -> "
                        "deadline_exceeded)")
    p.add_argument("--result-cache", type=int, default=0, metavar="N",
                   help="serve mode: a result cache of N entries keyed by "
                        "relation content; repeated queries answer before "
                        "admission, served_by=cache_hit (default 0 = off)")
    p.add_argument("--result-cache-ttl-s", type=float, default=None,
                   metavar="SEC",
                   help="serve mode: expire result-cache entries older "
                        "than SEC (default: no TTL)")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   metavar="MS",
                   help="serve mode: coalesce co-batchable queries arriving "
                        "within MS into one fused device program (one K2 "
                        "sort, one probe), served_by=batched (default 0 = "
                        "off)")
    p.add_argument("--batch-max", type=int, default=8, metavar="N",
                   help="serve mode: max queries fused into one batch")
    p.add_argument("--place-cache-max", type=int, default=8, metavar="N",
                   help="serve mode: placed relations a session keeps on "
                        "the device")
    p.add_argument("--resident-budget-mb", type=float, default=0.0,
                   metavar="MB",
                   help="serve mode: device memory for resident sorted "
                        "inner lanes; incremental requests "
                        "(delta_tuples_per_node > 0) then sort only their "
                        "delta and merge it, served_by=delta_merge "
                        "(default 0 = off)")
    p.add_argument("--breaker-threshold", type=int, default=3,
                   help="serve mode: consecutive backend failures that trip "
                        "the circuit breaker onto the degraded CPU engine")
    p.add_argument("--breaker-cooldown-s", type=float, default=30.0,
                   help="serve mode: seconds the breaker stays open before "
                        "its half-open health probe")
    p.add_argument("--plan", default=None, metavar="auto|explain|FILE",
                   help="planner (planner/): 'auto' prices every execution "
                        "discipline against the --profile constants and "
                        "runs the cheapest feasible one; 'explain' prints "
                        "the per-strategy cost table and the profile's "
                        "provenance and exits without joining; a path "
                        "replays a saved JoinPlan JSON")
    p.add_argument("--plan-cache-dir", default=None,
                   help="persist the engine's converged window capacities "
                        "(and a --plan auto plan) here, fingerprinted by "
                        "the profile, the shapes and the config, so a later "
                        "run skips planning and the sizing pass; serve "
                        "mode's default: a session-private directory")
    p.add_argument("--profile", default="h100",
                   help="device profile of the planner and the plan cache: "
                        "a packaged name ('h100', fitted on the card), a "
                        "profile JSON path, or 'auto': the ledger's fitted "
                        "profile_fitted.json while fresh, else 'h100'")
    p.add_argument("--ledger-dir", default=None,
                   help="append this run's distilled registry (phase times, "
                        "counters, plan and plan-vs-actual) to the run "
                        "ledger here at exit, and in serve mode one row a "
                        "query (observability/ledger.py; default: "
                        "$TPU_RADIX_LEDGER_DIR, else off); --profile auto "
                        "and --plan explain read it")
    p.add_argument("--fleet", type=int, default=None, metavar="N",
                   help="not ported (ROADMAP A16b): the fleet supervisor")
    p.add_argument("--statusz", type=int, default=None, metavar="PORT",
                   help="not ported (ROADMAP A18): the live status endpoint")
    return p


def _run_grid(args, inner, outer, expected, meas, plan=None) -> int:
    """Grid mode: both relations streamed in device-generated chunks,
    every (inner, outer) chunk pair probed once; slabs of
    ``min(chunk, 2**20)``.  ``--grid-pipeline auto`` takes a chunked
    plan's choice, and a plan is folded into the checkpoint's fingerprint
    and audited against the grid's JTOTAL.  Prints one JSON line; a
    classified failure (``failure_class`` on the exception) prints it and
    returns 1."""
    from tpu_radix_join_torch.core.device import resolve_device
    from tpu_radix_join_torch.data.streaming import stream_chunks_device
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.ops.chunked import chunked_join_grid
    from tpu_radix_join_torch.planner.audit import audit_plan, phase_snapshot
    from tpu_radix_join_torch.robustness.retry import RetryPolicy

    dev = resolve_device(args.device)
    chunk = args.grid_chunk_tuples
    ckpt_path = None
    if args.checkpoint_dir:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        ckpt_path = os.path.join(args.checkpoint_dir, "grid.ckpt")
        if not args.resume and os.path.exists(ckpt_path):
            os.remove(ckpt_path)   # a fresh run never resumes a stale file
    # the JAX CLI's tag: everything that changes the grid's total
    tag = (f"{args.outer_kind}:{inner.global_size}:{args.seed}:{chunk}:"
           f"{args.key_range}")
    policy = (RetryPolicy(max_attempts=args.max_retries + 1,
                          base_delay_s=0.5, jitter=0.1)
              if args.max_retries else None)
    # "auto" defers to a chunked plan (the cost model priced both grid
    # rows); an explicit off/on wins
    pipeline = args.grid_pipeline
    if pipeline == "auto" and plan is not None and plan.engine == "chunked":
        pipeline = plan.grid_pipeline
    cuda = dev.type == "cuda"
    kernels.reset_launches()
    times0 = phase_snapshot(meas)
    t0 = time.perf_counter()
    meas.start("JTOTAL")
    try:
        total = chunked_join_grid(
            stream_chunks_device(inner, 0, chunk, dev),
            lambda: stream_chunks_device(outer, 0, chunk, dev),
            min(chunk, 1 << 20), checkpoint_path=ckpt_path,
            checkpoint_tag=tag, progress=True, key_range=args.key_range,
            measurements=meas, retry_policy=policy,
            pipeline=pipeline, sort_impl=args.sort_impl, plan=plan)
    except Exception as e:
        cls = getattr(e, "failure_class", None)
        if cls is None:
            raise
        meas.stop("JTOTAL")
        meas.meta["failure_class"] = cls
        print(json.dumps({"ok": False, "failure_class": cls,
                          "error": str(e)}))
        return 1
    if cuda:
        torch.cuda.synchronize(dev)
    meas.stop("JTOTAL")
    grid_s = time.perf_counter() - t0
    audit = audit_plan(plan, meas, times0=times0)
    if audit is not None:
        print(f"[PLAN] actual_ms={audit['actual_ms']:.1f} "
              f"predicted_ms={audit['predicted_ms']:.1f} "
              f"drift={audit['drift_pct']:.1f}%")
    pairs = meas.counters.get("GRIDPAIRS", 0)
    ok = expected is None or total == expected
    if args.output_dir:
        print(f"[PERF] stored {meas.store(args.output_dir)}")
    print(json.dumps({
        "matches": total, "ok": ok, "expected": expected,
        "grid_ms": grid_s * 1e3, "tuples": 2 * inner.global_size,
        "tuples_per_s": 2 * inner.global_size / grid_s,
        "pairs": pairs, "pairs_per_s": pairs / grid_s,
        "matches_per_s": total / grid_s,
        "counters": dict(meas.counters), "launches": kernels.launch_counts(),
        "chunk_tuples": chunk, "grid_pipeline": pipeline,
        "key_range": args.key_range,
        "plan": plan.strategy if plan is not None else None,
        "plan_vs_actual": audit,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
    }))
    return 0 if ok else 1


def _ledger_dir(args):
    """The run ledger's directory: the flag, then $TPU_RADIX_LEDGER_DIR;
    None keeps no ledger."""
    return args.ledger_dir or os.environ.get("TPU_RADIX_LEDGER_DIR")


def _ledger_flush(args, meas) -> None:
    """Append this run's registry as one ``run`` row at exit.  A run that
    measured nothing (``--plan explain``) writes none; a failed write is a
    line on stderr, never the run's exit code."""
    d = _ledger_dir(args)
    if not d or (not meas.times_us and not meas.counters):
        return
    try:
        from tpu_radix_join_torch.observability.ledger import (Ledger,
                                                               run_payload)
        led = Ledger(d)
        row = led.append("run", run_payload(meas))
        print(f"[OBS] ledger row {row['run_id']} -> {led.path}",
              file=sys.stderr)
    except Exception as e:   # noqa: BLE001 — the ledger never fails a run
        print(f"[OBS] ledger append failed: {e!r}", file=sys.stderr)


def _plan(args, nodes: int, rank: int, meas):
    """The planner's part of a join run (``tpu_radix_join/main.py:
    1520-1630``): (rc, plan, costs, plan cache).  ``rc`` is not None when
    the run ends here: 0 after ``--plan explain`` has printed the cost
    table and the profile's provenance (staleness from the ledger's
    rows); 2 on a plan-cache manifest of another topology or profile, an
    unreadable plan or profile, or a profile constant the plan needs and
    the profile leaves unset."""
    from tpu_radix_join_torch.planner import (PlanError, ProfileError,
                                              load_profile)

    try:
        return _plan_with(args, nodes, rank, meas, load_profile(args.profile))
    except (PlanError, ProfileError) as e:
        print(f"[PLAN] {e}", file=sys.stderr)
        return 2, None, None, None


def _plan_with(args, nodes, rank, meas, profile):
    from tpu_radix_join_torch.planner import (JoinPlan, ManifestMismatch,
                                              PlanCache, Workload,
                                              explain_table, plan_join)

    global_size = args.tuples_per_node * nodes
    plan = costs = plan_cache = None
    if args.plan_cache_dir:
        plan_cache = PlanCache(args.plan_cache_dir, profile,
                               measurements=meas)
        try:
            plan_cache.check_manifest(nodes)
        except ManifestMismatch as e:
            print(f"[PLAN] {e}", file=sys.stderr)
            return 2, None, None, None
        plan_cache.write_manifest(nodes, rank=rank)
    if args.plan in ("auto", "explain"):
        workload = Workload(r_tuples=global_size, s_tuples=global_size,
                            key_bound=global_size,   # keys lie in [0, N)
                            num_nodes=nodes, repeats=args.repeat)
        wl_fp = {"workload": dataclasses.asdict(workload)}
        if plan_cache is not None and args.plan == "auto":
            plan, _ = plan_cache.lookup(global_size, global_size, wl_fp)
        if plan is None:
            plan, costs = plan_join(profile, workload)
            if args.plan == "explain":
                from tpu_radix_join_torch.observability.ledger import (
                    default_ledger_dir, load_rows)
                from tpu_radix_join_torch.planner import (detect_stale,
                                                          format_provenance)
                if rank == 0:
                    print(explain_table(costs, plan))
                    ld = _ledger_dir(args) or default_ledger_dir()
                    print(format_provenance(
                        profile, stale=detect_stale(load_rows(ld))))
                return 0, plan, costs, plan_cache
            if plan_cache is not None:
                plan_cache.store(global_size, global_size, wl_fp, plan=plan)
    elif args.plan is not None:
        plan = JoinPlan.load(args.plan)
    if plan is not None:
        if rank == 0:
            print(f"[PLAN] strategy={plan.strategy} engine={plan.engine} "
                  f"predicted_ms={plan.predicted_ms:.1f} "
                  f"profile={plan.profile_name or profile.name}")
        meas.meta["plan"] = plan.to_dict()
        meas.event("plan_decision", strategy=plan.strategy,
                   engine=plan.engine,
                   predicted_ms=round(plan.predicted_ms, 3))
        # the JAX registry tags its spans with these (ROADMAP A18d)
        meas.meta["trace_tags"] = {"strategy": plan.strategy,
                                   "engine": plan.engine}
        if plan.engine == "chunked" and nodes == 1:
            if args.grid_chunk_tuples is None:
                args.grid_chunk_tuples = plan.chunk_tuples or (1 << 20)
        elif plan.engine == "chunked" and rank == 0:
            print("[PLAN] the chunked engine runs on one rank; keeping the "
                  "in-core engine at this world size", file=sys.stderr)
    return None, plan, costs, plan_cache


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.trace and not args.output_dir:
        parser.error("--trace writes its artifacts under --output-dir")
    if args.resume and not args.checkpoint_dir:
        parser.error("--resume reads the checkpoint under --checkpoint-dir")
    if args.pipeline_repeats and args.measure_phases:
        parser.error("--pipeline-repeats dispatches without intermediate "
                     "fences; the --measure-phases split timers need a "
                     "fence per program — drop one of the two")
    if args.nodes > 1 and args.grid_chunk_tuples is not None:
        parser.error("the grid join runs on one GPU (--nodes 1)")
    if args.fleet is not None:
        parser.error("--fleet is not ported to PyTorch yet (ROADMAP.md "
                     "queue A, A16b: the fleet supervisor)")
    if args.statusz is not None:
        parser.error("--statusz is not ported to PyTorch yet (ROADMAP.md "
                     "queue A, A18: host-side modules)")
    if args.serve is not None and args.grid_chunk_tuples is not None:
        parser.error("--serve runs the in-core resident engine; the "
                     "out-of-core grid is a one-shot mode")
    if args.serve == "-" and args.nodes > 1:
        parser.error("--serve - reads stdin, which only one rank has: give "
                     "every rank the same request FILE")
    if args.profile == "auto":
        from tpu_radix_join_torch.planner import resolve_profile
        args.profile = resolve_profile("auto", ledger_dir=_ledger_dir(args))
        print(f"[PROFILE] auto -> {args.profile}", file=sys.stderr)
    from tpu_radix_join_torch.parallel import multihost

    group = None
    if args.nodes > 1:
        if not multihost.initialize(device=args.device):
            parser.error(f"--nodes {args.nodes} runs under torchrun "
                         f"(torchrun --nproc-per-node {args.nodes} -m "
                         "tpu_radix_join_torch.main ...)")
        group = dist.group.WORLD
    try:
        if args.serve is not None:
            return _run_serve(args, group)
        return _run_join(args, group)
    finally:
        multihost.shutdown()


def _join_config(args):
    """The JoinConfig of the command line's join flags."""
    from tpu_radix_join_torch import JoinConfig

    return JoinConfig(network_fanout_bits=args.network_fanout,
                      local_fanout_bits=args.local_fanout,
                      two_level=args.two_level, probe_algorithm=args.probe,
                      assignment_policy=args.assignment,
                      window_sizing=args.window_sizing,
                      key_range=args.key_range, num_nodes=args.nodes,
                      num_hosts=args.hosts, max_retries=args.max_retries,
                      retry_backoff_s=args.retry_backoff,
                      skew_threshold=args.skew_threshold,
                      fallback=args.fallback,
                      chunk_size=args.chunk_size,
                      debug_checks=args.debug_checks,
                      generation=args.generation,
                      measure_phases=args.measure_phases,
                      exchange_codec=args.exchange_codec,
                      exchange_stages=args.exchange_stages,
                      verify=args.verify, grid_pipeline=args.grid_pipeline,
                      sort_impl=args.sort_impl,
                      partition_impl=args.partition_impl)


def _serve_lines(args, batcher, flush_groups):
    """The request lines of ``--serve``: the file's, or stdin's as they
    come.  Under a batch window stdin is read by a thread into a timed
    queue, so a parked group flushes when its window expires even while
    stdin is quiet (``_run_serve``, tpu_radix_join/main.py:802-842)."""
    if args.serve != "-":
        with open(args.serve) as f:
            return f.read().splitlines()
    if args.batch_window_ms <= 0:
        return iter(sys.stdin)
    import queue
    import threading

    lineq: "queue.Queue" = queue.Queue()

    def read_lines():
        try:
            for raw in sys.stdin:
                lineq.put(raw)
        finally:
            lineq.put(None)

    threading.Thread(target=read_lines, name="serve-stdin",
                     daemon=True).start()

    def timed_lines():
        while True:
            nd = batcher.next_deadline_s()
            wait = 0.2 if nd is None else max(0.001, min(0.2, nd))
            try:
                raw = lineq.get(timeout=wait)
            except queue.Empty:
                flush_groups(batcher.due())
                continue
            if raw is None:
                return
            yield raw

    return timed_lines()


def _run_serve(args, group) -> int:
    """Resident service mode (``_run_serve``, tpu_radix_join/main.py:
    643-905): every request flows through one :class:`JoinSession`.  One
    outcome JSON line a query, then a summary line with the SLO snapshot;
    over several ranks every rank serves the same stream and rank 0
    prints.  Returns 1 when a request line was malformed or a query
    failed (admission rejections are backpressure, not failures), 2 on a
    plan-cache manifest of another topology or profile."""
    from tpu_radix_join_torch.core.config import ServiceConfig
    from tpu_radix_join_torch.performance.measurements import Measurements
    from tpu_radix_join_torch.service import (AdmissionRejected, JoinSession,
                                              MicroBatcher, QueryRequest)

    nodes = args.nodes
    rank = dist.get_rank(group) if group is not None else 0
    meas = Measurements(node_id=rank, num_nodes=nodes)
    plan_cache = None
    if args.plan_cache_dir:
        from tpu_radix_join_torch.planner import (ManifestMismatch,
                                                  PlanCache, load_profile)
        plan_cache = PlanCache(args.plan_cache_dir, load_profile(args.profile),
                               measurements=meas)
        try:
            plan_cache.check_manifest(nodes)
        except ManifestMismatch as e:
            print(f"[PLAN] {e}", file=sys.stderr)
            return 2
        plan_cache.write_manifest(nodes, rank=rank)
    svc = ServiceConfig(
        max_queue_depth=args.serve_queue_depth,
        tenant_quota=args.serve_tenant_quota,
        default_deadline_s=args.serve_deadline_s,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_s,
        place_cache_max=args.place_cache_max,
        result_cache_max=args.result_cache,
        result_cache_ttl_s=args.result_cache_ttl_s,
        batch_window_ms=args.batch_window_ms,
        batch_max_queries=args.batch_max,
        resident_budget_bytes=int(args.resident_budget_mb * (1 << 20)))
    ledger = None
    if _ledger_dir(args):
        from tpu_radix_join_torch.observability.ledger import Ledger
        ledger = Ledger(_ledger_dir(args))
    session = JoinSession(_join_config(args), svc, measurements=meas,
                          plan_cache=plan_cache, profile=args.profile,
                          device=args.device, group=group, ledger=ledger)
    # the coalescer is the serve loop's (no threads of its own), on the
    # session's clock (rank 0's over several ranks)
    batcher = MicroBatcher(svc.batch_window_ms, svc.batch_max_queries,
                           clock=session._clock)
    errors = 0
    fuse = svc.batch_window_ms > 0

    def emit(out):
        if rank == 0:
            print(json.dumps({"event": "outcome", **out.to_json()}),
                  flush=True)

    def flush_groups(groups):
        # submit every member of every due group, then drain: contiguous
        # co-signature queries fuse inside run_next_batch
        submitted = 0
        for grp in groups:
            for request in grp:
                try:
                    session.submit(request)
                    submitted += 1
                except AdmissionRejected as e:
                    emit(session.rejection_outcome(request, e))
        if submitted:
            session.drain(on_outcome=emit)

    lines = _serve_lines(args, batcher, flush_groups)
    batch = max(1, args.serve_batch)
    try:
        pending = 0
        for lineno, line in enumerate(lines, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            qid = None
            try:
                obj = json.loads(line)
                if not isinstance(obj, dict):
                    raise ValueError("request must be a JSON object")
                obj.setdefault("query_id", f"line{lineno}")
                qid = obj.get("query_id")
                request = QueryRequest.from_json(obj)
            except (ValueError, TypeError) as e:
                # a malformed line is the client's bug: report it and keep
                # serving
                errors += 1
                if rank == 0:
                    print(json.dumps({"event": "request_error",
                                      "line": lineno, "query_id": qid,
                                      "error": str(e)}), flush=True)
                continue
            # a result-cache hit answers before admission
            hit = session.try_cache(request)
            if hit is not None:
                emit(hit)
                continue
            if fuse and request.delta_tuples_per_node == 0:
                # park in the signature window; the key bound is the widest
                # key any generated lane of the request can carry
                key_bound = max(request.tuples_per_node * nodes,
                                request.modulo or 0)
                grp = batcher.offer(request, key_bound)
                if grp is not None:
                    flush_groups([grp])
                flush_groups(batcher.due())
                continue
            try:
                session.submit(request)
                pending += 1
            except AdmissionRejected as e:
                emit(session.rejection_outcome(request, e))
            if pending >= batch:
                session.drain(on_outcome=emit)
                pending = 0
        if fuse:
            flush_groups(batcher.flush())
        session.drain(on_outcome=emit)
        summary = session.summary()
        if rank == 0:
            print(json.dumps({"event": "summary", **summary}), flush=True)
        return 1 if (errors or summary.get("queries_failed", 0)) else 0
    finally:
        session.close()
        _ledger_flush(args, meas)


def _run_join(args, group) -> int:
    """One join of ``--nodes`` ranks (or the grid), its result line from
    rank 0; every rank returns 1 unless the result equals the oracle.  The
    registry's run row goes to the ledger at exit (``--ledger-dir``)."""
    from tpu_radix_join_torch.performance.measurements import Measurements

    rank = dist.get_rank(group) if group is not None else 0
    meas = Measurements(node_id=rank, num_nodes=args.nodes)
    try:
        return _join_body(args, group, rank, meas)
    finally:
        _ledger_flush(args, meas)


def _join_body(args, group, rank, meas) -> int:
    from tpu_radix_join_torch import HashJoin, Relation
    from tpu_radix_join_torch.performance.measurements import (RESULTS,
                                                               print_results)
    from tpu_radix_join_torch.planner.audit import (actuals_for_explain,
                                                    audit_plan,
                                                    phase_snapshot)

    nodes = args.nodes
    cfg = _join_config(args)
    plan = costs = plan_cache = None
    if args.plan is not None or args.plan_cache_dir:
        rc, plan, costs, plan_cache = _plan(args, nodes, rank, meas)
        if rc is not None:
            return rc
        if (plan is not None and plan.engine == "incore"
                and args.grid_chunk_tuples is None):
            cfg = dataclasses.replace(cfg, **plan.config_kwargs())
            if (plan.pipeline_repeats and args.repeat > 1
                    and not cfg.measure_phases):
                args.pipeline_repeats = True
    n = args.tuples_per_node * nodes
    meas.meta.update(tuples_per_node=args.tuples_per_node, global_size=n,
                     config=vars(args))
    inner = Relation(n, nodes, "unique", seed=args.seed)
    outer_kw = {}
    if args.outer_kind == "modulo":
        outer_kw["modulo"] = args.modulo or max(1, n // 4)
    elif args.outer_kind == "zipf":
        outer_kw["zipf_theta"] = args.zipf_theta
        outer_kw["key_domain"] = n
    outer = Relation(n, nodes, args.outer_kind, seed=args.seed + 1,
                     **outer_kw)
    expected = inner.expected_matches(outer)
    if args.grid_chunk_tuples is not None:
        return _run_grid(args, inner, outer, expected, meas, plan=plan)

    engine = HashJoin(cfg, device=args.device, group=group,
                      measurements=meas, plan_cache=plan_cache)
    # generation is set-up, outside the join's timers (main.cpp:94-116)
    r, s = engine.place(inner), engine.place(outer)
    key_bound = max(inner.key_bound(), outer.key_bound())
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(engine.device)
    trace_ctx = (meas.trace(os.path.join(args.output_dir, "trace"))
                 if args.trace else contextlib.nullcontext())
    times0 = phase_snapshot(meas)
    t0 = time.perf_counter()
    with trace_ctx:
        if args.pipeline_repeats and args.repeat > 1:
            result = engine.join_arrays_pipelined(r, s, args.repeat,
                                                  key_bound=key_bound)
        else:
            for _ in range(args.repeat):
                result = engine.join_arrays(r, s, key_bound=key_bound)
        if cuda:
            torch.cuda.synchronize(engine.device)
    join_s = (time.perf_counter() - t0) / args.repeat
    ok = result.ok and (expected is None or result.matches == expected)
    meas.meta["failure_class"] = result.diagnostics["failure_class"]
    # plan-vs-actual: the measured JTOTAL against the plan's prediction
    audit = audit_plan(plan, meas, repeats=args.repeat, times0=times0)
    if args.repeat > 1:
        # the report's Tuples line is one join's result; times and tuple
        # counters stay cumulative
        meas.counters[RESULTS] = result.matches
    if args.measure_phases or args.output_dir:
        meas.measure_dispatch_floor(device=engine.device)
    all_meas = meas.gather_all(engine.world)
    if rank == 0:
        if audit is not None:
            print(f"[PLAN] actual_ms={audit['actual_ms']:.1f} "
                  f"predicted_ms={audit['predicted_ms']:.1f} "
                  f"drift={audit['drift_pct']:.1f}%")
            if costs is not None:
                from tpu_radix_join_torch.planner import explain_table
                print(explain_table(costs, plan,
                                    actuals=actuals_for_explain(audit)))
        if len(all_meas) == 1:
            print(f"[RESULTS] Tuples: {result.matches}")
        if expected is not None:
            status = "OK" if result.matches == expected else "MISMATCH"
            print(f"[RESULTS] Expected: {expected} ({status})")
        print(f"[RESULTS] Conservation: {'OK' if result.ok else 'VIOLATED'}")
        if not result.ok:
            for k, v in result.diagnostics.items():
                print(f"[RESULTS] failure/{k}: {v}")
        total_us = meas.times_us.get("JTOTAL", 0.0)
        if total_us:
            rate = (2 * n * args.repeat) / (total_us / 1e6)
            print(f"[RESULTS] Throughput: {rate / 1e6:.1f} M tuples/sec")
        if len(all_meas) > 1:
            print_results(all_meas)
        else:
            for line in meas.lines():
                print(f"[PERF] {line}")
    if args.output_dir:
        # the post-join memory checkpoint (main.cpp:32,68,92)
        meas.memory_utilization()
        path = meas.store(args.output_dir)
        if rank == 0:
            print(f"[PERF] stored {path}")
    if rank == 0:
        print(json.dumps({
            "matches": result.matches, "ok": result.ok, "expected": expected,
            "join_ms": join_s * 1e3, "tuples": 2 * n,
            "tuples_per_s": 2 * n / join_s, "nodes": nodes,
            "failure_class": result.diagnostics["failure_class"],
            "retries": result.retries,
            "degraded": result.diagnostics.get("degraded"),
            "pipeline": ("sort_probe" if cfg.sort_probe and nodes == 1
                         else "shuffled_sort_probe" if cfg.sort_probe
                         else "chunked_probe" if cfg.chunk_size
                         else "partitioned"),
            "key_range": cfg.key_range,
            "device": (torch.cuda.get_device_name(engine.device) if cuda
                       else "cpu"),
            "repeat": args.repeat,
            "pipeline_repeats": args.pipeline_repeats,
            "generation": args.generation,
            "plan": plan.strategy if plan is not None else None,
            "sort_impl": cfg.sort_impl,
            "plan_vs_actual": audit,
            "phases_us": dict(meas.times_us),
            "counters": dict(meas.counters),
        }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
