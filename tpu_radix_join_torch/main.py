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
rank 0 prints.
The liveness and observability plane (``_observed``): ``--timeline-dir``
writes the rank's span file (``<rank>.spans.json``, with the profiler's
device summary under ``--trace``, which under ``--serve`` profiles the
served queries); ``--metrics-interval`` a heartbeat line a tick
(``<rank>.metrics.jsonl``); ``--elastic on`` (one rank) keeps a lease in
``--lease-dir`` (``--rank-lease-s``, ``--rank-missed-beats``), written
before any work and on every tick, withdrawn at exit; ``--forensics-dir``
collects the bundles of failed queries and runs; ``--watchdog-timeout``
cancels a stalled join; ``--statusz PORT`` serves ``/statusz`` and
``/healthz``.
``--fleet N`` with ``--serve FILE|-`` runs the crash-only fleet instead
(``_run_fleet``, service/fleet.py): N worker subprocesses, each started as
``--serve - --elastic on --lease-dir D --rank-lease-s S
--rank-missed-beats N --metrics-interval I --timeline-dir T`` with the
supervisor's shape flags and its ``--device``, behind one supervisor that
makes no CUDA call: queries routed by tenant hash, journaled under
``--fleet-dir`` (intent before dispatch, outcome before reply), a dead
worker's query replayed on a survivor (``--fleet-kill-at N`` SIGKILLs the
N-th query's worker), dead workers restarted with backoff, SIGTERM a
drain to zero unacknowledged intents; ``--statusz`` adds a ``fleet``
section and the supervisor's readiness.  The JAX command line's
``--transfer-guard`` (A18e) is refused by name.
``--elastic on`` over ``--nodes N`` (plain processes of an ``env://`` or
``file://`` rendezvous: torchrun's agent tears every worker down when one
dies) finds a lost rank at the join's phase boundaries and behind a
transport error, bounds every collective by the lapse window plus 30 s
(or ``TPU_RJ_COORD_TIMEOUT_S``) and finishes the join on the survivors from
host-regenerated relations (``[RESULTS] recovered: ...``; a survivor then
touches the group no more: no gather, no barrier, no
``destroy_process_group``); ``--rank-death-at N`` kills a rank at the
N-th boundary (really with ``TPU_RJ_RANK_DEATH_SUICIDE``, else simulated
on every rank), ``--elastic-grow`` admits a newcomer started with
``--elastic-join N`` (``--rank-join-at`` simulates one), and ``--hedge``
with ``--straggle-factor`` hedges a straggler through the manifest.
``--cpu-fallback`` builds the engine on the host CPU when building it on
the card fails (robustness/degrade.py), with a ``[DEGRADE]
failure_class=... backend=cpu nodes=... error=...`` line on stderr; a
kernel build or launch failure inside the join still raises.
``--elastic on --checkpoint-dir D`` attaches the partition manifest
``D/partitions.manifest`` (robustness/checkpoint.py), to which the join
appends one line a realized partition.  Every join and grid run with
``--timeline-dir`` prints its critical path (observability/critpath.py)
as ``[CRITPATH] ...``, stamps it into ``meta["critical_path"]`` and
prices the plan audit against it; ``--plan explain --timeline-dir``
adds the measured ``critical_path`` column from the span files there.
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
    python -m tpu_radix_join_torch.main --serve - --elastic on --lease-dir /tmp/w0/leases --rank-lease-s 1 --rank-missed-beats 2 --metrics-interval 0.25 --timeline-dir /tmp/w0 --statusz 0 --forensics-dir /tmp/w0/forensics --watchdog-timeout 30
    torchrun --standalone --nproc-per-node 4 -m tpu_radix_join_torch.main --nodes 4 --device cpu --serve requests.jsonl
    python -m tpu_radix_join_torch.main --fleet 2 --serve requests.jsonl --verify check --fleet-dir /tmp/fleet --fleet-kill-at 2 --statusz 0
    python -m tpu_radix_join_torch.main --fleet 2 --serve - --device cpu --fleet-dir /tmp/fleet
    python -m tpu_radix_join_torch.main --cpu-fallback --tuples-per-node 4194304
    python -m tpu_radix_join_torch.main --elastic on --checkpoint-dir /tmp/ckpt --timeline-dir /tmp/tl
    python -m tpu_radix_join_torch.main --plan explain --timeline-dir /tmp/tl
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import threading
import time
import traceback
from typing import Optional

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
                        "saved after every chunk pair (see --resume); with "
                        "--elastic on, of the join's partition manifest "
                        "(partitions.manifest)")
    p.add_argument("--cpu-fallback", action="store_true",
                   help="if building the engine on the card fails (no card, "
                        "the process group), build it on the host CPU "
                        "(loud [DEGRADE] line) instead of aborting; kernel "
                        "failures inside the join still raise")
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
    # --- the liveness and observability plane (observability/, ---------
    # robustness/membership.py)
    p.add_argument("--timeline-dir", default=None,
                   help="write this rank's phase spans and instant events as "
                        "Chrome trace-event JSON (<rank>.spans.json; merge "
                        "ranks with observability.merge_timeline), with the "
                        "profiler's device summary under --trace")
    p.add_argument("--metrics-interval", type=float, default=0.0,
                   metavar="SEC",
                   help="heartbeat: host memory, the card's memory and the "
                        "counter registry every SEC seconds into "
                        "<rank>.metrics.jsonl under --timeline-dir or "
                        "--output-dir (with --elastic on, each tick writes "
                        "the lease; under --serve it carries the session's "
                        "SLO, breaker and caches); 0 = off")
    p.add_argument("--statusz", type=int, default=None, metavar="PORT",
                   help="a read-only live status endpoint on 127.0.0.1:PORT "
                        "(observability/statusz.py): GET /statusz returns "
                        "the phase, counters and, under --serve, the "
                        "service, leases, cache and batch sections; "
                        "/statusz/<section> one of them; /healthz 200 or "
                        "503 with a reason; 0 = an ephemeral port (printed "
                        "on stderr)")
    p.add_argument("--watchdog-timeout", type=float, default=0.0,
                   metavar="SEC",
                   help="hang watchdog (observability/watchdog.py): when the "
                        "registry records nothing for SEC seconds while a "
                        "phase is open, dump every thread's stack and the "
                        "flight recorder into a forensics bundle and cancel "
                        "the join at its next cancel point "
                        "(backend_unavailable); 0 = off")
    p.add_argument("--forensics-dir", default=None,
                   help="where forensics bundles land "
                        "(observability/postmortem.py): a failed query, a "
                        "watchdog trip or a classified failure writes "
                        "bundle_*.json (default: $TPU_RADIX_FORENSICS_DIR, "
                        "else forensics/ under --output-dir or "
                        "--timeline-dir)")
    p.add_argument("--elastic", choices=["on", "off"], default="off",
                   help="elastic membership and recovery (robustness/"
                        "membership.py, recovery.py): heartbeat an epoch-"
                        "stamped lease a rank (lease_r<rank>.json) under "
                        "--lease-dir, the first before any work, then every "
                        "--metrics-interval tick (or every half lease "
                        "without one, over several ranks), withdrawn at "
                        "exit; detect a lost peer at phase boundaries and "
                        "from transport errors, fence the membership epoch "
                        "and finish the join on the survivors by "
                        "recomputing the lost partitions from host-"
                        "regenerated relations.  With --checkpoint-dir the "
                        "join records its realized partitions in "
                        "partitions.manifest there and a recovery resumes "
                        "from it.  Over several ranks the group's timeout "
                        "is the lapse window plus 30 s, unless "
                        "TPU_RJ_COORD_TIMEOUT_S sets it, and the ranks must "
                        "be plain processes (env:// or file:// "
                        "rendezvous): torchrun's agent "
                        "tears every worker down when one dies")
    p.add_argument("--lease-dir", default=None,
                   help="directory of the lease files (default: "
                        "$TPU_RADIX_LEASE_DIR, else leases/ under "
                        "--output-dir or --timeline-dir, else a private "
                        "temporary directory)")
    p.add_argument("--rank-lease-s", type=float, default=5.0, metavar="SEC",
                   help="the lease window in seconds (default 5.0)")
    p.add_argument("--rank-missed-beats", type=int, default=2, metavar="N",
                   help="a lease lapses after N windows of silence (lapse "
                        "window = N x --rank-lease-s; default 2)")
    p.add_argument("--rank-death-at", type=int, default=None, metavar="N",
                   help="arm the membership.rank_death chaos site at the "
                        "N-th phase boundary (1-based): with "
                        "TPU_RJ_RANK_DEATH_SUICIDE set this process dies "
                        "for real (SIGKILL; =stop freezes it with SIGSTOP); "
                        "otherwise the highest rank's death is simulated "
                        "on every rank and --elastic on recovers it")
    p.add_argument("--elastic-grow", action="store_true",
                   help="admit joining ranks mid-run: a newcomer's joining "
                        "lease is admitted at the next phase boundary with "
                        "a fenced epoch bump, and the join finishes on the "
                        "grown membership; needs --elastic on")
    p.add_argument("--elastic-join", type=int, default=None, metavar="N",
                   help="run as a newcomer to an N-rank incumbent world, "
                        "outside its process group: write a joining lease "
                        "under the shared --lease-dir, wait for admission "
                        "(an incumbent's epoch bump), recompute this rank's "
                        "share of the unfinished partitions into the shared "
                        "--checkpoint-dir manifest, and exit once it is "
                        "complete; needs --elastic on")
    p.add_argument("--hedge", choices=["on", "off", "auto"], default="off",
                   help="straggler hedging (robustness/straggler.py): when "
                        "a live rank's manifest progress falls below "
                        "--hedge-threshold x the median for two checks, "
                        "recompute its unfinished partitions beside it; the "
                        "manifest's first-writer-wins fence keeps the "
                        "speculation from counting twice; auto backs off "
                        "while SPECWASTE > HEDGEWIN; needs --elastic on")
    p.add_argument("--hedge-threshold", type=float, default=0.5,
                   metavar="F",
                   help="the straggler threshold: hedge when the slowest "
                        "rank's progress < F x the median (default 0.5, in "
                        "(0, 1))")
    p.add_argument("--straggle-factor", type=float, default=0.0,
                   metavar="F",
                   help="arm the compute.straggle chaos site: the highest "
                        "rank slows by F x TPU_RJ_STRAGGLE_UNIT_S seconds "
                        "(0.05) after the sizing pass (0 = off)")
    p.add_argument("--rank-join-at", type=int, default=None, metavar="N",
                   help="arm the membership.rank_join chaos site at the "
                        "N-th phase boundary: a joining lease appears past "
                        "the boot world and --elastic-grow admits it")
    # --- the crash-only fleet (service/fleet.py) ---------------------------
    p.add_argument("--fleet", type=int, default=None, metavar="N",
                   help="crash-only fleet serving (service/fleet.py): "
                        "supervise N --serve worker subprocesses, route "
                        "queries by consistent hash on tenant, health-check "
                        "workers by lease heartbeat (two missed beats = "
                        "lapse, the rank-lapse rule), restart dead workers "
                        "with exponential backoff + a crash-loop breaker, "
                        "and guarantee exactly-once outcomes through the "
                        "durable query journal (intent before dispatch, "
                        "outcome before reply, replay on death); SIGTERM "
                        "drains gracefully.  Requires --serve FILE|-; "
                        "--statusz gains a fleet section and a readiness-"
                        "aware /healthz.  The supervisor touches no device; "
                        "every worker runs on its --device")
    p.add_argument("--fleet-dir", default=None,
                   help="fleet work dir: the query journal plus per-worker "
                        "lease/timeline artifacts live here (default: "
                        "fleet/ under --output-dir or --timeline-dir, else "
                        "a private tempdir — restart the supervisor over "
                        "the SAME dir to replay unacknowledged intents)")
    p.add_argument("--fleet-kill-at", type=int, default=None, metavar="N",
                   help="arm the fleet.worker_kill chaos site at the N-th "
                        "dispatched query (1-based): the routed worker is "
                        "SIGKILLed right after the request hits its pipe, "
                        "and the supervisor must journal-replay it on a "
                        "healthy worker (seeded from --seed)")
    # the JAX command line's flags the port refuses, each naming its item
    for flag, item in REFUSED_FLAGS.items():
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=f"not ported (ROADMAP {item})")
    return p


#: the JAX command line's flags the port refuses by name, with their items
REFUSED_FLAGS = {
    "--transfer-guard": "A18e: the sync guard",
}


def _forensics_dir(args):
    """Where forensics bundles land (``_forensics_dir``,
    tpu_radix_join/main.py:413-427): the flag, then
    $TPU_RADIX_FORENSICS_DIR, then ``forensics/`` under the artifact
    directory the run already writes; None (no bundles) without one."""
    return (args.forensics_dir
            or os.environ.get("TPU_RADIX_FORENSICS_DIR")
            or (os.path.join(args.output_dir, "forensics")
                if args.output_dir else None)
            or (os.path.join(args.timeline_dir, "forensics")
                if args.timeline_dir else None))


def _lease_dir(args):
    """Where the lease files live (``_lease_dir``, tpu_radix_join/main.py:
    429-443): the flag, then $TPU_RADIX_LEASE_DIR, then ``leases/`` under
    the artifact directory, else a private temporary directory (one rank
    needs no shared one)."""
    import tempfile
    return (args.lease_dir
            or os.environ.get("TPU_RADIX_LEASE_DIR")
            or (os.path.join(args.output_dir, "leases")
                if args.output_dir else None)
            or (os.path.join(args.timeline_dir, "leases")
                if args.timeline_dir else None)
            or tempfile.mkdtemp(prefix="tpu_rj_leases_"))


def _trace_identity(args, rank: int) -> str:
    """One trace id for every rank of a run (``_trace_identity``,
    tpu_radix_join/main.py:446-495): rank 0 mints it and writes it to
    ``trace_id`` in the lease directory; the others read the file (one
    written within the last 120 s, so an earlier run's is never taken),
    polling for 10 s, then mint their own with a warning: correlation
    degrades, the run does not."""
    import tempfile

    from tpu_radix_join_torch.observability.spans import new_trace_id

    lease_dir = _lease_dir(args)
    path = os.path.join(lease_dir, "trace_id")
    if rank == 0:
        tid = new_trace_id()
        os.makedirs(lease_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=lease_dir, prefix=".trace_id.")
        with os.fdopen(fd, "w") as f:
            f.write(tid)
        os.replace(tmp, path)
        return tid
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        try:
            if time.time() - os.stat(path).st_mtime <= 120.0:
                with open(path) as f:
                    tid = f.read().strip()
                if tid:
                    return tid
        except OSError:
            pass
        time.sleep(0.05)
    tid = new_trace_id()
    print(f"[OBS] rank {rank}: no shared trace_id under {lease_dir} after "
          f"10s; minted {tid} locally: cross-rank correlation degraded",
          file=sys.stderr)
    return tid


def _emit_failure_bundle(meas, exc, args):
    """A forensics bundle of a terminal classified failure
    (``_emit_failure_bundle``, tpu_radix_join/main.py:520-550): a watchdog
    trip's exception carries the bundle it wrote; anything else gets one
    here.  A write error is a line on stderr, never a new failure."""
    path = getattr(exc, "bundle", None)
    if path:
        return path
    out_dir = _forensics_dir(args)
    if not out_dir:
        print("[FORENSICS] no bundle dir (--forensics-dir / --output-dir / "
              "--timeline-dir all unset); skipping bundle", file=sys.stderr)
        return None
    try:
        from tpu_radix_join_torch.observability.postmortem import write_bundle
        extra = {"error": repr(exc)}
        extra.update(getattr(exc, "bundle_extra", None) or {})
        return write_bundle(
            out_dir, meas, reason="failure",
            failure_class=getattr(exc, "failure_class", None),
            config=vars(args), extra=extra)
    except Exception as e:   # noqa: BLE001 — forensics must not mask
        print(f"[FORENSICS] bundle write failed: {e!r}", file=sys.stderr)
        return None


def _statusz(args, sections, readiness=None):
    """The ``--statusz`` server, started (None without the flag)."""
    if args.statusz is None:
        return None
    from tpu_radix_join_torch.observability.statusz import StatuszServer
    server = StatuszServer(port=args.statusz, sections=sections,
                           readiness=readiness)
    server.start()
    print(f"[STATUSZ] serving http://127.0.0.1:{server.port}/statusz",
          file=sys.stderr)
    return server


class _LeaseBeat:
    """A daemon thread heartbeating a membership view's lease every
    ``period_s`` seconds: over several ranks without a metrics sampler,
    a rank blocked in a long collective or a recompute must not lapse in
    its peers' eyes."""

    def __init__(self, membership, period_s: float):
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(membership, period_s), daemon=True,
            name="lease-beat")
        self._thread.start()

    def _run(self, membership, period_s: float) -> None:
        while not self._stop.wait(period_s):
            membership.board.heartbeat(membership.epoch,
                                       status=membership.my_status())

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


@contextlib.contextmanager
def _observed(args, meas, rank: Optional[int]):
    """The liveness and observability plane around a run (``main``,
    tpu_radix_join/main.py:1365-1460): the compile monitor; with
    ``--timeline-dir`` a span tracer (one trace id over the ranks, through
    the lease directory); with ``--metrics-interval`` the heartbeat
    sampler on the run's card; with ``--elastic on`` a one-rank lease
    board and membership view, the first lease written before any work and
    one every sampler tick.  Yields ``(sampler, membership)``; on the way
    out, whatever happened, the sampler is stopped, the lease withdrawn,
    the ledger row appended and the span file saved (with the profiler's
    device summary after ``--trace``)."""
    from tpu_radix_join_torch.observability.compilemon import (
        install_compile_monitor, uninstall_compile_monitor)

    install_compile_monitor(meas)
    tracer = sampler = membership = board = beat = None
    try:
        if args.timeline_dir:
            os.makedirs(args.timeline_dir, exist_ok=True)
            trace_id = (_trace_identity(args, rank)
                        if args.nodes > 1 and rank is not None else None)
            tracer = meas.attach_tracer(trace_id=trace_id, nodes=args.nodes)
        if args.metrics_interval:
            from tpu_radix_join_torch.observability.metrics import (
                MetricsSampler)
            mdir = args.timeline_dir or args.output_dir
            sampler = MetricsSampler(
                os.path.join(mdir, f"{meas.node_id}.metrics.jsonl"),
                args.metrics_interval, measurements=meas,
                device=_card(args))
        if args.elastic == "on":
            from tpu_radix_join_torch.robustness.membership import (
                LeaseBoard, MembershipView)
            joining = rank is None
            if joining:
                # a newcomer's rank: the first free id at or above the
                # incumbent world's size, from the shared lease directory
                rank = LeaseBoard.next_rank(_lease_dir(args),
                                            floor=args.elastic_join)
            board = LeaseBoard(_lease_dir(args), rank=rank,
                               num_ranks=args.nodes,
                               lease_s=args.rank_lease_s,
                               missed_beats=args.rank_missed_beats,
                               measurements=meas)
            membership = MembershipView(board, measurements=meas)
            # the first lease before any work (a newcomer's asks to join)
            board.heartbeat(0, status="joining" if joining else "member")
            if sampler is not None:
                sampler.extra = board.sampler_extra(
                    epoch_of=membership.epoch_of,
                    status_of=membership.my_status)
            elif args.nodes > 1:
                beat = _LeaseBeat(membership, args.rank_lease_s / 2)
        if sampler is not None:
            sampler.start()
        yield sampler, membership
    finally:
        # the sampler's last tick writes the lease: stop it first
        if sampler is not None:
            sampler.stop()
        if beat is not None:
            beat.stop()
        if board is not None:
            # a clean exit withdraws the lease: a reader sees a departure,
            # not a stale lease
            board.withdraw(board.rank)
        uninstall_compile_monitor(meas)
        _ledger_flush(args, meas)
        if tracer is not None:
            path = tracer.save(args.timeline_dir,
                               device_summary=meas.meta.get("trace"))
            print(f"[OBS] timeline spans stored {path}", file=sys.stderr)


def _card(args):
    """The run's device for the heartbeat's memory block: this rank's card
    (None on the CPU)."""
    if torch.device(args.device).type != "cuda" or not \
            torch.cuda.is_available():
        return None
    return torch.device("cuda", torch.cuda.current_device())


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
    cp = _critical_path(meas, 0)
    audit = audit_plan(plan, meas, times0=times0, critical_path=cp)
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
                    print(explain_table(costs, plan,
                                        critpath=_explain_critpath(args,
                                                                   plan)))
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
        # the decision tags every later span of the timeline
        meas.set_trace_tags(strategy=plan.strategy, engine=plan.engine)
        if plan.engine == "chunked" and nodes == 1:
            if args.grid_chunk_tuples is None:
                args.grid_chunk_tuples = plan.chunk_tuples or (1 << 20)
        elif plan.engine == "chunked" and rank == 0:
            print("[PLAN] the chunked engine runs on one rank; keeping the "
                  "in-core engine at this world size", file=sys.stderr)
    return None, plan, costs, plan_cache


def _explain_critpath(args, plan):
    """``--plan explain --timeline-dir``'s ``critical_path`` column (JAX
    ``main.py:1565-1588``): the measured path of the span files an earlier
    run left there, its on-path JCOMPILE taken off, on the chosen
    strategy's row; None without the flag or a usable path."""
    if not args.timeline_dir:
        return None
    from tpu_radix_join_torch.observability.critpath import (
        critical_path_for_dir)
    cp = critical_path_for_dir(args.timeline_dir)
    if cp.get("error"):
        return None
    jc = float((cp.get("phase_ms") or {}).get("JCOMPILE", 0.0))
    return {"strategy": plan.strategy,
            "bound_ms": max(0.0, cp.get("path_ms", 0.0) - jc),
            "bound_rank": cp.get("bounding_rank"),
            "wait_fraction": cp.get("wait_fraction")}


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
    for flag, item in REFUSED_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            parser.error(f"{flag} is not ported to PyTorch yet (ROADMAP.md "
                         f"queue A, {item})")
    if args.elastic_grow and args.elastic != "on":
        parser.error("--elastic-grow admits ranks into the elastic "
                     "recovery protocol — it needs --elastic on")
    if args.hedge != "off" and args.elastic != "on":
        parser.error("--hedge speculates through the elastic recovery "
                     "machinery — it needs --elastic on")
    if not 0.0 < args.hedge_threshold < 1.0:
        parser.error("--hedge-threshold must be in (0, 1): it is the "
                     "slowest/median progress ratio below which hedging "
                     "arms")
    if args.rank_missed_beats < 1:
        parser.error("--rank-missed-beats must be >= 1")
    if args.rank_lease_s <= 0:
        parser.error("--rank-lease-s must be > 0")
    if args.metrics_interval < 0 or args.watchdog_timeout < 0:
        parser.error("--metrics-interval and --watchdog-timeout must be >= 0")
    if args.metrics_interval and not (args.timeline_dir or args.output_dir):
        parser.error("--metrics-interval writes <rank>.metrics.jsonl under "
                     "--timeline-dir or --output-dir: pass one")
    if args.serve is not None and args.grid_chunk_tuples is not None:
        parser.error("--serve runs the in-core resident engine; the "
                     "out-of-core grid is a one-shot mode")
    if args.fleet is not None:
        if args.fleet < 1:
            parser.error("--fleet needs at least one worker")
        if args.serve is None:
            parser.error("--fleet supervises --serve workers — pass "
                         "--serve FILE (or '-' for stdin)")
        if args.nodes > 1:
            parser.error("--fleet workers are one-rank serve processes; a "
                         "worker of --nodes > 1 runs under torchrun")
        if args.elastic_join is not None:
            parser.error("--fleet is a serving supervisor, not a mesh "
                         "rank; it cannot run as --elastic-join")
    if args.elastic_join is not None:
        if args.elastic != "on":
            parser.error("--elastic-join is the growth half of elastic "
                         "recovery — it needs --elastic on")
        if not args.checkpoint_dir:
            parser.error("--elastic-join recomputes through the shared "
                         "partition manifest — pass the incumbents' "
                         "--checkpoint-dir")
        if args.elastic_join < 1 or args.nodes not in (1, args.elastic_join):
            parser.error("--elastic-join N names the incumbent world of N "
                         "ranks (one node a rank): --nodes, when given, "
                         "must be N")
        if args.serve is not None:
            parser.error("--elastic-join joins a one-shot join, not a "
                         "serving process")
        args.nodes = args.elastic_join
    if args.serve == "-" and args.nodes > 1:
        parser.error("--serve - reads stdin, which only one rank has: give "
                     "every rank the same request FILE")
    if args.profile == "auto":
        from tpu_radix_join_torch.planner import resolve_profile
        args.profile = resolve_profile("auto", ledger_dir=_ledger_dir(args))
        print(f"[PROFILE] auto -> {args.profile}", file=sys.stderr)
    if args.fleet is not None:
        # the supervisor never touches a device: the workers own the
        # card, so dispatch before anything below can reach torch.cuda
        return _run_fleet(args)
    from tpu_radix_join_torch.parallel import multihost
    from tpu_radix_join_torch.performance.measurements import Measurements

    if args.elastic_join is not None:
        # a newcomer stays outside the incumbents' process group
        meas = Measurements(node_id=args.elastic_join, num_nodes=args.nodes)
        with _observed(args, meas, None) as (_, membership):
            return _run_joiner(args, meas, membership)
    group = None
    if args.nodes > 1:
        lapse = (args.rank_lease_s * args.rank_missed_beats
                 if args.elastic == "on" else None)
        if not multihost.initialize(device=args.device,
                                    elastic_lapse_s=lapse):
            parser.error(f"--nodes {args.nodes} runs under torchrun "
                         f"(torchrun --nproc-per-node {args.nodes} -m "
                         "tpu_radix_join_torch.main ...), or as plain "
                         "processes with MASTER_ADDR, MASTER_PORT, RANK and "
                         "WORLD_SIZE set (the launch --elastic on needs)")
        group = dist.group.WORLD
    rc, views = 1, []
    try:
        rank = dist.get_rank(group) if group is not None else 0
        meas = Measurements(node_id=rank, num_nodes=args.nodes)
        with _observed(args, meas, rank) as (sampler, membership):
            views.append(membership)
            if args.serve is not None:
                rc = _run_serve(args, group, meas, sampler, membership)
            else:
                rc = _join_body(args, group, rank, meas, membership)
        return rc
    finally:
        if group is not None and views and views[0] is not None \
                and views[0].lost:
            # a survivor of a rank loss leaves the group without a word:
            # destroying it may wait on the dead peer, so flush and exit
            # with the join's code (and the traceback of one in flight)
            if sys.exc_info()[0] is not None:
                traceback.print_exc()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(rc)
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


def _run_serve(args, group, meas, sampler=None, membership=None) -> int:
    """Resident service mode (``_run_serve``, tpu_radix_join/main.py:
    643-905): every request flows through one :class:`JoinSession`.  One
    outcome JSON line a query, then a summary line with the SLO snapshot;
    over several ranks every rank serves the same stream and rank 0
    prints.  The plane: failed queries' bundles (``--forensics-dir``),
    the heartbeat's tick carrying the session's state and writing the
    lease, the worker's incarnation in the ring's context, the watchdog
    (``--watchdog-timeout``), ``--statusz``, and ``--trace`` profiling the
    served queries.  Returns 1 when a request line was malformed or a
    query failed (admission rejections are backpressure, not failures), 2
    on a plan-cache manifest of another topology or profile."""
    from tpu_radix_join_torch.core.config import ServiceConfig
    from tpu_radix_join_torch.service import (AdmissionRejected, JoinSession,
                                              MicroBatcher, QueryRequest)
    from tpu_radix_join_torch.service.breaker import OPEN

    nodes = args.nodes
    rank = meas.node_id
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
                          device=args.device, group=group, ledger=ledger,
                          forensics_dir=_forensics_dir(args),
                          membership=membership,
                          elastic=args.elastic == "on",
                          elastic_grow=args.elastic_grow,
                          hedge=args.hedge,
                          hedge_threshold=args.hedge_threshold)
    # the coalescer is the serve loop's (no threads of its own), on the
    # session's clock (rank 0's over several ranks)
    batcher = MicroBatcher(svc.batch_window_ms, svc.batch_max_queries,
                           clock=session._clock)
    # a fleet worker's incarnation id (w<slot>i<n>) groups its bundles
    incarnation = os.environ.get("TPU_RJ_WORKER_INCARNATION")
    if incarnation:
        meas.flightrec.set_context(worker_incarnation=incarnation)
    if sampler is not None:
        # the tick carries the session's state and writes the lease
        sampler.extra = session.heartbeat_tick
    if args.watchdog_timeout > 0:
        session.attach_watchdog(args.watchdog_timeout)
    statusz = None
    if args.statusz is not None:
        from tpu_radix_join_torch.observability.statusz import (
            measurements_sections)
        # JAX's serve sections (tpu_radix_join/main.py:722-780)
        from tpu_radix_join_torch.performance.measurements import (
            HEDGED, HEDGEWIN, SPECWASTE)
        sections = dict(measurements_sections(meas))
        sections["service"] = session._heartbeat_extra
        sections["hedge"] = (lambda: {
            "mode": session.hedge,
            "threshold": session.hedge_threshold,
            "elastic_grow": session.elastic_grow,
            "hedged": int(meas.counters.get(HEDGED, 0)),
            "wins": int(meas.counters.get(HEDGEWIN, 0)),
            "wasted": int(meas.counters.get(SPECWASTE, 0))})
        sections["critical_paths"] = (
            lambda: list(session.recent_critical_paths))
        if membership is not None:
            sections["leases"] = membership.board.sampler_extra(
                epoch_of=membership.epoch_of)
        if svc.result_cache_max or svc.resident_budget_bytes:
            sections["cache"] = (lambda: {
                "result_cache": session.result_cache.stats(),
                "resident": session.resident.stats(),
                "placed_bytes": session.placed_bytes()})
        if svc.batch_window_ms > 0:
            sections["batch"] = (lambda: {
                **batcher.stats(),
                "session_fused_batches": session.batches_fused,
                "session_fused_queries": session.batch_queries_fused})

        def readiness():
            # do not route here: a closed session, an open breaker, or an
            # own lease older than the lapse window
            if session._closed:
                return {"ok": False, "reason": "session_closed"}
            if session.breaker.state == OPEN:
                return {"ok": False, "reason": "breaker_open"}
            if membership is not None:
                lease = membership.board.read(membership.board.rank)
                if lease is not None:
                    age = time.time() - lease.t_epoch_s
                    if age > membership.board.lapse_window_s:
                        return {"ok": False,
                                "reason": f"heartbeat_stale_{age:.1f}s"}
            return {"ok": True}

        statusz = _statusz(args, sections, readiness)
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
    trace_ctx = (meas.trace(os.path.join(args.output_dir, "trace"))
                 if args.trace else contextlib.nullcontext())
    try:
        with trace_ctx:
            return _serve_loop(args, session, batcher, lines, emit,
                               flush_groups, rank, nodes, batch, fuse)
    finally:
        if statusz is not None:
            statusz.stop()
        session.close()


def _serve_loop(args, session, batcher, lines, emit, flush_groups, rank,
                nodes, batch, fuse) -> int:
    """The request loop of :func:`_run_serve`."""
    from tpu_radix_join_torch.service import AdmissionRejected, QueryRequest

    errors = 0
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


def _fleet_worker_args(args) -> list:
    """The worker command line's shape flags (``_run_fleet``,
    tpu_radix_join/main.py:941-968), with the supervisor's ``--device``:
    requests carry the per-query knobs (tuples_per_node, seed,
    deadline_s, ...), and a worker runs on the device the supervisor was
    given, never on the CPU on its own."""
    worker_args = ["--nodes", str(args.nodes), "--device", args.device]
    if args.verify != "off":
        worker_args += ["--verify", args.verify]
    worker_args += ["--profile", args.profile,
                    "--max-retries", str(args.max_retries),
                    "--fallback", args.fallback,
                    "--breaker-threshold", str(args.breaker_threshold),
                    "--breaker-cooldown-s", str(args.breaker_cooldown_s),
                    "--serve-queue-depth", str(args.serve_queue_depth),
                    "--serve-tenant-quota", str(args.serve_tenant_quota),
                    "--place-cache-max", str(args.place_cache_max)]
    if args.serve_deadline_s is not None:
        worker_args += ["--serve-deadline-s", str(args.serve_deadline_s)]
    if args.result_cache:
        worker_args += ["--result-cache", str(args.result_cache)]
        if args.result_cache_ttl_s is not None:
            worker_args += ["--result-cache-ttl-s",
                            str(args.result_cache_ttl_s)]
    if args.batch_window_ms > 0:
        # the workers share the batch window: dispatch_batch writes a
        # group's request lines back to back, and the worker's own
        # coalescer fuses them into one device program
        worker_args += ["--batch-window-ms", str(args.batch_window_ms),
                        "--batch-max", str(args.batch_max)]
    if args.resident_budget_mb:
        worker_args += ["--resident-budget-mb", str(args.resident_budget_mb)]
    return worker_args


def _run_fleet(args) -> int:
    """Crash-only fleet supervision (``--fleet N``, ``_run_fleet``,
    tpu_radix_join/main.py:908-1124): N ``--serve -`` worker subprocesses
    behind the journal's exactly-once discipline.

    The supervisor reads the same JSONL request stream serve mode does,
    but each query is intent-journaled, routed by tenant hash to a live
    worker, and outcome-journaled before the client sees the reply; a
    worker SIGKILLed mid-query fails over (replay on a healthy worker),
    and a SIGTERM to the supervisor drains gracefully — admission stops,
    in-flight queries finish, workers exit cleanly (withdrawing their own
    leases), and the journal ends with zero unacknowledged intents.  The
    supervisor makes no CUDA call.  Exit 0 = every accepted query got
    exactly one outcome; 1 on a malformed line, an unacknowledged intent
    or a double execution at drain."""
    import queue
    import signal
    import tempfile
    import threading

    from tpu_radix_join_torch.performance.measurements import Measurements
    from tpu_radix_join_torch.robustness import faults
    from tpu_radix_join_torch.service.fleet import FleetSupervisor

    work_dir = (args.fleet_dir
                or (os.path.join(args.output_dir, "fleet")
                    if args.output_dir else None)
                or (os.path.join(args.timeline_dir, "fleet")
                    if args.timeline_dir else None)
                or tempfile.mkdtemp(prefix="tpu_rj_fleet_"))
    meas = Measurements()
    sup = FleetSupervisor(args.fleet, _fleet_worker_args(args), work_dir,
                          measurements=meas,
                          lease_s=args.rank_lease_s,
                          missed_beats=args.rank_missed_beats,
                          result_cache_max=args.result_cache,
                          result_cache_ttl_s=args.result_cache_ttl_s,
                          batch_window_ms=args.batch_window_ms)
    statusz = None
    if args.statusz is not None:
        from tpu_radix_join_torch.observability.statusz import (
            measurements_sections)
        sections = dict(measurements_sections(meas))
        sections["fleet"] = sup.statusz_section
        statusz = _statusz(args, sections, sup.readiness)

    # SIGTERM = graceful drain: the handler only sets a flag; the
    # in-flight dispatch (the supervisor is single-threaded) finishes its
    # query, then the loop sees the flag and drains
    stop = threading.Event()
    prev_term = signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())

    # requests arrive through a reader thread and a queue so the loop can
    # poll the stop flag: a blocking readline would ride out SIGTERM (PEP
    # 475 retries it) and strand the drain until the next line
    lineq: "queue.Queue" = queue.Queue()

    def read_lines(src):
        try:
            for line in src:
                lineq.put(line)
        finally:
            lineq.put(None)

    src = sys.stdin if args.serve == "-" else open(args.serve)
    reader = threading.Thread(target=read_lines, args=(src,),
                              name="fleet-stdin", daemon=True)

    def emit(out):
        print(json.dumps({"event": "outcome", **out}, default=str),
              flush=True)

    errors = 0
    try:
        with contextlib.ExitStack() as stack:
            if args.fleet_kill_at is not None:
                inj = faults.FaultInjector(seed=args.seed, measurements=meas)
                inj.arm(faults.FLEET_WORKER_KILL, at=args.fleet_kill_at)
                stack.enter_context(inj)
            sup.start()
            # a previous incarnation's accepted-but-unanswered queries
            # replay before any new admission, each outcome emitted
            replayed = sup.replay_unacknowledged(emit)
            if replayed:
                print(f"[FLEET] replayed {len(replayed)} unacknowledged "
                      f"intent(s) from {sup.journal.path}", file=sys.stderr)
            reader.start()
            errors = _fleet_loop(args, sup, lineq, stop, emit)
        report = sup.drain()
        summary = {**sup.summary(), "drain": report}
        print(json.dumps({"event": "summary", **summary}, default=str),
              flush=True)
        if report["unacked"] or report["double_exec"]:
            # a stranded or doubled query is the one failure this mode
            # exists to rule out
            print(f"[FLEET] exactly-once violated at drain: "
                  f"unacked={report['unacked']} "
                  f"double_exec={report['double_exec']}", file=sys.stderr)
            return 1
        return 1 if errors else 0
    finally:
        sup.close()
        if statusz is not None:
            statusz.stop()
        if src is not sys.stdin:
            src.close()
        signal.signal(signal.SIGTERM, prev_term)
        _ledger_flush(args, meas)


def _fleet_loop(args, sup, lineq, stop, emit) -> int:
    """The request loop of :func:`_run_fleet` until EOF or SIGTERM; returns
    the count of malformed lines.  Under ``--batch-window-ms``
    co-signature requests arriving within the window dispatch together
    (``dispatch_batch``: one signature-routed worker, back-to-back lines
    its coalescer fuses); EOF or SIGTERM flushes every parked group."""
    import queue

    window_s = args.batch_window_ms / 1000.0
    parked: dict = {}          # sig -> (opened_monotonic, [request])

    def flush_sig(sig):
        _, group = parked.pop(sig)
        for out in sup.dispatch_batch(group):
            emit(out)

    def flush_due():
        now = time.monotonic()
        for sig in sorted(parked, key=lambda s: parked[s][0]):
            if now - parked[sig][0] >= window_s:
                flush_sig(sig)

    poll_s = min(0.2, window_s) if window_s > 0 else 0.2
    errors = 0
    lineno = 0
    while not stop.is_set():
        try:
            line = lineq.get(timeout=poll_s if parked else 0.2)
        except queue.Empty:
            flush_due()
            continue
        if line is None:
            break
        lineno += 1
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            obj = json.loads(line)
            if not isinstance(obj, dict):
                raise ValueError("request must be a JSON object")
            obj.setdefault("query_id", f"line{lineno}")
        except (ValueError, TypeError) as e:
            errors += 1
            print(json.dumps({"event": "request_error", "line": lineno,
                              "error": str(e)}), flush=True)
            continue
        sig = sup._batch_signature(obj)
        if sig is None or obj.get("delta_tuples_per_node"):
            emit(sup.dispatch(obj))
        else:
            opened, group = parked.get(sig, (time.monotonic(), []))
            group.append(obj)
            parked[sig] = (opened, group)
            if len(group) >= args.batch_max:
                flush_sig(sig)
        flush_due()
    # EOF or SIGTERM: no parked query is lost to the drain
    for sig in list(parked):
        flush_sig(sig)
    return errors


def _engine(args, cfg, group, meas, plan_cache):
    """The join's engine on ``--device``; with ``--cpu-fallback`` a failed
    construction builds it on the host CPU instead (robustness/
    degrade.py) and prints the ``[DEGRADE]`` line (JAX ``main.py:
    1633-1645``)."""
    from tpu_radix_join_torch import HashJoin

    if not args.cpu_fallback:
        return HashJoin(cfg, device=args.device, group=group,
                        measurements=meas, plan_cache=plan_cache)
    from tpu_radix_join_torch.robustness.degrade import (
        engine_with_cpu_fallback)
    engine, dinfo = engine_with_cpu_fallback(
        cfg, device=args.device, group=group, measurements=meas,
        plan_cache=plan_cache)
    if dinfo["degraded"]:
        # structured, parseable: key=value pairs after the marker
        print(f"[DEGRADE] failure_class={dinfo['failure_class']} "
              f"backend=cpu nodes={dinfo['num_nodes']} "
              f"error={dinfo['error']}", file=sys.stderr)
    return engine


def _attach_manifest(args, engine, cfg, nodes, meas, membership) -> None:
    """The membership view, the elastic flags (``--elastic``,
    ``--elastic-grow``, ``--hedge``, ``--hedge-threshold``,
    ``--straggle-factor``) and, with ``--elastic on --checkpoint-dir D``,
    the partition manifest ``D/partitions.manifest`` under the JAX
    command line's fingerprint (JAX ``main.py:1651-1660``): the join
    appends one line a realized partition; a manifest of another
    fingerprint raises CheckpointMismatch."""
    engine.membership = membership
    engine.elastic = args.elastic == "on"
    engine.elastic_grow = args.elastic_grow
    engine.hedge = args.hedge
    engine.hedge_threshold = args.hedge_threshold
    engine.straggle_factor = args.straggle_factor
    if args.elastic != "on" or not args.checkpoint_dir:
        return
    engine.partition_manifest = _manifest(args, nodes,
                                          cfg.network_partition_count, meas)


def _manifest(args, nodes: int, num_p: int, meas):
    """``--checkpoint-dir``'s ``partitions.manifest`` under the JAX command
    line's fingerprint ``elastic:<outer>:<N>:<seed>:<P>``."""
    from tpu_radix_join_torch.robustness.checkpoint import PartitionManifest
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    return PartitionManifest(
        os.path.join(args.checkpoint_dir, "partitions.manifest"),
        fingerprint=(f"elastic:{args.outer_kind}:"
                     f"{args.tuples_per_node * nodes}:{args.seed}:{num_p}"),
        measurements=meas)


def _relations(args, nodes: int):
    """The command line's (inner, outer) relations over ``nodes``: unique
    of ``--seed``, and ``--outer-kind`` of ``--seed + 1``."""
    from tpu_radix_join_torch import Relation
    n = args.tuples_per_node * nodes
    outer_kw = {}
    if args.outer_kind == "modulo":
        outer_kw["modulo"] = args.modulo or max(1, n // 4)
    elif args.outer_kind == "zipf":
        outer_kw["zipf_theta"] = args.zipf_theta
        outer_kw["key_domain"] = n
    return (Relation(n, nodes, "unique", seed=args.seed),
            Relation(n, nodes, args.outer_kind, seed=args.seed + 1,
                     **outer_kw))


def _critical_path(meas, rank: int):
    """The run's critical path over this rank's live span stream
    (observability/critpath.py) when a tracer is attached
    (``--timeline-dir``): stamped into ``meta["critical_path"]`` and
    printed as ``[CRITPATH]`` by rank 0 (JAX ``main.py:1772-1798``);
    None without a tracer."""
    if meas.tracer is None:
        return None
    from tpu_radix_join_torch.observability.critpath import (
        critical_path_from_tracer, format_summary)
    cp = critical_path_from_tracer(meas.tracer)
    meas.meta["critical_path"] = cp
    if rank == 0:
        print(f"[CRITPATH] {format_summary(cp)}")
    return cp


def _membership_faults(args, meas):
    """One injector of ``--seed`` arming ``--rank-death-at``,
    ``--rank-join-at`` and ``--straggle-factor``'s sites (only the
    innermost injector is consulted, so they share one), or a null
    context."""
    if not (args.rank_death_at or args.rank_join_at
            or args.straggle_factor > 0):
        return contextlib.nullcontext()
    from tpu_radix_join_torch.robustness import faults
    inj = faults.FaultInjector(seed=args.seed, measurements=meas)
    if args.rank_death_at:
        inj.arm(faults.RANK_DEATH, at=args.rank_death_at)
    if args.rank_join_at:
        inj.arm(faults.RANK_JOIN, at=args.rank_join_at)
    if args.straggle_factor > 0:
        inj.arm(faults.COMPUTE_STRAGGLE, at=1)
    return inj


def _print_recovery(d: dict, times, reporter: bool) -> None:
    """The recovered join's lines (JAX ``main.py:1817-1831``) from the
    reporter, and on every rank's stderr ``[ELASTIC] {...}``: the
    recovery's kind, wall times, matches and the kernel launches it made
    (``HashJoin.last_recovery``)."""
    if reporter:
        print(f"[RESULTS] recovered: epoch={d.get('membership_epoch')} "
              f"lost_ranks={d.get('lost_ranks')} "
              f"resumed={len(d.get('resumed_partitions') or [])} "
              f"recomputed={len(d.get('recovered_partitions') or [])}")
        if d.get("regrown"):
            print(f"[RESULTS] regrown: "
                  f"joined_ranks={d.get('joined_ranks_admitted')} "
                  f"survivors={d.get('survivors')}")
        if d.get("hedged"):
            print(f"[RESULTS] hedged: straggler={d.get('straggler')} "
                  f"partitions={d.get('hedged_partitions')} "
                  f"hedgewin={d.get('hedgewin')} "
                  f"specwaste={d.get('specwaste')}")
    if times:
        print("[ELASTIC] " + json.dumps(times), file=sys.stderr, flush=True)


def _run_joiner(args, meas, membership) -> int:
    """The newcomer's half of elastic growth (``--elastic-join N``, JAX
    ``main.py:1126-1257``): outside the incumbents' process group, this
    process wrote a ``joining`` lease before any work; it waits for an
    incumbent's epoch bump (the fenced admission, read from the shared
    lease directory), regenerates the seeded relations on the host,
    recomputes its share of the unfinished partitions on ``--device``
    into the shared manifest (``execute_recovery(only_rank=...)``, the
    incumbents' regrowth discipline) and reports once the manifest is
    complete: completeness, not a barrier, is the exit signal."""
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.performance.measurements import RECOVERN
    from tpu_radix_join_torch.robustness.recovery import (execute_recovery,
                                                          host_keys,
                                                          partition_weights,
                                                          plan_recovery)

    board = membership.board
    nodes = args.nodes
    my_nodes = [board.rank]          # one node a rank
    cfg = _join_config(args)
    inner, outer = _relations(args, nodes)
    num_p = cfg.network_partition_count
    manifest = _manifest(args, nodes, num_p, meas)
    print(f"[ELASTIC] joiner rank={board.rank} nodes={my_nodes} "
          f"waiting for admission under {board.run_dir}", file=sys.stderr,
          flush=True)
    wait_s = max(120.0, 6.0 * board.lapse_window_s)
    deadline = time.monotonic() + wait_s
    admitted_epoch = 0
    while time.monotonic() < deadline:
        for r in board.discover():
            lease = None if r == board.rank else board.read(r)
            if (lease is not None and lease.status == "member"
                    and lease.epoch > admitted_epoch):
                admitted_epoch = lease.epoch
        # incumbents that finished the grown join before this process read
        # their leases leave its lines behind, at the admission's epoch
        admitted_epoch = max([admitted_epoch] + [
            rec["epoch"] for rec in manifest.completed().values()])
        if admitted_epoch >= 1:
            break
        board.heartbeat(membership.epoch, status="joining")
        time.sleep(min(0.2, board.lease_s / 4.0))
    if admitted_epoch < 1:
        print("[RESULTS] failure/joiner: no admission epoch bump before "
              "the deadline: the incumbents never saw the joining lease "
              "(a dead world, or no --elastic-grow there)", file=sys.stderr)
        return 1
    membership.epoch = admitted_epoch
    membership.joined.add(board.rank)
    board.heartbeat(admitted_epoch, status="member")
    print(f"[ELASTIC] joiner admitted epoch={admitted_epoch}",
          file=sys.stderr, flush=True)
    rk, rhi = host_keys(inner)
    sk, shi = host_keys(outer)
    plan = plan_recovery(num_nodes=nodes, num_partitions=num_p,
                         lost_ranks=[], epoch=admitted_epoch,
                         manifest=manifest,
                         weights=partition_weights(rk, sk, num_p),
                         joined_ranks=my_nodes)
    board.heartbeat(admitted_epoch, status="member")
    t0 = time.perf_counter()
    execute_recovery(plan, rk, sk, rhi, shi, only_rank=set(my_nodes),
                     manifest=manifest, measurements=meas,
                     device=args.device, sort_impl=cfg.sort_impl,
                     pipeline=cfg.grid_pipeline)
    recompute_s = time.perf_counter() - t0
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        if len(manifest.completed()) >= num_p:
            break
        board.heartbeat(admitted_epoch, status="member")
        time.sleep(0.1)
    done = manifest.completed()
    matches = int(sum(rec["count"] for rec in done.values()))
    mine = sum(1 for rec in done.values() if rec.get("owner") in my_nodes)
    expected = inner.expected_matches(outer)
    print(f"[RESULTS] joiner: rank={board.rank} epoch={admitted_epoch} "
          f"owned_partitions={mine} manifest_partitions={len(done)}/{num_p}")
    print(f"[RESULTS] Tuples: {matches}")
    if expected is not None:
        status = "OK" if matches == expected else "MISMATCH"
        print(f"[RESULTS] Expected: {expected} ({status})")
        if matches != expected:
            return 1
    if len(done) < num_p:
        print("[RESULTS] failure/joiner: manifest incomplete at the "
              "deadline", file=sys.stderr)
        return 1
    aud = manifest.audit()
    print(f"[ELASTIC] joiner manifest audit total={aud['total']} "
          f"fenced_duplicates={aud['fenced_duplicates']}", file=sys.stderr)
    print("[ELASTIC] " + json.dumps({
        "kind": "joiner", "rank": board.rank, "matches": matches,
        "recomputed": int(meas.counters.get(RECOVERN, 0)),
        "recompute_s": recompute_s,
        "launches": {k: v for k, v in kernels.launch_counts().items()
                     if v}}), file=sys.stderr, flush=True)
    if args.output_dir:
        print(f"[PERF] stored {meas.store(args.output_dir)}")
    return 0


def _join_body(args, group, rank, meas, membership=None) -> int:
    """One join of ``--nodes`` ranks (or the grid), its result line from
    rank 0; every rank returns 1 unless the result equals the oracle, and
    1 with ``[RESULTS] failure/failure_class`` and a forensics bundle when
    the join raises a classified failure (a watchdog trip)."""
    from tpu_radix_join_torch.ops.kernels import launch_counts
    from tpu_radix_join_torch.performance.measurements import (RESULTS,
                                                               print_results)
    from tpu_radix_join_torch.planner.audit import (actuals_for_explain,
                                                    audit_plan,
                                                    critpath_for_explain,
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
    engine = None
    if args.grid_chunk_tuples is None:
        engine = _engine(args, cfg, group, meas, plan_cache)
        cfg = engine.config
        nodes = cfg.num_nodes
        _attach_manifest(args, engine, cfg, nodes, meas, membership)
    n = args.tuples_per_node * nodes
    meas.meta.update(tuples_per_node=args.tuples_per_node, global_size=n,
                     config=vars(args))
    inner, outer = _relations(args, nodes)
    expected = inner.expected_matches(outer)
    if engine is None:
        return _run_grid(args, inner, outer, expected, meas, plan=plan)

    # generation is set-up, outside the join's timers (main.cpp:94-116)
    r, s = engine.place(inner), engine.place(outer)
    key_bound = max(inner.key_bound(), outer.key_bound())
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(engine.device)
    trace_ctx = (meas.trace(os.path.join(args.output_dir, "trace"))
                 if args.trace else contextlib.nullcontext())
    # the hang watchdog: evidence first (stacks, bundle), then the kill
    # through the engine's cancel hook
    from tpu_radix_join_torch.observability.statusz import (
        measurements_sections)
    from tpu_radix_join_torch.observability.watchdog import (Watchdog,
                                                             engine_killer)
    wd_ctx = (Watchdog(meas, timeout_s=args.watchdog_timeout,
                       kill=engine_killer(engine),
                       bundle_dir=_forensics_dir(args), config=vars(args),
                       membership=membership)
              if args.watchdog_timeout > 0 else contextlib.nullcontext())
    statusz = _statusz(args, measurements_sections(meas))
    if args.elastic == "on":
        # recovery regenerates the relations from their seeded specs on
        # the host, never from the group's tensors
        from tpu_radix_join_torch.robustness.recovery import relation_inputs
        engine.elastic_inputs = relation_inputs(inner, outer)
    times0 = phase_snapshot(meas)
    t0 = time.perf_counter()
    try:
        with trace_ctx, wd_ctx, _membership_faults(args, meas):
            if args.pipeline_repeats and args.repeat > 1:
                result = engine.join_arrays_pipelined(r, s, args.repeat,
                                                      key_bound=key_bound)
            else:
                for _ in range(args.repeat):
                    result = engine.join_arrays(r, s, key_bound=key_bound)
            if cuda:
                torch.cuda.synchronize(engine.device)
    except Exception as e:
        # a classified failure (a watchdog trip, an injected fault) exits
        # with its class and a forensics bundle; anything else stays a
        # traceback
        cls = getattr(e, "failure_class", None)
        if cls is None:
            raise
        meas.meta["failure_class"] = cls
        if rank == 0:
            print(f"[RESULTS] failure/failure_class: {cls}")
        print(f"[RESULTS] failure/error: {e}", file=sys.stderr)
        bundle = _emit_failure_bundle(meas, e, args)
        if bundle:
            print(f"[FORENSICS] bundle {bundle}", file=sys.stderr)
        if args.output_dir:
            path = meas.store(args.output_dir)
            if rank == 0:
                print(f"[PERF] stored {path}")
        return 1
    finally:
        if statusz is not None:
            statusz.stop()
    join_s = (time.perf_counter() - t0) / args.repeat
    ok = result.ok and (expected is None or result.matches == expected)
    meas.meta["failure_class"] = result.diagnostics["failure_class"]
    # after a recovery nothing of the group is touched again: no gather,
    # and the lowest survivor reports from its own registry
    recovered = bool(result.diagnostics.get("recovered"))
    lost = sorted(membership.lost) if membership is not None else []
    reporter = rank == 0
    if lost and membership.board.num_ranks > 1:
        reporter = membership.board.rank == min(membership.survivors)
    if recovered:
        _print_recovery(result.diagnostics, engine.last_recovery, reporter)
    cp = _critical_path(meas, rank)
    # plan-vs-actual: the measured JTOTAL (and the critical path) against
    # the plan's prediction
    audit = audit_plan(plan, meas, repeats=args.repeat, times0=times0,
                       critical_path=cp)
    if args.repeat > 1:
        # the report's Tuples line is one join's result; times and tuple
        # counters stay cumulative
        meas.counters[RESULTS] = result.matches
    if args.measure_phases or args.output_dir:
        meas.measure_dispatch_floor(device=engine.device)
    all_meas = ([meas] if recovered or lost
                else meas.gather_all(engine.world))
    if reporter:
        if audit is not None:
            print(f"[PLAN] actual_ms={audit['actual_ms']:.1f} "
                  f"predicted_ms={audit['predicted_ms']:.1f} "
                  f"drift={audit['drift_pct']:.1f}%")
            if costs is not None:
                from tpu_radix_join_torch.planner import explain_table
                print(explain_table(costs, plan,
                                    actuals=actuals_for_explain(audit),
                                    critpath=critpath_for_explain(audit)))
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
        if reporter:
            print(f"[PERF] stored {path}")
    if reporter:
        print(json.dumps({
            "matches": result.matches, "ok": result.ok, "expected": expected,
            "recovered": recovered, "recovery": engine.last_recovery,
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
            "launches": {k: v for k, v in launch_counts().items() if v},
        }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
