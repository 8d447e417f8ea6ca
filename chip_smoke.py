#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``tpu_radix_join_torch/csrc/``, holds
each one bit-exact against its plain PyTorch version on the card (at the
main path's shapes and at adversarial small shapes), times it beside its
plain version, its memory bound and the nearest single PyTorch call, then
drives the paths below and checks their answers, their counters and that
each kernel launched (the counts are reset before each group of paths).
K2, the onesweep radix sort, is also held at tile edges, on lanes whose
keys share one digit, with 1-4 lanes, under key bounds of 1 and 2 passes,
at the row sort's 64 x 65536 shape and past 2**30 keys (2**30 + 4097, its
order, stability and permutation checked without the plain version); its
histogram table against a per-pass ``bincount``; and it is timed at five
main-path shapes: (a)'s union, (h)'s, (d)'s row sort, (k)'s slab and (j)'s
presort.  Its histogram launches, one a sort, count as ``radix_histogram``.
K4, the onesweep grouping pass (a histogram and a onesweep launch a call),
is also held with every id in one group, at capacity 1 and with every id
invalid at the local-partition shape, at tile edges, and in slots mode
past 2**31 ids (2**31 + 4097, held without the plain version: its
histogram and every slot).  K6, the single-pass per-window scan, is also
held at its tile counter's edges, at widths under a thread's items and on
one key's run over five tiles.  K3 and K5, the single-pass partition scans
(``csrc/merge_scan_partitions.cuh``), are also held at their tile's edges,
on one key's run over more than three tiles, with 128 partitions of a few
positions each and on lanes offset by one element (the 4-byte load path);
the run prints their scratch size at (a)'s and (h)'s unions.  The run
prints the ``-Xptxas -v`` registers, shared memory and spills of K3's,
K4's, K5's and K6's kernels, and their device time by kernel under
``torch.profiler`` beside the event times.
The sort probe — ``HashJoin(JoinConfig()).join(inner, outer)``:

  (a) unique ⋈ unique, 20,000,000 tuples each (hpcjoin's per-node size);
  (b) unique ⋈ zipf(theta 0.75) over a 20,000,000-key domain;
  (c) modulo(65536) ⋈ unique at 2**24 tuples, where the uint32
      overflow guard runs the partition histogram.

The partitioned join (window sizing, exchange, local radix partition,
bucketized build/probe):

  (d) unique ⋈ unique, 20,000,000 each, ``probe_algorithm="bucket"``;
  (e) unique ⋈ zipf(theta 0.75) over 20,000,000 keys, ``two_level=True``
      with capacity retries (the Zipf head fills one local bucket);
  (f) full-range keys at 2**24: unique ⋈ modulo(65536), both shifted into
      [2**31, 2**32 - 2), through ``join_arrays``.

Full-range and 64-bit keys (the wide merge scan, K5):

  (g) the full-range sort probe: unique ⋈ zipf(theta 0.75) over a
      20,000,000-key domain, 20,000,000 each, both shifted into
      [2**31, 2**31 + 20M) by flipping bit 31, through ``join_arrays`` with
      ``key_range="auto"``, whose device max-key probe picks the full route;
  (h) the 64-bit sort probe: unique ⋈ unique, 20,000,000 each,
      ``key_bits=64``;
  (i) the 64-bit partitioned join: (h)'s relations with
      ``probe_algorithm="bucket"``.

The out-of-core grid (the per-window merge scan, K6) and its fallback:

  (j) the pipelined grid, unique ⋈ unique, 2**30 tuples each in chunks of
      2**27 (hpcjoin's 128M-tuple large-data chunk): an 8 x 8 grid, each
      inner chunk sorted once per row (K2) and probed by binary search;
  (k) the synchronous grid, unique ⋈ unique, 2**26 each in chunks of
      2**25, slabs of 2**20: K2 and K6 on every slab's union; again with a
      modulo(65536) inner, whose weights of 1024 exercise the window guard;
  (l) ``fallback="chunked"``: (e)'s relations with no retries, so the
      two-level attempt overflows and degrades to the chunked count;
  (m) the 64-bit grid, 2**24 ⋈ 2**24 unique in chunks of 2**23,
      pipelined: the wide slabs through K2 and K5.

The distributed main path's generic body over a ``torch.distributed`` NCCL
process group of one rank (one card holds one NCCL rank), 20,000,000 ⋈
20,000,000 unique tuples a rank (phase_n):

  (n1) ``probe_algorithm="bucket"`` through ``HashJoin.join``, equal to (d);
  (n2) the shuffled narrow sort probe (``join_shuffled``): K1 sizing, K4
       into one block of 2**25 slots a side, ``all_to_all_single``, then K2
       and K3 over the 67.1M-position pad-filled union, equal to (a);
  (n3) the same with ``key_bits=64``: K2 with three lanes, then K5, equal
       to (h);
  (n4) (n2) with ``debug_checks=True``.

K4 is also held at the exchange call of a 4- and an 8-rank world (20M ids
into 4 groups of 2**23 slots and 8 of 2**22), and K1's and K2's device
times are printed beside their event times.

Cell (o), on (n)'s NCCL group of one rank at 20,000,000 ⋈ 20,000,000
(phase_o): the measurements and the rest of the distributed main path:

  (o1) the chunked probe after the shuffle, ``JoinConfig(chunk_size=2**22)``
       over receive buffers of 2**25 slots (8 outer slabs), narrow and at
       ``key_bits=64``: exact, with (n2)'s and (n3)'s per-partition counts;
  (o2) ``distribute`` of the 20M-tuple relation, 32- and 64-bit: the
       tuples conserved and the order equal to the plain sort of the same
       hash keys, bit for bit;
  (o3) a ``Measurements`` registry on (a), (n1) and (n2): the phase
       columns present (JMPI, SNETCOMPL, SLOCPREP, BPBUILD/BPPROBE with
       ``measure_phases``), the results unchanged, the median join with and
       without the registry (interleaved, 10 each), JTOTAL beside this
       script's host clock around the same join;
  (o4) ``Measurements.trace`` around one join of (a), (n1) and (n2):
       CTOTAL beside the profiler's device time of the same join, and the
       idle share of (o3)'s median;
  (o5) ``python -m tpu_radix_join_torch.main --output-dir ...
       --measure-phases`` at 20M: exit 0, the oracle's OK, ``0.perf``
       loaded with JTOTAL.

Cell (q), on the same group at 20,000,000 ⋈ 20,000,000 unique (phase_q):
the materializing join (ROADMAP A12) and the command-line knobs (A20):

  (q1) ``join_materialize_arrays`` with ``match_rate_cap=8``: exactly 20M
       pairs, each outer rid once, every pair joining equal keys (checked
       on the host from the generated lanes); the median of 3 joins, and
       the shuffle, the inner K2 sort, the searchsorted, the gather and
       the compaction readback alone; K2 at the inner sort's shape against
       its plain version; then ``probe_count`` and the three
       ``local_join_*`` on the relations (K6 under ``local_join_merge``);
  (q2) (q1) at ``key_bits=64``, through the union scan (K2 over four
       lanes, held against its plain version);
  (q3) (q1) and (q2) with ``chunk_size=2**22``: the pairs equal the
       resident join's;
  (q4) the rate-cap retry: modulo(2**23) ⋈ unique at 2**24,
       ``match_rate_cap=1``: one retry to 2**24 pairs, and without
       retries ``ok`` false and 2**23 outer tuples over the cap;
  (q5) ``generation="host"`` for unique, modulo, Zipf and 64-bit at 20M:
       bit-equal to the card's generation, its time printed;
  (q6) ``join_arrays(..., repeats=5)`` on (a)'s relations: one readback,
       RESULTS 5 x 20M, the time a join against 5 synchronous joins;
  (q7) ``engine.shuffle_overflow`` armed once: one retry, the exact count,
       a ``retry`` event;
  (q8) the command line with ``--debug-checks --probe bucket``,
       ``--generation host`` and ``--pipeline-repeats --repeat 3``: exit 0
       and the oracle's count.

Cell (r), on the same group (phase_r): the packed wire codec, the
staged exchange's neighbours and integrity verification (ROADMAP A13,
A15):

  (r1) the grouped scatter (K4's grouped mode: rank * 32 + pid into 128
       groups, 32 a block) of rank 0's shard of the unique 4-rank
       relation into four blocks of 2**23 slots, the capacity phase (p)'s
       20M-a-rank join sizes, then ``pack_blocks`` and ``unpack_blocks``
       on the card, narrow and 64-bit, under the measured key bound and
       under none: the words equal the CPU's bit for bit, and the round
       trip is exact; the pack's and the unpack's times;
  (r2) ``segmented_xor_fold`` and ``device_partition_checksums`` at 20M
       against the same calls on the CPU;
  (r3) (n1)'s bucket join with ``verify="check"``: clean (VCHKN 4), with
       ``exchange.corrupt_lane`` armed once (``ok`` false, one damaged
       partition), and with ``verify="repair"`` armed once (the oracle
       count, VREPAIR 1, the whole join recomputed); VCHK beside JTOTAL,
       and JTOTAL unverified.

K4's grouped call is also held against its plain version at the 4-rank
exchange's 20M ids, at 2**23 slots a block and clipped at 2**22.

Cell (s), on the same group (phase_s): the resident join service (ROADMAP
A16), through ``JoinSession`` and ``python -m tpu_radix_join_torch.main
--serve``, unique ⋈ unique at 20,000,000 tuples a node:

  (s1) one session (``probe_algorithm="bucket"``, a result cache of 8, a
       50 ms batch window, 1024 MiB resident): q0 cold, q1 and q2 warm (no
       JHIST), q3 a repeat of q0 served by the cache (no launch); four
       queries of one signature at 2**20 through one fused program
       (``batched``, BATCHN 1, BATCHQ 4, K2 launched), timed against the
       same four served solo; the delta chain (the 20M base, then three Δ
       of 2**16 a node, ``delta_merge``, K2 launched, each count the host
       oracle's); a 1 ms deadline missed and the next query served; a
       session of queue depth 2 rejecting a third submission; then the
       command line's ``--serve`` with q0-q3 and the deadline pair.  Each
       query's latency and launches, and the SLO p50 and p99, are printed;
       no degraded engine and no ``batch_fallback`` fires;
  (s2) the breaker at 2**16: ``backend.dispatch`` armed three times trips
       it, the degraded CPU engine serves one query with no kernel
       launched, the half-open probe closes it and the card's kernels run
       again;
  (s3) in phase (p)'s four gloo ranks: one session of the four ranks
       serves three queries at 20M a rank (q1 and q2 warm) and a delta
       base and delta merge at 2**20 a rank; every rank reports the same
       outcomes.

Phase (t), wider fanout and the implementation choice (ROADMAP A19, A21;
phase_t), on the one card, run before (n):

  (t1) each wide kernel path bit-exact against its plain version: K1 past
       128 bins (20M ids into 256, 1024, 2**14 and 2**16 bins, random and
       sorted, counts and weight sums), K3 and K5 past 128 partitions
       (fanouts 8, 10, 12 on (a)'s and (h)'s unions), K4 past 256 groups
       (dense 257, 1025 and 4097 groups; grouped 16 x 32 and 4 x 256 at
       2**23 slots a block, clipped), each timed beside its bytes bound,
       its device time and the library call (``torch.bincount``,
       ``argsort(stable=True)``);
  (t2) 20,000,000 ⋈ 20,000,000 unique joins, median of 3, beside the
       fanout-5 join each extends: the sort probe at network fanout 8 and
       10, 64-bit at 10, bucketed at local fanout 10, two-level 8 + 10;
       each wide path's counter shows it ran and no baseline counter moved;
  (t3) (a) and (d) under ``sort_impl="xla"`` and ``partition_impl=
       "sort"``: the kernels' counts, the baseline counters ticked, K2 and
       K4 at zero, ``baseline_arms`` in the result.

Phase (p), the skew split and the hierarchical exchange (phase_p): four
rank processes of one gloo group on this one card
(``multihost.initialize(device="cuda", backend="gloo")``, ``file://``
rendezvous, every rank's tensors on ``cuda:0``; gloo's CUDA collectives go
through the host, so its times are not NCCL times), 20,000,000 ⋈
20,000,000 tuples a rank, unique ⋈ zipf(theta 0.75) over the whole key
domain, generated on the card:

  (p1) ``skew_threshold=4.0``, the sort probe: the hot set, ``hot_cap``, the
       caps and retries printed; the oracle's count; each hot partition's
       outer load spread over the ranks (max <= 1.5 x mean), where the same
       join unsplit sits it on one rank with the same total; K1, K4 (the
       exchange and the hot extraction), K2 and K3 launched;
  (p2) (p1) with ``two_level=True`` at 2**22 a rank: K4's second pass and
       K2's row sort take the replicated hot side;
  (p3) (p1) at ``key_bits=64``: K2 over three lanes, then K5;
  (p4) (p1) with ``num_hosts=2`` (2 x 2): its per-rank, per-partition
       counts equal (p1)'s, and one exchange of each relation through the
       hierarchical route equals the flat route's lanes and counts bit for
       bit on the card;
  (p5) ``join_materialize_arrays`` under (p1)'s split against the same
       join unsplit: every rank returns all 80M pairs, each outer rid
       once, each pair joining equal keys, and the two pair lists equal
       (a digest of the pairs ordered by s_rid);
  (p6) the packed and the staged exchange and verify (A13, A15): the
       sort probe with ``exchange_codec="pack"``, ``"auto"`` and
       ``exchange_stages=4`` against (p1) unsplit, ``"pack"`` with the
       split against (p1), ``num_hosts=2`` with 4 stages against (p4),
       ``"pack"`` at ``key_bits=64`` against (p3), the split
       ``join_materialize_arrays`` under ``"pack"`` against (p5)'s pairs,
       each exactly; and ``verify="repair"`` with ``exchange.corrupt_lane``
       armed once: the oracle count, one partition repaired.  Each prints
       ``pack_ratio_pct``, WIREBYTES against MWINBYTES and
       ``peak_exchange_bytes`` against the fused raw exchange's;
  (p7) the packed exchange at network fanout 7 (A19): the grouped
       scatter's 4 x 128 = 512 groups on K4's wide path, exact and equal on
       every rank.

Each case prints every rank's join median of 3, its exchange (JMPI) and
local probe (JPROC) under ``measure_phases``, and its device busy time.
The ranks are this script started with ``--phase-p-rank`` (one each); the
kernels are built before they start.

Phase (u), the planner (ROADMAP A17) and the run ledger (phase_u), after
(p), its ledger and fits in a temporary directory:

  (u1) three probe rounds on the card, each a ledger row a constant:
       ``calibrate()`` (the elementwise envelope, the stable
       ``torch.sort`` stage unit, the dispatch floor, the card's memory),
       K2 alone on 20,000,000 random keys, K4 on 20,000,000 ids into 32
       groups, the full-range sort over the narrow one at (a)'s union, the
       ``partition_impl="sort"`` arm, a random gather and a session's
       result-cache hit (its executed queries write ``query`` rows);
       ``fit_profile`` over them, each constant printed with its CI beside
       the packaged ``h100`` profile's value;
  (u2) (a)'s workload planned under the packaged ``h100`` and run by
       ``main --plan auto --ledger-dir`` in this process: exact, the
       strategy's kernels launched, ``plan_vs_actual`` and PLANDRIFT; the
       plan's config timed by the registry; the saved plan replayed with
       ``--plan FILE``;
  (u3) ``--plan explain --profile auto`` as a subprocess: exit 0, no
       ``[RESULTS]``, the profile resolved to (u1)'s fit;
  (u4) 2**26 ⋈ 2**26 planned under a copy of ``h100`` cut to 4 GiB: the
       chunked plan run with a checkpoint whose fingerprint carries it and
       ``--grid-pipeline auto`` taking its choice, then the cost table's
       other grid row replayed; exact, K2 launched, K6 on the synchronous
       grid.

Phase (v), the serve worker's liveness and observability plane (ROADMAP
A16b step 1, A18d; phase_v), last, at 20,000,000 tuples a node:

  (v1) in this process, a ``JoinSession`` with the flight recorder, a span
       tracer, the compile monitor, a one-rank ``MembershipView`` whose
       lease the heartbeat (``attach_heartbeat``) writes every 0.25 s,
       ``forensics_dir`` and a 2 s watchdog (``attach_watchdog``): two
       sort-probe queries (K2, K3) and, through a second such session, a
       bucket query (K1, K4, K2), each exact; a query with ``backend.stall``
       armed ends as ``backend_unavailable`` within the timeout plus 3 s,
       its bundle carrying every thread's stack, and the next query is
       exact; NCOMPILE flat after each path's first query; the lease's age
       read every 20 ms stays under its 2 s lapse window; the same warm
       query with the plane on and off, (o3)'s registry overhead with the
       ring on, one sampler tick;
  (v2) ``python -m tpu_radix_join_torch.main --serve - --elastic on
       --lease-dir ... --rank-lease-s 1 --rank-missed-beats 2
       --metrics-interval 0.25 --timeline-dir ... --statusz 0
       --forensics-dir ... --watchdog-timeout 30 --probe bucket --trace``
       as a subprocess fed one query at a time on its stdin (three exact,
       a missed deadline): ``/statusz``, ``/statusz/leases`` and
       ``/healthz`` between them, each GET timed; the lease younger than
       its lapse window while it serves and withdrawn at exit; one metrics
       line a tick with the card's bytes in use; the span file merged into
       a timeline with a device track; exit 1, the missed deadline's.

Phase (w), the crash-only fleet (ROADMAP A16b step 2; phase_w), after (v),
at 20,000,000 tuples a node, through the command line as subprocesses:

  (w1) ``python -m tpu_radix_join_torch.main --fleet 2 --serve FILE
       --verify check --fleet-dir D --fleet-kill-at 2 --statusz 0``: three
       queries in two tenants, the second's worker SIGKILLed with the
       request on its pipe and the query replayed on the survivor; every
       outcome exact, ``failover`` and ``replayn`` at least 1,
       ``double_exec`` and ``unacked`` 0, the journal's audit agreeing;
       ``/healthz`` 200 while a worker serves, ``/statusz`` with its
       ``fleet`` section; the card holding one CUDA context a live worker
       beside this script's and none for the supervisor; the workers'
       heartbeat lines holding their device bytes, NCOMPILE / COMPILEMS
       and kernel launches (K2, K3);
  (w2) ``--fleet 1 --serve - --fleet-kill-at 1``: one query on stdin, its
       only worker killed and the slot respawned (``w0i2``), the query
       replayed there; SIGTERM after the outcome: exit 0, nothing
       unacknowledged, no lease left.

  It prints the failover time, the cold restart, each query's latency
  through the fleet beside the worker's and (v1)'s warm in-process query,
  the supervisor's dispatch overhead and the workers' peak device memory.

Phase (x), the host-fed chunk stream (ROADMAP A18a), the device-init
fallback and the partition manifest (A18b) and the critical path (A18d's
critpath.py; phase_x):

  (x1) the synchronous grid at (k)'s shape, 2**26 ⋈ 2**26 unique in
       chunks of 2**25, slabs of 2**20, fed by ``stream_chunks`` (the
       native generator into a pinned pool, non-blocking copies on a side
       stream) and by ``stream_chunks_device``: equal totals, equal K2 and
       K6 launches, the first chunks bit-equal; a chunk's fill and H2D
       ms and the fill time hidden under the previous chunk; the host feed
       first pinning its pools, then on the pools kept pinned; the
       pipelined engine on the host feed;
  (x2) ``main(argv)`` with ``engine.device_init`` armed and
       ``--cpu-fallback`` at 2**22 a node (the plain versions on the
       host): the ``[DEGRADE]`` line, exact, no launch; without the flag
       the fault raises; the flag on the healthy card at 20M: (a) on the
       card, K2 and K3;
  (x3) (a) with ``--elastic on --checkpoint-dir``: 32 manifest lines equal
       to the join's per-partition counts; a rerun leaves ``completed()``
       as it was; another fingerprint raises ``CheckpointMismatch``;
  (x4) (a) with ``--timeline-dir``: ``[CRITPATH]``, the path within JTOTAL
       + 5%, its classes summing to it; ``--plan explain --timeline-dir``'s
       ``critical_path`` column; two session queries' paths in
       ``/statusz``.

Phase (y), membership, recovery, stragglers and chaos over two gloo ranks
(ROADMAP A18c; phase_y, its docstring), then phase (z), the sync guard
(``utils/hostsync.sync_guard``, A18e) and the command-line tools (phase_z),
last:

  (z1) (a) at 20M on placed lanes under ``sync_guard("disallow")``, then
       (c)'s modulo(65536) ⋈ unique at 2**24 (K1): exact, K1/K2/K3
       launched, SORTPASS equal to K2's sorts, the sanctioned
       readbacks, uploads and fences a join makes (counted by wrapping
       each module's ``host_readback``);
  (z2) ``main(argv)`` with ``--transfer-guard disallow --timeline-dir T``
       twice: exit 0, OK; ``tools.critical_path T --summary`` and
       ``tools.check_regress`` over the two result lines exit 0;
  (z3) under the guard: the synchronous and the pipelined grid at 2**24
       (K2, K6), a ``JoinSession``'s cold and warm query, and on an NCCL
       group of one rank the generic body (K1, K4, K2, K3), the bucket
       probe, ``debug_checks``, a verified repair of a corrupt lane and
       the materializing join, each exact;
  (z4) a bare ``.cpu()`` under ``disallow`` raises, under ``log`` warns;
  (z5) (a) with the guard off and at ``disallow``, 10 joins each,
       interleaved: the medians;
  (z6) ``python -m tpu_radix_join_torch.tools.lint --strict`` exits 0.

Phase (aa), last: ROADMAP C10's repairs under the guard and the evidence
tools on the card's own output (phase_aa):

  (aa1) ``main(argv)`` with ``--partition-impl sort --transfer-guard
        disallow`` at 20M: (a), (d) and (d) on both library arms
        (``--sort-impl xla`` too, (t3)'s arms), exact, the sanctioned
        readbacks and the ``baseline_*`` launches; then K4 against its
        plain version on the card, bit-equal, the plain version under
        ``disallow``;
  (aa2) ``execute_recovery`` of all 32 partitions of 20M ⋈ 20M in this
        process under the guard: exact, K2 and K6; then (y1)'s two gloo
        ranks with ``--rank-death-at 2`` and the skew split (unique ⋈
        zipf, ``--skew-threshold 4``) on two gloo ranks, both under
        ``--transfer-guard log``: exact, every trip listed by site; a gloo
        ``all_reduce`` of a CUDA and of a CPU tensor under ``log``: the
        trips each makes by itself;
  (aa3) the grid at 2**24 fed by ``stream_chunks`` under the guard: exact;
  (aa4) three runs at 20M and three at 2**16 of ``main(argv)`` with
        ``--output-dir``, ``--ledger-dir`` and ``--timeline-dir``, then
        ``tools.make_report`` (the report, ``--emit-ledger``,
        ``--emit-profile``, ``--emit-timeline``) and ``tools.profile_fit``
        (``fit``, ``diff``, ``refresh``) on them, each exit code checked.

Every line of standard output is one JSON object, except one line that is
nvidia-smi's ``name, power.limit`` as it prints them.  The line before the
last lists the kernels; the last is ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero.  Needs one CUDA device; exits non-zero
without one, and outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


#: tuples of each relation of cell (j): 8 x 8 chunks of 2**27
GRID_J_TUPLES = 1 << 30
#: the chunked probe's slab in cell (o1): 8 slabs of (n)'s 2**25-slot
#: receive buffers
O1_CHUNK = 1 << 22
#: cell (q3)'s slab, as (o1)'s; (q4)'s relations: 2**24 tuples, the inner
#: one modulo 2**23 (each key twice); arguments (q8) adds to its command
#: lines (none on the card)
Q3_CHUNK = 1 << 22
Q4_TUPLES = 1 << 24
Q8_EXTRA = ()


#: cell (r1)'s packed blocks: the four blocks of the capacity phase (p)'s
#: unique 20M-a-rank join sizes (5M tuples a destination)
R1_BLOCKS = 4
R1_CAPACITY = 1 << 23


#: phase (p): four ranks of one gloo group on the one card (hpcjoin's
#: 20,000,000 tuples a rank and relation, ``main.cpp:70-71``); the
#: two-level case (p2) at 2**22 a rank: its retries double every bucket of
#: the second radix pass until the hot buckets fit, and four ranks' rows at
#: 20M would not fit the card's 80 GB together
P_RANKS = 4
P_TUPLES = 20_000_000
P2_TUPLES = 1 << 22
#: seconds phase (p)'s ranks may take together before they are killed
P_DEADLINE_S = 600.0
#: the command-line flag that runs one rank of phase (p)
P_RANK_FLAG = "--phase-p-rank"
#: the partitioned join's capacity retries in (p2) (the Zipf head fills
#: one local bucket, as in (e)); the others need none
P2_RETRIES = 6
P_BACKEND = "gloo-cuda, 4 ranks on one card"

#: the sources whose registers, shared memory and spills the run prints
PTXAS_SOURCES = ("partition", "merge_scan_chunks", "merge_scan",
                 "merge_scan_wide", "partition_wide", "partition_msd",
                 "histogram")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_summary(log: str) -> dict:
    """``-Xptxas -v``'s registers, shared memory and spills per kernel."""
    names = {"chunks_kernel": "chunks_kernel",
             "onesweep_kernelILb1": "onesweep_kernel<slots>",
             "onesweep_kernelILb0": "onesweep_kernel<moving>",
             "histogram_kernel": "histogram_kernel",
             "count_kernel": "count_kernel",
             "carry_kernel": "carry_kernel",
             "starts_kernel": "starts_kernel",
             "sweep_kernelILb1": "sweep_kernel<slots>",
             "sweep_kernelILb0": "sweep_kernel<moving>",
             "histogram_range_kernelILb0": "histogram_range_kernel",
             "histogram_range_kernelILb1": "histogram_range_kernel<weighted>",
             "histogram_global_kernelILb0": "histogram_global_kernel",
             "histogram_global_kernelILb1": "histogram_global_kernel<weighted>",
             "pass_kernelILb0ELb0": "pass_kernel<coarse, moving>",
             "pass_kernelILb0ELb1": "pass_kernel<coarse, slots>",
             "pass_kernelILb1ELb0": "pass_kernel<last, moving>",
             "pass_kernelILb1ELb1": "pass_kernel<last, slots>",
             "4PlanENS_4Maps": "scan_kernel<starts, tile maps>",
             "PackedLane": "scan_kernel<packed>",
             "LanesILb1": "scan_kernel<lo, hi, tag>",
             "LanesILb0": "scan_kernel<lo, tag>"}
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((v for k, v in names.items() if k in line), line)
        elif name and ("Used" in line or "spill" in line):
            out.setdefault(name, []).append(line.split(":")[-1].strip())
    return out

def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_o(dev, n, group, rels32, rels64, placed, refs, time_ms,
            device_us, card) -> dict:
    """Cell (o) on (n)'s process group ``group`` (see the module
    docstring).  ``placed`` holds (n2)'s and (n3)'s placed relations,
    ``refs`` (n2)'s and (n3)'s results.  Each main path runs once with the
    launch counts set to 0; returns the launches of those runs."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from tpu_radix_join_torch import HashJoin, JoinConfig
    from tpu_radix_join_torch.data.tuples import CompressedBatch, widen
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.ops.build_probe import probe_count_per_partition
    from tpu_radix_join_torch.ops.kernels import histogram as k1
    from tpu_radix_join_torch.ops.kernels import radix_sort as k2
    from tpu_radix_join_torch.ops.merge_count import presorted_weights
    from tpu_radix_join_torch.ops.sorting import (sort_kv_unstable,
                                                  sort_unstable)
    from tpu_radix_join_torch.parallel.window import Window
    from tpu_radix_join_torch.parallel.distribute import (distribute,
                                                          shuffle_keys)
    from tpu_radix_join_torch.performance import Measurements

    def sync():
        torch.cuda.synchronize(dev)

    total = {k: 0 for k in kernels.launch_counts()}

    def main_path(fn):
        """``fn()`` once with the launch counts set to 0: (its result, the
        kernels it launched)."""
        sync()
        kernels.reset_launches()
        out = fn()
        sync()
        got = kernels.launch_counts()
        for k, v in got.items():
            total[k] += v
        return out, got

    def host_ms(fn):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    def same(a, b):
        return (a.matches == b.matches and a.ok == b.ok
                and np.array_equal(a.partition_counts, b.partition_counts)
                and a.diagnostics == b.diagnostics)

    bound = {32: max(r.key_bound() for r in rels32),
             64: max(r.key_bound() for r in rels64)}

    # (o1) the chunked probe after the shuffle
    chunk = O1_CHUNK
    for bits, ref_key in ((32, "n2"), (64, "n3")):
        cfg = JoinConfig(chunk_size=chunk, key_bits=bits)
        eng = HashJoin(cfg, dev, group=group)
        lanes = placed[ref_key]

        def join(eng=eng, lanes=lanes, bits=bits):
            return eng.join_arrays(*lanes, key_bound=bound[bits])

        res, got = main_path(join)
        ref = refs[ref_key]
        if not (res.matches == n and res.ok and res.retries == 0
                and np.array_equal(res.partition_counts,
                                   ref.partition_counts)):
            raise AssertionError(f"(o1) chunked {bits}-bit: {res}, "
                                 f"({ref_key}): {ref}")
        needed = ["histogram", "partition", "radix_histogram", "radix_pass"]
        if bits == 64:
            needed.append("merge_scan_wide")
        for k in needed:
            if got[k] <= 0:
                raise AssertionError(f"(o1) {bits}-bit: kernel {k} did not "
                                     "launch")
        plan = eng._shuffle_plan(*lanes)
        cap_r, cap_s, _ = eng._measure_capacities(*lanes, plan)
        runs = [host_ms(join) for _ in range(5)]
        # where the time goes: each stage alone (the probe's first slab)
        rp, sp, *_ = eng._shuffle(*lanes, plan,
                                  Window(eng.world, cap_r, "inner"),
                                  Window(eng.world, cap_s, "outer"))
        pid = sp.pid[:chunk]
        stages = {"sizing": lambda: eng._measure_capacities(
                      *lanes, eng._shuffle_plan(*lanes)),
                  "exchange": lambda: eng._shuffle(
                      *lanes, plan, Window(eng.world, cap_r, "inner"),
                      Window(eng.world, cap_s, "outer"))}
        if bits == 32:
            r_sorted = sort_unstable(rp.batch.key)
            slab = sp.batch.key[:chunk]
            weight = presorted_weights(r_sorted, slab)
            stages.update({
                "inner_sort": lambda: sort_unstable(rp.batch.key),
                "slab_searchsorted": lambda: presorted_weights(r_sorted,
                                                               slab),
                "slab_histogram": lambda: k1.histogram(
                    pid, weight, num_bins=eng.config.network_partition_count),
                "slab_max": lambda: weight.max()})
        else:
            slab = CompressedBatch(sp.batch.key[:chunk], pid,
                                   sp.batch.key_hi[:chunk])
            inner = CompressedBatch(rp.batch.key, rp.batch.rid,
                                    rp.batch.key_hi)
            stages["slab_probe"] = lambda: probe_count_per_partition(
                inner, slab, pid, eng.config.network_partition_count,
                return_max_weight=True)
        emit({"phase": "breakdown", "workload": f"o1_chunked_{bits}",
              "stage_ms": {k: time_ms(f, 5) for k, f in stages.items()},
              "join_ms": statistics.median(runs), **card})
        del rp, sp, stages
        emit({"phase": "chunked_probe", "cell": "o1", "key_bits": bits,
              "chunk_size": chunk, "receive_slots": cap_s,
              "slabs": -(-cap_s // chunk), "matches": res.matches,
              "join_ms": statistics.median(runs), "join_runs_ms": runs,
              "k2_launches": got["radix_pass"] + got["radix_histogram"],
              "launches": got, **card})

    # (o2) the pre-shuffle
    world = HashJoin(JoinConfig(), dev, group=group).world
    seed = 7
    for bits, batch in ((32, placed["n2"][0]), (64, placed["n3"][0])):
        out, got = main_path(lambda batch=batch: distribute(batch, world,
                                                            seed=seed))
        lanes_in = [x for x in batch if x is not None]
        lanes_out = [x for x in out if x is not None]
        # conserved: the rids are distinct, so the tuples ordered by rid
        by_in = torch.sort(widen(batch.rid)).indices
        by_out = torch.sort(widen(out.rid)).indices
        conserved = all(torch.equal(a[by_in], b[by_out])
                        for a, b in zip(lanes_in, lanes_out))
        plain = k2.radix_sort_plain(
            [shuffle_keys(batch.size, world.rank, seed, dev), *lanes_in])[1:]
        bit_exact = all(torch.equal(a, b) for a, b in zip(lanes_out, plain))
        if not (conserved and bit_exact and got["radix_pass"] > 0):
            raise AssertionError(f"(o2) distribute {bits}-bit: conserved "
                                 f"{conserved}, equal to the plain sort "
                                 f"{bit_exact}, launches {got}")
        h = shuffle_keys(batch.size, world.rank, seed, dev)
        stages = {
            "shuffle_keys": lambda: shuffle_keys(batch.size, world.rank,
                                                 seed, dev),
            "all_to_all_one_lane": lambda: world.all_to_all(batch.key,
                                                            batch.size),
            "sort": lambda: sort_kv_unstable(h, *lanes_in)}
        emit({"phase": "distribute", "cell": "o2", "key_bits": bits,
              "tuples": batch.size, "seed": seed,
              "ms": time_ms(lambda batch=batch: distribute(batch, world,
                                                           seed=seed)),
              "stage_ms": {k: time_ms(f) for k, f in stages.items()},
              "k2_launches": got["radix_pass"] + got["radix_histogram"],
              "launches": got, **card})
        del out, plain, lanes_out

    # (o3) the registry on (a), (n1) and (n2)
    lanes = placed["n2"]
    cells = {
        "a": (JoinConfig(), None, "join_arrays"),
        "n1": (JoinConfig(probe_algorithm="bucket"), group, "join_arrays"),
        "n2": (JoinConfig(), group, "join_shuffled"),
    }
    medians = {}
    for name, (cfg, grp, entry) in cells.items():
        def make(cfg, m=None, grp=grp):
            return HashJoin(cfg, dev, group=grp, measurements=m)

        def run(eng, entry=entry):
            return getattr(eng, entry)(*lanes, key_bound=bound[32])

        bare = make(cfg)
        m = Measurements()
        with_m = make(cfg, m)
        ref = run(bare)
        res = run(with_m)
        need = ["JTOTAL", "SWINALLOC", "JPROC"] + ([] if name == "a"
                                                  else ["JHIST"])
        if not same(res, ref) or not all(m.times_us.get(k, 0) > 0
                                         for k in need):
            raise AssertionError(f"(o3) {name}: {res} vs {ref}, columns "
                                 f"{dict(m.times_us)}")
        phases = None
        if name != "a":
            mp = Measurements()
            res_p = run(make(dataclasses.replace(cfg, measure_phases=True),
                             mp))
            t = mp.times_us
            want = ["JMPI", "SNETCOMPL", "JPROC", "JHIST", "SWINALLOC"]
            if name == "n1":
                want += ["SLOCPREP", "BPBUILD", "BPPROBE"]
            if not (same(res_p, ref) and all(t.get(k, 0) > 0 for k in want)
                    and t["JMPI"] <= t["JTOTAL"]
                    and t["SNETCOMPL"] <= t["JMPI"]):
                raise AssertionError(f"(o3) {name} measure_phases: {res_p}, "
                                     f"columns {dict(t)}")
            phases = dict(t)
        bare_ms, meas_ms = [], []
        for _ in range(10):                   # the arms interleaved
            bare_ms.append(host_ms(lambda: run(bare)))
            meas_ms.append(host_ms(lambda: run(with_m)))
        m_clock = Measurements()
        clocked = make(cfg, m_clock)
        run(clocked)
        m_clock.times_us.clear()
        clock_ms = host_ms(lambda: run(clocked))
        medians[name] = statistics.median(bare_ms)
        emit({"phase": "registry", "cell": "o3", "workload": name,
              "join_ms": statistics.median(bare_ms),
              "join_ms_with_registry": statistics.median(meas_ms),
              "overhead_pct": 100 * (statistics.median(meas_ms)
                                     / statistics.median(bare_ms) - 1),
              "join_runs_ms": bare_ms, "join_runs_ms_with_registry": meas_ms,
              "jtotal_ms": m_clock.times_us["JTOTAL"] / 1e3,
              "host_clock_ms": clock_ms,
              "phases_us": dict(m.times_us), "counters": dict(m.counters),
              "phases_us_measure_phases": phases, **card})

    # (o4) the profiler bracket around one join of (a), (n1) and (n2):
    # CTOTAL against this script's profiler device time of the same join,
    # and the idle share of (o3)'s median
    for name, (cfg, grp, entry) in cells.items():
        m = Measurements()
        eng = HashJoin(cfg, dev, group=grp, measurements=m)

        def join(eng=eng, entry=entry):
            return getattr(eng, entry)(*lanes, key_bound=bound[32])

        join()
        m.times_us.clear()
        with tempfile.TemporaryDirectory() as tmp:
            with m.trace(tmp):
                join()
        if not m.times_us.get("CTOTAL", 0) > 0:
            raise AssertionError(f"(o4) {name}: no CTOTAL: "
                                 f"{dict(m.times_us)}, "
                                 f"{m.meta.get('trace', {}).get('plane')}")
        # a profiler session that records no CUDA activity (seen once on
        # the card after the trace's own session) is taken again
        for _ in range(3):
            profiler_us = sum(device_us(join, 1).values())
            if profiler_us > 0:
                break
        else:
            raise AssertionError(f"(o4) {name}: the profiler recorded no "
                                 f"device time in three sessions")
        ctotal = m.times_us["CTOTAL"]
        emit({"phase": "trace", "cell": "o4", "workload": name,
              "ctotal_us": ctotal, "profiler_device_us": profiler_us,
              "ctotal_vs_profiler": ctotal / profiler_us,
              "idle_share": 1 - ctotal / 1e3 / medians[name],
              "join_ms": medians[name], "jtotal_us": m.times_us["JTOTAL"],
              "plane": m.meta["trace"]["plane"],
              "top_ops": list(m.meta["trace"]["ops"].items())[:8], **card})

    # (o5) the command line's report
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "tpu_radix_join_torch.main",
             "--tuples-per-node", str(n), "--output-dir", tmp,
             "--measure-phases"], cwd=root, capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=root), timeout=600)
        cli_s = time.perf_counter() - t0
        loaded = Measurements.load(tmp) if out.returncode == 0 else []
        lines = out.stdout.splitlines()
        if not (out.returncode == 0
                and f"[RESULTS] Expected: {n} (OK)" in lines
                and len(loaded) == 1 and loaded[0].times_us["JTOTAL"] > 0):
            raise AssertionError(f"(o5) the command line: rc "
                                 f"{out.returncode}\n{out.stdout[-3000:]}"
                                 f"\n{out.stderr[-3000:]}")
        emit({"phase": "cli", "cell": "o5", "seconds": cli_s,
              "report": [ln for ln in lines if ln.startswith("[")],
              "result": json.loads(lines[-1]), **card})
    return total


class _CountReadbacks:
    """Counts ``Tensor.cpu`` calls while active: the host readbacks of a
    pipelined join."""

    def __enter__(self):
        import torch
        self.calls, self._cpu = 0, torch.Tensor.cpu

        def cpu(t, *a, **kw):
            self.calls += 1
            return self._cpu(t, *a, **kw)

        torch.Tensor.cpu = cpu
        return self

    def __exit__(self, *exc):
        import torch
        torch.Tensor.cpu = self._cpu


def phase_q(dev, n, group, time_ms, device_us, card) -> dict:
    """Cell (q) on (n)'s process group ``group``: the materializing join,
    the probe API, host generation, pipelined repeats, the shuffle-overflow
    fault site and the command line's flags (see the module docstring).
    Each main path runs once with the launch counts set to 0; returns the
    launches of those runs."""
    import numpy as np
    import torch
    from tpu_radix_join_torch import HashJoin, JoinConfig, Relation
    from tpu_radix_join_torch import ops as tops
    from tpu_radix_join_torch.data.tuples import (CompressedBatch,
                                                  lane_to_numpy)
    from tpu_radix_join_torch.ops import build_probe as bp
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.ops.kernels import radix_sort as k2
    from tpu_radix_join_torch.ops.merge_count import search_bounds
    from tpu_radix_join_torch.ops.sorting import (sort_kv_unstable,
                                                  sort_lex_unstable)
    from tpu_radix_join_torch.parallel.window import Window
    from tpu_radix_join_torch.performance import Measurements
    from tpu_radix_join_torch.robustness import faults

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    total = {k: 0 for k in kernels.launch_counts()}

    def main_path(fn, needed, what):
        """``fn()`` once with the launch counts set to 0: its result; each
        kernel of ``needed`` must have launched."""
        sync()
        kernels.reset_launches()
        out = fn()
        sync()
        got = kernels.launch_counts()
        for k, v in got.items():
            total[k] += v
        for k in needed:
            if got[k] <= 0:
                raise AssertionError(f"{what}: kernel {k} did not launch")
        return out, got

    def host_ms(fn, reps=3):
        runs = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            runs.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(runs), runs

    def canon(res):
        """(s_rid, r_rid) ordered by s_rid: every outer tuple of these
        joins matches once, so this is the sorted pair list."""
        order = np.argsort(res.s_rid, kind="stable")
        return res.s_rid[order], res.r_rid[order]

    def keys_of(b):
        lo = lane_to_numpy(b.key).astype(np.uint64)
        if b.key_hi is None:
            return lo
        hi = lane_to_numpy(b.key_hi).astype(np.uint64)
        return (hi << np.uint64(32)) | lo

    core = ("histogram", "partition", "radix_histogram", "radix_pass")
    for bits in (32, 64):
        rels = (Relation(n, 1, "unique", seed=1234, key_bits=bits),
                Relation(n, 1, "unique", seed=1235, key_bits=bits))
        eng = HashJoin(JoinConfig(match_rate_cap=8, key_bits=bits), dev,
                       group=group)
        r, s = eng.place(rels[0]), eng.place(rels[1])
        name = "q1" if bits == 32 else "q2"
        res, got = main_path(lambda: eng.join_materialize_arrays(r, s),
                             core, f"({name})")
        r_keys, s_keys = keys_of(r), keys_of(s)
        if not (res.ok and res.matches == n and res.retries == 0
                and np.unique(res.s_rid).size == n
                and np.array_equal(r_keys[res.r_rid], s_keys[res.s_rid])):
            raise AssertionError(f"({name}) materializing join: "
                                 f"{res.matches} pairs, {res.diagnostics}")
        join_ms, runs = host_ms(lambda: eng.join_materialize_arrays(r, s))
        busy_ms = (sum(device_us(lambda: eng.join_materialize_arrays(r, s),
                                 3).values()) / 1e3 if cuda else None)
        # where the time goes: each stage alone on the receive buffers
        plan = eng._shuffle_plan(r, s)
        cap_r, cap_s, _ = eng._measure_capacities(r, s, plan)
        win_r = Window(eng.world, cap_r, "inner")
        win_s = Window(eng.world, cap_s, "outer")
        sh = eng._shuffle(r, s, plan, win_r, win_s)
        rb, sb = sh.rp.batch, sh.sp.batch
        mm = bp.probe_materialize(CompressedBatch(rb.key, rb.rid, rb.key_hi),
                                  CompressedBatch(sb.key, sb.rid, sb.key_hi),
                                  8)
        stages = {"shuffle": lambda: eng._shuffle(r, s, plan, win_r, win_s),
                  "compaction_readback": lambda: eng._gather_pairs(mm)}
        if bits == 32:
            r_sorted, r_rid_sorted = sort_kv_unstable(rb.key, rb.rid)
            lo, hi = search_bounds(r_sorted, sb.key)
            stages.update({
                "inner_sort": lambda: sort_kv_unstable(rb.key, rb.rid),
                "searchsorted": lambda: search_bounds(r_sorted, sb.key),
                "gather": lambda: bp._rows(r_rid_sorted, lo, hi, 8)})
            lanes = (rb.key, rb.rid)
            sorted_on_card = k2.radix_sort(lanes, num_keys=1)
            sorted_plain = k2.radix_sort_plain(list(lanes), num_keys=1)
        else:
            inner_c = CompressedBatch(rb.key, rb.rid, rb.key_hi)
            outer_c = CompressedBatch(sb.key, sb.rid, sb.key_hi)
            _, _, r_rid_sorted = sort_lex_unstable(rb.key_hi, rb.key, rb.rid,
                                                   num_keys=2)
            tag, base, c_r, _ = bp._wide_union_scan(inner_c, outer_c,
                                                   sb.rid)
            stages.update({
                "inner_sort": lambda: sort_lex_unstable(
                    rb.key_hi, rb.key, rb.rid, num_keys=2),
                "union_sort_scan": lambda: bp._wide_union_scan(
                    inner_c, outer_c, sb.rid),
                "gather": lambda: bp._rows(r_rid_sorted, base, c_r, 8,
                                           tag == 1)})
            lanes = (torch.cat([rb.key_hi, sb.key_hi]),
                     torch.cat([rb.key, sb.key]),
                     torch.cat([torch.zeros_like(rb.key),
                                torch.ones_like(sb.key)]),
                     torch.cat([torch.full_like(rb.rid, -1), sb.rid]))
            sorted_on_card = k2.radix_sort(lanes, num_keys=2)
            sorted_plain = k2.radix_sort_plain(list(lanes), num_keys=2)
        # K2 at this path's own sort shape, against its plain version
        if not all(torch.equal(a, b)
                   for a, b in zip(sorted_on_card, sorted_plain)):
            raise AssertionError(f"({name}) K2 at {len(lanes)} lanes of "
                                 f"{lanes[0].numel()} differs from its plain "
                                 "version")
        del sorted_on_card, sorted_plain
        stage_ms = {k: time_ms(f, 5) for k, f in stages.items()}
        emit({"phase": "join_time", "cell": name,
              "workload": f"{name}_materialize_unique_20M_{bits}bit",
              "join_ms": join_ms, "join_runs_ms": runs,
              "pairs": res.matches, "pairs_per_s": res.matches / join_ms * 1e3,
              "device_busy_ms": busy_ms,
              "idle_share": None if busy_ms is None else 1 - busy_ms / join_ms,
              "caps": [cap_r, cap_s], "rows": int(mm.valid.shape[0]),
              "launches": got, "k2_plain_equal_lanes": len(lanes), **card})
        emit({"phase": "breakdown", "workload": name, "stage_ms": stage_ms,
              "join_ms": join_ms, **card})
        del mm, sh, stages, lanes
        if cuda:
            torch.cuda.empty_cache()
        # (q3) the chunked form, equal to the resident one
        eng_c = HashJoin(JoinConfig(match_rate_cap=8, key_bits=bits,
                                    chunk_size=Q3_CHUNK), dev, group=group)
        res_c, got_c = main_path(lambda: eng_c.join_materialize_arrays(r, s),
                                 core, f"(q3) {bits}-bit")
        if not (res_c.ok and res_c.matches == n
                and all(np.array_equal(a, b)
                        for a, b in zip(canon(res_c), canon(res)))):
            raise AssertionError(f"(q3) {bits}-bit chunked: {res_c.matches}"
                                 f" pairs, {res_c.diagnostics}")
        chunk_ms, chunk_runs = host_ms(
            lambda: eng_c.join_materialize_arrays(r, s))
        emit({"phase": "join_time", "cell": "q3",
              "workload": f"q3_materialize_chunked_20M_{bits}bit",
              "chunk_size": Q3_CHUNK, "join_ms": chunk_ms,
              "join_runs_ms": chunk_runs, "resident_join_ms": join_ms,
              "launches": got_c, **card})
        del res_c
        if bits == 32:
            # the probe API on the relations themselves (one device)
            tb = CompressedBatch(r.key, r.rid)
            ub = CompressedBatch(s.key, s.rid)
            api = {
                "probe_count": lambda: tops.probe_count(tb, ub),
                "local_join_sorted": lambda: tops.local_join_sorted(r, s),
                "local_join_merge": lambda: tops.local_join_merge(r, s),
                # 32 partitions of about 3% of n each: the next power of
                # two above 5% of n (2**20 at 20M)
                "local_join_partitioned": lambda: tops.local_join_partitioned(
                    r, s, 5, 1 << (n // 20).bit_length()),
            }
            needs = {"probe_count": ("radix_histogram", "radix_pass"),
                     "local_join_sorted": ("radix_histogram", "radix_pass"),
                     "local_join_merge": ("radix_pass", "merge_scan_chunks"),
                     "local_join_partitioned": ("partition", "radix_pass")}
            api_out = {}
            for k, fn in api.items():
                out, got_api = main_path(fn, needs[k], f"(q) {k}")
                counts = out[0] if k == "local_join_partitioned" else out
                total_pairs = int(lane_to_numpy(
                    counts.reshape(-1)).astype(np.uint64).sum())
                if total_pairs != n or (
                        k == "local_join_partitioned" and int(out[1])):
                    raise AssertionError(f"(q) {k}: {total_pairs} matches")
                api_out[k] = {"ms": time_ms(fn, 5), "launches": got_api}
            emit({"phase": "probe_api", "cell": "q", "tuples": n,
                  "calls": api_out, **card})
        else:
            # the 64-bit probe_count through the union scan
            out, got_api = main_path(lambda: tops.probe_count(
                CompressedBatch(r.key, r.rid, r.key_hi),
                CompressedBatch(s.key, s.rid, s.key_hi)),
                ("radix_histogram", "radix_pass"), "(q) probe_count 64-bit")
            if int(lane_to_numpy(out.reshape(1))[0]) != n:
                raise AssertionError("(q) 64-bit probe_count")
        del r, s, eng, eng_c
        if cuda:
            torch.cuda.empty_cache()

    # (q4) the rate-cap retry: each inner key twice, a cap of one
    inner = Relation(Q4_TUPLES, 1, "modulo", seed=1234, modulo=Q4_TUPLES // 2)
    outer = Relation(Q4_TUPLES, 1, "unique", seed=1235)
    for retries in (1, 0):
        eng = HashJoin(JoinConfig(match_rate_cap=1, max_retries=retries),
                       dev, group=group)
        res, got = main_path(lambda: eng.join_materialize(inner, outer), core,
                             f"(q4) max_retries={retries}")
        ok = (res.ok and res.retries == 1 and res.matches == Q4_TUPLES
              if retries else
              not res.ok and res.diagnostics["local_overflow"]
              == Q4_TUPLES // 2
              and res.diagnostics["failure_class"] == "capacity_overflow")
        if not ok:
            raise AssertionError(f"(q4) max_retries={retries}: "
                                 f"{res.matches} pairs, {res.retries} "
                                 f"retries, {res.diagnostics}")
        emit({"phase": "join", "cell": "q4", "max_retries": retries,
              "matches": res.matches, "ok": res.ok, "retries": res.retries,
              "diagnostics": res.diagnostics, "launches": got, **card})

    # (q5) host generation, bit-equal to the card's
    gen = {}
    for kind, kw in (("unique", {}), ("modulo", {"modulo": 65536}),
                     ("zipf", {"zipf_theta": 0.75}),
                     ("unique_64", {"key_bits": 64})):
        rel = Relation(n, 1, kind.split("_")[0], seed=1235, **kw)
        bits = rel.key_bits
        t0 = time.perf_counter()
        host = HashJoin(JoinConfig(generation="host", key_bits=bits),
                        dev).place(rel)
        host_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        card_b = HashJoin(JoinConfig(key_bits=bits), dev).place(rel)
        card_s = time.perf_counter() - t0
        if not all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(host, card_b)):
            raise AssertionError(f"(q5) {kind}: host generation differs "
                                 "from the card's")
        gen[kind] = {"host_s": host_s, "device_s": card_s}
        del host, card_b
    emit({"phase": "generation", "cell": "q5", "tuples": n, "kinds": gen,
          **card})

    # (q6) pipelined repeats on (a)'s relations: one readback, five joins
    rels = (Relation(n, 1, "unique", seed=1234),
            Relation(n, 1, "unique", seed=1235))
    bound = max(x.key_bound() for x in rels)
    meas = Measurements()
    eng = HashJoin(JoinConfig(), dev, measurements=meas)
    r, s = eng.place(rels[0]), eng.place(rels[1])
    with _CountReadbacks() as reads:
        res, got = main_path(lambda: eng.join_arrays(r, s, key_bound=bound,
                                                     repeats=5),
                             ("radix_histogram", "radix_pass", "merge_scan"),
                             "(q6)")
    if not (res.ok and res.matches == n and reads.calls == 1
            and meas.counters["RESULTS"] == 5 * n
            and got["merge_scan"] == 5):
        raise AssertionError(f"(q6) repeats: {res}, {reads.calls} "
                             f"readbacks, {dict(meas.counters)}, {got}")
    plain = HashJoin(JoinConfig(), dev)
    pipe_ms, pipe_runs = host_ms(lambda: plain.join_arrays(
        r, s, key_bound=bound, repeats=5))
    sync_ms, sync_runs = host_ms(lambda: [plain.join_arrays(
        r, s, key_bound=bound) for _ in range(5)])
    emit({"phase": "join_time", "cell": "q6", "repeats": 5,
          "pipelined_ms_per_join": pipe_ms / 5,
          "synchronous_ms_per_join": sync_ms / 5,
          "pipelined_runs_ms": pipe_runs, "synchronous_runs_ms": sync_runs,
          "readbacks": reads.calls, "launches": got, **card})

    # (q7) the shuffle-overflow fault site, armed once
    meas = Measurements()
    eng = HashJoin(JoinConfig(max_retries=1, retry_backoff_s=0.001), dev,
                   measurements=meas)
    with faults.FaultInjector(seed=7).arm(faults.SHUFFLE_OVERFLOW, at=1):
        res, got = main_path(lambda: eng.join_arrays(r, s, key_bound=bound),
                             ("radix_pass", "merge_scan"), "(q7)")
    events = [e["event"] for e in meas.meta.get("events", [])]
    if not (res.ok and res.matches == n and res.retries == 1
            and "retry" in events and meas.counters["RETRIES"] == 1):
        raise AssertionError(f"(q7) fault site: {res}, events {events}")
    emit({"phase": "fault", "cell": "q7", "retries": res.retries,
          "events": events, "fault_sites": res.diagnostics["fault_sites"],
          "launches": got, **card})
    del r, s

    # (q8) the command line's flags
    root = os.path.dirname(os.path.abspath(__file__))
    cli = {}
    for flags in (["--debug-checks", "--probe", "bucket"],
                  ["--generation", "host"],
                  ["--pipeline-repeats", "--repeat", "3"]):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "tpu_radix_join_torch.main",
             "--tuples-per-node", str(n), *flags, *Q8_EXTRA], cwd=root,
            capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=root), timeout=600)
        lines = out.stdout.splitlines()
        result = json.loads(lines[-1]) if out.returncode == 0 else {}
        if not (out.returncode == 0 and result.get("ok")
                and result.get("matches") == n
                and f"[RESULTS] Expected: {n} (OK)" in lines):
            raise AssertionError(f"(q8) {' '.join(flags)}: rc "
                                 f"{out.returncode}\n{out.stdout[-3000:]}"
                                 f"\n{out.stderr[-3000:]}")
        cli[" ".join(flags)] = {"seconds": time.perf_counter() - t0,
                                "join_ms": result["join_ms"],
                                "counters": result["counters"]}
    emit({"phase": "cli", "cell": "q8", "runs": cli, **card})
    return total


def phase_n(dev, n, refs, time_ms, device_us, card) -> dict:
    """Cell (n): the generic body over a process group of one rank (NCCL
    on the card, gloo on the CPU) at ``n`` ⋈ ``n`` unique tuples a rank.
    ``refs`` maps each join to the one-rank result whose counts it must
    equal; ``time_ms(fn, reps)`` times a call, ``device_us(fn, reps)``
    gives its device time by kernel.  Each join runs once with the launch
    counts set to 0 (the main path), then 1 + 3 times for its median, then
    under the profiler (its device busy time, so the idle share of the
    median), then stage by stage.  Cell (o) (:func:`phase_o`) then runs on
    the same group.  Returns the main paths' launches, (o)'s included."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from tpu_radix_join_torch import HashJoin, JoinConfig, Relation
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.ops.kernels import merge_scan as k3
    from tpu_radix_join_torch.ops.kernels import merge_scan_wide as k5
    from tpu_radix_join_torch.ops.merge_count import (_pack_pm, _rotate_pid,
                                                      _side_tags)
    from tpu_radix_join_torch.ops.sorting import (sort_lex_unstable,
                                                  sort_unstable)
    from tpu_radix_join_torch.parallel import multihost
    from tpu_radix_join_torch.parallel.window import Window

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    multihost.initialize(init_method=f"tcp://127.0.0.1:{free_port()}",
                         world_size=1, rank=0, local_rank=dev.index or 0,
                         device=dev, timeout_s=300)
    group = dist.group.WORLD
    rels32 = (Relation(n, 1, "unique", seed=1234),
              Relation(n, 1, "unique", seed=1235))
    rels64 = (Relation(n, 1, "unique", seed=1234, key_bits=64),
              Relation(n, 1, "unique", seed=1235, key_bits=64))
    cells = {
        "n1": ("n1_bucket_unique_20M", JoinConfig(probe_algorithm="bucket"),
               rels32),
        "n2": ("n2_shuffled_narrow_unique_20M", JoinConfig(), rels32),
        "n3": ("n3_shuffled_wide_unique_20M", JoinConfig(key_bits=64),
               rels64),
        "n4": ("n4_shuffled_narrow_debug_unique_20M",
               JoinConfig(debug_checks=True), rels32),
    }
    try:
        engines = {k: HashJoin(cfg, dev, group=group)
                   for k, (_, cfg, _) in cells.items()}
        placed = {k: tuple(engines[k].place(rel) for rel in rels)
                  for k, (_, _, rels) in cells.items() if k != "n1"}
        setup_s = time.perf_counter() - t0

        def run(k, r=None, s=None):
            """(n1) through ``join`` (placing its relations) unless given
            placed lanes, the others through ``join_shuffled``."""
            rels = cells[k][2]
            bound = max(rel.key_bound() for rel in rels)
            if k == "n1":
                if r is None:
                    return engines[k].join(*rels)
                return engines[k].join_arrays(r, s, key_bound=bound)
            return engines[k].join_shuffled(*placed[k], key_bound=bound)

        sync()
        kernels.reset_launches()
        before = {k: dict(e.world.counts) for k, e in engines.items()}
        results = {k: run(k) for k in cells}
        sync()
        launches = kernels.launch_counts()
        collectives = {k: {c: e.world.counts[c] - before[k][c]
                           for c in e.world.counts}
                       for k, e in engines.items()}
        for k, res in results.items():
            ref = refs[k]
            if not (res.matches == n and res.ok and res.retries == 0
                    and np.array_equal(res.partition_counts,
                                       ref.partition_counts)):
                raise AssertionError(f"{cells[k][0]}: {res}, one rank "
                                     f"without the shuffle: {ref}")
        for k in ("n1", "n2"):
            if collectives[k]["all_to_all"] < 6:
                raise AssertionError(f"{cells[k][0]}: {collectives[k]} "
                                     "collectives")
        for name in ("histogram", "partition", "radix_histogram",
                     "radix_pass", "merge_scan", "merge_scan_wide"):
            if launches[name] <= 0:
                raise AssertionError(f"cell (n): kernel {name} did not "
                                     "launch")
        emit({"phase": "distributed", "cell": "n", "world_size": 1,
              "backend": engines["n1"].world.backend, "setup_s": setup_s,
              "launches": launches, "collectives": collectives,
              "matches": {cells[k][0]: res.matches
                          for k, res in results.items()}, **card})

        fanout = JoinConfig().network_fanout_bits
        for k, (name, cfg, rels) in cells.items():
            eng = engines[k]
            r, s = placed.get(k) or tuple(eng.place(rel) for rel in rels)
            times = []
            for _ in range(4):
                sync()
                t1 = time.perf_counter()
                run(k, r, s)
                sync()
                times.append(time.perf_counter() - t1)
            join_ms = statistics.median(times[1:]) * 1e3
            by_kernel = device_us(lambda: run(k, r, s), 3)
            busy_ms = sum(by_kernel.values()) / 1e3
            plan = eng._shuffle_plan(r, s)
            cap_r, cap_s, _ = eng._measure_capacities(r, s, plan)
            win_r = Window(eng.world, cap_r, "inner")
            win_s = Window(eng.world, cap_s, "outer")
            rp, sp, lost_r, lost_s, *_ = eng._shuffle(r, s, plan, win_r,
                                                     win_s)
            lane = rp.batch.key
            small = torch.zeros((2, 32), dtype=torch.int64, device=dev)
            stages = {
                "sizing": lambda: eng._measure_capacities(
                    r, s, eng._shuffle_plan(r, s)),
                "exchange": lambda: eng._shuffle(r, s, plan, win_r, win_s),
                "nccl_all_to_all_one_lane": lambda: eng.world.all_to_all(
                    lane, cap_r),
                "nccl_all_reduce_2x32": lambda: eng.world.all_reduce(
                    small, op="max"),
                "nccl_all_gather_32": lambda: eng.world.all_gather(small[0]),
            }
            if k == "n1":
                stages["local_process"] = lambda: eng._local_process(
                    rp, sp, cap_r, cap_s, 1)
            elif k == "n3":
                lanes = [torch.cat([_rotate_pid(rp.batch.key, fanout),
                                    _rotate_pid(sp.batch.key, fanout)]),
                         torch.cat([rp.batch.key_hi, sp.batch.key_hi]),
                         _side_tags(rp.batch.key, sp.batch.key)]
                ordered = sort_lex_unstable(*lanes, num_keys=2)
                stages.update({
                    "rotate_concat": lambda: (
                        _rotate_pid(rp.batch.key, fanout),
                        _rotate_pid(sp.batch.key, fanout)),
                    "sort": lambda: sort_lex_unstable(*lanes, num_keys=2),
                    "scan": lambda: k5.merge_scan_partitions_wide(
                        *ordered, num_partitions=1 << fanout)})
            else:
                packed = _pack_pm(rp.batch.key, sp.batch.key, fanout)
                ordered = sort_unstable(packed)
                stages.update({
                    "pack": lambda: _pack_pm(rp.batch.key, sp.batch.key,
                                             fanout),
                    "sort": lambda: sort_unstable(packed),
                    "scan": lambda: k3.merge_scan_partitions(
                        ordered, num_partitions=1 << fanout)})
                if k == "n4":
                    stages["debug_checks"] = lambda: eng._debug_checks(
                        rp, sp, plan, lost_r, lost_s)
            stage_ms = {st: time_ms(f, 5) for st, f in stages.items()}
            emit({"phase": "join_time", "workload": name, "join_ms": join_ms,
                  "join_runs_ms": [t * 1e3 for t in times],
                  "tuples_per_s": 2 * n / join_ms * 1e3,
                  "device_busy_ms": busy_ms,
                  "idle_share": 1 - busy_ms / join_ms,
                  "device_us_by_kernel": dict(sorted(
                      by_kernel.items(), key=lambda kv: -kv[1])[:12]),
                  "caps": [cap_r, cap_s],
                  "union_positions": rp.batch.key.numel()
                  + sp.batch.key.numel(),
                  "pad_share": 1 - 2 * n / (rp.batch.key.numel()
                                            + sp.batch.key.numel()),
                  "nccl_lane_bytes": 4 * cap_r, **card})
            emit({"phase": "breakdown", "workload": name,
                  "stage_ms": stage_ms, "join_ms": join_ms, **card})
        torch.cuda.empty_cache()
        launches_o = phase_o(dev, n, group, rels32, rels64,
                             {k: placed[k] for k in ("n2", "n3")},
                             {k: results[k] for k in ("n2", "n3")},
                             time_ms, device_us, card)
        launches = {k: v + launches_o[k] for k, v in launches.items()}
        del placed, engines
        torch.cuda.empty_cache()
        launches_q = phase_q(dev, n, group, time_ms, device_us, card)
        launches = {k: v + launches_q[k] for k, v in launches.items()}
        torch.cuda.empty_cache()
        launches_r = phase_r(dev, n, group, time_ms, card)
        launches = {k: v + launches_r[k] for k, v in launches.items()}
        torch.cuda.empty_cache()
        launches_s = phase_s(dev, n, group, card)
        launches = {k: v + launches_s[k] for k, v in launches.items()}
    finally:
        multihost.shutdown()
    return launches


def phase_r(dev, n, group, time_ms, card) -> dict:
    """Cell (r) on (n)'s process group ``group`` (ROADMAP A13, A15): the
    packed wire codec (r1) and the checksums (r2) on the card against the
    same calls on the CPU, and the verified bucket join (r3).  Each main
    path runs once with the launch counts set to 0; returns their
    launches."""
    import contextlib
    import dataclasses
    import torch
    from tpu_radix_join_torch import HashJoin, JoinConfig, Relation
    from tpu_radix_join_torch.data import tuples as tt
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.ops.radix import scatter_to_blocks_grouped
    from tpu_radix_join_torch.ops.sorting import segmented_xor_fold
    from tpu_radix_join_torch.performance import Measurements
    from tpu_radix_join_torch.robustness import faults
    from tpu_radix_join_torch.robustness.verify import (
        device_partition_checksums)

    cuda = dev.type == "cuda"
    cpu = torch.device("cpu")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    total = {k: 0 for k in kernels.launch_counts()}

    def main_path(fn, needed, what):
        """``fn()`` once with the launch counts set to 0: its result; each
        kernel of ``needed`` must have launched."""
        sync()
        kernels.reset_launches()
        out = fn()
        sync()
        got = kernels.launch_counts()
        for k, v in got.items():
            total[k] += v
        for k in needed:
            if got[k] <= 0:
                raise AssertionError(f"{what}: kernel {k} did not launch")
        return out, got

    def same(got, want, what):
        for a, b in zip(got, want):
            if (a is None) != (b is None) or (
                    a is not None and not torch.equal(a.cpu(), b.cpu())):
                raise AssertionError(f"{what}: the card differs from the CPU")

    def on_cpu(b):
        return tt.TupleBatch(*(None if x is None else x.cpu() for x in b))

    # (r1) the codec at the shape of phase (p)'s exchange: rank 0's shard of
    # the unique 4-rank relation, grouped by (round-robin rank, pid) into
    # four blocks of the capacity the 20M-a-rank join sizes (K4's grouped
    # mode), packed, unpacked
    codec = {}
    fanout = JoinConfig().network_fanout_bits
    for key_bits in (32, 64):
        rel = Relation(R1_BLOCKS * n, R1_BLOCKS, "unique", seed=1234,
                       key_bits=key_bits)
        b = rel.shard(0, dev)
        pid = tt.partition_ids(b, fanout)
        dest = torch.remainder(pid, R1_BLOCKS)
        grouped, launches = main_path(
            lambda: scatter_to_blocks_grouped(b, dest, pid, R1_BLOCKS,
                                              1 << fanout, R1_CAPACITY,
                                              "outer"),
            ["partition"], f"(r1) grouped scatter, {key_bits}-bit keys")
        blocks, counts, gcounts, _ = grouped
        plain = scatter_to_blocks_grouped(on_cpu(b), dest.cpu(), pid.cpu(),
                                          R1_BLOCKS, 1 << fanout, R1_CAPACITY,
                                          "outer")
        same([*blocks, counts, gcounts], [*plain[0], plain[1], plain[2]],
             f"(r1) grouped scatter, {key_bits}-bit keys")
        measured = int(tt.umax(b.key)) + 1
        if b.key_hi is not None:
            measured = (int(tt.umax(b.key_hi)) << 32) + measured
        for bound, kb, rb in (("tight", measured, rel.global_size),
                              ("none", None, None)):
            spec = tt.make_wire_spec(R1_CAPACITY, fanout,
                                     wide=key_bits == 64, key_bound=kb,
                                     rid_bound=rb)
            words = tt.pack_blocks(spec, blocks, gcounts)
            same([words], [tt.pack_blocks(spec, on_cpu(blocks),
                                          gcounts.cpu())],
                 f"(r1) packed words, {key_bits}-bit keys, bound {bound}")
            back, got_counts = tt.unpack_blocks(spec, words, "outer")
            same([*back, got_counts], [*blocks, tt.narrow(torch.clamp(
                tt.widen(counts), max=R1_CAPACITY))],
                 f"(r1) round trip, {key_bits}-bit keys, bound {bound}")
            slots = R1_BLOCKS * R1_CAPACITY
            lanes = 3 if key_bits == 64 else 2
            codec[f"{key_bits}_{bound}"] = {
                "tuple_bits": spec.tuple_bits,
                "bytes_per_tuple": spec.bytes_per_tuple,
                "words": words.numel(), "slots": slots,
                "pack_ms": time_ms(lambda: tt.pack_blocks(spec, blocks,
                                                          gcounts), 5),
                "unpack_ms": time_ms(lambda: tt.unpack_blocks(
                    spec, words, "outer"), 5),
                # lanes read once and words written once, and the reverse
                "pack_bound_ms": (4 * lanes * slots + 4 * words.numel())
                / 3.35e12 * 1e3,
                "grouped_scatter_ms": time_ms(
                    lambda: scatter_to_blocks_grouped(
                        b, dest, pid, R1_BLOCKS, 1 << fanout, R1_CAPACITY,
                        "outer"), 5)}
            del words, back
        codec[f"{key_bits}_launches"] = launches
        del b, pid, dest, grouped, blocks, plain
        torch.cuda.empty_cache()
    emit({"phase": "codec", "cell": "r1", "blocks": R1_BLOCKS,
          "capacity": R1_CAPACITY, "fanout_bits": fanout, "exact": True,
          "cases": codec, **card})

    # (r2) the checksums at 20M: a tenth of the slots invalid (the
    # discard bucket), the key lane folded by partition
    b = Relation(n, 1, "unique", seed=1234).shard(0, dev)
    pid = tt.partition_ids(b, fanout)
    valid = torch.remainder(b.rid, 10) != 0
    seg = torch.where(valid, pid, 1 << fanout)
    fold, launches_f = main_path(
        lambda: segmented_xor_fold(seg, b.key, 1 << fanout),
        ["radix_histogram", "radix_pass"], "(r2) segmented_xor_fold")
    same([fold], [segmented_xor_fold(seg.cpu(), b.key.cpu(), 1 << fanout)],
         "(r2) segmented_xor_fold")
    sums, launches_c = main_path(
        lambda: device_partition_checksums(b.key, pid, 1 << fanout,
                                           valid=valid),
        ["histogram", "radix_pass"], "(r2) device_partition_checksums")
    same(sums, device_partition_checksums(b.key.cpu(), pid.cpu(),
                                          1 << fanout, valid=valid.cpu()),
         "(r2) device_partition_checksums")
    emit({"phase": "checksums", "cell": "r2", "elements": n, "exact": True,
          "xor_fold_ms": time_ms(lambda: segmented_xor_fold(
              seg, b.key, 1 << fanout), 5),
          "checksums_ms": time_ms(lambda: device_partition_checksums(
              b.key, pid, 1 << fanout, valid=valid), 5),
          "launches": {"xor_fold": launches_f, "checksums": launches_c},
          **card})
    del b, pid, valid, seg
    torch.cuda.empty_cache()

    # (r3) the verified bucket join of (n1): clean, the fault caught, the
    # fault repaired
    rels = (Relation(n, 1, "unique", seed=1234),
            Relation(n, 1, "unique", seed=1235))
    bound = max(rel.key_bound() for rel in rels)
    base = JoinConfig(probe_algorithm="bucket")
    r, s = (HashJoin(base, dev, group=group).place(rel) for rel in rels)
    verified = {}
    needed = ["histogram", "partition", "radix_histogram", "radix_pass"]
    for case, mode, fault in (("clean", "check", False),
                              ("caught", "check", True),
                              ("repaired", "repair", True)):
        meas = Measurements()
        eng = HashJoin(dataclasses.replace(base, verify=mode), dev,
                       group=group, measurements=meas)
        inj = faults.FaultInjector()
        inj.arm(faults.EXCHANGE_CORRUPT, at=1)
        with inj if fault else contextlib.nullcontext():
            res, launches = main_path(
                lambda: eng.join_arrays(r, s, key_bound=bound),
                needed + (["merge_scan_chunks"] if mode == "repair" else []),
                f"(r3) verify={mode}, {case}")
        diag = res.diagnostics
        c = meas.counters
        if case == "clean":
            good = (res.ok and res.matches == n and c.get("VCHKN") == 4
                    and not c.get("VFAIL"))
        elif case == "caught":
            good = (not res.ok and res.matches < n
                    and diag["failure_class"] == "data_corruption"
                    and diag["data_corruption_partitions"] == 1
                    and c.get("VFAIL") == 1)
        else:
            good = (res.ok and res.matches == n
                    and diag.get("repaired") == "full"
                    and c.get("VREPAIR") == 1
                    and diag["failure_class"] == "data_corruption")
        if not good:
            raise AssertionError(f"(r3) verify={mode}, {case}: {res}, "
                                 f"counters {c}")
        verified[case] = {"matches": res.matches, "ok": res.ok,
                          "diagnostics": diag, "launches": launches,
                          "counters": {k: c.get(k) for k in (
                              "VCHKN", "VFAIL", "VREPAIR")}}
    # VCHK beside JTOTAL: the median of three verified joins, each with a
    # fresh registry, and the same join unverified
    timed = {}
    for mode in ("off", "check"):
        runs = []
        for _ in range(4):
            meas = Measurements()
            eng = HashJoin(dataclasses.replace(base, verify=mode), dev,
                           group=group, measurements=meas)
            eng.join_arrays(r, s, key_bound=bound)
            runs.append({k: meas.times_us.get(k, 0.0) / 1e3
                         for k in ("JTOTAL", "VCHK")})
        runs = runs[1:]
        timed[mode] = {k: statistics.median(x[k] for x in runs)
                       for k in ("JTOTAL", "VCHK")}
        timed[mode]["runs"] = runs
    emit({"phase": "verify", "cell": "r3", "workload":
          "n1_bucket_unique_20M", "cases": verified,
          "jtotal_ms": timed["check"]["JTOTAL"],
          "vchk_ms": timed["check"]["VCHK"],
          "unverified_jtotal_ms": timed["off"]["JTOTAL"],
          "overhead_share": timed["check"]["JTOTAL"]
          / timed["off"]["JTOTAL"] - 1, "runs": timed, **card})
    return total


#: phase (s): the batch's tuples a node, the Δ a node of the delta chain,
#: the breaker's tuples, the resident budget (MiB) and the deadline of the
#: query that must miss it; (s3)'s delta base a rank
S_BATCH_TUPLES = 1 << 20
S_DELTA_TUPLES = 1 << 16
S_BREAKER_TUPLES = 1 << 16
S_RESIDENT_MB = 1024
S_DEADLINE_S = 0.001
S3_DELTA_BASE = 1 << 20
#: arguments phase (s) adds to its command line (none on the card)
S_CLI_EXTRA = ()


def phase_s(dev, n, group, card) -> dict:
    """Cell (s), on (n)'s NCCL group of one rank (phase_s, called by
    phase_n after (r)): the resident join service (ROADMAP A16).

    (s1) One ``JoinSession`` (``probe_algorithm="bucket"``, a result cache
    of 8, a 50 ms batch window of 4, 1024 MiB resident) at ``n`` tuples a
    node, unique ⋈ unique: q0 cold, q1 and q2 warm (no JHIST), q3 a repeat
    of q0 from the cache; four queries of one signature at 2**20 through
    ``run_next_batch`` (one fused program, K2); the delta chain (the base,
    then three Δ of 2**16: ``delta_merge``, each count the host oracle's);
    a query whose 1 ms deadline passes, then one that is served; a second
    session of queue depth 2 rejecting a third submission.  Each query runs
    with the launch counts set to 0 and read after.  The same four queries
    at 2**20 served solo by a plain session time the batch against them.
    Then ``python -m tpu_radix_join_torch.main --serve FILE`` runs q0-q3 and
    the deadline pair as a subprocess.
    (s2) The breaker at 2**16: ``backend.dispatch`` armed three times
    trips it, one query is served by the degraded CPU engine (no kernel
    launched), the half-open probe closes it (the card's kernels again).
    Prints each query's latency, served_by and launches, and the SLO p50
    and p99.  No degraded engine and no ``batch_fallback`` outside (s2).
    Returns the launches of every query."""
    import tempfile
    import torch
    from tpu_radix_join_torch import JoinConfig
    from tpu_radix_join_torch.core.config import ServiceConfig
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.performance import Measurements
    from tpu_radix_join_torch.robustness import faults
    from tpu_radix_join_torch.service import (AdmissionRejected, JoinSession,
                                              QueryRequest)

    cuda = dev.type == "cuda"
    total = {k: 0 for k in kernels.launch_counts()}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def launched(fn):
        """``fn()`` with the launch counts set to 0: (its result, the
        kernels it launched)."""
        sync()
        kernels.reset_launches()
        out = fn()
        sync()
        got = kernels.launch_counts()
        for k, v in got.items():
            total[k] += v
        return out, got

    def serve(sess, qid, **kw):
        kw.setdefault("tuples_per_node", n)
        kw.setdefault("seed", 1234)

        def one():
            sess.submit(QueryRequest(query_id=qid, **kw))
            return sess.run_next()
        return launched(one)

    lines = []

    def record(cell, out, got):
        line = {"phase": "serve", "cell": cell, **out.to_json(),
                "launches": {k: v for k, v in got.items() if v}}
        lines.append(line)
        emit(dict(line, **card))

    def need(cell, out, got, names, **want):
        for k, v in want.items():
            if getattr(out, k) != v:
                raise AssertionError(f"({cell}) {out.query_id}: {k} "
                                     f"{getattr(out, k)!r}, not {v!r}: "
                                     f"{out}")
        if out.matches != out.expected:
            raise AssertionError(f"({cell}) {out.query_id}: {out.matches} "
                                 f"matches, the oracle {out.expected}")
        for k in names:
            if got[k] <= 0:
                raise AssertionError(f"({cell}) {out.query_id}: kernel {k} "
                                     "did not launch")
        if names == () and any(got.values()):
            raise AssertionError(f"({cell}) {out.query_id}: launched "
                                 f"{got}")

    # ------------------------------------------------------------- (s1)
    meas = Measurements()
    svc = ServiceConfig(result_cache_max=8, batch_window_ms=50.0,
                        batch_max_queries=4,
                        resident_budget_bytes=S_RESIDENT_MB << 20)
    sess = JoinSession(JoinConfig(probe_algorithm="bucket"), svc,
                       measurements=meas, device=dev, group=group)
    bucket = ("histogram", "partition", "radix_histogram", "radix_pass")
    try:
        jhist = []
        for i in range(3):
            out, got = serve(sess, f"q{i}", seed=1234 + 2 * i)
            jhist.append(meas.times_us.get("JHIST", 0.0))
            record("s1", out, got)
            need("s1", out, got, bucket, status="ok", served_by="execute",
                 warm=i > 0, matches=n)
        if not (jhist[0] > 0 and jhist[1] == jhist[0] == jhist[2]):
            raise AssertionError(f"(s1) JHIST after q0-q2: {jhist}")
        out, got = launched(lambda: sess.try_cache(
            QueryRequest(query_id="q3", tuples_per_node=n, seed=1234)))
        record("s1", out, got)
        need("s1", out, got, (), status="ok", served_by="cache_hit",
             matches=n)
        # four queries of one signature through one fused program
        nb = S_BATCH_TUPLES
        batch_reqs = [QueryRequest(query_id=f"b{i}", tuples_per_node=nb,
                                   seed=100 + i) for i in range(4)]
        for req in batch_reqs:
            sess.submit(req)
        outs, got = launched(sess.run_next_batch)
        for out in outs:
            record("s1", out, got)
            need("s1", out, got, ("radix_histogram", "radix_pass"),
                 status="ok", served_by="batched", matches=nb)
        if (len(outs) != 4 or meas.counters.get("BATCHN") != 1
                or meas.counters.get("BATCHQ") != 4):
            raise AssertionError(f"(s1) batch: {len(outs)} outcomes, "
                                 f"{dict(meas.counters)}")
        batch_ms = outs[0].latency_ms
        # the delta chain: the base, then three Δ merged on the device
        delta_ms = []
        for i in range(4):
            out, got = serve(sess, f"d{i}", seed=4321,
                             delta_tuples_per_node=S_DELTA_TUPLES)
            record("s1", out, got)
            need("s1", out, got, ("radix_histogram", "radix_pass"),
                 status="ok", served_by="delta_merge" if i else "execute",
                 matches=n)
            delta_ms.append(out.latency_ms)
        if meas.counters.get("DELTAMERGE") != 3:
            raise AssertionError(f"(s1) DELTAMERGE "
                                 f"{meas.counters.get('DELTAMERGE')}")
        out, got = serve(sess, "deadline", seed=999,
                         deadline_s=S_DEADLINE_S)
        record("s1", out, got)
        if (out.status, out.failure_class) != ("failed",
                                               "deadline_exceeded"):
            raise AssertionError(f"(s1) the 1 ms deadline: {out}")
        out, got = serve(sess, "after", seed=1001)
        record("s1", out, got)
        need("s1", out, got, bucket, status="ok", served_by="execute")
        summary = sess.summary()
        events = [e["event"] for e in meas.meta.get("events", [])]
    finally:
        sess.close()
    if "degrade" in events or "batch_fallback" in events:
        raise AssertionError(f"(s1) left the device: {events}")
    # admission: queue depth 2, three submitted before the drain
    small = JoinSession(JoinConfig(), ServiceConfig(max_queue_depth=2),
                        measurements=Measurements(), device=dev, group=group)
    try:
        rejected = []
        for i in range(3):
            req = QueryRequest(query_id=f"a{i}",
                               tuples_per_node=S_BREAKER_TUPLES, seed=i)
            try:
                small.submit(req)
            except AdmissionRejected as e:
                rejected.append(small.rejection_outcome(req, e))
        served, got = launched(small.drain)
        for out in rejected:
            record("s1", out, {})
        for out in served:
            record("s1", out, got)
        if ([o.failure_class for o in rejected] != ["admission_rejected"]
                or "queue_full" not in rejected[0].detail
                or [o.status for o in served] != ["ok", "ok"]):
            raise AssertionError(f"(s1) admission: {rejected} {served}")
    finally:
        small.close()
    # the same four batch queries served solo by a plain session
    solo = JoinSession(JoinConfig(), ServiceConfig(),
                       measurements=Measurements(), device=dev, group=group)
    try:
        solo_ms = []
        for req in batch_reqs:
            out, got = launched(lambda req=req: (solo.submit(req),
                                                 solo.run_next())[1])
            need("s1", out, got, ("radix_pass", "merge_scan"), status="ok",
                 served_by="execute")
            solo_ms.append(out.latency_ms)
    finally:
        solo.close()
    executed = [ln["latency_ms"] for ln in lines
                if ln["query_id"] in ("q1", "q2")]
    emit({"phase": "serve_summary", "cell": "s1", "tuples_per_node": n,
          "slo_p50_ms": summary["slo_p50_ms"],
          "slo_p99_ms": summary["slo_p99_ms"],
          "summary": summary, "delta_ms": delta_ms[1:],
          "delta_cold_ms": delta_ms[0], "warm_execute_ms": executed,
          "batch_of_4_ms": batch_ms, "solo_ms": solo_ms,
          "solo_sum_ms": sum(solo_ms), **card})

    # the command line, as a subprocess (its kernels were built above)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_s_") as tmp:
        path = os.path.join(tmp, "requests.jsonl")
        reqs = [{"query_id": f"q{i}", "tuples_per_node": n,
                 "seed": 1234 + 2 * i} for i in range(3)]
        reqs += [{"query_id": "q3", "tuples_per_node": n, "seed": 1234},
                 {"query_id": "deadline", "tuples_per_node": n, "seed": 999,
                  "deadline_s": S_DEADLINE_S},
                 {"query_id": "after", "tuples_per_node": n, "seed": 1001}]
        with open(path, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in reqs))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_radix_join_torch.main", "--serve",
             path, "--probe", "bucket", "--result-cache", "8",
             *S_CLI_EXTRA],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
    recs = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]
    outs = {r["query_id"]: r for r in recs if r.get("event") == "outcome"}
    cli_summary = next((r for r in recs if r.get("event") == "summary"), {})
    want = {"q0": ("ok", "execute", False), "q1": ("ok", "execute", True),
            "q2": ("ok", "execute", True), "q3": ("ok", "cache_hit", True),
            "deadline": ("failed", "execute", False),
            "after": ("ok", "execute", True)}
    got_cli = {q: (o["status"], o["served_by"], o["warm"])
               for q, o in outs.items()}
    # one failed query (the deadline) makes the run's exit code 1
    if (proc.returncode != 1 or got_cli != want
            or outs["deadline"]["failure_class"] != "deadline_exceeded"
            or any(outs[q]["matches"] != n for q in ("q0", "q1", "q3"))):
        raise AssertionError(f"(s1) --serve exited {proc.returncode}: "
                             f"{got_cli}\n{proc.stderr[-3000:]}")
    emit({"phase": "serve_cli", "cell": "s1", "seconds": cli_s,
          "latency_ms": {q: o["latency_ms"] for q, o in outs.items()},
          "slo_p50_ms": cli_summary.get("slo_p50_ms"),
          "slo_p99_ms": cli_summary.get("slo_p99_ms"),
          "warm_queries": cli_summary.get("warm_queries"), **card})

    # ------------------------------------------------------------- (s2)
    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clock = Clock()
    meas = Measurements()
    sess = JoinSession(JoinConfig(), ServiceConfig(breaker_threshold=3,
                                                   breaker_cooldown_s=60.0),
                       measurements=meas, clock=clock, device=dev,
                       group=group)
    inj = faults.FaultInjector(seed=15)
    inj.arm(faults.BACKEND_DISPATCH, at=(1, 2, 3))
    try:
        outs = []
        with inj:
            for i in range(4):
                out, got = serve(sess, f"brk{i}",
                                 tuples_per_node=S_BREAKER_TUPLES)
                record("s2", out, got)
                outs.append((out, got))
            clock.t += 61.0                   # the cooldown elapses
            for qid in ("probe", "after"):
                out, got = serve(sess, qid, tuples_per_node=S_BREAKER_TUPLES)
                record("s2", out, got)
                outs.append((out, got))
        for out, got in outs[:3]:
            if (out.failure_class != "backend_unavailable"
                    or any(got.values())):
                raise AssertionError(f"(s2) outage: {out} {got}")
        cpu_out, cpu_got = outs[3]
        # the degraded engine launches nothing on the card (a CPU dry run
        # of this phase has no card to tell apart)
        need("s2", cpu_out, cpu_got, () if cuda else ("radix_pass",),
             status="ok", engine="cpu_fallback", degraded=True,
             breaker_state="open")
        for out, got in outs[4:]:
            need("s2", out, got, ("radix_pass", "merge_scan"), status="ok",
                 engine="primary", breaker_state="closed")
        c = meas.counters
        if (c.get("BRKTRIP"), c.get("BRKPROBE"), c.get("QDEGRADED")) != (
                1, 1, 1) or "degrade" not in [
                e["event"] for e in meas.meta["events"]]:
            raise AssertionError(f"(s2) counters {dict(c)}")
        emit({"phase": "serve_summary", "cell": "s2",
              "breaker": sess.breaker.snapshot(),
              "cpu_fallback_ms": cpu_out.latency_ms,
              "probe_ms": outs[4][0].latency_ms,
              "summary": sess.summary(), **card})
    finally:
        sess.close()
    return total


#: phase (t)'s sizes: the ids of the kernel shapes, K4's grouped block
T_IDS = 20_000_000
T_GROUPED_BLOCK = 1 << 23
#: the blocked MSD shape's capacity (16,384 groups of one, the hot one clips)
T_MSD_CAPACITY = 1500


def k4_huge_check(dev, widen, groups, m=(1 << 31) + 4097) -> dict:
    """K4 past 2**31 ids in slots mode: 2**31 + 4097 ids into ``groups``
    groups (4: the onesweep kernel; 1025: the wide one; 8193: the MSD
    passes), all but 2048 in group 0, so group 0's look-back counts, chunk
    words and positions pass 2**31.  Held without the plain version: the
    histogram, group 0's slots (each position less the others before it)
    and the others' slots (their group's start plus their rank), in
    chunks."""
    import numpy as np
    import torch
    from tpu_radix_join_torch.ops.kernels import partition as k4
    ids = torch.zeros(m, dtype=torch.int32, device=dev)
    at = torch.arange(2048, device=dev, dtype=torch.int64) * (m // 2048) + 3
    g_at = np.random.default_rng(17).integers(1, groups, 2048)
    ids[at] = torch.from_numpy(g_at).to(dev).to(torch.int32)
    slots, hist = k4.partition_slots(ids, num_groups=groups)
    want_hist = np.bincount(g_at, minlength=groups)
    want_hist[0] = m - 2048
    ok = [bool(np.array_equal(widen(hist).cpu().numpy(), want_hist))]
    zeros_ok = True
    step = 1 << 28
    for c in range(0, m, step):
        i = torch.arange(c, min(m, c + step), device=dev)
        zero = ids[c:c + step] == 0
        zeros_ok &= bool(torch.equal(widen(slots[c:c + step])[zero],
                                     (i - torch.searchsorted(at, i))[zero]))
        del i, zero
    ok.append(zeros_ok)
    start = np.cumsum(want_hist) - want_hist
    order = np.argsort(g_at, kind="stable")
    sorted_g = g_at[order]
    want_at = np.empty(2048, np.int64)
    want_at[order] = start[sorted_g] + np.arange(2048) - np.searchsorted(
        sorted_g, sorted_g)
    ok.append(bool(np.array_equal(widen(slots[at]).cpu().numpy(), want_at)))
    del ids, slots, hist
    if not all(ok):
        raise AssertionError(f"partition slots of {m} ids into {groups} "
                             f"groups: hist, group 0's slots, the others' "
                             f"slots: {ok}")
    return {"elements": m, "groups": groups, "largest_group": m - 2048,
            "checks": len(ok), "max_abs_err": 0}


def phase_t(dev, n, time_ms, device_us, card):
    """Phase (t): wider fanout (ROADMAP A19) and the implementation choice
    (A21) on the one card.  Returns ``(launches, rows)``: the main paths'
    launches and, for the final kernels line, one row a wide kernel path
    (``histogram_wide``, ``merge_scan_fanout``, ``merge_scan_wide_fanout``,
    ``partition_wide``, ``partition_msd``) at its representative shape.

      (t1) each wide path bit-exact against its plain version (max abs err
           0): K1 (its range tables) at ``T_IDS`` ids into 256, 1024, 2**14,
           2**15 + 1, 2**16 and 2**17 bins, random, sorted and constant,
           counts and weight sums, and its global table at 2**18 + 1 bins;
           K3 and K5 at fanouts
           8, 10 and 12 on (a)'s and (h)'s unions; K4's wide kernel dense
           at 257, 1025 and 4097 groups, and grouped 16 x 32 and 4 x 256
           at ``T_GROUPED_BLOCK`` slots a block, clipped, slots and two
           moved lanes; its edges (tile and chunk boundaries, one group
           across every tile, every id invalid, capacity 1, sorted ids, the
           cap's 8192 groups) and 2**31 + 4097 ids into 1025 groups in
           slots mode, held by formula; K4 past the cap on the MSD passes:
           dense 8193, 16,385 and 65,537 groups, blocked 16,384 x 1 clipped
           (``d_lf14``'s layout), grouped 4 x 4096, and 30% of the ids in
           one group, slots and two moved lanes; its edges (tile
           boundaries, one group, every id invalid, capacity 1, sorted
           ids, 2**20 + 1 and 2**24 + 1 groups: three and four passes) and
           2**31 + 4097 ids into 8193 groups by formula.  Each timed:
           event ms, device ms, the bytes bound at 3.35 TB/s, the library
           call (``torch.bincount``; ``argsort(stable=True)``; none for K3
           / K5), whether it reaches half its bound and whether it beats
           the library;
      (t2) joins of n ⋈ n unique, exact, median of 3 with its spread,
           beside the fanout-5 join each extends, measured here: (a) at
           network fanout 8 and 10, (h) 64-bit at 10, (d) bucketed at
           local fanout 10 (the wide K4) and 14 (past its cap: K1's range
           tables and the MSD passes), two-level 8 + 10; the first join of
           each with
           the counts set to 0 shows its wide path launched, the other K4
           path idle and no baseline counter moved;
      (t3) (a) and (d) under ``sort_impl="xla"``, ``partition_impl="sort"``:
           the kernel joins' counts, the baseline counters ticked, K2 and
           K4 (every path) at zero, the result naming its arms; times
           beside the kernels'."""
    import torch
    from tpu_radix_join_torch import HashJoin, JoinConfig, Relation
    from tpu_radix_join_torch.data.tuples import narrow, widen
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.ops.kernels import histogram as k1
    from tpu_radix_join_torch.ops.kernels import merge_scan as k3
    from tpu_radix_join_torch.ops.kernels import merge_scan_wide as k5
    from tpu_radix_join_torch.ops.kernels import partition as k4
    from tpu_radix_join_torch.ops.merge_count import (_pack_pm, _rotate_pid,
                                                      _side_tags)
    from tpu_radix_join_torch.ops.sorting import (sort_lex_unstable,
                                                  sort_unstable)

    hbm = 3.35e12
    t_start = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(16)

    def rand(m, hi):
        return narrow(torch.randint(0, hi, (m,), generator=gen, device=dev,
                                    dtype=torch.int64))

    def as_int(x):
        return widen(x) if x.dtype == torch.int32 else x.to(torch.int64)

    def exact(got, want, what) -> int:
        """The measured max abs difference over every output; raises
        unless it is 0 (and the shapes agree)."""
        got = [got] if torch.is_tensor(got) else list(got)
        want = [want] if torch.is_tensor(want) else list(want)
        err = 0
        for g, w in zip(got, want, strict=True):
            if g.shape != w.shape:
                raise AssertionError(f"phase (t) {what}: shape {g.shape} "
                                     f"against {w.shape}")
            if g.numel():
                err = max(err, int((as_int(g) - as_int(w)).abs().max()))
        if err:
            raise AssertionError(f"phase (t) {what}: the kernel differs "
                                 f"from its plain version (max abs err {err})")
        return err

    def device_ms(fn) -> float:
        return sum(device_us(fn, reps=5).values()) / 1e3

    def timed(kernel, shape, fn, nbytes, err, library=None, plain=None,
              beside=None):
        """One shape's line: event and device time, bound, library, and
        ``err``, the max abs err that :func:`exact` measured on these very
        inputs; ``beside``: name -> another path's call on them, timed
        too."""
        row = {"ms": time_ms(fn), "device_ms": device_ms(fn),
               "bound_ms": nbytes / hbm * 1e3, "bound_by": "bytes",
               "library_ms": None if library is None else time_ms(library),
               "plain_ms": None if plain is None else time_ms(plain, reps=3),
               "max_abs_err": err}
        for name, other in (beside or {}).items():
            row[f"{name}_ms"] = time_ms(other)
            row[f"{name}_device_ms"] = device_ms(other)
        row["half_bound"] = row["bound_ms"] >= 0.5 * row["device_ms"]
        row["beats_library"] = (None if library is None
                                else row["ms"] < row["library_ms"])
        emit({"phase": "wide_kernel", "kernel": kernel, "shape": shape,
              **row, **card})
        return row

    rows = {}
    # (t1) K1 past 128 bins
    checks = 0

    def k1_exact(x, w, bins, what) -> int:
        nonlocal checks
        checks += 1
        return exact(k1.histogram(x, w, num_bins=bins),
                     k1.histogram_plain(x, w, bins), f"K1 {bins} bins {what}")

    for bins in (256, 1024, 1 << 14, (1 << 15) + 1, 1 << 16, 1 << 17,
                 (1 << 18) + 1):
        ids = rand(T_IDS, bins + bins // 8)        # ids >= bins ignored
        w = rand(T_IDS, 1 << 32)
        for kind, x in (("random", ids), ("sorted", torch.sort(ids).values)):
            k1_exact(x, None, bins, kind)
            k1_exact(x, w, bins, f"{kind} weighted")
        inside = rand(T_IDS, bins)
        srt = torch.sort(inside).values
        const = torch.full_like(inside, bins - 1)
        shape = {"ids": T_IDS, "bins": bins, "table": k1.wide_table(bins)}
        row = timed("histogram_wide", shape,
                    lambda: k1.histogram(inside, num_bins=bins),
                    4 * T_IDS + 4 * bins,
                    k1_exact(inside, None, bins, "timed random"),
                    library=lambda: torch.bincount(inside, minlength=bins),
                    plain=lambda: k1.histogram_plain(inside, None, bins))
        for kind, x in (("sorted", srt), ("constant", const)):
            timed("histogram_wide", dict(shape, ids_kind=kind),
                  lambda: k1.histogram(x, num_bins=bins),
                  4 * T_IDS + 4 * bins,
                  k1_exact(x, None, bins, f"timed {kind}"),
                  library=lambda: torch.bincount(x, minlength=bins))
        timed("histogram_wide", dict(shape, weighted=True),
              lambda: k1.histogram(inside, w, num_bins=bins),
              8 * T_IDS + 4 * bins,
              k1_exact(inside, w, bins, "timed weighted"))
        if bins == 1 << 14:
            rows["histogram_wide"] = row
        del ids, w, inside, srt, const
    # K3 and K5 past 128 partitions on (a)'s and (h)'s unions
    rels_a = [Relation(n, 1, "unique", seed=s).generate(dev)
              for s in (1234, 1235)]
    rels_h = [Relation(n, 1, "unique", seed=s, key_bits=64).generate(dev)
              for s in (1234, 1235)]
    for f in (8, 10, 12):
        packed = sort_unstable(_pack_pm(rels_a[0].key, rels_a[1].key, f))
        m = packed.numel()
        err = exact(k3.merge_scan_partitions(packed, num_partitions=1 << f),
                    k3.merge_scan_plain(packed, f), f"K3 fanout {f}")
        checks += 1
        row = timed("merge_scan_fanout", {"positions": m, "fanout_bits": f},
                    lambda: k3.merge_scan_partitions(packed,
                                                     num_partitions=1 << f),
                    4 * m + 4 * ((1 << f) + 1), err,
                    plain=lambda: k3.merge_scan_plain(packed, f))
        if f == 10:
            rows["merge_scan_fanout"] = row
        del packed
        lo, hi, tag = sort_lex_unstable(
            torch.cat([_rotate_pid(r.key, f) for r in rels_h]),
            torch.cat([r.key_hi for r in rels_h]),
            _side_tags(rels_h[0].key, rels_h[1].key), num_keys=2)
        err = exact(k5.merge_scan_partitions_wide(
            lo, hi, tag, num_partitions=1 << f),
            k5.merge_scan_wide_plain(lo, hi, tag, f), f"K5 fanout {f}")
        checks += 1
        row = timed("merge_scan_wide_fanout",
                    {"positions": m, "fanout_bits": f, "hi": True},
                    lambda: k5.merge_scan_partitions_wide(
                        lo, hi, tag, num_partitions=1 << f),
                    12 * m + 4 * ((1 << f) + 1), err,
                    plain=lambda: k5.merge_scan_wide_plain(lo, hi, tag, f))
        if f == 10:
            rows["merge_scan_wide_fanout"] = row
        del lo, hi, tag
    del rels_a, rels_h
    # K4 past 256 groups: the wide kernel dense, then grouped with the clip
    key, rid = rand(T_IDS, 1 << 32), rand(T_IDS, 1 << 32)
    fills = [0xFFFFFFFF, 0xFFFFFFFE]

    def k4_exact(ids, groups, gsize, cap, what, path) -> int:
        """Slots and two moved lanes against the plain versions, with the
        counts set to 0 first: the wrapper must take ``path``."""
        nonlocal checks
        m = ids.numel()
        lanes = [key[:m], rid[:m]]
        kernels.reset_launches()
        err = exact(k4.partition_slots(ids, num_groups=groups,
                                       group_size=gsize, capacity=cap),
                    k4.partition_slots_plain(ids, groups, gsize, cap),
                    f"K4 slots {what}")
        got = k4.partition_scatter(ids, lanes, fills, num_groups=groups,
                                   group_size=gsize, capacity=cap)
        want = k4.partition_scatter_plain(ids, lanes, fills, groups, gsize,
                                          cap)
        err = max(err, exact(got[0] + [got[1]], want[0] + [want[1]],
                             f"K4 lanes {what}"))
        launched = kernels.launch_counts()
        if launched[path] != 2 or sum(launched[k] for k in (
                "partition", "partition_wide", "partition_msd")) != 2:
            raise AssertionError(f"phase (t) K4 {what}: launches {launched}")
        checks += 2
        return err

    for groups, gsize, cap in ((257, 1, None), (1025, 1, None),
                               (4097, 1, None),
                               (16 * 32, 32, T_GROUPED_BLOCK),
                               (4 * 256, 256, T_GROUPED_BLOCK)):
        ids = rand(T_IDS, groups + groups // 16)   # a few invalid ids
        if cap is not None:                        # one hot block: clipped
            ids = torch.where(rand(T_IDS, 2) == 0, ids % gsize, ids)
        shape = {"ids": T_IDS, "groups": groups, "group_size": gsize,
                 "capacity": cap, "lanes": 2}
        err = k4_exact(ids, groups, gsize, cap, shape, "partition_wide")
        size = k4.out_size(T_IDS, groups, gsize, cap)
        g = torch.where(widen(ids) < groups, widen(ids), groups)
        row = timed("partition_wide", dict(
            shape, launches_a_call=4,
            matrix_bytes=k4.wide_scratch_layout(
                T_IDS, groups, gsize, cap).matrix_bytes),
                    lambda: k4.partition_scatter(
                        ids, [key, rid], fills, num_groups=groups,
                        group_size=gsize, capacity=cap),
                    4 * T_IDS + 8 * T_IDS + 8 * size, err,
                    library=lambda: torch.argsort(g, stable=True),
                    plain=lambda: k4.partition_scatter_plain(
                        ids, [key, rid], fills, groups, gsize, cap),
                    beside={"slots": lambda: k4.partition_slots(
                            ids, num_groups=groups, group_size=gsize,
                            capacity=cap)})
        if groups == 1025:
            rows["partition_wide"] = row
        del ids, g
    # the wide kernel's edges: tile and chunk boundaries, one group across
    # every tile, every id invalid, capacity 1, sorted ids, the cap
    tile = k4.WIDE_TILE_IDS
    edge_errs = []
    for m in (1, tile - 1, tile, tile + 1, tile * k4.WIDE_CHUNK_TILES,
              tile * k4.WIDE_CHUNK_TILES + 1, 7 * tile + 5):
        ids = rand(m, 1025 + 64)
        edge_errs.append(k4_exact(ids, 1025, 1, None, f"n={m} dense",
                                  "partition_wide"))
        edge_errs.append(k4_exact(ids, 1024, 32, 5, f"n={m} blocked",
                                  "partition_wide"))
    one = torch.full((T_IDS,), 700, dtype=torch.int32, device=dev)
    edge_errs.append(k4_exact(one, 1025, 1, None, "one group",
                              "partition_wide"))
    edge_errs.append(k4_exact(one, 1024, 256, T_GROUPED_BLOCK,
                              "one group, clipped", "partition_wide"))
    edge_errs.append(k4_exact(rand(T_IDS, 1 << 20) + 1025, 1025, 1, None,
                              "every id invalid", "partition_wide"))
    edge_errs.append(k4_exact(rand(T_IDS, 4097), 4097, 1, 1, "capacity 1",
                              "partition_wide"))
    edge_errs.append(k4_exact(torch.sort(rand(T_IDS, 1025)).values, 1025, 1,
                              None, "sorted", "partition_wide"))
    edge_errs.append(k4_exact(rand(T_IDS, k4.WIDE_MAX_GROUPS + 512),
                              k4.WIDE_MAX_GROUPS, 1, None, "the cap",
                              "partition_wide"))
    del one
    # past the cap: the MSD passes (the kernels line's partition_msd row:
    # dense 16,385), then their edges
    for name, groups, gsize, cap, hot in (
            ("dense", 8193, 1, None, False), ("dense", 16385, 1, None, False),
            ("dense", 65537, 1, None, False),
            ("blocked", 16384, 1, T_MSD_CAPACITY, False),
            ("grouped", 4 * 4096, 4096, T_GROUPED_BLOCK, False),
            ("skewed", 16385, 1, None, True)):
        ids = rand(T_IDS, groups + groups // 16)   # a few invalid ids
        if cap is not None:                        # one hot block: clipped
            ids = torch.where(rand(T_IDS, 2) == 0, ids % gsize, ids)
        if hot:                                    # 30% in one group
            ids = torch.where(rand(T_IDS, 10) < 3, 77, ids)
        shape = {"ids": T_IDS, "groups": groups, "group_size": gsize,
                 "capacity": cap, "lanes": 2, "input": name,
                 "passes": len(k4.msd_plan(groups))}
        err = k4_exact(ids, groups, gsize, cap, shape, "partition_msd")
        size = k4.out_size(T_IDS, groups, gsize, cap)
        g = torch.where(widen(ids) < groups, widen(ids), groups)
        row = timed("partition_msd", shape,
                    lambda: k4.partition_scatter(
                        ids, [key, rid], fills, num_groups=groups,
                        group_size=gsize, capacity=cap),
                    4 * T_IDS + 8 * T_IDS + 8 * size, err,
                    library=lambda: torch.argsort(g, stable=True),
                    plain=lambda: k4.partition_scatter_plain(
                        ids, [key, rid], fills, groups, gsize, cap),
                    beside={"slots": lambda: k4.partition_slots(
                        ids, num_groups=groups, group_size=gsize,
                        capacity=cap)})
        if groups == 16385 and not hot:
            rows["partition_msd"] = row
        del ids, g
    msd_errs = []
    for m in (1, k4.MSD_TILE_IDS - 1, k4.MSD_TILE_IDS, k4.MSD_TILE_IDS + 1,
              3 * k4.MSD_TILE_IDS + 5):
        ids = rand(m, 8193 + 512)
        msd_errs.append(k4_exact(ids, 8193, 1, None, f"msd n={m} dense",
                                 "partition_msd"))
        msd_errs.append(k4_exact(ids, 16000, 1000, 5, f"msd n={m} blocked",
                                 "partition_msd"))
    one = torch.full((T_IDS,), 9000, dtype=torch.int32, device=dev)
    msd_errs.append(k4_exact(one, 16385, 1, None, "msd one group",
                             "partition_msd"))
    msd_errs.append(k4_exact(one, 16384, 4096, T_GROUPED_BLOCK,
                             "msd one group, clipped", "partition_msd"))
    del one
    msd_errs.append(k4_exact(rand(T_IDS, 1 << 20) + 16385, 16385, 1, None,
                             "msd every id invalid", "partition_msd"))
    msd_errs.append(k4_exact(rand(T_IDS, 16385), 16385, 1, 1,
                             "msd capacity 1", "partition_msd"))
    msd_errs.append(k4_exact(torch.sort(rand(T_IDS, 16385)).values, 16385,
                             1, None, "msd sorted", "partition_msd"))
    for groups in ((1 << 20) + 1, (1 << 24) + 1):   # three and four passes
        msd_errs.append(k4_exact(rand(min(T_IDS, 1_000_000),
                                      groups + groups // 16),
                                 groups, 1, None, f"msd {groups} groups",
                                 "partition_msd"))
    del ids, key, rid
    torch.cuda.empty_cache()
    huge = k4_huge_check(dev, widen, 1025)
    checks += huge["checks"]
    emit({"phase": "wide_kernel_edges", "kernel": "partition_wide",
          "checks": len(edge_errs), "max_abs_err": max(edge_errs),
          "past_2p31": huge, **card})
    torch.cuda.empty_cache()
    huge = k4_huge_check(dev, widen, 8193)
    checks += huge["checks"]
    emit({"phase": "wide_kernel_edges", "kernel": "partition_msd",
          "checks": len(msd_errs), "max_abs_err": max(msd_errs),
          "past_2p31": huge, **card})
    torch.cuda.empty_cache()
    emit({"phase": "wide_kernels_checked", "checks": checks,
          "seconds": time.perf_counter() - t_start, **card})

    # (t2) joins at n ⋈ n, beside the fanout-5 join each extends
    inner = Relation(n, 1, "unique", seed=1234)
    outer = Relation(n, 1, "unique", seed=1235)
    inner64 = Relation(n, 1, "unique", seed=1234, key_bits=64)
    outer64 = Relation(n, 1, "unique", seed=1235, key_bits=64)
    bucket = dict(probe_algorithm="bucket")
    two = dict(two_level=True, max_retries=4)
    cells = [   # name, config, 64-bit, the fanout-5 twin, wide counters,
                # counters that stay at zero
        ("a_f8", dict(network_fanout_bits=8), False, "a_f5",
         ("merge_scan_fanout",), ()),
        ("a_f10", dict(network_fanout_bits=10), False, "a_f5",
         ("merge_scan_fanout",), ()),
        ("h_f10", dict(network_fanout_bits=10, key_bits=64), True, "h_f5",
         ("merge_scan_wide_fanout",), ()),
        ("d_lf10", dict(bucket, local_fanout_bits=10, max_retries=4), False,
         "d_f5", ("partition_wide",), ("partition_msd",)),
        ("d_lf14", dict(bucket, local_fanout_bits=14, max_retries=4), False,
         "d_f5", ("partition_msd", "histogram_wide"), ("partition_wide",)),
        ("two_level_8_10", dict(two, network_fanout_bits=8,
                                local_fanout_bits=10), False,
         "two_level_5_5", ("partition_wide", "histogram_wide"),
         ("partition_msd",)),
    ]
    twins = {"a_f5": (dict(), False), "h_f5": (dict(key_bits=64), True),
             "d_f5": (bucket, False), "two_level_5_5": (two, False)}
    baseline_keys = ("baseline_sort", "baseline_partition",
                     "baseline_histogram")
    placed = {}

    def lanes(wide):
        if wide not in placed:
            placed.clear()
            torch.cuda.empty_cache()
            eng = HashJoin(JoinConfig(key_bits=64 if wide else 32), dev)
            placed[wide] = ((eng.place(inner64), eng.place(outer64)) if wide
                            else (eng.place(inner), eng.place(outer)))
        return placed[wide]

    def run(cfg_kw, wide):
        """(first result, its launches, median ms, min, max)."""
        eng = HashJoin(JoinConfig(**cfg_kw), dev)
        r, s = lanes(wide)
        torch.cuda.synchronize()
        kernels.reset_launches()
        res = eng.join_arrays(r, s)
        torch.cuda.synchronize()
        launched = kernels.launch_counts()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.join_arrays(r, s)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if not (res.ok and res.matches == n):
            raise AssertionError(f"phase (t) {cfg_kw}: {res}")
        return res, launched, statistics.median(times), times

    launches = {k: 0 for k in kernels.launch_counts()}

    def add(launched):
        for k, v in launched.items():
            launches[k] += v

    twin_ms = {}
    for name, cfg_kw, wide, twin, wide_keys, idle in sorted(
            cells, key=lambda c: c[2]):
        if twin not in twin_ms:
            twin_ms[twin] = run(*twins[twin])[2]
        res, launched, ms, times = run(cfg_kw, wide)
        add(launched)
        for k in wide_keys:
            if launched[k] <= 0:
                raise AssertionError(f"phase (t) {name}: {k} did not launch")
        if any(launched[k] for k in idle):
            raise AssertionError(f"phase (t) {name}: launches {launched}")
        if any(launched[k] for k in baseline_keys):
            raise AssertionError(f"phase (t) {name}: a baseline arm ran")
        if "baseline_arms" in res.diagnostics:
            raise AssertionError(f"phase (t) {name}: {res.diagnostics}")
        emit({"phase": "wide_join", "cell": name, "config": cfg_kw,
              "matches": res.matches, "ok": res.ok, "retries": res.retries,
              "join_ms": ms, "join_runs_ms": times,
              "tuples_per_s": 2 * n / ms * 1e3, "fanout5_cell": twin,
              "fanout5_join_ms": twin_ms[twin], "launches": launched,
              **card})

    # (t3) the library baseline arms, beside the kernels
    arms = dict(sort_impl="xla", partition_impl="sort")
    for name, cfg_kw in (("a", dict()), ("d", bucket)):
        kern, _, kern_ms, _ = run(cfg_kw, False)
        res, launched, ms, times = run(dict(cfg_kw, **arms), False)
        add(launched)
        if not (res.partition_counts.tolist()
                == kern.partition_counts.tolist()):
            raise AssertionError(f"phase (t) {name} baseline: the counts "
                                 "differ from the kernels'")
        zero = ("radix_histogram", "radix_pass", "partition",
                "partition_wide", "partition_msd")
        need = ("baseline_sort",) + (("baseline_partition",
                                      "baseline_histogram")
                                     if name == "d" else ())
        if any(launched[k] for k in zero) or not all(launched[k]
                                                     for k in need):
            raise AssertionError(f"phase (t) {name} baseline: launches "
                                 f"{launched}")
        if res.diagnostics.get("baseline_arms") != arms:
            raise AssertionError(f"phase (t) {name}: {res.diagnostics}")
        emit({"phase": "baseline_join", "cell": name, "arms": arms,
              "matches": res.matches, "ok": res.ok, "join_ms": ms,
              "join_runs_ms": times, "kernel_join_ms": kern_ms,
              "launches": launched, **card})
    placed.clear()
    torch.cuda.empty_cache()
    emit({"phase": "wide_seconds", "seconds": time.perf_counter() - t_start,
          **card})
    return launches, rows


def s3_case(dev, group, rank, world, n):
    """(s3), one rank of phase (p)'s gloo group: a ``JoinSession`` of the
    four ranks (``probe_algorithm="bucket"``, 1024 MiB resident) serves
    q0-q2 at ``n`` tuples a rank (q1 and q2 warm), then a delta base and
    one delta-merge query at :data:`S3_DELTA_BASE` a rank.  Returns this
    rank's outcomes (without their latencies, which it reports apart)."""
    import torch.distributed as dist
    from tpu_radix_join_torch import JoinConfig
    from tpu_radix_join_torch.core.config import ServiceConfig
    from tpu_radix_join_torch.performance import Measurements
    from tpu_radix_join_torch.service import JoinSession, QueryRequest

    meas = Measurements(node_id=rank, num_nodes=world)
    sess = JoinSession(JoinConfig(num_nodes=world, probe_algorithm="bucket"),
                       ServiceConfig(resident_budget_bytes=S_RESIDENT_MB
                                     << 20),
                       measurements=meas, device=dev, group=group)
    reqs = [QueryRequest(f"q{i}", tuples_per_node=n, seed=1234 + 2 * i)
            for i in range(3)]
    reqs += [QueryRequest(f"d{i}", tuples_per_node=S3_DELTA_BASE, seed=77,
                          delta_tuples_per_node=S_DELTA_TUPLES)
             for i in range(2)]
    try:
        dist.barrier()
        outs = []
        for req in reqs:
            sess.submit(req)
            outs.append(sess.run_next().to_json())
        latency = {o["query_id"]: o.pop("latency_ms") for o in outs}
        return {"outcomes": outs, "latency_ms": latency,
                "counters": {k: meas.counters.get(k, 0)
                             for k in ("QWARM", "DELTAMERGE", "RESBYTES")},
                "events": sorted({e["event"]
                                  for e in meas.meta.get("events", [])})}
    finally:
        sess.close()


def check_s3(results: list, card: dict) -> None:
    """(s3)'s checks: every rank reports the same outcomes and counters, q1
    and q2 warm, the delta query merged, every count the oracle's."""
    ref = results[0]["serve"]
    for res in results[1:]:
        if (res["serve"]["outcomes"] != ref["outcomes"]
                or res["serve"]["counters"] != ref["counters"]):
            raise AssertionError(f"(s3) rank {res['rank']}: "
                                 f"{res['serve']} against rank 0's {ref}")
    outs = ref["outcomes"]
    if ([(o["status"], o["served_by"], o["warm"]) for o in outs] != [
            ("ok", "execute", False), ("ok", "execute", True),
            ("ok", "execute", True), ("ok", "execute", False),
            ("ok", "delta_merge", False)]
            or any(o["matches"] != o["expected"] for o in outs)
            or "degrade" in ref["events"]
            or "batch_fallback" in ref["events"]):
        raise AssertionError(f"(s3): {ref}")
    emit({"phase": "serve", "cell": "s3", "backend": P_BACKEND,
          "ranks": P_RANKS, "outcomes": outs, "counters": ref["counters"],
          "latency_ms_by_rank": [r["serve"]["latency_ms"] for r in results],
          **card})


def phase_p_rank(rank: int, world: int, init_method: str,
                 spec: dict) -> dict:
    """One rank of phase (p) (see :func:`phase_p`): joins the gloo group
    on ``spec["device"]`` through ``multihost.initialize(...,
    backend="gloo")``, generates its shards on the card and runs each case.
    A case's first join runs with the launch counts set to 0 (the main
    path), then three more for the median, then once with
    ``measure_phases`` for this rank's exchange (JMPI) and local probe
    (JPROC).  Returns every case's result, plan, launches, collectives and
    times."""
    import contextlib
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_radix_join_torch import HashJoin, JoinConfig, Relation
    from tpu_radix_join_torch.data.tuples import lane_to_numpy
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.parallel import multihost
    from tpu_radix_join_torch.parallel.network_partitioning import (
        network_partition)
    from tpu_radix_join_torch.parallel.window import Window
    from tpu_radix_join_torch.parallel.world import make_world
    from tpu_radix_join_torch.performance import Measurements
    from tpu_radix_join_torch.robustness import faults

    dev = torch.device(spec["device"])
    cuda = dev.type == "cuda"
    if cuda:
        dev = torch.device("cuda", 0)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def device_busy_ms(fn):
        """This rank's device time of one call (torch.profiler's CUDA
        activity: its kernels, memsets and gloo's copies)."""
        from torch.profiler import ProfilerActivity, profile
        dist.barrier()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        return sum(getattr(e, "device_time_total", 0) or 0
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3

    def host_ms(fn):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return (time.perf_counter() - t0) * 1e3, out

    multihost.initialize(init_method=init_method, world_size=world,
                         rank=rank, local_rank=0, device=dev,
                         backend="gloo", timeout_s=spec["timeout_s"])
    group = dist.group.WORLD
    out = {"rank": rank, "backend": str(dist.get_backend(group)),
           "gloo_on_card": multihost.gloo_on_card(), "cases": {}}

    def rels(n, key_bits=32):
        total = n * world
        return (Relation(total, world, "unique", seed=1234,
                         key_bits=key_bits),
                Relation(total, world, "zipf", seed=1235, zipf_theta=0.75,
                         key_domain=total, key_bits=key_bits))

    base = dict(num_nodes=world, max_retries=spec["max_retries"])
    split = dict(base, skew_threshold=4.0)
    n, n2 = spec["tuples"], spec["p2_tuples"]
    cases = {   # name -> (config, relations)
        "p1": (JoinConfig(**split), (n, 32)),
        "p1_unsplit": (JoinConfig(**base), (n, 32)),
        "p4": (JoinConfig(**split, num_hosts=2), (n, 32)),
        "p5": (JoinConfig(**split), (n, 32)),
        "p5_unsplit": (JoinConfig(**base), (n, 32)),
        # (p6): the packed and the staged exchange and verify (A13, A15)
        "p6_pack": (JoinConfig(**base, exchange_codec="pack"), (n, 32)),
        "p6_auto": (JoinConfig(**base, exchange_codec="auto"), (n, 32)),
        "p6_staged": (JoinConfig(**base, exchange_stages=4), (n, 32)),
        "p6_pack_split": (JoinConfig(**split, exchange_codec="pack"),
                          (n, 32)),
        "p6_hosts_staged": (JoinConfig(**split, num_hosts=2,
                                       exchange_stages=4), (n, 32)),
        "p6_materialize_pack": (JoinConfig(**split, exchange_codec="pack"),
                                (n, 32)),
        "p6_repair": (JoinConfig(**base, verify="repair"), (n, 32)),
        # (p7): the packed exchange at network fanout 7 (A19): 4 x 128
        # = 512 groups, past K4's onesweep, on its wide path
        "p7_pack_f7": (JoinConfig(**base, exchange_codec="pack",
                                  network_fanout_bits=7), (n, 32)),
        "p3": (JoinConfig(**split, key_bits=64), (n, 64)),
        "p6_pack_64": (JoinConfig(**split, key_bits=64,
                                  exchange_codec="pack"), (n, 64)),
        "p2": (JoinConfig(**dict(split, max_retries=spec["p2_retries"]),
                          two_level=True), (n2, 32)),
    }
    def materialize_case(cfg, inner, outer, r, s):
        """(p5): ``join_materialize_arrays`` of this rank's shards, every
        rank's pairs gathered to every rank.  Each outer tuple of this
        workload matches one inner tuple, so the pairs ordered by s_rid
        are the sorted pair list: checked to hold each outer rid once and
        to join equal keys (the whole relations generated on the card),
        and summarised by a digest that the ranks and the unsplit join
        must share."""
        import hashlib
        eng = HashJoin(cfg, dev, group=group)
        cap_r, cap_s, skew = eng._measure_capacities(
            r, s, eng._shuffle_plan(r, s))
        sync()
        dist.barrier()
        kernels.reset_launches()
        before = dict(eng.world.counts)
        first_ms, res = host_ms(lambda: eng.join_materialize_arrays(r, s))
        launches = kernels.launch_counts()
        collectives = {k: eng.world.counts[k] - before[k] for k in before}
        runs = [first_ms] + [host_ms(
            lambda: eng.join_materialize_arrays(r, s))[0] for _ in range(2)]
        total = outer.global_size
        r_keys = lane_to_numpy(inner.generate(dev).key)
        s_keys = lane_to_numpy(outer.generate(dev).key)
        once = (res.matches == total
                and int(np.bincount(res.s_rid, minlength=total).max()) == 1)
        r_by_s = np.zeros(total, np.uint32)
        r_by_s[res.s_rid] = res.r_rid
        return {
            "matches": res.matches, "ok": res.ok, "retries": res.retries,
            "diagnostics": res.diagnostics,
            "expected": inner.expected_matches(outer),
            "tuples_per_rank": r.size, "key_bits": 32,
            "caps": [cap_r, cap_s],
            "hot_bits": None if skew is None else skew.hot_bits,
            "hot_cap": None if skew is None else skew.hot_cap,
            "launches": launches, "collectives": collectives,
            "join_runs_ms": runs, "join_ms": statistics.median(runs),
            "once": bool(once),
            "keys_equal": bool(once and np.array_equal(r_keys[r_by_s],
                                                       s_keys)),
            "digest": hashlib.sha1(r_by_s.tobytes()).hexdigest()}

    def p6_case(name, cfg, inner, outer, r, s):
        """(p6): the case's join once with the launch counts set to 0 (with
        ``exchange.corrupt_lane`` armed once for the repair), then twice
        more for the median; its registry's exchange plan and counters.
        The materializing case adds its pairs' digest (``materialize_case``)."""
        meas = Measurements(node_id=rank, num_nodes=world)
        eng = HashJoin(cfg, dev, group=group, measurements=meas)
        if name == "p6_materialize_pack":
            case = materialize_case(cfg, inner, outer, r, s)
            eng.join_materialize_arrays(r, s)
            return dict(case, exchange_plan=meas.meta["exchange_plan"],
                        counters=dict(meas.counters))
        bound = max(inner.key_bound(), outer.key_bound())
        inj = faults.FaultInjector()
        inj.arm(faults.EXCHANGE_CORRUPT, at=1)
        sync()
        dist.barrier()
        kernels.reset_launches()
        before = dict(eng.world.counts)
        with inj if name == "p6_repair" else contextlib.nullcontext():
            first_ms, res = host_ms(
                lambda: eng.join_arrays(r, s, key_bound=bound))
        sync()
        launches = kernels.launch_counts()
        collectives = {k: eng.world.counts[k] - before[k] for k in before}
        counters = dict(meas.counters)
        runs = [first_ms] + [host_ms(
            lambda: eng.join_arrays(r, s, key_bound=bound))[0]
            for _ in range(2)]
        return {"matches": res.matches, "ok": res.ok,
                "retries": res.retries, "diagnostics": res.diagnostics,
                "partition_counts": res.partition_counts.tolist(),
                "expected": inner.expected_matches(outer),
                "tuples_per_rank": r.size, "key_bits": cfg.key_bits,
                "launches": launches, "collectives": collectives,
                "join_runs_ms": runs, "join_ms": statistics.median(runs),
                "exchange_plan": meas.meta["exchange_plan"],
                "counters": counters}

    placed = {}
    try:
        for name, (cfg, shape) in cases.items():
            if shape not in placed:
                placed.clear()
                if cuda:
                    torch.cuda.empty_cache()
                inner, outer = rels(*shape)
                eng0 = HashJoin(JoinConfig(num_nodes=world,
                                           key_bits=shape[1]), dev,
                                group=group)
                placed[shape] = (inner, outer, eng0.place(inner),
                                 eng0.place(outer))
            inner, outer, r, s = placed[shape]
            if name.startswith(("p6", "p7")):
                out["cases"][name] = p6_case(name, cfg, inner, outer, r, s)
                if cuda:
                    torch.cuda.empty_cache()
                continue
            if name.startswith("p5"):
                out["cases"][name] = materialize_case(cfg, inner, outer, r, s)
                if cuda:
                    torch.cuda.empty_cache()
                continue
            bound = max(inner.key_bound(), outer.key_bound())
            eng = HashJoin(cfg, dev, group=group)
            cap_r, cap_s, skew = eng._measure_capacities(
                r, s, eng._shuffle_plan(r, s))
            sync()
            dist.barrier()
            kernels.reset_launches()
            before = dict(eng.world.counts)
            res = eng.join_arrays(r, s, key_bound=bound)
            sync()
            launches = kernels.launch_counts()
            collectives = {k: eng.world.counts[k] - before[k]
                           for k in before}
            runs = [host_ms(lambda: eng.join_arrays(r, s, key_bound=bound))[0]
                    for _ in range(3)]
            busy_ms = (device_busy_ms(
                lambda: eng.join_arrays(r, s, key_bound=bound)) if cuda
                else None)
            meas = Measurements(node_id=rank, num_nodes=world)
            eng_m = HashJoin(dataclasses.replace(cfg, measure_phases=True),
                             dev, group=group, measurements=meas)
            res_m = eng_m.join_arrays(r, s, key_bound=bound)
            case = {
                "matches": res.matches, "ok": res.ok,
                "retries": res.retries, "diagnostics": res.diagnostics,
                "partition_counts": res.partition_counts.tolist(),
                "expected": inner.expected_matches(outer),
                "tuples_per_rank": shape[0], "key_bits": shape[1],
                "caps": [cap_r, cap_s],
                "hot_bits": None if skew is None else skew.hot_bits,
                "hot_cap": None if skew is None else skew.hot_cap,
                "launches": launches, "collectives": collectives,
                "join_runs_ms": runs,
                "join_ms": statistics.median(runs),
                "device_busy_ms": busy_ms,
                "phases_ms": {k: v / 1e3 for k, v in meas.times_us.items()
                              if k in ("JMPI", "SNETCOMPL", "SLOCPREP",
                                       "JPROC", "SWINALLOC", "JTOTAL")},
                "phases_same": bool(np.array_equal(res_m.partition_counts,
                                                   res.partition_counts)),
            }
            if name == "p4":
                # one exchange of each relation through both routes, on
                # the card: the received lanes and counts bit for bit
                plan = eng._shuffle_plan(r, s)
                routes = {"flat": make_world(world, group),
                          "hierarchical": make_world(world, group, 2)}
                got, ms = {}, {}
                for route, w in routes.items():
                    def exchange(w=w):
                        return [network_partition(
                            b, cfg.network_fanout_bits, plan.assignment,
                            Window(w, c, side))
                            for b, c, side in ((r, cap_r, "inner"),
                                               (s, cap_s, "outer"))]
                    ms[route], got[route] = host_ms(exchange)
                    ms[route] = statistics.median(
                        [ms[route]] + [host_ms(exchange)[0]
                                       for _ in range(2)])
                case["exchange_equal"] = all(
                    torch.equal(a, b)
                    for x, y in zip(got["flat"], got["hierarchical"])
                    for a, b in zip([*x.batch, x.recv_counts],
                                    [*y.batch, y.recv_counts])
                    if a is not None)
                case["exchange_ms"] = ms
                del got
            out["cases"][name] = case
            del eng, eng_m
        placed.clear()
        if cuda:
            torch.cuda.empty_cache()
        out["serve"] = s3_case(dev, group, rank, world, n)
    finally:
        placed.clear()
        multihost.shutdown()
    return out


def phase_p(dev, card, spec=None) -> dict:
    """Phase (p): the skew split (A10) and the hierarchical exchange on
    :data:`P_RANKS` rank processes of one gloo group on the one card
    (``file://`` rendezvous; every rank's tensors on ``cuda:0``, gloo's CUDA
    collectives through the host), 20,000,000 ⋈ 20,000,000 tuples a rank:
    unique ⋈ zipf(theta 0.75) over the whole key domain, generated on the
    card.  (p1) ``skew_threshold=4.0``, the sort probe, against the same
    join unsplit; (p2) (p1) with ``two_level=True`` at 2**22 a rank; (p3)
    (p1) at ``key_bits=64``; (p4) (p1) with ``num_hosts=2``, and one
    exchange through both routes.  The kernels are built before the ranks
    start.  Checks the oracles, the spread of each hot partition, the
    routes' equality and the launches; prints each case's times beside the
    card's name and power limit (not NCCL times: no claim rests on them).
    Returns the main paths' launches summed over the ranks."""
    import shutil
    import tempfile
    import threading
    spec = dict({"device": dev.type, "tuples": P_TUPLES,
                 "p2_tuples": P2_TUPLES, "max_retries": 2,
                 "p2_retries": P2_RETRIES, "timeout_s": P_DEADLINE_S},
                **(spec or {}))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p_")
    init = f"file://{os.path.join(tmp, 'rendezvous')}"
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")   # one host: loopback
    procs, logs, outs = [], [], []
    t0 = time.perf_counter()
    try:
        for rank in range(P_RANKS):
            log = open(os.path.join(tmp, f"rank{rank}.err"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), P_RANK_FLAG,
                 str(rank), str(P_RANKS), init, json.dumps(spec)],
                stdout=subprocess.PIPE, stderr=log, text=True, env=env))
            outs.append([])
            # drain the rank's output as it comes, so it never blocks
            threading.Thread(target=lambda p=procs[-1], o=outs[-1]:
                             o.append(p.stdout.read()), daemon=True).start()
        end = time.monotonic() + P_DEADLINE_S
        while any(p.poll() is None for p in procs):
            failed = [i for i, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > end:
                why = (f"rank {failed[0]} exited {procs[failed[0]].poll()}"
                       if failed else "the ranks passed their deadline")
                i = failed[0] if failed else 0
                logs[i].seek(0)
                raise AssertionError(f"phase (p): {why}:\n"
                                     f"{logs[i].read()[-4000:]}")
            time.sleep(0.2)
        results = []
        for rank, p in enumerate(procs):
            while not outs[rank] and time.monotonic() < end:
                time.sleep(0.05)
            text = "".join(outs[rank])
            if p.returncode != 0 or not text.strip():
                logs[rank].seek(0)
                raise AssertionError(f"phase (p): rank {rank} exited "
                                     f"{p.returncode}:\n"
                                     f"{logs[rank].read()[-4000:]}")
            results.append(json.loads(text.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    return check_phase_p(results, seconds, card)


def p_launch_checks(name: str, launches: dict, attempts: int) -> None:
    """The kernels each case of phase (p) must have launched, summed over
    the ranks: K1 (sizing), K4 (two exchanges and the hot extraction an
    attempt and rank, plus the second radix pass of both relations on the
    two-level path), K2, and K3 or K5 on the sort probe."""
    need = ["histogram", "partition", "radix_histogram", "radix_pass"]
    if name == "p3":
        need.append("merge_scan_wide")
    elif name not in ("p2", "p5", "p5_unsplit"):
        need.append("merge_scan")
    for k in need:
        if launches[k] <= 0:
            raise AssertionError(f"phase (p) {name}: kernel {k} did not "
                                 "launch")
    split = name not in ("p1_unsplit", "p5_unsplit")
    per_attempt = 2 + split + 2 * (name == "p2")
    if launches["partition"] != per_attempt * attempts * P_RANKS:
        raise AssertionError(
            f"phase (p) {name}: {launches['partition']} K4 launches, not "
            f"{per_attempt} an attempt and rank over {attempts} attempt(s)")


def check_phase_p(results: list, seconds: float, card: dict) -> dict:
    """Phase (p)'s checks over every rank's results; emits one line a case
    and returns the launches summed over the cases and ranks."""
    import numpy as np
    names = [k for k in results[0]["cases"]
             if not k.startswith(("p5", "p6", "p7"))]
    for res in results:
        if res["backend"] != "gloo" or not res["gloo_on_card"]:
            raise AssertionError(f"phase (p): rank {res['rank']} ran on "
                                 f"{res['backend']}")
    total = {}
    cases = {}
    for name in names:
        per_rank = [res["cases"][name] for res in results]
        c = per_rank[0]
        for other in per_rank[1:]:
            for k in ("matches", "ok", "retries", "partition_counts",
                      "caps", "hot_bits", "hot_cap", "diagnostics"):
                if other[k] != c[k]:
                    raise AssertionError(f"phase (p) {name}: ranks differ "
                                         f"in {k}")
        if not (c["ok"] and c["matches"] == c["expected"]
                and all(r["phases_same"] for r in per_rank)):
            raise AssertionError(f"phase (p) {name}: {c['matches']} "
                                 f"matches, expected {c['expected']}, "
                                 f"{c['diagnostics']}")
        split = name != "p1_unsplit"
        if split != (c["hot_bits"] is not None):
            raise AssertionError(f"phase (p) {name}: hot set "
                                 f"{c['hot_bits']}")
        pc = np.asarray(c["partition_counts"], np.int64).reshape(P_RANKS, -1)
        hot = [p for p in range(32) if (c["hot_bits"] or 0) >> p & 1]
        # the sort probes count per network partition (each outer tuple
        # matches once, so a count is that partition's outer load on the
        # rank); the two-level join counts per local bucket
        for p in hot if name != "p2" else ():
            load = pc[:, p]
            if not (load.min() > 0 and load.max() <= 1.5 * load.mean()):
                raise AssertionError(f"phase (p) {name}: hot partition "
                                     f"{p} loads the ranks {load}")
        launches = {k: sum(r["launches"][k] for r in per_rank)
                    for k in c["launches"]}
        p_launch_checks(name, launches, c["retries"] + 1)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        cases[name] = (c, pc, per_rank, launches)
    c1, pc1 = cases["p1"][:2]
    c0, pc0 = cases["p1_unsplit"][:2]
    hot1 = [p for p in range(32) if c1["hot_bits"] >> p & 1]
    for p in hot1:
        if (pc0[:, p] > 0).sum() != 1:
            raise AssertionError(f"phase (p): unsplit, hot partition {p} "
                                 f"loads {pc0[:, p]}")
    if c0["matches"] != c1["matches"]:
        raise AssertionError("phase (p): the unsplit join's total differs")
    c4, pc4, per4 = cases["p4"][:3]
    if not (np.array_equal(pc4, pc1)
            and all(r["exchange_equal"] for r in per4)):
        raise AssertionError("phase (p) p4: the hierarchical route differs "
                             "from the flat one")
    # (p5): the materializing join split and unsplit
    p5 = {}
    for name in ("p5", "p5_unsplit"):
        per_rank = [res["cases"][name] for res in results]
        c = per_rank[0]
        for other in per_rank[1:]:
            for k in ("matches", "ok", "retries", "caps", "hot_bits",
                      "hot_cap", "diagnostics", "digest"):
                if other[k] != c[k]:
                    raise AssertionError(f"phase (p) {name}: ranks differ "
                                         f"in {k}")
        if not (c["ok"] and c["matches"] == c["expected"]
                and all(r["once"] and r["keys_equal"] for r in per_rank)):
            raise AssertionError(f"phase (p) {name}: {c['matches']} pairs, "
                                 f"expected {c['expected']}, "
                                 f"{c['diagnostics']}")
        if (c["hot_bits"] is not None) != (name == "p5"):
            raise AssertionError(f"phase (p) {name}: hot set "
                                 f"{c['hot_bits']}")
        launches = {k: sum(r["launches"][k] for r in per_rank)
                    for k in c["launches"]}
        p_launch_checks(name, launches, c["retries"] + 1)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        p5[name] = (c, per_rank, launches)
    if p5["p5"][0]["digest"] != p5["p5_unsplit"][0]["digest"]:
        raise AssertionError("phase (p) p5: the split materializing join's "
                             "pairs differ from the unsplit one's")
    for name, (c, per_rank, launches) in p5.items():
        emit({"phase": "multi_rank", "cell": name, "backend": P_BACKEND,
              "ranks": P_RANKS, "seconds": seconds,
              "tuples_per_rank": c["tuples_per_rank"], "pairs": c["matches"],
              "expected": c["expected"], "retries": c["retries"],
              "hot_cap": c["hot_cap"], "caps": c["caps"],
              "pairs_equal_unsplit": True,
              "join_ms_by_rank": [r["join_ms"] for r in per_rank],
              "join_runs_ms_by_rank": [r["join_runs_ms"] for r in per_rank],
              "launches": launches, "collectives": c["collectives"],
              **card})
    check_p6(results, seconds, card, cases, p5, total)
    check_p7(results, seconds, card, total)
    check_s3(results, card)
    for name, (c, pc, per_rank, launches) in cases.items():
        hot = [p for p in range(32) if (c["hot_bits"] or 0) >> p & 1]
        hot_p = {"p1_unsplit": hot1, "p2": ()}.get(name, hot)
        emit({"phase": "multi_rank", "cell": name, "backend": P_BACKEND,
              "ranks": P_RANKS, "seconds": seconds,
              "tuples_per_rank": c["tuples_per_rank"],
              "key_bits": c["key_bits"], "matches": c["matches"],
              "expected": c["expected"], "retries": c["retries"],
              "hot_partitions": hot, "hot_cap": c["hot_cap"],
              "caps": c["caps"],
              "hot_outer_load_by_rank": {p: pc[:, p].tolist()
                                         for p in hot_p},
              "join_ms_by_rank": [r["join_ms"] for r in per_rank],
              "join_runs_ms_by_rank": [r["join_runs_ms"] for r in per_rank],
              "probe_ms_by_rank": [r["phases_ms"].get("JPROC")
                                   for r in per_rank],
              "device_busy_ms_by_rank": [r["device_busy_ms"]
                                         for r in per_rank],
              "idle_share_by_rank": [
                  None if r["device_busy_ms"] is None
                  else 1 - r["device_busy_ms"] / r["join_ms"]
                  for r in per_rank],
              "phases_ms_by_rank": [r["phases_ms"] for r in per_rank],
              "exchange_ms_by_rank": [r.get("exchange_ms")
                                      for r in per_rank],
              "launches": launches, "collectives": c["collectives"],
              **card})
    return total


#: (p6) case -> the case of phase (p) whose join it repeats with the codec
#: off and the exchange fused (its counts, or its pairs' digest, must be
#: equal), or None for the repair, held to the oracle
P6_REFS = {"p6_pack": "p1_unsplit", "p6_auto": "p1_unsplit",
           "p6_staged": "p1_unsplit", "p6_pack_split": "p1",
           "p6_hosts_staged": "p4", "p6_materialize_pack": "p5",
           "p6_repair": None, "p6_pack_64": "p3"}


def check_p6(results: list, seconds: float, card: dict, cases: dict,
             p5: dict, total: dict) -> None:
    """(p6)'s checks: each case equal to its codec-off, fused reference of
    :data:`P6_REFS` (the repair to the oracle, one partition repaired),
    the plan's codec and stages as configured, the launches; emits one
    line a case with the wire geometry (``pack_ratio_pct``, WIREBYTES
    against MWINBYTES, ``peak_exchange_bytes`` against the fused raw
    exchange's) and adds the launches to ``total``."""
    import numpy as np
    for name, ref in P6_REFS.items():
        per_rank = [res["cases"][name] for res in results]
        c = per_rank[0]
        for other in per_rank[1:]:
            for k in ("matches", "ok", "retries", "diagnostics",
                      "partition_counts", "digest", "exchange_plan"):
                if other.get(k) != c.get(k):
                    raise AssertionError(f"phase (p) {name}: ranks differ "
                                         f"in {k}")
        if not (c["ok"] and c["matches"] == c["expected"]):
            raise AssertionError(f"phase (p) {name}: {c['matches']} "
                                 f"matches, expected {c['expected']}, "
                                 f"{c['diagnostics']}")
        if ref == "p5":
            if c["digest"] != p5["p5"][0]["digest"]:
                raise AssertionError(f"phase (p) {name}: the pairs differ "
                                     "from (p5)'s")
        elif ref is not None:
            pc = np.asarray(c["partition_counts"], np.int64).reshape(
                P_RANKS, -1)
            if not np.array_equal(pc, cases[ref][1]):
                raise AssertionError(f"phase (p) {name}: the counts differ "
                                     f"from ({ref})'s")
        else:
            diag = c["diagnostics"]
            if not (diag.get("repaired") == "partition"
                    and len(diag["repaired_partitions"]) == 1
                    and c["counters"].get("VREPAIR") == 1
                    and c["counters"].get("GRIDPAIRS") == 1):
                raise AssertionError(f"phase (p) {name}: {diag}, "
                                     f"{c['counters']}")
        plan = c["exchange_plan"]
        packs = name not in ("p6_staged", "p6_hosts_staged", "p6_repair")
        staged = name in ("p6_staged", "p6_hosts_staged")
        if (packs != (plan["codec_r"] == plan["codec_s"] == "pack")
                or staged != (plan["stages"] == 4)):
            raise AssertionError(f"phase (p) {name}: exchange plan {plan}")
        launches = {k: sum(r["launches"][k] for r in per_rank)
                    for k in c["launches"]}
        p_launch_checks(ref or "p1_unsplit", launches, c["retries"] + 1)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        lanes = 3 if c["key_bits"] == 64 else 2
        # a repaired join records no exchange (as the JAX engine's)
        caps = [c["counters"].get(k) for k in ("WINCAPR", "WINCAPS")]
        emit({"phase": "multi_rank", "cell": name, "backend": P_BACKEND,
              "ranks": P_RANKS, "seconds": seconds,
              "tuples_per_rank": c["tuples_per_rank"],
              "key_bits": c["key_bits"], "matches": c["matches"],
              "expected": c["expected"], "retries": c["retries"],
              "equal_to": ref or "oracle",
              "pack_ratio_pct": plan["pack_ratio_pct"],
              "wire_bytes": c["counters"].get("WIREBYTES"),
              "raw_bytes": c["counters"].get("MWINBYTES"),
              "peak_exchange_bytes": plan["peak_exchange_bytes"],
              "fused_raw_peak_bytes": None if None in caps
              else P_RANKS * 4 * lanes * max(caps),
              "exchange_plan": plan,
              "repaired": c["diagnostics"].get("repaired_partitions"),
              "join_ms_by_rank": [r["join_ms"] for r in per_rank],
              "join_runs_ms_by_rank": [r["join_runs_ms"] for r in per_rank],
              "launches": launches, "collectives": c["collectives"],
              **card})


def check_p7(results: list, seconds: float, card: dict, total: dict) -> None:
    """(p7)'s checks: the packed join at network fanout 7 equal on every
    rank and to the oracle, packed, with K4's wide kernel (the grouped
    scatter's 512 groups), not the MSD passes, and no baseline arm
    launched; emits its line and adds its launches to ``total``."""
    per_rank = [res["cases"]["p7_pack_f7"] for res in results]
    c = per_rank[0]
    for other in per_rank[1:]:
        for k in ("matches", "ok", "retries", "diagnostics",
                  "partition_counts", "exchange_plan"):
            if other.get(k) != c.get(k):
                raise AssertionError(f"phase (p) p7_pack_f7: ranks differ "
                                     f"in {k}")
    if not (c["ok"] and c["matches"] == c["expected"]
            and len(c["partition_counts"]) == P_RANKS * 128):
        raise AssertionError(f"phase (p) p7_pack_f7: {c['matches']} "
                             f"matches, expected {c['expected']}, "
                             f"{c['diagnostics']}")
    plan = c["exchange_plan"]
    launches = {k: sum(r["launches"][k] for r in per_rank)
                for k in c["launches"]}
    if (plan["codec_r"] != "pack" or plan["codec_s"] != "pack"
            or launches["partition_wide"] <= 0 or launches["partition_msd"]
            or launches["merge_scan"] <= 0
            or any(v for k, v in launches.items()
                   if k.startswith("baseline"))):
        raise AssertionError(f"phase (p) p7_pack_f7: plan {plan}, "
                             f"launches {launches}")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    emit({"phase": "multi_rank", "cell": "p7_pack_f7", "backend": P_BACKEND,
          "ranks": P_RANKS, "seconds": seconds,
          "tuples_per_rank": c["tuples_per_rank"], "network_fanout_bits": 7,
          "matches": c["matches"], "expected": c["expected"],
          "retries": c["retries"], "equal_on_every_rank": True,
          "pack_ratio_pct": plan["pack_ratio_pct"],
          "join_ms_by_rank": [r["join_ms"] for r in per_rank],
          "join_runs_ms_by_rank": [r["join_runs_ms"] for r in per_rank],
          "launches": launches, "collectives": c["collectives"], **card})


#: phase (u): probe repeats (run ids chip_smoke:u:<repeat>), the session's
#: relations, the planned grid's relations and its memory cut, and what
#: the in-process command lines add (nothing on the card)
U_REPEATS = 3
U_SESSION_TUPLES = 1 << 20
U_GRID_TUPLES = 1 << 26
U_GRID_HBM_BYTES = 4 << 30
U_CLI_EXTRA = ()

#: the kernels each planned strategy must launch (its sort arm aside)
U_STRATEGY_KERNELS = {
    "incore_fused_sort_narrow": ("merge_scan",),
    "incore_split_sort_narrow": ("merge_scan",),
    "incore_fused_sort_full": ("merge_scan_wide",),
    "incore_split_sort_full": ("merge_scan_wide",),
    "incore_fused_twolevel": ("histogram", "partition"),
}


def u_expected_kernels(plan) -> tuple:
    """Counters a planned run must tick: the strategy's kernels, and its
    sort arm's (K2's passes, or the named baseline arm under
    ``sort_impl="xla"``); a grid's K2, and K6 on the synchronous grid."""
    if plan.engine == "chunked":
        return (("radix_pass", "merge_scan_chunks")
                if plan.grid_pipeline == "off" else ("radix_pass",))
    arm = ("baseline_sort",) if plan.sort_impl == "xla" else (
        "radix_histogram", "radix_pass")
    return U_STRATEGY_KERNELS[plan.strategy] + arm


def phase_u(dev, n, time_ms, card) -> dict:
    """Cell (u): the planner (ROADMAP A17) and the run ledger on the card.

    (u1) ``U_REPEATS`` probe rounds, each a ledger row a constant under run
    id ``chip_smoke:u:<round>`` (in a temporary directory): ``calibrate()``
    on the card (``hbm_gbps``, ``sort_stage_unit_ms``, ``dispatch_floor_ms``,
    ``hbm_bytes``); a ``--sort-bench``-shaped row from K2 alone on ``n``
    random keys (``radix_sort_pass_unit_ms``); a ``--partition-bench``-
    shaped row from K4 on ``n`` ids into 32 groups
    (``partition_pass_unit_ms``); ``obs`` rows for the full-range sort over
    the narrow one at (a)'s union (``full_range_sort_factor``), the
    ``partition_impl="sort"`` arm's rate (``scatter_loop_melems_s``), a
    random gather (``gather_melems_s``) and a session's cache hit
    (``result_cache_lookup_ms``, a ``JoinSession(ledger=...)`` whose
    executed queries write ``query`` rows).  ``fit_profile`` fits them;
    each fitted constant is printed with its CI beside the packaged
    ``h100`` profile's value, and the fit is written as
    ``profile_fitted.json`` in the temporary directory.
    (u2) (a)'s workload planned under the packaged ``h100`` and run by
    ``main --plan auto --ledger-dir`` in this process: the oracle's total,
    the strategy's kernels launched, the plan-vs-actual audit and
    PLANDRIFT; the plan's config timed by the registry (JTOTAL, median of
    3); the saved plan replayed with ``--plan FILE``.
    (u3) ``--plan explain --profile auto --ledger-dir`` as a subprocess:
    exit 0, no ``[RESULTS]``, the profile resolved to (u1)'s fit.
    (u4) ``U_GRID_TUPLES`` ⋈ ``U_GRID_TUPLES`` planned under a copy of
    ``h100`` cut to ``U_GRID_HBM_BYTES`` (a file in the temporary
    directory): ``--plan auto`` with a checkpoint whose fingerprint carries
    the plan and ``--grid-pipeline auto`` taking the plan's choice, then
    the cost table's other grid row replayed with ``--plan FILE``; each
    exact, K2 launched, K6 on the synchronous grid.
    Every planned run's ``run`` row is in the ledger.  Returns the planned
    runs' launches."""
    import contextlib
    import dataclasses
    import io
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from tpu_radix_join_torch import HashJoin, JoinConfig
    from tpu_radix_join_torch import main as cli
    from tpu_radix_join_torch.core.config import ServiceConfig
    from tpu_radix_join_torch.data.tuples import TupleBatch, narrow
    from tpu_radix_join_torch.observability.ledger import Ledger, load_rows
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.ops.kernels import partition as k4
    from tpu_radix_join_torch.ops.kernels import radix_sort as k2
    from tpu_radix_join_torch.ops.merge_count import (_pack_pm, _rotate_pid,
                                                      _side_tags)
    from tpu_radix_join_torch.ops.radix import scatter_to_blocks
    from tpu_radix_join_torch.ops.sorting import (library_sort,
                                                  sort_lex_unstable,
                                                  sort_unstable)
    from tpu_radix_join_torch.performance import Measurements
    from tpu_radix_join_torch.planner import (Workload, calibrate,
                                              fit_profile, load_profile,
                                              plan_join, resolve_profile)
    from tpu_radix_join_torch.planner.profile import FITTED_PROFILE_BASENAME
    from tpu_radix_join_torch.service import JoinSession, QueryRequest

    if dist.is_initialized():
        raise AssertionError("(u) runs the command line in this process, "
                             "which leaves any process group")
    cuda = dev.type == "cuda"
    smi = card["nvidia_smi"]
    total = {k: 0 for k in kernels.launch_counts()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_u_")
    ledger = Ledger(tmp)
    t_phase = time.perf_counter()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # ------------------------------------------------------------ (u1)
    packaged = load_profile("h100")
    probes = {
        "hbm_gbps": "calibrate() elementwise pass",
        "sort_stage_unit_ms": "calibrate() stable torch.sort",
        "dispatch_floor_ms": "calibrate() trivial op and synchronize",
        "hbm_bytes": "calibrate() mem_get_info",
        "radix_sort_pass_unit_ms": f"K2 alone on {n} random keys",
        "partition_pass_unit_ms": f"K4 on {n} ids into 32 groups",
        "full_range_sort_factor": f"the full-range sort over the narrow "
                                  f"one at a {2 * n}-position union",
        "scatter_loop_melems_s": f"the partition_impl=sort arm on {n} ids",
        "gather_melems_s": f"a random gather of {n} of {n}",
        "result_cache_lookup_ms": "a JoinSession result-cache hit",
    }
    base = packaged.replace_constants(**{
        k: {"value": packaged.constants[k]["value"],
            "source": f"chip_smoke.py phase (u): {what} on {smi}"}
        for k, what in probes.items()})
    gen = torch.Generator(device="cpu").manual_seed(20261018)

    def lane(hi):
        return narrow(torch.randint(0, hi, (n,), dtype=torch.int64,
                                    generator=gen)).to(dev)

    keys, ids = lane(1 << 32), lane(32)
    rids = torch.arange(n, dtype=torch.int32, device=dev)
    r_keys = lane(n)
    s_keys = lane(n)
    packed = _pack_pm(r_keys, s_keys, 5)
    rot = torch.cat([_rotate_pid(r_keys, 5), _rotate_pid(s_keys, 5)])
    tags = _side_tags(r_keys, s_keys)
    perm = torch.randperm(n, device=dev)
    cap = n // 32 * 3 // 2
    batch = TupleBatch(key=keys, rid=rids)
    svc = ServiceConfig(result_cache_max=8)
    sess = JoinSession(JoinConfig(), svc, device=dev, ledger=ledger)
    for qid, seed in (("u-q0", 7), ("u-q1", 8)):
        sess.submit(QueryRequest(query_id=qid,
                                 tuples_per_node=U_SESSION_TUPLES,
                                 seed=seed))
        out = sess.run_next()
        if out.status != "ok" or out.matches != out.expected:
            raise AssertionError(f"(u1) session query {qid}: {out}")
    rounds = []
    for rep in range(U_REPEATS):
        rid = f"chip_smoke:u:{rep}"
        cal = calibrate(base=base, device=dev)
        for k in ("hbm_gbps", "sort_stage_unit_ms", "dispatch_floor_ms",
                  "hbm_bytes"):
            ledger.append("obs", {"constant": k, "value": cal.value(k)},
                          run_id=rid)
        kernel_ms = time_ms(lambda: k2.radix_sort([keys]), reps=5)
        kv_ms = time_ms(lambda: k2.radix_sort([keys, rids]), reps=5)
        lib_ms = time_ms(lambda: library_sort([keys, rids], 1), reps=5)
        ledger.append("bench", {
            "metric": "radix_sort_speedup", "value": lib_ms / kv_ms,
            "size": n, "sort_ms": kv_ms, "sort_xla_ms": lib_ms,
            "sort_kernel_ms": kernel_ms, "sort_passes": 4}, run_id=rid)
        part_ms = time_ms(lambda: k4.partition_slots(
            ids, num_groups=32, capacity=cap), reps=5)
        fused_ms = time_ms(lambda: scatter_to_blocks(
            batch, ids, 32, cap, "inner"), reps=5)
        sort_arm_ms = time_ms(lambda: scatter_to_blocks(
            batch, ids, 32, cap, "inner", impl="sort"), reps=5)
        ledger.append("bench", {
            "metric": "partition_fused_speedup",
            "value": sort_arm_ms / fused_ms, "size": n, "num_blocks": 32,
            "partition_ms": fused_ms, "partition_kernel_ms": part_ms,
            "partition_sort_ms": sort_arm_ms}, run_id=rid)
        narrow_ms = time_ms(lambda: sort_unstable(packed), reps=5)
        full_ms = time_ms(lambda: sort_lex_unstable(rot, tags, num_keys=1),
                          reps=5)
        gather_ms = time_ms(lambda: keys[perm], reps=5)
        hit = sess.try_cache(QueryRequest(
            query_id=f"u-hit{rep}", tuples_per_node=U_SESSION_TUPLES,
            seed=7))
        if hit is None or hit.served_by != "cache_hit":
            raise AssertionError(f"(u1) round {rep}: no cache hit: {hit}")
        for k, v in (("full_range_sort_factor", full_ms / narrow_ms),
                     ("scatter_loop_melems_s", n / 1e3 / sort_arm_ms),
                     ("gather_melems_s", n / 1e3 / gather_ms),
                     ("result_cache_lookup_ms", hit.latency_ms)):
            ledger.append("obs", {"constant": k, "value": v}, run_id=rid)
        rounds.append({"kernel_ms": kernel_ms, "kv_ms": kv_ms,
                       "library_ms": lib_ms, "partition_kernel_ms": part_ms,
                       "partition_ms": fused_ms,
                       "partition_sort_ms": sort_arm_ms,
                       "narrow_sort_ms": narrow_ms, "full_sort_ms": full_ms,
                       "gather_ms": gather_ms, "hit_ms": hit.latency_ms})
    sess.close()
    queries = load_rows(tmp, kind="query")
    if [q["query_id"] for q in queries] != ["u-q0", "u-q1"]:
        raise AssertionError(f"(u1) session ledger rows: {queries}")
    del keys, ids, rids, r_keys, s_keys, packed, rot, tags, perm, batch
    fitted, fits = fit_profile(load_rows(tmp), base=base, name="h100",
                               min_samples=2)
    fitted = dataclasses.replace(fitted, notes=(
        f"{smi}; fitted by chip_smoke.py phase (u) from {U_REPEATS} probe "
        f"rounds (calibrate() and the K2, K4, sort, gather and result-cache "
        f"probes); ici_gbps and ici_bytes_per_s unset (no interconnect "
        f"measured)"))
    want = set(probes)
    if set(fits) != want:
        raise AssertionError(f"(u1) fitted {sorted(fits)}, not "
                             f"{sorted(want)}")
    for k, f in fits.items():
        src = fitted.source(k)
        if not (f.value > 0 and f.n >= 2 and src.startswith("fit:")
                and card["name"] in src):
            raise AssertionError(f"(u1) {k}: {f} {src!r}")
    fit_path = fitted.save(os.path.join(tmp, FITTED_PROFILE_BASENAME))
    emit({"phase": "profile_fit", "rounds": rounds,
          "constants": {k: {"value": f.value, "ci95": list(f.ci95),
                            "n": f.n, "residual": f.residual,
                            "packaged": packaged.constants[k]["value"]}
                        for k, f in sorted(fits.items())},
          "profile": fitted.to_dict(), **card})

    # ------------------------------------------------------------ (u2)
    def cli_run(cell, argv):
        """``main(argv)`` in this process with the launch counts set to 0:
        (its JSON line, the [PLAN] lines, the launches)."""
        buf = io.StringIO()
        sync()
        kernels.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([*argv, *U_CLI_EXTRA])
        sync()
        got = kernels.launch_counts()
        for k, v in got.items():
            total[k] += v
        lines = buf.getvalue().splitlines()
        if rc != 0:
            raise AssertionError(f"(u) {cell}: exit {rc}: {lines[-5:]}")
        doc = json.loads(lines[-1])
        return doc, [x for x in lines if x.startswith("[PLAN]")], got

    def check_run(cell, plan, doc, plan_lines, got, expected):
        if not plan_lines or not plan_lines[0].startswith(
                f"[PLAN] strategy={plan.strategy} "):
            raise AssertionError(f"(u) {cell}: {plan_lines}")
        if doc["matches"] != expected or not doc["ok"]:
            raise AssertionError(f"(u) {cell}: {doc['matches']} matches, "
                                 f"the oracle {expected}")
        pva = doc.get("plan_vs_actual") or {}
        if (pva.get("strategy") != plan.strategy
                or "PLANDRIFT" not in doc["counters"]):
            raise AssertionError(f"(u) {cell}: no audit: {pva}")
        for k in u_expected_kernels(plan):
            if got[k] <= 0:
                raise AssertionError(f"(u) {cell}: {plan.strategy} did not "
                                     f"launch {k}: {got}")
        emit({"phase": "planner", "cell": cell, "strategy": plan.strategy,
              "engine": plan.engine, "sort_impl": plan.sort_impl,
              "grid_pipeline": plan.grid_pipeline,
              "chunk_tuples": plan.chunk_tuples,
              "predicted_ms": plan.predicted_ms,
              "predicted_terms": plan.predicted_terms,
              "actual_ms": pva["actual_ms"], "drift_pct": pva["drift_pct"],
              "plandrift": doc["counters"]["PLANDRIFT"],
              "launches": {k: v for k, v in got.items() if v}, **card})
        return pva

    # the packaged profile as the command line loads it
    packaged = load_profile("h100")
    work_a = Workload(r_tuples=n, s_tuples=n, key_bound=n)
    plan_a, costs_a = plan_join(packaged, work_a)
    emit({"phase": "planner", "cell": "u_costs_a",
          "costs": [c.to_dict() for c in costs_a], **card})
    doc, plan_lines, got = cli_run("u_a_auto", [
        "--plan", "auto", "--tuples-per-node", str(n), "--ledger-dir", tmp])
    pva_a = check_run("u_a_auto", plan_a, doc, plan_lines, got, n)
    # the plan's config alone, JTOTAL by the registry (median of 3)
    meas = Measurements()
    eng = HashJoin(dataclasses.replace(JoinConfig(),
                                       **plan_a.config_kwargs()),
                   device=dev, measurements=meas)
    from tpu_radix_join_torch import Relation
    r = eng.place(Relation(n, 1, "unique", seed=1234))
    s = eng.place(Relation(n, 1, "unique", seed=1235))
    jt = []
    for _ in range(4):
        before = meas.times_us.get("JTOTAL", 0.0)
        if eng.join_arrays(r, s, key_bound=n).matches != n:
            raise AssertionError("(u2) the plan's config is not exact")
        jt.append((meas.times_us["JTOTAL"] - before) / 1e3)
    del r, s, eng
    emit({"phase": "planner", "cell": "u_a_jtotal",
          "strategy": plan_a.strategy, "predicted_ms": plan_a.predicted_ms,
          "jtotal_ms": jt, "jtotal_median_ms": statistics.median(jt[1:]),
          "cli_actual_ms": pva_a["actual_ms"], **card})
    plan_path = plan_a.save(os.path.join(tmp, "plan_a.json"))
    doc, plan_lines, got = cli_run("u_a_replay", [
        "--plan", plan_path, "--tuples-per-node", str(n),
        "--ledger-dir", tmp])
    check_run("u_a_replay", plan_a, doc, plan_lines, got, n)

    # ------------------------------------------------------------ (u3)
    if resolve_profile("auto", ledger_dir=tmp) != fit_path:
        raise AssertionError("(u3) --profile auto did not resolve to the "
                             "fit")
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_radix_join_torch.main", "--plan",
         "explain", "--profile", "auto", "--ledger-dir", tmp,
         "--tuples-per-node", str(n), *U_CLI_EXTRA],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if (proc.returncode != 0 or "[RESULTS]" in proc.stdout
            or f"[PROFILE] auto -> {fit_path}" not in proc.stderr
            or "chosen:" not in proc.stdout
            or "provenance/staleness" not in proc.stdout):
        raise AssertionError(f"(u3) --plan explain: exit {proc.returncode}"
                             f"\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    emit({"phase": "planner", "cell": "u_explain",
          "table": proc.stdout.splitlines(), **card})

    # ------------------------------------------------------------ (u4)
    cut = packaged.replace_constants(
        name="h100_4gib", hbm_bytes={
            "value": U_GRID_HBM_BYTES,
            "source": f"chip_smoke.py phase (u): h100 cut to "
                      f"{U_GRID_HBM_BYTES} bytes"})
    cut_path = cut.save(os.path.join(tmp, "h100_4gib.json"))
    plan_g, costs_g = plan_join(cut, Workload(
        r_tuples=U_GRID_TUPLES, s_tuples=U_GRID_TUPLES,
        key_bound=U_GRID_TUPLES))
    if plan_g.engine != "chunked":
        raise AssertionError(f"(u4) the 4 GiB plan is {plan_g}")
    other = ("chunked_grid" if plan_g.strategy == "chunked_grid_pipelined"
             else "chunked_grid_pipelined")
    row = next(c for c in costs_g if c.strategy == other)
    plan_o = dataclasses.replace(
        plan_g, strategy=other, predicted_ms=row.cost_ms,
        predicted_terms={k: round(v, 4) for k, v in row.terms.items()},
        grid_pipeline="on" if other.endswith("_pipelined") else "off")
    emit({"phase": "planner", "cell": "u_costs_grid",
          "costs": [c.to_dict() for c in costs_g], **card})
    for cell, plan, argv in (
            ("u_grid_auto", plan_g, ["--plan", "auto", "--profile",
                                      cut_path]),
            ("u_grid_replay", plan_o, ["--plan", plan_o.save(
                os.path.join(tmp, "plan_grid.json"))])):
        ckpt = os.path.join(tmp, cell)
        doc, plan_lines, got = cli_run(cell, [
            *argv, "--tuples-per-node", str(U_GRID_TUPLES),
            "--checkpoint-dir", ckpt, "--ledger-dir", tmp])
        check_run(cell, plan, doc, plan_lines, got, U_GRID_TUPLES)
        with open(os.path.join(ckpt, "grid.ckpt")) as f:
            fp = json.load(f)["fingerprint"]
        if (doc["grid_pipeline"] != plan.grid_pipeline
                or doc["chunk_tuples"] != plan.chunk_tuples
                or fp.get("plan") != {"strategy": plan.strategy,
                                      "chunk_tuples": plan.chunk_tuples}):
            raise AssertionError(f"(u4) {cell}: {doc['grid_pipeline']}, "
                                 f"{doc['chunk_tuples']}, {fp}")
    runs = load_rows(tmp, kind="run")
    if (len(runs) != 4 or not all(r.get("plan") and r.get("plan_vs_actual")
                                  for r in runs)):
        raise AssertionError(f"(u) ledger run rows: {len(runs)}")
    shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "planner", "cell": "u_done",
          "seconds": time.perf_counter() - t_phase,
          "launches": {k: v for k, v in total.items() if v}, **card})
    return total


#: phase (v): the serve worker's liveness and observability plane (ROADMAP
#: A16b step 1, A18d) at hpcjoin's 20,000,000 tuples a node: the lease
#: window (lapse after V_MISSED_BEATS windows), the heartbeat's interval,
#: the watchdog's timeout and the slack a trip may take past it, the
#: queries timed with the plane on and off (interleaved), the stall cap of
#: an unwatched stall
V_LEASE_S = 1.0
V_MISSED_BEATS = 2
V_INTERVAL_S = 0.25
V_WATCHDOG_S = 2.0
V_TRIP_SLACK_S = 3.0
V_LATENCY_REPS = 5
V_STALL_CAP_S = "30"
V_DEADLINE_S = 0.001
#: arguments phase (v) adds to its command line (none on the card)
V_CLI_EXTRA = ()


def phase_v(dev, n, card) -> dict:
    """Cell (v): the serve worker's liveness and observability plane
    (ROADMAP A16b step 1 with A18d's flight recorder, spans, timeline,
    metrics heartbeat, ``/statusz``, compile monitor, forensics bundles and
    hang watchdog), at ``n`` tuples a node on the one card.

    (v1) In this process: a ``JoinSession`` with a registry (the flight
    recorder on), an attached span tracer, the compile monitor, a one-rank
    ``MembershipView`` whose lease the heartbeat writes every
    ``V_INTERVAL_S`` (``attach_heartbeat``), ``forensics_dir`` and a
    watchdog of ``V_WATCHDOG_S`` (``attach_watchdog``).  It serves two
    sort-probe queries (K2, K3) and, through a second such session with
    ``probe_algorithm="bucket"``, one bucket query (K1, K4, K2), each equal
    to the oracle, each with the launch counts set to 0 before it and read
    after; then one query with ``backend.stall`` armed: the watchdog trips
    within its timeout plus ``V_TRIP_SLACK_S``, the outcome is
    ``backend_unavailable`` with a bundle carrying every thread's stack,
    and the next query is exact.  NCOMPILE (which hears the process's
    first-use builds) does not rise after the first query of each path.  A thread reads the lease file's age every 20 ms: it stays under
    the lapse window.  Then the same warm query (placed relations cached)
    is timed with the plane on and off (a session with no registry),
    interleaved, ``V_LATENCY_REPS`` each; the registry's overhead on (a)'s
    join with the ring on (phase (o3)'s row: a registry against none,
    interleaved, 10 each); one sampler tick, timed.
    (v2) The command line ``python -m tpu_radix_join_torch.main --serve -
    --elastic on --lease-dir D --rank-lease-s 1 --rank-missed-beats 2
    --metrics-interval 0.25 --timeline-dir T --statusz 0 --forensics-dir F
    --watchdog-timeout 30 --probe bucket --trace --output-dir O`` as a
    subprocess: three queries and a missed deadline written to its stdin
    one at a time; between them the lease's age, ``/statusz`` (its
    ``critical_paths`` holding each served query's path),
    ``/statusz/leases`` and ``/healthz`` (each GET timed).  The lease is
    younger than the lapse window while it serves and withdrawn at exit;
    the metrics file holds one line a tick with the card's bytes in use;
    the span file merges (``merge_timeline``) into a timeline with a
    device track (``--trace``); the exit code is 1, the missed deadline's,
    as (s1)'s.  Returns the launches of every query."""
    import tempfile
    import threading
    import urllib.request
    import torch
    from tpu_radix_join_torch import JoinConfig
    from tpu_radix_join_torch.core.config import ServiceConfig
    from tpu_radix_join_torch.observability import (install_compile_monitor,
                                                    load_bundle,
                                                    load_samples,
                                                    merge_timeline,
                                                    uninstall_compile_monitor)
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.performance import Measurements
    from tpu_radix_join_torch.robustness import faults
    from tpu_radix_join_torch.robustness.membership import (LeaseBoard,
                                                            MembershipView)
    from tpu_radix_join_torch.service import JoinSession, QueryRequest

    cuda = dev.type == "cuda"
    total = {k: 0 for k in kernels.launch_counts()}
    t_phase = time.perf_counter()
    lapse_s = V_LEASE_S * V_MISSED_BEATS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_v_")
    os.environ["TPU_RADIX_STALL_CAP_S"] = V_STALL_CAP_S

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def launched(fn):
        sync()
        kernels.reset_launches()
        out = fn()
        sync()
        got = kernels.launch_counts()
        for k, v in got.items():
            total[k] += v
        return out, got

    def serve(sess, qid, **kw):
        kw.setdefault("tuples_per_node", n)

        def one():
            sess.submit(QueryRequest(query_id=qid, **kw))
            return sess.run_next()
        return launched(one)

    def exact(out, got, names):
        if out.status != "ok" or out.matches != out.expected:
            raise AssertionError(f"(v) {out.query_id}: {out}")
        for k in names:
            if got[k] <= 0:
                raise AssertionError(f"(v) {out.query_id}: kernel {k} did "
                                     f"not launch: {got}")

    def plane(name, cfg):
        meas = Measurements()
        install_compile_monitor(meas)
        meas.attach_tracer(nodes=1)
        board = LeaseBoard(os.path.join(tmp, name, "leases"), rank=0,
                           num_ranks=1, lease_s=V_LEASE_S,
                           missed_beats=V_MISSED_BEATS, measurements=meas)
        view = MembershipView(board, measurements=meas)
        board.heartbeat(0)
        sess = JoinSession(cfg, ServiceConfig(), measurements=meas,
                           device=dev, membership=view, elastic=True,
                           forensics_dir=os.path.join(tmp, name, "bundles"))
        sess.attach_heartbeat(os.path.join(tmp, name, "0.metrics.jsonl"),
                              V_INTERVAL_S)
        sess.attach_watchdog(V_WATCHDOG_S)
        return sess, meas, board

    # ------------------------------------------------------------- (v1)
    sess, meas, board = plane("sort", JoinConfig())
    bsess, bmeas, bboard = plane("bucket", JoinConfig(probe_algorithm="bucket"))
    ages, stop_ages = [], threading.Event()

    def watch_lease():
        while not stop_ages.wait(0.02):
            for b in (board, bboard):
                lease = b.read(0)
                if lease is not None:
                    ages.append(time.time() - lease.t_epoch_s)

    watcher = threading.Thread(target=watch_lease, daemon=True)
    watcher.start()
    lines = []
    try:
        outs = []
        for qid, s, seed in (("v0", sess, 1234), ("vb", bsess, 1234),
                             ("v1", sess, 1240)):
            out, got = serve(s, qid, seed=seed)
            outs.append((out, got))
            if qid == "vb":
                # the monitor hears the process's builds: after the first
                # query of each path every library is loaded
                ncompile_after_first = meas.counters.get("NCOMPILE", 0)
        exact(*outs[0], ("radix_pass", "merge_scan"))
        exact(*outs[1], ("histogram", "partition", "radix_pass"))
        exact(*outs[2], ("radix_pass", "merge_scan"))
        inj = faults.FaultInjector(seed=21)
        inj.arm(faults.BACKEND_STALL, at=1)
        t0 = time.perf_counter()
        with inj:
            hung, got_h = serve(sess, "stall", seed=1234)
        stall_s = time.perf_counter() - t0
        outs.append((hung, got_h))
        if (hung.status, hung.failure_class) != ("failed",
                                                 "backend_unavailable"):
            raise AssertionError(f"(v1) the stalled query: {hung}")
        if stall_s > V_WATCHDOG_S + V_TRIP_SLACK_S:
            raise AssertionError(f"(v1) the watchdog took {stall_s:.3f} s")
        bundle = load_bundle(hung.bundle)
        if (bundle["reason"] != "watchdog_trip" or not bundle["stacks"]
                or "JTOTAL" not in bundle["open_phases"]
                or bundle["query_id"] != "stall"):
            raise AssertionError(f"(v1) the trip's bundle: "
                                 f"{ {k: bundle.get(k) for k in ('reason', 'open_phases', 'query_id')} }")
        after, got_a = serve(sess, "v_after", seed=1234)
        outs.append((after, got_a))
        exact(after, got_a, ("radix_pass", "merge_scan"))
        if meas.counters.get("NCOMPILE", 0) != ncompile_after_first:
            raise AssertionError(f"(v1) NCOMPILE rose after the first "
                                 f"query: {ncompile_after_first} -> "
                                 f"{meas.counters.get('NCOMPILE')}")
        if meas.counters.get("WDOGTRIP") != 1:
            raise AssertionError(f"(v1) WDOGTRIP {dict(meas.counters)}")
        for out, got in outs:
            line = {"phase": "plane", "cell": "v1", **out.to_json(),
                    "launches": {k: v for k, v in got.items() if v}}
            line.pop("detail")
            lines.append(line)
            emit(dict(line, **card))
        # the same warm query with the plane on and off, interleaved
        off = JoinSession(JoinConfig(), ServiceConfig(), device=dev)
        try:
            lat = {"on": [], "off": []}
            for i in range(V_LATENCY_REPS + 1):
                for key, s in (("on", sess), ("off", off)):
                    out, _ = serve(s, f"lat_{key}{i}", seed=1234)
                    if out.matches != n:
                        raise AssertionError(f"(v1) latency: {out}")
                    if i:                       # the first warms the cache
                        lat[key].append(out.latency_ms)
        finally:
            off.close()
        # one sampler tick (a line written), timed
        tick = []
        for _ in range(20):
            t0 = time.perf_counter()
            sess._sampler.sample()
            tick.append((time.perf_counter() - t0) * 1e3)
        summary = sess.summary()
        ring = len(meas.flightrec)
    finally:
        stop_ages.set()
        watcher.join(5.0)
        sess.close()
        bsess.close()
        uninstall_compile_monitor(meas)
        uninstall_compile_monitor(bmeas)
    samples = load_samples(os.path.join(tmp, "sort", "0.metrics.jsonl"))
    if not samples or not any(s.get("lease") for s in samples):
        raise AssertionError("(v1) the heartbeat wrote no lease")
    if cuda and not any(v > 0 for s in samples
                        for k, v in s.get("devices", {}).items()
                        if k.endswith("_bytes_in_use")):
        raise AssertionError("(v1) no device bytes in the heartbeat")
    if not ages or max(ages) >= lapse_s:
        raise AssertionError(f"(v1) lease ages up to "
                             f"{max(ages) if ages else None} s")
    # the registry's overhead with the ring on: (a)'s join, a registry
    # against none, interleaved (phase (o3)'s row)
    from tpu_radix_join_torch import HashJoin, Relation
    engines = {"registry": HashJoin(JoinConfig(), device=dev,
                                    measurements=Measurements()),
               "none": HashJoin(JoinConfig(), device=dev)}
    r = engines["none"].place(Relation(n, 1, "unique", seed=1234))
    s_ = engines["none"].place(Relation(n, 1, "unique", seed=1235))
    reg = {"registry": [], "none": []}
    for i in range(11):
        for key, eng in engines.items():
            sync()
            t0 = time.perf_counter()
            res = eng.join_arrays(r, s_, key_bound=n)
            sync()
            if res.matches != n:
                raise AssertionError(f"(v1) (o3) row: {res}")
            if i:
                reg[key].append((time.perf_counter() - t0) * 1e3)
    del r, s_, engines
    med = {k: statistics.median(v) for k, v in lat.items()}
    reg_med = {k: statistics.median(v) for k, v in reg.items()}
    emit({"phase": "plane_summary", "cell": "v1", "tuples_per_node": n,
          "stall_s": stall_s, "watchdog_s": V_WATCHDOG_S,
          "latency_on_ms": lat["on"], "latency_off_ms": lat["off"],
          "latency_median_ms": med,
          "plane_overhead_pct": 100.0 * (med["on"] - med["off"])
          / med["off"],
          "registry_join_ms": reg["registry"], "none_join_ms": reg["none"],
          "registry_median_ms": reg_med,
          "registry_overhead_pct": 100.0 * (reg_med["registry"]
                                            - reg_med["none"])
          / reg_med["none"],
          "sampler_tick_ms": statistics.median(tick),
          "lease_age_s": {"n": len(ages), "max": max(ages),
                          "median": statistics.median(ages)},
          "lapse_window_s": lapse_s, "heartbeat_lines": len(samples),
          "ring_records": ring, "ncompile": summary["ncompile"],
          "counters": {k: meas.counters.get(k, 0) for k in (
              "NCOMPILE", "COMPILEMS", "WDOGTRIP", "PMBUNDLE", "QWARM")},
          **card})

    # ------------------------------------------------------------- (v2)
    d, tl, fdir, odir = (os.path.join(tmp, "cli", x)
                         for x in ("D", "T", "F", "O"))
    argv = [sys.executable, "-m", "tpu_radix_join_torch.main", "--serve",
            "-", "--elastic", "on", "--lease-dir", d, "--rank-lease-s",
            str(V_LEASE_S), "--rank-missed-beats", str(V_MISSED_BEATS),
            "--metrics-interval", str(V_INTERVAL_S), "--timeline-dir", tl,
            "--statusz", "0", "--forensics-dir", fdir,
            "--watchdog-timeout", "30", "--probe", "bucket", "--trace",
            "--output-dir", odir, *V_CLI_EXTRA]
    t_cli = time.perf_counter()
    proc = subprocess.Popen(argv, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    err_lines, port_box = [], []

    def read_err():
        for ln in proc.stderr:
            err_lines.append(ln)
            if "[STATUSZ] serving http://127.0.0.1:" in ln:
                port_box.append(int(ln.split("127.0.0.1:")[1].split("/")[0]))

    err_reader = threading.Thread(target=read_err, daemon=True)
    err_reader.start()
    lease_path = os.path.join(d, "lease_r0.json")

    def get(path):
        t0 = time.perf_counter()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port_box[0]}{path}", timeout=30) as rsp:
            body = json.load(rsp)
            code = rsp.status
        return code, body, (time.perf_counter() - t0) * 1e3

    cli_outs, cli_ages, gets, health = [], [], [], []
    reqs = [{"query_id": f"c{i}", "tuples_per_node": n, "seed": 1234 + 2 * i}
            for i in range(3)]
    reqs.append({"query_id": "c_deadline", "tuples_per_node": n,
                 "seed": 999, "deadline_s": V_DEADLINE_S})
    try:
        for req in reqs:
            proc.stdin.write(json.dumps(req) + "\n")
            proc.stdin.flush()
            line = ""
            while not line.startswith('{"event": "outcome"'):
                line = proc.stdout.readline()
                if not line:
                    raise AssertionError(f"(v2) the worker ended: "
                                         f"{''.join(err_lines)[-3000:]}")
            cli_outs.append(json.loads(line))
            t0 = time.perf_counter()
            while not port_box and time.perf_counter() - t0 < 30:
                time.sleep(0.01)
            with open(lease_path) as f:
                cli_ages.append(time.time() - json.load(f)["t_epoch_s"])
            for path in ("/statusz", "/statusz/leases", "/healthz"):
                code, body, ms = get(path)
                gets.append({"path": path, "code": code, "ms": ms})
                if path == "/healthz":
                    health.append(body)
                if path == "/statusz" and (
                        set(body) - {"t_epoch_s"} != {
                            "phase", "counters", "service", "leases",
                            "hedge", "critical_paths"}
                        or body["hedge"]["mode"] != "off"
                        or [p.get("query_id") for p in
                            body["critical_paths"]]
                        != [r["query_id"] for r in reqs[:len(cli_outs)]]):
                    raise AssertionError(f"(v2) /statusz sections "
                                         f"{sorted(body)}: "
                                         f"{body.get('critical_paths')}")
        proc.stdin.close()
        rest = proc.stdout.read()
        proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err_reader.join(10.0)
    cli_s = time.perf_counter() - t_cli
    recs = [json.loads(ln) for ln in rest.splitlines() if ln.startswith("{")]
    cli_summary = next((r for r in recs if r.get("event") == "summary"), {})
    want = [("ok", n)] * 3 + [("failed", None)]
    if ([(o["status"], o["matches"]) for o in cli_outs] != want
            or any(o["matches"] != o["expected"] for o in cli_outs[:3])
            or proc.returncode != 1):
        raise AssertionError(f"(v2) exited {proc.returncode}: {cli_outs}\n"
                             f"{''.join(err_lines)[-3000:]}")
    if os.path.exists(lease_path) or max(cli_ages) >= lapse_s:
        raise AssertionError(f"(v2) lease ages {cli_ages}; withdrawn: "
                             f"{not os.path.exists(lease_path)}")
    if not all(h.get("ok") for h in health) or any(
            g["code"] != 200 for g in gets):
        raise AssertionError(f"(v2) health {health} {gets}")
    samples = load_samples(os.path.join(tl, "0.metrics.jsonl"))
    dev_bytes = [v for s in samples for k, v in s.get("devices", {}).items()
                 if k.endswith("_bytes_in_use")]
    if len(samples) < 2 or len(samples) > cli_s / V_INTERVAL_S + 3 or (
            cuda and not any(v > 0 for v in dev_bytes)):
        raise AssertionError(f"(v2) {len(samples)} heartbeat lines in "
                             f"{cli_s:.1f} s, device bytes {dev_bytes[-3:]}")
    doc = merge_timeline(tl)
    device_track = [e for e in doc["traceEvents"]
                    if e.get("tid") == 1 and e.get("ph") == "X"]
    queries = [e for e in doc["traceEvents"] if e.get("name") == "query"]
    if not device_track or len(queries) != 4:
        raise AssertionError(f"(v2) timeline: {len(device_track)} device "
                             f"ops, {len(queries)} query spans")
    bundle = load_bundle(cli_outs[3]["bundle"])
    if bundle["query_id"] != "c_deadline":
        raise AssertionError(f"(v2) the deadline's bundle: {bundle}")
    emit({"phase": "plane_cli", "cell": "v2", "seconds": cli_s,
          "exit_code": proc.returncode,
          "latency_ms": {o["query_id"]: o["latency_ms"] for o in cli_outs},
          "lease_age_s": cli_ages, "lapse_window_s": lapse_s,
          "statusz_get_ms": {p: statistics.median(
              g["ms"] for g in gets if g["path"] == p)
              for p in ("/statusz", "/statusz/leases", "/healthz")},
          "heartbeat_lines": len(samples),
          "device_bytes_in_use_max": max(dev_bytes) if dev_bytes else 0,
          "timeline_device_ops": len(device_track),
          "ncompile": cli_summary.get("ncompile"),
          "compile_ms": cli_summary.get("compile_ms"),
          "recompile_storms": cli_summary.get("recompile_storms"), **card})
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "plane", "cell": "v_done",
          "seconds": time.perf_counter() - t_phase,
          "launches": {k: v for k, v in total.items() if v}, **card})
    return total, med["on"]


#: phase (w): the fleet's workers and the dispatched query its kill hits;
#: the supervisor's lease window (its workers beat every half window); the
#: seconds a fleet run may take; the period of the status poller;
#: arguments phase (w) adds to its command lines (none on the card)
W_WORKERS = 2
W_KILL_AT = 2
W_LEASE_S = 1.0
W_RUN_S = 300.0
W_POLL_S = 0.25
W_CLI_EXTRA = ()


def smi_apps() -> list:
    """The compute apps ``nvidia-smi`` lists on the card: one line a CUDA
    context (the pid column may be a pid of another namespace)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise AssertionError(f"nvidia-smi --query-compute-apps: "
                             f"{out.stderr}")
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def fleet_run(argv, cwd, feed=None, sigterm=False, poll=None):
    """One ``main --fleet`` run as a subprocess: ``feed`` lines written to
    its stdin (then SIGTERM with ``sigterm``, else stdin closed), its
    stdout's JSON lines collected, ``poll(port)`` called every
    ``W_POLL_S`` while it runs once ``--statusz`` has printed its port.
    Returns (exit code, JSON lines, stderr); the supervisor is killed if it
    outlives ``W_RUN_S`` (its workers then see EOF and exit)."""
    import queue
    import signal
    import threading

    proc = subprocess.Popen(argv, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, bufsize=1, cwd=cwd)
    outq, err, port = queue.Queue(), [], []

    def read_out():
        for ln in proc.stdout:
            if ln.startswith("{"):
                outq.put(json.loads(ln))
        outq.put(None)

    def read_err():
        for ln in proc.stderr:
            err.append(ln)
            if "[STATUSZ] serving http://127.0.0.1:" in ln:
                port.append(int(ln.split("127.0.0.1:")[1].split("/")[0]))

    readers = [threading.Thread(target=f, daemon=True)
               for f in (read_out, read_err)]
    for t in readers:
        t.start()
    recs = []
    deadline = time.monotonic() + W_RUN_S
    try:
        for line in feed or ():
            proc.stdin.write(json.dumps(line) + "\n")
            proc.stdin.flush()
            while True:
                rec = outq.get(timeout=max(1.0, deadline - time.monotonic()))
                if rec is None:
                    raise AssertionError(f"(w) the supervisor ended: "
                                         f"{''.join(err)[-3000:]}")
                recs.append(rec)
                if rec.get("event") == "outcome":
                    break
        if sigterm:
            proc.send_signal(signal.SIGTERM)
        else:
            proc.stdin.close()
        while proc.poll() is None and time.monotonic() < deadline:
            if poll is not None and port:
                poll(port[0])
            time.sleep(W_POLL_S)
        proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    for t in readers:
        t.join(30.0)
    while True:
        rec = outq.get_nowait() if not outq.empty() else None
        if rec is None:
            break
        recs.append(rec)
    return proc.returncode, recs, "".join(err)


def worker_incarnations(work_dir: str) -> list:
    """Each worker incarnation's heartbeat lines under a fleet dir (the
    slots' ``worker<k>/0.metrics.jsonl``, which every incarnation of a
    slot appends to), grouped by the pid its lease names, in start order:
    ``{"slot", "pid", "first_lease_s", "lines", "last"}``."""
    from tpu_radix_join_torch.observability import load_samples

    out = []
    for slot in sorted(os.listdir(work_dir)):
        path = os.path.join(work_dir, slot, "0.metrics.jsonl")
        if not slot.startswith("worker") or not os.path.exists(path):
            continue
        by_pid: dict = {}
        for rec in load_samples(path):
            lease = rec.get("lease") or {}
            if "pid" in lease:
                by_pid.setdefault(lease["pid"], []).append(rec)
        for pid, recs in by_pid.items():
            out.append({"slot": int(slot[len("worker"):]), "pid": pid,
                        "first_lease_s": recs[0]["lease"]["t_epoch_s"],
                        "lines": len(recs), "last": recs[-1],
                        "peak_bytes": max(
                            (v for r in recs for k, v in
                             r.get("devices", {}).items()
                             if k.endswith("_peak_bytes_in_use")),
                            default=0)})
    return sorted(out, key=lambda w: w["first_lease_s"])


def phase_w(dev, n, card, warm_ms) -> dict:
    """Cell (w): the crash-only fleet (ROADMAP A16b step 2) on the card, at
    ``n`` tuples a node, through the command line as a subprocess, so that
    the supervisor's process is told apart from its workers'.

    (w1) ``python -m tpu_radix_join_torch.main --fleet 2 --serve FILE
    --verify check --fleet-dir D --fleet-kill-at 2 --statusz 0
    --rank-lease-s 1``: three unique ⋈ unique queries in two tenants; the
    second query's worker is SIGKILLed with the request on its pipe and the
    survivor serves the replay.  Every outcome is ``ok`` and equal to the
    oracle, the killed query carries ``fleet.attempts >= 2`` and
    ``replayed``; the summary has ``failover >= 1``, ``replayn >= 1``,
    ``double_exec == 0`` and ``unacked == 0``, and ``QueryJournal(D)
    .audit()`` agrees.  While it serves a poller reads ``/healthz`` (200
    while a worker serves) and ``/statusz`` (its ``fleet`` section: the
    workers' pids and states) and counts ``nvidia-smi``'s compute apps:
    this script's context and one a live worker, none for the supervisor
    (inside a container nvidia-smi may list each process under another
    pid namespace's id, so contexts are counted, not pids matched).  The
    workers' heartbeat lines under D (one file a slot, one pid an
    incarnation) show their device bytes, NCOMPILE / COMPILEMS and
    kernel launches: each worker counts from 0 at its start, and the
    launches of the incarnations' last lines are the phase's.
    (w2) ``--fleet 1 --serve - --fleet-kill-at 1``: one query on stdin, its
    only worker killed, so the supervisor respawns the slot (``w0i2``) and
    replays the query there; SIGTERM after the outcome: exit 0,
    ``drain.unacked == 0``, ``leases_left == []`` and no ``lease_*`` file
    under its fleet dir.
    Times: failover (the kill to the replayed outcome: the journal's first
    intent to its outcome), cold restart (the respawn, the journal's intent
    on the new incarnation, to that incarnation's first lease beat in its
    heartbeat), each query's latency through the fleet (intent to outcome)
    beside the worker's own and (v1)'s warm in-process query, the
    supervisor's dispatch overhead (fleet latency less the worker's, on a
    worker that had served before; on a fresh one that difference is its
    boot), the workers' peak device memory.  Returns the launches of every
    worker."""
    import shutil
    import tempfile
    import urllib.error
    import urllib.request
    import torch
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.service.journal import QueryJournal

    cuda = dev.type == "cuda"
    total = {k: 0 for k in kernels.launch_counts()}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_w_")
    root = os.path.dirname(os.path.abspath(__file__))
    base = [sys.executable, "-m", "tpu_radix_join_torch.main", "--verify",
            "check", "--rank-lease-s", str(W_LEASE_S), "--seed", "7",
            *W_CLI_EXTRA]
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    apps0 = len(smi_apps()) if cuda else 0

    # ------------------------------------------------------------- (w1)
    d1 = os.path.join(tmp, "fleet")
    reqs = [{"query_id": f"w{i}", "tenant": f"t{i % 2}",
             "tuples_per_node": n, "seed": 1234 + 2 * i} for i in range(3)]
    req_path = os.path.join(tmp, "requests.jsonl")
    with open(req_path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in reqs)
    polls, pids_seen = [], set()

    def get(port, path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=10) as rsp:
                return rsp.status, json.load(rsp)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"{}")
        except (urllib.error.URLError, ConnectionError):
            return None, {}             # the server stopped at the drain

    def poll(port):
        hcode, hbody = get(port, "/healthz")
        scode, body = get(port, "/statusz")
        workers = (body.get("fleet") or {}).get("workers", {})
        live = {w["pid"]: w["state"] for w in workers.values()
                if w["pid"] is not None
                and w["state"] in ("serving", "booting", "stale")}
        pids_seen.update(live)
        rec = {"healthz": hcode, "health": hbody, "statusz": scode,
               "sections": sorted(body), "live": live}
        if cuda:
            rec["apps"] = len(smi_apps())
        polls.append(rec)

    t1 = time.perf_counter()
    try:
        rc1, recs1, err1 = fleet_run(
            base + ["--fleet", str(W_WORKERS), "--serve", req_path,
                    "--fleet-dir", d1, "--fleet-kill-at", str(W_KILL_AT),
                    "--statusz", "0"], root, poll=poll)
    except BaseException:
        for pid in pids_seen:           # workers the supervisor left
            try:
                os.kill(pid, 9)
            except OSError:
                pass
        raise
    w1_s = time.perf_counter() - t1
    outs = [r for r in recs1 if r.get("event") == "outcome"]
    summary = next((r for r in recs1 if r.get("event") == "summary"), {})
    if rc1 != 0 or [o["query_id"] for o in outs] != ["w0", "w1", "w2"]:
        raise AssertionError(f"(w1) exit {rc1}: {recs1}\n{err1[-3000:]}")
    for o in outs:
        if o["status"] != "ok" or not o["matches"] == o["expected"] == n:
            raise AssertionError(f"(w1) {o}")
    killed = outs[W_KILL_AT - 1]
    if killed["fleet"]["attempts"] < 2 or not killed["fleet"]["replayed"]:
        raise AssertionError(f"(w1) the killed query: {killed}")
    drain = summary.get("drain", {})
    if (summary.get("failover", 0) < 1 or summary.get("replayn", 0) < 1
            or summary.get("double_exec") != 0 or summary.get("unacked") != 0
            or drain.get("unacked") != 0 or drain.get("double_exec") != 0):
        raise AssertionError(f"(w1) summary {summary}")
    journal = QueryJournal(d1)
    audit = journal.audit()
    if (audit.unacked, audit.double_exec, audit.outcomes, audit.replays) != (
            summary["unacked"], summary["double_exec"], 3,
            summary["replayn"]):
        raise AssertionError(f"(w1) journal audit {audit} against "
                             f"{summary}")
    serving = [p for p in polls
               if "serving" in p["live"].values() and p["statusz"] == 200]
    if not serving or not any(p["healthz"] == 200 and p["health"].get("ok")
                              for p in serving):
        raise AssertionError(f"(w1) no /healthz 200 while a worker served: "
                             f"{polls[-5:]}")
    if any("fleet" not in p["sections"] for p in polls if
           p["statusz"] == 200):
        raise AssertionError(f"(w1) /statusz without its fleet section: "
                             f"{polls[-5:]}")
    incs1 = worker_incarnations(d1)
    if cuda:
        # one context a live worker beside this script's, none for the
        # supervisor: nvidia-smi's pid column may be of another pid
        # namespace (a container's processes can all read as pid 1), so
        # the contexts are counted against the live workers the
        # supervisor's statusz names
        full = [p for p in serving if len(p["live"]) == W_WORKERS
                and set(p["live"].values()) == {"serving"}]
        if (not full or any(p["apps"] > apps0 + len(p["live"])
                            for p in polls)
                or not any(p["apps"] == apps0 + W_WORKERS for p in full)):
            raise AssertionError(f"(w1) compute apps {apps0} before, "
                                 f"{[(p['apps'], len(p['live'])) for p in polls]}")

    # ------------------------------------------------------------- (w2)
    d2 = os.path.join(tmp, "drain")
    t2 = time.perf_counter()
    rc2, recs2, err2 = fleet_run(
        base + ["--fleet", "1", "--serve", "-", "--fleet-dir", d2,
                "--fleet-kill-at", "1"], root,
        feed=[{"query_id": "wd", "tenant": "t0", "tuples_per_node": n,
               "seed": 1240}], sigterm=True)
    w2_s = time.perf_counter() - t2
    out2 = next((r for r in recs2 if r.get("event") == "outcome"), {})
    sum2 = next((r for r in recs2 if r.get("event") == "summary"), {})
    leases = [f for _, _, fs in os.walk(d2) for f in fs
              if f.startswith("lease_")]
    if (rc2 != 0 or out2.get("status") != "ok" or out2.get("matches") != n
            or out2.get("expected") != n
            or out2["fleet"]["incarnation"] != "w0i2"
            or not out2["fleet"]["replayed"]
            or sum2.get("worker_restarts") != 1
            or sum2.get("drain", {}).get("unacked") != 0
            or sum2["drain"].get("double_exec") != 0
            or sum2["drain"].get("leases_left") != [] or leases):
        raise AssertionError(f"(w2) exit {rc2}: {recs2}; lease files "
                             f"{leases}\n{err2[-3000:]}")
    if QueryJournal(d2).audit().unacked != 0:
        raise AssertionError(f"(w2) {QueryJournal(d2).audit()}")
    incs2 = worker_incarnations(d2)

    # ------------------------------------------------------- the numbers
    def rows(j, qid):
        intents = sorted((r for r in j.rows("intent")
                          if r["query_id"] == qid),
                         key=lambda r: r["attempt"])
        outcome = next(r for r in j.rows("outcome") if r["query_id"] == qid)
        return intents, outcome

    # a query's wait past its worker's own latency: the dispatch overhead
    # where the worker had served before, its boot where it had not
    fleet_ms, worker_ms, overhead_ms, boot_wait_ms = {}, {}, {}, {}
    served = set()
    for o in outs:
        qid, inc = o["query_id"], o["fleet"]["incarnation"]
        intents, outcome = rows(journal, qid)
        fleet_ms[qid] = 1e3 * (outcome["t_epoch_s"]
                               - intents[0]["t_epoch_s"])
        worker_ms[qid] = o["latency_ms"]
        if len(intents) == 1:
            (overhead_ms if inc in served else boot_wait_ms)[qid] = (
                fleet_ms[qid] - o["latency_ms"])
        served.add(inc)
    failover_ms = fleet_ms[killed["query_id"]]
    j2 = QueryJournal(d2)
    intents2, outcome2 = rows(j2, "wd")
    respawn_s = next(r["t_epoch_s"] for r in intents2
                     if r["incarnation"] == "w0i2")
    # the first incarnation may die before its first heartbeat line
    reborn = [w for w in incs2 if w["first_lease_s"] >= respawn_s]
    if len(incs2) > 2 or len(reborn) != 1:
        raise AssertionError(f"(w2) incarnations {incs2}")
    cold_restart_ms = 1e3 * (reborn[0]["first_lease_s"] - respawn_s)
    for w in incs1 + incs2:
        for k, v in (w["last"].get("launches") or {}).items():
            total[k] += v
    if cuda:
        for name in ("radix_pass", "merge_scan"):
            if total[name] <= 0:
                raise AssertionError(f"(w) kernel {name} did not launch in "
                                     f"the workers: {total}")
        if any(not w["peak_bytes"] for w in incs1 + incs2
               if w["last"]["counters"].get("NCOMPILE")):
            raise AssertionError(f"(w) a serving worker's heartbeat holds "
                                 f"no device bytes: {incs1 + incs2}")

    def inc_row(w):
        c = w["last"].get("counters", {})
        return {"slot": w["slot"], "heartbeat_lines": w["lines"],
                "ncompile": c.get("NCOMPILE", 0),
                "compile_ms": c.get("COMPILEMS", 0),
                "peak_bytes": w["peak_bytes"],
                "launches": {k: v for k, v in
                             (w["last"].get("launches") or {}).items() if v}}

    emit({"phase": "fleet", "cell": "w", "tuples_per_node": n,
          "workers": W_WORKERS, "kill_at": W_KILL_AT,
          "failover_ms": failover_ms, "cold_restart_ms": cold_restart_ms,
          "fleet_latency_ms": fleet_ms, "worker_latency_ms": worker_ms,
          "in_process_warm_ms": warm_ms,
          "dispatch_overhead_ms": overhead_ms,
          "first_query_boot_wait_ms": boot_wait_ms,
          "dispatch_overhead_median_ms": (statistics.median(
              overhead_ms.values()) if overhead_ms else None),
          "restart_replay_ms": 1e3 * (outcome2["t_epoch_s"]
                                      - intents2[0]["t_epoch_s"]),
          "restart_query_worker_ms": out2["latency_ms"],
          "worker_peak_bytes_max": max(
              [w["peak_bytes"] for w in incs1 + incs2] or [0]),
          "incarnations_w1": [inc_row(w) for w in incs1],
          "incarnations_w2": [inc_row(w) for w in incs2],
          "summary_w1": {k: summary[k] for k in (
              "failover", "replayn", "worker_restarts", "incarnations",
              "jdepth", "unacked", "double_exec")},
          "summary_w2": {k: sum2[k] for k in (
              "failover", "replayn", "worker_restarts", "incarnations",
              "unacked", "double_exec")},
          "journal_audit_w1": audit.to_json(),
          "polls": len(polls), "compute_apps_before": apps0,
          "compute_apps": sorted({(p.get("apps"), len(p["live"]))
                                  for p in polls}),
          "w1_s": w1_s, "w2_s": w2_s,
          "seconds": time.perf_counter() - t_phase,
          "launches": {k: v for k, v in total.items() if v}, **card})
    shutil.rmtree(tmp, ignore_errors=True)
    return total


#: cell (x1): the host-fed grid at (k)'s shape
X_GRID_TUPLES = 1 << 26
X_CHUNK = 1 << 25
X_SLAB = 1 << 20
#: cell (x2): the degraded run's tuples a node (the plain versions on the
#: host; cut from 20M)
X_FALLBACK_TUPLES = 1 << 22
#: appended to every in-process command line of (x) (a CPU dry run sets
#: ``("--device", "cpu")``)
X_CLI_EXTRA = ()


def phase_x(dev, n, card) -> dict:
    """Cell (x): the host-fed chunk stream (ROADMAP A18a), the device-init
    fallback and the partition manifest (A18b) and the critical path
    (A18d's critpath.py), on the one card.

    (x1) The synchronous grid at (k)'s shape (``X_GRID_TUPLES`` unique ⋈
    unique, chunks of ``X_CHUNK``, slabs of ``X_SLAB``), fed once by
    ``stream_chunks`` (the native generator into a pinned pool, the copies
    on a side stream) and once by ``stream_chunks_device``, the same
    relations: both totals equal the oracle, K2's and K6's launches equal
    between the feeds, and the first chunk of each relation is bit-equal
    between them.  Each feed's grid ms, a chunk's host fill ms and H2D ms
    (CUDA events on the side stream), and the share of fill time hidden
    under the previous chunk; the host feed runs twice, first pinning its
    streams' pools, then on the pools the streams keep pinned; then the
    pipelined engine once on the host feed, exact.
    (x2) ``main(argv)`` in this process with ``engine.device_init`` armed
    and ``--cpu-fallback`` at ``X_FALLBACK_TUPLES`` a node: the
    ``[DEGRADE]`` line, an exact total on the CPU, no kernel launched; the
    same argv without the flag raises the injected fault; the flag on the
    healthy card at ``n``: the card's join (a), exact, K2 and K3 launched,
    no ``[DEGRADE]``.
    (x3) (a) at ``n`` with ``--elastic on --checkpoint-dir D``: 32
    manifest lines whose counts equal the same join's per-partition counts
    (``HashJoin.join`` beside it) and sum to the ``[RESULTS]`` total; a
    second run at the same fingerprint leaves ``completed()`` unchanged;
    another fingerprint (``--seed``) raises ``CheckpointMismatch``.
    (x4) (a) at ``n`` with ``--timeline-dir T``: the ``[CRITPATH]`` line;
    the path of T's span file (``critical_path_for_dir``) within JTOTAL
    plus 5%, its classes summing to the path; ``--plan explain
    --timeline-dir T`` prints the ``critical_path`` column; a two-query
    ``JoinSession`` with a tracer serves both paths in ``/statusz``'s
    ``critical_paths``.
    Returns the launches of every driven run (the comparisons' included
    only where they are main-path runs)."""
    import contextlib
    import io
    import shutil
    import tempfile
    import urllib.request
    import warnings
    import torch
    from tpu_radix_join_torch import HashJoin, JoinConfig, Relation
    from tpu_radix_join_torch import main as cli
    from tpu_radix_join_torch.core.config import ServiceConfig
    from tpu_radix_join_torch.data.streaming import (release_staging_pools,
                                                     stream_chunks,
                                                     stream_chunks_device)
    from tpu_radix_join_torch.observability.critpath import (
        critical_path_for_dir)
    from tpu_radix_join_torch.observability.statusz import StatuszServer
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.ops.chunked import chunked_join_grid
    from tpu_radix_join_torch.performance import Measurements
    from tpu_radix_join_torch.robustness import faults
    from tpu_radix_join_torch.robustness.checkpoint import (
        CheckpointMismatch, PartitionManifest)
    from tpu_radix_join_torch.service import JoinSession, QueryRequest

    cuda = dev.type == "cuda"
    total = {k: 0 for k in kernels.launch_counts()}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_x_")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def launched(fn):
        """``fn()`` with the launch counts set to 0 just before and read
        just after: (its result, the counts, seconds)."""
        sync()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs = time.perf_counter() - t0
        got = kernels.launch_counts()
        for k, v in got.items():
            total[k] += v
        return out, got, secs

    def need(cell, got, names):
        for k in names:
            if got[k] <= 0:
                raise AssertionError(f"(x) {cell}: kernel {k} did not "
                                     f"launch: {got}")

    def cli_run(argv, extra=X_CLI_EXTRA):
        """``main(argv)`` in this process: (exit code, stdout lines,
        stderr lines)."""
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main([*argv, *extra])
        return rc, out.getvalue().splitlines(), err.getvalue().splitlines()

    try:
        # ------------------------------------------------------------ (x1)
        rels = (Relation(X_GRID_TUPLES, 1, "unique", seed=1234),
                Relation(X_GRID_TUPLES, 1, "unique", seed=1235))
        for rel in rels:
            host = next(stream_chunks(rel, 0, X_CHUNK, device=dev))
            on_card = next(stream_chunks_device(rel, 0, X_CHUNK, dev))
            if not (torch.equal(host.key, on_card.key)
                    and torch.equal(host.rid, on_card.rid)):
                raise AssertionError("(x1) the host stream's first chunk "
                                     "differs from the device stream's")
            del host, on_card
        feeds, stats = {}, []

        def host_stream(rel):
            st = {}
            stats.append(st)
            return stream_chunks(rel, 0, X_CHUNK, device=dev, stats=st)

        # the first host feed pins its streams' pools; the second takes
        # them from the cache
        for feed in ("host_cold", "host", "device"):
            if feed.startswith("host"):
                del stats[:]
                args = (host_stream(rels[0]), lambda: host_stream(rels[1]))
            else:
                args = (stream_chunks_device(rels[0], 0, X_CHUNK, dev),
                        lambda: stream_chunks_device(rels[1], 0, X_CHUNK,
                                                     dev))
            meas = Measurements()
            got_total, got, secs = launched(lambda: chunked_join_grid(
                *args, X_SLAB, pipeline="off", measurements=meas))
            if got_total != X_GRID_TUPLES:
                raise AssertionError(f"(x1) {feed} feed: {got_total} "
                                     f"matches, the oracle {X_GRID_TUPLES}")
            need(f"x1_{feed}", got, ("radix_histogram", "radix_pass",
                                     "merge_scan_chunks"))
            feeds[feed] = {"grid_ms": secs * 1e3, "matches": got_total,
                           "launches": {k: v for k, v in got.items() if v},
                           "pairs": meas.counters.get("GRIDPAIRS", 0)}
        for k in ("radix_histogram", "radix_pass", "merge_scan_chunks"):
            if not (feeds["host_cold"]["launches"][k]
                    == feeds["host"]["launches"][k]
                    == feeds["device"]["launches"][k]):
                raise AssertionError(f"(x1) {k}: {feeds}")
        # the warm host feed's streams
        fill = [x for st in stats for x in st["fill_ms"]]
        h2d = [x for st in stats for x in st.get("h2d_ms", [])]
        # the first chunk of a stream has nothing to hide under
        later_fill = sum(x for st in stats for x in st["fill_ms"][1:])
        later_wait = sum(x for st in stats for x in st["wait_ms"][1:])
        hidden = 1.0 - later_wait / later_fill if later_fill else None
        st_pipe = {}
        got_total, got, secs = launched(lambda: chunked_join_grid(
            stream_chunks(rels[0], 0, X_CHUNK, device=dev),
            lambda: stream_chunks(rels[1], 0, X_CHUNK, device=dev,
                                  stats=st_pipe),
            X_SLAB, pipeline="on"))
        if got_total != X_GRID_TUPLES:
            raise AssertionError(f"(x1) pipelined host feed: {got_total}")
        need("x1_pipelined", got, ("radix_histogram", "radix_pass"))
        emit({"phase": "host_stream", "cell": "x1", "tuples": X_GRID_TUPLES,
              "chunk": X_CHUNK, "slab": X_SLAB, "feeds": feeds,
              "chunks_filled": len(fill),
              "fill_ms_median": statistics.median(fill),
              "h2d_ms_median": statistics.median(h2d) if h2d else None,
              "h2d_gb_s": (8 * X_CHUNK / statistics.median(h2d) / 1e6
                           if h2d else None),
              "fill_hidden_share": hidden,
              "pipelined_host_ms": secs * 1e3,
              "pipelined_launches": {k: v for k, v in got.items() if v},
              **card})

        # ------------------------------------------------------------ (x2)
        argv = ["--tuples-per-node", str(X_FALLBACK_TUPLES),
                "--cpu-fallback"]

        def degraded():
            with faults.FaultInjector(seed=23) as inj:
                inj.arm(faults.DEVICE_INIT, at=1)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    return cli_run(argv) + (inj.hits(faults.DEVICE_INIT),)

        (rc, out, err, hits), got, secs = launched(degraded)
        doc = json.loads(out[-1])
        lines = [x for x in err if x.startswith("[DEGRADE] ")]
        if (rc != 0 or not lines or "failure_class=device_unavailable"
                not in lines[0] or doc["device"] != "cpu"
                or doc["matches"] != X_FALLBACK_TUPLES or hits != 2):
            raise AssertionError(f"(x2) degraded run: rc {rc}, {lines}, "
                                 f"{doc}, hits {hits}")
        if cuda and any(got.values()):
            # (a CPU dry run counts its plain calls as launches)
            raise AssertionError(f"(x2) the degraded run launched a "
                                 f"kernel: {got}")
        x2 = {"degraded_ms": secs * 1e3, "degrade_line": lines[0][:200],
              "degraded_join_ms": doc["join_ms"]}
        try:
            with faults.FaultInjector(seed=23) as inj:
                inj.arm(faults.DEVICE_INIT, at=1)
                cli_run(argv[:-1])
            raise AssertionError("(x2) without --cpu-fallback the armed "
                                 "site did not fail the run")
        except faults.InjectedFault as e:
            x2["without_flag"] = str(e)
        (rc, out, err), got, secs = launched(lambda: cli_run(
            ["--tuples-per-node", str(n), "--cpu-fallback"]))
        doc = json.loads(out[-1])
        want_dev = card["name"] if cuda else "cpu"
        if (rc != 0 or doc["matches"] != n or doc["device"] != want_dev
                or any(x.startswith("[DEGRADE]") for x in err)):
            raise AssertionError(f"(x2) healthy --cpu-fallback: rc {rc}, "
                                 f"{doc}")
        need("x2_healthy", got, ("radix_pass", "merge_scan"))
        x2.update(healthy_join_ms=doc["join_ms"],
                  healthy_launches={k: v for k, v in got.items() if v})
        emit({"phase": "cpu_fallback", "cell": "x2",
              "tuples_degraded": X_FALLBACK_TUPLES, "tuples": n, **x2,
              **card})

        # ------------------------------------------------------------ (x3)
        ck = os.path.join(tmp, "ck")
        argv = ["--tuples-per-node", str(n), "--elastic", "on",
                "--checkpoint-dir", ck, "--lease-dir",
                os.path.join(tmp, "leases")]
        (rc, out, err), got, secs = launched(lambda: cli_run(argv))
        need("x3", got, ("radix_pass", "merge_scan"))
        tuples = [int(x.split(":")[1]) for x in out
                  if x.startswith("[RESULTS] Tuples:")]
        path = os.path.join(ck, "partitions.manifest")
        fp = f"elastic:unique:{n}:1234:32"
        mf = PartitionManifest(path, fingerprint=fp)
        done = mf.completed()
        with open(path) as f:
            n_lines = len(f.readlines()) - 1
        eng = HashJoin(JoinConfig(), device=dev)
        res, got_ref, _ = launched(lambda: eng.join(
            Relation(n, 1, "unique", seed=1234),
            Relation(n, 1, "unique", seed=1235)))
        per_p = [int(c) for c in res.partition_counts]
        if (rc != 0 or tuples != [n] or n_lines != 32
                or sorted(done) != list(range(32))
                or [done[p]["count"] for p in range(32)] != per_p
                or sum(per_p) != n or mf.audit()["total"] != n):
            raise AssertionError(f"(x3) manifest: rc {rc}, {tuples}, "
                                 f"{n_lines} lines, {done}, {per_p}")
        rc2, _, _ = cli_run(argv)
        if rc2 != 0 or PartitionManifest(path, fp).completed() != done:
            raise AssertionError("(x3) a second run at the same "
                                 "fingerprint changed completed()")
        try:
            cli_run([*argv, "--seed", "9"])
            raise AssertionError("(x3) another fingerprint did not raise")
        except CheckpointMismatch as e:
            mismatch = str(e)[:120]
        emit({"phase": "manifest", "cell": "x3", "tuples": n,
              "lines": n_lines, "total": mf.audit()["total"],
              "first_run_ms": secs * 1e3,
              "launches": {k: v for k, v in got.items() if v},
              "mismatch": mismatch, **card})

        # ------------------------------------------------------------ (x4)
        tl = os.path.join(tmp, "tl")
        (rc, out, err), got, secs = launched(lambda: cli_run(
            ["--tuples-per-node", str(n), "--timeline-dir", tl,
             "--lease-dir", os.path.join(tmp, "leases4")]))
        need("x4", got, ("radix_pass", "merge_scan"))
        crit = [x for x in out if x.startswith("[CRITPATH] ")]
        doc = json.loads(out[-1])
        jtotal_ms = doc["phases_us"]["JTOTAL"] / 1e3
        cp = critical_path_for_dir(tl)
        seg_sum = sum(s["compute_ms"] + s["collective_wait_ms"]
                      + s["straggle_ms"] for s in cp.get("segments", []))
        if (rc != 0 or len(crit) != 1 or "error" in cp
                or not 0 < cp["path_ms"] <= 1.05 * jtotal_ms
                or abs(sum(cp["fractions"].values()) - 1.0) > 2e-3
                or abs(seg_sum - cp["path_ms"]) > 0.01 + 1e-3 * len(
                    cp["segments"])):
            raise AssertionError(f"(x4) critical path: rc {rc}, {crit}, "
                                 f"JTOTAL {jtotal_ms}, {cp}")
        rc, out, _ = cli_run(["--tuples-per-node", str(n), "--plan",
                              "explain", "--timeline-dir", tl,
                              "--lease-dir", os.path.join(tmp, "leases4")])
        header = next((x for x in out if x.startswith("| strategy")), "")
        if rc != 0 or "critical_path" not in header:
            raise AssertionError(f"(x4) --plan explain: rc {rc}, {out[:3]}")
        meas = Measurements()
        meas.attach_tracer(nodes=1)
        sess = JoinSession(JoinConfig(), ServiceConfig(), measurements=meas,
                           device=dev)
        server = StatuszServer(sections={
            "critical_paths": lambda: list(sess.recent_critical_paths)})
        server.start()
        try:
            lat = []
            for i in range(2):
                sess.submit(QueryRequest(query_id=f"x{i}", tuples_per_node=n,
                                         seed=1234 + 2 * i))
                o, got, secs = launched(sess.run_next)
                need(f"x4_q{i}", got, ("radix_pass", "merge_scan"))
                if o.status != "ok" or o.matches != o.expected:
                    raise AssertionError(f"(x4) session: {o}")
                lat.append(secs * 1e3)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/statusz",
                    timeout=30) as rsp:
                body = json.load(rsp)
        finally:
            server.stop()
            sess.close()
        paths = body.get("critical_paths") or []
        if ([p.get("query_id") for p in paths] != ["x0", "x1"]
                or any("error" in p for p in paths)):
            raise AssertionError(f"(x4) /statusz critical_paths: {paths}")
        emit({"phase": "critpath", "cell": "x4", "tuples": n,
              "critpath_line": crit[0][:240], "path_ms": cp["path_ms"],
              "jtotal_ms": jtotal_ms, "fractions": cp["fractions"],
              "top_phase": cp["top_phase"],
              "explain_header": header[:160],
              "session_paths_ms": [p["path_ms"] for p in paths],
              "session_latency_ms": lat, **card})
    finally:
        release_staging_pools()
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "x_summary", "seconds": time.perf_counter() - t_phase,
          "launches": {k: v for k, v in total.items() if v}, **card})
    return total


Y_RANKS = 2
Y_TUPLES = 20_000_000
Y_LEASE_S = 1.0
Y_MISSED_BEATS = 2
Y_STRAGGLE_FACTOR = 40
Y_SOAK_RUNS = 6
Y_SOAK_TUPLES = 1 << 16
#: the soaks' first seeds: a schedule that arms ``engine.device_init``
#: ends before its join, so these windows are ones where most schedules
#: reach it (the recovery soak's six all do, the join soak's five, two of
#: them passing: a CPU run of two gloo ranks at 2^14 gives pass 6 and
#: pass 2 with capacity_overflow, data_corruption and device_unavailable)
Y_SOAK_RECOVERY_SEED = 380
Y_SOAK_JOIN_SEED = 303
Y_CHECK_PARTITIONS = 2
Y_DEADLINE_S = 300.0
#: the ranks' device flag (a CPU dry run passes ``("--device", "cpu")``)
Y_DEVICE_ARGS = ("--device", "cuda")
Y_RANK_FLAG = "--phase-y-rank"
Y_CLI_FLAG = "--phase-y-cli"


def y_cli_rank(argv) -> int:
    """One command-line rank of phases (y) and (aa): joins the ``env://``
    group as an elastic gloo group on ``argv``'s ``--device`` (several
    ranks on one card, their collectives through the host), then runs the
    command line's ``main(argv)``, which takes that group.  With
    :data:`AA_TRIPS_ENV` set, every guard trip is echoed to stderr as it
    happens (``listing_trips``): a survivor leaves by ``os._exit``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_radix_join_torch import main as cli
    from tpu_radix_join_torch.parallel import multihost
    device = argv[argv.index("--device") + 1]
    multihost.initialize(device=device, backend="gloo",
                         elastic_lapse_s=Y_LEASE_S * Y_MISSED_BEATS)
    if os.environ.get(AA_TRIPS_ENV):
        with listing_trips(echo=True):
            return cli.main(argv)
    return cli.main(argv)


def y_soak_rank(rank: int, world: int, init_method: str,
                spec: dict) -> dict:
    """One rank of (y6) (see :func:`phase_y`): joins a gloo group on
    ``spec["device"]`` and runs ``soak_recovery`` and ``soak`` through
    runners over the group; returns both summaries, the outcomes'
    statuses and the launches."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.parallel import multihost
    from tpu_radix_join_torch.robustness import chaos, faults
    dev = torch.device(spec["device"], 0) if spec["device"] == "cuda" \
        else torch.device("cpu")
    multihost.initialize(init_method=init_method, world_size=world,
                         rank=rank, device=dev.type, backend="gloo",
                         timeout_s=spec["timeout_s"])
    try:
        kernels.reset_launches()
        kw = dict(num_nodes=world, size=spec["tuples"], device=dev,
                  group=dist.group.WORLD)
        runner = chaos.RecoveryChaosRunner(**kw)
        t0 = time.perf_counter()
        try:
            outs_r, rec = chaos.soak_recovery(
                spec["runs"], base_seed=Y_SOAK_RECOVERY_SEED, runner=runner)
        finally:
            runner.close()
        t1 = time.perf_counter()
        outs_j, join = chaos.soak(spec["runs"], base_seed=Y_SOAK_JOIN_SEED,
                                  runner=chaos.ChaosRunner(**kw))
        t2 = time.perf_counter()
        return {"rank": rank, "recovery": rec, "join": join,
                "statuses": [o.status for o in outs_r + outs_j],
                # a run whose schedule arms the constructor's site ends
                # before its join
                "reached_join": sum(
                    all(site != faults.DEVICE_INIT
                        for site, _ in o.schedule.arms)
                    for o in outs_r + outs_j),
                "details": [o.detail[:200] for o in outs_r + outs_j
                            if o.status == chaos.VIOLATION],
                "recovery_s": t1 - t0, "join_s": t2 - t1,
                "launches": kernels.launch_counts()}
    finally:
        multihost.shutdown()


def y_processes(cmds, deadline_s=Y_DEADLINE_S, start_gap=None):
    """Start every ``(argv, env)`` of ``cmds`` (``start_gap(i)``, when
    given, runs before the i-th start) and wait for all under one
    deadline: their exit codes, stdouts and stderrs.  Every process is
    reaped on the way out."""
    import threading
    procs, outs, errs = [], [], []
    try:
        for i, (argv, env) in enumerate(cmds):
            if start_gap is not None:
                start_gap(i, procs, errs)
            p = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env,
                                 cwd=os.path.dirname(os.path.abspath(
                                     __file__)))
            procs.append(p)
            for stream, sink in ((p.stdout, outs), (p.stderr, errs)):
                sink.append([])
                threading.Thread(target=lambda st=stream, o=sink[-1]:
                                 o.extend(st.readlines()),
                                 daemon=True).start()
        end = time.monotonic() + deadline_s
        while any(p.poll() is None for p in procs):
            if time.monotonic() > end:
                raise AssertionError(
                    f"(y) processes passed their deadline: "
                    f"{''.join(errs[0])[-3000:]}")
            time.sleep(0.1)
        time.sleep(0.2)       # the drains' last lines
        return ([p.returncode for p in procs],
                ["".join(o) for o in outs], ["".join(e) for e in errs])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def y_elastic_lines(err: str) -> list:
    """The ``[ELASTIC] {...}`` records of a rank's stderr."""
    return [json.loads(x[len("[ELASTIC] "):]) for x in err.splitlines()
            if x.startswith("[ELASTIC] {")]


def y_last_json(out: str):
    lines = [x for x in out.splitlines() if x.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def phase_y(dev, n, card) -> dict:
    """Cell (y): membership, recovery, stragglers and chaos over several
    ranks (ROADMAP A18c), on the one card: :data:`Y_RANKS` plain processes
    of the command line (``main(argv)`` behind ``y_cli_rank``: an
    ``env://`` rendezvous of a gloo group, several ranks on one card, no
    torchrun agent) at ``n`` tuples a rank, unique ⋈ unique, the
    main path's defaults (fanout 5, the sort probe), ``--elastic on`` with
    a lease of :data:`Y_LEASE_S` s and :data:`Y_MISSED_BEATS` missed beats.

    (y1) a simulated death at boundary 2 (``--rank-death-at 2`` on every
    rank): every rank recovers the oracle's ``2n`` (``[ELASTIC]``'s
    matches), RANKLOST 1, MEPOCH 1, RECOVERN 32, and K2 and K6 launched
    during each rank's recovery;
    (y2) a real death: rank 1 alone is armed and SIGKILLs itself at
    boundary 2 (``TPU_RJ_RANK_DEATH_SUICIDE=1``); the survivor finds it
    behind gloo's reset connection and the lapsed lease, exits 0 and
    exact;
    the time from the kill to detection, the host regeneration, the
    recompute and the total;
    (y3) resume: a manifest holding the true counts of 16 of the 32
    partitions (``--checkpoint-dir``), then (y1)'s death: RECOVERN below
    32, 16 resumed, the spliced total and the manifest's audit exact;
    (y4) ``compute.straggle`` (``--straggle-factor`` x 0.05 s on every
    rank, the victim rank 1) with ``--hedge on`` and a manifest, then with
    the hedge off: both exact, each join's time, HEDGED 1 and HEDGEWIN +
    SPECWASTE equal to the hedged partitions;
    (y5) growth: a newcomer (``--elastic-join 2``) starts first, two
    ``--elastic-grow`` incumbents admit it: all three exit 0 and exact,
    RANKJOIN 1, the partitions the newcomer recomputed (on the card: K2
    and K6 launched in its process) among the manifest's lines of its
    rank;
    (y6) ``soak_recovery`` and ``soak`` over :data:`Y_SOAK_RUNS` seeds at
    :data:`Y_SOAK_TUPLES` a world on a gloo group of :data:`Y_RANKS`
    ranks (``chip_smoke.py --phase-y-rank``), from seed windows where most
    schedules reach the join: no VIOLATION, every rank's summary the same,
    and each soak with a pass.
    Then the recovery path's K2 and K6 held bit-exact against their plain
    versions on that path's inputs: :data:`Y_CHECK_PARTITIONS` partitions
    of (y1)'s relations recovered in this process, every sort and window
    scan the grid makes recorded and replayed through the plain versions.
    Returns the launches of the main-path runs (the reporters' and the
    newcomer's whole processes, the soaks' ranks)."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import torch
    from tpu_radix_join_torch import Relation
    from tpu_radix_join_torch.ops import kernels, merge_count, sorting
    from tpu_radix_join_torch.ops.kernels import merge_scan_chunks as k6
    from tpu_radix_join_torch.ops.kernels import radix_sort as k2
    from tpu_radix_join_torch.robustness import recovery
    from tpu_radix_join_torch.robustness.checkpoint import PartitionManifest

    cuda = dev.type == "cuda"
    total = {k: 0 for k in kernels.launch_counts()}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_y_")
    here = os.path.dirname(os.path.abspath(__file__))
    global_n = Y_RANKS * n
    num_p = 32
    fp = f"elastic:unique:{global_n}:1234:{num_p}"

    def add(launches):
        for k, v in (launches or {}).items():
            total[k] += v

    def rank_env(rank, port, **extra):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(Y_RANKS), LOCAL_RANK="0",
                   PYTHONPATH=here + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")   # one host: loopback
        env.pop("TPU_RJ_RANK_DEATH_SUICIDE", None)
        env.update(extra)
        return env

    def cli(*argv, leases, rank=True):
        """A rank's command (``y_cli_rank``), or with ``rank=False`` the
        command line alone (a newcomer outside the group)."""
        head = ([sys.executable, os.path.abspath(__file__), Y_CLI_FLAG]
                if rank else
                [sys.executable, "-m", "tpu_radix_join_torch.main"])
        return [*head, *Y_DEVICE_ARGS, "--nodes", str(Y_RANKS),
                "--tuples-per-node", str(n), "--elastic", "on",
                "--rank-lease-s", str(Y_LEASE_S),
                "--rank-missed-beats", str(Y_MISSED_BEATS),
                "--lease-dir", os.path.join(tmp, leases), *argv]

    def world(case, *argv, envs=None, victim=()):
        """Every rank runs ``argv``; rank ``Y_RANKS - 1`` adds
        ``victim``'s flags and ``envs``' last entry its environment."""
        port = free_port()
        envs = envs or [{}] * Y_RANKS
        t0 = time.perf_counter()
        rcs, outs, errs = y_processes([
            (cli(*argv, *(victim if r == Y_RANKS - 1 else ()), leases=case),
             rank_env(r, port, **envs[r]))
            for r in range(Y_RANKS)])
        return rcs, outs, errs, time.perf_counter() - t0

    def fail(case, rcs, outs, errs):
        raise AssertionError(f"({case}) rcs {rcs}:\n"
                             + "\n---\n".join(o[-1500:] + e[-2500:]
                                              for o, e in zip(outs, errs)))

    def recovered_ranks(case, errs, rcs, outs, ranks):
        recs = []
        for r in ranks:
            got = [x for x in y_elastic_lines(errs[r])
                   if x.get("kind") in ("recovery", "hedge", "regrow")]
            if len(got) != 1 or got[0]["matches"] != global_n:
                fail(case, rcs, outs, errs)
            if cuda and not (got[0]["launches"].get("radix_pass", 0) > 0
                             and got[0]["launches"].get(
                                 "merge_scan_chunks", 0) > 0):
                raise AssertionError(f"({case}) rank {r}'s recovery did not "
                                     f"launch K2 and K6: {got[0]}")
            recs.append(got[0])
        return recs

    try:
        # ------------------------------------------------------------ (y1)
        rcs, outs, errs, secs = world("y1", "--rank-death-at", "2")
        doc = y_last_json(outs[0])
        if rcs != [0] * Y_RANKS or doc is None:
            fail("y1", rcs, outs, errs)
        c = doc["counters"]
        if (doc["matches"] != global_n or not doc["recovered"]
                or c.get("RANKLOST") != 1 or c.get("MEPOCH") != 1
                or c.get("RECOVERN") != num_p):
            fail("y1", rcs, outs, errs)
        recs = recovered_ranks("y1", errs, rcs, outs, range(Y_RANKS))
        add(doc.get("launches"))
        emit({"phase": "elastic", "cell": "y1", "tuples_per_rank": n,
              "ranks": Y_RANKS, "matches": doc["matches"],
              "counters": {k: c[k] for k in ("RANKLOST", "MEPOCH",
                                             "RECOVERN", "RECOVERMS")},
              "regen_s": [x["regen_s"] for x in recs],
              "recompute_s": [x["recompute_s"] for x in recs],
              "total_s": [x["total_s"] for x in recs],
              "recovery_launches": [x["launches"] for x in recs],
              "run_s": secs, **card})

        # ------------------------------------------------------------ (y2)
        rcs, outs, errs, secs = world(
            "y2", victim=("--rank-death-at", "2"),
            envs=[{}, {"TPU_RJ_RANK_DEATH_SUICIDE": "1"}])
        doc = y_last_json(outs[0])
        death = [x for x in errs[1].splitlines()
                 if x.startswith("[ELASTIC] rank_death ")]
        if (rcs[0] != 0 or rcs[1] != -9 or doc is None or not death
                or doc["matches"] != global_n or not doc["recovered"]
                or "[RESULTS] recovered: epoch=1 lost_ranks=[1]"
                not in outs[0]):
            fail("y2", rcs, outs, errs)
        (rec,) = recovered_ranks("y2", errs, rcs, outs, [0])
        killed_t = float(death[0].split("t_epoch_s=")[1].split()[0])
        add(doc.get("launches"))
        emit({"phase": "elastic", "cell": "y2", "tuples_per_rank": n,
              "matches": doc["matches"], "victim_rc": rcs[1],
              "detect_s": rec["detected_t"] - killed_t,
              "regen_s": rec["regen_s"], "recompute_s": rec["recompute_s"],
              "recovery_total_s": rec["total_s"],
              "kill_to_done_s": rec["detected_t"] - killed_t
              + rec["total_s"],
              "lapse_window_s": Y_LEASE_S * Y_MISSED_BEATS,
              "counters": {k: doc["counters"].get(k) for k in
                           ("RANKLOST", "MEPOCH", "RECOVERN")},
              "recovery_launches": rec["launches"], "run_s": secs, **card})

        # ------------------------------------------------------------ (y3)
        ck = os.path.join(tmp, "ck3")
        os.makedirs(ck)
        sk, _ = Relation(global_n, Y_RANKS, "unique",
                         seed=1235).fill_np(0, global_n)
        true = np.bincount(sk & np.uint32(num_p - 1), minlength=num_p)
        del sk
        PartitionManifest(os.path.join(ck, "partitions.manifest"),
                          fingerprint=fp).mark_many(
            {p: int(true[p]) for p in range(num_p // 2)},
            owner_of=lambda p: p % Y_RANKS)
        rcs, outs, errs, secs = world("y3", "--rank-death-at", "2",
                                      "--checkpoint-dir", ck)
        doc = y_last_json(outs[0])
        aud = PartitionManifest(os.path.join(ck, "partitions.manifest"),
                                fingerprint=fp).audit()
        if (rcs != [0] * Y_RANKS or doc is None
                or doc["matches"] != global_n
                or not 0 < doc["counters"].get("RECOVERN", 0) < num_p
                or f"resumed={num_p // 2} " not in outs[0]
                or aud["total"] != global_n):
            fail("y3", rcs, outs, errs)
        recs = [x for r in range(Y_RANKS) for x in y_elastic_lines(errs[r])]
        add(doc.get("launches"))
        emit({"phase": "elastic", "cell": "y3", "tuples_per_rank": n,
              "matches": doc["matches"], "resumed": num_p // 2,
              "recovern": doc["counters"]["RECOVERN"],
              "manifest_total": aud["total"],
              "fenced_duplicates": len(aud["fenced_duplicates"]),
              "total_s": [x["total_s"] for x in recs], "run_s": secs,
              **card})

        # ------------------------------------------------------------ (y4)
        hedge = {}
        for mode in ("on", "off"):
            extra = (["--hedge", "on", "--checkpoint-dir",
                      os.path.join(tmp, "ck4")] if mode == "on" else [])
            rcs, outs, errs, secs = world(
                f"y4_{mode}", "--straggle-factor", str(Y_STRAGGLE_FACTOR),
                *extra)
            doc = y_last_json(outs[0])
            if rcs != [0] * Y_RANKS or doc is None \
                    or doc["matches"] != global_n:
                fail(f"y4_{mode}", rcs, outs, errs)
            c = doc["counters"]
            row = {"join_ms": doc["join_ms"], "run_s": secs,
                   "hedged": c.get("HEDGED", 0),
                   "hedgewin": c.get("HEDGEWIN", 0),
                   "specwaste": c.get("SPECWASTE", 0)}
            if mode == "on":
                line = [x for x in outs[0].splitlines()
                        if x.startswith("[RESULTS] hedged: ")]
                parts = (int(line[0].split("partitions=")[1].split()[0])
                         if line else -1)
                if (c.get("HEDGED") != 1 or parts <= 0
                        or row["hedgewin"] + row["specwaste"] != parts
                        or c.get("MEPOCH", 0) != 0):
                    fail("y4_on", rcs, outs, errs)
                row["hedged_partitions"] = parts
                (rec,) = recovered_ranks("y4_on", errs, rcs, outs, [0])
                row.update(recompute_s=rec["recompute_s"],
                           regen_s=rec["regen_s"])
            elif doc["recovered"] or c.get("HEDGED"):
                fail("y4_off", rcs, outs, errs)
            add(doc.get("launches"))
            hedge[mode] = row
        emit({"phase": "elastic", "cell": "y4", "tuples_per_rank": n,
              "straggle_s": Y_STRAGGLE_FACTOR * 0.05, **hedge, **card})

        # ------------------------------------------------------------ (y5)
        ck = os.path.join(tmp, "ck5")
        port = free_port()
        leases = os.path.join(tmp, "y5")
        joiner_argv = cli("--elastic-join", str(Y_RANKS), "--checkpoint-dir",
                          ck, leases="y5", rank=False)
        joiner_env = dict(rank_env(0, port))
        for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
            joiner_env.pop(k)

        def newcomer_first(i, procs, errs_):
            if i != 1:
                return
            lease = os.path.join(leases, f"lease_r{Y_RANKS}.json")
            end = time.monotonic() + 120
            while not os.path.exists(lease):
                if time.monotonic() > end or procs[0].poll() is not None:
                    raise AssertionError("(y5) the newcomer's joining "
                                         "lease never appeared")
                time.sleep(0.1)

        t0 = time.perf_counter()
        rcs, outs, errs = y_processes(
            [(joiner_argv, joiner_env)]
            + [(cli("--elastic-grow", "--checkpoint-dir", ck, leases="y5"),
                rank_env(r, port)) for r in range(Y_RANKS)],
            start_gap=newcomer_first)
        secs = time.perf_counter() - t0
        doc = y_last_json(outs[1])
        with open(os.path.join(ck, "partitions.manifest")) as f:
            lines = [json.loads(x) for x in f.readlines()[1:] if x.strip()]
        newcomer_lines = [x for x in lines if x.get("owner") == Y_RANKS
                          and "count" in x]
        joined = [x for x in y_elastic_lines(errs[0])
                  if x.get("kind") == "joiner"]
        if (rcs != [0] * (Y_RANKS + 1) or doc is None
                or doc["matches"] != global_n
                or doc["counters"].get("RANKJOIN") != 1
                or f"[RESULTS] joiner: rank={Y_RANKS} epoch=1" not in outs[0]
                or f"[RESULTS] Expected: {global_n} (OK)" not in outs[0]
                or not joined or not 0 < joined[0]["recomputed"]
                <= len(newcomer_lines)):
            fail("y5", rcs, outs, errs)
        if cuda and not (joined[0]["launches"].get("radix_pass", 0) > 0
                         and joined[0]["launches"].get(
                             "merge_scan_chunks", 0) > 0):
            raise AssertionError(f"(y5) the newcomer launched no K2/K6: "
                                 f"{joined[0]}")
        regrow = recovered_ranks("y5", errs, rcs, outs, [1])
        add(doc.get("launches"))
        add(joined[0]["launches"])
        emit({"phase": "elastic", "cell": "y5", "tuples_per_rank": n,
              "matches": doc["matches"],
              "newcomer_lines": len(newcomer_lines),
              "newcomer_recomputed": joined[0]["recomputed"],
              "newcomer_recompute_s": joined[0]["recompute_s"],
              "incumbent_total_s": regrow[0]["total_s"],
              "newcomer_launches": joined[0]["launches"], "run_s": secs,
              **card})

        # ------------------------------------------------------------ (y6)
        spec = {"device": dev.type, "tuples": Y_SOAK_TUPLES,
                "runs": Y_SOAK_RUNS, "timeout_s": Y_DEADLINE_S}
        init = f"file://{os.path.join(tmp, 'rendezvous6')}"
        t0 = time.perf_counter()
        env = rank_env(0, 0)
        rcs, outs, errs = y_processes([
            ([sys.executable, os.path.abspath(__file__), Y_RANK_FLAG,
              str(r), str(Y_RANKS), init, json.dumps(spec)], env)
            for r in range(Y_RANKS)])
        res = [y_last_json(o) for o in outs]
        if rcs != [0] * Y_RANKS or None in res:
            fail("y6", rcs, outs, errs)
        for r in res:
            if (r["recovery"]["violations"] or r["join"]["violations"]
                    or not r["recovery"]["pass"] or not r["join"]["pass"]
                    or r["recovery"] != res[0]["recovery"]
                    or r["join"] != res[0]["join"]
                    or r["recovery"]["wdogtrip"]):
                raise AssertionError(f"(y6) soak: {r}")
            add(r["launches"])
        emit({"phase": "elastic", "cell": "y6", "tuples": Y_SOAK_TUPLES,
              "runs": Y_SOAK_RUNS, "recovery": res[0]["recovery"],
              "join": res[0]["join"], "reached_join": res[0]["reached_join"],
              "recovery_s": [r["recovery_s"] for r in res],
              "join_s": [r["join_s"] for r in res],
              "run_s": time.perf_counter() - t0, **card})

        # ------------------------------------- the recovery's K2 and K6
        rk, _ = recovery.host_keys(Relation(global_n, Y_RANKS, "unique",
                                            seed=1234))
        sk, _ = recovery.host_keys(Relation(global_n, Y_RANKS, "unique",
                                            seed=1235))
        plan = recovery.plan_recovery(
            num_nodes=Y_RANKS, num_partitions=num_p, lost_ranks=[1],
            epoch=1, weights=recovery.partition_weights(rk, sk, num_p))
        plan = dataclasses.replace(
            plan, recompute=plan.recompute[:Y_CHECK_PARTITIONS])
        sorts, scans = [], []
        real_sort, real_scan = sorting.radix_sort, \
            merge_count.merge_scan_chunks

        def sort_rec(operands, *a, **kw):
            out = real_sort(operands, *a, **kw)
            sorts.append(([x.clone() for x in operands], a, kw, out))
            return out

        def scan_rec(packed, *a, **kw):
            out = real_scan(packed, *a, **kw)
            scans.append((packed.clone(), a, kw, out))
            return out

        sorting.radix_sort, merge_count.merge_scan_chunks = sort_rec, \
            scan_rec
        try:
            kernels.reset_launches()
            matches, counts = recovery.execute_recovery(
                plan, rk, sk, device=dev)
            got = kernels.launch_counts()
        finally:
            sorting.radix_sort, merge_count.merge_scan_chunks = real_sort, \
                real_scan
        want = {p: int(true[p]) for p in plan.recompute}
        if counts != want or not sorts or not scans:
            raise AssertionError(f"(y) the recovery check: {counts} "
                                 f"against {want}, {len(sorts)} sorts, "
                                 f"{len(scans)} scans")
        errs_k2, errs_k6 = [], []
        for operands, a, kw, out in sorts:
            ref = k2.radix_sort_plain(operands, kw.get("num_keys", 1),
                                      kw.get("key_bounds"))
            errs_k2 += [int((g.to(torch.int64) - r.to(torch.int64))
                            .abs().max()) if g.numel() else 0
                        for g, r in zip(out, ref)]
        for packed, a, kw, out in scans:
            ref = k6.merge_scan_chunks_plain(packed, kw["width"])
            errs_k6 += [int((out[0].to(torch.int64) - ref[0].to(torch.int64))
                            .abs().max()) if out[0].numel() else 0,
                        abs(int(out[1]) - int(ref[1]))]
        if max(errs_k2) or max(errs_k6):
            raise AssertionError(f"(y) the recovery's K2/K6 disagree with "
                                 f"their plain versions: {errs_k2} "
                                 f"{errs_k6}")
        emit({"phase": "elastic_kernels", "cell": "y",
              "partitions": list(plan.recompute),
              "k2_calls": len(sorts), "k6_calls": len(scans),
              "k2_max_abs_err": max(errs_k2), "k6_max_abs_err": max(errs_k6),
              "elements": [int(s[0][0].numel()) for s in sorts],
              "launches": {k: v for k, v in got.items() if v}, **card})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "y_summary", "seconds": time.perf_counter() - t_phase,
          "launches": {k: v for k, v in total.items() if v}, **card})
    return total


#: (c)'s join in (z1): modulo(Z_K1_MODULO) ⋈ unique at Z_K1_TUPLES, whose
#: largest weight times |S| passes 2**32, so the overflow guard runs K1
#: (a CPU dry run: 2**16 and modulo 1)
Z_K1_TUPLES = 1 << 24
Z_K1_MODULO = 65536
Z_GRID_TUPLES = 1 << 24
Z_CHUNK = 1 << 23
Z_SLAB = 1 << 20
Z_REPS = 10
#: the guard's mode around (z1) and (z3) on the card ("log" warns
#: instead, to list every trip of a run)
Z_GUARD = "disallow"
#: arguments (z2) adds to its command lines (none on the card)
Z_CLI_EXTRA = ()


@contextlib.contextmanager
def counting_readbacks():
    """Count the sanctioned readbacks, uploads and fences
    (``utils/hostsync``) of the port's modules: each module's own binding
    of ``host_readback``, ``host_upload``, ``host_fence`` and
    ``stream_fence`` is wrapped for the block.  Yields the counts."""
    from tpu_radix_join_torch.utils import hostsync
    counts = {"host_readback": 0, "host_upload": 0, "host_fence": 0,
              "stream_fence": 0}
    saved = []

    def wrap(name, fn):
        def counted(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return counted

    originals = {name: getattr(hostsync, name) for name in counts}
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("tpu_radix_join_torch"):
            continue
        for name, fn in originals.items():
            if getattr(mod, name, None) is fn:
                saved.append((mod, name, fn))
                setattr(mod, name, wrap(name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_z(dev, n, card) -> dict:
    """Cell (z): the sync guard (``utils/hostsync.sync_guard``, ROADMAP
    A18e) on the card, around the main paths, and the port's command-line
    tools.

    (z1) ``HashJoin(JoinConfig())`` on ``n`` ⋈ ``n`` unique placed lanes
    (generation and placement outside the guard) under
    ``sync_guard("disallow")``: exact, K2 and K3 launched, SORTPASS equal
    to K2's sorts (its histogram launches); the count of sanctioned
    readbacks, uploads and fences a join makes (this script wraps each
    module's ``host_readback``); then (c)'s modulo(65536) ⋈ unique at
    ``Z_K1_TUPLES``, whose overflow guard runs K1, the same way.
    (z2) ``main(argv)`` in this process with ``--transfer-guard
    disallow --timeline-dir T`` at ``n``, twice: exit 0 and the oracle's
    OK; ``tools.critical_path T --summary`` exits 0 with one
    ``[CRITPATH]`` line; ``tools.check_regress`` over the two runs' result
    lines (the second against the first, ``--threshold 1.0``: the plumbing
    of two runs of one join, no gain claimed) exits 0.
    (z3) Under the guard: ``chunked_join_grid`` at ``Z_GRID_TUPLES`` ⋈
    ``Z_GRID_TUPLES`` unique in chunks of ``Z_CHUNK``, synchronous (slabs
    of ``Z_SLAB``: K2 and K6) and pipelined (K2); a ``JoinSession``'s
    ``submit`` / ``run_next``, a cold query and a warm one at ``n``; on an
    NCCL group of one rank at ``n``: the generic body (``join_shuffled``:
    K1, K4, the all_to_all, K2, K3), and the paths whose implicit syncs the
    guard found on the card (routed since): the bucket probe, the generic
    body with ``debug_checks``, with ``verify="repair"`` and the corrupt
    lane armed once, and ``join_materialize_arrays``.  Each exact.
    (z4) Negative controls: a bare ``.cpu()`` of a CUDA tensor under
    ``disallow`` raises, under ``log`` warns and returns its values.
    (z5) (a) with the guard off and at ``disallow``, ``Z_REPS`` joins each,
    interleaved: their medians.
    (z6) ``python -m tpu_radix_join_torch.tools.lint --strict`` exits 0.
    Returns the launches of the driven main paths."""
    import io
    import shutil
    import tempfile
    import warnings
    import torch
    import torch.distributed as dist
    from tpu_radix_join_torch import HashJoin, JoinConfig, Relation
    from tpu_radix_join_torch import main as cli
    from tpu_radix_join_torch.core.config import ServiceConfig
    from tpu_radix_join_torch.data.streaming import stream_chunks_device
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.ops.chunked import chunked_join_grid
    from tpu_radix_join_torch.parallel import multihost
    from tpu_radix_join_torch.performance import Measurements
    from tpu_radix_join_torch.robustness import faults
    from tpu_radix_join_torch.service import JoinSession, QueryRequest
    from tpu_radix_join_torch.tools import check_regress, critical_path
    from tpu_radix_join_torch.utils.hostsync import host_fence, sync_guard

    cuda = dev.type == "cuda"
    guard = Z_GUARD if cuda else "off"
    total = {k: 0 for k in kernels.launch_counts()}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_z_")

    def launched(fn, mode=guard):
        """``fn()`` under the guard at ``mode`` with the launch counts set
        to 0 just before and read just after: (its result, the counts,
        seconds)."""
        host_fence(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        with sync_guard(mode):
            out = fn()
            host_fence(dev)
        secs = time.perf_counter() - t0
        got = kernels.launch_counts()
        for k, v in got.items():
            total[k] += v
        return out, got, secs

    def need(cell, got, names):
        for k in names:
            if got[k] <= 0:
                raise AssertionError(f"(z) {cell}: kernel {k} did not "
                                     f"launch: {got}")

    def quiet(fn):
        """``fn()`` with its stdout and stderr captured: (result, stdout
        lines, stderr lines)."""
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = fn()
        return rc, out.getvalue().splitlines(), err.getvalue().splitlines()

    try:
        # ------------------------------------------------------------ (z1)
        z1 = {}
        for name, inner, outer, expected, extra in (
                ("unique_20M", Relation(n, 1, "unique", seed=1234),
                 Relation(n, 1, "unique", seed=1235), n, ()),
                ("refine_2p24", Relation(Z_K1_TUPLES, 1, "modulo",
                                         seed=1234, modulo=Z_K1_MODULO),
                 Relation(Z_K1_TUPLES, 1, "unique", seed=1235),
                 Z_K1_TUPLES, ("histogram",))):
            meas = Measurements()
            engine = HashJoin(JoinConfig(), dev, measurements=meas)
            r, s = engine.place(inner), engine.place(outer)
            bound = max(inner.key_bound(), outer.key_bound())
            engine.join_arrays(r, s, key_bound=bound)      # warm
            sortpass0 = meas.counters.get("SORTPASS", 0)
            with counting_readbacks() as syncs:
                res, got, secs = launched(
                    lambda: engine.join_arrays(r, s, key_bound=bound))
            if res.matches != expected or not res.ok:
                raise AssertionError(f"(z1) {name}: {res.matches} matches "
                                     f"ok={res.ok}, the oracle {expected}")
            need(f"z1_{name}", got, ("radix_histogram", "radix_pass",
                                     "merge_scan", *extra))
            sortpass = meas.counters.get("SORTPASS", 0) - sortpass0
            if sortpass != got["radix_histogram"]:
                raise AssertionError(f"(z1) {name}: SORTPASS {sortpass} "
                                     f"against K2's {got['radix_histogram']}"
                                     f" sorts")
            z1[name] = {"matches": res.matches, "ms": secs * 1e3,
                        "sortpass": sortpass, "syncs": dict(syncs),
                        "launches": {k: v for k, v in got.items() if v}}
            del engine, r, s
        emit({"phase": "z1_guarded_main_path", "guard": guard,
              "cells": z1, **card})

        # ------------------------------------------------------------ (z2)
        tl = os.path.join(tmp, "timeline")
        results = []
        for i in range(2):
            argv = ["--tuples-per-node", str(n), "--timeline-dir", tl,
                    "--transfer-guard", guard, *Z_CLI_EXTRA]
            # the command line arms the guard itself, around its join
            (rc, out, err), got, secs = launched(
                lambda: quiet(lambda: cli.main(argv)), mode="off")
            if rc != 0 or not any("(OK)" in ln for ln in out):
                raise AssertionError(f"(z2) run {i}: exit {rc}: "
                                     f"{(out + err)[-6:]}")
            need(f"z2_cli_{i}", got, ("radix_histogram", "radix_pass",
                                      "merge_scan"))
            line = json.loads(out[-1])
            path = os.path.join(tmp, f"result_{i}.json")
            with open(path, "w") as f:
                json.dump(line, f)
            results.append((path, line, secs))
        rc_cp, cp_out, _ = quiet(lambda: critical_path.main(
            [tl, "--summary"]))
        crit = [ln for ln in cp_out if ln.startswith("[CRITPATH]")]
        if rc_cp != 0 or len(crit) != 1:
            raise AssertionError(f"(z2) critical_path: exit {rc_cp}, "
                                 f"{cp_out[-4:]}")
        rc_rg, rg_out, rg_err = quiet(lambda: check_regress.main(
            [results[1][0], "--baseline", results[0][0],
             "--threshold", "1.0"]))
        if rc_rg != 0:
            raise AssertionError(f"(z2) check_regress: exit {rc_rg}, "
                                 f"{(rg_out + rg_err)[-6:]}")
        emit({"phase": "z2_guarded_cli", "guard": guard,
              "join_ms": [ln["join_ms"] for _, ln, _ in results],
              "critpath": crit[0][:200], "check_regress_rc": rc_rg,
              "check_regress_verdict": rg_out[-1][:120], **card})

        # ------------------------------------------------------------ (z3)
        z3 = {}
        rels = (Relation(Z_GRID_TUPLES, 1, "unique", seed=1234),
                Relation(Z_GRID_TUPLES, 1, "unique", seed=1235))
        for pipeline, kern in (("off", ("radix_histogram", "radix_pass",
                                         "merge_scan_chunks")),
                               ("on", ("radix_histogram", "radix_pass"))):
            got_total, got, secs = launched(lambda: chunked_join_grid(
                stream_chunks_device(rels[0], 0, Z_CHUNK, dev),
                lambda: stream_chunks_device(rels[1], 0, Z_CHUNK, dev),
                Z_SLAB, pipeline=pipeline))
            if got_total != Z_GRID_TUPLES:
                raise AssertionError(f"(z3) grid pipeline={pipeline}: "
                                     f"{got_total} matches, the oracle "
                                     f"{Z_GRID_TUPLES}")
            need(f"z3_grid_{pipeline}", got, kern)
            z3[f"grid_{pipeline}"] = {"ms": secs * 1e3, "launches": {
                k: v for k, v in got.items() if v}}
        session = JoinSession(JoinConfig(), ServiceConfig(), device=dev,
                              measurements=Measurements())
        try:
            for qid, seed in (("z3_cold", 21), ("z3_warm", 22)):
                def serve():
                    session.submit(QueryRequest(query_id=qid,
                                                tuples_per_node=n,
                                                seed=seed))
                    return session.run_next()
                out, got, secs = launched(serve)
                if out.status != "ok" or out.matches != out.expected:
                    raise AssertionError(f"(z3) session {qid}: "
                                         f"{out.to_json()}")
                need(f"z3_{qid}", got, ("radix_histogram", "radix_pass",
                                        "merge_scan"))
                z3[qid] = {"ms": secs * 1e3, "warm": out.warm,
                           "matches": out.matches}
        finally:
            session.close()
        multihost.initialize(init_method=f"tcp://127.0.0.1:{free_port()}",
                             world_size=1, rank=0, local_rank=dev.index or 0,
                             device=dev, timeout_s=300)
        try:
            inner, outer = (Relation(n, 1, "unique", seed=1234),
                            Relation(n, 1, "unique", seed=1235))
            engine = HashJoin(JoinConfig(), dev, group=dist.group.WORLD)
            r, s = engine.place(inner), engine.place(outer)
            bound = max(inner.key_bound(), outer.key_bound())
            # the first collective sets up the communicator: a warm-up
            engine.join_shuffled(r, s, key_bound=bound)
            shuffled = (lambda e: e.join_shuffled(r, s, key_bound=bound))
            corrupt = faults.FaultInjector(seed=1).arm(
                faults.EXCHANGE_CORRUPT, at=1)
            # the generic body, then the paths whose readbacks the guard
            # found on the card and which now route them: the bucket
            # probe's run starts, debug_checks' hot mask, the repair's
            # partition filter, the materializing join's compaction
            for name, cfg, call, kern, inj in (
                    ("generic_body", {}, shuffled,
                     ("histogram", "partition", "radix_histogram",
                      "radix_pass", "merge_scan"), None),
                    ("bucket", {"probe_algorithm": "bucket"},
                     lambda e: e.join_arrays(r, s, key_bound=bound),
                     ("histogram", "partition", "radix_pass"), None),
                    ("debug_checks", {"debug_checks": True}, shuffled,
                     ("histogram", "partition", "merge_scan"), None),
                    ("verify_repair", {"verify": "repair"}, shuffled,
                     ("histogram", "partition", "merge_scan"), corrupt),
                    ("materialize", {},
                     lambda e: e.join_materialize_arrays(r, s),
                     ("partition", "radix_pass"), None)):
                engine = HashJoin(JoinConfig(**cfg), dev,
                                  group=dist.group.WORLD)
                with inj if inj is not None else contextlib.nullcontext():
                    res, got, secs = launched(lambda: call(engine))
                if res.matches != n or not res.ok:
                    raise AssertionError(f"(z3) {name}: {res.matches} "
                                         f"ok={res.ok}, the oracle {n}")
                need(f"z3_{name}", got, kern)
                z3[name] = {"ms": secs * 1e3, "launches": {
                    k: v for k, v in got.items() if v}}
            if not corrupt.history:
                raise AssertionError("(z3) verify_repair: the corrupt lane "
                                     "never fired")
            del engine, r, s
        finally:
            multihost.shutdown()
        emit({"phase": "z3_guarded_paths", "guard": guard, "cells": z3,
              **card})

        # ------------------------------------------------------------ (z4)
        if cuda:
            x = torch.arange(1024, device=dev)
            try:
                with sync_guard("disallow"):
                    x.cpu()
            except RuntimeError as e:
                raised = str(e).splitlines()[0][:160]
            else:
                raise AssertionError("(z4) a bare .cpu() under disallow "
                                     "did not raise")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                with sync_guard("log"):
                    y = x.cpu()
            # (PyTorch also warns once that the mode is a prototype)
            caught = [w for w in caught
                      if "called a synchronizing" in str(w.message)]
            if not caught or not torch.equal(y, torch.arange(1024)):
                raise AssertionError(f"(z4) a bare .cpu() under log did "
                                     f"not warn ({len(caught)}) or return "
                                     f"its values")
            if torch.cuda.get_sync_debug_mode() != 0:
                raise AssertionError("(z4) the guard left the mode armed")
            emit({"phase": "z4_negative_controls", "disallow": raised,
                  "log": str(caught[0].message)[:160], **card})

        # ------------------------------------------------------------ (z5)
        inner, outer = (Relation(n, 1, "unique", seed=1234),
                        Relation(n, 1, "unique", seed=1235))
        engine = HashJoin(JoinConfig(), dev)
        r, s = engine.place(inner), engine.place(outer)
        bound = max(inner.key_bound(), outer.key_bound())
        times = {"off": [], "disallow": []}
        engine.join_arrays(r, s, key_bound=bound)
        for _ in range(Z_REPS):
            for mode in times:
                host_fence(dev)
                t0 = time.perf_counter()
                with sync_guard(mode if cuda else "off"):
                    res = engine.join_arrays(r, s, key_bound=bound)
                    host_fence(dev)
                times[mode].append((time.perf_counter() - t0) * 1e3)
                if res.matches != n:
                    raise AssertionError(f"(z5) {mode}: {res.matches}")
        del engine, r, s
        med = {k: statistics.median(v) for k, v in times.items()}
        emit({"phase": "z5_guard_cost", "reps": Z_REPS,
              "median_ms": med, "times_ms": times,
              "disallow_over_off": med["disallow"] / med["off"], **card})

        # ------------------------------------------------------------ (z6)
        root = os.path.dirname(os.path.abspath(__file__))
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_radix_join_torch.tools.lint",
             "--strict"], cwd=root, capture_output=True, text=True,
            timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"(z6) lint --strict exit "
                                 f"{proc.returncode}: "
                                 f"{proc.stdout[-800:]}{proc.stderr[-400:]}")
        emit({"phase": "z6_lint", "python": sys.version.split()[0],
              "verdict": proc.stdout.strip().splitlines()[-1][:200], **card})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "z_summary", "seconds": time.perf_counter() - t_phase,
          "launches": {k: v for k, v in total.items() if v}, **card})
    return total


#: phase (aa): the grid fed from the host at (z3)'s size, its chunks and
#: slabs; the small runs of (aa4) (``planner/calibrate.py`` fits
#: ``dispatch_floor_ms`` from runs of at most 2**16 tuples) and the runs a
#: size there
AA_GRID_TUPLES = 1 << 24
AA_CHUNK = 1 << 23
AA_SLAB = 1 << 20
AA_SMALL_TUPLES = 1 << 16
AA_RUNS = 3
#: the guard's mode around (aa1)-(aa3) on the card ("log" lists every trip
#: by site instead of raising at the first)
AA_GUARD = "disallow"
#: arguments (aa1) and (aa4) add to their command lines (none on the card)
AA_CLI_EXTRA = ()
#: the environment variable that makes a (y) / (aa) rank list its trips
AA_TRIPS_ENV = "CHIP_SMOKE_LIST_TRIPS"
#: the library arm's (d) at 20M in (t3) (run 2, PR 18), printed beside
#: (aa1)'s
AA_T3_LIBRARY_D_MS = 80.04
#: the marker of a trip a rank echoes (``listing_trips``)
AA_TRIP_MARK = "[TRIP] "
#: the command-line flag that runs one rank of (aa2)'s gloo control, and
#: the marker its segments start with
AA_GLOO_FLAG = "--phase-aa-gloo"
AA_GLOO_MARK = "[GLOO] "


@contextlib.contextmanager
def listing_trips(echo=False):
    """Every guard trip of the block (c10's "called a synchronizing CUDA
    operation" warning under ``log``), counted by site: the innermost
    frame of the port's package or of this script, else the warning's own
    frame.  Yields ``{site: count}``; ``echo`` also prints each trip to
    stderr as ``[TRIP] {"site": ..., "at": ...}`` when it happens."""
    import traceback
    import warnings
    trips = {}
    here = os.path.dirname(os.path.abspath(__file__))
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if "called a synchronizing" not in str(message):
                return shown(message, category, filename, lineno, file, line)
            ours = [f for f in traceback.extract_stack()[:-1]
                    if "tpu_radix_join_torch" in f.filename
                    or f.filename.endswith("chip_smoke.py")]
            site = (f"{os.path.relpath(ours[-1].filename, here)}:"
                    f"{ours[-1].lineno} {ours[-1].name}" if ours
                    else f"{filename}:{lineno}")
            trips[site] = trips.get(site, 0) + 1
            if echo:
                print(AA_TRIP_MARK + json.dumps(
                    {"site": site,
                     "at": f"{os.path.basename(filename)}:{lineno}"}),
                      file=sys.stderr, flush=True)
        warnings.showwarning = show
        yield trips


def rank_trips(err: str) -> dict:
    """A rank's trips by site from its stderr: the ``[TRIP]`` lines it
    echoed, and c10's own warnings from threads without a Python frame
    (a collective's worker thread), each under its text."""
    trips = {}
    for line in err.splitlines():
        if line.startswith(AA_TRIP_MARK):
            site = json.loads(line[len(AA_TRIP_MARK):])["site"]
        elif ("called a synchronizing" in line
              and "UserWarning" not in line):
            site = "c10: " + line.split("Warning:")[-1].strip()[:120]
        else:
            continue
        trips[site] = trips.get(site, 0) + 1
    return trips


def aa_gloo_rank() -> int:
    """One rank of (aa2)'s control (started by ``phase_aa``): joins the
    ``env://`` group as a gloo group on the card, then under
    ``sync_guard("log")`` makes one ``all_reduce`` of a CUDA tensor and one
    of a CPU tensor, each after a ``[GLOO] <name>`` line on stderr, so the
    trips c10 prints between two markers are that collective's."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_radix_join_torch.parallel import multihost
    from tpu_radix_join_torch.utils.hostsync import host_fence, sync_guard
    dev = torch.device("cuda", 0)
    multihost.initialize(device="cuda", backend="gloo", timeout_s=120)
    try:
        lanes = {"cuda": torch.ones(1 << 20, device=dev),
                 "cpu": torch.ones(1 << 20)}
        for t in lanes.values():
            dist.all_reduce(t)           # the connections, unguarded
        host_fence(dev)
        for name, t in lanes.items():
            print(AA_GLOO_MARK + name, file=sys.stderr, flush=True)
            with listing_trips(echo=True), sync_guard("log"):
                dist.all_reduce(t)
            host_fence(dev)
        print(AA_GLOO_MARK + "end", file=sys.stderr, flush=True)
        return 0
    finally:
        multihost.shutdown()


def gloo_segments(err: str) -> dict:
    """A control rank's trips by site, for each ``[GLOO]`` segment."""
    out, name, lines = {}, None, []
    for line in err.splitlines() + [AA_GLOO_MARK + "end"]:
        if line.startswith(AA_GLOO_MARK):
            if name is not None and name != "end":
                out[name] = rank_trips("\n".join(lines))
            name, lines = line[len(AA_GLOO_MARK):], []
        else:
            lines.append(line)
    return out


def phase_aa(dev, n, card) -> dict:
    """Cell (aa): ROADMAP C10's repairs under the sync guard, and the
    evidence tools (A8b step 3) on the card's own output.

    (aa1) ``main(argv)`` in this process with ``--partition-impl sort
    --transfer-guard disallow`` (the library baseline arms, whose plain
    versions size nothing on the host since C10's repair) at ``n`` unique
    ⋈ unique: (a), the sort probe; (d), ``--probe bucket``, whose sizing
    and partitions run the arms; and (d) with ``--sort-impl xla`` too,
    (t3)'s arms, beside (t3)'s 80.04 ms.  Each runs twice (the first
    loads what it runs), exits 0 with the oracle's OK (a trip would
    raise), and prints its join ms, the command line's sanctioned
    readbacks (the generator's re-walk included) and its
    ``baseline_partition`` / ``baseline_histogram`` launches.  Then K4
    (``partition_slots``, ``partition_scatter``) on (d)'s network ids of
    the same relation, dense and blocked, against its plain version run
    on the card under the guard: bit-equal; and the repair's cost on
    those ids, each replaced spelling (``bincount`` counts, the boolean
    compaction) beside its replacement (``index_add_``, the trash slot),
    the plain version whole and K4, CUDA events, median of 10.
    (aa2) ``recovery.execute_recovery`` in this process, ``only_rank=None``
    (one survivor, the simulated death's view), every one of the 32
    partitions of ``n`` ⋈ ``n`` unique recomputed under the guard: exact,
    K2 and K6 launched.  Then two command-line gloo ranks on the card
    (``y_cli_rank``) under ``--transfer-guard log``: (y1)'s simulated
    death at boundary 2, both ranks recovering the oracle's ``2n``; and
    the skew split, unique ⋈ zipf(0.75) with ``--skew-threshold 4`` at
    ``n`` a rank, exact: every trip of each rank listed by site (a trip
    c10 prints outside any Python frame under its text).  Then the
    control (``aa_gloo_rank``): two gloo ranks, one ``all_reduce`` of a
    CUDA tensor and one of a CPU tensor under ``log``, the trips of each.
    (aa3) ``chunked_join_grid`` at ``AA_GRID_TUPLES`` ⋈ ``AA_GRID_TUPLES``
    unique fed by ``stream_chunks`` (the native generator, pinned pools,
    a side stream) under the guard: exact, K2 and K6.
    (aa4) In a fresh directory T: ``AA_RUNS`` runs at ``n`` and
    ``AA_RUNS`` at ``AA_SMALL_TUPLES`` of ``main(argv)`` with
    ``--output-dir T/perf_<i> --ledger-dir T/ledger --timeline-dir
    T/tl`` (``--output-dir`` records SDISPATCH), then the tools through
    their ``main(argv)``: ``make_report T`` (exit 0, a row a run whose
    JPROC and SDISPATCH cells are the ``.perf`` files', whose JTOTAL is
    the run's result line's); ``--emit-ledger T/backfill`` (exit 0, a
    run row a run whose fingerprint names this card, no bench row);
    ``--emit-profile T/p.json`` (exit 0, ``dispatch_floor_ms`` the median
    SDISPATCH, ``sort_stage_unit_ms`` kept from ``h100`` with its
    citation); ``--emit-timeline T/merged.json`` (exit 0); ``profile_fit
    fit --ledger T/ledger`` (exit 0, ``dispatch_floor_ms`` fitted);
    ``profile_fit diff h100 T/ledger/profile_fitted.json`` and
    ``profile_fit refresh --ledger T/ledger`` (exit 0 or 1, printed).
    The fitted ``dispatch_floor_ms`` is printed beside ``h100``'s; nothing
    is written into the tree.  Returns the launches of the driven paths."""
    import io
    import shutil
    import tempfile
    import torch
    from tpu_radix_join_torch import Relation
    from tpu_radix_join_torch import main as cli
    from tpu_radix_join_torch.data.streaming import stream_chunks
    from tpu_radix_join_torch.data.tuples import narrow, widen
    from tpu_radix_join_torch.observability.ledger import load_rows
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.ops.chunked import chunked_join_grid
    from tpu_radix_join_torch.ops.kernels import partition as k4
    from tpu_radix_join_torch.performance import Measurements
    from tpu_radix_join_torch.planner.profile import (FITTED_PROFILE_BASENAME,
                                                      load_profile)
    from tpu_radix_join_torch.robustness import recovery
    from tpu_radix_join_torch.tools import make_report, profile_fit
    from tpu_radix_join_torch.utils.hostsync import host_fence, sync_guard

    cuda = dev.type == "cuda"
    guard = AA_GUARD if cuda else "off"
    total = {k: 0 for k in kernels.launch_counts()}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_aa_")
    here = os.path.dirname(os.path.abspath(__file__))

    def launched(fn, mode=guard):
        """``fn()`` under the guard at ``mode``, its trips listed, with the
        launch counts set to 0 just before and read just after: (its
        result, the counts, seconds, the trips by site)."""
        host_fence(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        with listing_trips() as trips, sync_guard(mode):
            out = fn()
            host_fence(dev)
        secs = time.perf_counter() - t0
        got = kernels.launch_counts()
        for k, v in got.items():
            total[k] += v
        return out, got, secs, dict(trips)

    def need(cell, got, names):
        for k in names:
            if got[k] <= 0:
                raise AssertionError(f"(aa) {cell}: {k} did not launch: "
                                     f"{got}")

    def quiet(fn):
        """``fn()`` with its stdout and stderr captured: (result, stdout
        lines, stderr lines)."""
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = fn()
        return rc, out.getvalue().splitlines(), err.getvalue().splitlines()

    def run_cli(cell, argv, kern):
        """``main(argv)`` in this process (it arms any guard itself), with
        its sanctioned syncs counted: (its result line, launches, seconds,
        syncs, trips)."""
        with counting_readbacks() as syncs:
            (rc, out, err), got, secs, trips = launched(
                lambda: quiet(lambda: cli.main(argv)), mode="off")
        if rc != 0 or not any("(OK)" in ln for ln in out):
            raise AssertionError(f"(aa) {cell}: exit {rc}: "
                                 f"{(out + err)[-8:]}")
        need(cell, got, kern)
        return json.loads(out[-1]), got, secs, dict(syncs), trips

    def nonzero(d):
        return {k: v for k, v in d.items() if v}

    def event_ms(fn, reps=10):
        """CUDA events around each of ``reps`` calls after a warm-up: the
        median ms."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    try:
        # ----------------------------------------------------------- (aa1)
        cells = {}
        guard_args = ("--transfer-guard", guard) if cuda else ()
        for name, extra, kern in (
                ("a", (), ("radix_pass", "merge_scan")),
                ("d", ("--probe", "bucket"),
                 ("radix_pass", "baseline_partition", "baseline_histogram")),
                ("d_library", ("--probe", "bucket", "--sort-impl", "xla"),
                 ("baseline_sort", "baseline_partition",
                  "baseline_histogram"))):
            argv = ["--tuples-per-node", str(n), "--partition-impl", "sort",
                    *extra, *guard_args, *AA_CLI_EXTRA]
            join_ms = []
            for rep in range(2):         # the first loads what it runs
                line, got, secs, syncs, trips = run_cli(
                    f"aa1_{name}_{rep}", argv, kern)
                if line["matches"] != n or not line["ok"]:
                    raise AssertionError(f"(aa1) {name}: {line['matches']}"
                                         f" ok={line['ok']}")
                join_ms.append(line["join_ms"])
            cells[name] = {
                "join_ms": join_ms, "matches": line["matches"],
                "syncs": syncs, "trips": trips,
                "baseline_partition": got["baseline_partition"],
                "baseline_histogram": got["baseline_histogram"],
                "launches": nonzero(got)}
        cells["d_library"]["t3_library_d_ms"] = AA_T3_LIBRARY_D_MS
        # K4 against its plain version on (d)'s network ids, the plain
        # version on the card under the guard
        key = Relation(n, 1, "unique", seed=1234).generate(dev).key
        ids = torch.bitwise_and(key, 31)
        rid = narrow(torch.arange(n, dtype=torch.int64, device=dev))
        # the blocked layout one percent short of a group's share: every
        # group drops tuples (the plain version's trash slot)
        cap = max(1, (n // 32) * 99 // 100)
        errs = {}
        for mode, kw in (("dense", {}), ("blocked", {"capacity": cap})):
            got_k = (k4.partition_slots(ids, num_groups=32, **kw),
                     k4.partition_scatter(ids, [key, rid], [0, 0xFFFFFFFF],
                                          num_groups=32, **kw))
            plain, _, _, trips = launched(lambda: (
                k4.partition_slots_plain(ids, 32, **kw),
                k4.partition_scatter_plain(ids, [key, rid],
                                           [0, 0xFFFFFFFF], 32, **kw)))
            pairs = [(got_k[0][0], plain[0][0]), (got_k[0][1], plain[0][1]),
                     *zip(got_k[1][0], plain[1][0]),
                     (got_k[1][1], plain[1][1])]
            for a, b in pairs:
                if a.shape != b.shape or not torch.equal(a, b):
                    raise AssertionError(f"(aa1) K4 {mode} differs from "
                                         f"its plain version")
            errs[mode] = {"max_abs_err": 0, "plain_trips": trips}
        # what the repair costs: each spelling the guard caught beside the
        # one that replaced it, on these ids (outside the guard), then the
        # plain version whole and K4, the blocked layout
        repair = {}
        if cuda:
            g = widen(ids)
            ones = torch.ones_like(g)
            keep = torch.rand(n, device=dev) < 0.9
            slots = widen(k4.partition_slots_plain(ids, 32, capacity=cap)[0])
            dropped = slots == k4.DROPPED
            size = k4.out_size(n, 32, 1, cap)

            def bool_write():
                out = torch.empty(size, dtype=torch.int32, device=dev)
                out[slots[~dropped]] = key[~dropped]

            def trash_write():
                out = torch.empty(size + 1, dtype=torch.int32, device=dev)
                out[torch.where(dropped, size, slots)] = key

            lanes, fills = [key, rid], [0, 0xFFFFFFFF]
            for name, fn in (
                    ("count_bincount", lambda: torch.bincount(
                        g, minlength=33)),
                    ("count_index_add", lambda: torch.zeros(
                        33, dtype=g.dtype, device=dev).index_add_(0, g,
                                                                  ones)),
                    ("hist_bincount", lambda: torch.bincount(
                        g[keep], minlength=32)),
                    ("hist_index_add", lambda: torch.zeros(
                        32, dtype=g.dtype, device=dev).index_add_(
                            0, torch.where(keep, g, 0),
                            keep.to(torch.int64))),
                    ("write_bool_index", bool_write),
                    ("write_trash_slot", trash_write),
                    ("plain_slots", lambda: k4.partition_slots_plain(
                        ids, 32, capacity=cap)),
                    ("plain_scatter", lambda: k4.partition_scatter_plain(
                        ids, lanes, fills, 32, capacity=cap)),
                    ("k4_scatter", lambda: k4.partition_scatter(
                        ids, lanes, fills, num_groups=32, capacity=cap))):
                repair[f"{name}_ms"] = event_ms(fn)
            del g, ones, keep, slots, dropped
        del key, ids, rid
        emit({"phase": "aa1_library_arms", "guard": guard, "cells": cells,
              "k4_vs_plain": errs, "repair_cost": repair, **card})

        # ----------------------------------------------------------- (aa2)
        inner = Relation(n, 1, "unique", seed=1234)
        outer = Relation(n, 1, "unique", seed=1235)
        rk, _ = recovery.host_keys(inner)
        sk, _ = recovery.host_keys(outer)
        plan = recovery.plan_recovery(
            num_nodes=2, num_partitions=32, lost_ranks=[1], epoch=1,
            weights=recovery.partition_weights(rk, sk, 32))
        with counting_readbacks() as syncs:
            (matches, counts), got, secs, trips = launched(
                lambda: recovery.execute_recovery(plan, rk, sk, device=dev))
        if matches != n or len(counts) != 32:
            raise AssertionError(f"(aa2) recovery: {matches} matches over "
                                 f"{len(counts)} partitions, the oracle {n}")
        need("aa2_recovery", got, ("radix_pass", "merge_scan_chunks"))
        del rk, sk
        emit({"phase": "aa2_recovery", "guard": guard, "matches": matches,
              "partitions": len(counts), "recovery_s": secs,
              "syncs": dict(syncs), "trips": trips,
              "launches": nonzero(got), **card})
        ranks = {}
        device_args = ("--device", "cuda") if cuda else ("--device", "cpu")
        log_args = ("--transfer-guard", "log") if cuda else ()
        for name, argv in (
                ("y1_death", ("--elastic", "on", "--rank-death-at", "2",
                              "--rank-lease-s", str(Y_LEASE_S),
                              "--rank-missed-beats", str(Y_MISSED_BEATS),
                              "--lease-dir", os.path.join(tmp, "leases"))),
                ("skew_split", ("--outer-kind", "zipf", "--skew-threshold",
                                "4", "--max-retries", "4"))):
            port = free_port()
            cmds = []
            for r in range(Y_RANKS):
                env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(port), RANK=str(r),
                           WORLD_SIZE=str(Y_RANKS), LOCAL_RANK="0",
                           PYTHONPATH=here + os.pathsep
                           + os.environ.get("PYTHONPATH", ""))
                env.setdefault("GLOO_SOCKET_IFNAME", "lo")
                env.pop("TPU_RJ_RANK_DEATH_SUICIDE", None)
                env[AA_TRIPS_ENV] = "1"
                cmds.append(([sys.executable, os.path.abspath(__file__),
                              Y_CLI_FLAG, *device_args, "--nodes",
                              str(Y_RANKS), "--tuples-per-node", str(n),
                              *argv, *log_args], env))
            t0 = time.perf_counter()
            rcs, outs, errs = y_processes(cmds)
            secs = time.perf_counter() - t0
            doc = y_last_json(outs[0])
            want = Y_RANKS * n
            if (rcs != [0] * Y_RANKS or doc is None or not doc["ok"]
                    or doc["matches"] != doc["expected"]
                    or (name == "y1_death" and doc["matches"] != want)):
                raise AssertionError(
                    f"(aa2) {name}: rcs {rcs}:\n" + "\n---\n".join(
                        o[-1500:] + e[-2500:] for o, e in zip(outs, errs)))
            if name == "y1_death":
                recs = [x for e in errs for x in y_elastic_lines(e)
                        if x.get("kind") == "recovery"]
                if len(recs) != Y_RANKS or any(x["matches"] != want
                                               for x in recs):
                    raise AssertionError(f"(aa2) {name}: {recs}")
            for k, v in (doc.get("launches") or {}).items():
                total[k] += v
            ranks[name] = {"seconds": secs, "matches": doc["matches"],
                           "expected": doc.get("expected"),
                           "join_ms": doc.get("join_ms"),
                           "trips": [rank_trips(e) for e in errs],
                           "launches": doc.get("launches")}
        if cuda:
            # the control: which trips one gloo collective makes by itself
            port = free_port()
            rcs, outs, errs = y_processes([
                ([sys.executable, os.path.abspath(__file__), AA_GLOO_FLAG],
                 dict(os.environ, MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port), RANK=str(r),
                      WORLD_SIZE=str(Y_RANKS), LOCAL_RANK="0",
                      GLOO_SOCKET_IFNAME="lo",
                      PYTHONPATH=here + os.pathsep
                      + os.environ.get("PYTHONPATH", "")))
                for r in range(Y_RANKS)])
            segments = [gloo_segments(e) for e in errs]
            if rcs != [0] * Y_RANKS or any(set(x) != {"cuda", "cpu"}
                                           for x in segments):
                raise AssertionError(f"(aa2) gloo control: rcs {rcs}: "
                                     + "\n---\n".join(e[-2000:]
                                                       for e in errs))
            ranks["gloo_all_reduce_control"] = {"trips": segments}
        emit({"phase": "aa2_gloo_ranks", "guard": "log" if cuda else "off",
              "ranks": Y_RANKS, "cases": ranks, **card})

        # ----------------------------------------------------------- (aa3)
        rels = (Relation(AA_GRID_TUPLES, 1, "unique", seed=1234),
                Relation(AA_GRID_TUPLES, 1, "unique", seed=1235))
        with counting_readbacks() as syncs:
            got_total, got, secs, trips = launched(lambda: chunked_join_grid(
                stream_chunks(rels[0], 0, AA_CHUNK, device=dev),
                lambda: stream_chunks(rels[1], 0, AA_CHUNK, device=dev),
                AA_SLAB, pipeline="off"))
        if got_total != AA_GRID_TUPLES:
            raise AssertionError(f"(aa3) host-fed grid: {got_total} "
                                 f"matches, the oracle {AA_GRID_TUPLES}")
        need("aa3_host_grid", got, ("radix_pass", "merge_scan_chunks"))
        emit({"phase": "aa3_host_feed", "guard": guard,
              "tuples": AA_GRID_TUPLES, "chunk": AA_CHUNK,
              "grid_ms": secs * 1e3, "syncs": dict(syncs),
              "trips": trips,
              "launches": nonzero(got), **card})

        # ----------------------------------------------------------- (aa4)
        led = os.path.join(tmp, "ledger")
        runs = []
        for i, size in enumerate([n] * AA_RUNS
                                 + [AA_SMALL_TUPLES] * AA_RUNS):
            perf = os.path.join(tmp, f"perf_{i}")
            argv = ["--tuples-per-node", str(size), "--output-dir", perf,
                    "--ledger-dir", led, "--timeline-dir",
                    os.path.join(tmp, "tl"), *AA_CLI_EXTRA]
            line, got, secs, _, _ = run_cli(f"aa4_run_{i}", argv,
                                            ("radix_pass", "merge_scan"))
            (m,) = Measurements.load(perf)
            if line["matches"] != size or "SDISPATCH" not in m.times_us:
                raise AssertionError(f"(aa4) run {i}: {line['matches']}, "
                                     f"{sorted(m.times_us)}")
            runs.append({"dir": f"perf_{i}", "size": size,
                         "jtotal_us": m.times_us["JTOTAL"],
                         "result_jtotal_us": line["phases_us"]["JTOTAL"],
                         "sdispatch_us": m.times_us["SDISPATCH"],
                         "jproc_us": m.times_us.get("JPROC")})
            if m.times_us["JTOTAL"] != round(line["phases_us"]["JTOTAL"]):
                raise AssertionError(f"(aa4) run {i}: the .perf JTOTAL "
                                     f"{m.times_us['JTOTAL']} against "
                                     f"{line['phases_us']['JTOTAL']}")
        tools = {}
        rc, out, err = quiet(lambda: make_report.main([tmp]))
        table = {ln.split("|")[1].strip(): ln for ln in out
                 if ln.startswith("| perf_")}
        for r in runs:
            row = table.get(r["dir"], "")
            for tag in ("JPROC", "SDISPATCH"):
                us = r["jproc_us" if tag == "JPROC" else "sdispatch_us"]
                if us is not None and f"| {us / 1e3:.1f} |" not in row + "|":
                    raise AssertionError(f"(aa4) make_report: {r['dir']}'s "
                                         f"{tag} {us} not in {row!r}")
        if rc != 0 or len(table) != len(runs):
            raise AssertionError(f"(aa4) make_report: exit {rc}, "
                                 f"{len(table)} rows: {(out + err)[-8:]}")
        tools["make_report"] = {"rc": rc, "rows": len(table)}
        backfill = os.path.join(tmp, "backfill")
        rc, out, err = quiet(lambda: make_report.main(
            [tmp, "--emit-ledger", backfill]))
        rows = load_rows(backfill)
        bench = [x for x in rows if x["kind"] == "bench"]
        devices = {x["fingerprint"]["device"] for x in rows}
        if (rc != 0 or len(rows) != len(runs) or bench
                or devices != {card["name"] if cuda else "cpu"}):
            raise AssertionError(f"(aa4) --emit-ledger: exit {rc}, "
                                 f"{len(rows)} rows, devices {devices}: "
                                 f"{(out + err)[-4:]}")
        tools["emit_ledger"] = {"rc": rc, "run_rows": len(rows),
                                "bench_rows": len(bench),
                                "devices": sorted(devices)}
        prof_path = os.path.join(tmp, "p.json")
        rc, out, err = quiet(lambda: make_report.main(
            [tmp, "--emit-profile", prof_path]))
        base = load_profile()
        prof = load_profile(prof_path)
        floors = sorted(r["sdispatch_us"] / 1e3 for r in runs)
        if (rc != 0 or prof.value("dispatch_floor_ms")
                != round(floors[len(floors) // 2], 3)
                or prof.source("sort_stage_unit_ms")
                != base.source("sort_stage_unit_ms")
                or prof.value("sort_stage_unit_ms")
                != base.value("sort_stage_unit_ms")):
            raise AssertionError(f"(aa4) --emit-profile: exit {rc}, "
                                 f"{prof.constants}: {(out + err)[-4:]}")
        tools["emit_profile"] = {
            "rc": rc, "dispatch_floor_ms": prof.value("dispatch_floor_ms"),
            "source": prof.source("dispatch_floor_ms")[:160]}
        merged = os.path.join(tmp, "merged.json")
        rc, out, err = quiet(lambda: make_report.main(
            [tmp, "--emit-timeline", merged]))
        if rc != 0 or not os.path.exists(merged):
            raise AssertionError(f"(aa4) --emit-timeline: exit {rc}: "
                                 f"{(out + err)[-4:]}")
        tools["emit_timeline"] = {"rc": rc, "said": out[-1][:160],
                                  "warnings": [x[:160] for x in err]}
        rc, out, err = quiet(lambda: profile_fit.main(["fit", "--ledger",
                                                       led]))
        fitted_path = os.path.join(led, FITTED_PROFILE_BASENAME)
        if rc != 0 or not os.path.exists(fitted_path):
            raise AssertionError(f"(aa4) profile_fit fit: exit {rc}: "
                                 f"{(out + err)[-6:]}")
        fitted = load_profile(fitted_path)
        origin = {k: (fitted.provenance(k) or {}).get("origin")
                  for k in fitted.constants}
        if origin.get("dispatch_floor_ms") != "fit":
            raise AssertionError(f"(aa4) profile_fit fit: {origin}")
        tools["profile_fit_fit"] = {
            "rc": rc, "said": [x[:200] for x in out[:3]],
            "fitted": sorted(k for k, v in origin.items() if v == "fit"),
            "kept": sorted(k for k, v in origin.items() if v != "fit"),
            "dispatch_floor_ms": fitted.value("dispatch_floor_ms"),
            "h100_dispatch_floor_ms": base.value("dispatch_floor_ms")}
        for name, argv in (("diff", ["diff", "h100", fitted_path]),
                           ("refresh", ["refresh", "--ledger", led])):
            rc, out, err = quiet(lambda: profile_fit.main(argv))
            if rc not in (0, 1):
                raise AssertionError(f"(aa4) profile_fit {name}: exit "
                                     f"{rc}: {(out + err)[-6:]}")
            tools[f"profile_fit_{name}"] = {"rc": rc,
                                            "said": out[-1][:200]}
        emit({"phase": "aa4_evidence_tools", "runs": runs, "tools": tools,
              **card})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "aa_summary", "seconds": time.perf_counter() - t_phase,
          "launches": {k: v for k, v in total.items() if v}, **card})
    return total


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    # the port beside this script; outside a checkout the import fails
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_radix_join_torch import HashJoin, JoinConfig, Relation
    from tpu_radix_join_torch.data.relation import host_join_count
    from tpu_radix_join_torch.data.tuples import (PAD_RID, R_PAD_KEY,
                                                  S_PAD_KEY, TupleBatch,
                                                  lane_to_numpy, narrow, umax,
                                                  valid_mask, widen)
    from tpu_radix_join_torch.operators.hash_join import FALLBACK_SLAB
    from tpu_radix_join_torch.operators.local_partitioning import (
        local_bucket_ids, local_partition)
    from tpu_radix_join_torch.ops import kernels
    from tpu_radix_join_torch.ops.build_probe import (bucket_rows_count,
                                                      bucket_rows_sort)
    from tpu_radix_join_torch.ops.kernels import _build
    from tpu_radix_join_torch.ops.kernels import histogram as k1
    from tpu_radix_join_torch.ops.kernels import merge_scan as k3
    from tpu_radix_join_torch.ops.kernels import merge_scan_chunks as k6
    from tpu_radix_join_torch.ops.kernels import merge_scan_wide as k5
    from tpu_radix_join_torch.ops.kernels import partition as k4
    from tpu_radix_join_torch.ops.kernels import radix_sort as k2
    from tpu_radix_join_torch.data.streaming import stream_chunks_device
    from tpu_radix_join_torch.ops import chunked
    from tpu_radix_join_torch.ops.merge_count import (MAX_MERGE_KEY, _pack,
                                                      _pack_pm, _rotate_pid,
                                                      _side_tags, presort_keys)
    from tpu_radix_join_torch.performance.measurements import Measurements
    from tpu_radix_join_torch.parallel.window import Window

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    card = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit({"phase": "device", **card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:   # every nvcc starts at once
        verbose = pool.submit(_build.build, PTXAS_SOURCES, True)
        _build.build()
        ptxas_logs = verbose.result()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(_build.SOURCES)})
    emit({"phase": "ptxas", "kernels": {
        name: ptxas_summary(log) for name, log in ptxas_logs.items()}})

    hbm_bytes_per_s = 3.35e12        # H100 SXM, NVIDIA data sheet
    gen = torch.Generator(device="cpu").manual_seed(20240601)

    def rand_lane(n, lo=0, hi=1 << 32):
        x = torch.randint(lo, hi, (n,), dtype=torch.int64, generator=gen)
        return narrow(x).to(dev)

    def max_abs_err(a, b) -> int:
        if a.numel() == 0:
            return 0
        return int((widen(a) - widen(b)).abs().max())

    def exact(a, b, what) -> int:
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{what}: kernel differs from its plain "
                                 f"version (max abs err "
                                 f"{max_abs_err(a, b) if a.shape == b.shape else 'shape'})")
        return max_abs_err(a, b)

    def time_ms(fn, reps=10) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    def device_us(fn, reps=10) -> dict:
        """Device time a call, by kernel (torch.profiler's CUDA activity):
        what the event times of ``time_ms`` hold besides the host's gaps.
        Kernels whose shortened names coincide (PyTorch's elementwise
        kernels) are summed under one name."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", 0) or 0
            if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.key.replace("(anonymous namespace)::", "")
                name = name.replace("void ", "").split("(")[0][:40]
                out[name] = out.get(name, 0.0) + us / reps
        return out

    # ---------------------------------------------------- main-path inputs
    n_main = 20_000_000
    fanout = JoinConfig().network_fanout_bits
    num_p = 1 << fanout
    inner = Relation(n_main, 1, "unique", seed=1234)
    outer = Relation(n_main, 1, "unique", seed=1235)
    r_main = inner.generate(dev)
    s_main = outer.generate(dev)
    union = _pack_pm(r_main.key, s_main.key, fanout)          # 40M, unsorted
    s_pid = torch.bitwise_and(s_main.key, num_p - 1)          # 20M pids

    results = {}

    # ------------------------------------------------------------ K2 sort
    errs = []
    for shift in (0, 8, 16, 24):
        errs.append(exact(k2.radix_pass_slots(union, shift=shift),
                          k2.radix_pass_slots_plain(union, shift),
                          f"radix pass shift {shift} @ {union.numel()}"))
    sorted_union = k2.radix_sort([union])[0]
    errs.append(exact(sorted_union, k2.radix_sort_plain([union])[0],
                      "radix sort @ main shape"))
    sentinels = torch.tensor([0, 1, 0xFFFFFFFE, 0xFFFFFFFF], dtype=torch.int64)
    adversarial = {
        **{f"random_{n}": rand_lane(n) for n in (1, 255, 32767, 32769,
                                                 1000003)},
        "all_equal": narrow(torch.full((100003,), 0xDEADBEEF,
                                       dtype=torch.int64)).to(dev),
        "presorted": k2.radix_sort_plain([rand_lane(100003)])[0],
        "reverse_sorted": k2.radix_sort_plain(
            [rand_lane(100003)])[0].flip(0).contiguous(),
        "sentinel_saturated": narrow(sentinels[torch.randint(
            0, 4, (100003,), generator=gen)]).to(dev),
        "max_merge_key": narrow(torch.full((70001,), MAX_MERGE_KEY,
                                           dtype=torch.int64)).to(dev),
    }
    for name, x in adversarial.items():
        vals = narrow(torch.arange(x.numel(), dtype=torch.int64)).to(dev)
        got = k2.radix_sort([x, vals])
        ref = k2.radix_sort_plain([x, vals])
        errs.append(exact(got[0], ref[0], f"radix sort keys, {name}"))
        errs.append(exact(got[1], ref[1], f"radix sort values, {name}"))
        for shift in (0, 24):
            errs.append(exact(k2.radix_pass_slots(x, shift=shift),
                              k2.radix_pass_slots_plain(x, shift),
                              f"radix pass shift {shift}, {name}"))
    # the onesweep pass's edges: tile boundaries, look-back chains through
    # tiles that count zero for every digit but one, 1-4 lanes, key bounds
    # that leave 1 and 2 passes, and the row sort's three-lane shape
    tile = k2.TILE_KEYS

    def sort_case(name, lanes, num_keys=1, key_bounds=None):
        got = k2.radix_sort(lanes, num_keys=num_keys, key_bounds=key_bounds)
        ref = k2.radix_sort_plain(lanes, num_keys, key_bounds)
        return [exact(g, r, f"radix sort lane {i}, {name}")
                for i, (g, r) in enumerate(zip(got, ref))]

    one_digit = {
        "all_equal_1000003": narrow(torch.full((1000003,), 0x5A5A5A5A,
                                               dtype=torch.int64)).to(dev),
        "low_digit_equal_1000003": narrow(
            (torch.randint(0, 1 << 24, (1000003,), generator=gen) << 8)
            | 0x5A).to(dev),
    }
    for n in (tile - 1, tile, tile + 1, 3 * tile + 17):
        x = rand_lane(n)
        errs += sort_case(f"n {n}", [x, narrow(torch.arange(n)).to(dev)])
        for shift in (0, 24):
            errs.append(exact(k2.radix_pass_slots(x, shift=shift),
                              k2.radix_pass_slots_plain(x, shift),
                              f"radix pass shift {shift}, n {n}"))
    for name, x in one_digit.items():
        errs += sort_case(name, [x, narrow(torch.arange(x.numel())).to(dev)])
        errs.append(exact(k2.radix_pass_slots(x, shift=0),
                          k2.radix_pass_slots_plain(x, 0),
                          f"radix pass shift 0, {name}"))
    lanes4 = [rand_lane(1000003) for _ in range(4)]
    for k in (1, 2, 3, 4):
        errs += sort_case(f"{k} lanes", lanes4[:k])
    errs += sort_case("two keys, 4 lanes", lanes4, num_keys=2)
    for bound in (256, 1 << 16):
        errs += sort_case(f"key bound {bound}",
                          [rand_lane(1000003, hi=bound), lanes4[1]],
                          key_bounds=(bound,))
    rows_n, width_n = 64, 65536
    row = torch.arange(rows_n, dtype=torch.int32,
                       device=dev).repeat_interleave(width_n)
    errs += sort_case("row sort 64 x 65536",
                      [row, rand_lane(rows_n * width_n),
                       rand_lane(rows_n * width_n, hi=2)],
                      num_keys=2, key_bounds=(rows_n, None))
    del one_digit, lanes4, row

    # the histogram kernel's table against a plain per-pass bincount, at
    # (a)'s packed union and (h)'s two key lanes (lo rotated, hi)
    def wide_union(r, s, f):
        lanes = [torch.cat([_rotate_pid(r.key, f), _rotate_pid(s.key, f)])]
        if r.key_hi is not None:
            lanes.append(torch.cat([r.key_hi, s.key_hi]))
        return lanes + [_side_tags(r.key, s.key)]

    rel_h = (Relation(n_main, 1, "unique", seed=1234, key_bits=64),
             Relation(n_main, 1, "unique", seed=1235, key_bits=64))
    union_h = wide_union(*(rel.generate(dev) for rel in rel_h), fanout)
    hist_checks = [exact(k2.radix_histograms([union]),
                         k2.radix_histograms_plain([union]),
                         "radix histograms @ (a)'s union"),
                   exact(k2.radix_histograms(union_h[:2]),
                         k2.radix_histograms_plain(union_h[:2]),
                         "radix histograms @ (h)'s union")]
    errs += hist_checks

    # past 2**30: n = 2**30 + 4097 keys, all but 2048 of one value, so a
    # digit of every pass holds more than 2**30 keys; the input index rides.
    # Held without the plain version: keys non-decreasing, indices rising
    # within equal keys, indices a permutation, and each key its index's.
    def huge_check():
        n = (1 << 30) + 4097
        keys = torch.full((n,), 0x2A2A2A2A, dtype=torch.int32, device=dev)
        at = torch.arange(2048, device=dev, dtype=torch.int64) * (n // 2048)
        keys[at] = rand_lane(2048)
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        out_k, out_i = k2.radix_sort([keys, idx])
        del idx
        f = torch.bitwise_xor(out_k, -(1 << 31))
        ok = [bool((f[1:] >= f[:-1]).all())]
        eq = out_k[1:] == out_k[:-1]
        ok.append(bool(((out_i[1:] > out_i[:-1]) | ~eq).all()))
        del f, eq
        seen = torch.zeros(n, dtype=torch.bool, device=dev)
        same = True
        for c in range(0, n, 1 << 28):
            i = out_i[c:c + (1 << 28)].to(torch.int64)
            seen[i] = True
            same &= bool(torch.equal(keys[i], out_k[c:c + (1 << 28)]))
        ok += [bool(seen.all()), same]
        if not all(ok):
            raise AssertionError(f"radix sort of {n} keys: sorted, stable, "
                                 f"permutation, keys ride: {ok}")
        return {"elements": n, "largest_digit_count": n - 2048,
                "checks": len(ok)}

    huge = huge_check()
    errs += [0] * huge["checks"]
    torch.cuda.empty_cache()

    m = union.numel()
    flipped = torch.bitwise_xor(union, -(1 << 31))   # uint32 order as int32
    results["radix_sort"] = {
        "max_abs_err": max(errs),
        "ms": time_ms(lambda: k2.radix_sort([union])),
        "plain_ms": time_ms(lambda: k2.radix_sort_plain([union]), reps=3),
        "bound_ms": 8 * m / hbm_bytes_per_s * 1e3,
        "library_ms": time_ms(lambda: torch.sort(flipped)),
    }
    k2_shapes = {}

    def k2_shape(name, lanes, num_keys=1, key_bounds=None, ms=None):
        """K2's time at one main-path shape beside its bound (each lane
        read and written once), its pass floor (that, every pass) and,
        for one lane, torch.sort of the same keys."""
        n, k = lanes[0].numel(), len(lanes)
        passes = len(k2.pass_plan(num_keys, key_bounds))
        if ms is None:
            ms = time_ms(lambda: k2.radix_sort(lanes, num_keys=num_keys,
                                               key_bounds=key_bounds))
        lib = None
        if k == 1:
            signed = torch.bitwise_xor(lanes[0], -(1 << 31))
            lib = time_ms(lambda: torch.sort(signed))
            del signed
        k2_shapes[name] = {
            "elements": n, "lanes": k, "passes": passes, "ms": ms,
            "bound_ms": k * 8 * n / hbm_bytes_per_s * 1e3,
            "pass_floor_ms": passes * k * 8 * n / hbm_bytes_per_s * 1e3,
            "library_ms": lib}

    k2_shape("a_packed_union", [union], ms=results["radix_sort"]["ms"])
    k2_shape("h_wide_union", union_h, num_keys=2)
    emit({"phase": "kernel", "kernel": "radix_sort", "elements": m,
          "checks": len(errs), "histogram_checks": len(hist_checks),
          "histogram_ms": time_ms(lambda: k2.radix_histograms([union])),
          "device_us": device_us(lambda: k2.radix_sort([union])),
          "past_2p30": huge, "tile_keys": tile,
          "lookback_bytes": {
              "a": 8 * k2.scratch_layout(m, 4).lookback_words,
              "past_2p30": 8 * k2.scratch_layout(huge["elements"],
                                                 4).lookback_words},
          **results["radix_sort"]})

    # ---------------------------------------------------------- K3 probe
    errs = []
    got = k3.merge_scan_partitions(sorted_union, num_partitions=num_p)
    ref = k3.merge_scan_plain(sorted_union, fanout)
    errs += [exact(got[0], ref[0], "merge scan counts @ main shape"),
             exact(got[1], ref[1], "merge scan max weight @ main shape")]

    def probe_case(name, r_keys, s_keys, f):
        packed = k2.radix_sort_plain([_pack_pm(r_keys, s_keys, f)])[0]
        g = k3.merge_scan_partitions(packed, num_partitions=1 << f)
        p = k3.merge_scan_plain(packed, f)
        return [exact(g[0], p[0], f"merge scan counts, {name}"),
                exact(g[1], p[1], f"merge scan max weight, {name}")]

    for n in (1, 255, 32767, 32769, 1000003):
        errs += probe_case(f"random_{n}", rand_lane(n, hi=1 << 20),
                           rand_lane(n, hi=1 << 20), fanout)
    run = 3 * 4096 + 17                 # one key run longer than a block
    seven = narrow(torch.full((run,), 7, dtype=torch.int64)).to(dev)
    errs += probe_case("long_run", seven, seven, fanout)
    errs += probe_case("long_run_fanout0", seven, seven, 0)
    edge = narrow(torch.tensor([MAX_MERGE_KEY, MAX_MERGE_KEY + 1,
                                0xFFFFFFFE, 0xFFFFFFFF, 0] * 9001,
                               dtype=torch.int64)).to(dev)
    errs += probe_case("max_merge_key_and_sentinels", edge, edge, 7)
    # the pack runs int32 arithmetic on the card: its bits against the host's
    wide = rand_lane(1000003)
    for f in (0, 5, 7):
        for lane in (edge, wide):
            errs.append(exact(_pack_pm(lane, lane, f),
                              _pack_pm(lane.cpu(), lane.cpu(), f).to(dev),
                              f"pack fanout {f}"))
    dup = rand_lane(500003, hi=97)
    errs += probe_case("duplicate_heavy", dup, rand_lane(500003, hi=97), 3)
    # the single pass's edges: lengths at its tile (SCAN_TILE positions),
    # one key's run over more than three tiles, 128 partitions of a few
    # positions each, and lanes offset by one element (4-byte loads)
    scan_tile = k3.SCAN_TILE

    def packed_case(name, packed, f):
        g = k3.merge_scan_partitions(packed, num_partitions=1 << f)
        p = k3.merge_scan_plain(packed, f)
        return [exact(g[0], p[0], f"merge scan counts, {name}"),
                exact(g[1], p[1], f"merge scan max weight, {name}")]

    for f in (0, 5, 7):
        for n in (scan_tile - 1, scan_tile, scan_tile + 1):
            errs += probe_case(f"{n} positions, fanout {f}",
                               rand_lane(n // 2, hi=1 << 12),
                               rand_lane(n - n // 2, hi=1 << 12), f)
        run4 = narrow(torch.full((2 * scan_tile + 17,), 7,
                                 dtype=torch.int64)).to(dev)
        errs += probe_case(f"one run over 4 tiles, fanout {f}", run4, run4, f)
    few = rand_lane(3000, hi=1 << 11)
    errs += probe_case("128 partitions of a few positions", few[:1400],
                       few[1000:], 7)
    errs += packed_case("(a)'s union offset by one", sorted_union[1:],
                        fanout)
    errs += packed_case("3 tiles + 17 offset by one",
                        sorted_union[1:3 * scan_tile + 18], fanout)
    results["merge_scan"] = {
        "max_abs_err": max(errs),
        "ms": time_ms(lambda: k3.merge_scan_partitions(
            sorted_union, num_partitions=num_p)),
        "plain_ms": time_ms(lambda: k3.merge_scan_plain(sorted_union, fanout),
                            reps=3),
        "bound_ms": (4 * m + 4 * (num_p + 1)) / hbm_bytes_per_s * 1e3,
        "library_ms": None,
    }
    emit({"phase": "kernel", "kernel": "merge_scan", "elements": m,
          "checks": len(errs), "scan_tile": scan_tile,
          "scratch_bytes": k3.scratch_layout(m, fanout).bytes,
          "device_us": device_us(lambda: k3.merge_scan_partitions(
              sorted_union, num_partitions=num_p)),
          **results["merge_scan"]})

    # ------------------------------------------------------ K1 histogram
    errs = [exact(k1.histogram(s_pid, num_bins=num_p),
                  k1.histogram_plain(s_pid, None, num_p),
                  "histogram @ main shape")]
    for n in (1, 255, 32767, 32769, 1000003):
        ids = rand_lane(n, hi=200)                    # ids >= P are ignored
        w = rand_lane(n)
        for bins in (1, 32, 128):
            errs.append(exact(k1.histogram(ids, num_bins=bins),
                              k1.histogram_plain(ids, None, bins),
                              f"histogram {n} x {bins}"))
            errs.append(exact(k1.histogram(ids, w, num_bins=bins),
                              k1.histogram_plain(ids, w, bins),
                              f"weighted histogram {n} x {bins}"))
    same = torch.zeros(1000003, dtype=torch.int32, device=dev)
    errs.append(exact(k1.histogram(same, num_bins=32),
                      k1.histogram_plain(same, None, 32), "histogram, one bin"))
    results["histogram"] = {
        "max_abs_err": max(errs),
        "ms": time_ms(lambda: k1.histogram(s_pid, num_bins=num_p)),
        "plain_ms": time_ms(lambda: k1.histogram_plain(s_pid, None, num_p)),
        "bound_ms": (4 * n_main + 4 * num_p) / hbm_bytes_per_s * 1e3,
        "library_ms": time_ms(lambda: torch.bincount(s_pid, minlength=num_p)),
    }
    emit({"phase": "kernel", "kernel": "histogram", "elements": n_main,
          "checks": len(errs),
          "device_us": device_us(lambda: k1.histogram(s_pid, num_bins=num_p)),
          **results["histogram"]})
    del union, flipped, sorted_union, s_pid

    # ------------------------------------------------------ K4 partition
    # the partitioned join's two shapes at 20M (one rank), as its calls
    # give them: the exchange groups 20M ids into one block of 2**25
    # slots; the local pass groups the 2**25 received slots into 32
    # buckets of bucket_capacity(2**25, 32) slots, pad slots carrying the
    # invalid id 32, which K4 drops (ops/radix.scatter_to_blocks)
    cfg_b = JoinConfig(probe_algorithm="bucket")
    cap_x = 1 << (n_main - 1).bit_length()
    n_buckets = cfg_b.local_partition_count
    lcap = cfg_b.bucket_capacity(cap_x, n_buckets)
    fills = [R_PAD_KEY, PAD_RID]
    ex_ids = torch.zeros(n_main, dtype=torch.int32, device=dev)
    (rx_key, rx_rid), _ = k4.partition_scatter(
        ex_ids, [r_main.key, r_main.rid], fills, num_groups=1,
        capacity=cap_x)
    received = TupleBatch(key=rx_key, rid=rx_rid)
    loc_ids = torch.where(valid_mask(received, "inner"),
                          local_bucket_ids(received, fanout,
                                           cfg_b.local_fanout_bits),
                          n_buckets).to(torch.int32)
    k4_shapes = {
        "exchange": (ex_ids, [r_main.key, r_main.rid], 1, 1, cap_x),
        "local": (loc_ids, [rx_key, rx_rid], n_buckets, 1, lcap),
    }

    def k4_case(name, ids, lanes, groups, gsize, cap):
        """K4 (slots and the lanes it moves) against its plain version."""
        got = k4.partition_slots(ids, num_groups=groups, group_size=gsize,
                                 capacity=cap)
        ref = k4.partition_slots_plain(ids, groups, gsize, cap)
        out = [exact(got[0], ref[0], f"partition slots, {name}"),
               exact(got[1], ref[1], f"partition hist, {name}")]
        pads = [R_PAD_KEY, PAD_RID, S_PAD_KEY, 7][:len(lanes)]
        got = k4.partition_scatter(ids, lanes, pads, num_groups=groups,
                                   group_size=gsize, capacity=cap)
        ref = k4.partition_scatter_plain(ids, lanes, pads, groups, gsize, cap)
        for i, (g, r) in enumerate(zip(got[0], ref[0])):
            out.append(exact(g, r, f"partition lane {i}, {name}"))
        out.append(exact(got[1], ref[1], f"partition scatter hist, {name}"))
        return out

    errs = []
    for name, (ids, lanes, groups, gsize, cap) in k4_shapes.items():
        errs += k4_case(f"{name} @ main shape", ids, lanes, groups, gsize,
                        cap)
    # the exchange call of a 4- and an 8-rank world, as network_partition
    # gives it: 20M ids, dest = round-robin assignment[pid], into 4 blocks
    # of 2**23 slots and 8 of 2**22
    r_pid = torch.bitwise_and(r_main.key, num_p - 1)
    exchange_groups = {}
    for groups, cap in ((4, 1 << 23), (8, 1 << 22)):
        assign = torch.arange(num_p, dtype=torch.int32, device=dev) % groups
        dest = torch.index_select(assign, 0, r_pid)
        errs += k4_case(f"exchange into {groups} groups of {cap}", dest,
                        [r_main.key, r_main.rid], groups, 1, cap)
        if groups == 4:
            dest4 = dest
        exchange_groups[groups] = {
            "elements": n_main, "out_slots": groups * cap,
            "ms": time_ms(lambda: k4.partition_scatter(
                dest, [r_main.key, r_main.rid], fills, num_groups=groups,
                capacity=cap))}
    # the packed exchange's grouped call (ops/radix.
    # scatter_to_blocks_grouped): the composite id dest * 32 + pid into 128
    # groups, 32 a block, at the 4-rank join's 2**23 slots and clipped at
    # 2**22 (each block's highest pids lose their tail)
    comp = dest4 * num_p + r_pid
    for cap in (1 << 23, 1 << 22):
        errs += k4_case(f"grouped exchange, 128 groups / 32, capacity {cap}",
                        comp, [r_main.key, r_main.rid], 4 * num_p, num_p,
                        cap)
    exchange_groups["grouped_128x32"] = {
        "elements": n_main, "out_slots": 4 * (1 << 23),
        "ms": time_ms(lambda: k4.partition_scatter(
            comp, [r_main.key, r_main.rid], fills, num_groups=4 * num_p,
            group_size=num_p, capacity=1 << 23)),
        "device_us": device_us(lambda: k4.partition_scatter(
            comp, [r_main.key, r_main.rid], fills, num_groups=4 * num_p,
            group_size=num_p, capacity=1 << 23))}
    del r_pid, dest, dest4, comp
    # dense mode with the pads as a real last group: reorder_by_partition's
    # call, on the main path's ids
    errs += k4_case("dense reorder @ main shape", loc_ids, [rx_key, rx_rid],
                    n_buckets + 1, 1, None)
    for n in (1, 255, 4097, 32769, 600_000, 1000003):
        lanes = [rand_lane(n) for _ in range(4)]
        for groups, gsize, hi in ((7, 1, 10), (16, 4, 18), (256, 1, 257),
                                  (5, 1, 1 << 32)):
            ids = rand_lane(n, hi=hi)          # some ids >= groups: invalid
            for cap in (None, max(1, n // groups), max(1, n // 2)):
                errs += k4_case(f"{n} ids, {groups} groups / {gsize}, "
                                f"capacity {cap}", ids, lanes, groups,
                                gsize, cap)
    for name, ids in (
            ("all equal", torch.full((100003,), 3, dtype=torch.int32,
                                     device=dev)),
            ("all invalid", rand_lane(100003, lo=256)),
            ("id 256 of 256", narrow(torch.tensor([256, 0, 255] * 33335,
                                                  dtype=torch.int64)).to(dev))):
        lanes = [rand_lane(ids.numel()) for _ in range(2)]
        for cap in (None, 1000, 60000):
            errs += k4_case(f"{name}, capacity {cap}", ids, lanes, 256, 1,
                            cap)
    # the onesweep pass's edges at the local shape: every id in one group
    # (one look-back chain, a run of 2**25), capacity 1 (all but 32 clipped)
    # and dense mode with every id invalid, so the pads fill every slot
    rx_lanes = [rx_key, rx_rid]
    errs += k4_case("one group @ local shape", torch.zeros_like(loc_ids),
                    rx_lanes, n_buckets, 1, lcap)
    errs += k4_case("capacity 1 @ local shape", loc_ids, rx_lanes, n_buckets,
                    1, 1)
    errs += k4_case("all invalid, dense @ local shape",
                    torch.full_like(loc_ids, n_buckets), rx_lanes, n_buckets,
                    1, None)
    for n in (k4.TILE_IDS - 1, k4.TILE_IDS, k4.TILE_IDS + 1):
        lanes = [rand_lane(n) for _ in range(2)]
        errs += k4_case(f"{n} ids, 32 groups", rand_lane(n, hi=33), lanes,
                        32, 1, n // 40 + 1)
    ids, lanes, groups, gsize, cap = k4_shapes["local"]
    m4, out4 = ids.numel(), k4.out_size(ids.numel(), groups, gsize, cap)
    ex_ms = time_ms(lambda: k4.partition_scatter(
        ex_ids, [r_main.key, r_main.rid], fills, num_groups=1,
        capacity=cap_x))
    results["partition"] = {
        "max_abs_err": max(errs),
        "ms": time_ms(lambda: k4.partition_scatter(
            ids, lanes, fills, num_groups=groups, capacity=cap)),
        "plain_ms": time_ms(lambda: k4.partition_scatter_plain(
            ids, lanes, fills, groups, gsize, cap), reps=3),
        # ids read, two lanes read, two block layouts written, the hist
        "bound_ms": (4 * m4 + 2 * 4 * m4 + 2 * 4 * out4 + 4 * groups)
        / hbm_bytes_per_s * 1e3,
        "library_ms": time_ms(lambda: torch.argsort(ids, stable=True)),
    }
    exchange_shape = {
        "elements": n_main, "out_slots": cap_x, "ms": ex_ms,
        "bound_ms": (4 * n_main + 2 * 4 * n_main + 2 * 4 * cap_x + 4)
        / hbm_bytes_per_s * 1e3,
        "library_ms": time_ms(lambda: torch.argsort(ex_ids, stable=True)),
        "device_us": device_us(lambda: k4.partition_scatter(
            ex_ids, [r_main.key, r_main.rid], fills, num_groups=1,
            capacity=cap_x))}
    local_device_us = device_us(lambda: k4.partition_scatter(
        ids, lanes, fills, num_groups=groups, capacity=cap))
    del (r_main, s_main, ex_ids, rx_key, rx_rid, rx_lanes, received, loc_ids,
         k4_shapes, ids, lanes)
    torch.cuda.empty_cache()

    # past 2**31 ids in slots mode: group 0's look-back counts pass 2**31
    huge4 = k4_huge_check(dev, widen, 4)
    errs += [0] * huge4["checks"]
    torch.cuda.empty_cache()
    results["partition"]["max_abs_err"] = max(errs)
    emit({"phase": "kernel", "kernel": "partition", "elements": m4,
          "out_slots": out4, "checks": len(errs), "past_2p31": huge4,
          "scratch_bytes": {"local": k4.scratch_layout(m4, groups).bytes,
                            "exchange": k4.scratch_layout(n_main, 1).bytes},
          "exchange_shape": exchange_shape, "device_us": local_device_us,
          "exchange_groups": exchange_groups,
          **results["partition"]})

    # ------------------------------------------------------ K5 wide probe
    # its two main-path shapes: (h)'s sorted 40M three-lane union (lo
    # rotated, hi, tag) and (g)'s sorted 40M two-lane union with no hi lane
    def flipped(rel, where=dev):
        """A relation's lanes with bit 31 of every key set: [2**31, ...)."""
        b = rel.generate(where)
        return TupleBatch(key=torch.bitwise_xor(b.key, -(1 << 31)), rid=b.rid)

    rel_g = (Relation(n_main, 1, "unique", seed=1234),
             Relation(n_main, 1, "zipf", seed=1235, zipf_theta=0.75,
                      key_domain=n_main))
    union_g = wide_union(*(flipped(rel) for rel in rel_g), fanout)
    # K2 on the wide sort's shape, once: the plain version takes seconds
    errs = []
    sorted_h = k2.radix_sort(union_h, num_keys=2)
    for i, (g, r) in enumerate(zip(sorted_h, k2.radix_sort_plain(
            union_h, num_keys=2))):
        errs.append(exact(g, r, f"radix sort lane {i}, (h)'s wide union"))
    sorted_g = k2.radix_sort(union_g, num_keys=1)
    m5 = sorted_h[0].numel()
    k2_wide_ms = k2_shapes["h_wide_union"]["ms"]
    del union_h, union_g

    def wide_case(name, lo_rot, hi, tag, f):
        """K5 against its plain version on lanes sorted by (lo_rot, hi)."""
        keys = [lo_rot] if hi is None else [lo_rot, hi]
        lanes = k2.radix_sort([*keys, tag], num_keys=len(keys))
        lo_s, hi_s = lanes[0], (None if hi is None else lanes[1])
        g = k5.merge_scan_partitions_wide(lo_s, hi_s, lanes[-1],
                                          num_partitions=1 << f)
        p = k5.merge_scan_wide_plain(lo_s, hi_s, lanes[-1], f)
        return [exact(g[0], p[0], f"wide merge scan counts, {name}"),
                exact(g[1], p[1], f"wide merge scan max weight, {name}")]

    sorted_sets = {"(h) wide union": sorted_h,
                   "(g) full-range union": [sorted_g[0], None, sorted_g[1]]}
    for name, (lo_s, hi_s, tag_s) in sorted_sets.items():
        g = k5.merge_scan_partitions_wide(lo_s, hi_s, tag_s,
                                          num_partitions=num_p)
        p = k5.merge_scan_wide_plain(lo_s, hi_s, tag_s, fanout)
        errs += [exact(g[0], p[0], f"wide merge scan counts, {name}"),
                 exact(g[1], p[1], f"wide merge scan max weight, {name}")]

    def sides(n):
        """Tags of a union of n // 2 inner then n - n // 2 outer tuples."""
        return (torch.arange(n, device=dev) >= n // 2).to(torch.int32)

    for n in (1, 255, 32767, 32769, 1000003):
        for hi in (rand_lane(n, hi=4), None):
            errs += wide_case(f"random_{n}, hi {hi is not None}",
                              rand_lane(n, hi=1 << 12), hi, sides(n), fanout)
    run = 3 * 2304 + 17                 # one key's run longer than a block
    key = narrow(torch.full((2 * run,), 0x12345678, dtype=torch.int64)).to(dev)
    for f in (0, 5, 7):
        errs += wide_case(f"long_run, fanout {f}", key, key, sides(2 * run), f)
        errs += wide_case(f"long_run, no hi, fanout {f}", key, None,
                          sides(2 * run), f)
    # equal lo with different hi, which generated relations never give
    n = 200003
    errs += wide_case("equal_lo_different_hi", rand_lane(n, hi=16),
                      rand_lane(n, hi=4), rand_lane(n, hi=2), fanout)
    edge = torch.tensor([0, 0xFFFFFFFF, 0xFFFFFFFE, 1, MAX_MERGE_KEY,
                         0x80000000], dtype=torch.int64)

    def pick(n):
        return narrow(edge[torch.randint(0, len(edge), (n,),
                                         generator=gen)]).to(dev)
    for f in (0, 5, 7):
        errs += wide_case(f"lo 0 / all-ones and sentinel pairs, fanout {f}",
                          pick(n), pick(n), rand_lane(n, hi=2), f)
        errs += wide_case(f"lo 0 / all-ones, no hi, fanout {f}", pick(n),
                          None, rand_lane(n, hi=2), f)
    ones = narrow(torch.full((70001,), 0xFFFFFFFF, dtype=torch.int64)).to(dev)
    errs += wide_case("all-ones S-pad triples", ones, ones,
                      torch.ones(70001, dtype=torch.int32, device=dev), fanout)
    errs += wide_case("duplicate_heavy", rand_lane(500003, hi=97),
                      rand_lane(500003, hi=3), sides(500003), 3)
    # the single pass's edges, as K3's: its tile's lengths, one key's run
    # over more than three tiles, 128 partitions of a few positions each,
    # and each lane offset by one element alone (4-byte loads)
    for f in (0, 5, 7):
        for n in (scan_tile - 1, scan_tile, scan_tile + 1):
            for hi in (rand_lane(n, hi=4), None):
                errs += wide_case(f"{n} positions, fanout {f}, hi "
                                  f"{hi is not None}", rand_lane(n, hi=1 << 12),
                                  hi, sides(n), f)
        key4 = narrow(torch.full((4 * scan_tile + 34,), 0x12345678,
                                 dtype=torch.int64)).to(dev)
        errs += wide_case(f"one run over 4 tiles, fanout {f}", key4, key4,
                          sides(key4.numel()), f)
        errs += wide_case(f"one run over 4 tiles, no hi, fanout {f}", key4,
                          None, sides(key4.numel()), f)
    few = rand_lane(3000, hi=1 << 11)
    for hi in (rand_lane(3000, hi=2), None):
        errs += wide_case(f"128 partitions of a few positions, hi "
                          f"{hi is not None}", narrow(widen(few) << 21), hi,
                          sides(3000), 7)

    def offset_case(name, lanes):
        g = k5.merge_scan_partitions_wide(*lanes, num_partitions=num_p)
        p = k5.merge_scan_wide_plain(*lanes, fanout)
        return [exact(g[0], p[0], f"wide merge scan counts, {name}"),
                exact(g[1], p[1], f"wide merge scan max weight, {name}")]

    # each lane copied one element off its 16-byte alignment, the others
    # left aligned: the tile takes the 4-byte path for that lane alone
    cut = 3 * scan_tile + 17
    for i in range(3):
        lanes = [x[:cut] for x in sorted_h]
        moved = torch.empty(cut + 1, dtype=torch.int32, device=dev)
        moved[1:] = lanes[i]
        lanes[i] = moved[1:]
        errs += offset_case(f"(h)'s lane {i} offset by one", lanes)
    errs += offset_case("(h)'s union offset by one",
                        [x[1:] for x in sorted_h])
    errs += offset_case("(g)'s union offset by one",
                        [sorted_g[0][1:], None, sorted_g[1][1:]])
    lo_h, hi_h, tag_h = sorted_h
    results["merge_scan_wide"] = {
        "max_abs_err": max(errs),
        "ms": time_ms(lambda: k5.merge_scan_partitions_wide(
            lo_h, hi_h, tag_h, num_partitions=num_p)),
        "plain_ms": time_ms(lambda: k5.merge_scan_wide_plain(
            lo_h, hi_h, tag_h, fanout), reps=3),
        # three lanes read once, the counts and the max weight written
        "bound_ms": (3 * 4 * m5 + 4 * (num_p + 1)) / hbm_bytes_per_s * 1e3,
        "library_ms": None,
    }
    emit({"phase": "kernel", "kernel": "merge_scan_wide", "elements": m5,
          "checks": len(errs), "scan_tile": scan_tile,
          "scratch_bytes": k5.scratch_layout(m5, fanout).bytes,
          "device_us": device_us(lambda: k5.merge_scan_partitions_wide(
              lo_h, hi_h, tag_h, num_partitions=num_p)),
          "full_range_shape": {
              "elements": sorted_g[0].numel(),
              "ms": time_ms(lambda: k5.merge_scan_partitions_wide(
                  sorted_g[0], None, sorted_g[1], num_partitions=num_p)),
              "device_us": device_us(lambda: k5.merge_scan_partitions_wide(
                  sorted_g[0], None, sorted_g[1], num_partitions=num_p)),
              "bound_ms": (2 * 4 * sorted_g[0].numel() + 4 * (num_p + 1))
              / hbm_bytes_per_s * 1e3},
          "radix_sort_wide_shape": {"elements": m5, "lanes": 3, "passes": 8,
                                    "ms": k2_wide_ms},
          **results["merge_scan_wide"]})
    del sorted_h, sorted_g, sorted_sets, lo_h, hi_h, tag_h

    # ------------------------------------------------- K6 per-window scan
    # its main-path shapes, each a first slab's sorted union at 1024
    # windows: (k)'s (one 2**25 inner chunk and a 2**20 outer slab), (k')'s
    # (the same with the modulo inner, weights of 512) and (l)'s (the
    # 20M inner and a FALLBACK_SLAB outer slab).  Beside them the TPU
    # kernel's own width, TILE, on (a)'s sorted 40M union packed at fanout
    # 0: merge_count_pallas's shape, which no grid path runs.
    n_k, chunk_k, slab_size = 1 << 26, 1 << 25, 1 << 20
    grid_k = (Relation(n_k, 1, "unique", seed=1234),
              Relation(n_k, 1, "unique", seed=1235))
    rel_km = (Relation(n_k, 1, "modulo", seed=1234, modulo=65536),
              grid_k[1])
    r_k = next(stream_chunks_device(grid_k[0], 0, chunk_k, dev))
    s_k = next(stream_chunks_device(grid_k[1], 0, chunk_k, dev))
    slab_k = k2.radix_sort([_pack(r_k.key, s_k.key[:slab_size])])[0]
    m_k = slab_k.numel()
    w_k = -(-m_k // chunked.SLAB_WINDOWS)
    r_km = next(stream_chunks_device(rel_km[0], 0, chunk_k, dev))
    slab_km = k2.radix_sort([_pack(r_km.key, s_k.key[:slab_size])])[0]
    del r_km
    rel_l = (Relation(n_main, 1, "unique", seed=1234),
             Relation(n_main, 1, "zipf", seed=1235, zipf_theta=0.75,
                      key_domain=n_main))
    outer_l = rel_l[1].generate(dev).key[:FALLBACK_SLAB]
    slab_l = k2.radix_sort([_pack(rel_l[0].generate(dev).key, outer_l)])[0]
    del outer_l
    w_l = -(-slab_l.numel() // chunked.SLAB_WINDOWS)
    union_a = k2.radix_sort([_pack(inner.generate(dev).key,
                                   outer.generate(dev).key)])[0]

    def k6_case(name, packed, w):
        got = k6.merge_scan_chunks(packed, width=w)
        ref = k6.merge_scan_chunks_plain(packed, w)
        return [exact(got[0], ref[0], f"window sums, {name}"),
                exact(got[1], ref[1], f"window max weight, {name}")]

    def sorted_pack(r_keys, s_keys):
        return k2.radix_sort_plain([_pack(r_keys, s_keys)])[0]

    errs = k6_case("(k)'s slab union", slab_k, w_k)
    errs += k6_case("(k')'s modulo-inner slab union", slab_km, w_k)
    maxw_km = int(k6.merge_scan_chunks_plain(slab_km, w_k)[1])
    if maxw_km <= 1:
        raise AssertionError("(k')'s slab union has no weight above 1")
    errs += k6_case("(l)'s first slab union", slab_l, w_l)
    errs += k6_case("(a)'s union at TILE (merge_count_pallas)", union_a,
                    k6.TILE)
    key7 = narrow(torch.full((3 * k6.TILE,), 7, dtype=torch.int64)).to(dev)
    spanning = sorted_pack(key7, key7[:2 * k6.TILE])
    for w in (1, 1000, 4097, k6.TILE, w_k):
        errs += k6_case(f"one key over many windows, width {w}", spanning, w)
    pads = narrow(torch.full((100003,), 0xFFFFFFFF, dtype=torch.int64)).to(dev)
    errs += k6_case("all pads", pads, 33)
    key42 = narrow(torch.full((2 * k6.TILE,), 42, dtype=torch.int64)).to(dev)
    r_run = sorted_pack(key42, torch.cat([key42[:100], narrow(torch.arange(
        1000, 1000 + k6.TILE, dtype=torch.int64)).to(dev)]))
    errs += k6_case("two-tile R run", r_run, k6.TILE)
    for n in (1, 255, 32767, 32769, 1000003):
        packed = sorted_pack(rand_lane(n // 2 + 1, hi=1 << 16),
                             rand_lane(n - n // 2, hi=1 << 16))
        for w in (1, 7, 15, 480, 977, 33792, k6.TILE, 5000000):
            errs += k6_case(f"random {packed.numel()}, width {w}", packed, w)
    dup = sorted_pack(rand_lane(500003, hi=97), rand_lane(500003, hi=97))
    errs += k6_case("duplicate heavy, width 977", dup, 977)
    # the single pass's edges: lengths at the tile counter's (a tile of
    # SCAN_TILE positions, 39 a thread), widths under a thread's items, and
    # one key's run over more than three tiles
    scan_tile = k6.SCAN_TILE
    for n in (scan_tile - 1, scan_tile, scan_tile + 1):
        packed = sorted_pack(rand_lane(n // 2, hi=1 << 12),
                             rand_lane(n - n // 2, hi=1 << 12))
        for w in (1, 7, 38, 39, 977, scan_tile - 1, scan_tile,
                  scan_tile + 1):
            errs += k6_case(f"{n} positions, width {w}", packed, w)
    key9 = narrow(torch.full((4 * scan_tile,), 9, dtype=torch.int64)).to(dev)
    run4 = sorted_pack(key9, key9[:scan_tile + 5])
    for w in (1, 38, 4099, scan_tile, 33792):
        errs += k6_case(f"one run over 5 tiles, width {w}", run4, w)
    results["merge_scan_chunks"] = {
        "max_abs_err": max(errs),
        "ms": time_ms(lambda: k6.merge_scan_chunks(slab_k, width=w_k)),
        "plain_ms": time_ms(lambda: k6.merge_scan_chunks_plain(slab_k, w_k),
                            reps=3),
        # the packed lane read once, the window sums written once
        "bound_ms": (4 * m_k + 4 * -(-m_k // w_k)) / hbm_bytes_per_s * 1e3,
        "library_ms": None,
    }
    m_a = union_a.numel()
    emit({"phase": "kernel", "kernel": "merge_scan_chunks", "elements": m_k,
          "width": w_k, "checks": len(errs), "scan_tile": scan_tile,
          "scratch_bytes": k6.scratch_layout(m_k, w_k).bytes,
          "device_us": device_us(lambda: k6.merge_scan_chunks(slab_k,
                                                              width=w_k)),
          "modulo_inner_max_weight": maxw_km,
          "fallback_shape": {"elements": slab_l.numel(), "width": w_l},
          "tile_shape": {
              "elements": m_a, "width": k6.TILE,
              "ms": time_ms(lambda: k6.merge_scan_chunks(union_a,
                                                         width=k6.TILE)),
              "bound_ms": (4 * m_a + 4 * -(-m_a // k6.TILE))
              / hbm_bytes_per_s * 1e3},
          **results["merge_scan_chunks"]})
    del slab_k, slab_km, slab_l, union_a, spanning, r_run, dup, key7, key42
    del pads, run4, key9, packed

    # ---------------------------------------------------------- main path
    def cpu_agrees(cfg, inner_rel, outer_rel, flip=False):
        """A small join on the card equals the plain versions on the host
        and the host oracle (on the uint64 keys hi << 32 | lo for 64-bit
        relations); ``flip`` sets bit 31 of every key first."""
        def lanes(rel, where):
            return flipped(rel, where) if flip else rel.generate(where)

        def host_keys(b):
            lo = lane_to_numpy(b.key).astype(np.uint64)
            if b.key_hi is None:
                return lo
            return (lane_to_numpy(b.key_hi).astype(np.uint64)
                    << np.uint64(32)) | lo

        r, s = lanes(inner_rel, dev), lanes(outer_rel, dev)
        got = HashJoin(cfg).join_arrays(r, s)
        ref = HashJoin(cfg, device="cpu").join_arrays(
            lanes(inner_rel, "cpu"), lanes(outer_rel, "cpu"))
        oracle = host_join_count(host_keys(r), host_keys(s))
        if not (got.matches == ref.matches == oracle and got.ok and ref.ok
                and (got.partition_counts == ref.partition_counts).all()
                and got.retries == ref.retries):
            raise AssertionError(f"small join disagrees: card {got}, host "
                                 f"{ref}, oracle {oracle}")

    small = 1 << 16
    cpu_agrees(JoinConfig(), Relation(small, 1, "unique", seed=7),
               Relation(small, 1, "zipf", seed=8, zipf_theta=0.75))
    cpu_agrees(JoinConfig(), Relation(small, 1, "modulo", seed=7, modulo=4099),
               Relation(small, 1, "unique", seed=8))
    cpu_agrees(cfg_b, Relation(small, 1, "unique", seed=7),
               Relation(small, 1, "modulo", seed=8, modulo=4099))
    cpu_agrees(JoinConfig(two_level=True), Relation(small, 1, "unique", seed=7),
               Relation(small, 1, "unique", seed=8))
    # (g), (h) and (i) in small
    cpu_agrees(JoinConfig(), Relation(small, 1, "unique", seed=7),
               Relation(small, 1, "zipf", seed=8, zipf_theta=0.75), flip=True)
    for cfg in (JoinConfig(key_bits=64),
                JoinConfig(probe_algorithm="bucket", key_bits=64)):
        cpu_agrees(cfg, Relation(small, 1, "unique", seed=7, key_bits=64),
                   Relation(small, 1, "modulo", seed=8, modulo=4099,
                            key_bits=64))

    one_rank = {}   # the joins' results: cell (n) must equal some

    def drive(engine, name, run, expected, needed, retries=0):
        """One main-path join, its answer and the kernels it launched."""
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        after = kernels.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        if res.matches != expected or not res.ok or res.retries != retries:
            raise AssertionError(f"{name}: {res} (expected {expected} "
                                 f"matches after {retries} retries)")
        for k in needed:
            if delta[k] <= 0:
                raise AssertionError(f"{name}: kernel {k} did not launch")
        if not engine.config.sort_probe and \
                delta["partition"] != 4 * (retries + 1):
            raise AssertionError(f"{name}: {delta['partition']} partition "
                                 f"launches for {retries + 1} attempts")
        emit({"phase": "join", "workload": name, "matches": res.matches,
              "expected": expected, "ok": res.ok, "retries": res.retries,
              "failure_class": res.diagnostics["failure_class"],
              "launches": delta, "join_with_generation_ms": total_s * 1e3})
        one_rank[name] = res

    # the sort probe: (a), (b), (c)
    workloads = [
        ("unique_20M", Relation(n_main, 1, "unique", seed=1234),
         Relation(n_main, 1, "unique", seed=1235), n_main, ()),
        ("zipf_20M", Relation(n_main, 1, "unique", seed=1234),
         Relation(n_main, 1, "zipf", seed=1235, zipf_theta=0.75,
                  key_domain=n_main), n_main, ()),
        ("refine_2p24", Relation(1 << 24, 1, "modulo", seed=1234,
                                 modulo=65536),
         Relation(1 << 24, 1, "unique", seed=1235), 1 << 24,
         ("histogram",)),
    ]
    engine = HashJoin(JoinConfig())
    kernels.reset_launches()
    for name, inner_rel, outer_rel, expected, extra in workloads:
        drive(engine, name, lambda: engine.join(inner_rel, outer_rel),
              expected, ("radix_histogram", "radix_pass", "merge_scan",
                         *extra))
    launches = kernels.launch_counts()

    # the partitioned join: (d), (e), (f).  (e) needs four retries: the
    # Zipf(1.75) head puts ~95% of S in local bucket 0, 12x its capacity.
    # (f)'s lanes are made before the counts are reset.
    full_n = 1 << 24
    r_full = Relation(full_n, 1, "unique", seed=1234).generate(dev)
    s_full = Relation(full_n, 1, "modulo", seed=1235,
                      modulo=65536).generate(dev)
    r_full = TupleBatch(key=torch.bitwise_xor(r_full.key, -(1 << 31)),
                        rid=r_full.rid)
    s_full = TupleBatch(key=torch.bitwise_xor(s_full.key, -(1 << 31)),
                        rid=s_full.rid)
    full_oracle = host_join_count(lane_to_numpy(r_full.key),
                                  lane_to_numpy(s_full.key))
    torch.cuda.synchronize()
    zipf_retries = 4
    partitioned = [
        ("bucket_unique_20M", cfg_b,
         Relation(n_main, 1, "unique", seed=1234),
         Relation(n_main, 1, "unique", seed=1235), n_main, 0),
        ("two_level_zipf_20M",
         JoinConfig(two_level=True, max_retries=zipf_retries),
         Relation(n_main, 1, "unique", seed=1234),
         Relation(n_main, 1, "zipf", seed=1235, zipf_theta=0.75,
                  key_domain=n_main), n_main, zipf_retries),
    ]
    kernels.reset_launches()
    for name, cfg, inner_rel, outer_rel, expected, retries in partitioned:
        eng = HashJoin(cfg)
        drive(eng, name, lambda: eng.join(inner_rel, outer_rel), expected,
              ("histogram", "partition", "radix_histogram", "radix_pass"),
              retries)
    eng = HashJoin(cfg_b)
    drive(eng, "bucket_full_range_2p24",
          lambda: eng.join_arrays(r_full, s_full), full_oracle,
          ("histogram", "partition", "radix_histogram", "radix_pass"))
    launches = {k: v + launches[k] for k, v in kernels.launch_counts().items()}
    del r_full, s_full

    # full-range and 64-bit keys: (g), (h), (i); (g)'s lanes are made
    # before the counts are reset
    r_g, s_g = (flipped(rel) for rel in rel_g)
    torch.cuda.synchronize()
    eng_g = HashJoin(JoinConfig())
    eng_h = HashJoin(JoinConfig(key_bits=64))
    cfg_i = JoinConfig(probe_algorithm="bucket", key_bits=64)
    eng_i = HashJoin(cfg_i)
    kernels.reset_launches()
    before = kernels.launch_counts()
    drive(eng_g, "full_range_zipf_20M", lambda: eng_g.join_arrays(r_g, s_g),
          n_main, ("radix_histogram", "radix_pass", "merge_scan_wide"))
    if kernels.launch_counts()["merge_scan"] != before["merge_scan"]:
        raise AssertionError("full_range_zipf_20M: the narrow probe ran")
    drive(eng_h, "wide_unique_20M", lambda: eng_h.join(*rel_h), n_main,
          ("radix_histogram", "radix_pass", "merge_scan_wide"))
    drive(eng_i, "bucket_wide_unique_20M", lambda: eng_i.join(*rel_h),
          n_main, ("histogram", "partition", "radix_histogram",
                   "radix_pass"))
    launches = {k: v + launches[k] for k, v in kernels.launch_counts().items()}

    # the out-of-core grid: (j), (k), (l), (m).  A small grid on the card
    # first equals the plain versions on the host and the host oracle.
    def grid_on(rel_r, rel_s, chunk, where, pipeline, slab=None):
        return chunked.chunked_join_grid(
            stream_chunks_device(rel_r, 0, chunk, where),
            lambda: stream_chunks_device(rel_s, 0, chunk, where),
            slab or min(chunk, 1 << 20), pipeline=pipeline)

    small_rels = (Relation(small, 1, "modulo", seed=7, modulo=4099),
                  Relation(small, 1, "zipf", seed=8, zipf_theta=0.75))
    small_oracle = host_join_count(*(lane_to_numpy(rel.generate("cpu").key)
                                     for rel in small_rels))
    for pipeline in ("off", "on"):
        got = grid_on(*small_rels, small // 4, dev, pipeline, slab=4096)
        ref = grid_on(*small_rels, small // 4, "cpu", pipeline, slab=4096)
        if not got == ref == small_oracle:
            raise AssertionError(f"small grid ({pipeline}) disagrees: card "
                                 f"{got}, host {ref}, oracle {small_oracle}")

    def grid_cell(name, run, expected, counters, want_launches, tuples):
        """One main-path grid run: its total, its counters, the kernels it
        launched (an int: exactly; None: at least once) and its time,
        chunk generation included."""
        meas = Measurements()
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total = run(meas)
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
        after = kernels.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        if total != expected:
            raise AssertionError(f"{name}: {total} matches, expected "
                                 f"{expected}")
        for k, v in counters.items():
            if meas.counters.get(k, 0) != v:
                raise AssertionError(f"{name}: counter {k} is "
                                     f"{meas.counters.get(k, 0)}, not {v}")
        for k, v in want_launches.items():
            if (delta[k] <= 0) if v is None else (delta[k] != v):
                raise AssertionError(f"{name}: kernel {k} launched "
                                     f"{delta[k]} times, expected "
                                     f"{'some' if v is None else v}")
        pairs = meas.counters.get("GRIDPAIRS", 0)
        emit({"phase": "grid", "workload": name, "matches": total,
              "expected": expected, "counters": dict(meas.counters),
              "launches": delta, "grid_ms": grid_s * 1e3,
              "tuples_per_s": tuples / grid_s, "pairs_per_s": pairs / grid_s,
              "matches_per_s": total / grid_s,
              "span_s": {k: round(v, 6) for k, v in meas.span_s.items()},
              **card})
        return grid_s

    def grid_run(rels, chunk, pipeline, slab=None):
        return lambda meas: chunked.chunked_join_grid(
            stream_chunks_device(rels[0], 0, chunk, dev),
            lambda: stream_chunks_device(rels[1], 0, chunk, dev),
            slab or min(chunk, 1 << 20), pipeline=pipeline,
            measurements=meas)

    n_j, chunk_j = GRID_J_TUPLES, 1 << 27
    rows_j = n_j // chunk_j
    rel_j = (Relation(n_j, 1, "unique", seed=1234),
             Relation(n_j, 1, "unique", seed=1235))
    n_m, chunk_m = 1 << 24, 1 << 23
    rel_m = (Relation(n_m, 1, "unique", seed=1234, key_bits=64),
             Relation(n_m, 1, "unique", seed=1235, key_bits=64))
    wide_keys = []
    for rel in rel_m:
        b = rel.generate(dev)
        wide_keys.append((lane_to_numpy(b.key_hi).astype(np.uint64)
                          << np.uint64(32)) | lane_to_numpy(b.key))
    oracle_m = host_join_count(*wide_keys)
    del wide_keys, b
    pairs_k = (n_k // chunk_k) ** 2
    slabs_k = pairs_k * (chunk_k // slab_size)
    pairs_m = (n_m // chunk_m) ** 2
    slabs_m = pairs_m * (chunk_m // min(chunk_m, slab_size))
    kernels.reset_launches()
    ms_grid = {}
    ms_grid["j"] = grid_cell(
        "j_pipelined_unique_grid", grid_run(rel_j, chunk_j, "auto"), n_j,
        {"GRIDPAIRS": rows_j * rows_j, "SORTREUSE": rows_j * (rows_j - 1)},
        {"radix_histogram": rows_j, "radix_pass": 4 * rows_j,
         "merge_scan_chunks": 0, "merge_scan": 0},
        2 * n_j)
    ms_grid["k"] = grid_cell(
        "k_sync_unique_2p26", grid_run(grid_k, chunk_k, "off", slab_size),
        n_k, {"GRIDPAIRS": pairs_k, "SORTREUSE": 0},
        {"merge_scan_chunks": slabs_k, "radix_histogram": slabs_k,
         "radix_pass": 4 * slabs_k, "merge_scan": 0}, 2 * n_k)
    ms_grid["k_modulo"] = grid_cell(
        "k_sync_modulo_inner_2p26",
        grid_run(rel_km, chunk_k, "off", slab_size), n_k,
        {"GRIDPAIRS": pairs_k},
        {"merge_scan_chunks": slabs_k, "merge_scan": 0}, 2 * n_k)
    eng_l = HashJoin(JoinConfig(two_level=True, max_retries=0,
                                fallback="chunked"))
    slabs_l = -(-n_main // min(FALLBACK_SLAB, n_main))

    def run_l(meas):
        res = eng_l.join(*rel_l)
        d = res.diagnostics
        if not (res.ok and d["degraded"] == "chunked"
                and "fallback_error" not in d):
            raise AssertionError(f"l_fallback_chunked: {res}")
        return res.matches

    ms_grid["l"] = grid_cell(
        "l_fallback_chunked_zipf_20M", run_l, n_main, {},
        {"merge_scan_chunks": slabs_l, "histogram": None, "partition": 4,
         "radix_histogram": None, "radix_pass": None, "merge_scan": 0},
        2 * n_main)
    ms_grid["m"] = grid_cell(
        "m_pipelined_wide_unique_2p24",
        grid_run(rel_m, chunk_m, "auto"), oracle_m,
        {"GRIDPAIRS": pairs_m, "SORTREUSE": 0},
        {"merge_scan_wide": slabs_m, "radix_histogram": slabs_m,
         "radix_pass": 8 * slabs_m, "merge_scan_chunks": 0,
         "merge_scan": 0}, 2 * n_m)
    if oracle_m != n_m:
        raise AssertionError(f"(m)'s uint64 oracle is {oracle_m}")
    launches = {k: v + launches[k] for k, v in kernels.launch_counts().items()}

    # where the grids' time goes: each stage alone, CUDA events, at (j)'s
    # and (k)'s shapes; "model" multiplies them by their counts in the run
    gen_j = stream_chunks_device(rel_j[1], 0, chunk_j, dev)
    s_j = next(gen_j)
    r_j = next(stream_chunks_device(rel_j[0], 0, chunk_j, dev))
    r_sorted = presort_keys(r_j.key)
    slabs_j = chunk_j // min(chunk_j, slab_size)
    probe_j = chunked._scan_probe_presorted(r_sorted, s_j.key, slabs_j)
    stages = {
        "generation": lambda: next(stream_chunks_device(rel_j[1], 0, chunk_j,
                                                        dev)),
        "presort": lambda: presort_keys(r_j.key),
        "probe": lambda: chunked._scan_probe_presorted(r_sorted, s_j.key,
                                                       slabs_j),
        "bound": lambda: umax(s_j.key),
        "readback": lambda: chunked._resolve(*probe_j),
    }
    stage_ms = {k: time_ms(f, reps=5) for k, f in stages.items()}
    k2_shape("j_presort", [r_j.key], ms=stage_ms["presort"])
    counts = {"generation": rows_j + rows_j * rows_j, "presort": rows_j,
              "probe": rows_j * rows_j, "bound": rows_j + rows_j * rows_j,
              "readback": rows_j * rows_j}
    model = sum(stage_ms[k] * counts[k] for k in stages)
    emit({"phase": "breakdown", "workload": "j_pipelined_unique_grid",
          "stage_ms": stage_ms, "stage_count": counts, "model_ms": model,
          "grid_ms": ms_grid["j"] * 1e3, **card})
    del gen_j, s_j, r_j, r_sorted, probe_j
    slab_s = s_k.key[:slab_size]
    packed_k = _pack(r_k.key, slab_s)
    sorted_k = k2.radix_sort([packed_k])[0]
    per_pair = chunked._scan_probe(r_k.key, s_k.key, chunk_k // slab_size)
    stages = {
        "generation": lambda: next(stream_chunks_device(grid_k[1], 0, chunk_k,
                                                        dev)),
        "pack": lambda: _pack(r_k.key, slab_s),
        "slab_sort": lambda: k2.radix_sort([packed_k]),
        "merge_scan_chunks": lambda: k6.merge_scan_chunks(sorted_k,
                                                          width=w_k),
        "bound": lambda: umax(s_k.key),
        "readback": lambda: chunked._resolve(*per_pair),
    }
    stage_ms = {k: time_ms(f, reps=5) for k, f in stages.items()}
    k2_shape("k_slab_union", [packed_k], ms=stage_ms["slab_sort"])
    rows_k = n_k // chunk_k
    counts = {"generation": rows_k + pairs_k, "pack": slabs_k,
              "slab_sort": slabs_k, "merge_scan_chunks": slabs_k,
              "bound": 2 * rows_k, "readback": pairs_k}
    model = sum(stage_ms[k] * counts[k] for k in stages)
    emit({"phase": "breakdown", "workload": "k_sync_unique_2p26",
          "stage_ms": stage_ms, "stage_count": counts, "model_ms": model,
          "grid_ms": ms_grid["k"] * 1e3, **card})
    del slab_s, packed_k, sorted_k, per_pair, r_k, s_k

    # join time alone, on placed inputs (not counted as the main path)
    def join_ms(eng, r, s, bound=None):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.join_arrays(r, s, key_bound=bound)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times[1:]) * 1e3

    for name, inner_rel, outer_rel, _, _ in workloads:
        r, s = engine.place(inner_rel), engine.place(outer_rel)
        ms = join_ms(engine, r, s,
                     max(inner_rel.key_bound(), outer_rel.key_bound()))
        emit({"phase": "join_time", "workload": name, "join_ms": ms,
              "tuples_per_s": (r.size + s.size) / ms * 1e3, **card})
        if name == "unique_20M":
            # where the join's time goes: each stage alone, CUDA events
            packed = _pack_pm(r.key, s.key, fanout)
            ordered = k2.radix_sort([packed])[0]
            stages = {
                "key_minmax": lambda: (torch.aminmax(r.key),
                                       torch.aminmax(s.key)),
                "pack": lambda: _pack_pm(r.key, s.key, fanout),
                "radix_sort": lambda: k2.radix_sort([packed]),
                "merge_scan": lambda: k3.merge_scan_partitions(
                    ordered, num_partitions=num_p),
                "readback": lambda: torch.zeros(
                    num_p + 5, dtype=torch.int64, device=dev).cpu(),
            }
            emit({"phase": "breakdown", "workload": name,
                  "stage_ms": {k: time_ms(f) for k, f in stages.items()},
                  "join_ms": ms, **card})
            del packed, ordered
        del r, s

    # (d): join time, and its stages alone
    name, cfg, inner_rel, outer_rel, _, _ = partitioned[0]
    eng = HashJoin(cfg)
    r, s = eng.place(inner_rel), eng.place(outer_rel)
    ms = join_ms(eng, r, s)
    emit({"phase": "join_time", "workload": name, "join_ms": ms,
          "tuples_per_s": (r.size + s.size) / ms * 1e3, **card})
    # (d) under the load-aware assignment: exact, and its time beside (d)'s
    eng_la = HashJoin(JoinConfig(probe_algorithm="bucket",
                                 assignment_policy="load_aware"))
    res = eng_la.join_arrays(r, s)
    if res.matches != n_main or not res.ok:
        raise AssertionError(f"{name}, load_aware: {res}")
    ms_la = join_ms(eng_la, r, s)
    emit({"phase": "join_time", "workload": f"{name}_load_aware",
          "join_ms": ms_la, "tuples_per_s": (r.size + s.size) / ms_la * 1e3,
          **card})
    plan = eng._shuffle_plan(r, s)
    cap_r, cap_s, _ = eng._measure_capacities(r, s, plan)
    win_r = Window(eng.world, cap_r, "inner")
    win_s = Window(eng.world, cap_s, "outer")
    rp, sp, *_ = eng._shuffle(r, s, plan, win_r, win_s)
    lcap_r, lcap_s = eng._bucket_caps(cap_r, cap_s, 1)
    lf = cfg.local_fanout_bits

    def local_pass():
        return (local_partition(rp.batch, rp.valid, fanout, lf, lcap_r,
                                "inner"),
                local_partition(sp.batch, sp.valid, fanout, lf, lcap_s,
                                "outer"))

    lr, ls = local_pass()
    rows = (lr.blocks.key.view(n_buckets, lcap_r),
            ls.blocks.key.view(n_buckets, lcap_s))
    sorted_rows = bucket_rows_sort(*rows)
    stages = {
        "key_contract": lambda: eng._keys_in_contract(r, s, False),
        "sizing_histograms": lambda: eng._measure_capacities(
            r, s, eng._shuffle_plan(r, s)),
        "exchange": lambda: eng._shuffle(r, s, plan, win_r, win_s),
        "local_partition": local_pass,
        "row_sort": lambda: bucket_rows_sort(*rows),
        "row_scan": lambda: bucket_rows_count(*sorted_rows),
        "readback": lambda: torch.zeros(
            n_buckets + 7, dtype=torch.int64, device=dev).cpu(),
    }
    emit({"phase": "breakdown", "workload": name,
          "stage_ms": {k: time_ms(f) for k, f in stages.items()},
          "row_sort_elements": sorted_rows[0].numel(),
          "caps": [cap_r, cap_s, lcap_r, lcap_s], "join_ms": ms, **card})
    del sorted_rows
    # K2 alone at the row sort's lanes, as sort_lex_rows_unstable gives
    # them: (row, key, tag), the row index a one-pass key
    nb_d = rows[0].shape[0]
    width_d = rows[0].shape[1] + rows[1].shape[1]
    k2_shape("d_row_sort",
             [torch.arange(nb_d, dtype=torch.int32,
                           device=dev).repeat_interleave(width_d),
              torch.cat(rows, dim=1).reshape(-1),
              torch.cat([torch.zeros_like(rows[0]), torch.ones_like(rows[1])],
                        dim=1).reshape(-1)],
             num_keys=2, key_bounds=(nb_d, None))
    del r, s, plan, rp, sp, lr, ls, rows

    # (g), (h), (i): join time; (h)'s stages alone
    ms = join_ms(eng_g, r_g, s_g)
    emit({"phase": "join_time", "workload": "full_range_zipf_20M",
          "join_ms": ms, "tuples_per_s": 2 * n_main / ms * 1e3, **card})
    del r_g, s_g
    r, s = eng_h.place(rel_h[0]), eng_h.place(rel_h[1])
    for name, eng in (("wide_unique_20M", eng_h),
                      ("bucket_wide_unique_20M", eng_i)):
        ms = join_ms(eng, r, s)
        emit({"phase": "join_time", "workload": name, "join_ms": ms,
              "tuples_per_s": (r.size + s.size) / ms * 1e3, **card})
        if eng is eng_h:
            lanes = wide_union(r, s, fanout)
            ordered = k2.radix_sort(lanes, num_keys=2)
            stages = {
                "rotate_concat": lambda: wide_union(r, s, fanout),
                "radix_sort": lambda: k2.radix_sort(lanes, num_keys=2),
                "merge_scan_wide": lambda: k5.merge_scan_partitions_wide(
                    *ordered, num_partitions=num_p),
                "key_contract": lambda: (umax(r.key_hi), umax(s.key_hi)),
                "readback": lambda: torch.zeros(
                    num_p + 4, dtype=torch.int64, device=dev).cpu(),
            }
            emit({"phase": "breakdown", "workload": name,
                  "stage_ms": {k: time_ms(f) for k, f in stages.items()},
                  "join_ms": ms, **card})
            del lanes, ordered
    del r, s

    # (t): wider fanout and the implementation choice
    torch.cuda.empty_cache()
    launches_t, wide_rows = phase_t(dev, n_main, time_ms, device_us, card)
    launches = {k: v + launches_t[k] for k, v in launches.items()}

    # (n): the generic body on an NCCL group of one rank
    torch.cuda.empty_cache()
    launches_n = phase_n(dev, n_main, {
        "n1": one_rank["bucket_unique_20M"], "n2": one_rank["unique_20M"],
        "n3": one_rank["wide_unique_20M"], "n4": one_rank["unique_20M"]},
        time_ms, device_us, card)
    launches = {k: v + launches[k] for k, v in launches_n.items()}

    # (p): the skew split and the hierarchical exchange on four ranks of
    # one gloo group on this card (the kernels are built above)
    torch.cuda.empty_cache()
    launches_p = phase_p(dev, card)
    launches = {k: v + launches_p.get(k, 0) for k, v in launches.items()}

    # (u): the planner's cost model fitted on this card and its plans run
    torch.cuda.empty_cache()
    launches_u = phase_u(dev, n_main, time_ms, card)
    launches = {k: v + launches_u[k] for k, v in launches.items()}

    # (v): the serve worker's liveness and observability plane
    torch.cuda.empty_cache()
    launches_v, warm_ms = phase_v(dev, n_main, card)
    launches = {k: v + launches_v[k] for k, v in launches.items()}

    # (w): the crash-only fleet, its workers serving on this card
    torch.cuda.empty_cache()
    launches_w = phase_w(dev, n_main, card, warm_ms)
    launches = {k: v + launches_w[k] for k, v in launches.items()}

    # (x): the host-fed stream, the device-init fallback, the manifest
    # and the critical path
    torch.cuda.empty_cache()
    launches_x = phase_x(dev, n_main, card)
    launches = {k: v + launches_x[k] for k, v in launches.items()}

    # (y): membership, recovery, stragglers and chaos over several ranks
    torch.cuda.empty_cache()
    launches_y = phase_y(dev, n_main, card)
    launches = {k: v + launches_y[k] for k, v in launches.items()}

    # (z): the sync guard around the main paths, and the command-line tools
    torch.cuda.empty_cache()
    launches_z = phase_z(dev, n_main, card)
    launches = {k: v + launches_z[k] for k, v in launches.items()}

    # (aa): C10's repairs under the guard, and the evidence tools
    torch.cuda.empty_cache()
    launches_aa = phase_aa(dev, n_main, card)
    launches = {k: v + launches_aa[k] for k, v in launches.items()}

    sources = {
        "histogram": ("tpu_radix_join_torch/csrc/histogram.cu",
                      "tpu_radix_join/ops/pallas/histogram.py:60",
                      "histogram"),
        "radix_sort": ("tpu_radix_join_torch/csrc/radix_sort.cu",
                       "tpu_radix_join/ops/pallas/radix_sort.py:162",
                       "radix_pass"),
        "merge_scan": ("tpu_radix_join_torch/csrc/merge_scan.cu",
                       "tpu_radix_join/ops/pallas/merge_scan.py:187",
                       "merge_scan"),
        "partition": ("tpu_radix_join_torch/csrc/partition.cu",
                      "tpu_radix_join/ops/pallas/partition.py:150",
                      "partition"),
        "merge_scan_wide": ("tpu_radix_join_torch/csrc/merge_scan_wide.cu",
                            "tpu_radix_join/ops/pallas/merge_scan.py:313",
                            "merge_scan_wide"),
        "merge_scan_chunks": ("tpu_radix_join_torch/csrc/merge_scan_chunks.cu",
                              "tpu_radix_join/ops/pallas/merge_scan.py:356",
                              "merge_scan_chunks"),
    }
    emit({"phase": "kernel_shapes", "kernel": "radix_sort",
          "shapes": k2_shapes, **card})
    results["radix_sort"]["shapes"] = k2_shapes
    results["radix_sort"]["histogram_launches"] = launches["radix_histogram"]
    # the wide paths of K1, K3, K5 and K4 (phase (t)), each at its
    # representative shape, counted under its own name (K4's MSD passes at
    # 16,385 groups, K1's range tables at 2**14 bins)
    wide_sources = {
        "histogram_wide": sources["histogram"][:2],
        "merge_scan_fanout": (
            "tpu_radix_join_torch/csrc/merge_scan_partitions.cuh",
            sources["merge_scan"][1]),
        "merge_scan_wide_fanout": (
            "tpu_radix_join_torch/csrc/merge_scan_partitions.cuh",
            sources["merge_scan_wide"][1]),
        "partition_wide": ("tpu_radix_join_torch/csrc/partition_wide.cu",
                           sources["partition"][1]),
        "partition_msd": ("tpu_radix_join_torch/csrc/partition_msd.cu",
                          sources["partition"][1]),
    }
    for name, (src, replaces) in wide_sources.items():
        results[name] = wide_rows[name]
        sources[name] = (src, replaces, name)
    table = []
    for name, (src, replaces, counter) in sources.items():
        r = results[name]
        table.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[counter],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": "bytes", "library_ms": r["library_ms"],
                     **{k: r[k] for k in ("shapes", "histogram_launches")
                        if k in r}})
    print(smi, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1] == AA_GLOO_FLAG:
        # one rank of (aa2)'s gloo control, started by phase_aa
        sys.exit(aa_gloo_rank())
    if len(sys.argv) > 1 and sys.argv[1] == Y_CLI_FLAG:
        # one command-line rank of phase (y), started by phase_y
        sys.exit(y_cli_rank(sys.argv[2:]))
    if len(sys.argv) == 6 and sys.argv[1] == Y_RANK_FLAG:
        # one rank of (y6), started by phase_y: its result on stdout
        print(json.dumps(y_soak_rank(int(sys.argv[2]), int(sys.argv[3]),
                                     sys.argv[4], json.loads(sys.argv[5]))),
              flush=True)
        sys.exit(0)
    if len(sys.argv) == 6 and sys.argv[1] == P_RANK_FLAG:
        # one rank of phase (p), started by phase_p: its result on stdout
        print(json.dumps(phase_p_rank(int(sys.argv[2]), int(sys.argv[3]),
                                      sys.argv[4], json.loads(sys.argv[5]))),
              flush=True)
        sys.exit(0)
    sys.exit(main())
