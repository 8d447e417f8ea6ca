"""The join engine, on one GPU or over a process group of N ranks.

Counterpart of ``tpu_radix_join/operators/hash_join.py`` (``_pipeline_fn``,
``_shuffle``, ``_local_process``, ``_join_arrays_inner``, ``join``,
``join_arrays``, ``join_arrays_pipelined``, ``place``, ``_finish_join``,
``_materialize_fn``, ``join_materialize_arrays``, ``join_materialize``).
The world
(parallel/world.py) is a ``OneRankWorld`` by default, or a ``DistWorld``
over the ``torch.distributed`` group the caller passes: every rank runs the
same program on its own shard and returns the same result.

**Sort probe at one rank** (the default; ``_pipeline_fn``'s ``n == 1 and
sort_probe`` specialization): the shuffle is an identity, so the join is

  1. the discipline (``_resolve_key_range``): "wide" for 64-bit keys, else
     ``key_range``'s "narrow" or "full";
  2. the sort of the union (K2, the LSD radix sort): narrow packs both key
     lanes partition-major into one lane (ops/merge_count._pack_pm); full
     sorts the pid-rotated keys, wide the (rotated lo, hi) pairs, with the
     side tag riding;
  3. the fused merge-scan probe, K3 on the packed lane or K5 on the wide
     order: per-partition uint32 counts and the largest single weight;
  4. the uint32 overflow-risk guard, which runs the partition histogram
     (K1) only when the one scalar readback says a count might wrap;
  5. a host uint64 sum of the per-partition counts.

**The generic body** (``_pipeline_fn``'s shuffle path: every world larger
than one rank, and the partitioned join ``probe_algorithm="bucket"`` or
``two_level`` at any size; :meth:`HashJoin.join_shuffled` runs it at one
rank too):

  1. window sizing: the local histograms (K1), their ``all_reduce``, the
     assignment, and each relation's worst per-destination demand over all
     ranks (``all_reduce`` max) rounded up to a power of two (or the
     ``allocation_factor`` estimate, ``window_sizing="static"``); computed
     once a join and shared by every attempt.  With ``skew_threshold``
     over more than one rank, hot partitions found in the global
     histograms take the skew split (operators/skew.py), sized by a
     second pass;
  2. the exchange (``_shuffle``): ``network_partition`` into one block per
     rank (K4), an ``all_to_all`` of every lane and of the counts (two
     stages with ``num_hosts > 1``), or under the wire plan
     (``_resolve_exchange_plan``: ``exchange_codec``, ``exchange_stages``)
     a grouped K4 scatter by (rank, partition), the bit-packed words in one
     ``all_to_all`` whose headers carry the counts, and the unpack; each
     collective in k column groups when staged.  Then the conservation
     check, and with
     ``debug_checks`` the per-partition check (K1 on the receive buffers)
     and the OffsetMap invariant; under the split the hot inner tuples
     are extracted (K4) and gathered to every rank, and the hot outer
     tuples spread over the ranks;
  3. local processing on the ``N * cap`` pad-filled receive buffers (and
     the replicated hot inner side): the
     sort probe (K2 then K3, or K5 for full-range and 64-bit keys), the
     chunked probe with ``chunk_size`` (the inner buffer sorted once on K2
     and the outer one streamed in slabs; 64-bit keys: K2 and K5 a slab),
     or the second radix pass into buckets (K4), the row sort of every
     bucket (K2) and the merge-weight scan;
  4. the 7-entry flag vector, summed over the ranks in one ``all_reduce``,
     and the per-partition (or per-bucket) counts gathered in rank order
     into ``[N * P]``, read back together; a capacity shortfall reruns the
     attempt on every rank with only the shape that fell short doubled
     (after the ``retry_backoff_s`` pause), up to ``max_retries`` times;
     with ``fallback="chunked"`` a shortfall that outlasts them degrades
     to the out-of-core count (``_fallback_chunked``).

**The materializing join** (:meth:`HashJoin.join_materialize`, the
reference's ``probe_match_rate``): the generic body at every world size,
one rank included, with the materializing probe (``ops/build_probe.
probe_materialize``, or ``probe_materialize_chunked`` with ``chunk_size``)
on the receive buffers, the replicated hot inner side joining the inner
buffer under the skew split.  Its six flags are the counting ones without
the count-overflow risk; ``local_overflow`` counts the outer tuples with
more than ``match_rate_cap`` matches, and a retry doubles the cap.  After
the last attempt the valid pairs are compacted on the device and only
they are read back; over several ranks they are gathered rank-major, so
every rank returns every pair.

**Pipelined repeats** (``join_arrays(..., repeats=k)``): sized once, then
k attempts with no readback between them and one readback of the last
attempt's flags and counts; no retry loop, and the counters grow by k.

**Integrity verification** (``verify="check"`` or ``"repair"``, every path
but the one-rank sort probe, which exchanges nothing): the pristine
inputs' per-partition fingerprints (robustness/verify.py; VCHK) before the
exchange, those of the received lanes after it and, on the bucket path
without a skew plan, of the second radix pass's blocks, read back with the
attempt's flags; then the cross-product bound of the counts on the sort
and chunked paths.  A damaged partition fails the join
(``data_corruption``), or under "repair" is recomputed from the pristine
inputs on a 1 x 1 out-of-core grid (the whole join on the bucket path or
when only the bound failed).  The fault site ``exchange.corrupt_lane``
flips bit 30 of rank 0's first outer key before the exchange, whatever the
verify mode.

Every rank issues the same collectives in the same order: each host
decision that precedes a collective reads an all-reduced value or the
configuration.

**Serving hooks** (the join service, service/session.py): ``plan_cache``
(a ``planner.PlanCache``) stores a successful join's converged capacities
under its global shapes and config, and a later join of those shapes
takes them instead of the sizing pass (no JHIST; ``_cache_eligible``: not
the one-rank sort probe, static sizing or a skew split; over several ranks
the warm verdict and the capacities are all-reduced).  ``cancel``, a
callable of the phase name, is consulted at the boundaries "start" (before
JTOTAL), "sized", "probe" (each attempt) and "stalled" (the fault site
``backend.stall`` spins there) and raises to cancel the join; JTOTAL is
closed on the way out.  ``partition_manifest`` (robustness/checkpoint.
PartitionManifest) takes one line a realized partition after each
successful ``join_arrays`` (``_manifest_record``).  Construction consults
the fault site ``engine.device_init`` first (robustness/degrade.py's
fallback).

**Elastic recovery** (``elastic``, ``elastic_grow``, ``hedge``; JAX
``hash_join.py:1731-1761``, ``:1969-2460``): every boundary also consults
the sites ``membership.rank_death`` and ``membership.rank_join``, beats
this rank's lease and scans the membership view (admissions, then lapses),
and polls the straggler detector when hedging; ``compute.straggle`` fires
after the stall site.  A lost rank (a lapse, the death site, or a
transport error a lapsed lease confirms within one lapse window) ends the
join in :meth:`HashJoin._recover_join`: the relations regenerated on the
host, the partitions the manifest lacks assigned over the survivors and
each recomputed as a masked out-of-core grid (K2 and K6 on the card), with
no collective on the old group.  An admission under ``elastic_grow``
(:meth:`HashJoin._regrow_join`) and a straggler verdict
(:meth:`HashJoin._hedge_join`) finish on the same engine.  A JAX process
owns several mesh nodes and a port process is one, so the expansions from
lease ranks to node ranks are the identity over the port's world
(:meth:`HashJoin._npp`).

**Measurements** (``HashJoin(..., measurements=Measurements())``; timer
placement of ``hash_join.py:1780-1935``): JTOTAL spans the join, the
key-range probe included; SWINALLOC the sizing pass, whose execution is
JHIST (``meta["key_range"]`` records the 32-bit sort probe's route); JPROC
the attempt.  Each timer stops at a host readback the join already does —
the sizing readback ends JHIST and SWINALLOC, the flags and counts readback
JPROC and JTOTAL — so a registry adds no synchronisation.  With
``measure_phases`` the attempt is fenced into JMPI (SNETCOMPL nested) for
the shuffle, SLOCPREP and BPBUILD / BPPROBE inside JPROC on the bucket
path, and JPROC for the local probe.  A superseded attempt's phase times
move to MWINWAIT and RETRIES counts it.  A first-use kernel build is
JCOMPILE, excluded from the running timers.  The epilogue counts RESULTS,
RTUPLES and STUPLES (global sizes), the exchange under the wire plan
(``record_exchange``: WIREBYTES, PACKRATIO, XSTAGES and
``meta["exchange_plan"]``; none on the one-rank sort probe, which exchanges
nothing, or after a repair) and the rates; verification adds VCHK, VCHKN,
VFAIL and VREPAIR and the events ``data_corruption`` and ``repair``.
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_radix_join_torch.core.config import JoinConfig
from tpu_radix_join_torch.core.device import resolve_device
from tpu_radix_join_torch.data.relation import Relation
from tpu_radix_join_torch.data.tuples import (R_PAD_KEY, CompressedBatch,
                                              TupleBatch, _sentinel_lane,
                                              lane_from_numpy, lane_to_numpy,
                                              make_wire_spec, partition_ids,
                                              umax, valid_mask, widen)
from tpu_radix_join_torch.histograms import (compute_global_histogram,
                                             compute_local_histogram,
                                             compute_offsets,
                                             compute_partition_assignment)
from tpu_radix_join_torch.operators.local_partitioning import local_partition
from tpu_radix_join_torch.operators.skew import (detect_hot_partitions,
                                                 hot_mask_bits, is_hot,
                                                 mask_hot,
                                                 spread_destinations)
from tpu_radix_join_torch.ops.build_probe import (DENSE_BUCKET_LIMIT,
                                                  MaterializedMatches,
                                                  probe_count_bucketized,
                                                  probe_count_chunked,
                                                  probe_materialize,
                                                  probe_materialize_chunked)
from tpu_radix_join_torch.ops.chunked import (chunked_join_count,
                                              chunked_join_grid)
from tpu_radix_join_torch.ops.kernels import _build, launch_counts
from tpu_radix_join_torch.ops.merge_count import (
    MAX_MERGE_KEY, merge_count_per_partition, merge_count_per_partition_full,
    merge_count_wide_per_partition)
from tpu_radix_join_torch.ops.radix import local_histogram, scatter_to_blocks
from tpu_radix_join_torch.parallel import multihost
from tpu_radix_join_torch.parallel.network_partitioning import (
    network_partition, receive_checksums)
from tpu_radix_join_torch.parallel.window import Window, parse_exchange_mode
from tpu_radix_join_torch.parallel.world import make_world
from tpu_radix_join_torch.performance.measurements import (
    BACKOFFMS, BPBUILD, BPBUILDTUPLES, BPPROBE, BPPROBETUPLES, HEDGED,
    HEDGEWIN, JCOMPILE, JHIST, JMPI, JPROC, JTOTAL, MEPOCH, MWINWAIT,
    PACKRATIO, RANKLOST, RESULTS, RETRIES, RETRYN, RTUPLES, SLOCPREP,
    SNETCOMPL, SPECWASTE, STUPLES, SWINALLOC, VCHK, VCHKN, VFAIL, VREPAIR,
    XSTAGES)
from tpu_radix_join_torch.robustness import faults
from tpu_radix_join_torch.robustness.membership import (LeaseBoard,
                                                        RankJoined, RankLost,
                                                        StaleEpoch)
from tpu_radix_join_torch.robustness.straggler import (StragglerDetected,
                                                       StragglerDetector,
                                                       board_progress,
                                                       score_hedge)
from tpu_radix_join_torch.robustness.retry import (CAPACITY_OVERFLOW,
                                                   RETRIES_EXHAUSTED,
                                                   RetryPolicy,
                                                   classify_diagnostics)
from tpu_radix_join_torch.robustness.verify import (
    checksum_rows, cross_check_counts, damaged_partitions,
    global_partition_checksums)

#: slab of the chunked fallback's count (the JAX package's)
FALLBACK_SLAB = 1 << 20


class JoinResult(NamedTuple):
    matches: int                  # exact match count (host uint64 sum)
    ok: bool                      # no flag raised
    partition_counts: np.ndarray  # uint32 [N * P] per-rank per-partition (or
                                  # bucket) counts, in rank order
    diagnostics: Optional[dict] = None   # failure breakdown (_flags_to_diag)
    retries: int = 0              # capacity retries the join took


class MaterializedJoinResult(NamedTuple):
    """The matching rid pairs of a join, every rank's, rank-major."""
    r_rid: np.ndarray             # uint32 [matches]
    s_rid: np.ndarray             # uint32 [matches]
    matches: int
    ok: bool                      # no flag raised (the match cap included)
    diagnostics: Optional[dict] = None
    retries: int = 0              # capacity retries the join took


class ShufflePlan(NamedTuple):
    r_hist: torch.Tensor          # int32 [P]: this rank's R histogram
    s_hist: torch.Tensor          # int32 [P]: this rank's S histogram
    r_ghist: torch.Tensor         # int32 [P]: R summed over the ranks
    s_ghist: torch.Tensor         # int32 [P]: S summed over the ranks
    assignment: torch.Tensor      # int32 [P]: partition -> owner rank


class SkewPlan(NamedTuple):
    """The skew split of a join (``skew_plan`` of ``hash_join.py:449-490``):
    the hot set, the per-rank slots of the hot inner block, and the shuffle
    plan whose assignment is computed from the globals with the hot
    partitions masked (its histograms are the unmasked ones)."""
    hot_bits: int                 # uint32 mask of the hot partitions
    hot_cap: int                  # slots of each rank's hot inner block
    plan: ShufflePlan


class Shuffled(NamedTuple):
    """What one exchange leaves on this rank (``_shuffle``'s outputs)."""
    rp: object                    # NetworkPartitionResult of R
    sp: object                    # NetworkPartitionResult of S
    lost_r: torch.Tensor          # 0-d int64: R tuples dropped, all ranks
    lost_s: torch.Tensor          # 0-d int64: S tuples dropped, all ranks
    bad: torch.Tensor             # 0-d int64: this rank's violations, 0-2
    hot_batch: Optional[TupleBatch] = None   # the replicated hot inner side
    hot_overflow: Optional[torch.Tensor] = None  # 0-d int64, all ranks


def _as_compressed(batch: TupleBatch) -> CompressedBatch:
    """Identity-compression view (``hash_join.py:160``): the chunked probe
    compares whole keys, safe across the receive buffer's mixed
    partitions."""
    return CompressedBatch(key_rem=batch.key, rid=batch.rid,
                           key_rem_hi=batch.key_hi)


def _minmax_i32(lane: torch.Tensor) -> torch.Tensor:
    """int64 [2]: (min, max) of an int32 lane as signed values; a uint32
    lane lies below 2**31 exactly when its signed min is non-negative."""
    if lane.numel() == 0:
        return torch.tensor([0, 0], dtype=torch.int64, device=lane.device)
    lo, hi = torch.aminmax(lane)
    return torch.stack([lo, hi]).to(torch.int64)


class HashJoin:
    """The join engine; ``device`` is "cuda" unless the caller asks for
    "cpu", where every kernel takes its plain PyTorch version.

    ``group`` is the ``torch.distributed`` process group of a join over
    ``config.num_nodes`` ranks (``parallel/multihost.initialize`` starts
    one; ``torch.distributed.group.WORLD`` names it): NCCL for a CUDA
    device, gloo for the CPU, or gloo on a CUDA device when
    ``initialize(device="cuda", backend="gloo")`` started it so.  Without a
    group the world is one rank, and ``num_nodes > 1`` raises, as does a
    group of another size.  ``config.num_hosts > 1`` gives the world the
    hierarchical exchange.

    ``measurements``, a ``performance.measurements.Measurements``, records
    every join's timers and counters (see the module docstring); its
    ``gather_all(engine.world)`` collects every rank's.  ``plan_cache``
    (a ``planner.PlanCache``) warm-starts the sizing pass, and ``cancel``
    is the cooperative cancellation hook (:meth:`_check_cancel`)."""

    #: phase keys nested inside another recorded phase (SNETCOMPL in JMPI;
    #: BPBUILD/BPPROBE in JPROC): rolled back from their own columns on a
    #: superseded attempt but not added to MWINWAIT twice
    _NESTED_PHASES = frozenset({SNETCOMPL, BPBUILD, BPPROBE})

    def __init__(self, config: Optional[JoinConfig] = None, device="cuda",
                 group=None, measurements=None, plan_cache=None):
        # the injectable card-unavailable site (hash_join.py:180): lets
        # the tests drive the construction fallback of
        # robustness/degrade.py without a dead card
        faults.check(faults.DEVICE_INIT, measurements)
        self.config = config if config is not None else JoinConfig()
        self.measurements = measurements
        #: planner.PlanCache or None: a warm join takes the converged
        #: capacities of an earlier join of its shapes instead of the
        #: sizing pass, and a successful join stores its own
        self.plan_cache = plan_cache
        #: the cooperative cancellation hook: an optional ``callable(phase:
        #: str)`` consulted at the join's phase boundaries ("start",
        #: "sized", "stalled", "probe"), which raises to cancel the join
        #: between launches (service/deadline.py).  Over several ranks it
        #: must decide the same on every rank (the session's deadlines
        #: read rank 0's clock)
        self.cancel = None
        #: elastic recovery (robustness/membership.py, recovery.py,
        #: straggler.py), wired like ``cancel``: runtime services, not
        #: configuration.  ``partition_manifest`` (robustness/checkpoint.
        #: PartitionManifest) takes every realized partition of a
        #: successful join, or None; ``membership`` (a MembershipView) is
        #: scanned at every phase boundary and stamps the lines' epoch;
        #: ``elastic`` makes ``join_arrays`` finish a join that lost a rank
        #: on the survivors (:meth:`_recover_join`); ``elastic_grow``
        #: finishes one on a grown membership instead of raising
        #: RankJoined; ``hedge`` ("off" | "on" | "auto") hedges a
        #: straggler at ``hedge_threshold``; ``straggle_factor`` x
        #: ``straggle_unit_s`` seconds is the ``compute.straggle`` site's
        #: slowdown
        self.partition_manifest = None
        self.membership = None
        self.elastic = False
        self.elastic_grow = False
        self.hedge = "off"
        self.hedge_threshold = 0.5
        self.straggle_factor = 0.0
        self.straggle_unit_s = float(
            os.environ.get("TPU_RJ_STRAGGLE_UNIT_S", "0.05"))
        self._straggler_detector = None
        #: a zero-argument callable returning the global host lanes
        #: ``(r_keys, r_hi, s_keys, s_hi)`` (uint32 numpy, hi None for
        #: 32-bit keys) a recovery recomputes from; ``join`` sets it to
        #: its Relation specs (``recovery.relation_inputs``)
        self.elastic_inputs = None
        #: the last recovery's record, or None: its kind ("recovery",
        #: "regrow", "hedge"), rank and matches, when the loss was detected
        #: (``detected_t``, ``time.time``), the wall times of the host
        #: regeneration, the recompute and the whole (``regen_s``,
        #: ``recompute_s``, ``total_s``) and the kernel launches it made
        self.last_recovery = None
        self.device = resolve_device(device)
        self.world = make_world(self.config.num_nodes, group,
                                self.config.num_hosts)
        #: the key bound the sizing pass measured (set when a packed
        #: exchange may read it), and the join's resolved wire plan
        #: ``(codec, mode, key_bound, rid_bound_r, rid_bound_s)``
        self._measured_key_bound: Optional[int] = None
        self._xplan = ("off", 1, None, None, None)
        if group is not None:
            cuda = self.device.type == "cuda"
            want = "nccl" if cuda else "gloo"
            named = (cuda and self.world.backend == "gloo"
                     and multihost.gloo_on_card())
            if self.world.backend != want and not named:
                raise ValueError(
                    f"a join on {self.device.type} runs over a {want} "
                    f"process group, not {self.world.backend} (gloo on a "
                    "card only when multihost.initialize(device='cuda', "
                    "backend='gloo') started it)")

    # ------------------------------------------------------------- checks
    def _check_batches(self, r: TupleBatch, s: TupleBatch) -> None:
        self._check_key_width(r, s)
        for name, b in (("inner", r), ("outer", s)):
            lanes = [b.key, b.rid] + ([] if b.key_hi is None else [b.key_hi])
            for lane in lanes:
                if lane.dtype != torch.int32 or lane.dim() != 1:
                    raise ValueError(
                        f"{name} lanes must be 1-D int32 (uint32 bits), got "
                        f"{lane.dtype} rank {lane.dim()}")
                if lane.device != self.device:
                    raise ValueError(
                        f"{name} lanes live on {lane.device}, the engine "
                        f"on {self.device}")
                if lane.shape != b.key.shape:
                    raise ValueError(f"{name} lanes differ in length")
        if r.size + s.size >= 1 << 31:
            raise ValueError("the joins count positions in 32 bits: "
                             "|R| + |S| must stay below 2**31")

    def _check_key_width(self, r: TupleBatch, s: TupleBatch) -> None:
        """``config.key_bits`` must match the lanes the batches carry: a
        64-bit config joining lo-lane-only batches (or the reverse) would
        run a join on truncated keys and report ok."""
        for name, b in (("inner", r), ("outer", s)):
            wide = b.key_hi is not None
            if wide != (self.config.key_bits == 64):
                raise ValueError(
                    f"config.key_bits={self.config.key_bits} but the {name} "
                    f"batch {'carries' if wide else 'lacks'} a key_hi lane; "
                    f"refusing to run a silently-truncated join")

    def _resolve_key_range(self, r: TupleBatch, s: TupleBatch,
                           key_bound: Optional[int]) -> str:
        """The sort probe's discipline for this join: "wide" for 64-bit
        keys; else ``key_range`` — "narrow" (the packed 31-bit probe) or
        "full" as set, and "auto" from the relations' static key bound when
        one is known, else from the device max of both key lanes over every
        rank (one ``all_reduce`` and one readback).  ``key_bound`` must be
        the same on every rank."""
        cfg = self.config
        if r.key_hi is not None:
            return "wide"
        if cfg.key_range != "auto":
            return cfg.key_range
        if key_bound is not None:
            full = key_bound - 1 > MAX_MERGE_KEY
        else:
            full = int(self.world.all_reduce(
                torch.maximum(umax(r.key), umax(s.key)), op="max")
            ) > MAX_MERGE_KEY
        return "full" if full else "narrow"

    @staticmethod
    def _count_risk(max_weight: int, s_hist: np.ndarray) -> bool:
        """True when some partition's uint32 match count could have wrapped:
        count_p <= max_weight * outer_p, so ``outer_p > (2**32 - 1) //
        max_weight`` flags every count that might reach 2**32."""
        limit = 0xFFFFFFFF // max(max_weight, 1)
        return bool((s_hist.astype(np.uint64) > limit).any())

    @staticmethod
    def _flags_to_diag(flags: np.ndarray) -> dict:
        """Failure breakdown from the 7-entry flag vector (the JAX
        package's layout; ``hot_overflow`` is the skew split's hot inner
        tuples that did not fit ``hot_cap``).  Each entry is summed over
        the ranks."""
        diag = {
            "key_contract_violations": int(flags[0]),
            "shuffle_overflow_r_tuples": int(flags[1]),
            "shuffle_overflow_s_tuples": int(flags[2]),
            "conservation_violations": int(flags[3]),
            "local_overflow": int(flags[4]),
            "hot_overflow": int(flags[5]),
            "count_overflow_risk": int(flags[6]) if len(flags) > 6 else 0,
        }
        diag["failure_class"] = classify_diagnostics(diag)
        return diag

    def _stamp(self, diag: dict) -> dict:
        """The result's stamps: the active fault injector's per-site hits
        and fires in ``diagnostics["fault_sites"]`` (no injector, no key),
        and the library baseline arms the config asked for by name in
        ``diagnostics["baseline_arms"]`` (``{"sort_impl": "xla",
        "partition_impl": "sort"}`` or a part of it; a join on the kernels
        alone has no key), so a baseline run never passes for a kernel
        run."""
        inj = faults.active()
        if inj is not None:
            diag["fault_sites"] = inj.site_stats()
        cfg = self.config
        arms = {name: arm for name, arm in (("sort_impl", cfg.sort_impl),
                                            ("partition_impl",
                                             cfg.partition_impl))
                if arm in ("xla", "sort")}
        if arms:
            diag["baseline_arms"] = arms
        return diag

    def _inject_shuffle_fault(self, flags: np.ndarray) -> np.ndarray:
        """Fault site ``engine.shuffle_overflow`` (``_inject_shuffle_fault``,
        hash_join.py:1494-1502): when it fires, one outer shortfall more is
        reported, so the retry loop runs under test control."""
        if faults.fires(faults.SHUFFLE_OVERFLOW, self.measurements):
            flags = flags.copy()
            flags[2] += 1
        return flags

    @staticmethod
    def _retryable(diag: dict) -> bool:
        """Capacity shortfalls are fixable with bigger shapes; key,
        conservation and count-overflow flags are not (classify_diagnostics
        ranks them first, so one in the same attempt is never retried)."""
        return diag["failure_class"] == CAPACITY_OVERFLOW

    # ------------------------------------------------------------- joins
    def join_arrays(self, r: TupleBatch, s: TupleBatch,
                    key_bound: Optional[int] = None,
                    repeats: int = 1) -> JoinResult:
        """Join two placed batches (lanes on the engine's device): over a
        process group, this rank's shards.  ``key_bound``, when known, is
        an exclusive bound on both relations' keys, the same on every rank;
        with ``key_range="auto"`` it spares the sort probe the device
        max-key probe (:meth:`join` passes the relations' static bounds).
        The partitioned join takes every key below the pads and needs no
        bound.  One rank's sort probe skips the shuffle; everything else
        runs the generic body.

        ``repeats > 1`` runs that many joins of the same batches as one
        (``_join_arrays_inner``'s pipelined mode, hash_join.py:1879-1905):
        the key range and the sizing once, then ``repeats`` attempts with
        no readback between them, and one readback of the last attempt's
        flags and counts.  There is no retry loop (every attempt has the
        same shapes and flags), and ``measure_phases``, which fences every
        phase, raises.  RESULTS, RTUPLES, STUPLES and the exchange counters
        grow by ``repeats``.

        With ``elastic`` set, a rank lost mid-join (the
        ``membership.rank_death`` site, a lapsed lease found at a phase
        boundary, a stale epoch, or a transport error a lapsed lease
        explains) is absorbed: the join finishes on the survivors through
        partition-level recompute (:meth:`_recover_join`), with no
        collective on the old group.  Under ``elastic_grow`` an admission
        finishes it on the grown membership (:meth:`_regrow_join`), and
        with ``hedge`` a straggler's partitions are recomputed beside it
        (:meth:`_hedge_join`).  A successful join records its partitions
        in ``partition_manifest`` when one is attached."""
        if repeats < 1:
            raise ValueError("repeats must be >= 1")
        if repeats > 1 and self.config.measure_phases:
            raise ValueError(
                "pipelined repeats dispatch without intermediate fences; "
                "the measure_phases split timers need a fence per program "
                "— loop synchronous joins instead")
        self._check_batches(r, s)
        if not self.elastic and self.partition_manifest is None:
            return self._join_arrays_inner(r, s, key_bound, repeats)
        mv = self.membership
        if (mv is not None and self.partition_manifest is not None
                and mv.board.progress_of is None):
            # every lease beat carries this rank's manifest progress
            mv.board.progress_of = self._my_partitions_done
        try:
            result = self._join_arrays_inner(r, s, key_bound, repeats)
        except BaseException as e:     # noqa: BLE001 — triaged below
            if not self.elastic:
                raise
            if isinstance(e, StragglerDetected):
                return self._hedge_join(r, s, e, repeats, key_bound)
            if isinstance(e, RankJoined):
                return self._regrow_join(r, s, e, repeats, key_bound)
            exc = self._as_rank_lost(e)
            if exc is None:
                raise
            return self._recover_join(r, s, exc, repeats, key_bound)
        self._manifest_record(result)
        return result

    def _join_arrays_inner(self, r: TupleBatch, s: TupleBatch,
                           key_bound: Optional[int], repeats: int
                           ) -> JoinResult:
        """:meth:`join_arrays`' body; the wrapper owns rank-loss recovery,
        growth, hedging and the manifest."""
        self._check_cancel("start")
        with self._measured():
            if self.config.sort_probe and self.world.size == 1:
                return self._sort_probe_join(r, s, key_bound, repeats)
            return self._shuffled_join(r, s, key_bound, repeats)

    def _membership_epoch(self) -> int:
        """The membership epoch (0 without a view)."""
        return self.membership.epoch if self.membership is not None else 0

    def _manifest_record(self, result: JoinResult) -> None:
        """Record a successful join's realized partitions in the attached
        manifest (``_manifest_record``, hash_join.py:2470-2495), after the
        counts are on the host: each partition's uint64 sum over the ranks
        of its uint32 counts, owned by node stripe (``p % N``: forensic
        metadata, not the assignment map), at the membership epoch.  No
        manifest, a failed join, a recovered one (:func:`~..robustness.
        recovery.execute_recovery` wrote its lines) or counts that are not
        ``[N * P]`` (the chunked fallback's one total) record nothing."""
        mf = self.partition_manifest
        if mf is None or result is None or not result.ok:
            return
        if (result.diagnostics or {}).get("recovered"):
            return
        num_p = self.config.network_partition_count
        counts = np.asarray(result.partition_counts)
        if counts.size < num_p or counts.size % num_p:
            return
        per_p = counts.astype(np.uint64).reshape(-1, num_p).sum(axis=0)
        n = self.config.num_nodes
        mf.mark_many({int(p): int(c) for p, c in enumerate(per_p)},
                     owner_of=lambda p: p % n,
                     epoch=self._membership_epoch())

    def _my_partitions_done(self) -> int:
        """This rank's manifest progress, the partitions realized by the
        nodes it owns (``_my_partitions_done``, hash_join.py:2086-2098),
        every partition when it recovers for all: the progress clock every
        lease beat exports; -1 without a manifest."""
        mf = self.partition_manifest
        if mf is None:
            return -1
        done = mf.completed()
        scope = self._recovery_scope()
        if scope is None:
            return len(done)
        sc = set(scope)
        return sum(1 for rec in done.values() if rec["owner"] in sc)

    def join_arrays_pipelined(self, r: TupleBatch, s: TupleBatch,
                              repeats: int,
                              key_bound: Optional[int] = None) -> JoinResult:
        """:meth:`join_arrays` with ``repeats`` (the JAX package's name for
        the amortized mode)."""
        return self.join_arrays(r, s, key_bound=key_bound, repeats=repeats)

    def join_materialize_arrays(self, r: TupleBatch, s: TupleBatch
                                ) -> MaterializedJoinResult:
        """The join's matching (r_rid, s_rid) pairs instead of their count
        (``join_materialize_arrays``, hash_join.py:2737-2823): the generic
        body at every world size with the materializing probe, up to
        ``match_rate_cap`` pairs an outer tuple.  A capacity shortfall
        doubles what fell short (``cap_r``, ``cap_s``, the skew split's
        ``hot_cap``, or the match cap on ``local_overflow``) and reruns the
        attempt, up to ``max_retries`` times; the JAX loop does not back
        off here, nor does this one.  Every key must lie below the pads
        (no 31-bit packing: the probe compares whole keys)."""
        self._check_batches(r, s)
        self._check_cancel("start")
        with self._measured():
            return self._materialize_join(r, s)

    def join_shuffled(self, r: TupleBatch, s: TupleBatch,
                      key_bound: Optional[int] = None) -> JoinResult:
        """The generic body whatever the world's size: at one rank the sort
        probe then runs on the exchange's pad-filled receive buffers, as a
        rank of an N-rank world does, instead of on the relations."""
        self._check_batches(r, s)
        self._check_cancel("start")
        with self._measured():
            return self._shuffled_join(r, s, key_bound)

    # ----------------------------------------------------- measurements
    @contextlib.contextmanager
    def _measured(self):
        """A join under the registry: JTOTAL runs, and a first-use kernel
        build is recorded as JCOMPILE and excluded from the running timers
        (``_compile_timed``, hash_join.py:493-512).  A join that raises
        still closes its JTOTAL."""
        m = self.measurements
        if m is None:
            yield
            return

        def compiled(name: str, seconds: float) -> None:
            us = seconds * 1e6
            m.add_time_us(JCOMPILE, us)
            m.exclude_from_running(us)

        with _build.on_build(compiled):
            m.start(JTOTAL)
            try:
                yield
            finally:
                if JTOTAL in m._starts:
                    m.stop(JTOTAL)

    # ------------------------------------------------- exchange wire plan
    def _resolve_exchange_plan(self, r: TupleBatch, s: TupleBatch,
                               key_bound: Optional[int]):
        """The join's wire plan ``(codec, mode, key_bound, rid_bound_r,
        rid_bound_s)`` (``_resolve_exchange_plan``, hash_join.py:
        1560-1587): ``exchange_stages`` 0 is "auto"; a one-rank world ships
        raw.  The key bound is the static one of :meth:`join`
        (``key_bound``), else the sizing pass's measured max, else a device
        max over the world (:meth:`_probe_key_bound`); the rid bounds are
        the global relation sizes (rids are dense global indices).  "auto"
        is resolved window by window (:meth:`_wire_side`)."""
        cfg = self.config
        mode = "auto" if cfg.exchange_stages == 0 else int(cfg.exchange_stages)
        if cfg.exchange_codec == "off" or self.world.size == 1:
            return ("off", mode, None, None, None)
        if key_bound is None:
            key_bound = self._measured_key_bound
        if key_bound is None:
            key_bound = self._probe_key_bound(r, s)
        n = self.world.size
        return (cfg.exchange_codec, mode, int(key_bound), r.size * n,
                s.size * n)

    def _key_maxima(self, r: TupleBatch, s: TupleBatch) -> torch.Tensor:
        """int64 [2]: this rank's largest uint32 of the key lanes and of
        the hi key lanes (0 without them), each lane's own max."""
        hi = (torch.zeros((), dtype=torch.int64, device=self.device)
              if r.key_hi is None
              else torch.maximum(umax(r.key_hi), umax(s.key_hi)))
        return torch.stack([torch.maximum(umax(r.key), umax(s.key)), hi])

    @staticmethod
    def _bound_of(maxima) -> int:
        """The exclusive key bound of the all-reduced lane maxima: the lane
        maxima are independent upper bounds, so ``(max_hi << 32 | max_lo)
        + 1`` bounds every key (``hash_join.py:318-324``, ``:473``)."""
        return ((int(maxima[1]) << 32) | int(maxima[0])) + 1

    def _probe_key_bound(self, r: TupleBatch, s: TupleBatch) -> int:
        """Device max + 1 of the keys over the world, for a packed join
        with no static bound and no measured sizing pass
        (``_probe_key_bound``, hash_join.py:1589-1599)."""
        return self._bound_of(self.world.all_reduce(
            self._key_maxima(r, s), op="max").cpu())

    def _wire_side(self, cap: int, rid_bound):
        """One window's codec under the plan (``_wire_side``, hash_join.py:
        1601-1615): ("pack", WireSpec) or ("off", None); "auto" packs only
        when the packed block is smaller than the raw lanes."""
        cfg = self.config
        codec = self._xplan[0]
        if codec == "off":
            return "off", None
        wide = cfg.key_bits == 64
        spec = make_wire_spec(cap, cfg.network_fanout_bits, wide=wide,
                              key_bound=self._xplan[2], rid_bound=rid_bound)
        if codec == "auto" and spec.bytes_per_block >= cap * (12 if wide
                                                              else 8):
            return "off", None
        return "pack", spec

    def _make_windows(self, cap_r: int, cap_s: int):
        """The two windows under the plan (``_make_windows``, hash_join.py:
        1619-1636), the one construction site of the counting and the
        materializing attempts."""
        cfg = self.config
        _, mode, key_bound, rid_r, rid_s = self._xplan

        def one(cap, side, rid_bound):
            codec, _ = self._wire_side(cap, rid_bound)
            return Window(self.world, cap, side, codec=codec, mode=mode,
                          fanout_bits=cfg.network_fanout_bits,
                          key_bound=key_bound, rid_bound=rid_bound,
                          partition_impl=cfg.partition_impl)

        return one(cap_r, "inner", rid_r), one(cap_s, "outer", rid_s)

    def _exchange_stats(self, cap_r: int, cap_s: int) -> dict:
        """The wire geometry of one exchange under the plan
        (``_exchange_stats``, hash_join.py:1638-1690), from the shapes
        alone: ``wire_bytes`` a rank ships for both relations,
        ``bytes_per_tuple`` a slot (raw: 8, 12 with the hi key lane), and
        ``peak_exchange_bytes``, the largest single collective's buffer
        (the raw lanes of a side counted as one), which staging bounds to
        about 1/k."""
        cfg = self.config
        n = self.world.size
        wide = cfg.key_bits == 64
        raw_pt, lanes = (12, 3) if wide else (8, 2)
        mode = self._xplan[1]
        stats = {"codec": cfg.exchange_codec, "key_bound": self._xplan[2]}
        wire_total = raw_total = peak = 0
        stages_used = 1
        for side, cap, rid_bound in (("r", cap_r, self._xplan[3]),
                                     ("s", cap_s, self._xplan[4])):
            codec, spec = self._wire_side(cap, rid_bound)
            raw = n * cap * raw_pt
            if codec == "pack":
                wire = n * spec.bytes_per_block
                k = parse_exchange_mode(mode, spec.block_words)
                side_peak = n * 4 * -(-spec.block_words // k)
                bpt = spec.bytes_per_tuple
            else:
                wire = raw
                k = parse_exchange_mode(mode, cap)
                side_peak = n * 4 * lanes * -(-cap // k)
                bpt = float(raw_pt)
            stats[f"codec_{side}"] = codec
            stats[f"stages_{side}"] = k
            stats[f"bytes_per_tuple_{side}"] = round(bpt, 4)
            wire_total += wire
            raw_total += raw
            peak = max(peak, side_peak)
            stages_used = max(stages_used, k)
        stats["wire_bytes"] = wire_total
        stats["raw_bytes"] = raw_total
        stats["bytes_per_tuple"] = round(
            wire_total / max(1, n * (cap_r + cap_s)), 4)
        stats["pack_ratio_pct"] = round(
            100.0 * wire_total / max(1, raw_total), 2)
        stats["peak_exchange_bytes"] = peak
        stats["stages"] = stages_used
        return stats

    def _finish(self, r: TupleBatch, s: TupleBatch, matches: int,
                caps=None, repeats: int = 1) -> None:
        """The epilogue's counters (``_finish_join``, hash_join.py:
        2702-2735): JTOTAL stops, RESULTS and the global RTUPLES / STUPLES
        count, the exchange of the attempt that produced the result is
        recorded (``caps``; None on the one-rank sort probe), each once a
        join of ``repeats``, and the rates derived."""
        m = self.measurements
        if m is None:
            return
        m.stop(JTOTAL)
        n = self.world.size
        m.incr(RESULTS, matches * repeats)
        m.incr(RTUPLES, r.size * n * repeats)
        m.incr(STUPLES, s.size * n * repeats)
        if caps is not None:
            xs = self._exchange_stats(*caps)
            m.meta["exchange_plan"] = xs
            for _ in range(repeats):
                m.record_exchange(n, *caps,
                                  tuple_bytes=8 if r.key_hi is None else 12,
                                  wire_bytes=xs["wire_bytes"],
                                  pack_ratio_pct=xs["pack_ratio_pct"],
                                  stages=xs["stages"])
        m.derive_rates()

    @classmethod
    def _rollback_attempt(cls, m, dts: dict) -> None:
        """Move a superseded attempt's phase times into MWINWAIT
        (``_rollback_attempt``, hash_join.py:376-389), so the phase columns
        report only the attempt that produced the result."""
        m.incr(RETRIES)
        m.add_time_us(MWINWAIT, sum(v for k, v in dts.items()
                                    if k not in cls._NESTED_PHASES))
        for k, v in dts.items():
            if v:
                m.times_us[k] -= v

    def _stage(self, dts: dict):
        """``run(stage, fn, *args)`` for the bucket probe's stages: each
        call timed under ``stage``, fenced on its output, summed in
        ``dts``."""
        m = self.measurements

        def run(stage, fn, *args, **kw):
            m.start(stage)
            out = fn(*args, **kw)
            dts[stage] = dts.get(stage, 0.0) + m.stop(stage, fence=out)
            return out

        return run

    def _sort_probe_join(self, r: TupleBatch, s: TupleBatch,
                         key_bound: Optional[int],
                         repeats: int = 1) -> JoinResult:
        """The one-rank sort probe; a reported shortfall (only the
        ``engine.shuffle_overflow`` fault site gives one: nothing here has
        a capacity) reruns it, as the JAX retry loop does.  It exchanges
        nothing and is not verified, but ``exchange.corrupt_lane`` still
        damages its outer keys."""
        cfg = self.config
        m = self.measurements
        route = self._resolve_key_range(r, s, key_bound)
        if m is not None:
            if route != "wide":
                m.meta["key_range"] = route
            # no sizing pass: the one-rank sort probe has no windows
            m.start(SWINALLOC)
            m.stop(SWINALLOC)
        self._check_cancel("sized")
        self._stall_site()
        s, _ = self._inject_exchange_corrupt(s)
        for attempt in range(cfg.max_retries + 1 if repeats == 1 else 1):
            if repeats == 1:
                self._check_cancel("probe")
            if m is not None:
                m.start(JPROC)
            for _ in range(repeats):
                out = self._sort_probe_attempt(r, s, route)
            counts, flags = self._sort_probe_flags(s, out)
            dts = {JPROC: m.stop(JPROC)} if m is not None else {}
            if repeats == 1:
                flags = self._inject_shuffle_fault(flags)
            diag = self._flags_to_diag(flags)
            if not flags.any() or not self._retryable(diag):
                break
            if m is not None and attempt < cfg.max_retries:
                self._rollback_attempt(m, dts)
            self._retry_backoff(attempt)
        # host uint64 sum: a device sum of uint32 counts would wrap at scale
        matches = int(counts.astype(np.uint64).sum())
        self._finish(r, s, matches, repeats=repeats)
        return JoinResult(matches=matches, ok=not flags.any(),
                          partition_counts=counts,
                          diagnostics=self._stamp(diag),
                          retries=attempt)

    def _sort_probe_attempt(self, r: TupleBatch, s: TupleBatch,
                            route: str) -> torch.Tensor:
        """One sort probe on the device, read back by nothing: int64
        [2 + P] of the contract violation, the max weight and the
        per-partition counts."""
        fanout = self.config.network_fanout_bits
        impl = self.config.sort_impl
        keys_ok = self._keys_in_contract(r, s, route == "narrow")
        if route == "wide":
            counts, maxw = merge_count_wide_per_partition(
                r.key, r.key_hi, s.key, s.key_hi, fanout,
                return_max_weight=True, sort_impl=impl)
        elif route == "full":
            counts, maxw = merge_count_per_partition_full(
                r.key, s.key, fanout, return_max_weight=True, sort_impl=impl)
        else:
            counts, maxw = merge_count_per_partition(
                r.key, s.key, fanout, return_max_weight=True, sort_impl=impl)
        return torch.cat([(~keys_ok).to(torch.int64).reshape(1),
                          widen(maxw).reshape(1), widen(counts)])

    def _sort_probe_flags(self, s: TupleBatch, out: torch.Tensor):
        """(uint32 counts, the 7 flags) of a sort probe's output: its one
        readback, and the overflow-risk bound.  The scalar pre-test maxw *
        |S| < 2**32 clears every realistic workload with no extra pass;
        only a suspect workload pays the per-partition histogram (K1)."""
        num_p = self.config.network_partition_count
        host = out.cpu().numpy()
        keys_bad, maxw = int(host[0]), int(host[1])
        counts = host[2:].astype(np.uint32)
        scalar_limit = (2**32 - 1) // max(1, s.size)
        if maxw > scalar_limit:
            s_pid = torch.bitwise_and(s.key, num_p - 1)
            s_hist = local_histogram(s_pid, num_p,
                                     impl=self.config.partition_impl)
            count_risk = self._count_risk(
                maxw, s_hist.cpu().numpy().view(np.uint32))
        else:
            count_risk = False
        return counts, np.array([keys_bad, 0, 0, 0, 0, 0, int(count_risk)],
                                dtype=np.uint32)

    # ------------------------------------------------------ generic body
    def _sized(self, r: TupleBatch, s: TupleBatch, warm: bool = False):
        """(plan, cap_r, cap_s, skew, local_slack): the sizing pass under
        its timers, SWINALLOC and, with measured windows, JHIST, both
        stopped at the sizing readback, which has fenced the pass.  With
        ``warm`` the plan cache's converged capacities of these shapes,
        when it has them (:meth:`_warm_capacities`), replace the sizing
        pass (``hash_join.py:1805-1818``): no JHIST, and the histograms and
        the assignment that every attempt needs run inside SWINALLOC."""
        m = self.measurements
        if m is not None:
            m.start(SWINALLOC)
        caps = self._warm_capacities(r, s) if warm else None
        measured = self.config.window_sizing == "measured" and caps is None
        if m is not None and measured:
            m.start(JHIST)
        plan = self._shuffle_plan(r, s)
        if caps is not None:
            (cap_r, cap_s, slack), skew = caps, None
        else:
            (cap_r, cap_s, skew), slack = (
                self._measure_capacities(r, s, plan), 1)
        if m is not None:
            if measured:
                m.stop(JHIST)
            m.stop(SWINALLOC)
        return plan, cap_r, cap_s, skew, slack

    def _shuffled_join(self, r: TupleBatch, s: TupleBatch,
                       key_bound: Optional[int],
                       repeats: int = 1) -> JoinResult:
        """The retry loop around :meth:`_shuffled_attempt`
        (``_join_arrays_inner``, hash_join.py:1912-1948): a capacity
        shortfall doubles only what fell short — ``cap_r``, ``cap_s``, the
        local slack or the skew split's ``hot_cap`` — backs off
        (:meth:`_retry_backoff`) and reruns the attempt.  The flags are
        summed over the ranks, so every rank retries or stops together.
        ``repeats > 1`` runs that many attempts and no retry loop."""
        cfg = self.config
        m = self.measurements
        route = (self._resolve_key_range(r, s, key_bound) if cfg.sort_probe
                 else None)
        if m is not None and route in ("narrow", "full"):
            m.meta["key_range"] = route
        self._measured_key_bound = None   # only this join's sizing counts
        plan, cap_r, cap_s, skew, local_slack = self._sized(r, s, warm=True)
        self._xplan = self._resolve_exchange_plan(r, s, key_bound)
        caps = (cap_r, cap_s)
        if m is not None:
            xs = self._exchange_stats(cap_r, cap_s)
            m.meta["exchange_plan"] = xs
            m.counters[PACKRATIO] = int(round(xs["pack_ratio_pct"]))
            m.counters[XSTAGES] = int(xs["stages"])
        self._check_cancel("sized")
        self._stall_site()
        verify = cfg.verify != "off"
        pre = self._verify_pre(r, s, skew) if verify else None
        s, pristine_s = self._inject_exchange_corrupt(s)
        if repeats > 1:
            counts, flags, _, vchk = self._shuffled_attempt(
                r, s, plan, route, cap_r, cap_s, local_slack, skew, repeats,
                verify)
            diag = self._flags_to_diag(flags)
            if verify and not flags.any():
                result = self._verified_finish(
                    r, s, pristine_s, counts, flags, diag, pre, vchk, caps,
                    skew, repeats)
            else:
                result = self._result(r, s, counts, flags, diag, caps,
                                      repeats)
            self._cache_store_capacities(r, s, cap_r, cap_s, local_slack,
                                         result.ok)
            return result
        for attempt in range(cfg.max_retries + 1):
            self._check_cancel("probe")
            counts, flags, dts, vchk = self._shuffled_attempt(
                r, s, plan, route, cap_r, cap_s, local_slack, skew,
                verify=verify)
            caps = (cap_r, cap_s)   # the attempt the result comes from
            flags = self._inject_shuffle_fault(flags)
            diag = self._flags_to_diag(flags)
            if not flags.any() or not self._retryable(diag):
                break
            if diag["shuffle_overflow_r_tuples"]:
                cap_r *= 2
            if diag["shuffle_overflow_s_tuples"]:
                cap_s *= 2
            if diag["local_overflow"]:
                local_slack *= 2
            if diag["hot_overflow"]:
                skew = skew._replace(hot_cap=2 * skew.hot_cap)
            if m is not None and attempt < cfg.max_retries:
                # when retries are exhausted the last attempt is the
                # result and keeps its time
                self._rollback_attempt(m, dts)
            self._retry_backoff(attempt)
        if (flags.any() and self._retryable(diag)
                and cfg.fallback == "chunked"):
            return self._fallback_chunked(r, s, diag, attempt)
        if verify and not flags.any():
            # the checksums judge only a flag-clean accepted attempt: a
            # capacity shortfall drops tuples by its own failure class
            result = self._verified_finish(r, s, pristine_s, counts, flags,
                                           diag, pre, vchk, caps, skew, 1,
                                           attempt)
        else:
            result = self._result(r, s, counts, flags, diag, caps,
                                  retries=attempt)
        self._cache_store_capacities(r, s, cap_r, cap_s, local_slack,
                                     result.ok)
        return result

    def _result(self, r: TupleBatch, s: TupleBatch, counts: np.ndarray,
                flags: np.ndarray, diag: dict, caps, repeats: int = 1,
                retries: int = 0) -> JoinResult:
        """The epilogue of an attempt's readback: the host uint64 sum of
        the uint32 counts (a device sum would wrap at scale), the
        registry's counters and the result."""
        matches = int(counts.astype(np.uint64).sum())
        self._finish(r, s, matches, caps, repeats)
        return JoinResult(matches=matches, ok=not flags.any(),
                          partition_counts=counts,
                          diagnostics=self._stamp(diag),
                          retries=retries)

    # ------------------------------------------------- integrity verify
    def _verify_pre(self, r: TupleBatch, s: TupleBatch,
                    skew: Optional[SkewPlan]) -> torch.Tensor:
        """The pristine inputs' world fingerprints, int32 [2, rows, P] (R
        then S), timed as VCHK (``_verify_pre_fn``, hash_join.py:
        1376-1423).  Under a skew plan the hot inner partitions leave the
        exchange for the replication route and are left out; hot outer
        tuples land in the receive buffers with their true pid."""
        cfg = self.config
        m = self.measurements
        fanout, num_p = cfg.network_fanout_bits, cfg.network_partition_count
        if m is not None:
            m.start(VCHK)
        r_pid, s_pid = partition_ids(r, fanout), partition_ids(s, fanout)
        r_valid = None if skew is None else ~is_hot(r_pid, skew.hot_bits)
        pre = torch.stack([
            global_partition_checksums(r.key, r_pid, num_p, self.world,
                                       valid=r_valid, key_hi=r.key_hi,
                                       sort_impl=cfg.sort_impl),
            global_partition_checksums(s.key, s_pid, num_p, self.world,
                                       key_hi=s.key_hi,
                                       sort_impl=cfg.sort_impl)])
        if m is not None:
            m.stop(VCHK, fence=pre)
        return pre

    def _inject_exchange_corrupt(self, s: TupleBatch):
        """Fault site ``exchange.corrupt_lane`` (hash_join.py:1425-1445),
        consulted once a join on every rank whatever the verify mode: when
        it fires, rank 0 flips bit 30 of its first outer key (the JAX
        engine flips element 0 of the global outer lane), on a clone on
        the device.  Bit 30 keeps the key inside the contract and above
        the radix bits, so counts conserve and flags stay clean: only the
        checksums see it.  Returns (batch for the attempts, the pristine
        batch or None)."""
        if not faults.fires(faults.EXCHANGE_CORRUPT, self.measurements):
            return s, None
        if self.world.rank != 0 or s.size == 0:
            return s, s
        key = s.key.clone()
        key[:1].bitwise_xor_(0x40000000)
        return s._replace(key=key), s

    def _verified_finish(self, r: TupleBatch, s: TupleBatch,
                         pristine_s: Optional[TupleBatch], counts: np.ndarray,
                         flags: np.ndarray, diag: dict, pre: torch.Tensor,
                         vchk: np.ndarray, caps, skew: Optional[SkewPlan],
                         repeats: int, retries: int = 0) -> JoinResult:
        """The integrity verdict on a flag-clean attempt
        (``_verified_finish``, hash_join.py:2560-2620): each set the
        attempt read back (R and S alternating) against its relation's
        pre-exchange fingerprint, then, on the sort and chunked paths
        without a skew plan, the counts' cross-product bound.  Intact: the
        normal epilogue.  Damaged: ``data_corruption`` with ok False, or
        under "repair" :meth:`_repair`."""
        cfg = self.config
        m = self.measurements
        num_p = cfg.network_partition_count
        if m is not None:
            m.start(VCHK)
        pre_h = pre.cpu().numpy().view(np.uint32)
        damaged = set()
        ncomp = 0
        for k in range(vchk.shape[0]):
            ncomp += 1
            damaged.update(int(p) for p in damaged_partitions(pre_h[k % 2],
                                                              vchk[k]))
        cross = None
        if not damaged and not cfg.bucket_path and skew is None:
            ncomp += 1
            cross = cross_check_counts(
                counts.reshape(self.world.size, num_p),
                int(counts.astype(np.uint64).sum()), pre_h[0][0], pre_h[1][0])
        if m is not None:
            m.stop(VCHK)
            m.incr(VCHKN, ncomp)
        if not damaged and cross is None:
            return self._result(r, s, counts, flags, diag, caps, repeats,
                                retries)
        dmg = sorted(damaged)
        if m is not None:
            m.incr(VFAIL)
            m.event("data_corruption", partitions=dmg[:16],
                    comparisons=ncomp, cross=cross)
        diag = dict(diag, data_corruption_partitions=max(1, len(dmg)))
        if cross is not None:
            diag["data_corruption_cross"] = cross
        diag["failure_class"] = classify_diagnostics(diag)
        if cfg.verify != "repair":
            return self._result(r, s, counts, flags, diag, caps, repeats,
                                retries)._replace(ok=False)
        return self._repair(r, pristine_s if pristine_s is not None else s,
                            counts, diag, dmg, repeats, retries)

    def _repair(self, r: TupleBatch, s: TupleBatch, counts: np.ndarray,
                diag: dict, dmg, repeats: int, retries: int) -> JoinResult:
        """``verify="repair"`` (``_repair``, hash_join.py:2622-2690):
        recompute the damaged network partitions from the pristine inputs
        and splice their counts in.  On the sort and chunked layouts each
        damaged partition re-joins as its own 1 x 1 out-of-core grid
        (``chunked_join_grid(..., pipeline=grid_pipeline)``, one GRIDPAIRS
        each) and its count is parked in row 0 of its column; the bucket
        layout has no column a network partition, and a cross-check
        violation names none, so those recompute the whole join
        (``chunked_join_count``).  Over N ranks every rank gathers both
        relations and recomputes the same counts."""
        cfg = self.config
        m = self.measurements
        num_p = cfg.network_partition_count
        whole_r, whole_s = self._whole(r), self._whole(s)
        slab = min(FALLBACK_SLAB, max(1, whole_s.size))
        scope = "partition"
        if cfg.bucket_path or not dmg:
            scope = "full"
            matches = chunked_join_count(whole_r, whole_s, slab,
                                         key_range="auto",
                                         sort_impl=cfg.sort_impl)
            counts_out = np.array([matches % (1 << 32)], np.uint32)
        else:
            cols = counts.reshape(self.world.size, num_p).astype(np.uint64)
            for p in dmg:
                cols[:, p] = 0
            intact = int(cols.sum())
            repaired = 0
            for p in dmg:
                r_p, s_p = (self._partition_of(b, p) for b in (whole_r,
                                                               whole_s))
                cnt = 0
                if r_p.size and s_p.size:
                    cnt = chunked_join_grid(
                        [r_p], [s_p], min(slab, s_p.size), measurements=m,
                        pipeline=cfg.grid_pipeline, sort_impl=cfg.sort_impl)
                cols[0, p] = cnt % (1 << 32)
                repaired += cnt
            matches = intact + repaired
            counts_out = cols.astype(np.uint32).reshape(counts.shape)
        diag = self._stamp(dict(
            diag, repaired=scope, repaired_partitions=[int(p) for p in dmg]))
        if m is not None:
            m.incr(VREPAIR, max(1, len(dmg)))
            m.event("repair", scope=scope,
                    partitions=[int(p) for p in dmg][:16])
        self._finish(r, s, matches, None, repeats)
        return JoinResult(matches=matches, ok=True,
                          partition_counts=counts_out, diagnostics=diag,
                          retries=retries)

    def _partition_of(self, b: TupleBatch, p: int) -> TupleBatch:
        """The tuples of network partition ``p`` of ``b``, with zero rids
        (the count reads only keys)."""
        sel = partition_ids(b, self.config.network_fanout_bits) == p
        key = torch.masked_select(b.key, sel)
        return TupleBatch(key=key, rid=torch.zeros_like(key),
                          key_hi=None if b.key_hi is None
                          else torch.masked_select(b.key_hi, sel))

    # ------------------------------------------------ plan cache, cancel
    def _cache_config_fp(self) -> dict:
        """The JoinConfig fields window capacities depend on
        (``_cache_config_fp``, hash_join.py:399-416): configs agreeing here
        size the same windows for the same inputs.  The membership epoch
        belongs to the identity: capacities converged on the boot mesh
        never warm-start a mesh after a loss or an admission."""
        cfg = self.config
        return {"num_nodes": cfg.num_nodes, "num_hosts": cfg.num_hosts,
                "network_fanout_bits": cfg.network_fanout_bits,
                "local_fanout_bits": cfg.local_fanout_bits,
                "key_bits": cfg.key_bits, "two_level": cfg.two_level,
                "probe_algorithm": cfg.probe_algorithm,
                "assignment_policy": cfg.assignment_policy,
                "window_sizing": cfg.window_sizing,
                "exchange_codec": cfg.exchange_codec,
                "exchange_stages": cfg.exchange_stages,
                "membership_epoch": self._membership_epoch()}

    def _cache_eligible(self) -> bool:
        """Warm capacities apply only where the sizing pass would run and
        its result depends on the shapes and the config alone: not the
        one-rank sort probe (it never sizes), not static sizing (free
        already), not a skew split (its hot set is measured)."""
        cfg = self.config
        return (self.plan_cache is not None
                and not (cfg.sort_probe and self.world.size == 1)
                and cfg.window_sizing == "measured"
                and cfg.skew_threshold is None)

    def _cache_sizes(self, r: TupleBatch, s: TupleBatch):
        """The relations' global sizes, the cache key's shapes."""
        return r.size * self.world.size, s.size * self.world.size

    def _warm_capacities(self, r: TupleBatch, s: TupleBatch):
        """(cap_r, cap_s, local_slack) from the plan cache, or None.  Over
        several ranks the verdict is one all-reduced decision, so no rank
        sizes while another does not: the join is warm only when every
        rank found the entry, at the largest capacities any rank holds."""
        if not self._cache_eligible():
            return None
        _, warm = self.plan_cache.lookup(*self._cache_sizes(r, s),
                                         self._cache_config_fp())
        caps = (None if warm is None else
                (int(warm["cap_r"]), int(warm["cap_s"]),
                 int(warm.get("local_slack", 1))))
        if self.world.size > 1:
            got = self.world.all_reduce(torch.tensor(
                [caps is None, *(caps or (0, 0, 0))], dtype=torch.int64,
                device=self.device), op="max").cpu().tolist()
            caps = None if got[0] else tuple(got[1:])
        return caps

    def _cache_store_capacities(self, r: TupleBatch, s: TupleBatch,
                                cap_r: int, cap_s: int, local_slack: int,
                                ok: bool) -> None:
        """After a successful join, persist the converged capacities (after
        any retry doublings) for the next join of these shapes."""
        if not ok or not self._cache_eligible():
            return
        self.plan_cache.store(*self._cache_sizes(r, s),
                              self._cache_config_fp(),
                              capacities={"cap_r": cap_r, "cap_s": cap_s,
                                          "local_slack": local_slack})

    def _check_cancel(self, phase: str) -> None:
        """The phase-boundary service point (``_check_cancel``,
        hash_join.py:1969-2010): the ``membership.rank_death`` and
        ``membership.rank_join`` sites, then the membership view (this
        rank's own heartbeat, the lease scan: admissions, then lapses),
        the straggler poll when hedging, and the cancellation hook, which
        raises to cancel.  JTOTAL, when running, is closed by
        :meth:`_measured` on the way out.  Every rank reaches the same
        boundaries in the same order, so a hook that decides alike on
        every rank leaves no collective half-entered; an admission under
        ``elastic_grow`` and a straggler verdict are rank 0's, broadcast."""
        m = self.measurements
        if faults.fires(faults.RANK_DEATH, m):
            self._rank_death(phase)
        if faults.fires(faults.RANK_JOIN, m):
            self._rank_join(phase)
        mv = self.membership
        if mv is not None:
            # the self-heartbeat rides the boundary with the peer scan: a
            # long gap between boundaries must not lapse this rank's lease
            mv.board.heartbeat(mv.epoch, status=mv.my_status())
            prev_joined = set(mv.joined)
            newly = mv.check()
            if newly:
                raise RankLost(newly[0], mv.epoch,
                               f"lease lapsed at phase {phase!r}")
            if self.elastic_grow:
                admitted = self._agreed_admission(
                    sorted(mv.joined - prev_joined))
                if admitted:
                    # the fenced epoch on this rank's lease before the
                    # re-expansion: a newcomer is admitted when it reads an
                    # incumbent's lease at the bumped epoch
                    mv.board.heartbeat(mv.epoch, status=mv.my_status())
                    raise RankJoined(admitted, mv.epoch)
            if self._should_hedge():
                self._poll_straggler(phase)
        if self.cancel is not None:
            self.cancel(phase)

    def _agreed_admission(self, admitted: list) -> list:
        """The ranks this boundary admits: this rank's scan at one rank;
        over several, rank 0's, broadcast, and admitted here too where this
        rank's scan missed them, so every rank re-expands at the same
        boundary."""
        if self.world.size == 1:
            return admitted
        admitted = list(self.world.broadcast_object(admitted))
        mv = self.membership
        missed = [r for r in admitted if not mv.is_live(r)]
        if missed:
            mv._admit(missed, cause="joining_lease")
        return admitted

    def _stall_site(self) -> None:
        """Fault site ``backend.stall`` (hash_join.py:1838-1858): a hung
        launch, simulated by spinning at the ``"stalled"`` boundary, where
        only the cancel hook can end it; after ``TPU_RADIX_STALL_CAP_S``
        seconds (120 by default) it raises ``TransientFault``
        (``backend_unavailable``).  The cap is rank 0's clock's verdict.
        Then the ``compute.straggle`` site (hash_join.py:1859-1865)."""
        if faults.fires(faults.BACKEND_STALL, self.measurements):
            cap_s = float(os.environ.get("TPU_RADIX_STALL_CAP_S", "120"))
            t0 = time.monotonic()
            while True:
                self._check_cancel("stalled")
                if self.world.broadcast_object(
                        time.monotonic() - t0 >= cap_s):
                    raise faults.TransientFault(faults.BACKEND_STALL, 1)
                time.sleep(0.01)
        if faults.fires(faults.COMPUTE_STRAGGLE, self.measurements):
            # an alive but slow rank, not an infrastructure failure: it
            # keeps heartbeating, so no lease declares it dead; hedging
            # turns the stretch into a bounded speculative recompute
            self._compute_straggle()

    # ------------------------------------------------ elastic recovery
    def _rank_death(self, phase: str) -> None:
        """The ``membership.rank_death`` site fired at this boundary
        (``_rank_death``, hash_join.py:2012-2036).  Two modes:

          * **real** (``TPU_RJ_RANK_DEATH_SUICIDE`` set, the victim process
            of a multi-process test): the process dies as a real rank
            dies, SIGKILL, no cleanup; ``TPU_RJ_RANK_DEATH_SUICIDE=stop``
            freezes it with SIGSTOP instead (a hung peer: its sockets stay
            open, so the survivors wait out the group's timeout).  The
            wall time of the death goes to stderr first;
          * **simulated**: the highest node rank is the victim.  Every rank
            whose injector fired declares it lost (bumping the epoch) and
            raises the :class:`RankLost` the elastic path owns; with no
            manifest each rank then recomputes every partition."""
        mode = os.environ.get("TPU_RJ_RANK_DEATH_SUICIDE")
        if mode:
            print(f"[ELASTIC] rank_death pid={os.getpid()} phase={phase} "
                  f"t_epoch_s={time.time():.6f} mode={mode}",
                  file=sys.stderr, flush=True)
            os.kill(os.getpid(), signal.SIGSTOP if mode == "stop"
                    else signal.SIGKILL)
            return      # a frozen rank woken up again runs on, fenced out
        m = self.measurements
        victim = self.config.num_nodes - 1
        if self.membership is not None:
            epoch = self.membership.declare_lost(victim, cause="injected")
        else:
            epoch = 1
            if m is not None:
                m.incr(MEPOCH)
                m.incr(RANKLOST)
                m.event("rank_lost", ranks=[victim], epoch=epoch,
                        cause="injected",
                        survivors=self.config.num_nodes - 1)
        raise RankLost(victim, epoch, f"injected at phase {phase!r}")

    def _rank_join(self, phase: str) -> None:
        """The ``membership.rank_join`` site fired at this boundary: a
        newcomer simulated by a fresh ``joining`` lease for the next unused
        rank, the stand-in for a new process's first heartbeat.  The
        boundary's lease scan does the rest (a fenced epoch bump, RANKJOIN,
        and under ``elastic_grow`` the :class:`RankJoined`
        re-expansion)."""
        mv = self.membership
        if mv is None:
            return
        board = mv.board
        new_rank = LeaseBoard.next_rank(board.run_dir, floor=board.num_ranks)
        joiner = LeaseBoard(board.run_dir, new_rank, board.num_ranks,
                            lease_s=board.lease_s, clock=board.clock,
                            missed_beats=board.missed_beats)
        joiner.heartbeat(mv.epoch, status="joining")
        m = self.measurements
        if m is not None:
            m.event("rank_join_injected", rank=new_rank, phase=phase)

    def _should_hedge(self) -> bool:
        """Hedging needs the manifest's fence and a membership view;
        ``auto`` also backs off while wasted speculation outruns wins (the
        SPECWASTE / HEDGEWIN loop)."""
        if (self.hedge == "off" or self.membership is None
                or self.partition_manifest is None):
            return False
        if self.hedge == "auto":
            m = self.measurements
            if m is not None and (m.counters.get(SPECWASTE, 0)
                                  > m.counters.get(HEDGEWIN, 0)):
                return False
        return True

    def _detector(self) -> StragglerDetector:
        if self._straggler_detector is None:
            self._straggler_detector = StragglerDetector(
                threshold=self.hedge_threshold)
        return self._straggler_detector

    def _agreed_verdict(self, verdict, stop: bool = False):
        """``(verdict, stop)``: this rank's at one rank, rank 0's over
        several (a straggler verdict and the straggle's end decide alike
        on every rank, as the stall cap does)."""
        if self.world.size == 1:
            return verdict, stop
        return tuple(self.world.broadcast_object((verdict, stop)))

    def _poll_straggler(self, phase: str) -> None:
        """Straggler detection at a boundary: the live peers' lease
        progress clocks; a confirmed (post-dwell) verdict on a peer raises
        :class:`StragglerDetected` for the hedge.  A verdict on this rank
        itself is ignored: a straggler cannot hedge itself."""
        mv = self.membership
        board = mv.board
        live = [r for r in mv.survivors if r in set(board.discover())
                or r < board.num_ranks]
        progress = board_progress(board, live)
        verdict = None
        if len(progress) >= 2:
            num_p = self.config.network_partition_count
            share = max(1, num_p // max(1, len(progress)))
            outstanding = {r: max(0, share - done)
                           for r, done in progress.items()}
            verdict = self._detector().observe(progress, outstanding)
            if verdict is not None and verdict.rank == board.rank:
                verdict = None
        verdict, _ = self._agreed_verdict(verdict)
        if verdict is not None:
            raise verdict.to_exc(mv.epoch)

    def _compute_straggle(self) -> None:
        """The ``compute.straggle`` site fired (``_compute_straggle``,
        hash_join.py:2117-2154): the highest node rank slows down by
        ``straggle_factor`` x ``straggle_unit_s`` seconds, which every rank
        whose site fired spins out.  Unhedged, the join eats the stretch.
        Hedged, each poll feeds the detector the simulated picture (the
        healthy ranks at their share, the straggler at its manifest
        progress) and the post-dwell verdict aborts into the hedge.  Over
        several ranks every poll's verdict and the spin's end are rank
        0's."""
        m = self.measurements
        n = self.config.num_nodes
        victim = n - 1
        factor = max(0.0, float(self.straggle_factor))
        duration = factor * self.straggle_unit_s
        if m is not None:
            m.event("straggle", rank=victim, factor=factor,
                    duration_s=round(duration, 3))
        if duration <= 0:
            return
        hedging = self._should_hedge()
        share = max(1, self.config.network_partition_count // n)
        detector = self._detector() if hedging else None
        t0 = time.monotonic()
        while True:
            stop = time.monotonic() - t0 >= duration
            verdict = None
            if hedging and not stop:
                done = self.partition_manifest.completed()
                victim_done = sum(1 for p in done if p % n == victim)
                progress = {r: share for r in range(n) if r != victim}
                progress[victim] = victim_done
                outstanding = {victim: max(0, share - victim_done)}
                verdict = detector.observe(progress, outstanding)
            verdict, stop = self._agreed_verdict(verdict, stop)
            if verdict is not None:
                raise verdict.to_exc(self._membership_epoch())
            if stop:
                return
            time.sleep(min(0.02, duration / 4))

    def _as_rank_lost(self, e: BaseException) -> Optional[RankLost]:
        """A mid-join failure as the :class:`RankLost` recovery owns, or
        None.  RankLost and StaleEpoch always qualify; other injected
        faults and classified failures (``failure_class`` set: a deadline,
        a watchdog's hang) keep their own classes, at once (JAX waits a
        lapse window for them too).  A transport error (gloo's reset
        connection, a collective past the group's timeout, NCCL's abort)
        qualifies only once the membership view confirms a lapsed lease:
        a dead peer's socket closes before its lease ages out, so the lease
        gets one lapse window (``lease_s`` x ``missed_beats``) and a second
        to lapse before the error is disowned."""
        if isinstance(e, RankLost):
            return e
        if isinstance(e, StaleEpoch):
            mv = self.membership
            rank = min(mv.lost) if mv is not None and mv.lost else 0
            return RankLost(rank, e.current, "stale epoch fenced")
        if isinstance(e, faults.InjectedFault):
            return None
        if getattr(e, "failure_class", None) is not None:
            # a classified verdict (a deadline, the watchdog's hang, whose
            # triage already asked the leases) is no transport error: it
            # leaves at once instead of waiting out a lapse window
            return None
        mv = self.membership
        if mv is not None and isinstance(e, (ConnectionError, OSError,
                                             RuntimeError, TimeoutError)):
            deadline = time.monotonic() + mv.board.lapse_window_s + 1.0
            while True:
                lost = mv.check() or sorted(mv.lost)
                if lost or time.monotonic() >= deadline:
                    break
                time.sleep(0.2)
            if lost:
                return RankLost(lost[0], mv.epoch,
                                f"peer death surfaced as "
                                f"{type(e).__name__}: {e}"[:200])
        return None

    def _npp(self) -> int:
        """Node ranks a lease stands for: 1 wherever the board keeps one
        lease a rank of the world (every process of the port is one node),
        so the expansions below are the identity there; a one-lease board
        over an N-node engine (the simulated single-process mesh of the
        chaos runners) stands for all N."""
        mv = self.membership
        return max(1, self.config.num_nodes // max(1, mv.board.num_ranks))

    def _lost_nodes(self, exc: RankLost) -> list:
        """The node ranks of the lost lease ranks (``_lost_nodes``,
        hash_join.py:2196-2213): the identity over the port's world
        (:meth:`_npp`); without a board of several leases, the exception's
        rank."""
        n = self.config.num_nodes
        mv = self.membership
        if mv is None or mv.board.num_ranks <= 1:
            r = int(getattr(exc, "rank", n - 1))
            return [r if 0 <= r < n else n - 1]
        npp = self._npp()
        lost_procs = sorted(mv.lost) or [int(getattr(exc, "rank", 0))]
        out = []
        for pr in lost_procs:
            out.extend(range(pr * npp, min(n, (pr + 1) * npp)))
        return [r for r in out if 0 <= r < n] or [n - 1]

    def _recovery_scope(self):
        """The node ranks this rank recomputes for, or None for all
        (``_recovery_scope``, hash_join.py:2215-2227): a survivor on a
        board of several leases with a manifest takes its reassigned
        share (its own rank, :meth:`_npp`) and merges the rest through the
        manifest; otherwise it recomputes every lost partition."""
        mv = self.membership
        if (mv is None or mv.board.num_ranks <= 1
                or self.partition_manifest is None):
            return None
        npp = self._npp()
        me = mv.board.rank
        return range(me * npp, (me + 1) * npp)

    def _joined_nodes(self) -> list:
        """The node ranks admitted lease ranks bring (``_joined_nodes``,
        hash_join.py:2229-2243), the identity over the port's world: ids
        past the boot mesh label the out-of-band recompute's owners, not
        devices."""
        mv = self.membership
        if mv is None or not mv.joined:
            return []
        npp = self._npp()
        out = []
        for pr in sorted(mv.joined):
            out.extend(range(pr * npp, (pr + 1) * npp))
        return sorted(set(out))

    def _straggler_nodes(self, exc) -> list:
        """The node ranks the straggler owns (``_straggler_nodes``,
        hash_join.py:2245-2258): a lease rank of the real detection
        expands as :meth:`_lost_nodes` does (the identity over the port's
        world); the simulated straggle's victim is already a node rank."""
        n = self.config.num_nodes
        mv = self.membership
        rk = int(exc.rank)
        if (mv is not None and mv.board.num_ranks > 1
                and rk < mv.board.num_ranks):
            npp = self._npp()
            return [x for x in range(rk * npp, (rk + 1) * npp) if x < n]
        return [rk if 0 <= rk < n else n - 1]

    def _claim_hedge(self, plan, straggler_nodes, epoch: int) -> list:
        """Advisory claims on the straggler's unfinished partitions before
        the hedge recomputes them: a crash mid-hedge leaves a forensic
        trail (the hedge-claim timeline) and a concurrent hedger sees the
        race.  The done line, not the claim, decides the count."""
        mf = self.partition_manifest
        n = self.config.num_nodes
        strag = set(straggler_nodes)
        hedged = [p for p in plan.recompute if p % n in strag]
        scope = self._recovery_scope()
        mine = None if scope is None else set(scope)
        for p in hedged:
            owner = plan.reassignment[p]
            if mine is None or owner in mine:
                mf.claim(p, owner, epoch=epoch)
        return hedged

    def _recompute(self, plan, lanes, only_rank):
        """One :func:`~..robustness.recovery.execute_recovery` on this
        engine's device, sort arm and grid pipeline."""
        from tpu_radix_join_torch.robustness.recovery import execute_recovery
        rk, rhi, sk, shi = lanes
        return execute_recovery(
            plan, rk, sk, rhi, shi, only_rank=only_rank,
            slab=min(FALLBACK_SLAB, max(1, len(sk))),
            pipeline=self.config.grid_pipeline,
            measurements=self.measurements,
            manifest=self.partition_manifest, device=self.device,
            sort_impl=self.config.sort_impl)

    def _await_peer_partitions(self, plan, counts, lanes):
        """Partitions the plan gave other live ranks (an incumbent or a
        newcomer) may not have landed yet: poll the shared manifest for one
        lapse window, then recompute what is still missing here.  The
        inputs are deterministic and the fence takes the first line, so a
        double recompute is waste, never a double count."""
        mv, mf = self.membership, self.partition_manifest
        missing = [p for p in plan.recompute if p not in counts]
        if not missing or mf is None or mv is None:
            return counts
        deadline = time.monotonic() + mv.board.lapse_window_s + 1.0
        while missing and time.monotonic() < deadline:
            done = mf.completed()
            for p in list(missing):
                if p in done:
                    counts[p] = done[p]["count"]
                    missing.remove(p)
            if missing:
                time.sleep(0.2)
        if missing:
            _, extra = self._recompute(
                plan, lanes, {plan.reassignment[p] for p in missing})
            counts.update(extra)
        return counts

    def _host_lanes(self, r: TupleBatch, s: TupleBatch, exc):
        """The global host lanes ``(r_keys, r_hi, s_keys, s_hi)`` recovery
        recomputes from, without a collective: ``elastic_inputs``, else
        read from the batches at one rank.  A join of shards over several
        ranks without ``elastic_inputs`` re-raises the loss."""
        if self.elastic_inputs is not None:
            return tuple(self.elastic_inputs())
        if self.world.size == 1:
            return tuple(None if lane is None else lane_to_numpy(lane)
                         for lane in (r.key, r.key_hi, s.key, s.key_hi))
        raise exc

    def _recover_join(self, r: TupleBatch, s: TupleBatch, exc: RankLost,
                      repeats: int, key_bound: Optional[int] = None, *,
                      lost_nodes=None, joined_nodes=None, epoch=None,
                      span_name: str = "recovery", hedge_exc=None,
                      extra_diag=None) -> JoinResult:
        """Finish an aborted join on the survivors (``_recover_join``,
        hash_join.py:2309-2419; robustness/recovery.py): resume the
        realized partitions from the manifest, assign the rest over the
        survivors (a set an admission may have grown: ``joined_nodes``),
        recompute each as its own masked out-of-core grid from host lanes
        (K2 and K6 on the card), and splice: ``ok=True``, the exact count,
        the recovery record in the diagnostics, and no collective on the
        old group.

        Also the engine of :meth:`_regrow_join` (no loss, the admission's
        epoch) and :meth:`_hedge_join` (``lost_nodes`` only excluded from
        the assignment: nothing is declared lost, the epoch stays, and the
        manifest arbitrates against the original).  ``last_recovery``
        keeps the regeneration's and the recompute's wall times."""
        m = self.measurements
        cfg = self.config
        num_p = cfg.network_partition_count
        from tpu_radix_join_torch.robustness import recovery as _recovery
        t0 = time.monotonic()
        detected_t = time.time()
        launched0 = launch_counts()
        lanes = self._host_lanes(r, s, exc)
        rk, _, sk, _ = lanes
        t_regen = time.monotonic()
        if m is not None and JTOTAL in m._starts:
            m.stop(JTOTAL)      # the abort point; recovery has its own wall
        if epoch is None:
            epoch = max(1, self._membership_epoch(),
                        int(getattr(exc, "epoch", 1)))
        if lost_nodes is None:
            lost_nodes = self._lost_nodes(exc)
        if joined_nodes is None:
            joined_nodes = self._joined_nodes()
        # advisory re-pricing for the changed mesh under the port's own
        # profile: a missing profile must not block recovery
        profile = workload = None
        try:
            from tpu_radix_join_torch.planner.cost_model import Workload
            from tpu_radix_join_torch.planner.profile import load_profile
            profile = load_profile()
            workload = Workload(r_tuples=int(len(rk)), s_tuples=int(len(sk)),
                                key_bound=key_bound, key_bits=cfg.key_bits,
                                num_nodes=cfg.num_nodes)
        except Exception:   # noqa: BLE001 — advice only
            profile = workload = None
        span = (m.span(span_name, epoch=epoch, lost_ranks=list(lost_nodes))
                if m is not None else contextlib.nullcontext())
        with span:
            plan = _recovery.plan_recovery(
                num_nodes=cfg.num_nodes, num_partitions=num_p,
                lost_ranks=lost_nodes, epoch=epoch,
                manifest=self.partition_manifest,
                weights=_recovery.partition_weights(rk, sk, num_p),
                profile=profile, workload=workload,
                joined_ranks=joined_nodes)
            hedged_parts = []
            if hedge_exc is not None and self.partition_manifest is not None:
                hedged_parts = self._claim_hedge(plan, lost_nodes, epoch)
            _, counts = self._recompute(plan, lanes, self._recovery_scope())
            t_recompute = time.monotonic()
            counts = self._await_peer_partitions(plan, counts, lanes)
            matches = int(sum(counts.values()))
        counts_out = np.zeros(num_p, np.uint32)
        for p, c in counts.items():
            counts_out[p] = c % (1 << 32)
        diag = dict(plan.to_diag(), rank_lost_detail=str(exc)[:200],
                    failure_class="ok")
        if hedge_exc is not None and self.partition_manifest is not None:
            # the speculation against the fence's winners: a win is a
            # hedged partition someone other than the straggler realized
            score = {"hedgewin": 0, "specwaste": 0}
            for node in sorted(set(lost_nodes)):
                sub = [p for p in hedged_parts if p % cfg.num_nodes == node]
                sc = score_hedge(self.partition_manifest, sub, node, m)
                score["hedgewin"] += sc["hedgewin"]
                score["specwaste"] += sc["specwaste"]
            diag.update(score, hedged_partitions=len(hedged_parts))
        if extra_diag:
            diag.update(extra_diag)
        self._stamp(diag)
        if m is not None:
            m.incr(RESULTS, matches * repeats)
            m.incr(RTUPLES, len(rk) * repeats)
            m.incr(STUPLES, len(sk) * repeats)
            m.derive_rates()
        launched = launch_counts()
        self.last_recovery = {
            "kind": span_name, "rank": self.world.rank, "matches": matches,
            "detected_t": detected_t, "regen_s": t_regen - t0,
            "recompute_s": t_recompute - t_regen,
            "total_s": time.monotonic() - t0,
            "launches": {k: v - launched0[k] for k, v in launched.items()
                         if v != launched0[k]}}
        return JoinResult(matches=matches, ok=True,
                          partition_counts=counts_out, diagnostics=diag)

    def _regrow_join(self, r: TupleBatch, s: TupleBatch, exc, repeats: int,
                     key_bound: Optional[int] = None) -> JoinResult:
        """:class:`RankJoined` landed mid-join (``elastic_grow``): finish
        the join over the enlarged membership, the recovery engine with no
        loss at the admission's epoch.  The newcomer computes the same host
        lanes, takes its share, and the manifest merges the totals."""
        m = self.measurements
        if m is not None:
            m.event("regrow", joined_ranks=list(exc.ranks),
                    epoch=int(exc.epoch))
        epoch = max(1, int(exc.epoch), self._membership_epoch())
        return self._recover_join(
            r, s, exc, repeats, key_bound, lost_nodes=[], epoch=epoch,
            span_name="regrow",
            extra_diag={"regrown": True,
                        "joined_ranks_admitted": list(exc.ranks)})

    def _hedge_join(self, r: TupleBatch, s: TupleBatch, exc, repeats: int,
                    key_bound: Optional[int] = None) -> JoinResult:
        """:class:`StragglerDetected` (hedging on): finish the straggler's
        partitions speculatively without declaring anyone lost.  Its nodes
        leave the assignment only, the epoch stays, and where the original
        lands a partition first the hedge's line is fenced out and scores
        as SPECWASTE."""
        m = self.measurements
        strag_nodes = self._straggler_nodes(exc)
        epoch = max(self._membership_epoch(), int(exc.epoch))
        if m is not None:
            # no epoch bump stamps the ring before these records: stamp
            # the fence epoch so HEDGED and its scoring carry it
            m.flightrec.set_context(membership_epoch=epoch)
            m.incr(HEDGED)
            m.event("hedge", straggler=int(exc.rank), nodes=strag_nodes,
                    epoch=epoch, progress=int(exc.progress),
                    median=float(exc.median),
                    outstanding=int(exc.outstanding))
        return self._recover_join(
            r, s, exc, repeats, key_bound, lost_nodes=strag_nodes,
            epoch=epoch, span_name="hedge", hedge_exc=exc,
            extra_diag={"hedged": True, "straggler": int(exc.rank)})

    def _retry_backoff(self, attempt: int) -> None:
        """The pause after capacity retry ``attempt`` (``_retry_backoff``,
        hash_join.py:2495-2514): none when ``retry_backoff_s`` is 0 or no
        attempt follows; else the ``RetryPolicy`` delay of the config's
        backoff knobs (exponential, deterministic jitter), which ticks
        RETRYN, adds to BACKOFFMS and records a ``retry`` event at site
        ``engine.capacity`` before it sleeps.  Every rank sleeps the same
        delay."""
        cfg = self.config
        if cfg.retry_backoff_s <= 0 or attempt >= cfg.max_retries:
            return
        delay = RetryPolicy(max_attempts=cfg.max_retries + 1,
                            base_delay_s=cfg.retry_backoff_s,
                            multiplier=cfg.retry_backoff_mult,
                            max_delay_s=cfg.retry_backoff_max_s,
                            jitter=cfg.retry_jitter).delay_s(attempt)
        m = self.measurements
        if m is not None:
            m.incr(RETRYN)
            m.incr(BACKOFFMS, int(delay * 1000))
            m.event("retry", site="engine.capacity", attempt=attempt,
                    delay_s=round(delay, 6))
        time.sleep(delay)

    def _whole(self, b: TupleBatch) -> TupleBatch:
        """The whole relation, every rank's shard in rank order (an
        ``all_gather`` of each lane; the shards must have one size)."""
        if self.world.size == 1:
            return b
        return TupleBatch(*(None if lane is None
                            else self.world.all_gather(lane).reshape(-1)
                            for lane in b))

    def _fallback_chunked(self, r: TupleBatch, s: TupleBatch, diag: dict,
                          retries: int) -> JoinResult:
        """Degrade instead of failing (``fallback="chunked"``): the
        exchange windows could not be sized for this workload within
        ``max_retries`` doublings, so count the join out of core
        (``ops/chunked.chunked_join_count``), whose only capacity is the
        slab chosen here.  Over N ranks every rank gathers both relations
        and counts them whole, as every JAX process does.  The lanes stay
        on the device.  The diagnostics keep the attempt's flags, marked
        ``degraded="chunked"``; an error of the count is reported in
        ``fallback_error``, never raised."""
        m = self.measurements
        diag = self._stamp(dict(
            diag, failure_class=CAPACITY_OVERFLOW, degraded="chunked"))
        r, s = self._whole(r), self._whole(s)
        slab = min(FALLBACK_SLAB, s.size)
        try:
            matches = chunked_join_count(r, s, slab, key_range="auto",
                                         sort_impl=self.config.sort_impl)
        except Exception as e:   # the degraded path never raises past here
            diag["fallback_error"] = repr(e)
            diag["failure_class"] = RETRIES_EXHAUSTED
            if m is not None:
                m.stop(JTOTAL)
                m.event("fallback", path="chunked", ok=False, error=repr(e))
                m.derive_rates()
            return JoinResult(matches=0, ok=False,
                              partition_counts=np.zeros(1, np.uint32),
                              diagnostics=diag, retries=retries)
        if m is not None:
            m.stop(JTOTAL)
            m.incr(RESULTS, matches)
            m.incr(RTUPLES, r.size)
            m.incr(STUPLES, s.size)
            m.event("fallback", path="chunked", ok=True, slab=slab)
            m.derive_rates()
        return JoinResult(matches=matches, ok=True,
                          partition_counts=np.array([matches % (1 << 32)],
                                                    np.uint32),
                          diagnostics=diag, retries=retries)

    def _shuffle_plan(self, r: TupleBatch, s: TupleBatch) -> ShufflePlan:
        """The histograms (K1), their sums over the ranks and the
        assignment.  The JAX package computes them twice, in its sizing
        program (``_histogram_fn``) and again in every attempt's
        ``_shuffle``; they depend on the relations alone, so here the
        sizing pass and every attempt share one computation.  Every rank
        computes the same assignment from the same global histograms."""
        cfg = self.config
        _, r_hist = compute_local_histogram(r, cfg.network_fanout_bits,
                                            impl=cfg.partition_impl)
        _, s_hist = compute_local_histogram(s, cfg.network_fanout_bits,
                                            impl=cfg.partition_impl)
        r_ghist = compute_global_histogram(r_hist, self.world)
        s_ghist = compute_global_histogram(s_hist, self.world)
        return ShufflePlan(r_hist, s_hist, r_ghist, s_ghist,
                           compute_partition_assignment(
                               r_ghist, s_ghist, cfg.num_nodes,
                               cfg.assignment_policy))

    def _sizing_demands(self, plan: ShufflePlan, hot_bits: int = 0):
        """The sizing pass (``_histogram_fn`` without the codec's key max):
        this rank's per-destination send demand of each relation, int64
        [num_nodes] on the device, from ``plan``'s assignment; with a hot
        set its partitions leave the local histograms."""
        n = self.config.num_nodes
        assignment = plan.assignment
        dest_onehot = (widen(assignment)[None, :]
                       == torch.arange(n, device=assignment.device)[:, None])
        hists = (plan.r_hist, plan.s_hist)
        if hot_bits:
            hists = tuple(mask_hot(h, hot_bits) for h in hists)
        return tuple(torch.where(dest_onehot, widen(h)[None, :], 0).sum(dim=1)
                     for h in hists)

    def _masked_plan(self, plan: ShufflePlan, hot_bits: int) -> ShufflePlan:
        """``plan`` with the assignment computed from the global histograms
        with the hot partitions masked (``_shuffle``'s skew branch,
        hash_join.py:1217-1220): the hot partitions leave the assignment.
        The masked and the unmasked assignments spread the same total over
        the ranks differently, so the sizing pass and every attempt take
        this one."""
        cfg = self.config
        return plan._replace(assignment=compute_partition_assignment(
            mask_hot(plan.r_ghist, hot_bits), mask_hot(plan.s_ghist, hot_bits),
            cfg.num_nodes, cfg.assignment_policy))

    def _measure_capacities(self, r: TupleBatch, s: TupleBatch,
                            plan: ShufflePlan):
        """(cap_r, cap_s, skew): the static exchange block sizes — the next
        power of two at or above the worst (sender, destination) demand over
        all ranks (``all_reduce`` max), or the ``allocation_factor``
        estimate of the largest shard with ``window_sizing="static"`` — and
        the skew split (``hash_join.py:449-490``).

        ``skew`` is None, or a :class:`SkewPlan` when ``skew_threshold`` is
        set, the world has more than one rank and
        ``detect_hot_partitions`` finds hot partitions in the all-reduced
        global histograms (the same decision on every rank).  A second
        sizing pass then measures the split routing (``_histogram_fn``'s hot
        branch, :264-330): the masked demands under the masked assignment,
        the spread outer tuples added to the outer demand (K1 over their
        spread ranks), and ``hot_cap`` from the worst rank's hot inner
        count.  When the join may pack its exchange, the key lanes' maxima
        ride the demands' ``all_reduce`` and set the measured key bound
        (``hash_join.py:318-324``)."""
        cfg = self.config
        n = self.world.size
        if cfg.window_sizing == "static":
            sizes = self.world.all_reduce(torch.tensor(
                [r.size, s.size], dtype=torch.int64, device=self.device),
                op="max").cpu()
            return (cfg.shuffle_block_capacity(int(sizes[0])),
                    cfg.shuffle_block_capacity(int(sizes[1])), None)

        def cap(demand):
            worst = max(1, int(demand.max()))
            return max(8, 1 << (worst - 1).bit_length())

        packs = cfg.exchange_codec != "off" and n > 1
        reduced = torch.stack(self._sizing_demands(plan)).reshape(-1)
        if packs:
            reduced = torch.cat([reduced, self._key_maxima(r, s)])
        reduced = self.world.all_reduce(reduced, op="max")
        split = cfg.skew_threshold is not None and n > 1
        # one readback: the demands, the key maxima and the global histograms
        host = (torch.cat([reduced, widen(plan.r_ghist), widen(plan.s_ghist)])
                if split else reduced).cpu().numpy()
        off = 2 * n
        if packs:
            self._measured_key_bound = self._bound_of(host[off:off + 2])
            off += 2
        if not split:
            return cap(host[:n]), cap(host[n:2 * n]), None
        num_p = cfg.network_partition_count
        hot = detect_hot_partitions(host[off:off + num_p],
                                    host[off + num_p:], cfg.skew_threshold,
                                    num_nodes=n)
        if not hot.any():
            return cap(host[:n]), cap(host[n:2 * n]), None
        hot_bits = hot_mask_bits(hot)
        hot_plan = self._masked_plan(plan, hot_bits)
        r_demand, s_demand = self._sizing_demands(hot_plan, hot_bits)
        fanout = cfg.network_fanout_bits
        spread = local_histogram(
            spread_destinations(s.rid, n), n,
            is_hot(partition_ids(s, fanout), hot_bits),
            impl=cfg.partition_impl)
        hot_count = is_hot(partition_ids(r, fanout), hot_bits).sum()
        host = self.world.all_reduce(
            torch.cat([r_demand, s_demand + widen(spread),
                       hot_count.reshape(1)]), op="max").cpu()
        return (cap(host[:n]), cap(host[n:2 * n]),
                SkewPlan(hot_bits, cap(host[2 * n:]), hot_plan))

    @staticmethod
    def _keys_in_contract(r: TupleBatch, s: TupleBatch,
                          narrow_route: bool) -> torch.Tensor:
        """0-d bool: every key of this rank's shards below the narrow sort
        probe's packing cap (``MAX_MERGE_KEY``, judged on the signed
        (min, max) of each lane), or below the pads on every other route."""
        if narrow_route:
            st = torch.stack([_minmax_i32(r.key), _minmax_i32(s.key)])
            return (st[:, 0] >= 0).all() & (st[:, 1] <= MAX_MERGE_KEY).all()
        return ((umax(_sentinel_lane(r)) < R_PAD_KEY)
                & (umax(_sentinel_lane(s)) < R_PAD_KEY))

    def _shuffle(self, r: TupleBatch, s: TupleBatch, plan: ShufflePlan,
                 win_r: Window, win_s: Window,
                 skew: Optional[SkewPlan] = None) -> Shuffled:
        """Exchange and conservation checks (``_shuffle``, hash_join.py:
        1187-1306, on the histograms and assignment of ``plan``).

        With a ``skew`` plan the hot partitions take the split route
        (operators/skew.py; the skew branch, :1212-1255) on ``skew.plan``'s
        masked assignment: hot inner tuples leave the exchange and are
        extracted into one block of ``hot_cap`` slots (K4, one group),
        ``all_gather``ed into ``hot_batch``; hot outer tuples go to their
        spread ranks.  The outer conservation target is this rank's
        assigned non-hot share plus its slice of the all-reduced spread
        histogram (K1 over the spread ranks); the hot inner conservation is
        the gathered hot count against the hot slice of the global
        histogram.  Every rank takes the same branch and issues the same
        collectives: the split's sums share one ``all_reduce``, where JAX
        takes four ``psum``s."""
        cfg = self.config
        fanout = cfg.network_fanout_bits
        if skew is None:
            rp = network_partition(r, fanout, plan.assignment, win_r)
            sp = network_partition(s, fanout, plan.assignment, win_s)
            lost_r, bad_r = win_r.diagnostics(rp, plan.r_ghist,
                                              plan.assignment)
            lost_s, bad_s = win_s.diagnostics(sp, plan.s_ghist,
                                              plan.assignment)
            hot_batch = hot_overflow = None
        else:
            n, me = self.world.size, self.world.rank
            hot_bits, hot_cap, plan = skew
            assignment = plan.assignment
            r_gh_eff = mask_hot(plan.r_ghist, hot_bits)
            s_gh_eff = mask_hot(plan.s_ghist, hot_bits)
            r_pid = partition_ids(r, fanout)
            is_hot_r = is_hot(r_pid, hot_bits)
            is_hot_s = is_hot(partition_ids(s, fanout), hot_bits)
            dest_spread = spread_destinations(s.rid, n)
            rp = network_partition(r, fanout, assignment, win_r,
                                   exclude=is_hot_r)
            sp = network_partition(s, fanout, assignment, win_s,
                                   override=(is_hot_s, dest_spread))
            # replicate the hot build side: this rank's block, gathered
            hot_blocks, hot_counts, hot_ovf = scatter_to_blocks(
                r, torch.zeros_like(r_pid), 1, hot_cap, "inner",
                valid=is_hot_r, impl=cfg.partition_impl)
            hot_batch = TupleBatch(*(
                None if lane is None
                else self.world.all_gather(lane).reshape(-1)
                for lane in hot_blocks))
            lost_r, bad_r = win_r.diagnostics(rp, r_gh_eff, assignment)
            # the spread histogram, the extraction overflow, the extracted
            # count and the outer overflow, summed in one all_reduce
            summed = self.world.all_reduce(torch.cat([
                widen(local_histogram(dest_spread, n, is_hot_s,
                                      impl=cfg.partition_impl)),
                hot_ovf.reshape(1),
                torch.clamp(widen(hot_counts[:1]), max=hot_cap),
                sp.send_overflow.reshape(1)]))
            hot_overflow, hot_got, lost_s = summed[n:n + 3]
            mine = widen(assignment) == me
            expected_s = (torch.where(mine, widen(s_gh_eff), 0).sum()
                          + summed[me])
            bad_s = (sp.recv_counts.sum() != expected_s) & (lost_s == 0)
            hot_want = widen(plan.r_ghist).sum() - widen(r_gh_eff).sum()
            bad_r = bad_r | ((hot_got != hot_want) & (hot_overflow == 0))
        if cfg.debug_checks:
            bad_r = bad_r | self._debug_checks(
                rp, sp, plan, lost_r, lost_s,
                0 if skew is None else skew.hot_bits)
        return Shuffled(rp, sp, lost_r, lost_s,
                        bad_r.to(torch.int64) + bad_s.to(torch.int64),
                        hot_batch, hot_overflow)

    def _debug_checks(self, rp, sp, plan: ShufflePlan, lost_r: torch.Tensor,
                      lost_s: torch.Tensor, hot_bits: int = 0
                      ) -> torch.Tensor:
        """``debug_checks`` (hash_join.py:1269-1302), 0-d bool:
        per-partition conservation — the valid received tuples of each
        partition (K1 over the receive buffer) equal its global histogram
        entry where this rank owns it and 0 elsewhere, judged where nothing
        overflowed — and the OffsetMap invariant ``relative + local <=
        global`` (histograms/offset_map.py), which a disagreement between
        the ``all_reduce`` and the ``all_gather`` would break.  Under the
        skew split the hot rows are left out of the first check (hot inner
        tuples are withheld, hot outer ones land by their spread), and the
        expectation reads the masked histograms."""
        num_p = self.config.network_partition_count
        mine = widen(plan.assignment) == self.world.rank
        rows = torch.arange(num_p, dtype=torch.int32, device=self.device)
        cold = ~is_hot(rows, hot_bits)
        bad = torch.zeros((), dtype=torch.bool, device=self.device)
        for part, ghist, lost in ((rp, plan.r_ghist, lost_r),
                                  (sp, plan.s_ghist, lost_s)):
            got = widen(local_histogram(part.pid, num_p, part.valid,
                                        impl=self.config.partition_impl))
            want = torch.where(mine, widen(mask_hot(ghist, hot_bits)), 0)
            bad = bad | (((got != want) & cold).any() & (lost == 0))
        for lhist, ghist in ((plan.r_hist, plan.r_ghist),
                             (plan.s_hist, plan.s_ghist)):
            offs = compute_offsets(lhist, ghist, plan.assignment, self.world)
            bad = bad | (widen(offs.relative) + widen(lhist)
                         > widen(ghist)).any()
        return bad

    def _bucket_caps(self, cap_r: int, cap_s: int, local_slack: int,
                     hot_total: int = 0):
        """Per-bucket capacities of the second radix pass.  Under the skew
        split the replicated hot inner side (``hot_total`` = n * hot_cap
        gathered slots) rides the inner pass too (hash_join.py:925-935)."""
        cfg = self.config
        n, nb = cfg.num_nodes, cfg.local_partition_count
        return (cfg.bucket_capacity(n * cap_r + hot_total, nb) * local_slack,
                cfg.bucket_capacity(n * cap_s, nb) * local_slack)

    @staticmethod
    def _concat_hot(batch: TupleBatch,
                    hot_batch: Optional[TupleBatch]) -> TupleBatch:
        """``batch`` with the replicated hot inner side appended
        (``_concat_hot``, hash_join.py:349); no-op without a skew plan."""
        if hot_batch is None:
            return batch
        return TupleBatch(*(None if lane is None
                            else torch.cat([lane, hot_lane])
                            for lane, hot_lane in zip(batch, hot_batch)))

    @classmethod
    def _concat_hot_valid(cls, batch: TupleBatch, valid: torch.Tensor,
                          hot_batch: Optional[TupleBatch]):
        """(batch + hot, valid + hot valid) for the second radix pass
        (``_concat_hot_valid``, hash_join.py:349-371): the hot block's pad
        slots hold the inner sentinel, so its validity is the sentinel
        test.  No-op without a skew plan."""
        if hot_batch is None:
            return batch, valid
        return (cls._concat_hot(batch, hot_batch),
                torch.cat([valid, valid_mask(hot_batch, "inner")]))

    @staticmethod
    def _guarded_bucket_counts(inner_rows: torch.Tensor,
                               outer_rows: torch.Tensor,
                               inner_hi: Optional[torch.Tensor] = None,
                               outer_hi: Optional[torch.Tensor] = None,
                               run=None, sort_impl: str = "auto"):
        """(counts, count-overflow risk): a bucket's count is at most
        lcap_r * lcap_s, so the max-weight bound runs only when that
        product can reach 2**32.  64-bit keys add their hi-lane rows;
        ``run`` times the sort-merge's stages."""
        lcap_r, lcap_s = inner_rows.shape[1], outer_rows.shape[1]
        if lcap_r * lcap_s < 1 << 32:
            return (probe_count_bucketized(inner_rows, outer_rows, inner_hi,
                                           outer_hi, run=run,
                                           sort_impl=sort_impl),
                    torch.zeros((), dtype=torch.bool, device=inner_rows.device))
        counts, maxw = probe_count_bucketized(inner_rows, outer_rows, inner_hi,
                                              outer_hi, return_max_weight=True,
                                              run=run, sort_impl=sort_impl)
        return counts, widen(maxw) > 0xFFFFFFFF // lcap_s

    def _local_partition(self, rp, sp, cap_r: int, cap_s: int,
                         local_slack: int,
                         hot_batch: Optional[TupleBatch] = None):
        """The second radix pass of both received relations (K4), the
        replicated hot inner side with the inner one: (inner blocks, outer
        blocks), each with its overflow."""
        cfg = self.config
        hot_total = 0 if hot_batch is None else hot_batch.size
        lcap_r, lcap_s = self._bucket_caps(cap_r, cap_s, local_slack,
                                           hot_total)
        inner, inner_valid = self._concat_hot_valid(rp.batch, rp.valid,
                                                    hot_batch)
        return (local_partition(inner, inner_valid, cfg.network_fanout_bits,
                                cfg.local_fanout_bits, lcap_r, "inner",
                                impl=cfg.partition_impl),
                local_partition(sp.batch, sp.valid, cfg.network_fanout_bits,
                                cfg.local_fanout_bits, lcap_s, "outer",
                                impl=cfg.partition_impl))

    def _bucket_probe(self, lr, ls, run=None):
        """The bucketized probe of the local partitions: (per-bucket
        counts, count-overflow risk)."""
        nb = self.config.local_partition_count
        lcap_r = lr.blocks.key.numel() // nb
        lcap_s = ls.blocks.key.numel() // nb
        hi = (None, None) if lr.blocks.key_hi is None else (
            lr.blocks.key_hi.view(nb, lcap_r), ls.blocks.key_hi.view(nb, lcap_s))
        return self._guarded_bucket_counts(
            lr.blocks.key.view(nb, lcap_r), ls.blocks.key.view(nb, lcap_s), *hi,
            run=run, sort_impl=self.config.sort_impl)

    def _local_process(self, rp, sp, cap_r: int, cap_s: int,
                       local_slack: int,
                       hot_batch: Optional[TupleBatch] = None,
                       checksums: bool = False):
        """The bucket branch of ``_local_process``: the second radix pass
        of both received relations (and the hot inner side), then the
        bucketized probe.  Returns (per-bucket counts, local overflow,
        count-overflow risk, checksum sets or None).  With ``checksums``
        (verify) and no skew plan the sets are the world fingerprints of
        the inner and outer blocks (hash_join.py:1114-1152), so a tuple the
        second pass damaged is caught too; the replicated hot inner side
        would make the blocks incomparable with the pre-exchange
        fingerprint, so a split join takes none."""
        cfg = self.config
        lr, ls = self._local_partition(rp, sp, cap_r, cap_s, local_slack,
                                       hot_batch)
        counts, risk = self._bucket_probe(lr, ls)
        sets = None
        if checksums and hot_batch is None:
            sets = [global_partition_checksums(
                        b.key, partition_ids(b, cfg.network_fanout_bits),
                        cfg.network_partition_count, self.world,
                        valid=valid_mask(b, side), key_hi=b.key_hi,
                        sort_impl=cfg.sort_impl)
                    for b, side in ((lr.blocks, "inner"),
                                    (ls.blocks, "outer"))]
        return counts, lr.overflow + ls.overflow, risk, sets

    def _local_probe(self, rp, sp, route: Optional[str],
                     s_ghist: torch.Tensor,
                     hot_batch: Optional[TupleBatch] = None):
        """The non-bucket branch of ``_local_process`` (hash_join.py:
        1154-1185): on the pad-filled receive buffers, the chunked probe
        with ``chunk_size`` (whole keys, ``probe_count_chunked``), else the
        sort probe — narrow (K2 then K3), full (K2 then K5) or wide (K2
        with three lanes, then K5).  The pads sort with the tuples and
        match nothing.  Under the skew split the replicated hot inner keys
        join the inner lanes (the lo lane, and the hi lane of 64-bit keys);
        their pads are inner sentinels and weigh nothing.  The
        overflow-risk bound reads the shuffle's unmasked global outer
        histogram, the same on every rank.  Returns (per-partition counts,
        local overflow 0, count-overflow risk)."""
        cfg = self.config
        fanout = cfg.network_fanout_bits
        r, s = rp.batch, sp.batch
        r_key, r_hi = r.key, r.key_hi
        if hot_batch is not None:
            # the chunked probe excludes the split (JoinConfig)
            r_key = torch.cat([r_key, hot_batch.key])
            if r_hi is not None:
                r_hi = torch.cat([r_hi, hot_batch.key_hi])
        if cfg.chunk_size:
            counts, maxw = probe_count_chunked(
                _as_compressed(r), _as_compressed(s), sp.pid,
                cfg.network_partition_count, cfg.chunk_size,
                return_max_weight=True, sort_impl=cfg.sort_impl)
        elif route == "wide":
            counts, maxw = merge_count_wide_per_partition(
                r_key, r_hi, s.key, s.key_hi, fanout,
                return_max_weight=True, sort_impl=cfg.sort_impl)
        elif route == "full":
            counts, maxw = merge_count_per_partition_full(
                r_key, s.key, fanout, return_max_weight=True,
                sort_impl=cfg.sort_impl)
        else:
            counts, maxw = merge_count_per_partition(
                r_key, s.key, fanout, return_max_weight=True,
                sort_impl=cfg.sort_impl)
        limit = 0xFFFFFFFF // torch.clamp(widen(maxw), min=1)
        zero = torch.zeros((), dtype=torch.int64, device=counts.device)
        return counts, zero, (widen(s_ghist) > limit).any()

    def _split_local(self, rp, sp, route: Optional[str], s_ghist,
                     cap_r: int, cap_s: int, local_slack: int, dts: dict,
                     hot_batch: Optional[TupleBatch] = None):
        """Local processing fenced into its phases (``measure_phases``,
        ``_run_split``, hash_join.py:764-860): on the bucket path SLOCPREP
        for the second radix pass, then JPROC over the probe, with BPBUILD
        and BPPROBE for the sort-merge's row sort and scan (a dense probe
        is all BPPROBE); elsewhere JPROC over the local probe.  The skew
        split's hot inner side goes where the fused attempt takes it
        (:776-786)."""
        cfg = self.config
        m = self.measurements
        if not cfg.bucket_path:
            m.start(JPROC)
            out = self._local_probe(rp, sp, route, s_ghist, hot_batch)
            dts[JPROC] = m.stop(JPROC, fence=out)
            return out
        m.start(SLOCPREP)
        lr, ls = self._local_partition(rp, sp, cap_r, cap_s, local_slack,
                                       hot_batch)
        dts[SLOCPREP] = m.stop(SLOCPREP, fence=(lr.blocks, ls.blocks))
        nb, n = cfg.local_partition_count, self.world.size
        lcap_r = lr.blocks.key.numel() // nb
        lcap_s = ls.blocks.key.numel() // nb
        # the capacity-padded slots the build and probe stages process
        m.incr(BPBUILDTUPLES, n * nb * lcap_r)
        m.incr(BPPROBETUPLES, n * nb * lcap_s)
        dense = max(lcap_r, lcap_s) <= DENSE_BUCKET_LIMIT
        m.start(JPROC)
        counts, risk = self._bucket_probe(
            lr, ls, run=None if dense else self._stage(dts))
        dts[JPROC] = m.stop(JPROC, fence=counts)
        if dense:
            m.add_time_us(BPPROBE, dts[JPROC])
            dts[BPPROBE] = dts[JPROC]
        return counts, lr.overflow + ls.overflow, risk

    def _check_receive(self, cap_r: int, cap_s: int,
                       skew: Optional[SkewPlan]) -> None:
        n = self.world.size
        hot_cap = 0 if skew is None else skew.hot_cap
        if n * (cap_r + cap_s + hot_cap) >= 1 << 31:
            raise ValueError(
                f"the receive buffers hold {n} * ({cap_r} + {cap_s} + "
                f"{hot_cap}) positions; the joins count positions in 32 "
                "bits")

    def _shuffled_attempt(self, r: TupleBatch, s: TupleBatch,
                          plan: ShufflePlan, route: Optional[str], cap_r: int,
                          cap_s: int, local_slack: int,
                          skew: Optional[SkewPlan] = None, repeats: int = 1,
                          verify: bool = False):
        """One attempt at the given capacities (and the skew split's
        ``hot_cap``), or ``repeats`` of them with no readback between them:
        (per-rank per-partition uint32 counts [N * P] in rank order, uint32
        [7] flags summed over the ranks, both from the last attempt's one
        readback; the phase times it recorded; with ``verify`` the uint32
        checksum sets [sets, rows, P] of the same readback, else None).  By
        default JPROC spans the attempts and ends at the readback; with
        ``measure_phases`` the shuffle is JMPI and local processing is
        fenced into its phases (:meth:`_split_local`).  Flag slot 5 is the
        split's hot inner overflow."""
        cfg = self.config
        m = self.measurements
        split = m is not None and cfg.measure_phases
        dts = {}
        self._check_receive(cap_r, cap_s, skew)
        if m is not None:
            m.start(JMPI if split else JPROC)
        for _ in range(repeats):
            out = self._attempt_on_device(r, s, plan, route, cap_r, cap_s,
                                          local_slack, skew, dts, verify)
        host = (out.cpu().numpy() & 0xFFFFFFFF).astype(np.uint32)
        if m is not None and not split:
            dts[JPROC] = m.stop(JPROC)   # the readback has fenced it
        vchk = None
        if verify:
            sets = 4 if cfg.bucket_path and skew is None else 2
            shape = (sets, checksum_rows(r.key_hi is not None),
                     cfg.network_partition_count)
            vchk = host[host.size - int(np.prod(shape)):].reshape(shape)
            host = host[:host.size - vchk.size]
        return host[7:], host[:7], dts, vchk

    def _attempt_on_device(self, r: TupleBatch, s: TupleBatch,
                           plan: ShufflePlan, route: Optional[str],
                           cap_r: int, cap_s: int, local_slack: int,
                           skew: Optional[SkewPlan], dts: dict,
                           verify: bool = False) -> torch.Tensor:
        """An attempt's work up to its readback: int64 [7 + N * P], the
        flags summed over the ranks and the gathered counts, then with
        ``verify`` the flattened checksum sets — what the exchange
        delivered (``receive_checksums``, hash_join.py:621-628) and on the
        bucket path the second pass's blocks.  Under ``measure_phases``
        its phases are fenced and timed into ``dts``."""
        cfg = self.config
        m = self.measurements
        split = m is not None and cfg.measure_phases
        keys_ok = self._keys_in_contract(r, s, route == "narrow")
        sh = self._shuffle(r, s, plan, *self._make_windows(cap_r, cap_s),
                           skew)
        rp, sp, hot = sh.rp, sh.sp, sh.hot_batch
        sets = None
        if split:
            # the exchange's completion wait, nested in JMPI
            shuffled = (rp.batch, sp.batch, sh.lost_r, sh.lost_s, sh.bad,
                        keys_ok, hot)
            m.start(SNETCOMPL)
            dts[SNETCOMPL] = m.stop(SNETCOMPL, fence=shuffled)
            dts[JMPI] = m.stop(JMPI, fence=shuffled)
            counts, local_overflow, risk = self._split_local(
                rp, sp, route, plan.s_ghist, cap_r, cap_s, local_slack, dts,
                hot)
        elif cfg.bucket_path:
            counts, local_overflow, risk, sets = self._local_process(
                rp, sp, cap_r, cap_s, local_slack, hot, checksums=verify)
        else:
            counts, local_overflow, risk = self._local_probe(
                rp, sp, route, plan.s_ghist, hot)
        summed = self.world.all_reduce(torch.stack([
            (~keys_ok).to(torch.int64), sh.bad, widen(local_overflow),
            risk.to(torch.int64)]))
        hot_overflow = (torch.zeros((), dtype=torch.int64,
                                    device=summed.device)
                        if sh.hot_overflow is None else sh.hot_overflow)
        flags = torch.stack([summed[0], sh.lost_r, sh.lost_s, summed[1],
                             summed[2], hot_overflow, summed[3]])
        out = [flags, widen(self.world.all_gather(counts).reshape(-1))]
        if verify:
            num_p = cfg.network_partition_count
            sets = [receive_checksums(rp, num_p, self.world),
                    receive_checksums(sp, num_p, self.world)] + (sets or [])
            out.append(widen(torch.stack(sets)).reshape(-1))
        return torch.cat(out)

    # ------------------------------------------------- materializing join
    def _materialize_join(self, r: TupleBatch,
                          s: TupleBatch) -> MaterializedJoinResult:
        """The retry loop of the materializing join
        (``join_materialize_arrays``, hash_join.py:2737-2823)."""
        cfg = self.config
        m = self.measurements
        self._measured_key_bound = None
        plan, cap_r, cap_s, skew, _ = self._sized(r, s)
        self._xplan = self._resolve_exchange_plan(r, s, None)
        rate_cap = cfg.match_rate_cap
        for attempt in range(cfg.max_retries + 1):
            mm, flags, dts = self._materialize_attempt(
                r, s, plan, cap_r, cap_s, rate_cap, skew)
            caps = (cap_r, cap_s)   # the attempt the result comes from
            flags = self._inject_shuffle_fault(flags)
            diag = self._flags_to_diag(flags)
            if not flags.any() or not self._retryable(diag):
                break
            if diag["shuffle_overflow_r_tuples"]:
                cap_r *= 2
            if diag["shuffle_overflow_s_tuples"]:
                cap_s *= 2
            if diag["local_overflow"]:   # the match cap fell short
                rate_cap *= 2
            if diag["hot_overflow"]:
                skew = skew._replace(hot_cap=2 * skew.hot_cap)
            if m is not None and attempt < cfg.max_retries:
                self._rollback_attempt(m, dts)
        r_rid, s_rid = self._gather_pairs(mm)
        self._finish(r, s, r_rid.size, caps)
        return MaterializedJoinResult(
            r_rid=r_rid, s_rid=s_rid, matches=int(r_rid.size),
            ok=not flags.any(), diagnostics=self._stamp(diag),
            retries=attempt)

    def _materialize_attempt(self, r: TupleBatch, s: TupleBatch,
                             plan: ShufflePlan, cap_r: int, cap_s: int,
                             rate_cap: int, skew: Optional[SkewPlan]):
        """One materializing attempt (``_materialize_fn``, hash_join.py:
        1308-1352): the exchange, then the materializing probe of the
        receive buffers (the hot inner side appended to the inner one), and
        one readback of the six flags.  The pairs stay on the device.
        Returns (MaterializedMatches, uint32 [6] flags summed over the
        ranks, the phase times).  JPROC spans the attempt; with
        ``measure_phases`` the exchange is JMPI (SNETCOMPL nested) and
        JPROC the probe (``_run_split_materialize``, :900-926)."""
        cfg = self.config
        m = self.measurements
        split = m is not None and cfg.measure_phases
        dts = {}
        self._check_receive(cap_r, cap_s, skew)
        if m is not None:
            m.start(JMPI if split else JPROC)
        keys_ok = self._keys_in_contract(r, s, False)
        sh = self._shuffle(r, s, plan, *self._make_windows(cap_r, cap_s),
                           skew)
        if split:
            shuffled = (sh.rp.batch, sh.sp.batch, sh.lost_r, sh.lost_s,
                        sh.bad, keys_ok, sh.hot_batch)
            m.start(SNETCOMPL)
            dts[SNETCOMPL] = m.stop(SNETCOMPL, fence=shuffled)
            dts[JMPI] = m.stop(JMPI, fence=shuffled)
            m.start(JPROC)
        inner = _as_compressed(self._concat_hot(sh.rp.batch, sh.hot_batch))
        outer = _as_compressed(sh.sp.batch)
        if cfg.chunk_size:
            mm = probe_materialize_chunked(inner, outer, rate_cap,
                                           cfg.chunk_size,
                                           sort_impl=cfg.sort_impl)
        else:
            mm = probe_materialize(inner, outer, rate_cap,
                                   sort_impl=cfg.sort_impl)
        if split:
            dts[JPROC] = m.stop(JPROC, fence=mm)
        summed = self.world.all_reduce(torch.stack([
            (~keys_ok).to(torch.int64), sh.bad, mm.overflow]))
        hot_overflow = (torch.zeros((), dtype=torch.int64,
                                    device=summed.device)
                        if sh.hot_overflow is None else sh.hot_overflow)
        host = torch.stack([summed[0], sh.lost_r, sh.lost_s, summed[1],
                            summed[2], hot_overflow]).cpu().numpy()
        if m is not None and not split:
            dts[JPROC] = m.stop(JPROC)   # the readback has fenced it
        return mm, (host & 0xFFFFFFFF).astype(np.uint32), dts

    def _gather_pairs(self, mm: MaterializedMatches):
        """(r_rid, s_rid), uint32 numpy arrays of every rank's valid pairs,
        rank-major and in row order within a rank.  The pairs are
        compacted on the device, so only they are read back.  Over several
        ranks two collectives: the ranks' pair counts, then the two lanes
        of every rank in one [2, most] block."""
        pairs = torch.stack([torch.masked_select(mm.r_rid, mm.valid),
                             torch.masked_select(mm.s_rid, mm.valid)])
        if self.world.size > 1:
            counts = self.world.all_gather(torch.tensor(
                [pairs.shape[1]], dtype=torch.int64,
                device=pairs.device)).reshape(-1).tolist()
            block = pairs.new_zeros((2, max(counts)))
            block[:, :pairs.shape[1]] = pairs
            blocks = self.world.all_gather(block)
            pairs = torch.cat([b[:, :c] for b, c in zip(blocks, counts)],
                              dim=1)
        return lane_to_numpy(pairs[0]), lane_to_numpy(pairs[1])

    def place(self, rel: Relation) -> TupleBatch:
        """This rank's shard of a relation on the engine's device:
        generated there, or with ``generation="host"`` generated by numpy
        (``Relation.shard_np``) and copied there (``place``,
        hash_join.py:2838-2891); the same bits either way."""
        if rel.num_nodes != self.config.num_nodes:
            raise ValueError("relation num_nodes must match config.num_nodes")
        if rel.key_bits != self.config.key_bits:
            raise ValueError(
                f"config.key_bits={self.config.key_bits} but the relation "
                f"generates {rel.key_bits}-bit keys")
        if self.config.generation == "host":
            lanes = [lane_from_numpy(a, self.device)
                     for a in rel.shard_np(self.world.rank)]
            batch = TupleBatch(key=lanes[0], rid=lanes[-1],
                               key_hi=lanes[1] if len(lanes) == 3 else None)
        else:
            batch = rel.shard(self.world.rank, self.device)
        if self.device.type == "cuda":
            # generation and copies are asynchronous: they must not finish
            # inside a later join's timers
            torch.cuda.synchronize(self.device)
        return batch

    def join(self, inner: Relation, outer: Relation) -> JoinResult:
        """Join two relation specs; their static key bounds resolve
        ``key_range="auto"`` without the device max-key probe, and an
        elastic recovery regenerates them on the host."""
        from tpu_radix_join_torch.robustness.recovery import relation_inputs
        prev, self.elastic_inputs = (self.elastic_inputs,
                                     relation_inputs(inner, outer))
        try:
            return self.join_arrays(
                self.place(inner), self.place(outer),
                key_bound=max(inner.key_bound(), outer.key_bound()))
        finally:
            self.elastic_inputs = prev

    def join_materialize(self, inner: Relation,
                         outer: Relation) -> MaterializedJoinResult:
        """The matching rid pairs of two relation specs
        (:meth:`join_materialize_arrays`)."""
        return self.join_materialize_arrays(self.place(inner),
                                            self.place(outer))
