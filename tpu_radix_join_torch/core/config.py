"""Typed runtime configuration of the port.

The port's own copy of the fields of ``tpu_radix_join/core/config.py`` that
its joins read — the sort probe and the partitioned (bucket / two-level)
join, on one GPU or over ``num_nodes`` ranks of a ``torch.distributed``
process group — each with the JAX package's default, and the derived
geometry (``config.py:300-383``; ``mesh_axes`` is not applicable, as
``parallel/world.py`` takes the mesh's place).  A setting the port does
not run yet raises ``NotImplementedError`` naming the ROADMAP item that
will port it; nothing falls back quietly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

#: JAX's ``partition_impl`` and ``sort_impl`` choices (``ops/radix.py``,
#: ``ops/sorting.py`` and ``main.py`` read these two tuples)
PARTITION_IMPLS = ("auto", "sort", "pallas", "pallas_interpret")
SORT_IMPLS = ("auto", "xla", "pallas", "pallas_interpret")


def _expected(choices) -> str:
    """JAX's wording of a choice list: ``'a', 'b', or 'c'``."""
    return ", ".join(map(repr, choices[:-1])) + f", or {choices[-1]!r}"


def _not_ported(setting: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{setting} is not ported to PyTorch yet (ROADMAP.md {item})")


@dataclasses.dataclass(frozen=True)
class JoinConfig:
    """Knobs of the joins.

      * ``num_nodes``: the ranks of the process group the join runs over
        (``HashJoin(config, group=...)``); 1 is the one-GPU join.
      * ``debug_checks``: the shuffle's per-partition conservation check and
        the OffsetMap invariant (``hash_join.py:1269-1302``), one K1 pass
        over each receive buffer and two ``all_gather``s a join attempt.
      * ``chunk_size``: the sort probe after the shuffle streams the outer
        receive buffer in slabs of this many slots against the inner one
        (``ops/build_probe.probe_count_chunked``, the reference's
        large-data probe); the generic body then runs at one rank too.
      * ``measure_phases``: the engine fences each attempt into JMPI
        (SNETCOMPL nested), SLOCPREP and BPBUILD/BPPROBE on the bucket path,
        and JPROC, recorded in its ``Measurements`` registry; by default
        JPROC covers the attempt and no fence is added.

      * ``network_fanout_bits`` -> NETWORK_PARTITIONING_FANOUT
        (Configuration.h:30): the sort probe reports 1 << bits partition
        counts, and the shuffle routes by those bits.
      * ``local_fanout_bits`` -> LOCAL_PARTITIONING_FANOUT
        (Configuration.h:31): the buckets of the second radix pass, whose
        counts the partitioned join reports.
      * ``probe_algorithm="bucket"`` or ``two_level`` select the
        partitioned join (histograms, window sizing, exchange, local radix
        partition, bucketized build/probe); otherwise the sort probe runs.
      * ``key_bits``: 32 keys ride one uint32 lane; 64 adds the ``key_hi``
        lane, and the sort probe then always counts on the wide three-lane
        order (lo rotated, hi, tag) with K5.
      * ``key_range`` picks the 32-bit sort probe's discipline: "narrow"
        always takes the packed 31-bit probe (K3) and flags larger keys;
        "full" always takes the two-lane full-range probe (K5 with no hi
        lane), exact for every key below the pads; "auto" decides per join
        from the relations' key bounds (or the device max key for raw
        lanes).  64-bit keys and the partitioned join take every key below
        the pads and ignore it.
      * ``window_sizing``: "measured" sizes the exchange blocks from a
        histogram pass, "static" from ``allocation_factor`` alone.
      * ``sort_impl`` / ``partition_impl``: JAX's implementation choice
        (``ops/sorting``, ``ops/radix``).  "auto", "pallas" and
        "pallas_interpret" run the hand-written kernels (K2; K1 and K4) at
        every fanout; ``sort_impl="xla"`` and ``partition_impl="sort"`` are
        the library baseline arms (stable ``torch.sort``; a stable
        ``argsort`` and ``bincount``), counted apart and named in a join's
        ``diagnostics["baseline_arms"]``.
      * ``max_retries``: capacity-shortfall retries, each doubling what fell
        short; the sort probe has no capacity and never retries.
      * ``retry_backoff_s``, ``retry_backoff_mult``, ``retry_backoff_max_s``
        and ``retry_jitter``: the pause after each capacity retry but the
        last (``HashJoin._retry_backoff``, ``hash_join.py:2495-2514``):
        ``min(retry_backoff_s * retry_backoff_mult**k,
        retry_backoff_max_s)`` after attempt k, scaled by the deterministic
        jitter of ``robustness/retry.RetryPolicy``; 0 is no pause.
      * ``skew_threshold``: the skew split (operators/skew.py): a partition
        whose global outer weight passes this multiple of the mean total
        weight, and whose inner side is cheap to replicate, has its inner
        tuples replicated to every rank (``all_gather``) and its outer
        tuples spread over the ranks by a hash of the rid.  Needs
        ``network_fanout_bits <= 5``, measured window sizing and no
        ``chunk_size``; a one-rank join never splits.  None is off.
      * ``num_hosts``: the ranks form a host-major ``[num_hosts, num_nodes
        / num_hosts]`` grid and every exchange takes the hierarchical
        route, within each host first and then across the hosts
        (``parallel/world.hierarchical_block_all_to_all``).
      * ``fallback="chunked"``: a partitioned join still short of capacity
        after its retries counts out of core instead (ops/chunked.py).
      * ``exchange_codec``: the wire of the exchange — "off" ships the
        raw lanes and a count all_to_all; "pack" bit-packs each block to
        the key and rid bounds (``data/tuples.pack_blocks``), its header
        carrying the counts; "auto" packs a window only when its packed
        block is smaller than the raw lanes.  A one-rank world exchanges
        raw.  Packing masks key bits above the bound, so a bit flipped
        there in flight is healed rather than detected.
      * ``exchange_stages``: column groups of one exchange
        (``parallel/window.block_all_to_all``): 1 is the fused exchange,
        k > 1 exactly k sequenced collectives, bounding the live exchange
        buffer to about 1/k; 0 is "auto", 4 stages once a block holds 4096
        slots.
      * ``verify``: integrity verification (robustness/verify.py) — "check"
        fingerprints every network partition before the exchange and after
        it (and after the second radix pass on the bucket path) and fails a
        join whose fingerprints disagree (``data_corruption``); "repair"
        recomputes the damaged partitions out of core instead.  The
        one-rank sort probe exchanges nothing and is not verified.
      * ``grid_pipeline``: the out-of-core grid mode of the repair's
        recompute (``ops/chunked.chunked_join_grid``).
      * ``match_rate_cap``: matches the materializing join
        (``HashJoin.join_materialize``) emits at most per outer tuple
        before it flags ``local_overflow`` and, with retries, doubles it
        (the reference's ``MAX_MATCH_RATE``, kernels.cu:314-411).  Must be
        >= 1 (the JAX package does not check it: 0 would double to 0).
      * ``generation``: where :meth:`HashJoin.place` generates a relation —
        "host" builds the shard with numpy (``Relation.shard_np``) and
        copies it to the device; "auto" and "device" generate on the
        device.  The lanes are the same bits either way.
    """

    network_fanout_bits: int = 5
    local_fanout_bits: int = 5
    two_level: bool = False
    num_nodes: int = 1
    num_hosts: int = 1
    key_bits: int = 32
    key_range: str = "auto"
    window_sizing: str = "measured"
    allocation_factor: float = 1.5
    exchange_codec: str = "off"
    partition_impl: str = "auto"
    sort_impl: str = "auto"
    assignment_policy: str = "round_robin"
    probe_algorithm: str = "sort"
    max_retries: int = 0
    retry_backoff_s: float = 0.0
    retry_backoff_mult: float = 2.0
    retry_backoff_max_s: float = 30.0
    retry_jitter: float = 0.0
    fallback: str = "none"
    verify: str = "off"
    skew_threshold: Optional[float] = None
    chunk_size: Optional[int] = None
    debug_checks: bool = False
    measure_phases: bool = False
    exchange_stages: int = 1
    grid_pipeline: str = "auto"
    match_rate_cap: int = 8
    generation: str = "auto"

    def __post_init__(self):
        if self.network_fanout_bits < 0 or self.local_fanout_bits < 0:
            raise ValueError("fanout bits must be non-negative")
        if self.num_nodes < 1:
            raise ValueError("num_nodes must be >= 1")
        if self.num_hosts < 1 or self.num_nodes % self.num_hosts:
            raise ValueError("num_nodes must divide evenly over num_hosts")
        if self.key_bits not in (32, 64):
            raise ValueError("key_bits must be 32 or 64")
        if self.key_range not in ("auto", "narrow", "full"):
            raise ValueError(f"unknown key range mode {self.key_range!r}")
        if self.key_range != "auto" and self.key_bits == 64:
            raise ValueError(
                "key_range selects among 32-bit count disciplines; "
                "key_bits=64 always takes the wide hi/lo path")
        if self.window_sizing not in ("measured", "static"):
            raise ValueError(
                f"unknown window sizing mode {self.window_sizing!r}")
        if self.allocation_factor < 1.0:
            raise ValueError("allocation_factor must be >= 1.0")
        if self.exchange_codec not in ("off", "pack", "auto"):
            raise ValueError(
                f"unknown exchange codec {self.exchange_codec!r} "
                "(expected 'off', 'pack', or 'auto')")
        if self.exchange_stages < 0:
            raise ValueError(
                "exchange_stages must be >= 0 (0 = auto, 1 = fused, "
                "k > 1 = staged)")
        if self.grid_pipeline not in ("off", "on", "auto"):
            raise ValueError(
                f"unknown grid pipeline mode {self.grid_pipeline!r}")
        if self.match_rate_cap < 1:
            raise ValueError("match_rate_cap must be >= 1")
        if self.generation not in ("auto", "host", "device"):
            raise ValueError(f"unknown generation mode {self.generation!r}")
        if self.partition_impl not in PARTITION_IMPLS:
            raise ValueError(
                f"unknown partition impl {self.partition_impl!r} (expected "
                f"{_expected(PARTITION_IMPLS)})")
        if self.sort_impl not in SORT_IMPLS:
            raise ValueError(
                f"unknown sort impl {self.sort_impl!r} (expected "
                f"{_expected(SORT_IMPLS)})")
        if self.assignment_policy not in ("round_robin", "load_aware"):
            raise ValueError(
                f"unknown assignment policy {self.assignment_policy!r}")
        if self.probe_algorithm not in ("sort", "bucket"):
            raise ValueError(
                f"unknown probe algorithm {self.probe_algorithm!r}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.retry_backoff_s < 0 or self.retry_backoff_max_s < 0:
            raise ValueError("retry backoff delays must be >= 0")
        if self.retry_backoff_mult < 1.0:
            raise ValueError("retry_backoff_mult must be >= 1.0")
        if not 0.0 <= self.retry_jitter <= 1.0:
            raise ValueError("retry_jitter must be in [0, 1]")
        if self.fallback not in ("none", "chunked"):
            raise ValueError(f"unknown fallback mode {self.fallback!r}")
        if self.verify not in ("off", "check", "repair"):
            raise ValueError(f"unknown verify mode {self.verify!r}")
        if self.verify != "off" and self.measure_phases:
            # the JAX package's check (core/config.py:289-295)
            raise ValueError(
                "verify does not compose with measure_phases: the split "
                "attempt fences each phase and carries no checksums across "
                "them — use measure_phases=False for verified runs")
        if self.skew_threshold is not None:
            # the JAX package's checks (core/config.py:263-282)
            if self.skew_threshold <= 0:
                raise ValueError("skew_threshold must be positive")
            if self.chunk_size:
                raise ValueError(
                    "skew splitting does not compose with the chunked "
                    "probe: the split replicates the hot inner side onto "
                    "every rank, growing the working set chunking bounds")
            if self.network_fanout_bits > 5:
                raise ValueError(
                    "skew splitting supports network fanout <= 5 "
                    "(the hot set is a uint32 bit mask)")
            if self.window_sizing != "measured":
                raise ValueError(
                    "skew splitting requires window_sizing='measured' "
                    "(hot detection reads the sizing pass's histograms)")
        if self.chunk_size is not None and (
                self.chunk_size < 1
                or self.two_level or self.probe_algorithm == "bucket"):
            raise ValueError(
                "chunk_size requires the sort probe (chunking bounds the "
                "probe working set; the bucketized path is already blocked)")

    # --- derived geometry ------------------------------------------------
    @property
    def sort_probe(self) -> bool:
        """True when the (chunk-free) flat sort-merge probe runs: no second
        radix pass and no ``chunk_size``.  With 32-bit keys ``key_range``
        then picks the packed 31-bit probe or the full-range one; 64-bit
        keys take the wide probe.  The chunked probe compares whole keys,
        so the packing's key contract and route do not apply to it."""
        return (not self.two_level and self.probe_algorithm != "bucket"
                and not self.chunk_size)

    @property
    def bucket_path(self) -> bool:
        """True when local processing is the second radix pass plus the
        bucketized probe."""
        return self.two_level or self.probe_algorithm == "bucket"

    @property
    def network_partition_count(self) -> int:
        """NETWORK_PARTITIONING_COUNT = 1 << FANOUT (Configuration.h:33)."""
        return 1 << self.network_fanout_bits

    @property
    def local_partition_count(self) -> int:
        """LOCAL_PARTITIONING_COUNT = 1 << FANOUT (Configuration.h:34)."""
        return 1 << self.local_fanout_bits

    @property
    def total_fanout_bits(self) -> int:
        """Radix bits over both passes: the network fanout, plus the local
        fanout on the two-level path."""
        return self.network_fanout_bits + (self.local_fanout_bits
                                           if self.two_level else 0)

    @property
    def total_partition_count(self) -> int:
        return 1 << self.total_fanout_bits

    def shuffle_block_capacity(self, local_size: int) -> int:
        """Static per-destination exchange block: the expected share with
        ``allocation_factor`` slack, rounded up to a multiple of 8."""
        n = max(1, self.num_nodes)
        cap = int(math.ceil(local_size / n * self.allocation_factor))
        return max(8, -(-cap // 8) * 8)

    def bucket_capacity(self, total_slots: int, num_buckets: int) -> int:
        """Static per-bucket capacity of the local radix pass: the expected
        share of ``total_slots`` with ``allocation_factor`` slack."""
        cap = int(math.ceil(total_slots / max(1, num_buckets)
                            * self.allocation_factor))
        return max(8, -(-cap // 8) * 8)

    # --- key/rid packing contract ----------------------------------------
    @property
    def key_remainder_bits(self) -> int:
        """Key bits that survive compression: the network partition's bits
        are implied by the partition (NetworkPartitioning.cpp:128-129)."""
        return self.key_bits - self.network_fanout_bits

    @property
    def probe_shift_bits(self) -> int:
        """Bits below the probe's key remainder (``shiftBits`` of
        BuildProbe.cpp:55-61): the fanout bits, the rid riding its own
        lane."""
        return self.total_fanout_bits

    def bucket_count_for(self, inner_size: int) -> int:
        """N = the next power of two >= the inner partition's size
        (BuildProbe.cpp:59-61)."""
        return 1 << max(0, max(1, inner_size) - 1).bit_length()

    def replace(self, **kw) -> "JoinConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs of the resident join service (service/), the JAX package's
    ``ServiceConfig`` (``core/config.py:385-471``) with its fields,
    defaults and checks.  None of them changes what a join computes, so
    none enters a plan-cache or checkpoint fingerprint.

      * ``max_queue_depth`` / ``tenant_quota``: pending queries over all
        tenants, in-flight queries a tenant (service/admission.py).
      * ``default_deadline_s``: a query's budget when its request names
        none; None is unlimited (service/deadline.py).
      * ``breaker_threshold`` / ``breaker_cooldown_s``: consecutive
        backend failures that trip the breaker, and the open state's wait
        before its half-open probe (service/breaker.py).
      * ``outcomes_keep``: recent outcomes a session keeps.
      * ``place_cache_max``: placed relations a session keeps.
      * ``result_cache_max`` / ``result_cache_ttl_s``: the content
        fingerprint result cache (service/resultcache.py); 0 disables it.
      * ``batch_window_ms`` / ``batch_max_queries``: the micro-batch
        coalescer (service/microbatch.py); 0.0 disables it.
      * ``resident_budget_bytes``: device bytes of resident sorted unions
        behind the delta merge (service/resident.py); 0 disables it.
    """

    max_queue_depth: int = 64
    tenant_quota: int = 8
    default_deadline_s: Optional[float] = None
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 30.0
    outcomes_keep: int = 512
    place_cache_max: int = 8
    result_cache_max: int = 0
    result_cache_ttl_s: Optional[float] = None
    batch_window_ms: float = 0.0
    batch_max_queries: int = 8
    resident_budget_bytes: int = 0

    def __post_init__(self):
        if self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if self.tenant_quota < 1:
            raise ValueError("tenant_quota must be >= 1")
        if (self.default_deadline_s is not None
                and self.default_deadline_s < 0):
            raise ValueError("default_deadline_s must be >= 0 (or None)")
        if self.breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        if self.breaker_cooldown_s < 0:
            raise ValueError("breaker_cooldown_s must be >= 0")
        if self.outcomes_keep < 1:
            raise ValueError("outcomes_keep must be >= 1")
        if self.place_cache_max < 0:
            raise ValueError("place_cache_max must be >= 0 (0 = no reuse)")
        if self.result_cache_max < 0:
            raise ValueError("result_cache_max must be >= 0 (0 = disabled)")
        if (self.result_cache_ttl_s is not None
                and self.result_cache_ttl_s <= 0):
            raise ValueError("result_cache_ttl_s must be > 0 (or None)")
        if self.batch_window_ms < 0:
            raise ValueError("batch_window_ms must be >= 0 (0 = disabled)")
        if self.batch_max_queries < 2:
            raise ValueError("batch_max_queries must be >= 2 (a batch of "
                             "one is the serial path)")
        if self.resident_budget_bytes < 0:
            raise ValueError(
                "resident_budget_bytes must be >= 0 (0 = disabled)")

    def replace(self, **kw) -> "ServiceConfig":
        return dataclasses.replace(self, **kw)
