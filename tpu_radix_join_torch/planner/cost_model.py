"""Analytic per-strategy join cost from a calibrated device profile.

The port's copy of ``tpu_radix_join/planner/cost_model.py``: the same
formulas, term names and strategy rows (:func:`enumerate_strategies`,
:func:`enumerate_serving_strategies`), so a profile prices a workload the
same in both packages.  The stage model was built for the TPU:

  * the sort emitter (the ``xla`` arm, stable ``torch.sort`` in the port)
    costs ``unit * (M / 33.5M) * U(M)`` stage-units (``U = k(k+1)/2``,
    ``k = ceil(log2 M)``);
  * the radix sort (the ``pallas`` arm, K2 in the port) costs
    ``radix_sort_pass_unit_ms`` a million tuples a digit pass plus one
    streaming pass over its lanes;
  * every other pass streams at the profile's ``hbm_gbps``;
  * each program pays a non-pipelining dispatch floor.

Every coefficient comes from the :class:`~tpu_radix_join_torch.planner.
profile.DeviceProfile`; how far the fitted ``h100`` profile lands from the
card's clock is measured by ``chip_smoke.py``'s phase (u), not corrected
here.  Arm names (``pallas``, ``xla``, ``sort``) and the notes of the cost
rows keep the JAX package's vocabulary, which the port's ``--sort-impl`` /
``--partition-impl`` choices share.

Where the JAX model mirrors a rule of JAX's own engine, this one mirrors
the port's engine instead:

  * the availability probes of :func:`plan_partition` and
    :func:`plan_sort` (``pallas_ok=None``): the port runs K4 and K2 on every
    device its ``auto`` runs (the plain versions on the CPU), so the kernel
    arm is always available;
  * the JAX package's ``PALLAS_SORT_MIN_ELEMS`` floor: the port runs K2 at
    every size (ops/sorting.py), so no size routes to the ``xla`` arm;
  * "batched rows are structurally xla": the port sorts rows on K2 with
    the row index as the most significant key, so a batched sort prices
    the radix arm with that key's passes added;
  * ``num_radix_passes`` is the port's (ops/kernels/radix_sort.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from tpu_radix_join_torch.data.tuples import make_wire_spec
from tpu_radix_join_torch.ops.kernels.radix_sort import num_radix_passes
from tpu_radix_join_torch.ops.merge_count import MAX_MERGE_KEY
from tpu_radix_join_torch.ops.merge_delta import batch_feasible
from tpu_radix_join_torch.planner.profile import (SORT_REF_ELEMS,
                                                  DeviceProfile,
                                                  sort_stage_units)

#: Bytes per tuple on the wire / in HBM per lane (uint32 key + uint32 rid;
#: wide keys add a third uint32 lane).
LANE_BYTES = 4

#: Working-set multiplier of the in-core engine over the raw relation
#: bytes: inputs + the packed union + sort double-buffering + shuffle
#: receive windows (allocation slack).  Conservative by design — crossing
#: the budget routes to the chunked grid, whose only cost is time.
INCORE_WORKING_FACTOR = 6.0

#: Program counts per discipline (dispatch-floor multiplier).  The sizing
#: pre-pass is one program (skipped single-node and on plan-cache warm
#: starts); the fused pipeline is one; the phase split runs shuffle+probe
#: (sort path) or shuffle+LP+build+probe (bucket path) separately.
PROGRAMS = {
    "fused": 1,
    "split_sort": 2,
    "split_bucket": 4,
}

#: Pending-readback window of the pipelined grid (ops/chunked.py
#: ``readback_depth`` default): per-pair host round trips batch through it,
#: so the modeled dispatch floor amortizes by the same factor.
GRID_READBACK_DEPTH = 2


@dataclasses.dataclass(frozen=True)
class Workload:
    """What the planner knows before running: global relation sizes, the
    static key bound (``Relation.key_bound()``; None = unknown), mesh
    size, repeat count, and an optional memory-budget override (defaults
    to the profile's HBM envelope)."""

    r_tuples: int
    s_tuples: int
    key_bound: Optional[int] = None      # exclusive upper bound on keys
    key_bits: int = 32
    num_nodes: int = 1
    repeats: int = 1
    memory_budget_bytes: Optional[int] = None

    def budget(self, profile: DeviceProfile) -> float:
        if self.memory_budget_bytes is not None:
            return float(self.memory_budget_bytes)
        return profile.value("hbm_bytes")

    @property
    def lanes(self) -> int:
        """HBM lanes per tuple (key [+ key_hi] + rid)."""
        return 3 if self.key_bits == 64 else 2

    @property
    def union_per_node(self) -> int:
        return max(1, (self.r_tuples + self.s_tuples) // max(
            1, self.num_nodes))


@dataclasses.dataclass(frozen=True)
class StrategyCost:
    """One row of the ``--explain`` table: a strategy, its feasibility,
    the predicted per-join cost, and the per-term breakdown (ms) so a
    misprediction is debuggable against the chip logs term by term."""

    strategy: str
    cost_ms: float
    feasible: bool
    terms: Dict[str, float]
    note: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# --------------------------------------------------------------- primitives

def sort_ms(profile: DeviceProfile, elems: int, lane_factor: float = 1.0,
            rows: int = 1) -> float:
    """Stage-model cost of sorting ``elems`` total elements, optionally as
    ``rows`` independent batched rows (stage count follows row length —
    the batched-sort discount of the stage model)."""
    if elems <= 0:
        return 0.0
    row_len = max(2, elems // max(1, rows))
    return (profile.value("sort_stage_unit_ms")
            * (elems / SORT_REF_ELEMS)
            * sort_stage_units(row_len) * lane_factor)


def hbm_pass_ms(profile: DeviceProfile, byts: float) -> float:
    """One read+write streaming pass over ``byts`` bytes."""
    return 2.0 * byts / profile.value("hbm_gbps") / 1e9 * 1e3


def shuffle_ms(profile: DeviceProfile, w: Workload,
               bytes_per_tuple: Optional[float] = None) -> float:
    """all_to_all wire time per rank: each relation ships its non-local
    share (``local * (N-1)/N``) over the interconnect.

    ``bytes_per_tuple`` is the wire footprint per tuple slot under the
    active exchange codec — by default the raw lane width (8 B narrow /
    12 B wide), or a :func:`~tpu_radix_join_torch.data.tuples.make_wire_spec`
    estimate when the bit-packed codec is being priced (plan_exchange).
    """
    n = w.num_nodes
    if n <= 1:
        return 0.0
    if bytes_per_tuple is None:
        bytes_per_tuple = w.lanes * LANE_BYTES
    local = (w.r_tuples + w.s_tuples) / n
    wire_bytes = bytes_per_tuple * local * (n - 1) / n
    return wire_bytes / profile.value("ici_bytes_per_s") * 1e3


def dispatch_ms(profile: DeviceProfile, programs: int) -> float:
    return profile.value("dispatch_floor_ms") * programs


def scatter_loop_ms(profile: DeviceProfile, elems: int) -> float:
    """The block-scatter loop discipline's permutation cost (the second
    radix pass's destination grouping)."""
    return elems / profile.value("scatter_loop_melems_s") / 1e6 * 1e3


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """The cost model's destination-grouping decision: the grouping
    kernel (K4) vs the sort-backed scatter loop, with both arms'
    prices kept for the explain table."""

    impl: str               # "pallas" | "sort"
    partition_ms: float     # the chosen arm
    fused_ms: float         # two streaming kernel passes + the lane scatter
    sort_ms: float          # the scatter-loop (sort-rate-bound) arm
    note: str = ""


def plan_partition(profile: DeviceProfile, elems: int,
                   pallas_ok: Optional[bool] = None) -> PartitionPlan:
    """Price both destination-grouping arms and pick the cheaper available.

    The fused arm is the grouping kernel (K4, ``csrc/partition.cu``): two
    streaming passes over the ids at ``partition_pass_unit_ms`` each, then
    every lane crosses memory once more, priced as one streaming pass over
    the lane bytes.  The sort arm is the sort-backed grouping
    (``scatter_loop_melems_s``; the port's ``partition_impl="sort"``).
    ``pallas_ok=None`` is the port's rule: its ``auto`` runs K4 on every
    device, so the kernel arm is available; tests pass an explicit bool to
    price either arm.
    """
    if pallas_ok is None:
        pallas_ok = True
    fused = (profile.value("partition_pass_unit_ms") * elems / 1e6 * 2.0
             + hbm_pass_ms(profile, elems * 2 * LANE_BYTES))
    sort_arm = scatter_loop_ms(profile, elems)
    if pallas_ok and fused <= sort_arm:
        return PartitionPlan(
            impl="pallas", partition_ms=fused, fused_ms=fused,
            sort_ms=sort_arm,
            note=(f"fused pallas partition {fused:.2f} ms vs "
                  f"{sort_arm:.2f} ms scatter loop"))
    return PartitionPlan(
        impl="sort", partition_ms=sort_arm, fused_ms=fused,
        sort_ms=sort_arm,
        note=("pallas unavailable: scatter loop" if not pallas_ok else
              f"scatter loop {sort_arm:.2f} ms beats fused {fused:.2f} ms"))


def radix_sort_ms(profile: DeviceProfile, elems: int, passes: int,
                  lanes: int = 2) -> float:
    """LSD radix-sort cost (K2, ``csrc/radix_sort.cu``): each digit pass
    runs the slot kernel — priced per tuple by ``radix_sort_pass_unit_ms``
    (the key lane streams through both grid phases plus the slot
    writeback) — and then moves every lane across HBM once through the
    collision-free permutation scatter.  Linear in ``passes``, which is
    how the bounded-key pass skip shows up in the plan."""
    if elems <= 0 or passes <= 0:
        return 0.0
    return passes * (profile.value("radix_sort_pass_unit_ms") * elems / 1e6
                     + hbm_pass_ms(profile, elems * lanes * LANE_BYTES))


@dataclasses.dataclass(frozen=True)
class SortPlan:
    """The cost model's sort-engine decision: the LSD radix sort (K2) vs
    the library sort (stable ``torch.sort``), with both arms' prices kept for the explain
    table (mirrors :class:`PartitionPlan` for destination grouping)."""

    impl: str               # "pallas" | "xla"
    sort_ms: float          # the chosen arm
    pallas_ms: float        # bounded LSD digit passes + per-lane scatters
    xla_ms: float           # the stage-model library-sort arm
    passes: int             # digit passes the radix arm would run
    note: str = ""


def plan_sort(profile: DeviceProfile, elems: int, lanes: int = 2,
              key_bound: Optional[int] = None, key_bits: int = 32,
              lane_factor: float = 1.0, rows: int = 1,
              pallas_ok: Optional[bool] = None) -> SortPlan:
    """Price both sort arms and pick the cheaper available.

    The radix arm's pass count comes from the workload's static key bound
    through the port's :func:`~tpu_radix_join_torch.ops.kernels.radix_sort.
    num_radix_passes`, the rule K2 skips passes by, so a 16-bit-bounded key
    is priced at 2 passes, not 4.  The port's engine runs K2 at every size
    and sorts ``rows > 1`` batched rows on it with the row index as the
    most significant key, whose passes the radix arm adds.
    ``pallas_ok=None`` is the port's rule (K2 runs wherever ``auto`` does);
    tests pass an explicit bool to price either arm."""
    xla = sort_ms(profile, elems, lane_factor, rows)
    passes = num_radix_passes(key_bound, key_bits)
    if rows > 1:
        passes += num_radix_passes(rows)
    pal = radix_sort_ms(profile, elems, passes, lanes)
    if pallas_ok is None:
        pallas_ok = True
    if not pallas_ok:
        return SortPlan(
            impl="xla", sort_ms=xla, pallas_ms=pal, xla_ms=xla,
            passes=passes, note="pallas unavailable: lax.sort")
    if pal <= xla:
        return SortPlan(
            impl="pallas", sort_ms=pal, pallas_ms=pal, xla_ms=xla,
            passes=passes,
            note=(f"{passes}-pass radix {pal:.2f} ms vs "
                  f"{xla:.2f} ms lax.sort"))
    return SortPlan(
        impl="xla", sort_ms=xla, pallas_ms=pal, xla_ms=xla, passes=passes,
        note=f"lax.sort {xla:.2f} ms beats {passes}-pass radix {pal:.2f} ms")


def network_fanout_bits(w: Workload) -> int:
    """Network radix bits: at least enough partitions to cover the mesh,
    at most the default 32-way fanout, and never more partitions than
    tuples per node (tiny relations would leave most partitions empty and
    pay histogram width for nothing)."""
    floor_bits = max(0, math.ceil(math.log2(max(1, w.num_nodes))))
    per_node = max(1, w.r_tuples // max(1, w.num_nodes))
    size_cap = max(1, per_node.bit_length() - 3)
    return max(floor_bits, min(5, size_cap))


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """The cost model's exchange-layer decision: which wire codec and how
    many staged column groups, with both arms' prices kept for the explain
    table (``wire_off_ms`` is what the raw 8/12 B lanes would have cost)."""

    codec: str              # "off" | "pack"
    stages: int             # 1 = fused all_to_all, k > 1 = staged groups
    bytes_per_tuple: float  # wire footprint per slot under the chosen codec
    wire_ms: float          # shuffle wire time under the chosen codec
    pack_ms: float          # codec compute (pack + unpack passes); 0 if off
    wire_off_ms: float      # the raw-lane arm, for comparison
    note: str = ""


def plan_exchange(profile: DeviceProfile, w: Workload,
                  fanout_bits: Optional[int] = None) -> ExchangePlan:
    """Price both exchange arms and pick the cheaper.

    The packed arm's bytes/tuple comes from the same ``WireSpec`` geometry
    the engine ships (data/tuples.make_wire_spec) — key bits implied by the
    workload's static key bound minus the network fanout bits, rid bits by
    the relation sizes — so the planner and the wire agree on the payload
    width.  Pack compute is two extra streaming passes over the packed
    words (sender pack, receiver unpack), priced at the HBM envelope;
    packing wins exactly when the ICI bytes saved outrun that.

    Packing also wins on *memory*: within half the residency budget of the
    envelope, the smaller live exchange footprint buys headroom the ms
    model cannot see (exchange buffers are part of the in-core working
    set), so under pressure the packed arm is chosen whenever it actually
    shrinks the wire — the decisive shape knob alongside the byte ratio.

    Stages mirror the engine's ``exchange_stages=0`` auto rule: blocks big
    enough to matter (>= 4096 slots) exchange in 4 column groups, bounding
    live exchange memory to ~1/4 at no modeled wire cost (the groups ride
    the same link back to back).
    """
    n = w.num_nodes
    raw_bpt = w.lanes * LANE_BYTES
    if n <= 1:
        return ExchangePlan(codec="off", stages=1, bytes_per_tuple=raw_bpt,
                            wire_ms=0.0, pack_ms=0.0, wire_off_ms=0.0,
                            note="single node: no exchange")
    if fanout_bits is None:
        fanout_bits = network_fanout_bits(w)
    # per-(sender, destination) block capacity estimate — uniform split of
    # the per-node share; only the header amortization depends on it
    cap_est = max(1, w.union_per_node // n)
    spec = make_wire_spec(cap_est, fanout_bits, wide=(w.key_bits == 64),
                          key_bound=w.key_bound,
                          rid_bound=max(w.r_tuples, w.s_tuples))
    wire_off = shuffle_ms(profile, w)
    wire_pack = shuffle_ms(profile, w, spec.bytes_per_tuple)
    local = (w.r_tuples + w.s_tuples) / n
    pack_cost = 2.0 * hbm_pass_ms(profile, spec.bytes_per_tuple * local)
    stages = 4 if cap_est >= 4096 else 1
    cheaper = wire_pack + pack_cost < wire_off
    pressured = (spec.bytes_per_tuple < raw_bpt
                 and incore_resident_bytes(w) > 0.5 * w.budget(profile))
    if cheaper or pressured:
        why = (f"pack {spec.bytes_per_tuple:.2f} B/tuple vs {raw_bpt} B raw"
               + ("" if cheaper else
                  "; chosen for memory headroom near the residency budget"))
        return ExchangePlan(
            codec="pack", stages=stages,
            bytes_per_tuple=spec.bytes_per_tuple, wire_ms=wire_pack,
            pack_ms=pack_cost, wire_off_ms=wire_off, note=why)
    return ExchangePlan(
        codec="off", stages=stages, bytes_per_tuple=raw_bpt,
        wire_ms=wire_off, pack_ms=0.0, wire_off_ms=wire_off,
        note=(f"raw {raw_bpt} B/tuple; pack would cost "
              f"{wire_pack + pack_cost:.2f} ms vs {wire_off:.2f} ms wire"))


def wide_sort_factor(profile: DeviceProfile) -> float:
    """Derived 3-lane (64-bit hi/lo + rid) sort penalty: one extra lane
    costs ``full_range_sort_factor - 1``; the wide path carries two
    (the JAX package's model)."""
    return 1.0 + 2.0 * (profile.value("full_range_sort_factor") - 1.0)


def incore_resident_bytes(w: Workload) -> float:
    """Modeled per-rank residency of the in-core engine."""
    return (w.union_per_node * w.lanes * LANE_BYTES * INCORE_WORKING_FACTOR)


def pick_chunk_tuples(profile: DeviceProfile, w: Workload) -> int:
    """Largest power-of-two chunk whose grid working set (one inner chunk +
    one outer chunk, sorted) fits the memory budget; clamped to [2^16,
    2^24] (the JAX package's clamp)."""
    budget = w.budget(profile)
    cap = int(budget / (2 * w.lanes * LANE_BYTES * INCORE_WORKING_FACTOR))
    cap = max(1, cap)
    chunk = 1 << max(16, min(24, cap.bit_length() - 1))
    return chunk


# --------------------------------------------------------------- strategies

def _narrow_feasible(w: Workload) -> Tuple[bool, str]:
    if w.key_bits == 64:
        return False, "64-bit keys always take the wide 3-lane path"
    if w.key_bound is None:
        return True, "key bound unknown; narrow assumed (engine re-checks)"
    if w.key_bound - 1 > MAX_MERGE_KEY:
        return (False, f"max key {w.key_bound - 1:#x} exceeds the 31-bit "
                       f"packing limit {MAX_MERGE_KEY:#x}")
    return True, ""


def enumerate_strategies(profile: DeviceProfile,
                         w: Workload) -> list[StrategyCost]:
    """Cost every discipline combination for this workload.  Order is the
    tie-break preference (first feasible minimum wins in plan_join)."""
    union = w.union_per_node
    union_bytes = union * w.lanes * LANE_BYTES
    narrow_ok, narrow_why = _narrow_feasible(w)
    full_factor = (wide_sort_factor(profile) if w.key_bits == 64
                   else profile.value("full_range_sort_factor"))
    sizing = 0 if w.num_nodes == 1 else 1   # the n==1 sort probe skips it
    fits = incore_resident_bytes(w) <= w.budget(profile)
    mem_note = ("" if fits else
                f"resident ~{incore_resident_bytes(w) / 1e9:.1f} GB exceeds "
                f"the {w.budget(profile) / 1e9:.1f} GB budget")
    # codec-aware exchange: the shuffle term consumes the chosen arm's
    # actual wire bytes/tuple (plan_exchange), not a hardcoded lane width;
    # the packed arm's codec compute shows up as its own "pack" column
    xplan = plan_exchange(profile, w)
    shuf = xplan.wire_ms
    xch = ({"shuffle": shuf, "pack": xplan.pack_ms}
           if xplan.pack_ms > 0 else {"shuffle": shuf})
    scan = hbm_pass_ms(profile, union_bytes)

    def amortized_dispatch(programs: int, pipelinable: bool = True) -> float:
        # pipelined repeats overlap the per-join round trip; the floor is
        # paid once per program per *batch*, not per join.  The phase split cannot pipeline —
        # its host timers need a fence per program — so it pays per join.
        progs = programs + sizing
        if w.repeats > 1 and pipelinable:
            return dispatch_ms(profile, progs) / w.repeats
        return dispatch_ms(profile, progs)

    rows = []

    def add(name, feasible, terms, note=""):
        rows.append(StrategyCost(
            strategy=name, feasible=feasible,
            cost_ms=round(sum(terms.values()), 3),
            terms={k: round(v, 3) for k, v in terms.items()}, note=note))

    for key_mode, lane_factor, key_ok, key_why in (
            ("narrow", 1.0, narrow_ok, narrow_why),
            ("full", full_factor, True, "")):
        if w.key_bits == 64 and key_mode == "narrow":
            add("incore_fused_sort_narrow", False,
                {"sort": 0.0}, note=narrow_why)
            continue
        # the sort term rides plan_sort's chosen engine arm: the narrow
        # discipline sorts one packed lane whose word mixes key and rid
        # bits (the static key bound no longer bounds it — worst-case
        # passes), the full discipline sorts the raw key lane(s) so the
        # workload's bound skips radix passes
        splan = plan_sort(
            profile, union,
            lanes=(1 if key_mode == "narrow" else w.lanes),
            key_bound=(None if key_mode == "narrow" else w.key_bound),
            key_bits=w.key_bits, lane_factor=lane_factor)
        sort = splan.sort_ms
        sort_note = f"sort arm: {splan.note}"
        add(f"incore_fused_sort_{key_mode}", key_ok and fits,
            {"sort": sort, "scan": scan, **xch,
             "dispatch": amortized_dispatch(PROGRAMS["fused"])},
            note=key_why or mem_note or sort_note)
        add(f"incore_split_sort_{key_mode}", key_ok and fits,
            {"sort": sort, "scan": scan, **xch,
             "dispatch": amortized_dispatch(PROGRAMS["split_sort"],
                                            pipelinable=False)},
            note=(key_why or mem_note
                  or f"{sort_note}; pays one dispatch floor per split "
                     f"program"))

    # two-level bucket discipline: the second radix pass groups tuples by
    # destination bucket — priced by plan_partition as the cheaper of the
    # fused Pallas partition kernel and the sort-rate-bound block-scatter
    # loop (the pre-kernel path) — plus batched per-bucket sorts; always
    # full-range by construction (no packed merge).
    nb = 32                                      # local fanout 5
    pplan = plan_partition(profile, union)
    twolevel = {
        "partition": pplan.partition_ms,
        "sort": sort_ms(profile, union, 1.0, rows=nb),
        "scan": scan,
        **xch,
        "dispatch": amortized_dispatch(PROGRAMS["fused"]),
    }
    add("incore_fused_twolevel", fits, twolevel,
        note=mem_note or f"second radix pass: {pplan.note}")

    # chunked out-of-core grid: every (inner, outer) chunk pair probed
    # once; per-pair cost is a resident-sized sort + scan + one host
    # dispatch (the grid loop is host-driven, no pipelining).
    chunk = pick_chunk_tuples(profile, w)
    pairs = (math.ceil(w.r_tuples / chunk) * math.ceil(w.s_tuples / chunk))
    pair_union = min(2 * chunk, w.r_tuples + w.s_tuples)
    grid = {
        "sort": pairs * sort_ms(profile, pair_union, full_factor),
        "scan": pairs * hbm_pass_ms(profile,
                                    pair_union * w.lanes * LANE_BYTES),
        "dispatch": dispatch_ms(profile, pairs),
    }
    grid_ok = w.num_nodes == 1   # the grid loop is a single-node engine
    add("chunked_grid", grid_ok, grid,
        note="the out-of-core grid runs single-node (ops/chunked.py)"
             if not grid_ok else
             f"chunk={chunk} tuples, {pairs} pair(s); the only discipline "
             f"whose working set is bounded by the slab, not the relation"
             if not fits else f"chunk={chunk} tuples, {pairs} pair(s)")

    # pipelined grid (ops/chunked.py pipeline="on"): sort-reuse collapses
    # the per-pair union sort to one inner-chunk sort per grid ROW (the
    # binary-search probe needs no packing, so no full_factor on 32-bit
    # keys; wide keys keep the per-pair union sort); the prefetch stage
    # hides min(stage, compute) of every pair after the first; deferred
    # readbacks amortize the dispatch floor over the pending window.
    grid_rows = math.ceil(w.r_tuples / chunk)
    outer_chunk = min(chunk, w.s_tuples)
    chunk_bytes = outer_chunk * w.lanes * LANE_BYTES
    stage = hbm_pass_ms(profile, chunk_bytes)       # prefetch copy per pair
    if w.key_bits == 64:
        # wide pairs keep the per-pair union sort (no presorted probe yet)
        sort_pl = pairs * sort_ms(profile, pair_union, full_factor)
        probe = pairs * hbm_pass_ms(profile,
                                    pair_union * w.lanes * LANE_BYTES)
    else:
        # one inner sort per grid ROW (sort-reuse); the binary-search probe
        # is gather-bound — log2(inner) dependent touches per outer key —
        # so it prices like sorting the outer chunk, not like streaming it
        sort_pl = grid_rows * sort_ms(profile, min(chunk, w.r_tuples))
        probe = pairs * sort_ms(profile, outer_chunk)
    pipelined = {
        "sort": sort_pl,
        "probe": probe,
        "stage": pairs * stage,
        "overlap": -max(0, pairs - 1) * min(stage, (sort_pl + probe)
                                            / max(1, pairs)),
        "dispatch": dispatch_ms(profile, pairs)
        / min(max(1, pairs), GRID_READBACK_DEPTH),
    }
    # a 1x1 grid has nothing to overlap or reuse — the engine's pipeline
    # "auto" resolves it to the synchronous loop, so the row mirrors that
    add("chunked_grid_pipelined", grid_ok and pairs > 1, pipelined,
        note="the out-of-core grid runs single-node (ops/chunked.py)"
             if not grid_ok else
             "single chunk pair: nothing to overlap (pipeline auto "
             "resolves to the synchronous loop)" if pairs <= 1 else
             f"chunk={chunk} tuples, {pairs} pair(s); inner sorted once "
             f"per row, prefetch hides min(stage, compute)")
    return rows


# ------------------------------------------------------------ serving tiers

@dataclasses.dataclass(frozen=True)
class ServingContext:
    """What the serving fast paths know about one query beyond the
    workload: how many co-batchable queries share its window, how big its
    incremental delta is, and whether its relation's sorted union is
    already device-resident (service/resident.py)."""

    batch_queries: int = 1       # queries fused into one device program
    delta_tuples: int = 0        # per-query global delta size (0 = full)
    resident: bool = False       # sorted union already lives in HBM


def enumerate_serving_strategies(profile: DeviceProfile, w: Workload,
                                 ctx: ServingContext) -> list[StrategyCost]:
    """Price the serving fast-path tiers against the baseline per-query
    execution (the cheapest feasible :func:`enumerate_strategies` row).

    Kept OUT of :func:`enumerate_strategies` on purpose: plan_join binds
    its winner to command-line knobs, and the serving tiers are not
    command-line disciplines — they are session-level shortcuts (result
    cache, fused micro-batch, resident delta merge) whose feasibility
    depends on serving state the planner cannot see (cache contents,
    window co-arrivals, residency).  The serve loop and the throughput bench
    consume these rows to sanity-check that each tier's measured win
    matches its modeled one.
    """
    base_rows = [c for c in enumerate_strategies(profile, w) if c.feasible]
    base = (min(base_rows, key=lambda c: c.cost_ms) if base_rows else None)
    base_ms = base.cost_ms if base is not None else float("inf")
    union = w.union_per_node
    union_bytes = union * w.lanes * LANE_BYTES
    rows: list[StrategyCost] = []

    def add(name, feasible, terms, note=""):
        rows.append(StrategyCost(
            strategy=name, feasible=feasible,
            cost_ms=round(sum(terms.values()), 3),
            terms={k: round(v, 3) for k, v in terms.items()}, note=note))

    # tier 0 — result cache: one host-side fingerprint + LRU probe, no
    # device work at all.  Feasible whenever the request is cacheable
    # (non-incremental); whether it HITS is runtime state, not cost.
    add("serve_cached", ctx.delta_tuples == 0,
        {"lookup": profile.value("result_cache_lookup_ms")},
        note=("incremental queries never cache-serve"
              if ctx.delta_tuples else
              f"on hit; a miss falls through to the {base.strategy if base else 'baseline'} "
              f"row at {base_ms:.0f} ms"))

    # tier 1 — fused micro-batch: Q co-batchable queries share ONE sort
    # over the composite (qid<<shift)|key lane and ONE dispatch, so the
    # per-query price divides by Q.  The composite lane is single-width
    # (narrow discipline by construction).
    q = max(1, ctx.batch_queries)
    batch_ok = (q >= 2 and w.key_bound is not None
                and batch_feasible(q, w.key_bound))
    fused_sort = sort_ms(profile, q * union)
    fused_scan = hbm_pass_ms(profile, q * union_bytes)
    add("serve_batched", batch_ok,
        {"sort": fused_sort / q, "scan": fused_scan / q,
         "dispatch": dispatch_ms(profile, 1) / q},
        note=(f"{q} queries, one program: Q dispatch floors become one"
              if batch_ok else
              "needs >= 2 co-batchable queries and a key bound whose "
              "composite (qid<<shift)|key stays below the uint32 sentinel"))

    # tier 2 — resident delta merge: sort only the delta, then two
    # searchsorted passes + one collision-free scatter over the union
    # (~3 streaming passes), then the presorted probe.  O(N+delta) where
    # the baseline re-sorts all N+delta tuples.
    d = ctx.delta_tuples
    delta_ok = ctx.resident and d > 0
    delta_per_node = max(1, d // max(1, w.num_nodes))
    add("serve_delta", delta_ok,
        {"sort_delta": sort_ms(profile, delta_per_node),
         "merge": 3.0 * hbm_pass_ms(profile, union_bytes),
         "probe": hbm_pass_ms(profile, union_bytes),
         "dispatch": dispatch_ms(profile, 1)},
        note=(f"delta/N = {d / max(1, w.r_tuples):.4f}; baseline re-sorts "
              f"the full union" if delta_ok else
              "needs a device-resident sorted union and a non-zero delta"))
    return rows
