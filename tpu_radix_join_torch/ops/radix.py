"""Radix partitioning primitives of the port.

Counterpart of ``tpu_radix_join/ops/radix.py``: ``local_histogram`` on K1,
and ``scatter_to_blocks`` (the fused route ``_scatter_blocks_fused`` with
``group_size=1``), ``scatter_to_blocks_grouped`` (its grouped mode, for the
packed exchange) and ``reorder_by_partition`` on K4's blocked and dense
modes, at every fanout (K1 and K4 have wide paths past their shared bins).

``impl=`` is JAX's partition choice (``resolve_partition_impl``): "auto",
"pallas" and "pallas_interpret" run K1 and K4 at every group count, so the
port never falls back and ticks no PARTFALLBACK.  "sort", asked for by name,
is the library baseline arm: K4's plain version (a stable ``argsort`` and
an ``index_add_`` count) on the caller's device, counted in
``LAUNCHES["baseline_partition"]``, and an ``index_add_`` count for the
histogram (``"xla"`` there too, JAX's histogram name for it), counted in
``LAUNCHES["baseline_histogram"]``.  Both arms give the same blocks, and
neither reads anything back to the host (``--transfer-guard disallow``).

PARTPASS: every grouping the K4 arm dispatches ticks the registry that
:func:`install_partition_observer` installed (the engine installs its
own).  JAX ticks once per traced scatter or reorder site
(``ops/radix.py:55``); the port has no trace, so it ticks once per call.
The baseline arm does not tick.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu_radix_join_torch.core.config import PARTITION_IMPLS
from tpu_radix_join_torch.data.tuples import (PAD_RID, TupleBatch, narrow,
                                              pad_sentinel, widen)
from tpu_radix_join_torch.ops.kernels import LAUNCHES
from tpu_radix_join_torch.ops.kernels.histogram import histogram
from tpu_radix_join_torch.ops.kernels.partition import (
    partition_scatter, partition_scatter_plain)
from tpu_radix_join_torch.performance.measurements import PARTPASS

#: the registry that hears PARTPASS (``install_partition_observer``)
_partition_observer: dict = {"meas": None}


def install_partition_observer(measurements) -> None:
    """Register a ``Measurements`` (or None) to receive a PARTPASS tick a
    K4 grouping.  Process-global: the most recent engine wins (JAX's
    ``install_partition_observer``)."""
    _partition_observer["meas"] = measurements


def check_partition_impl(impl: str) -> str:
    """``impl`` if it is one of :data:`PARTITION_IMPLS`, else ValueError."""
    if impl not in PARTITION_IMPLS:
        raise ValueError(f"unknown partition impl {impl!r} (expected one of "
                         f"{PARTITION_IMPLS})")
    return impl


def local_histogram(pid: torch.Tensor, num_partitions: int,
                    valid: Optional[torch.Tensor] = None,
                    impl: str = "auto") -> torch.Tensor:
    """Tuples per partition (LocalHistogram.cpp:44-47): int32 lane
    [num_partitions] of uint32 counts of ``pid``.  ``valid`` (bool [n])
    masks out padding slots.  K1 on a CUDA lane, its plain version on a
    CPU lane; ``impl`` "sort" or "xla" is the library arm: an
    ``index_add_`` of the valid, in-range mask into a lane of
    ``num_partitions`` (no ``bincount``, which sizes its output on the
    host)."""
    if impl != "xla":
        check_partition_impl(impl)
    if impl in ("sort", "xla"):
        LAUNCHES["baseline_histogram"] += 1
        ids = widen(pid)
        keep = ids < num_partitions
        if valid is not None:
            keep &= valid
        counts = torch.zeros(num_partitions, dtype=torch.int64,
                             device=ids.device)
        counts.index_add_(0, torch.where(keep, ids, 0), keep.to(torch.int64))
        return narrow(counts)
    weights = None if valid is None else valid.to(torch.int32)
    return histogram(pid, weights, num_bins=num_partitions)


def _group(ids: torch.Tensor, lanes, fills, num_groups: int, group_size: int,
           capacity: Optional[int], impl: str):
    """K4 (:func:`partition_scatter`), or its plain version on the caller's
    device for the "sort" arm."""
    if check_partition_impl(impl) == "sort":
        LAUNCHES["baseline_partition"] += 1
        return partition_scatter_plain(ids, lanes, fills, num_groups,
                                       group_size, capacity)
    m = _partition_observer["meas"]
    if m is not None:
        m.incr(PARTPASS)
    return partition_scatter(ids, lanes, fills, num_groups=num_groups,
                             group_size=group_size, capacity=capacity)


def exclusive_cumsum(hist: torch.Tensor) -> torch.Tensor:
    """Partition base offsets = exclusive prefix sum of a uint32 histogram
    lane (LocalPartitioning.cpp:165-192), wrapping as uint32 does."""
    h = widen(hist)
    return narrow(torch.cumsum(h, 0) - h)


def _overflow(counts: torch.Tensor, capacity: int) -> torch.Tensor:
    """0-d int64: tuples past capacity, sum(max(counts - capacity, 0))."""
    return torch.clamp(widen(counts) - capacity, min=0).sum()


def _group_key(ids: torch.Tensor, num_groups: int,
               valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Invalid (padding) slots are routed to the group past the real ones."""
    if valid is None:
        return ids
    return torch.where(valid, ids, num_groups).to(torch.int32)


def scatter_to_blocks(batch: TupleBatch, dest: torch.Tensor, num_blocks: int,
                      capacity: int, side: str,
                      valid: Optional[torch.Tensor] = None,
                      impl: str = "auto"
                      ) -> Tuple[TupleBatch, torch.Tensor, torch.Tensor]:
    """Route tuples into ``num_blocks`` blocks of ``capacity`` slots each,
    padding unused slots with the side's sentinel key and ``PAD_RID``.

    Returns (blocks with [num_blocks * capacity] lanes, counts — int32 lane
    [num_blocks] of the *unclipped* per-destination demand, overflow — 0-d
    int64 count of tuples that did not fit).  A block keeps the first
    ``capacity`` of its tuples in input order.  A ``key_hi`` lane moves with
    the others, its pad slots holding the side's sentinel too."""
    pad = pad_sentinel(side)
    lanes, fills = [batch.key, batch.rid], [pad, PAD_RID]
    if batch.key_hi is not None:
        lanes.append(batch.key_hi)
        fills.append(pad)
    key = _group_key(dest, num_blocks, valid)
    out, counts = _group(key, lanes, fills, num_blocks, 1, capacity, impl)
    return TupleBatch(*out), counts, _overflow(counts, capacity)


def scatter_to_blocks_grouped(batch: TupleBatch, dest: torch.Tensor,
                              sub: torch.Tensor, num_blocks: int,
                              num_sub: int, capacity: int, side: str,
                              valid: Optional[torch.Tensor] = None,
                              impl: str = "auto"):
    """:func:`scatter_to_blocks` with a secondary order: within each
    destination block the tuples land sorted by ``sub`` (the partition id
    on the packed exchange), in input order within one ``sub``
    (``scatter_to_blocks_grouped``, ``ops/radix.py:273-343``, on the route
    of ``_scatter_blocks_fused``, :391-435).  ``sub`` may be any value in
    ``[0, num_sub)`` whatever ``dest`` is: a spread hot tuple keeps its
    true pid.

    K4's grouped mode over the composite id ``dest * num_sub + sub``:
    ``num_blocks * num_sub`` groups, ``num_sub`` of them a block, clipped
    at ``capacity``.  Returns (blocks, counts — int32 lane [num_blocks] of
    the unclipped demand, group_counts — int32 [num_blocks, num_sub] of the
    clipped per-(block, sub) counts, whose clip eats the highest subs
    first, overflow — 0-d int64)."""
    num_groups = num_blocks * num_sub
    pad = pad_sentinel(side)
    lanes, fills = [batch.key, batch.rid], [pad, PAD_RID]
    if batch.key_hi is not None:
        lanes.append(batch.key_hi)
        fills.append(pad)
    key = _group_key(narrow(widen(dest) * num_sub + widen(sub)), num_groups,
                     valid)
    out, ghist = _group(key, lanes, fills, num_groups, num_sub, capacity,
                        impl)
    raw = widen(ghist).view(num_blocks, num_sub)
    counts = raw.sum(dim=1)
    cum = torch.clamp(torch.cumsum(raw, dim=1), max=capacity)
    group_counts = torch.cat([cum[:, :1], cum[:, 1:] - cum[:, :-1]], dim=1)
    return (TupleBatch(*out), narrow(counts), narrow(group_counts),
            torch.clamp(counts - capacity, min=0).sum())


def reorder_by_partition(batch: TupleBatch, pid: torch.Tensor,
                         num_partitions: int,
                         valid: Optional[torch.Tensor] = None,
                         impl: str = "auto"):
    """Reorder so each partition's tuples are contiguous, in input order
    within a partition; invalid (padding) slots go to a virtual partition
    after the real ones, so every tuple lands.  Returns (reordered batch,
    reordered pid, histogram, base offsets), the last two int32 lanes
    [num_partitions] of uint32 values.  With a ``key_hi`` lane K4 moves
    four lanes, its limit."""
    lanes = [batch.key, batch.rid, pid]
    if batch.key_hi is not None:
        lanes.append(batch.key_hi)
    key = _group_key(pid, num_partitions, valid)
    out, hist_x = _group(key, lanes, [0] * len(lanes), num_partitions + 1, 1,
                         None, impl)
    hist = hist_x[:num_partitions]
    hi = out[3] if batch.key_hi is not None else None
    return (TupleBatch(key=out[0], rid=out[1], key_hi=hi), out[2], hist,
            exclusive_cumsum(hist))
