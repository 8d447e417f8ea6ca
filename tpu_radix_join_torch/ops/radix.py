"""Radix partitioning primitives of the port.

Counterpart of ``tpu_radix_join/ops/radix.py``: ``local_histogram`` on K1,
and ``scatter_to_blocks`` (the fused route ``_scatter_blocks_fused`` with
``group_size=1``), ``scatter_to_blocks_grouped`` (its grouped mode, for the
packed exchange) and ``reorder_by_partition`` on K4's blocked and dense
modes.  The JAX package's sort-based fallback and its impl switch have no
counterpart: the port has one partition pass, K4, and a grouping past its
256 groups raises (ROADMAP A19).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu_radix_join_torch.data.tuples import (PAD_RID, TupleBatch, narrow,
                                              pad_sentinel, widen)
from tpu_radix_join_torch.ops.kernels.histogram import histogram
from tpu_radix_join_torch.ops.kernels.partition import (MAX_GROUPS,
                                                        partition_scatter)


def local_histogram(pid: torch.Tensor, num_partitions: int,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tuples per partition (LocalHistogram.cpp:44-47): int32 lane
    [num_partitions] of uint32 counts of ``pid``.  ``valid`` (bool [n])
    masks out padding slots.  K1 on a CUDA lane, its plain version on a
    CPU lane."""
    weights = None if valid is None else valid.to(torch.int32)
    return histogram(pid, weights, num_bins=num_partitions)


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
                      valid: Optional[torch.Tensor] = None
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
    out, counts = partition_scatter(key, lanes, fills, num_groups=num_blocks,
                                    group_size=1, capacity=capacity)
    return TupleBatch(*out), counts, _overflow(counts, capacity)


def scatter_to_blocks_grouped(batch: TupleBatch, dest: torch.Tensor,
                              sub: torch.Tensor, num_blocks: int,
                              num_sub: int, capacity: int, side: str,
                              valid: Optional[torch.Tensor] = None):
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
    if num_groups > MAX_GROUPS:
        raise NotImplementedError(
            f"the grouped scatter of {num_blocks} blocks x {num_sub} "
            f"partitions needs {num_groups} groups; K4 holds {MAX_GROUPS} "
            "(ROADMAP.md A19: wider fanout)")
    pad = pad_sentinel(side)
    lanes, fills = [batch.key, batch.rid], [pad, PAD_RID]
    if batch.key_hi is not None:
        lanes.append(batch.key_hi)
        fills.append(pad)
    key = _group_key(narrow(widen(dest) * num_sub + widen(sub)), num_groups,
                     valid)
    out, ghist = partition_scatter(key, lanes, fills, num_groups=num_groups,
                                   group_size=num_sub, capacity=capacity)
    raw = widen(ghist).view(num_blocks, num_sub)
    counts = raw.sum(dim=1)
    cum = torch.clamp(torch.cumsum(raw, dim=1), max=capacity)
    group_counts = torch.cat([cum[:, :1], cum[:, 1:] - cum[:, :-1]], dim=1)
    return (TupleBatch(*out), narrow(counts), narrow(group_counts),
            torch.clamp(counts - capacity, min=0).sum())


def reorder_by_partition(batch: TupleBatch, pid: torch.Tensor,
                         num_partitions: int,
                         valid: Optional[torch.Tensor] = None):
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
    out, hist_x = partition_scatter(
        key, lanes, [0] * len(lanes), num_groups=num_partitions + 1,
        group_size=1, capacity=None)
    hist = hist_x[:num_partitions]
    hi = out[3] if batch.key_hi is not None else None
    return (TupleBatch(key=out[0], rid=out[1], key_hi=hi), out[2], hist,
            exclusive_cumsum(hist))
