"""Sort-merge match counting: the probe of the single-GPU join.

Counterpart of ``tpu_radix_join/ops/merge_count.py``
(``merge_count_per_partition`` on its fused-kernel path).  Both relations'
keys are packed partition-major into one uint32 lane,

    packed = pid << (32 - f) | (key >> f) << 1 | side      (R side 0, S side 1)

sorted once (K2), and scanned once (K3): every outer tuple weighs the number
of inner tuples with its key.  Keys must fit 31 bits; out-of-range keys map
to the reserved pad slots, which match nothing (the join's key-contract
check flags them).
"""

from __future__ import annotations

import torch

from tpu_radix_join_torch.ops.kernels.merge_scan import (  # noqa: F401
    _run_weights, _weights, merge_scan_partitions)
from tpu_radix_join_torch.ops.sorting import sort_unstable

# Largest valid key for the merge path (inclusive): 31-bit packing with two
# reserved pad key slots (0x7FFFFFFE, 0x7FFFFFFF) above it.
MAX_MERGE_KEY = 0x7FFFFFFD
_R_PACK_PAD = 0xFFFFFFFC   # key slot 0x7FFFFFFE, tag 0
_S_PACK_PAD = 0xFFFFFFFF   # key slot 0x7FFFFFFF, tag 1


def _pack_pm(r_keys: torch.Tensor, s_keys: torch.Tensor,
             fanout_bits: int) -> torch.Tensor:
    """Partition-major packing ``pid | key_remainder | side_tag`` (top to
    bottom bits) of both key lanes into one int32 lane: one sort then groups
    by partition first and by full key within it.  Out-of-range keys take
    the reserved key slots 0x7FFFFFFE (R) / 0x7FFFFFFF (S), runs no real
    key of the other side can share."""
    mask = (1 << fanout_bits) - 1

    # int32 arithmetic on the lanes' bits, with no int64 copies: a uint32
    # key is at most MAX_MERGE_KEY exactly when its int32 view lies in
    # [0, MAX_MERGE_KEY]; after the clamp every key is non-negative, so
    # >> is logical, and torch's int32 << wraps into bit 31 as uint32 does
    def pm(keys, pad_key, tag):
        in_range = (keys >= 0) & (keys <= MAX_MERGE_KEY)
        k = torch.where(in_range, keys, pad_key)
        packed = ((k >> fanout_bits) << 1) | tag
        if fanout_bits:
            packed |= (k & mask) << (32 - fanout_bits)
        return packed

    return torch.cat([pm(r_keys, _R_PACK_PAD >> 1, 0),
                      pm(s_keys, _S_PACK_PAD >> 1, 1)])


def merge_count_per_partition(r_keys: torch.Tensor, s_keys: torch.Tensor,
                              fanout_bits: int,
                              return_max_weight: bool = False):
    """Per-network-partition match counts, an int32 lane [1 << fanout_bits]
    of uint32 counts (each must stay below 2**32).  ``return_max_weight``
    also returns the largest single-outer-tuple match count (0-d int32 of
    uint32 bits), the input of the join's overflow-risk guard.

    The TPU path padded the sorted lane to a multiple of its 32768-element
    tile with the S pad; K3 takes any length, and the pad's weight is 0, so
    counts and max weight are the same without it."""
    packed = sort_unstable(_pack_pm(r_keys, s_keys, fanout_bits))
    counts, maxw = merge_scan_partitions(packed,
                                         num_partitions=1 << fanout_bits)
    if return_max_weight:
        return counts, maxw
    return counts
