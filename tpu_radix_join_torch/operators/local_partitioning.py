"""Local (second-level) radix partitioning.

Counterpart of ``tpu_radix_join/operators/local_partitioning.py``: the
second radix pass refines each rank's received tuples by the next
``local_fanout_bits`` key bits (LocalPartitioning.cpp:147-155) into a
[num_buckets, capacity] block layout whose rows are the build-probe tasks,
through ``ops/radix.scatter_to_blocks`` (K4).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_radix_join_torch.data.tuples import TupleBatch
from tpu_radix_join_torch.ops.radix import exclusive_cumsum, scatter_to_blocks


class LocalPartitionResult(NamedTuple):
    blocks: TupleBatch        # [num_buckets * capacity] lanes, pad-filled
    histogram: torch.Tensor   # int32 [num_buckets]: true per-bucket demand
    offsets: torch.Tensor     # int32 [num_buckets]: its exclusive prefix sum
    overflow: torch.Tensor    # 0-d int64: tuples that did not fit a bucket


def local_bucket_ids(batch: TupleBatch, network_fanout_bits: int,
                     local_fanout_bits: int) -> torch.Tensor:
    """Bucket = key bits [f, f + l) (LocalPartitioning.cpp:147-155).  The
    int32 shift is arithmetic, so the mask keeps at most the 32 - f bits
    that were the key's: a uint32 shift fills zeros above them."""
    bits = min(local_fanout_bits, 32 - network_fanout_bits)
    return torch.bitwise_and(batch.key >> network_fanout_bits,
                             (1 << bits) - 1)


def local_partition(batch: TupleBatch, valid: torch.Tensor,
                    network_fanout_bits: int, local_fanout_bits: int,
                    capacity: int, side: str,
                    impl: str = "auto") -> LocalPartitionResult:
    """The second radix pass into ``1 << local_fanout_bits`` buckets of
    ``capacity`` slots (K4 at every bucket count); ``impl`` is the
    partition arm (``ops/radix``)."""
    num_buckets = 1 << local_fanout_bits
    lpid = local_bucket_ids(batch, network_fanout_bits, local_fanout_bits)
    blocks, counts, overflow = scatter_to_blocks(
        batch, lpid, num_buckets, capacity, side, valid=valid, impl=impl)
    # counts is the per-bucket histogram of the same valid-masked ids
    return LocalPartitionResult(blocks=blocks, histogram=counts,
                                offsets=exclusive_cumsum(counts),
                                overflow=overflow)
