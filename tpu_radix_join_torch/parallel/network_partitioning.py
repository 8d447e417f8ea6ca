"""Network partitioning: route every tuple to its partition's owner rank.

Counterpart of ``tpu_radix_join/parallel/network_partitioning.py``
(``network_partition`` without ``exclude``/``override``, which belong to
the skew split, ROADMAP.md A10): partition id per tuple, destination per
tuple through the assignment map, then one window exchange.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpu_radix_join_torch.data.tuples import (TupleBatch, partition_ids,
                                              valid_mask)
from tpu_radix_join_torch.parallel.window import Window


class NetworkPartitionResult(NamedTuple):
    batch: TupleBatch          # received tuples, [size * capacity] lanes
    valid: torch.Tensor        # bool [size * capacity]
    pid: torch.Tensor          # int32 [size * capacity], recomputed
    recv_counts: torch.Tensor  # int64 [size]
    send_overflow: torch.Tensor


def network_partition(batch: TupleBatch, fanout_bits: int,
                      assignment: torch.Tensor, window: Window,
                      valid: Optional[torch.Tensor] = None
                      ) -> NetworkPartitionResult:
    """Exchange ``batch`` by ``assignment[pid]`` over ``window``."""
    pid = partition_ids(batch, fanout_bits)
    dest = torch.index_select(assignment, 0, pid)
    res = window.exchange(batch, dest, valid=valid)
    return NetworkPartitionResult(
        batch=res.batch, valid=valid_mask(res.batch, window.side),
        pid=partition_ids(res.batch, fanout_bits),
        recv_counts=res.recv_counts, send_overflow=res.send_overflow)
