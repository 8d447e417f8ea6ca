"""Network partitioning: route every tuple to its partition's owner rank.

Counterpart of ``tpu_radix_join/parallel/network_partitioning.py``
(``network_partition``): partition id per tuple, destination per tuple
through the assignment map, then one window exchange, the partition ids
riding along for the packed codec.  The skew split (operators/skew.py)
withholds hot inner tuples (``exclude``) and sends hot outer tuples to
their spread ranks (``override``).  :func:`receive_checksums` fingerprints
what an exchange delivered, for integrity verification
(robustness/verify.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tpu_radix_join_torch.data.tuples import (TupleBatch, partition_ids,
                                              valid_mask)
from tpu_radix_join_torch.parallel.window import Window
from tpu_radix_join_torch.robustness.verify import global_partition_checksums


class NetworkPartitionResult(NamedTuple):
    batch: TupleBatch          # received tuples, [size * capacity] lanes
    valid: torch.Tensor        # bool [size * capacity]
    pid: torch.Tensor          # int32 [size * capacity], recomputed
    recv_counts: torch.Tensor  # int64 [size]
    send_overflow: torch.Tensor


def network_partition(batch: TupleBatch, fanout_bits: int,
                      assignment: torch.Tensor, window: Window,
                      valid: Optional[torch.Tensor] = None,
                      exclude: Optional[torch.Tensor] = None,
                      override: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None
                      ) -> NetworkPartitionResult:
    """Exchange ``batch`` by ``assignment[pid]`` over ``window``
    (JAX ``network_partitioning.py:38-60``).  ``exclude``: bool [n], tuples
    withheld from the exchange.  ``override``: (bool mask [n], int32
    destination [n]), tuples whose destination ignores the assignment."""
    pid = partition_ids(batch, fanout_bits)
    dest = torch.index_select(assignment, 0, pid)
    if override is not None:
        dest = torch.where(override[0], override[1], dest)
    if exclude is not None:
        valid = ~exclude if valid is None else (valid & ~exclude)
    # the pid rides along for the packed codec, which drops the fanout bits
    # and restores them from the block headers
    res = window.exchange(batch, dest, valid=valid, pid=pid)
    return NetworkPartitionResult(
        batch=res.batch, valid=valid_mask(res.batch, window.side),
        pid=partition_ids(res.batch, fanout_bits),
        recv_counts=res.recv_counts, send_overflow=res.send_overflow)


def receive_checksums(res: NetworkPartitionResult, num_partitions: int,
                      world) -> torch.Tensor:
    """The world's int32 ``[rows, P]`` integrity fingerprint of what the
    exchange delivered (``receive_checksums``, ``network_partitioning.py:
    74-85``), taken on the received (unpacked) lanes: equal to the
    pre-exchange fingerprint when the exchange conserved every tuple and
    every key bit."""
    return global_partition_checksums(res.batch.key, res.pid, num_partitions,
                                      world, valid=res.valid,
                                      key_hi=res.batch.key_hi)
