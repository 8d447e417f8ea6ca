"""Radix partitioning primitives of the port.

This slice ports ``local_histogram`` (``tpu_radix_join/ops/radix.py``); the
shuffle's ``scatter_to_blocks`` belongs to the distributed slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_radix_join_torch.ops.kernels.histogram import histogram


def local_histogram(pid: torch.Tensor, num_partitions: int,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tuples per partition (LocalHistogram.cpp:44-47): int32 lane
    [num_partitions] of uint32 counts of ``pid``.  ``valid`` (bool [n])
    masks out padding slots.  K1 on a CUDA lane, its plain version on a
    CPU lane."""
    weights = None if valid is None else valid.to(torch.int32)
    return histogram(pid, weights, num_bins=num_partitions)
