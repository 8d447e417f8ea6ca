"""Local and global partition histograms.

Counterpart of ``tpu_radix_join/histograms/local_histogram.py`` (one pass
counting tuples per network partition, LocalHistogram.cpp:20,44-47, on K1)
and ``global_histogram.py`` (the sum over ranks, GlobalHistogram.cpp:37-42).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu_radix_join_torch.data.tuples import (TupleBatch, narrow,
                                              partition_ids, widen)
from tpu_radix_join_torch.ops.radix import local_histogram


def compute_local_histogram(batch: TupleBatch, fanout_bits: int,
                            valid: Optional[torch.Tensor] = None,
                            impl: str = "auto"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pid int32 [n], histogram int32 [1 << fanout_bits] of uint32
    counts), K1 at every fanout; ``impl`` is the histogram's arm
    (``ops/radix.local_histogram``)."""
    pid = partition_ids(batch, fanout_bits)
    return pid, local_histogram(pid, 1 << fanout_bits, valid, impl=impl)


def compute_global_histogram(local_hist: torch.Tensor,
                             world) -> torch.Tensor:
    """The local histograms summed over every rank of ``world``
    (parallel/world.py): an int64 ``all_reduce`` handed back as uint32
    bits, so it equals the JAX package's uint32 ``psum`` wherever that does
    not wrap.  A world of one rank returns ``local_hist`` itself."""
    if world.size == 1:
        return local_hist
    return narrow(world.all_reduce(widen(local_hist)))
