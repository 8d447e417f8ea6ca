"""Hot-partition skew splitting.

Counterpart of ``tpu_radix_join/operators/skew.py`` (the answer to skew of
hpcjoin's GPU fork, ``skew_detect`` and the ``probe_skew`` kernels,
``operators/gpu/kernels_optimized.cu:301-943``).  One dominant partition
lands on one rank whatever the assignment says; the split changes the data
movement instead.  For each hot partition

  * the inner (build) side is **replicated**: every rank extracts its hot
    inner tuples into one capacity-padded block (K4, one group) and an
    ``all_gather`` hands every rank the whole hot build side;
  * the outer (probe) side is **spread**: hot outer tuples ignore the
    assignment and go to rank ``mix32(rid) % n``;
  * every outer tuple still meets the whole hot inner side exactly once, so
    the per-partition counts sum to the exact total.

Detection is a host decision on the all-reduced global histograms, the
same on every rank.  Partition ids and lanes are int32 tensors of uint32
bits; the hot set is a uint32 bit mask over at most 32 partitions.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_radix_join_torch.data.tuples import narrow, widen
from tpu_radix_join_torch.utils.hashing import mix32

#: the hot set is one uint32 bit mask, so at most 32 partitions split
#: (the reference's default NETWORK_PARTITIONING_COUNT, Configuration.h:33)
MAX_SKEW_PARTITIONS = 32


def detect_hot_partitions(r_ghist: np.ndarray, s_ghist: np.ndarray,
                          threshold: float,
                          num_nodes: int = 0) -> np.ndarray:
    """bool [P]: the partitions worth splitting (JAX ``skew.py:44-68``,
    ``skew_detect``'s criterion reduced to split or not).

    A partition splits when its outer weight alone passes ``threshold``
    times the mean total partition weight, and replicating its inner side
    is affordable: that side is not itself hot (within ``threshold`` times
    the mean inner weight), or, with ``num_nodes`` given, ``num_nodes *
    R[p] <= S[p]`` — a tiny but relatively elevated build side must not
    veto spreading millions of probe tuples."""
    r = np.asarray(r_ghist).astype(np.float64)
    s = np.asarray(s_ghist).astype(np.float64)
    w = r + s
    affordable = r <= threshold * max(r.mean(), 1.0)
    if num_nodes > 0:
        affordable |= (num_nodes * r) <= s
    return (s > threshold * w.mean()) & affordable


def hot_mask_bits(hot: np.ndarray) -> int:
    """The bool [P <= 32] hot set packed into one uint32 constant."""
    if hot.shape[0] > MAX_SKEW_PARTITIONS:
        raise ValueError(
            f"skew splitting supports at most {MAX_SKEW_PARTITIONS} "
            f"network partitions, got {hot.shape[0]}")
    return sum(1 << i for i, h in enumerate(hot) if h)


def is_hot(pid: torch.Tensor, hot_bits: int) -> torch.Tensor:
    """bool [n]: whether each partition id (int32 lane, values < 32) is in
    the hot set.  The mask rides as its int32 bit pattern; an arithmetic
    shift keeps bit ``pid`` at bit 0 for every ``pid`` in [0, 32)."""
    mask = torch.full((), (hot_bits ^ 0x80000000) - 0x80000000,
                      dtype=torch.int32, device=pid.device)
    return torch.bitwise_and(torch.bitwise_right_shift(mask, pid), 1) == 1


def spread_destinations(rid: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """int32 [n]: the rank of each hot outer tuple, ``mix32(rid) % n`` over
    the rid's uint32 value (JAX ``skew.py:84-95``).  The mix matters: raw
    ``rid % n`` would put every tuple of a strided outer side whose rids are
    congruent mod n back on one rank.  The sizing pass and the shuffle both
    call this, so the measured capacities stay exact for any rid pattern."""
    return narrow(mix32(widen(rid)) % num_nodes)


def mask_hot(hist: torch.Tensor, hot_bits: int) -> torch.Tensor:
    """A [P] histogram with its hot partitions zeroed: they leave the
    assignment and the window accounting."""
    p = hist.shape[0]
    hot = is_hot(torch.arange(p, dtype=torch.int32, device=hist.device),
                 hot_bits)
    return torch.where(hot, torch.zeros_like(hist), hist)
