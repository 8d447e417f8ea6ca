"""End-to-end data-integrity verification: per-partition checksums.

Counterpart of ``tpu_radix_join/robustness/verify.py`` (``:44-156``).  Every
network partition gets an order-independent fingerprint of its key lanes:

  * **count** — tuples per partition;
  * **sum** — the wrapping uint32 sum of each key lane;
  * **xor** — the xor-fold of each key lane (``ops/sorting.
    segmented_xor_fold``), which catches the paired bit flips that cancel
    in a sum.

The count and sum rows are K1's counts and weighted sums
(``ops/kernels/histogram.py``): an id at ``num_partitions`` falls outside
its bins, which is the discard bucket of invalid slots (up to 128
partitions, the port's fanout limit).  Over a world the count and sum rows
add up in int64 and keep their low 32 bits (JAX's ``psum`` wraps in
uint32), and the xor rows combine per bit: the global xor of a bit is the
parity of how many ranks set it.  Both ride one ``all_reduce``.

The engine (operators/hash_join.py) fingerprints the pristine inputs before
the exchange and what each stage received after it; a partition whose rows
disagree is damaged (:func:`damaged_partitions`).  ``DataCorruption`` is
also what the out-of-core grid raises for a key lane in the pad range.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpu_radix_join_torch.data.tuples import U32_MASK, narrow, widen
from tpu_radix_join_torch.ops.kernels.histogram import histogram
from tpu_radix_join_torch.ops.sorting import segmented_xor_fold
from tpu_radix_join_torch.robustness.retry import DATA_CORRUPTION


class DataCorruption(ValueError):
    """A per-partition checksum disagreed across pipeline stages, or a key
    lane reached the reserved pad range; carries the machine-readable
    failure class and the damaged partitions."""

    failure_class = DATA_CORRUPTION

    def __init__(self, message: str, partitions=()):
        super().__init__(message)
        self.partitions = tuple(int(p) for p in partitions)


def checksum_rows(wide: bool) -> int:
    """Rows of one relation's fingerprint: count + (sum, xor) a key lane."""
    return 5 if wide else 3


def device_partition_checksums(key: torch.Tensor, pid: torch.Tensor,
                               num_partitions: int,
                               valid: Optional[torch.Tensor] = None,
                               key_hi: Optional[torch.Tensor] = None,
                               sort_impl: str = "auto"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's fingerprint halves: ``adds``, int32 [1 + lanes, P] (the
    count row, then each lane's wrapping sum), and ``xors``, int32
    [lanes, P] (each lane's xor-fold), all of uint32 bits.  Invalid slots
    go to the discard bucket ``num_partitions``.  The sums run on K1 at any
    partition count; ``sort_impl`` is the xor-folds' sort arm."""
    p = pid if valid is None else torch.where(valid, pid, num_partitions)
    p = p.to(torch.int32)
    lanes = [key] if key_hi is None else [key, key_hi]
    adds = torch.stack([histogram(p, None, num_bins=num_partitions)]
                       + [histogram(p, lane, num_bins=num_partitions)
                          for lane in lanes])
    xors = torch.stack([segmented_xor_fold(p, lane, num_partitions,
                                           impl=sort_impl)
                        for lane in lanes])
    return adds, xors


def global_partition_checksums(key: torch.Tensor, pid: torch.Tensor,
                               num_partitions: int, world,
                               valid: Optional[torch.Tensor] = None,
                               key_hi: Optional[torch.Tensor] = None,
                               sort_impl: str = "auto") -> torch.Tensor:
    """The world's int32 ``[rows, P]`` fingerprint
    (``global_partition_checksums``): the count and sum rows summed over
    the ranks modulo 2**32, the xor rows by per-bit parity, in one
    ``all_reduce`` over ``world`` (parallel/world.py)."""
    adds, xors = device_partition_checksums(key, pid, num_partitions,
                                            valid=valid, key_hi=key_hi,
                                            sort_impl=sort_impl)
    if world.size == 1:
        return torch.cat([adds, xors])
    bits = torch.arange(32, dtype=torch.int64, device=key.device)
    parity = (widen(xors)[..., None] >> bits) & 1        # [lanes, P, 32]
    summed = world.all_reduce(torch.cat([widen(adds).reshape(-1),
                                         parity.reshape(-1)]))
    g_adds = summed[:adds.numel()].view(adds.shape) & U32_MASK
    g_par = summed[adds.numel():].view(parity.shape) & 1
    return narrow(torch.cat([g_adds, (g_par << bits).sum(dim=-1)]))


def damaged_partitions(pre: np.ndarray, post: np.ndarray) -> np.ndarray:
    """Host compare of two ``[rows, P]`` fingerprints: the sorted partition
    ids whose rows disagree (empty when intact)."""
    pre = np.asarray(pre)
    post = np.asarray(post)
    if pre.shape != post.shape:
        raise ValueError(
            f"checksum shape mismatch: {pre.shape} vs {post.shape}")
    return np.nonzero((pre != post).any(axis=0))[0]


def cross_check_counts(partition_counts: np.ndarray, matches: int,
                       r_counts: np.ndarray,
                       s_counts: np.ndarray) -> Optional[str]:
    """Join-level invariants over the reported per-partition counts: their
    uint64 sum equals the reported total, and no partition reports more
    matches than ``|R_p| * |S_p|``.  ``partition_counts`` is ``[ranks,
    P]``; ``r_counts``/``s_counts`` are the count rows of the global
    pre-exchange fingerprints.  Returns the violation, or None."""
    counts = np.asarray(partition_counts, dtype=np.uint64)
    total = int(counts.sum())
    if total != int(matches):
        return (f"sum of per-partition matches {total} != reported total "
                f"{int(matches)}")
    per_part = counts.sum(axis=0)
    bound = (np.asarray(r_counts, dtype=np.uint64)
             * np.asarray(s_counts, dtype=np.uint64))
    over = np.nonzero(per_part > bound)[0]
    if over.size:
        p = int(over[0])
        return (f"partition {p} reports {int(per_part[p])} matches, above "
                f"its |R_p|*|S_p| bound {int(bound[p])}")
    return None
