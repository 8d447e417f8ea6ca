"""Serving fast-path device programs: O(N+Δ) delta merges and fused
multi-query batched counts.

Counterpart of ``tpu_radix_join/ops/merge_delta.py:49-218``.  Two
primitives back the serving fast paths (service/resident.py and
service/microbatch.py), both on the presorted binary-search probe of
:func:`~tpu_radix_join_torch.ops.merge_count.merge_count_presorted`:

  * **Delta merge** — a session keeps each relation's sorted key lane
    resident on the device; an incremental query sorts only its Δ new keys
    (K2, ``ops/sorting.sort_unstable``) and :func:`merge_sorted` splices
    them into the resident union with one Δ-sided ``searchsorted``, a
    marker cumsum and a monotone gather.  :func:`delta_merge_count` probes
    the outer lane against the merged union; :func:`delta_merge_increment`
    probes only the Δ against the session's resident sorted outer lane
    (multiset counts are additive).
  * **Batched count** — several small queries' key lanes concatenated,
    each element tagged with its query index above the key bits
    (``(qid << shift) | key``), one K2 sort and one probe for the whole
    batch; the per-query counts fall out of a cumulative sum read at the
    static query boundaries.

Every value is a uint32 bit pattern in an int32 lane, and keys reach
``MAX_SERVE_KEY`` while the batch composite fills all 32 bits, so every
``searchsorted`` runs on lanes with bit 31 flipped on both sides (signed
order is then the unsigned one) and K2 sorts unsigned.  Counts are the
JAX package's wrapped uint32 values: sums are taken in int64 and their low
32 bits kept.  The JAX ``compiled_*`` variants (``jax.jit`` per shape
class) are plain calls here, kept under their names.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from tpu_radix_join_torch.data.tuples import narrow, widen
from tpu_radix_join_torch.ops.merge_count import (merge_count_presorted,
                                                  search_bounds)
from tpu_radix_join_torch.ops.sorting import sort_unstable
from tpu_radix_join_torch.utils.hostsync import host_upload

#: exclusive ceiling real keys must stay under for the presorted probe
#: (0xFFFFFFFE / 0xFFFFFFFF are the pads)
MAX_SERVE_KEY = 0xFFFFFFFD
_FLIP = -(1 << 31)


def composite_shift(key_bound: int) -> int:
    """Bits the query tag must shift past: ``ceil(log2(key_bound))``, so
    ``(qid << shift) | key`` is injective over (qid, key)."""
    if key_bound < 1:
        raise ValueError("key_bound must be >= 1")
    return max(1, math.ceil(math.log2(max(2, key_bound))))


def batch_feasible(num_queries: int, key_bound: int) -> bool:
    """True when ``num_queries`` queries with keys < ``key_bound`` fit the
    uint32 composite word below the pads: the coalescer's fuse or serial
    decision."""
    shift = composite_shift(key_bound)
    if shift >= 32:
        return False
    top = (num_queries << shift) - 1
    return top <= MAX_SERVE_KEY


def merge_sorted(a_sorted: torch.Tensor,
                 b_sorted: torch.Tensor) -> torch.Tensor:
    """Merge two sorted uint32 lanes in O(N+Δ) with the work on the Δ
    side: the small lane is binary-searched into the big one (Δ·log N);
    for an unmarked slot ``j`` of the output, ``prefix[j]`` counts the
    b-elements placed before it, so it holds ``a[j - prefix[j]]`` (a
    monotone gather).  ``right=True`` places a's equal keys first."""
    n, d = a_sorted.numel(), b_sorted.numel()
    if d == 0:
        return a_sorted
    if n == 0:
        return b_sorted
    dev = a_sorted.device
    pos_b = (torch.arange(d, dtype=torch.int64, device=dev)
             + torch.searchsorted(torch.bitwise_xor(a_sorted, _FLIP),
                                  torch.bitwise_xor(b_sorted, _FLIP),
                                  right=True))
    marker = torch.zeros(n + d, dtype=torch.int32, device=dev)
    marker[pos_b] = 1
    prefix = torch.cumsum(marker, 0)
    idx = torch.arange(n + d, dtype=torch.int64, device=dev) - prefix
    out = a_sorted[torch.clamp(idx, 0, n - 1)]
    out[pos_b] = b_sorted
    return out


def delta_merge_count(resident_sorted: torch.Tensor,
                      delta_keys: torch.Tensor,
                      outer_keys: torch.Tensor, sort_impl: str = "auto"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One incremental query: sort only the Δ keys (K2), merge them into
    the resident sorted union and probe the outer lane against the merged
    union.  Returns ``(new_resident_sorted, total)``, the total a 0-d int32
    of the wrapped uint32 count.  ``sort_impl`` is the sort's arm."""
    delta_sorted = sort_unstable(delta_keys, impl=sort_impl)
    union = merge_sorted(resident_sorted, delta_sorted)
    return union, merge_count_presorted(union, outer_keys)


def compiled_delta_merge_count(n_resident: int, n_delta: int, n_outer: int):
    """:func:`delta_merge_count` (the JAX name of its per-shape program)."""
    del n_resident, n_delta, n_outer
    return delta_merge_count


def delta_merge_increment(resident_sorted: torch.Tensor,
                          delta_keys: torch.Tensor,
                          outer_sorted: torch.Tensor,
                          sort_impl: str = "auto"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One incremental query whose outer is unchanged since the last one
    on this relation: sort the Δ (K2), splice it into the resident union
    and count only the Δ's matches against the resident sorted outer lane
    (``count(s, A ⊎ Δ) = count(s, A) + count(s, Δ)``).  Returns
    ``(new_resident_sorted, increment)``, the increment a 0-d int32 of the
    wrapped uint32 sum."""
    delta_sorted = sort_unstable(delta_keys, impl=sort_impl)
    union = merge_sorted(resident_sorted, delta_sorted)
    lb, ub = search_bounds(outer_sorted, delta_sorted)
    return union, narrow((ub - lb).to(torch.int64).sum())


def compiled_delta_merge_increment(n_resident: int, n_delta: int,
                                   n_outer: int):
    """:func:`delta_merge_increment` (the JAX name of its per-shape
    program)."""
    del n_resident, n_delta, n_outer
    return delta_merge_increment


def batched_merge_count(r_keys: torch.Tensor, s_keys: torch.Tensor,
                        r_sizes: Tuple[int, ...], s_sizes: Tuple[int, ...],
                        key_bound: int, sort_impl: str = "auto"
                        ) -> torch.Tensor:
    """Fused multi-query count: one K2 sort and one probe over the
    concatenated per-query lanes.  ``r_keys`` / ``s_keys`` are the
    queries' inner and outer key lanes concatenated in query order,
    ``r_sizes`` / ``s_sizes`` the per-query lengths.  Each element is
    tagged with its query index above the key bits, so the sort groups the
    batch by query, and a weight never crosses a query boundary.

    Returns the per-query match counts, an int32 lane [num_queries] of the
    wrapped uint32 values.  The caller must have checked
    :func:`batch_feasible`."""
    q = len(r_sizes)
    if q != len(s_sizes):
        raise ValueError(f"r_sizes/s_sizes disagree: {q} != {len(s_sizes)}")
    if not batch_feasible(q, key_bound):
        raise ValueError(
            f"{q} queries at key_bound {key_bound} overflow the uint32 "
            f"composite (shift {composite_shift(key_bound)})")
    shift = composite_shift(key_bound)
    dev = r_keys.device

    def tagged(keys, sizes):
        qid = torch.repeat_interleave(
            torch.arange(q, dtype=torch.int64, device=dev),
            host_upload(sizes, dev, torch.int64),
            output_size=keys.numel())
        return narrow((qid << shift) | widen(keys))

    rc_sorted = sort_unstable(tagged(r_keys, r_sizes), impl=sort_impl)
    lb, ub = search_bounds(rc_sorted, tagged(s_keys, s_sizes))
    csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum((ub - lb).to(torch.int64), 0)])
    bounds = host_upload(
        np.concatenate([[0], np.cumsum(np.asarray(s_sizes, np.int64))]), dev)
    return narrow(csum[bounds[1:]] - csum[bounds[:-1]])


def compiled_batched_merge_count(r_sizes: Tuple[int, ...],
                                 s_sizes: Tuple[int, ...], key_bound: int):
    """:func:`batched_merge_count` for one batch shape class (the JAX name
    of its per-shape program): a call of the two key lanes (and the sort's
    arm, ``sort_impl``)."""
    return lambda r, s, sort_impl="auto": batched_merge_count(
        r, s, r_sizes, s_sizes, key_bound, sort_impl)
