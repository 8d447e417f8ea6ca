"""Sort-merge match counting: the probe of the single-GPU join.

Counterpart of ``tpu_radix_join/ops/merge_count.py`` on its fused-kernel
paths.  Three disciplines, each one sort (K2) and one scan:

  * narrow (``merge_count_per_partition``): both relations' keys packed
    partition-major into one uint32 lane,

        packed = pid << (32 - f) | (key >> f) << 1 | side   (R 0, S 1)

    scanned by K3.  Keys must fit 31 bits; out-of-range keys map to the
    reserved pad slots, which match nothing (the join's key-contract check
    flags them).
  * full range (``merge_count_per_partition_full``): every uint32 key, the
    pid rotated into the top bits, the side in a lane of its own; K5 with no
    hi lane.
  * wide (``merge_count_wide_per_partition``): 64-bit keys as (lo, hi)
    lanes; K5 over (lo rotated, hi, side).
  * chunked (``merge_count_chunks``, ``merge_count_pallas``): the narrow
    packing at fanout 0, scanned by K6 into uint32 partial sums over
    windows of positions (the out-of-core grid's count).

The grid's pipelined engine also counts against an inner lane sorted once
(``presort_keys``, K2) by binary search (``merge_count_presorted``).

Every outer tuple weighs the number of inner tuples with its key.  The JAX
package sorts the side tag as the last key; here it rides as a value: K2
is stable and the union is built ``[R..., S...]``, so R comes before S in
every run of equal keys without a digit pass for it.
"""

from __future__ import annotations

import torch

from tpu_radix_join_torch.data.tuples import narrow
from tpu_radix_join_torch.ops.kernels.merge_scan import (  # noqa: F401
    _run_weights, _weights, merge_scan_partitions)
from tpu_radix_join_torch.ops.kernels.merge_scan_chunks import (
    TILE, merge_scan_chunks)
from tpu_radix_join_torch.ops.kernels.merge_scan_wide import (
    merge_scan_partitions_wide)
from tpu_radix_join_torch.ops.sorting import sort_lex_unstable, sort_unstable

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


def _pack(r_keys: torch.Tensor, s_keys: torch.Tensor) -> torch.Tensor:
    """The packing ``key << 1 | side`` of both key lanes: the partition-major
    packing at fanout 0."""
    return _pack_pm(r_keys, s_keys, 0)


def presort_keys(keys: torch.Tensor, sort_impl: str = "auto") -> torch.Tensor:
    """Sort a raw key lane once (K2) for reuse across many probes: the inner
    side of :func:`merge_count_presorted`.  No packing and no side tag, so
    every key below the pads joins, with no ``MAX_MERGE_KEY`` ceiling."""
    return sort_unstable(keys, impl=sort_impl)


def search_bounds(r_sorted: torch.Tensor, s_keys: torch.Tensor):
    """``(lower, upper)``: each outer key's lower and upper bound in an
    already sorted inner lane (:func:`presort_keys`), int32 tensors of
    ``s_keys``' shape; [rows, width] lanes search row by row.  The lanes
    hold uint32 bits and K2 sorts them unsigned, while
    ``torch.searchsorted`` compares int32 signed: flipping bit 31 of both
    sides makes the signed order the unsigned one, so keys >= 2**31 are
    found."""
    flip = -(1 << 31)
    r_flipped = torch.bitwise_xor(r_sorted, flip)
    s_flipped = torch.bitwise_xor(s_keys, flip)
    lb = torch.searchsorted(r_flipped, s_flipped, out_int32=True)
    ub = torch.searchsorted(r_flipped, s_flipped, right=True, out_int32=True)
    return lb, ub


def presorted_weights(r_sorted: torch.Tensor, s_keys: torch.Tensor
                      ) -> torch.Tensor:
    """Each outer key's match weight, ``upper_bound - lower_bound`` over an
    already sorted inner lane (:func:`search_bounds`): an int32 tensor of
    ``s_keys``' shape."""
    lb, ub = search_bounds(r_sorted, s_keys)
    return ub - lb


def merge_count_presorted(r_sorted: torch.Tensor, s_keys: torch.Tensor,
                          return_max_weight: bool = False):
    """Duplicate-aware match count of ``s_keys`` against an already sorted
    inner lane: the uint32 total as a 0-d int32 (it wraps unless
    ``max_weight * len(s_keys) < 2**32``, the grid's window guard);
    ``return_max_weight`` also returns the largest single weight.  The
    caller keeps real keys below the pads, so an outer pad never meets an
    inner key."""
    weight = presorted_weights(r_sorted, s_keys)
    total = narrow(weight.sum())
    if return_max_weight:
        maxw = weight.max() if weight.numel() else weight.new_zeros(())
        return total, maxw
    return total


def merge_count_chunks(r_keys: torch.Tensor, s_keys: torch.Tensor,
                       num_chunks: int = 4096,
                       return_max_weight: bool = False,
                       sort_impl: str = "auto"):
    """Match count as ``num_chunks`` uint32 partial sums over equal windows
    of positions of the sorted packed union (an int32 lane; the caller sums
    them in uint64): K2, then K6 at width ``ceil(n / num_chunks)``, the
    windows past the union's end zero.  Each partial is exact while every
    window's weights stay below 2**32, which holds when the largest inner
    multiplicity times the window width does; ``return_max_weight`` also
    returns that multiplicity (0-d int32 of uint32 bits) so the caller can
    check it (``ops/chunked.chunked_join_count``).  Keys above
    ``MAX_MERGE_KEY`` pack to the pads and count nothing: the callers flag
    them."""
    packed = sort_unstable(_pack(r_keys, s_keys), impl=sort_impl)
    c = max(1, num_chunks)
    counts, maxw = merge_scan_chunks(packed,
                                     width=max(1, -(-packed.numel() // c)))
    if counts.numel() < c:
        counts = torch.cat([counts, counts.new_zeros(c - counts.numel())])
    if return_max_weight:
        return counts, maxw
    return counts


def merge_count_pallas(r_keys: torch.Tensor, s_keys: torch.Tensor,
                       sort_impl: str = "auto") -> torch.Tensor:
    """The JAX package's fused count under its name: K2 on the packed union,
    then K6 at the TPU tile width, so the uint32 per-tile partial counts
    equal the TPU kernel's (an int32 lane [ceil(n / TILE)]; host uint64
    sum).  The TPU path padded the union to a tile multiple with the S pad
    before the sort; the pads sort last and weigh 0, so no pad is needed."""
    return merge_scan_chunks(sort_unstable(_pack(r_keys, s_keys),
                                           impl=sort_impl), width=TILE)[0]


def merge_count_per_partition(r_keys: torch.Tensor, s_keys: torch.Tensor,
                              fanout_bits: int,
                              return_max_weight: bool = False,
                              sort_impl: str = "auto"):
    """Per-network-partition match counts, an int32 lane [1 << fanout_bits]
    of uint32 counts (each must stay below 2**32).  ``return_max_weight``
    also returns the largest single-outer-tuple match count (0-d int32 of
    uint32 bits), the input of the join's overflow-risk guard.

    The TPU path padded the sorted lane to a multiple of its 32768-element
    tile with the S pad; K3 takes any length, and the pad's weight is 0, so
    counts and max weight are the same without it.  Every fanout up to 30
    bits packs and scans (K3 bins past 128 partitions relative to each
    tile's first); ``sort_impl`` is the sort's arm (``ops/sorting``)."""
    packed = sort_unstable(_pack_pm(r_keys, s_keys, fanout_bits),
                           impl=sort_impl)
    counts, maxw = merge_scan_partitions(packed,
                                         num_partitions=1 << fanout_bits)
    if return_max_weight:
        return counts, maxw
    return counts


def _rotate_pid(lo: torch.Tensor, fanout_bits: int) -> torch.Tensor:
    """Rotate the low key lane right by ``fanout_bits``, so the partition id
    occupies the top bits: sorting by (lo_rot, hi) groups by partition
    first, then by (key remainder, hi), and equal keys stay adjacent, which
    is all the weight scan needs.  int32 arithmetic on the lane's bits, as
    in :func:`_pack_pm`: ``>>`` is arithmetic there, so the shifted-in sign
    bits are masked, and ``<<`` shifts only the non-negative low bits."""
    if not fanout_bits:
        return lo
    rest = 32 - fanout_bits
    return (((lo & ((1 << fanout_bits) - 1)) << rest)
            | ((lo >> fanout_bits) & ((1 << rest) - 1)))


def _side_tags(r_keys: torch.Tensor, s_keys: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(r_keys), torch.ones_like(s_keys)])


def merge_count_per_partition_full(r_keys: torch.Tensor, s_keys: torch.Tensor,
                                   fanout_bits: int,
                                   return_max_weight: bool = False,
                                   sort_impl: str = "auto"):
    """Full-range uint32 merge count: every key joins, with no 31-bit
    ``MAX_MERGE_KEY`` ceiling (the join's key contract still reserves the
    pads 0xFFFFFFFE/0xFFFFFFFF).  A one-key sort of the rotated keys with
    the side tag riding (4 passes, 2 lanes), then K5 with no hi lane.
    Returns what :func:`merge_count_per_partition` returns."""
    rot, tag = sort_lex_unstable(
        torch.cat([_rotate_pid(r_keys, fanout_bits),
                   _rotate_pid(s_keys, fanout_bits)]),
        _side_tags(r_keys, s_keys), num_keys=1, impl=sort_impl)
    counts, maxw = merge_scan_partitions_wide(
        rot, None, tag, num_partitions=1 << fanout_bits)
    if return_max_weight:
        return counts, maxw
    return counts


def merge_count_wide_per_partition(r_lo: torch.Tensor, r_hi: torch.Tensor,
                                   s_lo: torch.Tensor, s_hi: torch.Tensor,
                                   fanout_bits: int,
                                   return_max_weight: bool = False,
                                   sort_impl: str = "auto"):
    """64-bit-key match counting on two uint32 lanes: a two-key sort of
    (rotated lo, hi) with the side tag riding (8 passes, 3 lanes), then K5.
    The pads sit in both lanes and the R and S pads differ in the hi lane,
    so padding never matches.  Returns what
    :func:`merge_count_per_partition` returns."""
    lo_rot, hi, tag = sort_lex_unstable(
        torch.cat([_rotate_pid(r_lo, fanout_bits),
                   _rotate_pid(s_lo, fanout_bits)]),
        torch.cat([r_hi, s_hi]), _side_tags(r_lo, s_lo), num_keys=2,
        impl=sort_impl)
    counts, maxw = merge_scan_partitions_wide(
        lo_rot, hi, tag, num_partitions=1 << fanout_bits)
    if return_max_weight:
        return counts, maxw
    return counts
