"""One-device joins: the count of a relation pair on one GPU.

Counterpart of ``tpu_radix_join/ops/local_join.py``:

  * :func:`local_join_sorted`: the inner keys sorted on K2, then each outer
    key's run by two ``torch.searchsorted`` (bit 31 flipped on both sides,
    ``merge_count.search_bounds``);
  * :func:`local_join_merge`: the sort-merge count, ``merge_count_chunks``
    (K2 on the packed union, then K6): 4096 uint32 partial counts;
  * :func:`local_join_partitioned`: both relations radix-partitioned into
    [P, capacity] sentinel-padded blocks (``ops/radix.scatter_to_blocks``,
    K4), every inner row sorted (``sort_lex_rows_unstable``, K2 with the
    row index as the most significant key), then each outer row searched
    in its inner row.

Every count is an int32 lane (or 0-d) holding uint32 bits, summed on the
host in uint64.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_radix_join_torch.data.tuples import TupleBatch, narrow, partition_ids
from tpu_radix_join_torch.ops.merge_count import (merge_count_chunks,
                                                  search_bounds)
from tpu_radix_join_torch.ops.radix import scatter_to_blocks
from tpu_radix_join_torch.ops.sorting import (sort_lex_rows_unstable,
                                              sort_unstable)


def local_join_sorted(r: TupleBatch, s: TupleBatch,
                      sort_impl: str = "auto") -> torch.Tensor:
    """Total match count, a 0-d int32 of the uint32 count (mod 2**32)."""
    lo, hi = search_bounds(sort_unstable(r.key, impl=sort_impl), s.key)
    return narrow((hi - lo).to(torch.int64).sum())


def local_join_merge(r: TupleBatch, s: TupleBatch,
                     sort_impl: str = "auto") -> torch.Tensor:
    """4096 uint32 partial counts (an int32 lane; the host sums them in
    uint64) by the sort-merge count.  32-bit keys only, each at most
    ``MAX_MERGE_KEY``: larger keys pack to the pads and count nothing."""
    if r.key_hi is not None or s.key_hi is not None:
        raise NotImplementedError(
            "local_join_merge compares the 32-bit key lane only; 64-bit "
            "keys take merge_count.merge_count_wide_per_partition")
    return merge_count_chunks(r.key, s.key, sort_impl=sort_impl)


def local_join_partitioned(r: TupleBatch, s: TupleBatch, fanout_bits: int,
                           capacity: int, sort_impl: str = "auto",
                           partition_impl: str = "auto"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-partition match counts, an int32 lane [1 << fanout_bits] of
    uint32 counts; the tuples that did not fit ``capacity``, 0-d int64):
    each partition probed alone.  A partition past ``capacity`` keeps its
    first tuples and reports the rest as overflow."""
    num_p = 1 << fanout_bits
    r_blocks, _, r_ovf = scatter_to_blocks(r, partition_ids(r, fanout_bits),
                                           num_p, capacity, "inner",
                                           impl=partition_impl)
    s_blocks, _, s_ovf = scatter_to_blocks(s, partition_ids(s, fanout_bits),
                                           num_p, capacity, "outer",
                                           impl=partition_impl)
    (rk,) = sort_lex_rows_unstable(r_blocks.key.view(num_p, capacity),
                                   num_keys=1, impl=sort_impl)
    lo, hi = search_bounds(rk, s_blocks.key.view(num_p, capacity))
    return narrow((hi - lo).to(torch.int64).sum(dim=1)), r_ovf + s_ovf
