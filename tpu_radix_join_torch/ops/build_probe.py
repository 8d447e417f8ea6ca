"""Bucketized build/probe of the partitioned join.

Counterpart of the counting half of ``tpu_radix_join/ops/build_probe.py``
(``DENSE_BUCKET_LIMIT``, ``probe_count_bucketized``, ``bucket_rows_sort``,
``bucket_rows_count``, ``probe_count_bucketized_merge``).  Inputs are
sentinel-padded key blocks, int32 [nb, bi] (inner) and [nb, bo] (outer)
holding uint32 bits; the R and S pads differ, so padding never matches.

The JAX row sort was a batched ``lax.sort`` along each row.  Here it is
``ops/sorting.sort_lex_rows_unstable``: one K2 radix sort of the
flattened rows with the row index as the most significant key.  The row
scan is plain PyTorch on the card as it was plain XLA on the TPU.  JAX
sorts by (key, tag) and gives every outer slot the weight of the inner
tuples before it in its equal-key run (a cumsum/cummax scan), which is the
run's inner count; the port sums ``inner * outer`` per run instead, a
number that does not depend on the order within a run: runs are found on
the flattened rows with a run start forced at each row's first slot,
their tag counts come from one cumsum, and the rows' sums from another.
The counts and the largest weight are the same numbers;
``torch.cummax``, which took 302 ms of a 326 ms join at 20M on the card,
is gone.
"""

from __future__ import annotations

import torch

from tpu_radix_join_torch.data.tuples import narrow, widen
from tpu_radix_join_torch.ops.sorting import sort_lex_rows_unstable

# Above this per-bucket slot count the O(bi * bo) dense compare loses to
# the batched sort-merge.
DENSE_BUCKET_LIMIT = 256
#: slots one row sort takes at most: 2**27 slots are 1.6 GB of sort lanes
#: and about 6 GB of scan temporaries on the card
ROW_CHUNK_ELEMS = 1 << 27


def probe_count_bucketized(inner_blocks: torch.Tensor,
                           outer_blocks: torch.Tensor,
                           return_max_weight: bool = False):
    """Per-bucket match counts, int32 [nb] of uint32 bits; with
    ``return_max_weight`` also the largest single-outer-tuple match count
    (0-d int32).  Dense equality for tiny buckets, else the batched
    sort-merge."""
    if max(inner_blocks.shape[1], outer_blocks.shape[1]) <= DENSE_BUCKET_LIMIT:
        eq = inner_blocks[:, :, None] == outer_blocks[:, None, :]
        counts = narrow(eq.sum(dim=(1, 2)))
        if return_max_weight:
            return counts, narrow(eq.sum(dim=1).max())
        return counts
    return probe_count_bucketized_merge(inner_blocks, outer_blocks,
                                        return_max_weight=return_max_weight)


def bucket_rows_sort(inner_blocks: torch.Tensor, outer_blocks: torch.Tensor):
    """BUILD stage: every (inner | outer) bucket row sorted by (key, tag),
    tag 0 for inner and 1 for outer.  Returns (keys, tags), int32
    [nb, bi + bo] each."""
    keys = torch.cat([inner_blocks, outer_blocks], dim=1)
    tag = torch.cat([torch.zeros_like(inner_blocks),
                     torch.ones_like(outer_blocks)], dim=1)
    # the row scan counts each equal-key run's tags, which does not depend
    # on their order within the run: the rows are sorted by key alone and
    # the tag only rides along, costing no digit pass
    return sort_lex_rows_unstable(keys, tag, num_keys=1)


def bucket_rows_count(keys: torch.Tensor, tags: torch.Tensor,
                      return_max_weight: bool = False):
    """PROBE stage: the merge weights of pre-sorted bucket rows (see the
    module docstring); per-row counts (int32 [nb] of uint32 bits), and with
    ``return_max_weight`` the largest weight (0-d int32)."""
    nb, width = keys.shape
    flat = keys.reshape(-1)
    run_start = torch.ones_like(flat, dtype=torch.bool)
    run_start[1:] = flat[1:] != flat[:-1]
    run_start.view(nb, width)[:, 0] = True
    starts = torch.nonzero(run_start).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_full((1,), flat.numel())])
    # before[i]: outer slots before flat position i
    before = torch.zeros(flat.numel() + 1, dtype=torch.int64,
                         device=keys.device)
    torch.cumsum(tags.reshape(-1), 0, dtype=torch.int64, out=before[1:])
    s_run = before[ends] - before[starts]
    r_run = ends - starts - s_run
    # runs are in flat order and every row begins one, so a row's count is
    # a difference of the prefix sums at its first run and the next row's
    total = torch.zeros(starts.numel() + 1, dtype=torch.int64,
                        device=keys.device)
    torch.cumsum(r_run * s_run, 0, out=total[1:])
    first = torch.searchsorted(starts, torch.arange(
        nb + 1, dtype=torch.int64, device=keys.device) * width)
    counts = total[first[1:]] - total[first[:-1]]
    if return_max_weight:
        return narrow(counts), narrow(torch.where(s_run > 0, r_run, 0).max())
    return narrow(counts)


def probe_count_bucketized_merge(inner_blocks: torch.Tensor,
                                 outer_blocks: torch.Tensor,
                                 return_max_weight: bool = False):
    """:func:`bucket_rows_sort` then :func:`bucket_rows_count`, over groups
    of rows of at most :data:`ROW_CHUNK_ELEMS` slots each.  Rows are
    independent, so the chunking changes no count; it bounds the row sort's
    lanes and the scan's int64 temporaries when retries have doubled the
    bucket capacity many times."""
    nb = inner_blocks.shape[0]
    width = inner_blocks.shape[1] + outer_blocks.shape[1]
    step = max(1, ROW_CHUNK_ELEMS // max(1, width))
    parts = [bucket_rows_count(
        *bucket_rows_sort(inner_blocks[lo:lo + step],
                          outer_blocks[lo:lo + step]),
        return_max_weight=True) for lo in range(0, nb, step)]
    counts = torch.cat([c for c, _ in parts])
    if return_max_weight:
        return counts, narrow(torch.stack([widen(w) for _, w in parts]).max())
    return counts
