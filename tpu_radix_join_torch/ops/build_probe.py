"""Build/probe: the bucketized probe, the chunked probe, ``probe_count``
and the materializing probes.

Counterpart of ``tpu_radix_join/ops/build_probe.py`` (``DENSE_BUCKET_LIMIT``,
``probe_count_bucketized``, ``bucket_rows_sort``, ``bucket_rows_count``,
``probe_count_bucketized_merge``, ``_per_partition_counts``,
``probe_count_per_partition``, ``probe_count_chunked``, ``_probe_bounds``,
``_wide_union_scan``, ``probe_count``, ``MaterializedMatches``,
``probe_materialize``, ``_materialize_rows_narrow``,
``probe_materialize_chunked``).

**The materializing probes** (the reference's ``probe_match_rate``,
kernels.cu:314-411): each outer tuple emits up to ``cap`` (r_rid, s_rid)
pairs into a static [rows, cap] buffer with a validity mask, and the tuples
whose match count passes ``cap`` are counted as the overflow.  Narrow keys
sort the inner side once on K2 (key and rid) and find each outer key's
run with two ``torch.searchsorted`` (bit 31 flipped on both sides, so
full-range keys are found; ``merge_count.search_bounds``); the pairs are
then a gather ``r_rid_sorted[lo + k]`` for k < cap, plain PyTorch as it was
plain XLA.  64-bit keys take the union scan (:func:`_wide_union_scan`):
one K2 sort of the (hi, lo) union, the side tag and one carried lane
riding (K2 is stable and the union is built ``[R..., S...]``, so every
run's inner tuples come first without a digit pass for the tag, and four
lanes are K2's limit), then a cumsum gives each outer position its run's
inner ranks ``[base, c_r)``; the run's base is read at its start through
the run ids (a cumsum), not by ``cummax``.  The s_rid lane is the outer
rid ``expand``ed over the cap, a view: the caller compacts the valid pairs
(indexed at ``nonzero_static`` of the valid mask) without copying it.  The JAX function returns
flat lanes; here ``.reshape(-1)`` of the [rows, cap] lanes is that layout.

**The chunked probe** (``JoinConfig.chunk_size``, the reference's
large-data probe, kernels.cu:778-856): the outer side streams in slabs
against the inner side.  Narrow keys sort the inner lane once on K2 and
give each outer key its weight by two ``torch.searchsorted`` (the JAX
function's, computed outside any Pallas kernel there too), then the
pid-weighted sum per partition on K1 (the JAX ``bincount``'s wrapping
uint32 sums, in shared-memory bins); a Python loop over the slabs stands
in for ``lax.scan``.  64-bit keys join each slab with the whole inner side on K2
and K5 (``merge_count_wide_per_partition``), which takes each position's
partition from the low bits of its key: the outer pid lane the JAX union
scan carries is exactly those bits on the receive buffers, and a pad,
whatever its pid, weighs nothing.

**The partitioned join's buckets.**  Inputs are
sentinel-padded key blocks, int32 [nb, bi] (inner) and [nb, bo] (outer)
holding uint32 bits, and for 64-bit keys their hi-lane blocks of the same
shapes; the R and S pads differ (in the hi lane too), so padding never
matches.

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

import itertools
from typing import NamedTuple, Optional

import torch

from tpu_radix_join_torch.data.tuples import (PAD_RID, CompressedBatch,
                                              narrow, pad_sentinel, widen)
from tpu_radix_join_torch.ops.kernels.histogram import histogram
from tpu_radix_join_torch.ops.merge_count import (
    merge_count_wide_per_partition, presorted_weights, search_bounds)
from tpu_radix_join_torch.ops.sorting import (sort_kv_unstable,
                                              sort_lex_rows_unstable,
                                              sort_lex_unstable,
                                              sort_unstable)
from tpu_radix_join_torch.utils.hostsync import host_readback

# Above this per-bucket slot count the O(bi * bo) dense compare loses to
# the batched sort-merge.
DENSE_BUCKET_LIMIT = 256
#: slots one row sort takes at most: 2**27 slots are 1.6 GB of sort lanes
#: and about 6 GB of scan temporaries on the card
ROW_CHUNK_ELEMS = 1 << 27


def _per_partition_counts(r_sorted: torch.Tensor, s_keys: torch.Tensor,
                          pid: torch.Tensor, num_partitions: int):
    """Dual searchsorted against the sorted inner lane, then the
    pid-weighted sum on K1: ``(counts, max weight)``, int32 [P] of uint32
    bits (each count mod 2**32, as the JAX bincount's uint32) and a 0-d
    int32."""
    weight = presorted_weights(r_sorted, s_keys)
    counts = histogram(pid, weight, num_bins=num_partitions)
    maxw = weight.max() if weight.numel() else weight.new_zeros(())
    return counts, maxw


def probe_count_per_partition(inner: CompressedBatch, outer: CompressedBatch,
                              outer_pid: torch.Tensor, num_partitions: int,
                              return_max_weight: bool = False,
                              sort_impl: str = "auto"):
    """Per-partition match counts, int32 [num_partitions] of uint32 bits;
    ``return_max_weight`` also returns the largest single-outer-tuple count
    (0-d int32).  Narrow keys: the inner lane sorted on K2 and
    :func:`_per_partition_counts`.  64-bit keys: K2 and K5 over the union,
    partitions from the keys' low bits (see the module docstring), so
    ``outer_pid`` must hold those bits at every real outer tuple.
    ``sort_impl`` is every sort's arm (``ops/sorting``)."""
    if inner.key_rem_hi is not None:
        fanout = num_partitions.bit_length() - 1
        if num_partitions != 1 << fanout:
            raise ValueError("num_partitions must be a power of two")
        counts, maxw = merge_count_wide_per_partition(
            inner.key_rem, inner.key_rem_hi, outer.key_rem, outer.key_rem_hi,
            fanout, return_max_weight=True, sort_impl=sort_impl)
    else:
        counts, maxw = _per_partition_counts(
            sort_unstable(inner.key_rem, impl=sort_impl), outer.key_rem,
            outer_pid, num_partitions)
    return (counts, maxw) if return_max_weight else counts


def _slabs(lane: torch.Tensor, slab_size: int, fill: int):
    """The slabs of ``lane``, the last one padded with ``fill`` to
    ``slab_size``."""
    for lo in range(0, lane.numel(), slab_size):
        slab = lane[lo:lo + slab_size]
        if slab.numel() < slab_size:
            slab = torch.cat([slab, slab.new_full(
                (slab_size - slab.numel(),), fill)])
        yield slab


def probe_count_chunked(inner: CompressedBatch, outer: CompressedBatch,
                        outer_pid: torch.Tensor, num_partitions: int,
                        slab_size: int, return_max_weight: bool = False,
                        sort_impl: str = "auto"):
    """Per-partition counts with the outer side streamed in ``slab_size``
    slabs (the JAX ``lax.scan`` as a loop): the same numbers as
    :func:`probe_count_per_partition`, with a working set of O(inner +
    slab).  The last slab is padded with the S sentinel — in both key lanes
    for 64-bit keys (the ``make_padding(wide=True)`` contract) — and pid
    0, and pads match nothing.  Counts sum over the slabs mod 2**32."""
    if slab_size < 1:
        raise ValueError("slab_size must be >= 1")
    fill = int(narrow(torch.tensor(pad_sentinel("outer"))))
    wide = inner.key_rem_hi is not None
    dev = outer.key_rem.device
    total = torch.zeros(num_partitions, dtype=torch.int64, device=dev)
    maxws = []
    r_sorted = None if wide else sort_unstable(inner.key_rem, impl=sort_impl)
    hi_slabs = (_slabs(outer.key_rem_hi, slab_size, fill) if wide
                else itertools.repeat(None))
    for lo, hi, pid in zip(_slabs(outer.key_rem, slab_size, fill), hi_slabs,
                           _slabs(outer_pid, slab_size, 0)):
        if wide:
            counts, maxw = probe_count_per_partition(
                inner, CompressedBatch(lo, pid, hi), pid, num_partitions,
                return_max_weight=True, sort_impl=sort_impl)
        else:
            counts, maxw = _per_partition_counts(r_sorted, lo, pid,
                                                 num_partitions)
        total += widen(counts)
        maxws.append(maxw)
    counts = narrow(total)
    if not return_max_weight:
        return counts
    maxw = (torch.stack(maxws).max() if maxws
            else torch.zeros((), dtype=torch.int32, device=dev))
    return counts, maxw


def probe_count_bucketized(inner_blocks: torch.Tensor,
                           outer_blocks: torch.Tensor,
                           inner_hi: Optional[torch.Tensor] = None,
                           outer_hi: Optional[torch.Tensor] = None,
                           return_max_weight: bool = False, run=None,
                           sort_impl: str = "auto"):
    """Per-bucket match counts, int32 [nb] of uint32 bits; with
    ``return_max_weight`` also the largest single-outer-tuple match count
    (0-d int32).  Dense equality for tiny buckets, else the batched
    sort-merge; 64-bit keys add their hi-lane blocks.  ``run`` times the
    sort-merge's stages (:func:`probe_count_bucketized_merge`)."""
    if max(inner_blocks.shape[1], outer_blocks.shape[1]) <= DENSE_BUCKET_LIMIT:
        eq = inner_blocks[:, :, None] == outer_blocks[:, None, :]
        if inner_hi is not None:
            eq &= inner_hi[:, :, None] == outer_hi[:, None, :]
        counts = narrow(eq.sum(dim=(1, 2)))
        if return_max_weight:
            return counts, narrow(eq.sum(dim=1).max())
        return counts
    return probe_count_bucketized_merge(inner_blocks, outer_blocks, inner_hi,
                                        outer_hi,
                                        return_max_weight=return_max_weight,
                                        run=run, sort_impl=sort_impl)


def bucket_rows_sort(inner_blocks: torch.Tensor, outer_blocks: torch.Tensor,
                     inner_hi: Optional[torch.Tensor] = None,
                     outer_hi: Optional[torch.Tensor] = None,
                     sort_impl: str = "auto"):
    """BUILD stage: every (inner | outer) bucket row sorted by key — (hi,
    key) for 64-bit keys — with the tag, 0 for inner and 1 for outer,
    riding.  Returns (keys, tags), or (his, keys, tags) for 64-bit keys,
    int32 [nb, bi + bo] each."""
    keys = torch.cat([inner_blocks, outer_blocks], dim=1)
    tag = torch.cat([torch.zeros_like(inner_blocks),
                     torch.ones_like(outer_blocks)], dim=1)
    # the row scan counts each equal-key run's tags, which does not depend
    # on their order within the run: the rows are sorted by key alone and
    # the tag only rides along, costing no digit pass.  With the row index
    # the wide sort moves (row, hi, key, tag): four lanes, K2's limit.
    if inner_hi is not None:
        his = torch.cat([inner_hi, outer_hi], dim=1)
        return sort_lex_rows_unstable(his, keys, tag, num_keys=2,
                                      impl=sort_impl)
    return sort_lex_rows_unstable(keys, tag, num_keys=1, impl=sort_impl)


def bucket_rows_count(*sorted_lanes: torch.Tensor,
                      return_max_weight: bool = False):
    """PROBE stage: the merge weights of pre-sorted bucket rows (see the
    module docstring) given as (keys, tags) or (his, keys, tags); per-row
    counts (int32 [nb] of uint32 bits), and with ``return_max_weight`` the
    largest weight (0-d int32).  A run is a stretch of equal (hi, key)."""
    *key_lanes, tags = sorted_lanes
    nb, width = tags.shape
    first_lane, *more = [lane.reshape(-1) for lane in key_lanes]
    run_start = torch.ones(nb * width, dtype=torch.bool, device=tags.device)
    run_start[1:] = first_lane[1:] != first_lane[:-1]
    for flat in more:
        run_start[1:] |= flat[1:] != flat[:-1]
    run_start.view(nb, width)[:, 0] = True
    # the run count sizes the starts: one readback (nonzero's own sync)
    starts = torch.nonzero_static(
        run_start, size=int(host_readback(run_start.sum()))).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_full((1,), nb * width)])
    # before[i]: outer slots before flat position i
    before = torch.zeros(nb * width + 1, dtype=torch.int64,
                         device=tags.device)
    torch.cumsum(tags.reshape(-1), 0, dtype=torch.int64, out=before[1:])
    s_run = before[ends] - before[starts]
    r_run = ends - starts - s_run
    # runs are in flat order and every row begins one, so a row's count is
    # a difference of the prefix sums at its first run and the next row's
    total = torch.zeros(starts.numel() + 1, dtype=torch.int64,
                        device=tags.device)
    torch.cumsum(r_run * s_run, 0, out=total[1:])
    first = torch.searchsorted(starts, torch.arange(
        nb + 1, dtype=torch.int64, device=tags.device) * width)
    counts = total[first[1:]] - total[first[:-1]]
    if return_max_weight:
        return narrow(counts), narrow(torch.where(s_run > 0, r_run, 0).max())
    return narrow(counts)


def probe_count_bucketized_merge(inner_blocks: torch.Tensor,
                                 outer_blocks: torch.Tensor,
                                 inner_hi: Optional[torch.Tensor] = None,
                                 outer_hi: Optional[torch.Tensor] = None,
                                 return_max_weight: bool = False, run=None,
                                 sort_impl: str = "auto"):
    """:func:`bucket_rows_sort` then :func:`bucket_rows_count`, over groups
    of rows of at most :data:`ROW_CHUNK_ELEMS` slots each.  Rows are
    independent, so the chunking changes no count; it bounds the row sort's
    lanes and the scan's int64 temporaries when retries have doubled the
    bucket capacity many times.  ``run(stage, fn, *args)``, when given,
    calls each stage — "BPBUILD" for a group's row sort, "BPPROBE" for its
    scan — so the engine can time them (``measure_phases``)."""
    if run is None:
        def run(stage, fn, *args, **kw):
            return fn(*args, **kw)
    nb = inner_blocks.shape[0]
    width = inner_blocks.shape[1] + outer_blocks.shape[1]
    step = max(1, ROW_CHUNK_ELEMS // max(1, width))

    def rows(a, lo):
        return None if a is None else a[lo:lo + step]

    parts = [run("BPPROBE", bucket_rows_count, *run(
        "BPBUILD", bucket_rows_sort, rows(inner_blocks, lo),
        rows(outer_blocks, lo), rows(inner_hi, lo), rows(outer_hi, lo),
        sort_impl=sort_impl),
        return_max_weight=True) for lo in range(0, nb, step)]
    counts = torch.cat([c for c, _ in parts])
    if return_max_weight:
        return counts, narrow(torch.stack([widen(w) for _, w in parts]).max())
    return counts


# ---------------------------------------------------------------- probes
def _probe_bounds(r_keys: torch.Tensor, s_keys: torch.Tensor,
                  sort_impl: str = "auto"):
    """(inner lane sorted on K2, lower bounds, upper bounds) of each outer
    key."""
    r_sorted = sort_unstable(r_keys, impl=sort_impl)
    lo, hi = search_bounds(r_sorted, s_keys)
    return r_sorted, lo, hi


def _wide_union_scan(inner: CompressedBatch, outer: CompressedBatch,
                     *carried: torch.Tensor, sort_impl: str = "auto"):
    """The rank-space scan of the (hi, lo) union: the 64-bit keys'
    replacement for ``searchsorted``.  One K2 sort of (hi, lo) with the side
    tag and at most one ``carried`` lane ([n_outer], the inner slots filled
    with ``PAD_RID``) riding; then at every outer position ``[base, c_r)``
    is its run's range in the inner side sorted alone.  Returns (tag, base,
    c_r, *carried sorted): int32 lanes of the union's length, the tag 1 at
    outer positions."""
    if len(carried) > 1:
        raise ValueError("K2 moves four lanes: one carried lane at most")
    n_r, dev = inner.size, inner.key_rem.device
    hi = torch.cat([inner.key_rem_hi, outer.key_rem_hi])
    lo = torch.cat([inner.key_rem, outer.key_rem])
    tag = torch.cat([torch.zeros(n_r, dtype=torch.int32, device=dev),
                     torch.ones(outer.size, dtype=torch.int32, device=dev)])
    pad = torch.full((n_r,), int(narrow(torch.tensor(PAD_RID))),
                     dtype=torch.int32, device=dev)
    hi, lo, tag, *carried_sorted = sort_lex_unstable(
        hi, lo, tag, *(torch.cat([pad, c]) for c in carried), num_keys=2,
        impl=sort_impl)
    run_start = torch.ones(lo.numel(), dtype=torch.bool, device=dev)
    run_start[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    is_r = 1 - tag
    c_r = torch.cumsum(is_r, 0, dtype=torch.int32)
    # each run's base, the inner tuples before it, read at its start
    run_id = torch.cumsum(run_start, 0) - 1
    starts = torch.nonzero_static(
        run_start, size=int(host_readback(run_start.sum()))).squeeze(1)
    base = (c_r - is_r)[starts][run_id]
    return (tag, base, c_r, *carried_sorted)


def probe_count(inner: CompressedBatch, outer: CompressedBatch,
                sort_impl: str = "auto") -> torch.Tensor:
    """Exact number of matching (r, s) pairs, duplicates on both sides
    included, as a 0-d int32 holding the uint32 count (mod 2**32, as the
    JAX function's uint32 sum).  64-bit keys take the union scan."""
    if inner.key_rem_hi is not None:
        tag, base, c_r = _wide_union_scan(inner, outer, sort_impl=sort_impl)
        return narrow((tag * (c_r - base)).to(torch.int64).sum())
    _, lo, hi = _probe_bounds(inner.key_rem, outer.key_rem, sort_impl)
    return narrow((hi - lo).to(torch.int64).sum())


class MaterializedMatches(NamedTuple):
    r_rid: torch.Tensor      # int32 [rows, cap]: inner rids (uint32 bits)
    s_rid: torch.Tensor      # int32 [rows, cap]: outer rids (an expand view)
    valid: torch.Tensor      # bool  [rows, cap]
    overflow: torch.Tensor   # 0-d int64: outer tuples with more than cap


def _rows(r_rid_sorted: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
          cap: int, outer: Optional[torch.Tensor] = None):
    """The pair rows of outer positions whose matches are the sorted inner
    ranks ``[lo, hi)``: (r_rid, valid, overflow) as in
    :class:`MaterializedMatches`; ``outer`` masks the rows that emit."""
    k = torch.arange(cap, dtype=torch.int32, device=lo.device)[None, :]
    idx = lo[:, None] + k
    valid = idx < hi[:, None]
    over = (hi - lo) > cap
    if outer is not None:
        valid &= outer[:, None]
        over &= outer
    n_r = r_rid_sorted.numel()
    if n_r:
        r_rid = r_rid_sorted[torch.clamp(idx, max=n_r - 1)]
    else:
        r_rid = torch.zeros_like(idx)
    return r_rid, valid, over.sum()


def _materialize_rows_narrow(r_sorted: torch.Tensor,
                             r_rid_sorted: torch.Tensor,
                             outer_keys: torch.Tensor,
                             outer_rids: torch.Tensor, cap: int):
    """The narrow materialization against an inner side already sorted
    (key and rid): ([n, cap] r_rid, [n, cap] s_rid, [n, cap] valid,
    overflow), shared by the resident probe and each slab of the chunked
    one."""
    lo, hi = search_bounds(r_sorted, outer_keys)
    r_rid, valid, overflow = _rows(r_rid_sorted, lo, hi, cap)
    return r_rid, outer_rids[:, None].expand(-1, cap), valid, overflow


def probe_materialize(inner: CompressedBatch, outer: CompressedBatch,
                      cap: int, sort_impl: str = "auto"
                      ) -> MaterializedMatches:
    """Matching rid pairs, up to ``cap`` an outer tuple, and the overflow.
    Narrow keys: [n_outer, cap] rows.  64-bit keys: [n_inner + n_outer,
    cap] rows in the union's sorted order, the inner positions all
    invalid (the JAX layout)."""
    if inner.key_rem_hi is not None:
        _, _, r_rid_sorted = sort_lex_unstable(
            inner.key_rem_hi, inner.key_rem, inner.rid, num_keys=2,
            impl=sort_impl)
        tag, base, c_r, s_rid_sorted = _wide_union_scan(
            inner, outer, outer.rid, sort_impl=sort_impl)
        r_rid, valid, overflow = _rows(r_rid_sorted, base, c_r, cap,
                                       tag == 1)
        return MaterializedMatches(
            r_rid, s_rid_sorted[:, None].expand(-1, cap), valid, overflow)
    r_sorted, r_rid_sorted = sort_kv_unstable(inner.key_rem, inner.rid,
                                              impl=sort_impl)
    return MaterializedMatches(*_materialize_rows_narrow(
        r_sorted, r_rid_sorted, outer.key_rem, outer.rid, cap))


def probe_materialize_chunked(inner: CompressedBatch, outer: CompressedBatch,
                              cap: int, slab_size: int,
                              sort_impl: str = "auto"
                              ) -> MaterializedMatches:
    """:func:`probe_materialize` with the outer side streamed in
    ``slab_size`` slabs (the JAX ``lax.scan`` as a loop; the reference's LD
    output kernels, kernels.cu:778-856): [n_padded, cap] rows, the outer
    side padded to a slab multiple with the S sentinel (both key lanes)
    and ``PAD_RID``, which match nothing.  The inner side is sorted once.
    64-bit keys scan each slab's union with the whole inner side, carrying
    each outer tuple's slab position, and write its rows back at that
    position: the result has the narrow layout whatever the slab."""
    if slab_size < 1:
        raise ValueError("slab_size must be >= 1")
    fill = int(narrow(torch.tensor(pad_sentinel("outer"))))
    rid_fill = int(narrow(torch.tensor(PAD_RID)))
    dev = outer.key_rem.device
    n_pad = -(-outer.size // slab_size) * slab_size
    s_rid = torch.cat([outer.rid, outer.rid.new_full(
        (n_pad - outer.size,), rid_fill)])
    r_rid = torch.empty((n_pad, cap), dtype=torch.int32, device=dev)
    valid = torch.empty((n_pad, cap), dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    wide = inner.key_rem_hi is not None
    if wide:
        _, _, r_rid_sorted = sort_lex_unstable(
            inner.key_rem_hi, inner.key_rem, inner.rid, num_keys=2,
            impl=sort_impl)
        pos_lane = torch.arange(slab_size, dtype=torch.int32, device=dev)
        hi_slabs = _slabs(outer.key_rem_hi, slab_size, fill)
    else:
        r_sorted, r_rid_sorted = sort_kv_unstable(inner.key_rem, inner.rid,
                                                  impl=sort_impl)
        hi_slabs = itertools.repeat(None)
    for off, lo, hi in zip(range(0, n_pad, slab_size),
                           _slabs(outer.key_rem, slab_size, fill), hi_slabs):
        rids = s_rid[off:off + slab_size]
        if wide:
            tag, base, c_r, pos = _wide_union_scan(
                inner, CompressedBatch(lo, rids, hi), pos_lane,
                sort_impl=sort_impl)
            outer_rows = tag == 1
            rows_r, rows_v, ovf = _rows(r_rid_sorted, base[outer_rows],
                                        c_r[outer_rows], cap)
            at = pos[outer_rows].to(torch.int64) + off
            r_rid[at], valid[at] = rows_r, rows_v
        else:
            rows_r, _, rows_v, ovf = _materialize_rows_narrow(
                r_sorted, r_rid_sorted, lo, rids, cap)
            r_rid[off:off + slab_size] = rows_r
            valid[off:off + slab_size] = rows_v
        overflow += ovf
    return MaterializedMatches(r_rid, s_rid[:, None].expand(-1, cap), valid,
                               overflow)
