"""Wider fanout (ROADMAP A19) at kernel level: the plain versions of K1, K3,
K5 and K4 past the narrow kernels' shared bins, held bit for bit against
the JAX package's XLA and sort arms (the arms JAX's ``auto`` takes on the
CPU), and numpy emulations of the card's wide designs held against the
plain versions:

  * K1 (``histogram_plain``, ``local_histogram``) at 129, 1024, 4097,
    2**14, 2**15 + 1, 2**16 and 2**17 bins, counts, valid masks and
    uint32 weights, on random, sorted, constant and out-of-range ids,
    against JAX ``local_histogram(impl="xla")`` (uint32 weights against
    numpy, JAX's Pallas arm holding 128);
  * K3 and K5 (``merge_count_per_partition``, ``_full``,
    ``merge_count_wide_per_partition``) at fanouts 8, 10 and 12 against
    JAX's XLA path, and the wide binning of
    ``csrc/merge_scan_partitions.cuh`` (bins relative to a tile's first
    partition, a pid past them straight to the global count) emulated;
  * K4 (``partition_scatter`` on the CPU, ``scatter_to_blocks``,
    ``scatter_to_blocks_grouped``, ``reorder_by_partition`` with ``valid``)
    at 257, 1025 and 4097 groups, dense and blocked (32 x 16 blocks,
    256 x 4), clipped, against JAX's sort arm and a numpy stable oracle,
    and the MSD passes of ``csrc/partition_msd.cu`` (K1's totals, the
    starts, a coarse pass by the top digit that drops invalid ids, the
    segmented passes with their tile maps and per-segment look-back, the
    final layout and the pads; the card's path past 8192 groups) emulated
    from one group past that cap to 65,537 groups, dense, blocked, clipped
    and grouped 4 x 4096, against the plain version and JAX's sort arm
    (the wide kernel below it: ``tests/test_torch_partition_wide.py``);
  * the packed wire's geometry at fanouts 6-10.

JAX's sort arm is ``lax.sort(is_stable=False)``, so within one group its
order is its own: counts, overflow and each block's tuples (as sets) are
held against it, and the lanes bit for bit against the stable oracle,
which is K4's contract.  Tolerance 0 everywhere."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_radix_join.data import tuples as JT  # noqa: E402
from tpu_radix_join.ops import merge_count as jmc  # noqa: E402
from tpu_radix_join.ops import radix as jradix  # noqa: E402

from tpu_radix_join_torch.data import tuples as TT  # noqa: E402
from tpu_radix_join_torch.data.tuples import (lane_from_numpy,  # noqa: E402
                                              lane_to_numpy)
from tpu_radix_join_torch.ops import merge_count as tmc  # noqa: E402
from tpu_radix_join_torch.ops import radix as tradix  # noqa: E402
from tpu_radix_join_torch.ops.kernels import histogram as k1  # noqa: E402
from tpu_radix_join_torch.ops.kernels import merge_scan as k3  # noqa: E402
from tpu_radix_join_torch.ops.kernels import merge_scan_wide as k5  # noqa: E402
from tpu_radix_join_torch.ops.kernels import partition as k4  # noqa: E402

ONES = 0xFFFFFFFF


def _lane(a):
    return lane_from_numpy(np.asarray(a, np.uint32), "cpu")


def _np(t):
    return lane_to_numpy(t)


# ------------------------------------------------------------ K1 wide
def _ids(kind, n, bins, rng):
    if kind == "random":
        return rng.integers(0, bins, n).astype(np.uint32)
    if kind == "sorted":
        return np.sort(rng.integers(0, bins, n)).astype(np.uint32)
    if kind == "constant":
        return np.full(n, bins - 1, np.uint32)
    # out of range: a quarter past the bins, below 2**31, where JAX's
    # int32 bincount drops them as K1 does (it clips the int32 negatives
    # of larger ids into bin 0; K1 ignores every id >= num_bins)
    ids = rng.integers(0, bins, n).astype(np.uint32)
    far = rng.random(n) < 0.25
    ids[far] = rng.integers(bins, 1 << 31, int(far.sum())).astype(np.uint32)
    ids[:3] = (bins, (1 << 31) - 1, bins + 1)
    return ids


@pytest.mark.parametrize("bins", [129, 1024, 4097, 1 << 14, (1 << 15) + 1,
                                  1 << 16, 1 << 17])
@pytest.mark.parametrize("kind", ["random", "sorted", "constant",
                                  "out_of_range"])
def test_histogram_past_128_bins_equals_jax_xla(bins, kind):
    """Counts and valid-masked counts equal JAX ``local_histogram``'s
    bincount arm; uint32 weight sums wrap as numpy's."""
    rng = np.random.default_rng(bins + len(kind))
    n = 6000
    ids = _ids(kind, n, bins, rng)
    valid = rng.random(n) > 0.2
    for mask in (None, valid):
        want = np.asarray(jradix.local_histogram(
            jnp.asarray(ids), bins,
            None if mask is None else jnp.asarray(mask), impl="xla"))
        got = tradix.local_histogram(
            _lane(ids), bins, None if mask is None else torch.from_numpy(mask))
        np.testing.assert_array_equal(_np(got), want)
        base = tradix.local_histogram(
            _lane(ids), bins, None if mask is None else torch.from_numpy(mask),
            impl="sort")
        np.testing.assert_array_equal(_np(base), want)
    w = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    ids[-2:] = (ONES, 1 << 31)        # ignored by K1's contract
    keep = ids < bins
    want = np.zeros(bins, np.uint64)
    np.add.at(want, ids[keep], w[keep].astype(np.uint64))
    got = k1.histogram(_lane(ids), _lane(w), num_bins=bins)
    np.testing.assert_array_equal(
        _np(got), (want & np.uint64(ONES)).astype(np.uint32))


def test_histogram_rejects_what_the_kernels_do_not_take():
    ids = _lane(np.zeros(8, np.uint32))
    for bad in (0, 1 << 31):
        with pytest.raises(ValueError, match="num_bins"):
            k1.histogram(ids, num_bins=bad)
    with pytest.raises(ValueError, match="partition impl"):
        tradix.local_histogram(ids, 4, impl="loop")


# ------------------------------------------------------ K3 / K5 wide
def _keys(rng, n, bits=30):
    r = rng.integers(0, 1 << bits, n, dtype=np.uint64).astype(np.uint32)
    s = np.concatenate([r[: n // 3], rng.integers(
        0, 1 << bits, n - n // 3, dtype=np.uint64).astype(np.uint32)])
    s[:50] = r[7]                                   # one heavy key
    return r, s


@pytest.mark.parametrize("fanout", [8, 10, 12])
def test_merge_counts_past_128_partitions_equal_jax_xla(fanout):
    """The narrow (K3), full-range and 64-bit (K5) per-partition counts and
    max weights at fanouts 8-12 equal JAX's XLA path bit for bit."""
    rng = np.random.default_rng(fanout)
    r, s = _keys(rng, 5000)
    want = jmc.merge_count_per_partition(jnp.asarray(r), jnp.asarray(s),
                                         fanout, impl="xla",
                                         return_max_weight=True)
    got = tmc.merge_count_per_partition(_lane(r), _lane(s), fanout,
                                        return_max_weight=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    r_full, s_full = _keys(rng, 5000, bits=32)
    r_full, s_full = (np.minimum(x, np.uint32(0xFFFFFFFD))
                      for x in (r_full, s_full))
    want = jmc.merge_count_per_partition_full(
        jnp.asarray(r_full), jnp.asarray(s_full), fanout, impl="xla",
        return_max_weight=True)
    got = tmc.merge_count_per_partition_full(
        _lane(r_full), _lane(s_full), fanout, return_max_weight=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    r_hi = rng.integers(0, 3, r.size).astype(np.uint32)
    s_hi = rng.integers(0, 3, s.size).astype(np.uint32)
    want = jmc.merge_count_wide_per_partition(
        jnp.asarray(r), jnp.asarray(r_hi), jnp.asarray(s), jnp.asarray(s_hi),
        fanout, impl="xla", return_max_weight=True)
    got = tmc.merge_count_wide_per_partition(
        _lane(r), _lane(r_hi), _lane(s), _lane(s_hi), fanout,
        return_max_weight=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def _bin_wide(words, weights, fanout_bits, tile):
    """What ``scan_words<kWideBins>`` adds to the global counts: per tile of
    threads x items words, 128 shared bins from the tile's first pid; each
    thread sums its items' weights where the pid stays, adds the sum to its
    bin (or, past the bins, to the global count) where the pid changes and
    at its end; each tile flushes its non-zero bins below 2**f."""
    threads, items = tile
    size = threads * items
    out = np.zeros(1 << fanout_bits, np.uint64)
    pids = words >> 2
    for start in range(0, len(words), size):
        first = int(pids[start])
        bins = np.zeros(128, np.uint64)

        def add(pid, acc):
            if 0 <= pid - first < 128:
                bins[pid - first] += acc
            else:
                out[pid] += acc

        for lo in range(start, min(start + size, len(words)), items):
            hi = min(lo + items, start + size, len(words))
            pid, acc = int(pids[lo]), 0
            for j in range(lo, hi):
                if int(pids[j]) != pid:
                    if acc:
                        add(pid, acc)
                    pid, acc = int(pids[j]), 0
                acc += int(weights[j])
            if acc:
                add(pid, acc)
        for b in np.flatnonzero(bins):
            if first + b < len(out):
                out[first + b] += bins[b]
    return (out & np.uint64(ONES)).astype(np.uint32)


@pytest.mark.parametrize("fanout", [8, 10, 12])
@pytest.mark.parametrize("tile", [(256, 39), (8, 5)], ids=["kernel", "small"])
def test_wide_binning_emulation_equals_the_plain_versions(fanout, tile):
    """The card's wide binning over K3's words (pid << 2 | run start << 1 |
    side) and K5's (lo rotated, hi, tag) equals ``merge_scan_plain`` and
    ``merge_scan_wide_plain``; the small tile spans more than 128
    partitions, so pids past the shared bins go to the global counts."""
    rng = np.random.default_rng(100 + fanout)
    r, s = _keys(rng, 3000, bits=16)
    packed = np.sort(np.asarray(jmc._pack_pm(jnp.asarray(r), jnp.asarray(s),
                                             fanout)))
    w, _ = tmc._weights(_lane(packed))
    p = packed.astype(np.int64)
    start = np.ones(p.size, bool)
    start[1:] = (p[1:] >> 1) != (p[:-1] >> 1)
    words = (p >> (32 - fanout)) << 2 | start.astype(np.int64) << 1 | (p & 1)
    want, _ = k3.merge_scan_plain(_lane(packed), fanout)
    np.testing.assert_array_equal(
        _bin_wide(words, w.numpy(), fanout, tile), _np(want))
    r_hi = rng.integers(0, 3, r.size).astype(np.uint32)
    s_hi = rng.integers(0, 3, s.size).astype(np.uint32)
    lo, hi, tag = (_np(x) for x in tmc.sort_lex_unstable(
        torch.cat([tmc._rotate_pid(_lane(r), fanout),
                   tmc._rotate_pid(_lane(s), fanout)]),
        _lane(np.concatenate([r_hi, s_hi])),
        tmc._side_tags(_lane(r), _lane(s)), num_keys=2))
    want, _ = k5.merge_scan_wide_plain(_lane(lo), _lane(hi), _lane(tag),
                                       fanout)
    run_start = np.ones(lo.size, bool)
    run_start[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    weight = tmc._run_weights(torch.from_numpy(tag.astype(np.int64)),
                              torch.from_numpy(run_start)).numpy()
    words = ((lo.astype(np.int64) >> (32 - fanout)) << 2
             | run_start.astype(np.int64) << 1 | tag.astype(np.int64))
    np.testing.assert_array_equal(_bin_wide(words, weight, fanout, tile),
                                  _np(want))


def test_scan_takes_every_fanout_its_word_holds():
    lane = _lane(np.zeros(8, np.uint32))
    for f in (8, 12, 30):
        assert k3.scan_fanout_bits(1 << f, 8) == f
    assert k3.scratch_layout(40_000_000, 12).bins == 4096
    with pytest.raises(ValueError):
        k3.merge_scan_partitions(lane, num_partitions=1 << 31)


# ------------------------------------------------------------ K4 wide
def _stable_oracle(ids, num_groups, group_size, capacity):
    """K4's contract in numpy: (slots, hist)."""
    g = np.where(ids < num_groups, ids, num_groups).astype(np.int64)
    full = np.bincount(g, minlength=num_groups + 1)
    start = np.cumsum(full) - full
    pos = np.empty(g.size, np.int64)
    pos[np.argsort(g, kind="stable")] = np.arange(g.size)
    keep = g < num_groups
    if capacity is None:
        slot = pos
    else:
        lead = (g // group_size) * group_size
        within = pos - start[np.minimum(lead, num_groups)]
        keep &= within < capacity
        slot = (g // group_size) * capacity + within
    return (np.where(keep, slot, ONES).astype(np.uint32),
            full[:num_groups].astype(np.uint32))


def _kary_search(tile_map, segments, tile, ways):
    """The last segment whose first tile is <= ``tile``, as the pass kernel
    finds it: a ``ways``-ary search (256 threads on the card), each round
    one parallel load a thread and a count of the ones at or below."""
    a, b = 0, segments
    while b - a > 1:
        step = -(-(b - a) // ways)
        below = sum(1 for i in range(ways)
                    if a + i * step < b and tile_map[a + i * step] <= tile)
        a += (below - 1) * step
        b = min(a + step, b)
    return a


def _msd_emulation(ids, num_groups, group_size, capacity, lanes=(), fills=(),
                   tile=32, ways=4, seed=0):
    """``csrc/partition_msd.cu`` and its wrapper, tile by tile: K1's exact
    totals and the scan's starts; the passes of ``msd_plan`` (the coarse
    pass over the whole input drops the invalid ids, each later pass takes
    its tiles from the tile map of its segments, a tile never straddling
    two, the grid at the upper bound with surplus tiles idle); a look-back
    word a tile and digit (aggregate, then inclusive, some tiles left at
    aggregate as a tile still running would be) summed back to the
    segment's first tile; each digit's base from the starts; the final
    layout with the clip; the pads written region by region in each
    block's share.  Returns (slots, hist, outs); every output slot is
    written exactly once."""
    rng = np.random.default_rng(seed)
    n = ids.size
    ids64 = ids.astype(np.int64)
    ok = ids64 < num_groups
    hist = np.bincount(ids64[ok], minlength=num_groups)
    starts = np.concatenate([[0], np.cumsum(hist)]).astype(np.int64)
    plan = k4.msd_plan(num_groups)
    size = n if capacity is None else (num_groups // group_size) * capacity
    slots = np.full(n, ONES, np.uint32)
    outs = [np.full(size, -1, np.int64) for _ in lanes]
    # riding: the id, the input index, the moved lanes
    cur = [ids64, np.arange(n, dtype=np.int64)] + [
        np.asarray(x, np.int64) for x in lanes]
    grid = 0
    for p, (bits, shift) in enumerate(plan):
        last = p == len(plan) - 1
        above = shift + bits
        tiles0 = -(-n // tile)
        if p == 0:
            digits, segments = ((num_groups - 1) >> shift) + 1, 1
            seg_lo, seg_hi = np.array([0]), np.array([n])
            tile_map = np.array([0, tiles0])
            grid = tiles0
        else:
            digits, segments = 1 << bits, ((num_groups - 1) >> above) + 1
            q_all = np.arange(segments + 1, dtype=np.int64)
            bounds = starts[np.minimum(q_all << above, num_groups)]
            seg_lo, seg_hi = bounds[:-1], bounds[1:]
            tile_map = np.concatenate([[0], np.cumsum(
                -(-(seg_hi - seg_lo) // tile))])
            grid = tiles0 + segments
        nxt = [np.full(n, -1, np.int64) for _ in cur]
        words = {}   # tile -> (inclusive, counts a digit)
        for t in range(grid):
            if t >= tile_map[segments]:
                continue                              # a surplus block
            q = 0 if p == 0 else _kary_search(tile_map, segments, t, ways)
            first = tile_map[q]
            assert first <= t < tile_map[q + 1]
            lo = seg_lo[q] + (t - first) * tile
            hi = min(seg_hi[q], lo + tile)
            assert seg_lo[q] <= lo < hi <= seg_hi[q]  # never straddles
            idv = cur[0][lo:hi]
            if p == 0:
                valid = idv < num_groups
                d = np.where(valid, idv >> shift, digits)
                slots[cur[1][lo:hi][~valid]] = ONES   # dropped here
            else:
                valid = np.ones(hi - lo, bool)
                d = (idv >> shift) & ((1 << bits) - 1)
            count = np.bincount(d[valid], minlength=digits)[:digits]
            before = np.zeros(digits, np.int64)
            if t > first:
                k = t - 1
                while True:                           # the look-back chain
                    inclusive, c = words[k]
                    before += c
                    if inclusive or k == first:
                        assert inclusive
                        break
                    k -= 1
            words[t] = (t == first or rng.random() < 0.5,
                        before + count if t > first else count)
            if t > first and not words[t][0]:
                words[t] = (False, count)             # still aggregate
            local_start = np.cumsum(count) - count
            order = np.argsort(np.where(valid, d, digits), kind="stable")
            order = order[:int(valid.sum())]
            dv = d[order]
            local = np.arange(dv.size) - local_start[dv]
            r = (q << bits) | np.arange(digits)
            g = np.minimum(r << shift, num_groups)
            base = starts[g]
            if last and capacity is not None:
                base = base - starts[(g // group_size) * group_size]
            pos = base[dv] + before[dv] + local
            rows = [x[lo:hi][order] for x in cur]
            if not last:
                for lane, row in zip(nxt, rows):
                    assert (lane[pos] == -1).all()
                    lane[pos] = row
                continue
            group = (q << bits) | dv
            if capacity is None:
                keep, dst = np.ones(dv.size, bool), pos
            else:
                keep = pos < capacity
                dst = (group // group_size) * capacity + pos
            slots[rows[1]] = np.where(keep, dst, ONES).astype(np.uint32)
            for out, row in zip(outs, rows[2:]):
                assert (out[dst[keep]] == -1).all()
                out[dst[keep]] = row[keep]
        cur = nxt
    region = n if capacity is None else capacity
    if region:
        share = -(-size // grid) if grid else 0
        for blk in range(grid):
            lo_x, hi_x = blk * share, min(size, (blk + 1) * share)
            b = lo_x // region
            while b * region < hi_x:
                if capacity is None:
                    count = starts[num_groups]
                else:
                    count = (starts[min((b + 1) * group_size, num_groups)]
                             - starts[b * group_size])
                x0 = max(b * region + min(count, region), lo_x)
                x1 = min((b + 1) * region, hi_x)
                for out, f in zip(outs, fills):
                    if x1 > x0:
                        assert (out[x0:x1] == -1).all()
                        out[x0:x1] = f
                b += 1
    for out in outs:
        assert (out >= 0).all()                       # every slot once
    return (slots, hist.astype(np.uint32),
            [out.astype(np.uint32) for out in outs])


GROUPINGS = [   # id, ids, groups, group_size, capacity
    ("dense_257", 257, 1, None), ("dense_1025", 1025, 1, None),
    ("dense_4097", 4097, 1, None),
    ("blocked_32x16", 512, 32, 150), ("blocked_256x4", 1024, 256, 700),
    ("clip_1_4097", 4097, 1, 1),
    ("dense_8193_past_the_wide_cap", k4.WIDE_MAX_GROUPS + 1, 1, None),
    ("dense_16385", 16385, 1, None), ("dense_65537", 65537, 1, None),
    ("blocked_16384x1_clipped", 16384, 1, 2),
    ("blocked_12000_in_1000", 12000, 1000, 300),
    ("grouped_4x4096", 4 * 4096, 4096, 900),
]


def _group_ids(rng, n, groups, gsize, hot=True):
    ids = rng.integers(0, groups + groups // 8, n).astype(np.uint32)
    if hot:   # a hot block, so the blocked layouts clip
        ids[rng.random(n) < 0.3] = gsize // 2
    ids[:2] = (ONES, groups)
    return ids


@pytest.mark.parametrize("case,groups,gsize,cap", GROUPINGS,
                         ids=[g[0] for g in GROUPINGS])
def test_grouping_past_256_groups_equals_the_stable_contract(case, groups,
                                                             gsize, cap):
    """K4's plain version (the CPU's K4) and the card's MSD design,
    emulated, both equal the numpy stable oracle: slots, totals, and two
    moved lanes with their pad fills; past the wide kernel's cap the lanes
    equal JAX's sort arm's bit for bit wherever its order is the contract
    (counts, overflow, each block's tuples as a set)."""
    rng = np.random.default_rng(len(case) + groups)
    n = 3000
    ids = _group_ids(rng, n, groups, gsize)
    want_slots, want_hist = _stable_oracle(ids, groups, gsize, cap)
    slots, hist = k4.partition_slots(_lane(ids), num_groups=groups,
                                     group_size=gsize, capacity=cap)
    np.testing.assert_array_equal(_np(slots), want_slots)
    np.testing.assert_array_equal(_np(hist), want_hist)
    key = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    rid = np.arange(n, dtype=np.uint32)
    fills = (ONES, 7)
    outs, hist = k4.partition_scatter(_lane(ids), [_lane(key), _lane(rid)],
                                      fills, num_groups=groups,
                                      group_size=gsize, capacity=cap)
    e_slots, e_hist, e_outs = _msd_emulation(ids, groups, gsize, cap,
                                             (key, rid), fills, seed=groups)
    np.testing.assert_array_equal(e_slots, want_slots)
    np.testing.assert_array_equal(e_hist, want_hist)
    for got, emu in zip(outs, e_outs):
        np.testing.assert_array_equal(_np(got), emu)
    kept = want_slots != ONES
    np.testing.assert_array_equal(e_outs[1][want_slots[kept]], rid[kept])
    if groups > k4.WIDE_MAX_GROUPS:
        _equals_jax_sort_arm(ids, groups, gsize, cap, key, rid, e_outs,
                             want_hist)


def _equals_jax_sort_arm(ids, groups, gsize, cap, key, rid, outs, hist):
    """JAX's sort arm (``reorder_by_partition`` dense,
    ``scatter_to_blocks_grouped`` blocked, ``impl="sort"``) against the
    MSD emulation's lanes: the totals and the grouped lanes bit for bit
    where its unstable order is not in play (each group's tuples as a set;
    blocked: counts, clipped group counts, overflow, unclipped blocks)."""
    valid = ids < groups
    batch = JT.TupleBatch(jnp.asarray(key), jnp.asarray(rid))
    if cap is None:
        jb, jp, jh, jo = jradix.reorder_by_partition(
            batch, jnp.asarray(np.where(valid, ids, 0).astype(np.uint32)),
            groups, valid=jnp.asarray(valid), impl="sort")
        np.testing.assert_array_equal(np.asarray(jh), hist)
        m = int(valid.sum())
        np.testing.assert_array_equal(np.asarray(jp)[:m],
                                      np.repeat(np.arange(groups), hist))
        bounds = np.concatenate([[0], np.cumsum(hist.astype(np.int64))])
        for a, b in zip(bounds[:-1], bounds[1:]):
            if b > a:
                assert sorted(zip(outs[0][a:b], outs[1][a:b])) == sorted(
                    zip(np.asarray(jb.key)[a:b], np.asarray(jb.rid)[a:b]))
        return
    blocks = groups // gsize
    safe = np.where(valid, ids, 0).astype(np.uint32)
    jb, jc, jg, jo = jradix.scatter_to_blocks_grouped(
        batch, jnp.asarray(safe // gsize), jnp.asarray(safe % gsize), blocks,
        gsize, cap, "outer", valid=jnp.asarray(valid), impl="sort")
    counts = hist.astype(np.int64).reshape(blocks, gsize).sum(1)
    np.testing.assert_array_equal(np.asarray(jc), counts)
    kept = np.minimum(np.cumsum(
        hist.astype(np.int64).reshape(blocks, gsize), 1), cap)
    np.testing.assert_array_equal(
        np.asarray(jg).reshape(blocks, gsize),
        np.concatenate([kept[:, :1], np.diff(kept, axis=1)], 1))
    assert int(jo) == int(np.maximum(counts - cap, 0).sum())
    assert _block_sets(outs, blocks, cap, counts) == _block_sets(
        (jb.key, jb.rid), blocks, cap, counts)


def _block_sets(lanes, num_blocks, cap, counts):
    """Each unclipped block's (key, rid) pairs, sorted."""
    key, rid = (np.asarray(x).reshape(num_blocks, cap) for x in lanes)
    return {b: sorted(zip(key[b, :counts[b]], rid[b, :counts[b]]))
            for b in range(num_blocks) if counts[b] <= cap}


@pytest.mark.parametrize("groups,cap", [(257, 40), (1025, 6), (4097, 2)])
def test_scatter_to_blocks_past_256_equals_jax_sort_arm(groups, cap):
    rng = np.random.default_rng(groups)
    n = 4000
    key = rng.integers(0, 1 << 30, n, dtype=np.uint32)
    rid = np.arange(n, dtype=np.uint32)
    dest = rng.integers(0, groups, n).astype(np.uint32)
    dest[rng.random(n) < 0.05] = 3
    valid = rng.random(n) > 0.1
    jb, jc, jo = jradix.scatter_to_blocks(
        JT.TupleBatch(jnp.asarray(key), jnp.asarray(rid)), jnp.asarray(dest),
        groups, cap, "inner", valid=jnp.asarray(valid), impl="loop")
    for impl in ("auto", "sort"):
        tb, tc, to = tradix.scatter_to_blocks(
            TT.TupleBatch(_lane(key), _lane(rid)), _lane(dest), groups, cap,
            "inner", valid=torch.from_numpy(valid), impl=impl)
        np.testing.assert_array_equal(_np(tc), np.asarray(jc))
        assert int(to) == int(jo) > 0
        counts = _np(tc)
        assert _block_sets((_np(tb.key), _np(tb.rid)), groups, cap, counts) \
            == _block_sets((jb.key, jb.rid), groups, cap, counts)
        ids = np.where(valid, dest, groups).astype(np.uint32)
        slots, _ = _stable_oracle(ids, groups, 1, cap)
        kept = slots != ONES
        np.testing.assert_array_equal(_np(tb.rid)[slots[kept]], rid[kept])


@pytest.mark.parametrize("blocks,subs,cap", [(16, 32, 60), (4, 256, 500)],
                         ids=["32x16", "256x4"])
def test_grouped_scatter_past_256_equals_jax_sort_arm(blocks, subs, cap):
    """Counts, the clipped group counts (the clip eats a block's highest
    subs first) and overflow equal JAX's sort arm; every unclipped block
    holds JAX's tuples; the lanes equal the stable oracle."""
    rng = np.random.default_rng(blocks * subs)
    n = 3000
    key = rng.integers(0, 1 << 30, n, dtype=np.uint32)
    rid = np.arange(n, dtype=np.uint32)
    dest = rng.integers(0, blocks, n).astype(np.uint32)
    dest[rng.random(n) < 0.3] = 1
    sub = rng.integers(0, subs, n).astype(np.uint32)
    valid = rng.random(n) > 0.1
    jb, jc, jg, jo = jradix.scatter_to_blocks_grouped(
        JT.TupleBatch(jnp.asarray(key), jnp.asarray(rid)), jnp.asarray(dest),
        jnp.asarray(sub), blocks, subs, cap, "outer",
        valid=jnp.asarray(valid), impl="loop")
    tb, tc, tg, to = tradix.scatter_to_blocks_grouped(
        TT.TupleBatch(_lane(key), _lane(rid)), _lane(dest), _lane(sub),
        blocks, subs, cap, "outer", valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tg.reshape(-1)),
                                  np.asarray(jg).reshape(-1))
    assert int(to) == int(jo) > 0
    counts = _np(tc)
    assert _block_sets((_np(tb.key), _np(tb.rid)), blocks, cap, counts) == \
        _block_sets((jb.key, jb.rid), blocks, cap, counts)
    ids = np.where(valid, dest * subs + sub, blocks * subs).astype(np.uint32)
    slots, _ = _stable_oracle(ids, blocks * subs, subs, cap)
    kept = slots != ONES
    np.testing.assert_array_equal(_np(tb.rid)[slots[kept]], rid[kept])
    assert (np.bincount(dest[kept & valid], minlength=blocks) <= cap).all()


@pytest.mark.parametrize("groups", [257, 1025, 4097])
def test_reorder_by_partition_past_256_equals_jax_sort_arm(groups):
    rng = np.random.default_rng(groups + 1)
    n = 5000
    key = rng.integers(0, 1 << 30, n, dtype=np.uint32)
    rid = np.arange(n, dtype=np.uint32)
    pid = rng.integers(0, groups, n).astype(np.uint32)
    valid = rng.random(n) > 0.1
    jb, jp, jh, jo = jradix.reorder_by_partition(
        JT.TupleBatch(jnp.asarray(key), jnp.asarray(rid)), jnp.asarray(pid),
        groups, valid=jnp.asarray(valid), impl="sort")
    for impl in ("auto", "sort"):
        tb, tp, th, to = tradix.reorder_by_partition(
            TT.TupleBatch(_lane(key), _lane(rid)), _lane(pid), groups,
            valid=torch.from_numpy(valid), impl=impl)
        np.testing.assert_array_equal(_np(th), np.asarray(jh))
        np.testing.assert_array_equal(_np(to), np.asarray(jo))
        bounds = np.concatenate([_np(to), [valid.sum()]]).astype(np.int64)
        for a, b in zip(bounds[:-1], bounds[1:]):
            assert sorted(zip(_np(tb.rid)[a:b], _np(tp)[a:b])) == \
                sorted(zip(np.asarray(jb.rid)[a:b], np.asarray(jp)[a:b]))
        order = np.argsort(np.where(valid, pid, groups), kind="stable")
        np.testing.assert_array_equal(_np(tb.rid), rid[order])


def test_partition_impl_names_are_jaxs():
    ids = _lane(np.zeros(4, np.uint32))
    batch = TT.TupleBatch(ids, ids)
    with pytest.raises(ValueError, match="partition impl"):
        tradix.scatter_to_blocks(batch, ids, 300, 2, "inner", impl="xla")
    with pytest.raises(ValueError, match="num_groups"):
        k4.partition_slots(ids, num_groups=1 << 31)


# ----------------------------------------------------- wire at 6-10 bits
@pytest.mark.parametrize("fanout", [6, 7, 8, 9, 10])
@pytest.mark.parametrize("wide", [False, True], ids=["key32", "key64"])
def test_wire_spec_at_wide_fanouts_equals_jax(fanout, wide):
    for cap, kb, rb in ((1024, 1 << 20, 1 << 20), (8388608, 1 << 25,
                                                    80_000_000),
                        (7, None, None)):
        bound = None if kb is None else (kb << 20 if wide else kb)
        jspec = JT.make_wire_spec(cap, fanout, wide=wide, key_bound=bound,
                                  rid_bound=rb)
        tspec = TT.make_wire_spec(cap, fanout, wide=wide, key_bound=bound,
                                  rid_bound=rb)
        assert tuple(tspec) == tuple(jspec)
        assert tspec.num_sub == 1 << fanout
