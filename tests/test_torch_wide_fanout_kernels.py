"""Wider fanout (ROADMAP A19) at kernel level: the plain versions of K1, K3,
K5 and K4 past the narrow kernels' shared bins, held bit for bit against
the JAX package's XLA and sort arms (the arms JAX's ``auto`` takes on the
CPU), and numpy emulations of the card's wide designs held against the
plain versions:

  * K1 (``histogram_plain``, ``local_histogram``) at 129, 1024, 4097 and
    2**16 bins, counts, valid masks and uint32 weights, on random, sorted,
    constant and out-of-range ids, against JAX ``local_histogram(impl=
    "xla")`` (uint32 weights against numpy, JAX's Pallas arm holding 128);
  * K3 and K5 (``merge_count_per_partition``, ``_full``,
    ``merge_count_wide_per_partition``) at fanouts 8, 10 and 12 against
    JAX's XLA path, and the wide binning of
    ``csrc/merge_scan_partitions.cuh`` (bins relative to a tile's first
    partition, a pid past them straight to the global count) emulated;
  * K4 (``partition_scatter`` on the CPU, ``scatter_to_blocks``,
    ``scatter_to_blocks_grouped``, ``reorder_by_partition`` with ``valid``)
    at 257, 1025 and 4097 groups, dense and blocked (32 x 16 blocks,
    256 x 4), clipped, against JAX's sort arm and a numpy stable oracle,
    and the LSD composition of ``csrc/partition_lsd.cu`` (clamped groups,
    8-bit LSD digit passes, block starts, the placing formulas; the card's
    path past 8192 groups) emulated, up to one group past that cap (the
    wide kernel below it: ``tests/test_torch_partition_wide.py``);
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


@pytest.mark.parametrize("bins", [129, 1024, 4097, 1 << 16])
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


def _lsd_emulation(ids, num_groups, group_size, capacity, lanes=(),
                   fills=()):
    """``csrc/partition_lsd.cu`` and its wrapper: each id's group (the
    invalid group num_groups last) beside its index, 8-bit LSD digit passes
    (each a stable counting placement) over ceil(log2(num_groups + 1) / 8)
    digits, the exact totals, each layout block's first sorted position,
    then the placing formulas: slots over the sorted positions, or each
    output slot gathered from its block's sorted run or filled."""
    n = ids.size
    keys = np.where(ids < num_groups, ids, num_groups).astype(np.int64)
    index = np.arange(n, dtype=np.int64)
    passes = -(-int(num_groups).bit_length() // 8)
    for p in range(passes):
        digit = (keys >> (8 * p)) & 255
        counts = np.bincount(digit, minlength=256)
        cursor = np.cumsum(counts) - counts
        dest = np.empty(n, np.int64)
        for i in range(n):            # stable: input order within a digit
            dest[i] = cursor[digit[i]]
            cursor[digit[i]] += 1
        keys_next, index_next = np.empty_like(keys), np.empty_like(index)
        keys_next[dest], index_next[dest] = keys, index
        keys, index = keys_next, index_next
    hist = np.bincount(ids[ids < num_groups].astype(np.int64),
                       minlength=num_groups)
    lead = np.concatenate([[0], np.cumsum(hist)])
    block_start = (lead[[0, num_groups]] if capacity is None
                   else lead[::group_size])
    slots = np.full(n, ONES, np.uint32)
    for p in range(n):
        g = keys[p]
        if g < num_groups:
            if capacity is None:
                slots[index[p]] = p
            else:
                within = p - block_start[g // group_size]
                if within < capacity:
                    slots[index[p]] = (g // group_size) * capacity + within
    region = n if capacity is None else capacity
    size = n if capacity is None else (num_groups // group_size) * capacity
    x = np.arange(size)
    b = x // max(region, 1)
    w = x - b * region
    first = block_start[b]
    filled = w < block_start[b + 1] - first
    src = np.where(filled, index[np.minimum(first + w, max(n - 1, 0))], 0)
    outs = [np.where(filled, lane[src], np.uint32(f)).astype(np.uint32)
            for lane, f in zip(lanes, fills)]
    return slots, hist.astype(np.uint32), outs


GROUPINGS = [   # id, ids, groups, group_size, capacity
    ("dense_257", 257, 1, None), ("dense_1025", 1025, 1, None),
    ("dense_4097", 4097, 1, None),
    ("blocked_32x16", 512, 32, 150), ("blocked_256x4", 1024, 256, 700),
    ("clip_1_4097", 4097, 1, 1),
    ("dense_8193_past_the_wide_cap", k4.WIDE_MAX_GROUPS + 1, 1, None),
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
    """K4's plain version (the CPU's K4) and the card's LSD design,
    emulated, both equal the numpy stable oracle: slots, totals, and two
    moved lanes with their pad fills."""
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
    e_slots, e_hist, e_outs = _lsd_emulation(ids, groups, gsize, cap,
                                             (key, rid), fills)
    np.testing.assert_array_equal(e_slots, want_slots)
    np.testing.assert_array_equal(e_hist, want_hist)
    for got, emu in zip(outs, e_outs):
        np.testing.assert_array_equal(_np(got), emu)
    kept = want_slots != ONES
    np.testing.assert_array_equal(e_outs[1][want_slots[kept]], rid[kept])


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
