"""Port parity: K4, the radix partition pass
(``tpu_radix_join_torch.ops.kernels.partition``), bit-exact against
``partition_slots_pallas(..., interpret=True)`` on slots and histogram, and
the port's ``scatter_to_blocks`` / ``reorder_by_partition`` bit-exact
against the JAX functions called with ``impl="pallas_interpret"`` on blocks,
counts, histograms and overflow.  The JAX calls are direct, outside
``shard_map``.  Ids stay below 2**31: the TPU kernel reads them as int32."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_radix_join.data.tuples import TupleBatch as JBatch  # noqa: E402
from tpu_radix_join.ops import radix as jradix  # noqa: E402
from tpu_radix_join.ops.pallas.partition import (  # noqa: E402
    partition_slots_pallas)

from tpu_radix_join_torch.data.tuples import (  # noqa: E402
    PAD_RID, R_PAD_KEY, S_PAD_KEY, TupleBatch, lane_from_numpy,
    lane_to_numpy)
from tpu_radix_join_torch.ops import radix as tradix  # noqa: E402
from tpu_radix_join_torch.ops.kernels import partition as k4  # noqa: E402
from tpu_radix_join_torch.ops.kernels.partition import (  # noqa: E402
    DROPPED, partition_scatter, partition_slots)

INTERP = "pallas_interpret"


def _lane(a):
    return lane_from_numpy(np.asarray(a, np.uint32), "cpu")


def _eq(got, want):
    np.testing.assert_array_equal(lane_to_numpy(got),
                                  np.asarray(want).astype(np.uint32))


def _slots_parity(ids, **kw):
    """K4's plain version against the interpreted TPU kernel."""
    ids = np.asarray(ids, np.uint32)
    want = partition_slots_pallas(jnp.asarray(ids), interpret=True, **kw)
    got = partition_slots(_lane(ids), **kw)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    return lane_to_numpy(got[0]), lane_to_numpy(got[1])


def _ids(n, hi, seed):
    return np.random.default_rng(seed).integers(0, hi, n).astype(np.uint32)


# ----------------------------------------------------------------- K4 slots

@pytest.mark.parametrize("case,ids,kw", [
    ("dense", _ids(5000, 7, 2), dict(num_groups=7)),
    ("dense_invalid", _ids(5000, 10, 3), dict(num_groups=7)),
    ("blocked_fits", _ids(4000, 8, 4), dict(num_groups=8, capacity=1000)),
    ("blocked_overflow", _ids(4000, 4, 5), dict(num_groups=4, capacity=500)),
    ("blocked_group4", _ids(3000, 16, 6),
     dict(num_groups=16, group_size=4, capacity=800)),
    ("blocked_group4_overflow_invalid", _ids(3000, 18, 7),
     dict(num_groups=16, group_size=4, capacity=600)),
    ("all_equal_dense", np.full(3000, 3, np.uint32), dict(num_groups=5)),
    ("all_equal_overflow", np.full(3000, 3, np.uint32),
     dict(num_groups=5, capacity=1000)),
    ("all_invalid_dense", np.full(2000, 9, np.uint32), dict(num_groups=5)),
    ("all_invalid_blocked", _ids(2000, 1 << 20, 8) + 5,
     dict(num_groups=5, capacity=64)),
    ("groups_256_dense", _ids(5000, 257, 9), dict(num_groups=256)),
    ("groups_256_blocked", _ids(5000, 257, 10),
     dict(num_groups=256, capacity=16)),
    ("one_id", np.array([2], np.uint32), dict(num_groups=4, capacity=8)),
])
def test_partition_slots_equal_the_tpu_kernel(case, ids, kw):
    slots, hist = _slots_parity(ids, **kw)
    g = kw["num_groups"]
    assert hist.sum() == (ids < g).sum()
    assert (slots[ids >= g] == DROPPED).all()


def test_invalid_id_256_is_dropped_not_wrapped():
    ids = _ids(5000, 257, 9)
    ids[:4] = [256, 0, 256, 255]
    slots, hist = _slots_parity(ids, num_groups=256)
    assert hist[0] == (ids == 0).sum() and hist.sum() == (ids < 256).sum()
    assert slots[0] == slots[2] == DROPPED
    assert slots[1] == 0 and slots[3] == (ids < 255).sum()


@pytest.mark.parametrize("capacity", [None, 150_000])
def test_partition_slots_many_tiles(capacity):
    """600,000 ids span several tiles of the TPU kernel (its cursors carry
    across grid steps) and many blocks of the CUDA kernel."""
    _slots_parity(_ids(600_000, 5, 4), num_groups=5, capacity=capacity)


def test_partition_rejects_bad_geometry():
    ids = _lane(np.zeros(16, np.uint32))
    with pytest.raises(ValueError, match="num_groups"):
        partition_slots(ids, num_groups=0)
    with pytest.raises(ValueError, match="multiple"):
        partition_slots(ids, num_groups=10, group_size=4, capacity=8)
    with pytest.raises(ValueError, match="capacity"):
        partition_slots(ids, num_groups=4, capacity=0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        partition_slots(ids.to("meta"), num_groups=4)


def test_partition_scatter_moves_lanes_to_the_slots():
    ids = _ids(3000, 6, 12)
    lane = np.random.default_rng(13).integers(0, 1 << 32, 3000,
                                              dtype=np.uint64)
    (out,), hist = partition_scatter(_lane(ids), [_lane(lane)], [0xABCD],
                                     num_groups=5, capacity=400)
    slots, _ = partition_slots(_lane(ids), num_groups=5, capacity=400)
    want = np.full(5 * 400, 0xABCD, np.uint32)
    keep = lane_to_numpy(slots) != DROPPED
    want[lane_to_numpy(slots)[keep]] = lane.astype(np.uint32)[keep]
    np.testing.assert_array_equal(lane_to_numpy(out), want)
    np.testing.assert_array_equal(lane_to_numpy(hist),
                                  np.bincount(ids, minlength=6)[:5])


# ---------------------------------------------------- scatter_to_blocks

def _batches(n, seed):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 0xFFFFFFFE, n, dtype=np.uint64).astype(np.uint32)
    rid = np.arange(n, dtype=np.uint32)
    return (JBatch(jnp.asarray(key), jnp.asarray(rid)),
            TupleBatch(key=_lane(key), rid=_lane(rid)))


def _scatter_parity(n, nb, cap, side, dest, valid=None, seed=0):
    jb, tb = _batches(n, seed)
    want = jradix.scatter_to_blocks(
        jb, jnp.asarray(dest), nb, cap, side,
        valid=None if valid is None else jnp.asarray(valid), impl=INTERP)
    got = tradix.scatter_to_blocks(
        tb, _lane(dest), nb, cap, side,
        valid=None if valid is None else torch.from_numpy(valid))
    _eq(got[0].key, want[0].key)
    _eq(got[0].rid, want[0].rid)
    _eq(got[1], want[1])
    assert int(got[2]) == int(want[2])
    return got


@pytest.mark.parametrize("side", ["inner", "outer"])
@pytest.mark.parametrize("valid_p", [None, 0.7])
@pytest.mark.parametrize("nb,cap", [(8, 1000), (4, 500), (1, 4096)])
def test_scatter_to_blocks_equals_jax(side, valid_p, nb, cap):
    n = 4000
    rng = np.random.default_rng(nb * cap)
    dest = rng.integers(0, nb, n).astype(np.uint32)
    valid = None if valid_p is None else rng.random(n) < valid_p
    blocks, counts, overflow = _scatter_parity(n, nb, cap, side, dest, valid)
    pad = R_PAD_KEY if side == "inner" else S_PAD_KEY
    demand = np.bincount(dest[valid] if valid is not None else dest,
                         minlength=nb)
    np.testing.assert_array_equal(lane_to_numpy(counts), demand)
    assert int(overflow) == np.maximum(demand - cap, 0).sum()
    keys = lane_to_numpy(blocks.key).reshape(nb, cap)
    rids = lane_to_numpy(blocks.rid).reshape(nb, cap)
    for b in range(nb):
        k = min(demand[b], cap)
        assert (keys[b, k:] == pad).all() and (rids[b, k:] == PAD_RID).all()


def test_dropped_tuples_never_overwrite_the_last_slot():
    """Block 0 overflows while the last block is part empty: a dropped
    tuple's slot 0xFFFFFFFF is -1 as int32, which would index (and
    overwrite) the last slot of the last block if it were not masked."""
    n, nb, cap = 3000, 3, 1000
    dest = np.zeros(n, np.uint32)
    dest[-10:] = 2                              # 2990 tuples for block 0
    blocks, counts, overflow = _scatter_parity(n, nb, cap, "outer", dest)
    assert int(overflow) == 1990
    assert lane_to_numpy(blocks.key)[-1] == S_PAD_KEY
    assert lane_to_numpy(blocks.rid)[-1] == PAD_RID
    # the clip keeps block 0's first `cap` tuples in input order
    np.testing.assert_array_equal(lane_to_numpy(blocks.rid)[:cap],
                                  np.arange(cap))


# ------------------------------------------------- reorder_by_partition

@pytest.mark.parametrize("valid_p", [None, 0.6])
@pytest.mark.parametrize("p", [16, 127])
def test_reorder_by_partition_equals_jax(valid_p, p):
    n = 5000
    rng = np.random.default_rng(p)
    pid = rng.integers(0, p, n).astype(np.uint32)
    valid = None if valid_p is None else rng.random(n) < valid_p
    jb, tb = _batches(n, p)
    want = jradix.reorder_by_partition(
        jb, jnp.asarray(pid), p,
        valid=None if valid is None else jnp.asarray(valid), impl=INTERP)
    got = tradix.reorder_by_partition(
        tb, _lane(pid), p,
        valid=None if valid is None else torch.from_numpy(valid))
    _eq(got[0].key, want[0].key)
    _eq(got[0].rid, want[0].rid)
    for g, w in zip(got[1:], want[1:]):
        _eq(g, w)


def test_exclusive_cumsum_equals_jax():
    hist = np.random.default_rng(1).integers(0, 1 << 30, 40).astype(np.uint32)
    _eq(tradix.exclusive_cumsum(_lane(hist)),
        jradix.exclusive_cumsum(jnp.asarray(hist)))


# ------------------------------------------------ the onesweep pass of K4
# The card's K4 is a histogram launch and a onesweep launch: per-tile group
# counts published as look-back words, each group's offset summed over the
# tiles before by lanes that read kLookBack words a round, group starts
# that restart every group_size groups, the clip, and the pad tails every
# block writes its share of.  These hold that arithmetic in a plain
# emulation against the plain version and the interpreted TPU kernel.

def _emulate_partition(ids, num_groups, group_size=1, capacity=None,
                       tile=k4.TILE_IDS, inclusive_p=0.5, seed=0):
    """(slots, hist, pad tails) as the kernel computes them."""
    rng = np.random.default_rng(seed)
    n = len(ids)
    g = np.where(ids < num_groups, ids, num_groups).astype(np.int64)
    hist = np.bincount(g, minlength=num_groups + 1)[:num_groups]
    start = np.cumsum(hist) - hist
    lead = (np.arange(num_groups) // group_size) * group_size
    start_rel = start if capacity is None else start - start[lead]
    sub = 32                        # look-back lanes a group
    while sub > 1 and sub * num_groups > 256:
        sub //= 2
    step = sub * 8                  # words a round reaches
    words = []                      # (flag, count) per tile and group
    slots = np.full(n, DROPPED, np.int64)
    for t in range(-(-n // tile)):
        gt = g[t * tile:(t + 1) * tile]
        count = np.bincount(gt, minlength=num_groups + 1)[:num_groups]
        words.append([(2 if t == 0 else 1, int(c)) for c in count])
        before = np.zeros(num_groups, np.int64)
        for grp in range(num_groups):
            j = t - 1
            while j >= 0:
                got = [words[k][grp] for k in range(j, max(j - step, -1), -1)]
                last = next((i for i, (f, _) in enumerate(got) if f == 2),
                            None)
                before[grp] += sum(c for _, c in got[:None if last is None
                                                      else last + 1])
                if last is not None:
                    break
                j -= step
            if t and rng.random() < inclusive_p:
                words[t][grp] = (2, int(before[grp] + count[grp]))
        # the stable in-tile rank: input order within a group
        rank = np.zeros(len(gt), np.int64)
        for grp in range(num_groups):
            at = np.flatnonzero(gt == grp)
            rank[at] = np.arange(len(at))
        ok = gt < num_groups
        pos = start_rel[gt[ok]] + before[gt[ok]] + rank[ok]
        idx = np.flatnonzero(ok) + t * tile
        if capacity is None:
            slots[idx] = pos
        else:
            fit = pos < capacity
            slots[idx[fit]] = (gt[ok][fit] // group_size) * capacity + pos[fit]
    # the pads: region b's tail ends at (b + 1) * capacity (dense: at n);
    # each of `blocks` blocks writes its share of the regions' pads in turn
    if capacity is None:
        pads, ends = [n - int(hist.sum())], [n]
    else:
        blocks_of = np.add.reduceat(hist, np.arange(0, num_groups,
                                                    group_size))
        pads = [capacity - min(int(c), capacity) for c in blocks_of]
        ends = [(b + 1) * capacity for b in range(len(pads))]
    pad_before = np.concatenate([[0], np.cumsum(pads)])
    total = int(pad_before[-1])
    blocks = max(-(-n // tile), -(-sum(ends[-1:]) // (4 * tile)))
    share = -(-total // blocks) if blocks else 0
    tails = []
    for blk in range(blocks):
        lo, hi = blk * share, min(blk * share + share, total)
        for b in range(len(pads)):
            pb, pe = int(pad_before[b]), int(pad_before[b + 1])
            if pe <= lo or pb >= hi:
                continue
            first = ends[b] - (pe - pb)
            tails.append(np.arange(first + max(lo, pb) - pb,
                                   first + min(hi, pe) - pb))
    tails = np.concatenate(tails) if tails else np.zeros(0, np.int64)
    return slots.astype(np.uint32), hist.astype(np.uint32), tails


EMULATED = [
    ("dense", _ids(5000, 7, 2), dict(num_groups=7)),
    ("dense_invalid", _ids(5000, 10, 3), dict(num_groups=7)),
    ("blocked_group4_overflow_invalid", _ids(3000, 18, 7),
     dict(num_groups=16, group_size=4, capacity=600)),
    ("capacity_1", _ids(3000, 18, 7), dict(num_groups=16, group_size=4,
                                           capacity=1)),
    ("all_invalid_dense", np.full(2000, 9, np.uint32), dict(num_groups=5)),
    ("all_invalid_blocked", _ids(2000, 1 << 20, 8) + 5,
     dict(num_groups=5, capacity=64)),
    ("id_256_of_256", np.array([256, 0, 255] * 1667, np.uint32)[:5000],
     dict(num_groups=256)),
    ("groups_256_blocked", _ids(5000, 257, 10),
     dict(num_groups=256, capacity=16)),
    ("one_group", np.zeros(5000, np.uint32), dict(num_groups=1,
                                                  capacity=8192)),
]


@pytest.mark.parametrize("tile", [64, k4.TILE_IDS])
@pytest.mark.parametrize("case,ids,kw", EMULATED)
def test_onesweep_emulation_equals_the_plain_version(case, ids, kw, tile):
    """Tiles of 64 ids (many tiles, walks of several rounds when few tiles
    leave an inclusive word) and the kernel's own: slots and hist of the
    plain version; the written slots and the pad tails cover every output
    slot exactly once."""
    slots, hist, tails = _emulate_partition(ids, **kw, tile=tile,
                                            inclusive_p=0.1)
    want = partition_slots(_lane(ids), **kw)
    np.testing.assert_array_equal(slots, lane_to_numpy(want[0]))
    np.testing.assert_array_equal(hist, lane_to_numpy(want[1]))
    size = k4.out_size(len(ids), kw["num_groups"], kw.get("group_size", 1),
                       kw.get("capacity"))
    written = slots[slots != DROPPED].astype(np.int64)
    cover = np.bincount(np.concatenate([written, tails]), minlength=size)
    assert len(cover) == size and (cover == 1).all()
    (out,), _ = partition_scatter(_lane(ids), [_lane(np.arange(len(ids)))],
                                  [0xABCDEF], **kw)
    out = lane_to_numpy(out)
    assert (out[tails] == 0xABCDEF).all()
    np.testing.assert_array_equal(out[written],
                                  np.flatnonzero(slots != DROPPED))


@pytest.mark.parametrize("case,ids,kw", [e for e in EMULATED if e[0] in (
    "dense", "blocked_group4_overflow_invalid", "capacity_1",
    "id_256_of_256")])
def test_onesweep_emulation_equals_the_tpu_kernel(case, ids, kw):
    slots, hist, _ = _emulate_partition(ids, **kw, tile=512, seed=3)
    want = partition_slots_pallas(jnp.asarray(ids), interpret=True, **kw)
    _eq(_lane(slots), want[0])
    _eq(_lane(hist), want[1])


@pytest.mark.parametrize("n, groups, tiles", [
    (0, 1, 0), (1, 256, 1), (k4.TILE_IDS, 32, 1), (k4.TILE_IDS + 1, 5, 2),
    ((1 << 31) + 4097, 4, (1 << 19) + 2), ((1 << 32) - 1, 256, 1 << 20)])
def test_scratch_layout(n, groups, tiles):
    lay = k4.scratch_layout(n, groups)
    assert lay.tiles == tiles and lay.lookback_words == tiles * groups
    # 64-bit words: a flag over a 32-bit count that reaches n
    assert lay.word_bytes == 8 and n < 1 << 32
    assert lay.totals_words == 256
    assert lay.bytes == 8 * tiles * groups + 4 * 256 + 8
    assert lay.totals_offset == 2 * tiles * groups


def test_scratch_layout_sizes_stated_in_perf():
    # (d)'s local pass (2**25 ids, 32 groups) and its exchange (20M, 1)
    assert k4.scratch_layout(1 << 25, 32).bytes == 2_098_184
    assert k4.scratch_layout(20_000_000, 1).bytes == 40_096
    for bad in ((1 << 32, 1), (5, 0), (5, 257)):
        with pytest.raises(ValueError):
            k4.scratch_layout(*bad)
