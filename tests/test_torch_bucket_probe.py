"""Port parity: the modules of the partitioned join, each against its JAX
function on the same numpy-seeded inputs, exact — the tuple helpers, local
histograms, both assignment policies, the one-rank exchange, the local
radix partition (JAX on ``impl="pallas_interpret"``) and the bucketized
build/probe in its dense and merge branches."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_radix_join.data import tuples as jtuples  # noqa: E402
from tpu_radix_join.data.tuples import TupleBatch as JBatch  # noqa: E402
from tpu_radix_join.histograms import assignment_map as jassign  # noqa: E402
from tpu_radix_join.histograms.local_histogram import (  # noqa: E402
    compute_local_histogram as j_local_histogram)
from tpu_radix_join.operators import local_partitioning as jlocal  # noqa: E402
from tpu_radix_join.ops import build_probe as jbp  # noqa: E402
from tpu_radix_join.ops import radix as jradix  # noqa: E402

from tpu_radix_join_torch.data import tuples as ttuples  # noqa: E402
from tpu_radix_join_torch.data.tuples import (  # noqa: E402
    R_PAD_KEY, S_PAD_KEY, TupleBatch, lane_from_numpy, lane_to_numpy)
from tpu_radix_join_torch.histograms import (  # noqa: E402
    compute_global_histogram, compute_local_histogram,
    compute_partition_assignment)
from tpu_radix_join_torch.operators import (  # noqa: E402
    local_partitioning as tlocal)
from tpu_radix_join_torch.ops import build_probe as tbp  # noqa: E402
from tpu_radix_join_torch.parallel.network_partitioning import (  # noqa: E402
    network_partition)
from tpu_radix_join_torch.parallel.window import Window  # noqa: E402
from tpu_radix_join_torch.parallel.world import make_world  # noqa: E402


def _lane(a):
    return lane_from_numpy(np.asarray(a, np.uint32), "cpu")


def _eq(got, want):
    np.testing.assert_array_equal(lane_to_numpy(got),
                                  np.asarray(want).astype(np.uint32))


def _batch(key, rid=None):
    key = np.asarray(key, np.uint32)
    rid = np.arange(len(key), dtype=np.uint32) if rid is None else rid
    return (JBatch(jnp.asarray(key), jnp.asarray(rid)),
            TupleBatch(key=_lane(key), rid=_lane(rid)))


def _keys(n, hi, seed, pad=None, pad_p=0.0):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)
    if pad is not None:
        k[rng.random(n) < pad_p] = pad
    return k


# ------------------------------------------------------------ tuple layout

@pytest.mark.parametrize("side", ["inner", "outer"])
def test_tuple_helpers_equal_jax(side):
    pad = R_PAD_KEY if side == "inner" else S_PAD_KEY
    jb, tb = _batch(_keys(3000, 0xFFFFFFFF, 1, pad=pad, pad_p=0.3))
    for f in (0, 5, 8):
        _eq(ttuples.partition_ids(tb, f), jtuples.partition_ids(jb, f))
    np.testing.assert_array_equal(ttuples.valid_mask(tb, side).numpy(),
                                  np.asarray(jtuples.valid_mask(jb, side)))
    assert ttuples.pad_sentinel(side) == int(jtuples.pad_sentinel(side))
    tp = ttuples.make_padding_like(tb, 7, side)
    jp = jtuples.make_padding_like(jb, 7, side)
    _eq(tp.key, jp.key)
    _eq(tp.rid, jp.rid)
    assert tp.key_hi is None and jp.key_hi is None


# -------------------------------------------------- histograms, assignment

@pytest.mark.parametrize("fanout", [0, 5, 7])
def test_local_histogram_equals_jax(fanout):
    jb, tb = _batch(_keys(5000, 1 << 20, fanout))
    valid = np.random.default_rng(3).random(5000) < 0.8
    for v in (None, valid):
        jpid, jhist = j_local_histogram(
            jb, fanout, None if v is None else jnp.asarray(v))
        tpid, thist = compute_local_histogram(
            tb, fanout, None if v is None else torch.from_numpy(v))
        _eq(tpid, jpid)
        _eq(thist, jhist)
    one = make_world(1)
    assert compute_global_histogram(thist, one) is thist


@pytest.mark.parametrize("num_nodes", [1, 4, 8])
@pytest.mark.parametrize("hists", [
    "random", "all_equal", "pairs_tied", "one_hot_partition"])
def test_assignment_policies_equal_jax(num_nodes, hists):
    """Both policies are pure functions of the global histograms; ties
    break as JAX breaks them (stable descending order, first minimum)."""
    rng = np.random.default_rng(num_nodes)
    p = 32
    if hists == "random":
        r = rng.integers(0, 1000, p)
        s = rng.integers(0, 1000, p)
    elif hists == "all_equal":
        r = s = np.full(p, 40)
    elif hists == "pairs_tied":
        r = np.repeat(rng.integers(0, 50, p // 2), 2)
        s = np.repeat(rng.integers(0, 50, p // 2), 2)[::-1].copy()
    else:
        r = np.zeros(p, np.int64)
        s = np.zeros(p, np.int64)
        r[7] = s[7] = 1 << 20
    for policy in ("round_robin", "load_aware"):
        want = jassign.compute_partition_assignment(
            jnp.asarray(r, jnp.uint32), jnp.asarray(s, jnp.uint32),
            num_nodes, policy)
        got = compute_partition_assignment(_lane(r), _lane(s), num_nodes,
                                           policy)
        _eq(got, want)


def test_unknown_assignment_policy_raises():
    with pytest.raises(ValueError, match="policy"):
        compute_partition_assignment(_lane([1, 2]), _lane([1, 2]), 1, "lpt")


# ------------------------------------------------------- one-rank exchange

@pytest.mark.parametrize("cap", [4096, 2048])
def test_one_rank_exchange_is_the_block_scatter(cap):
    """At one rank the all_to_all is an identity: the received lanes are
    the scatter into one block, bit for bit the JAX block scatter; the
    conservation check holds unless tuples overflowed."""
    side = "outer"
    key = _keys(3000, 1 << 16, 5)
    jb, tb = _batch(key)
    world = make_world(1)
    assign = _lane(np.zeros(32, np.uint32))
    win = Window(world, cap, side)
    res = network_partition(tb, 5, assign, win)
    want = jradix.scatter_to_blocks(jb, jnp.zeros(3000, jnp.uint32), 1, cap,
                                    side, impl="pallas_interpret")
    _eq(res.batch.key, want[0].key)
    _eq(res.batch.rid, want[0].rid)
    np.testing.assert_array_equal(
        res.valid.numpy(), np.asarray(jtuples.valid_mask(want[0], side)))
    _eq(res.pid, jtuples.partition_ids(want[0], 5))
    assert int(res.recv_counts.sum()) == min(3000, cap)
    ghist = _lane(np.bincount(key & 31, minlength=32))
    lost, bad = win.diagnostics(res, ghist, assign)
    assert int(lost) == max(0, 3000 - cap) and not bool(bad)
    assert bool(win.assert_all_tuples_written(res, ghist, assign)) == (
        cap >= 3000)
    # a receive total that disagrees with the histogram is misrouting
    wrong = _lane(np.bincount(key & 31, minlength=32) + 1)
    if cap >= 3000:
        assert bool(win.diagnostics(res, wrong, assign)[1])


def test_world_beyond_one_rank_raises():
    """A world of more ranks needs a process group: without one,
    make_world raises and names the bootstrap that starts it."""
    with pytest.raises(ValueError, match="multihost.initialize"):
        make_world(2)
    with pytest.raises(ValueError, match="size"):
        make_world(1).all_to_all(torch.zeros(6), 4)


# ------------------------------------------------ local radix partition

@pytest.mark.parametrize("side", ["inner", "outer"])
@pytest.mark.parametrize("f,l,cap", [(5, 5, 200), (5, 5, 60), (4, 6, 90),
                                     (3, 8, 40), (0, 1, 3000)])
def test_local_partition_equals_jax(side, f, l, cap):
    pad = R_PAD_KEY if side == "inner" else S_PAD_KEY
    key = _keys(4096, 1 << 24, f * 16 + l, pad=pad, pad_p=0.25)
    jb, tb = _batch(key)
    valid = key != pad
    want = jlocal.local_partition(jb, jnp.asarray(valid), f, l, cap, side,
                                  impl="pallas_interpret")
    got = tlocal.local_partition(tb, torch.from_numpy(valid), f, l, cap,
                                 side)
    _eq(got.blocks.key, want.blocks.key)
    _eq(got.blocks.rid, want.blocks.rid)
    _eq(got.histogram, want.histogram)
    _eq(got.offsets, want.offsets)
    assert int(got.overflow) == int(want.overflow)
    _eq(tlocal.local_bucket_ids(tb, f, l), jlocal.local_bucket_ids(jb, f, l))


# ------------------------------------------------ bucketized build/probe

def _blocks(nb, bi, bo, hi, seed):
    """Sentinel-padded key blocks [nb, bi] (R) and [nb, bo] (S) with
    duplicates on both sides."""
    r = _keys(nb * bi, hi, seed, pad=R_PAD_KEY, pad_p=0.2).reshape(nb, bi)
    s = _keys(nb * bo, hi, seed + 1, pad=S_PAD_KEY, pad_p=0.2).reshape(nb, bo)
    return r, s


def _rows(a):
    return lane_from_numpy(a.reshape(-1), "cpu").view(a.shape)


@pytest.mark.parametrize("nb,bi,bo,hi", [
    (8, 100, 120, 50),        # dense branch (both widths <= 256)
    (4, 256, 256, 1 << 30),   # dense branch, at the limit
    (4, 300, 500, 200),       # merge branch
    (32, 384, 384, 1 << 31),  # merge branch, sparse matches
    (2, 257, 3, 5),           # merge branch, one wide side
])
def test_probe_count_bucketized_equals_jax(nb, bi, bo, hi):
    r, s = _blocks(nb, bi, bo, hi, nb + bi)
    jr, js = jnp.asarray(r), jnp.asarray(s)
    for mw in (False, True):
        want = jbp.probe_count_bucketized(jr, js, return_max_weight=mw)
        got = tbp.probe_count_bucketized(_rows(r), _rows(s),
                                         return_max_weight=mw)
        if mw:
            _eq(got[0], want[0])
            _eq(got[1], want[1])
        else:
            _eq(got, want)
    # oracle: per-bucket equi-join count of real keys
    oracle = [sum(int((r[b] == k).sum()) for k in s[b] if k != S_PAD_KEY)
              for b in range(nb)]
    np.testing.assert_array_equal(lane_to_numpy(got[0]), oracle)


def test_bucket_rows_sort_and_count_equal_jax():
    r, s = _blocks(6, 300, 400, 90, 21)
    want = jbp.bucket_rows_sort(jnp.asarray(r), jnp.asarray(s))
    got = tbp.bucket_rows_sort(_rows(r), _rows(s))
    # sorted (key, tag) rows are unique, so the lanes agree bit for bit
    for g, w in zip(got, want):
        np.testing.assert_array_equal(lane_to_numpy(g.reshape(-1)),
                                      np.asarray(w).reshape(-1))
    for mw in (False, True):
        w = jbp.bucket_rows_count(*want, return_max_weight=mw)
        g = tbp.bucket_rows_count(*got, return_max_weight=mw)
        for gi, wi in zip(g if mw else (g,), w if mw else (w,)):
            _eq(gi, wi)


def test_merge_probe_in_row_chunks_equals_jax(monkeypatch):
    """Rows sorted a few at a time (what bounds the card's memory after
    many local retries) count exactly what one batched row sort counts."""
    r, s = _blocks(7, 300, 260, 120, 33)
    want = jbp.probe_count_bucketized_merge(jnp.asarray(r), jnp.asarray(s),
                                            return_max_weight=True)
    for elems in (560, 1200, 1 << 27):
        monkeypatch.setattr(tbp, "ROW_CHUNK_ELEMS", elems)
        got = tbp.probe_count_bucketized_merge(_rows(r), _rows(s),
                                               return_max_weight=True)
        _eq(got[0], want[0])
        _eq(got[1], want[1])
