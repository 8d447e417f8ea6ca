"""Port parity: the full-range and 64-bit sort probes (ops/merge_count.py
over K2 and K5, ops/kernels/merge_scan_wide.py) against the JAX
``merge_count_per_partition_full`` and ``merge_count_wide_per_partition``
on both their paths — the fused Pallas kernel in interpret mode and the XLA
scan — and K5's plain version against the JAX ``merge_scan_partitions_wide``
in interpret mode.  Per-partition uint32 counts and the max weight, exactly.

Every family has |R| = 20000 and |S| = 20001: the interpret kernel then
compiles once per fanout (the union pads to 65536), and one run of equal
keys can be longer than the TPU's 32768-element tile."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_radix_join.data.relation import key_hi_lane_np  # noqa: E402
from tpu_radix_join.ops import merge_count as jmc  # noqa: E402
from tpu_radix_join.ops.pallas.merge_scan import (  # noqa: E402
    TILE, merge_scan_partitions_wide as jax_merge_scan_wide)

from tpu_radix_join_torch.data.tuples import (lane_from_numpy,  # noqa: E402
                                              lane_to_numpy)
from tpu_radix_join_torch.ops import merge_count as tmc  # noqa: E402
from tpu_radix_join_torch.ops.kernels import merge_scan_wide as k5  # noqa: E402

N_R, N_S = 20000, 20001
ONES = 0xFFFFFFFF
FAMILIES = ["unique", "duplicate_heavy", "equal_lo_different_hi",
            "lo_extremes", "long_run", "max_merge_key_and_sentinels"]


def _pick(rng, values, n):
    values = np.asarray(values, np.uint64).astype(np.uint32)
    return values[rng.integers(0, len(values), n)]


def _family(name, seed):
    """(r_lo, r_hi, s_lo, s_hi) uint32 lanes of one key family."""
    rng = np.random.default_rng(seed)
    if name == "unique":
        # an odd multiplier permutes uint32: distinct keys over the full range
        perm = rng.permutation(N_R + N_S).astype(np.uint64)
        keys = ((perm * 0x9E3779B1 + 12345) & ONES).astype(np.uint32)
        r_lo = keys[:N_R]
        s_lo = np.concatenate([rng.permutation(r_lo)[:N_S // 2],
                               keys[N_R:N_R + N_S - N_S // 2]])
        return r_lo, key_hi_lane_np(r_lo), s_lo, key_hi_lane_np(s_lo)
    if name == "duplicate_heavy":
        lo = [(rng.integers(0, 97, n).astype(np.uint64) * 0x01000193
               & ONES).astype(np.uint32) for n in (N_R, N_S)]
        return lo[0], key_hi_lane_np(lo[0]), lo[1], key_hi_lane_np(lo[1])
    if name == "equal_lo_different_hi":
        # generated relations never give this: their hi is a function of lo
        lanes = []
        for n in (N_R, N_S):
            lanes += [_pick(rng, np.arange(8) * 0x20000001, n),
                      _pick(rng, 0x40000000 + np.arange(4), n)]
        return tuple(lanes)
    if name == "lo_extremes":
        lo = [0, 1, 0x80000000, 0xFFFFFFFE, ONES]
        hi = [0, 1, 0xFFFFFFFE, 0x7FFFFFFF]
        return (_pick(rng, lo, N_R), _pick(rng, hi, N_R),
                _pick(rng, lo, N_S), _pick(rng, hi, N_S))
    if name == "long_run":
        # one key's run spans 36001 positions, more than a TILE
        key, hi = np.uint32(0x12345678), np.uint32(0x40000001)
        s_lo = np.concatenate([np.full(16001, key, np.uint32),
                               rng.integers(0, 1 << 32, N_S - 16001,
                                            dtype=np.uint64).astype(np.uint32)])
        s_lo = rng.permutation(s_lo)
        return (np.full(N_R, key, np.uint32), np.full(N_R, hi, np.uint32),
                s_lo, np.where(s_lo == key, hi, key_hi_lane_np(s_lo)))
    if name == "max_merge_key_and_sentinels":
        m = jmc.MAX_MERGE_KEY
        lo = [m - 1, m, m + 1, m + 2, 0x7FFFFFFF, 0xFFFFFFFE, ONES]
        hi = [0x40000000, 0xFFFFFFFE, ONES, 0]
        return (_pick(rng, lo, N_R), _pick(rng, hi, N_R),
                _pick(rng, lo, N_S), _pick(rng, hi, N_S))
    raise ValueError(name)


def _meets_pallas_pad(r_lo, r_hi):
    """True when an R tuple equals the JAX Pallas path's post-sort pad, the
    all-ones S-pad image (lo all-ones, and hi all-ones or none): that path
    then counts its pads as matches of a real key.  Such a key breaks the
    key contract (it is the S pad), and the XLA path and the port, which
    pad nothing, do not count them."""
    all_ones = r_lo == ONES
    if r_hi is not None:
        all_ones &= r_hi == ONES
    return bool(all_ones.any())


def _lanes(*arrays):
    return [lane_from_numpy(a, "cpu") for a in arrays]


def _got(c, w):
    return lane_to_numpy(c), int(lane_to_numpy(w.reshape(1))[0])


def _want(c, w):
    return np.asarray(c), int(w)


def _assert_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("fanout", range(8))
@pytest.mark.parametrize("family", FAMILIES)
def test_full_range_count_equals_jax(family, fanout):
    r_lo, _, s_lo, _ = _family(family, fanout)
    got = _got(*tmc.merge_count_per_partition_full(
        *_lanes(r_lo, s_lo), fanout, return_max_weight=True))
    assert got[0].shape == (1 << fanout,)
    impls = ["xla"] + ([] if _meets_pallas_pad(r_lo, None)
                       else ["pallas_interpret"])
    for impl in impls:
        _assert_equal(got, _want(*jmc.merge_count_per_partition_full(
            jnp.asarray(r_lo), jnp.asarray(s_lo), fanout, impl=impl,
            return_max_weight=True)))


@pytest.mark.parametrize("fanout", range(8))
@pytest.mark.parametrize("family", FAMILIES)
def test_wide_count_equals_jax(family, fanout):
    r_lo, r_hi, s_lo, s_hi = _family(family, fanout)
    got = _got(*tmc.merge_count_wide_per_partition(
        *_lanes(r_lo, r_hi, s_lo, s_hi), fanout, return_max_weight=True))
    assert got[0].shape == (1 << fanout,)
    impls = ["xla"] + ([] if _meets_pallas_pad(r_lo, r_hi)
                       else ["pallas_interpret"])
    for impl in impls:
        _assert_equal(got, _want(*jmc.merge_count_wide_per_partition(
            *map(jnp.asarray, (r_lo, r_hi, s_lo, s_hi)), fanout, impl=impl,
            return_max_weight=True)))


def test_families_hold_their_cases():
    """Each family has the shape its name promises (a test of the test)."""
    r_lo, r_hi, s_lo, s_hi = _family("equal_lo_different_hi", 0)
    same_lo = r_lo[:, None] == s_lo[None, :200]
    assert (same_lo & (r_hi[:, None] != s_hi[None, :200])).any()
    r_lo, _, s_lo, _ = _family("long_run", 0)
    assert (r_lo == r_lo[0]).sum() + (s_lo == r_lo[0]).sum() > TILE
    for name in ("lo_extremes", "max_merge_key_and_sentinels"):
        r_lo, r_hi, s_lo, s_hi = _family(name, 1)
        assert {0xFFFFFFFE, ONES} <= set(r_lo.tolist()) & set(s_lo.tolist())
        assert _meets_pallas_pad(r_lo, None)


def test_full_range_pads_as_real_keys_match_like_xla():
    """Keys 0xFFFFFFFE and 0xFFFFFFFF on both sides are counted on the
    full route (the join's contract check flags them), as the JAX XLA
    path counts them."""
    r = np.array([0xFFFFFFFE, ONES, ONES, 7, 0x80000000], np.uint32)
    s = np.array([ONES, 0xFFFFFFFE, 7, 0x80000000, ONES, 3], np.uint32)
    for fanout in (0, 5):
        got = _got(*tmc.merge_count_per_partition_full(
            *_lanes(r, s), fanout, return_max_weight=True))
        want = _want(*jmc.merge_count_per_partition_full(
            jnp.asarray(r), jnp.asarray(s), fanout, impl="xla",
            return_max_weight=True))
        _assert_equal(got, want)
        assert int(got[0].astype(np.uint64).sum()) == 7 and got[1] == 2


def _sorted_union(family, fanout, wide):
    """The JAX Pallas path's sorted lanes: (lo_rot, hi, tag), the union
    sorted as (lo_rot, hi, tag), with no hi lane for the full range."""
    r_lo, r_hi, s_lo, s_hi = _family(family, 10 + fanout)
    rot = np.asarray(jmc._rotate_pid(jnp.asarray(np.concatenate([r_lo, s_lo])),
                                     fanout))
    hi = np.concatenate([r_hi, s_hi]) if wide else np.zeros_like(rot)
    tag = np.concatenate([np.zeros(N_R, np.uint32), np.ones(N_S, np.uint32)])
    order = np.lexsort((tag, hi, rot))
    return rot[order], hi[order], tag[order]


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("fanout", [0, 3, 7])
@pytest.mark.parametrize("family", ["duplicate_heavy",
                                    "equal_lo_different_hi", "long_run"])
def test_plain_k5_equals_pallas_interpret(family, fanout, wide):
    """K5's plain version on the TILE-padded sorted lanes and on the same
    lanes unpadded (the port pads nothing) against the interpret kernel on
    the padded ones."""
    rot, hi, tag = _sorted_union(family, fanout, wide)
    pad = (-len(rot)) % TILE
    ones = np.full(pad, ONES, np.uint32)
    p_rot, p_hi = np.concatenate([rot, ones]), np.concatenate([hi, ones])
    p_tag = np.concatenate([tag, np.ones(pad, np.uint32)])
    want = _want(*jax_merge_scan_wide(
        jnp.asarray(p_rot), jnp.asarray(p_hi), jnp.asarray(p_tag),
        num_partitions=1 << fanout, interpret=True))
    for lanes in ((p_rot, p_hi, p_tag), (rot, hi, tag)):
        _assert_equal(_got(*k5.merge_scan_partitions_wide(
            *_lanes(*lanes), num_partitions=1 << fanout)), want)
    if not wide:    # the full range's zero hi lane is never materialised
        _assert_equal(_got(*k5.merge_scan_partitions_wide(
            *_lanes(rot), None, *_lanes(tag), num_partitions=1 << fanout)),
            want)


@pytest.mark.parametrize("n", [0, 1, 2, 255])
def test_plain_k5_tiny_lengths(n):
    """Lengths the TPU kernel never took: zero, one, and a ragged few."""
    rng = np.random.default_rng(n)
    rot = np.sort(rng.integers(0, 4, n).astype(np.uint32) << np.uint32(30))
    tag = rng.integers(0, 2, n).astype(np.uint32)
    hi = rng.integers(0, 2, n).astype(np.uint32)
    order = np.lexsort((tag, hi, rot))
    rot, hi, tag = rot[order], hi[order], tag[order]
    c, w = _got(*k5.merge_scan_partitions_wide(*_lanes(rot, hi, tag),
                                               num_partitions=4))
    # oracle: per (lo, hi) pair, R count times S count, in partition lo >> 30
    want = np.zeros(4, np.uint64)
    maxw = 0
    for key in set(zip(rot.tolist(), hi.tolist())):
        sel = (rot == key[0]) & (hi == key[1])
        nr, ns = int((sel & (tag == 0)).sum()), int((sel & (tag == 1)).sum())
        want[key[0] >> 30] += nr * ns
        maxw = max(maxw, nr if ns else 0)
    np.testing.assert_array_equal(c, want.astype(np.uint32))
    assert w == maxw


def test_rotate_pid_equals_jax():
    rng = np.random.default_rng(4)
    lo = np.concatenate([np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                                   ONES], np.uint32),
                         rng.integers(0, 1 << 32, 4000,
                                      dtype=np.uint64).astype(np.uint32)])
    for fanout in range(8):
        want = np.asarray(jmc._rotate_pid(jnp.asarray(lo), fanout))
        got = lane_to_numpy(tmc._rotate_pid(lane_from_numpy(lo, "cpu"),
                                            fanout))
        np.testing.assert_array_equal(got, want)


def test_wide_merge_scan_rejects_bad_inputs():
    lane = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        k5.merge_scan_partitions_wide(lane, lane, lane, num_partitions=3)
    with pytest.raises(ValueError):
        k5.merge_scan_partitions_wide(lane, None, lane,
                                      num_partitions=1 << 31)
    with pytest.raises(ValueError, match="equal-length"):
        k5.merge_scan_partitions_wide(lane, lane[:4].contiguous(), lane,
                                      num_partitions=2)
    with pytest.raises(ValueError, match="int32"):
        k5.merge_scan_partitions_wide(lane.to(torch.int64), None, lane,
                                      num_partitions=2)
