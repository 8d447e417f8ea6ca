"""Port parity: the sort probe (ops/merge_count.py over K2 and K3,
ops/kernels/merge_scan.py) against the JAX ``merge_count_per_partition`` on
its fused Pallas path in interpret mode, called directly (outside
shard_map).  Per-partition uint32 counts and the max weight, exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu_radix_join.data.relation import Relation as JRelation  # noqa: E402
from tpu_radix_join.ops import merge_count as jmc  # noqa: E402
from tpu_radix_join.ops.pallas.merge_scan import (  # noqa: E402
    TILE, merge_scan_partitions as jax_merge_scan)

from tpu_radix_join_torch.data.tuples import (lane_from_numpy,  # noqa: E402
                                              lane_to_numpy)
from tpu_radix_join_torch.ops import merge_count as tmc  # noqa: E402
from tpu_radix_join_torch.ops.kernels import merge_scan as k3  # noqa: E402


def _keys(case, n, seed):
    rng = np.random.default_rng(seed)
    if case == "unique":
        return JRelation(n, kind="unique", seed=seed).shard_np(0)[0]
    if case == "modulo":
        return JRelation(n, kind="modulo", modulo=61, seed=seed).shard_np(0)[0]
    if case == "zipf":
        return JRelation(n, kind="zipf", zipf_theta=0.75, key_domain=n,
                         seed=seed).shard_np(0)[0]
    if case == "duplicate_heavy":
        return (rng.integers(0, 1 << 31, n) % 5).astype(np.uint32)
    if case == "max_merge_key":
        # keys at, just above and far above the packing bound, and the
        # sentinels: only the in-range ones may match
        edge = np.array([jmc.MAX_MERGE_KEY, jmc.MAX_MERGE_KEY + 1,
                         0xFFFFFFFE, 0xFFFFFFFF, 0x7FFFFFFF, 3], np.uint32)
        return edge[rng.integers(0, len(edge), n)]
    raise ValueError(case)


def _both(r, s, fanout):
    want_c, want_w = jmc.merge_count_per_partition(
        jnp.asarray(r), jnp.asarray(s), fanout, impl="pallas_interpret",
        return_max_weight=True)
    got_c, got_w = tmc.merge_count_per_partition(
        lane_from_numpy(r, "cpu"), lane_from_numpy(s, "cpu"), fanout,
        return_max_weight=True)
    return (lane_to_numpy(got_c), int(lane_to_numpy(got_w.reshape(1))[0]),
            np.asarray(want_c), int(want_w))


@pytest.mark.parametrize("case", ["unique", "modulo", "zipf",
                                  "duplicate_heavy", "max_merge_key"])
def test_counts_and_max_weight_equal_pallas_interpret(case):
    r = _keys(case if case != "zipf" else "unique", 5000, 1)
    s = _keys(case, 7001, 2)
    got_c, got_w, want_c, want_w = _both(r, s, 5)
    np.testing.assert_array_equal(got_c, want_c)
    assert got_w == want_w


@pytest.mark.parametrize("fanout", range(8))
def test_every_fanout_equals_pallas_interpret(fanout):
    r = _keys("duplicate_heavy", 3000, 3 + fanout) * np.uint32(977)
    s = _keys("unique", 4000, 4 + fanout)
    got_c, got_w, want_c, want_w = _both(r, s, fanout)
    assert got_c.shape == (1 << fanout,)
    np.testing.assert_array_equal(got_c, want_c)
    assert got_w == want_w


def test_run_longer_than_a_tile_and_unpadded_length():
    """One equal-key run spanning K3's tiles; the port skips the TPU path's
    post-sort pad to a 32768 multiple, and counts stay identical."""
    r = np.full(9000, 12345, np.uint32)
    s = np.concatenate([np.full(7000, 12345, np.uint32),
                        np.arange(500, dtype=np.uint32)])
    got_c, got_w, want_c, want_w = _both(r, s, 5)
    np.testing.assert_array_equal(got_c, want_c)
    assert got_w == want_w == 9000
    # the scan itself, on the JAX-padded and on the unpadded sorted lane
    packed = np.sort(np.asarray(jmc._pack_pm(jnp.asarray(r), jnp.asarray(s),
                                             5)))
    pad = (-len(packed)) % TILE
    padded = np.concatenate([packed, np.full(pad, 0xFFFFFFFF, np.uint32)])
    jc, jw = jax_merge_scan(jnp.asarray(padded), num_partitions=32,
                            interpret=True)
    for lane in (packed, padded):
        c, w = k3.merge_scan_partitions(lane_from_numpy(lane, "cpu"),
                                        num_partitions=32)
        np.testing.assert_array_equal(lane_to_numpy(c), np.asarray(jc))
        assert int(lane_to_numpy(w.reshape(1))[0]) == int(jw)


def test_pack_pm_bits_equal_jax():
    rng = np.random.default_rng(6)
    r = rng.integers(0, 1 << 32, 2000, dtype=np.uint32)
    s = rng.integers(0, 1 << 31, 2000, dtype=np.uint32)
    for fanout in (0, 5, 7):
        want = np.asarray(jmc._pack_pm(jnp.asarray(r), jnp.asarray(s), fanout))
        got = tmc._pack_pm(lane_from_numpy(r, "cpu"), lane_from_numpy(s, "cpu"),
                           fanout)
        np.testing.assert_array_equal(lane_to_numpy(got), want)


def test_run_weights_equal_jax():
    rng = np.random.default_rng(8)
    packed = np.sort(rng.integers(0, 64, 3000, dtype=np.uint32))
    want_w, want_k = jmc._weights(jnp.asarray(packed))
    got_w, got_k = tmc._weights(lane_from_numpy(packed, "cpu"))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))


def test_merge_scan_rejects_bad_partition_counts():
    lane = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        k3.merge_scan_partitions(lane, num_partitions=3)
    with pytest.raises(ValueError):
        k3.merge_scan_partitions(lane, num_partitions=1 << 31)
