"""Port parity: relation generation and mix32 (tpu_radix_join_torch/data,
utils) against the JAX package, bit for bit, on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_radix_join.data import relation as jrel  # noqa: E402
from tpu_radix_join.utils.hashing import mix32_np  # noqa: E402

from tpu_radix_join_torch.data import relation as trel  # noqa: E402
from tpu_radix_join_torch.data.tuples import lane_to_numpy  # noqa: E402
from tpu_radix_join_torch.utils.hashing import mix32  # noqa: E402


def test_mix32_matches_numpy_twin():
    rng = np.random.default_rng(3)
    x = np.concatenate([
        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                 np.uint32),
        rng.integers(0, 1 << 32, 1 << 16, dtype=np.uint32)])
    got = mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), mix32_np(x))
    assert got.min() >= 0 and got.max() < 1 << 32


SPECS = [
    # (kind, global_size, seed, extra)
    ("unique", 1000, 1, {}),
    ("unique", 4099, 1234, {}),
    ("unique", 65535, 99, {}),
    ("modulo", 5003, 7, {"modulo": 97}),
    ("modulo", 40000, 8, {"modulo": 65536}),
    ("zipf", 3001, 5, {"zipf_theta": 0.75}),
    ("zipf", 50000, 1235, {"zipf_theta": 0.75, "key_domain": 1 << 20}),
    ("zipf", 20000, 11, {"zipf_theta": 1.25, "key_domain": (1 << 32) - 5}),
]


@pytest.mark.parametrize("kind,size,seed,extra", SPECS)
def test_lanes_equal_jax_generators(kind, size, seed, extra):
    want_key, want_rid = jrel.Relation(size, 1, kind, seed=seed,
                                       **extra).shard_np(0)
    batch = trel.Relation(size, 1, kind, seed=seed,
                          **extra).generate("cpu")
    assert batch.key.dtype == torch.int32 and batch.rid.dtype == torch.int32
    np.testing.assert_array_equal(lane_to_numpy(batch.key), want_key)
    np.testing.assert_array_equal(lane_to_numpy(batch.rid), want_rid)
    # and the JAX device generators, which shard_np twins
    if kind == "zipf":
        jr = jrel.Relation(size, 1, kind, seed=seed, **extra)
        dev_key, _ = jr.zipf_range_device(0, size)
    else:
        dev_key, _ = jrel.device_range(0, size, size, seed,
                                       extra.get("modulo"), False)
    np.testing.assert_array_equal(lane_to_numpy(batch.key),
                                  np.asarray(dev_key))


@pytest.mark.parametrize("theta,domain", [(0.75, 1000), (0.75, 1 << 20),
                                          (1.25, (1 << 32) - 5)])
def test_zipf_tables_verbatim(theta, domain):
    for a, b in zip(trel.zipf_tables(theta, domain),
                    jrel.zipf_tables(theta, domain)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("start", [0, 777])
def test_zipf_range_matches_numpy_sampler(start):
    head, tail = jrel.zipf_tables(0.9, 1 << 22)
    want = jrel.zipf_keys_np(start, 3000, head, tail, 1 << 22, 42)
    got = trel.zipf_range(start, 3000, head, tail, 1 << 22, 42, "cpu")
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_key_bounds_and_oracles_match_jax():
    pairs = [("unique", {}), ("modulo", {"modulo": 300}),
             ("zipf", {"zipf_theta": 0.75, "key_domain": 900})]
    inner_j = jrel.Relation(1024, kind="unique", seed=5)
    inner_t = trel.Relation(1024, kind="unique", seed=5)
    for kind, extra in pairs:
        oj = jrel.Relation(2048 if kind != "unique" else 1024, kind=kind,
                           seed=9, **extra)
        ot = trel.Relation(2048 if kind != "unique" else 1024, kind=kind,
                           seed=9, **extra)
        assert ot.key_bound() == oj.key_bound()
        assert inner_t.expected_matches(ot) == inner_j.expected_matches(oj)
    rk = lane_to_numpy(inner_t.generate("cpu").key)
    sk = lane_to_numpy(trel.Relation(2048, kind="modulo", modulo=256,
                                     seed=1).generate("cpu").key)
    assert trel.host_join_count(rk, sk) == jrel.host_join_count(rk, sk) == 2048


def test_out_of_slice_relations_raise():
    """64-bit relations and multi-rank shards are in the slice now: a
    rank's shard equals the JAX package's ``shard_np(rank)``.  A modulo
    relation without its modulo still raises."""
    wide = trel.Relation(1024, key_bits=64).generate("cpu")
    np.testing.assert_array_equal(
        lane_to_numpy(wide.key_hi),
        jrel.Relation(1024, key_bits=64).shard_np(0)[1])
    for rank in range(2):
        shard = trel.Relation(1024, num_nodes=2).shard(rank, "cpu")
        want = jrel.Relation(1024, num_nodes=2).shard_np(rank)
        np.testing.assert_array_equal(lane_to_numpy(shard.key), want[0])
        np.testing.assert_array_equal(lane_to_numpy(shard.rid), want[1])
    with pytest.raises(ValueError):
        trel.Relation(1024, kind="modulo")
