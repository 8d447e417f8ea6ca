"""Port parity of the pre-shuffle (``parallel/distribute.distribute``, the
``Relation::distribute`` analog): every lane of every rank against JAX's
``distribute`` under ``shard_map`` on the 4-device virtual mesh, 32- and
64-bit keys, two seeds.  The port's four ranks run in this process over a
world that serves each rank its peers' blocks in the order ``distribute``
exchanges its lanes; the 4-process gloo world runs it too
(tests/test_torch_distributed.py).  Tolerance 0."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from tpu_radix_join.data.tuples import TupleBatch as JBatch  # noqa: E402
from tpu_radix_join.parallel.distribute import (  # noqa: E402
    _mix32 as j_mix32, distribute as j_distribute)
from tpu_radix_join.parallel.mesh import make_mesh  # noqa: E402

from tpu_radix_join_torch.data.tuples import (  # noqa: E402
    TupleBatch, lane_from_numpy, lane_to_numpy)
from tpu_radix_join_torch.parallel.distribute import (  # noqa: E402
    _mix32, distribute, shuffle_keys)

N = 4


class _Peers:
    """Rank ``rank`` of a world whose ranks hold ``batches``: the k-th
    ``all_to_all`` call exchanges the k-th lane present in every batch."""

    def __init__(self, batches, rank):
        self.batches, self.rank, self.size = batches, rank, len(batches)
        self.calls = 0

    def all_to_all(self, x, block):
        lane = self.calls
        self.calls += 1
        lanes = [[ln for ln in b if ln is not None][lane] for b in self.batches]
        assert torch.equal(lanes[self.rank], x)
        return torch.cat([ln[self.rank * block:(self.rank + 1) * block]
                          for ln in lanes])


def _lanes(key_bits, seed, n_local=500):
    rng = np.random.default_rng(seed * 7 + key_bits)
    lanes = [rng.integers(0, 1 << 32, N * n_local, dtype=np.uint32)
             for _ in range(3 if key_bits == 64 else 2)]
    lanes[0][: N * 20] = 5                       # duplicate keys
    return lanes


def _jax_distribute(lanes, seed):
    def body(*ls):
        out = j_distribute(JBatch(*ls), N, "nodes", seed=seed)
        return tuple(lane for lane in out if lane is not None)

    spec = P("nodes")
    fn = jax.jit(jax.shard_map(body, mesh=make_mesh(N),
                               in_specs=(spec,) * len(lanes),
                               out_specs=(spec,) * len(lanes)))
    return [np.asarray(a).reshape(N, -1)
            for a in fn(*[jnp.asarray(lane) for lane in lanes])]


@pytest.mark.parametrize("key_bits", [32, 64])
@pytest.mark.parametrize("seed", [0, 12345])
def test_distribute_equals_jax_every_lane(key_bits, seed):
    lanes = _lanes(key_bits, seed)
    want = _jax_distribute(lanes, seed)
    batches = [TupleBatch(*[lane_from_numpy(lane.reshape(N, -1)[r], "cpu")
                            for lane in lanes]) for r in range(N)]
    for rank in range(N):
        got = distribute(batches[rank], _Peers(batches, rank), seed=seed)
        assert (got.key_hi is None) == (key_bits == 32)
        for i, lane in enumerate(x for x in got if x is not None):
            np.testing.assert_array_equal(lane_to_numpy(lane), want[i][rank],
                                          err_msg=f"lane {i} of rank {rank}")
    # the multiset of tuples is conserved over the world
    def rows(ls):
        return sorted(zip(*[np.concatenate(x).tolist() for x in ls]))
    assert rows([[lane.reshape(N, -1)[r] for r in range(N)]
                 for lane in lanes]) == rows(want)


def test_mix32_and_the_shuffle_keys_equal_jax():
    x = np.random.default_rng(1).integers(0, 1 << 32, 50_000,
                                          dtype=np.uint32)
    np.testing.assert_array_equal(
        _mix32(torch.from_numpy(x.astype(np.int64))).numpy().astype(np.uint32),
        np.asarray(j_mix32(jnp.asarray(x))))
    for rank, seed in ((0, 0), (3, 12345), (1, 1 << 31)):
        salt = j_mix32(jnp.uint32(rank) + jnp.uint32(seed)
                       * jnp.uint32(0x9E3779B9))
        want = np.asarray(j_mix32(jnp.arange(1000, dtype=jnp.uint32) ^ salt))
        got = lane_to_numpy(shuffle_keys(1000, rank, seed, "cpu"))
        np.testing.assert_array_equal(got, want)
        assert np.unique(got).size == 1000        # a bijection: distinct


def test_distribute_rejects_a_ragged_shard_and_the_staged_mode():
    """A ragged shard raises; the staged mode, refused until A13, now
    runs: at one rank it returns what the fused mode does, and an unknown
    mode raises as JAX's ``parse_exchange_mode`` does.  The staged modes
    over four ranks: tests/test_torch_exchange_codec.py."""
    from tpu_radix_join_torch.parallel.world import OneRankWorld
    batch = TupleBatch(*[lane_from_numpy(np.arange(10, dtype=np.uint32),
                                         "cpu")] * 2)
    with pytest.raises(ValueError, match="divide"):
        distribute(batch, _Peers([batch] * 4, 0))
    fused = distribute(batch, OneRankWorld(), seed=3)
    for mode in ("staged:2", "auto", 5):
        got = distribute(batch, OneRankWorld(), seed=3, mode=mode)
        for a, b in zip(got[:2], fused[:2]):
            np.testing.assert_array_equal(lane_to_numpy(a), lane_to_numpy(b))
    with pytest.raises(ValueError, match="exchange mode"):
        distribute(batch, OneRankWorld(), mode="bogus")
