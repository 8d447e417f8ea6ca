"""Port parity of the chunked probe after the shuffle (``chunk_size``) and
the compressed-tuple helpers it reads: ``probe_count_chunked`` and
``probe_count_per_partition`` against the JAX functions on the same lanes
(narrow and 64-bit keys; slabs that divide the outer side, that leave a
ragged last slab and that are larger than it; duplicate keys and pads),
``compress`` / ``decompress`` / ``probe_key`` / ``make_padding`` against
JAX's, and one-rank ``chunk_size`` joins against the JAX engine.
Tolerance 0."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_radix_join as jx  # noqa: E402
from tpu_radix_join.data import tuples as jt  # noqa: E402
from tpu_radix_join.ops import build_probe as jbp  # noqa: E402

import tpu_radix_join_torch as tx  # noqa: E402
from tpu_radix_join_torch.data import tuples as tt  # noqa: E402
from tpu_radix_join_torch.data.tuples import (  # noqa: E402
    lane_from_numpy, lane_to_numpy)
from tpu_radix_join_torch.ops import build_probe as tbp  # noqa: E402
from tpu_radix_join_torch.state import config_from_jax  # noqa: E402

P = 32
N_R, N_S = 1500, 1200


def _lanes(wide, seed):
    """Inner and outer lanes as the receive buffers hold them: duplicate
    keys, a hot key, and pads of each side (both lanes for 64-bit keys);
    the outer pid lane is the key's low bits, as the JAX join carries it."""
    rng = np.random.default_rng(seed)
    rk = rng.integers(0, 900, N_R, dtype=np.uint32)
    sk = rng.integers(0, 900, N_S, dtype=np.uint32)
    rk[:40] = sk[:60] = 17
    rk[-100:] = tt.R_PAD_KEY
    sk[-80:] = tt.S_PAD_KEY
    rh = sh = None
    if wide:
        rh = rng.integers(0, 3, N_R, dtype=np.uint32)
        sh = rng.integers(0, 3, N_S, dtype=np.uint32)
        rh[-100:] = tt.R_PAD_KEY
        sh[-80:] = tt.S_PAD_KEY
    return rk, rh, sk, sh, sk & np.uint32(P - 1)


def _max_weight(rk, rh, sk, sh):
    """The largest number of inner tuples one outer tuple matches, from
    the uint64 keys hi << 32 | lo."""
    def keys(lo, hi):
        return lo.astype(np.uint64) | (
            np.uint64(0) if hi is None else hi.astype(np.uint64) << np.uint64(32))
    inner, n = np.unique(keys(rk, rh), return_counts=True)
    hit = np.isin(inner, keys(sk, sh))
    return int(n[hit].max())


def _both(key, hi):
    rid = np.arange(key.size, dtype=np.uint32)
    return (jt.CompressedBatch(jnp.asarray(key), jnp.asarray(rid),
                               None if hi is None else jnp.asarray(hi)),
            tt.CompressedBatch(lane_from_numpy(key, "cpu"),
                               lane_from_numpy(rid, "cpu"),
                               None if hi is None
                               else lane_from_numpy(hi, "cpu")))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("slab", [400, 500, 4096])   # divides, ragged, larger
def test_probe_count_chunked_equals_jax(wide, slab):
    rk, rh, sk, sh, pid = _lanes(wide, slab)
    (ji, ti), (jo, to) = _both(rk, rh), _both(sk, sh)
    want_c, want_w = jbp.probe_count_chunked(ji, jo, jnp.asarray(pid), P,
                                             slab, return_max_weight=True)
    got_c, got_w = tbp.probe_count_chunked(ti, to, lane_from_numpy(pid, "cpu"),
                                           P, slab, return_max_weight=True)
    np.testing.assert_array_equal(lane_to_numpy(got_c), np.asarray(want_c))
    assert int(got_w) == int(want_w) == _max_weight(rk, rh, sk, sh)
    assert np.asarray(want_c).sum() > 0
    np.testing.assert_array_equal(
        lane_to_numpy(tbp.probe_count_chunked(
            ti, to, lane_from_numpy(pid, "cpu"), P, slab)),
        np.asarray(want_c))


@pytest.mark.parametrize("wide", [False, True])
def test_probe_count_per_partition_equals_jax(wide):
    rk, rh, sk, sh, pid = _lanes(wide, 3)
    (ji, ti), (jo, to) = _both(rk, rh), _both(sk, sh)
    want_c, want_w = jbp.probe_count_per_partition(
        ji, jo, jnp.asarray(pid), P, return_max_weight=True)
    got_c, got_w = tbp.probe_count_per_partition(
        ti, to, lane_from_numpy(pid, "cpu"), P, return_max_weight=True)
    np.testing.assert_array_equal(lane_to_numpy(got_c), np.asarray(want_c))
    assert int(got_w) == int(want_w)


def test_chunked_probe_rejects_an_empty_slab():
    rk, rh, sk, sh, pid = _lanes(False, 1)
    _, ti = _both(rk, rh)
    _, to = _both(sk, sh)
    with pytest.raises(ValueError, match="slab_size"):
        tbp.probe_count_chunked(ti, to, lane_from_numpy(pid, "cpu"), P, 0)


@pytest.mark.parametrize("fanout", [0, 1, 5, 7])
@pytest.mark.parametrize("wide", [False, True])
def test_compress_decompress_and_probe_key_equal_jax(fanout, wide):
    rng = np.random.default_rng(fanout)
    key = rng.integers(0, 1 << 32, 2000, dtype=np.uint32)
    hi = rng.integers(0, 1 << 32, 2000, dtype=np.uint32) if wide else None
    rid = np.arange(2000, dtype=np.uint32)
    jb = jt.TupleBatch(jnp.asarray(key), jnp.asarray(rid),
                       None if hi is None else jnp.asarray(hi))
    tb = tt.TupleBatch(lane_from_numpy(key, "cpu"), lane_from_numpy(rid, "cpu"),
                       None if hi is None else lane_from_numpy(hi, "cpu"))
    jc, tc = jt.compress(jb, fanout), tt.compress(tb, fanout)
    for want, got in zip(jc, tc):
        assert (want is None) == (got is None)
        if want is not None:
            np.testing.assert_array_equal(lane_to_numpy(got), np.asarray(want))
    np.testing.assert_array_equal(
        tt.probe_key(tc).numpy().view(np.uint32), np.asarray(jt.probe_key(jc)))
    pid = key & np.uint32((1 << fanout) - 1)
    back = tt.decompress(tc, lane_from_numpy(pid, "cpu"), fanout)
    for want, got in zip(jt.decompress(jc, jnp.asarray(pid), fanout), back):
        if want is not None:
            np.testing.assert_array_equal(lane_to_numpy(got), np.asarray(want))
    np.testing.assert_array_equal(lane_to_numpy(back.key), key)


@pytest.mark.parametrize("side", ["inner", "outer"])
@pytest.mark.parametrize("wide", [False, True])
def test_make_padding_equals_jax(side, wide):
    want = jt.make_padding(5, side, wide=wide)
    got = tt.make_padding(5, side, wide=wide)
    assert got.size == 5
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is not None:
            np.testing.assert_array_equal(lane_to_numpy(g), np.asarray(w))


@pytest.mark.parametrize("fields", [
    {"chunk_size": 1000}, {"chunk_size": 3000},
    {"chunk_size": 1000, "key_bits": 64},
    {"chunk_size": 1 << 20, "key_range": "narrow"}])
def test_one_rank_chunked_join_equals_jax(fields):
    """``chunk_size`` at one rank runs the generic body (JAX ``sort_probe``
    is false then): counts, diagnostics and matches equal JAX's; keys past
    the 31-bit packing join, since the chunked probe compares whole keys."""
    kb = fields.get("key_bits", 32)
    jcfg = jx.JoinConfig(**fields)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert not cfg.sort_probe and cfg.chunk_size == fields["chunk_size"]
    rels = [dict(global_size=4096, num_nodes=1, kind="unique", seed=3,
                 key_bits=kb),
            dict(global_size=4096, num_nodes=1, kind="zipf", seed=4,
                 zipf_theta=0.75, key_domain=4096, key_bits=kb)]
    want = jx.HashJoin(jcfg).join(*[jx.Relation(**r) for r in rels])
    eng = tx.HashJoin(cfg, device="cpu")
    got = eng.join(*[tx.Relation(**r) for r in rels])
    assert got.matches == want.matches and got.ok == want.ok
    np.testing.assert_array_equal(got.partition_counts,
                                  np.asarray(want.partition_counts))
    assert got.diagnostics == {k: want.diagnostics[k] for k in got.diagnostics}
    oracle = jx.Relation(**rels[0]).expected_matches(jx.Relation(**rels[1]))
    assert got.ok and (oracle is None or got.matches == oracle)
    # keys above MAX_MERGE_KEY: the narrow packing would flag them
    if kb == 32:
        r, s = (b._replace(key=torch.bitwise_xor(b.key, -(1 << 31)))
                for b in (eng.place(tx.Relation(**rels[0])),
                          eng.place(tx.Relation(**rels[1]))))
        flipped = eng.join_arrays(r, s)
        assert flipped.ok and flipped.matches == got.matches


@pytest.mark.parametrize("fields", [
    {"chunk_size": 0}, {"chunk_size": 64, "probe_algorithm": "bucket"},
    {"chunk_size": 64, "two_level": True}])
def test_chunk_size_rules_follow_jax(fields):
    with pytest.raises(ValueError, match="chunk_size"):
        jx.JoinConfig(**fields)
    with pytest.raises(ValueError, match="chunk_size"):
        tx.JoinConfig(**fields)
