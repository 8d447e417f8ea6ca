"""Port parity: 64-bit keys and the full-range uint32 sort probe end to end
— 64-bit relation lanes, the hi lane through K4, the exchange and the
bucketized probe, and ``tpu_radix_join_torch.HashJoin`` against the JAX
``HashJoin`` on the JAX CPU backend (matches, per-partition counts, flags,
failure class; retries against the 32-bit run of the same spec, since the
JAX result does not report them).  Tolerance 0 throughout."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_radix_join as jx  # noqa: E402
from tpu_radix_join.data import relation as jrel  # noqa: E402
from tpu_radix_join.data.tuples import TupleBatch as JBatch  # noqa: E402
from tpu_radix_join.ops import build_probe as jbp  # noqa: E402
from tpu_radix_join.ops import radix as jradix  # noqa: E402

import tpu_radix_join_torch as tx  # noqa: E402
from tpu_radix_join_torch.data import relation as trel  # noqa: E402
from tpu_radix_join_torch.data.tuples import (  # noqa: E402
    R_PAD_KEY, S_PAD_KEY, TupleBatch, lane_from_numpy, lane_to_numpy,
    make_padding_like, valid_mask)
from tpu_radix_join_torch.ops import build_probe as tbp  # noqa: E402
from tpu_radix_join_torch.ops import radix as tradix  # noqa: E402
from tpu_radix_join_torch.parallel.network_partitioning import (  # noqa: E402
    network_partition)
from tpu_radix_join_torch.parallel.window import Window  # noqa: E402
from tpu_radix_join_torch.parallel.world import make_world  # noqa: E402
from tpu_radix_join_torch.state import config_from_jax  # noqa: E402

INTERP = "pallas_interpret"


def _lane(a):
    return lane_from_numpy(np.asarray(a, np.uint32), "cpu")


def _eq(got, want):
    np.testing.assert_array_equal(lane_to_numpy(got),
                                  np.asarray(want).astype(np.uint32))


def _assert_same(got, want):
    assert got.matches == want.matches
    assert got.ok == want.ok
    assert got.partition_counts.dtype == np.uint32
    np.testing.assert_array_equal(got.partition_counts,
                                  np.asarray(want.partition_counts))
    assert set(got.diagnostics) <= set(want.diagnostics)
    assert got.diagnostics == {k: want.diagnostics[k] for k in got.diagnostics}


def _oracle64(r_lo, r_hi, s_lo, s_hi):
    """The host join count on the uint64 keys hi << 32 | lo."""
    def wide(lo, hi):
        return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(
            lo, np.uint64)
    return jrel.host_join_count(wide(r_lo, r_hi), wide(s_lo, s_hi))


# ------------------------------------------------------- 64-bit relations

SPECS = [
    ("unique", 1000, 1, {}),
    ("unique", 65535, 99, {}),
    ("modulo", 5003, 7, {"modulo": 97}),
    ("zipf", 20000, 11, {"zipf_theta": 1.25, "key_domain": (1 << 32) - 5}),
]


@pytest.mark.parametrize("kind,size,seed,extra", SPECS)
def test_64bit_lanes_equal_jax_generators(kind, size, seed, extra):
    want = jrel.Relation(size, 1, kind, seed=seed, key_bits=64,
                         **extra).shard_np(0)
    batch = trel.Relation(size, 1, kind, seed=seed, key_bits=64,
                          **extra).generate("cpu")
    assert len(want) == 3 and batch.key_hi is not None
    for lane, w in zip((batch.key, batch.key_hi, batch.rid), want):
        assert lane.dtype == torch.int32
        np.testing.assert_array_equal(lane_to_numpy(lane), w)
    if kind == "zipf":
        dev = jrel.Relation(size, 1, kind, seed=seed, key_bits=64,
                            **extra).zipf_range_device(0, size)
    else:
        dev = jrel.device_range(0, size, size, seed, extra.get("modulo"),
                                True)
    for lane, w in zip((batch.key, batch.key_hi), dev):
        np.testing.assert_array_equal(lane_to_numpy(lane), np.asarray(w))


def test_key_hi_lane_equals_jax_and_stays_off_the_pads():
    x = np.concatenate([np.array([0, 1, 0x7FFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF],
                                 np.uint32),
                        np.random.default_rng(0).integers(
                            0, 1 << 32, 4096, dtype=np.uint64).astype(
                                np.uint32)])
    got = trel.key_hi_lane(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32),
                                  jrel.key_hi_lane_np(x))
    assert got.min() >= 1 << 30 and got.max() < 1 << 31


def test_64bit_bounds_caps_and_oracles_match_jax():
    for kind, extra in (("unique", {}), ("modulo", {"modulo": 300})):
        t = trel.Relation(1024, kind=kind, key_bits=64, **extra)
        j = jrel.Relation(1024, kind=kind, key_bits=64, **extra)
        assert t.key_bound() == j.key_bound() == 1 << 64
        u = trel.Relation(1024, key_bits=64)
        assert u.expected_matches(t) == jrel.Relation(
            1024, key_bits=64).expected_matches(j)
    # 64-bit keys lift the 31-bit packing cap to the rid width
    assert trel.Relation((1 << 31) + 2, key_bits=64).global_size == \
        jrel.Relation((1 << 31) + 2, key_bits=64).global_size
    for bits, size in ((64, 1 << 32), (32, (1 << 31) - 1)):
        with pytest.raises(ValueError, match="global_size"):
            trel.Relation(size, key_bits=bits)
        with pytest.raises(ValueError, match="global_size"):
            jrel.Relation(size, key_bits=bits)


# ------------------------------------------------------------ join parity

def _specs(size, outer, key_bits):
    kind, kw = outer
    if kind == "zipf":
        kw = dict(kw, key_domain=size)
    return (dict(global_size=size, num_nodes=1, kind="unique", seed=1234,
                 key_bits=key_bits),
            dict(global_size=size, num_nodes=1, kind=kind, seed=1235,
                 key_bits=key_bits, **kw))


UNIQUE = ("unique", {})
ZIPF = ("zipf", {"zipf_theta": 0.75})


@pytest.mark.parametrize("cfg,size,outer,retries", [
    ({}, 1 << 12, UNIQUE, 0),
    ({}, 1 << 14, ZIPF, 0),
    ({}, 5000, ("modulo", {"modulo": 1250}), 0),
    ({"network_fanout_bits": 0}, 1 << 12, ZIPF, 0),
    ({"network_fanout_bits": 7}, 1 << 12, UNIQUE, 0),
    ({"probe_algorithm": "bucket"}, 1 << 13, UNIQUE, 0),
    ({"probe_algorithm": "bucket", "max_retries": 5}, 1 << 12, ZIPF, 5),
    ({"two_level": True}, 1 << 12, ("modulo", {"modulo": 1024}), 0),
])
def test_64bit_join_equals_jax(cfg, size, outer, retries):
    inner, outer_s = _specs(size, outer, 64)
    jcfg = jx.JoinConfig(key_bits=64, **cfg)
    want = jx.HashJoin(jcfg).join(jx.Relation(**inner),
                                  jx.Relation(**outer_s))
    port_cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert port_cfg == tx.JoinConfig(key_bits=64, **cfg)
    got = tx.HashJoin(port_cfg, device="cpu").join(tx.Relation(**inner),
                                                   tx.Relation(**outer_s))
    _assert_same(got, want)
    assert got.ok and got.retries == retries
    assert got.matches == tx.Relation(**inner).expected_matches(
        tx.Relation(**outer_s))
    # the hi lane is a function of the key: the 32-bit join of the same
    # relations gives the same counts after the same retries
    narrow = tx.HashJoin(tx.JoinConfig(**cfg), device="cpu").join(
        *(tx.Relation(**dict(spec, key_bits=32)) for spec in _specs(
            size, outer, 32)))
    np.testing.assert_array_equal(got.partition_counts,
                                  narrow.partition_counts)
    assert narrow.retries == got.retries


def _carried(jcfg, r_lanes, s_lanes):
    """Both engines on the same raw lanes ((key, key_hi) each, key_hi may
    be None): the JAX one directly, the port's through from_jax_state."""
    def jbatch(key, hi):
        rid = np.arange(len(key), dtype=np.uint32)
        return JBatch(jnp.asarray(key), jnp.asarray(rid),
                      None if hi is None else jnp.asarray(hi))

    want = jx.HashJoin(jcfg).join_arrays(jbatch(*r_lanes), jbatch(*s_lanes))
    d = dataclasses.asdict(jcfg)
    cfg, r = tx.from_jax_state(d, r_lanes[0], np.arange(len(r_lanes[0]),
                                                        dtype=np.uint32),
                               r_lanes[1], device="cpu")
    _, s = tx.from_jax_state(d, s_lanes[0], np.arange(len(s_lanes[0]),
                                                      dtype=np.uint32),
                             s_lanes[1], device="cpu")
    got = tx.HashJoin(cfg, device="cpu").join_arrays(r, s)
    _assert_same(got, want)
    return got


def _shared_lo_keys(n, seed):
    """Inner and outer 64-bit keys on 1024 lo values, which fill every
    (partition, bucket) pair of the default fanouts evenly, each with four
    hi values: a join on the lo lane alone would overcount fourfold."""
    rng = np.random.default_rng(seed)
    his = np.uint32(0x40000000) + np.arange(4, dtype=np.uint32)
    return [(rng.integers(0, 1024, n).astype(np.uint32),
             his[rng.integers(0, 4, n)]) for _ in range(2)]


@pytest.mark.parametrize("cfg", [
    {}, {"probe_algorithm": "bucket"}, {"two_level": True},
    {"probe_algorithm": "bucket", "local_fanout_bits": 2}])
def test_equal_lo_different_hi_joins_exactly(cfg):
    """Keys that share the lo lane and differ in hi: every path (the hi
    lane through K4, the exchange and the bucket probe; the sort probe's
    run equality on the pair) counts the uint64 join exactly."""
    (r_lo, r_hi), (s_lo, s_hi) = _shared_lo_keys(3000, 5)
    got = _carried(jx.JoinConfig(key_bits=64, **cfg), (r_lo, r_hi),
                   (s_lo, s_hi))
    oracle = _oracle64(r_lo, r_hi, s_lo, s_hi)
    assert got.ok and got.matches == oracle
    assert oracle < jrel.host_join_count(r_lo, s_lo)


@pytest.mark.parametrize("cfg", [{}, {"probe_algorithm": "bucket"}])
def test_64bit_hi_lane_pads_flag_the_contract(cfg):
    (r_lo, r_hi), (s_lo, s_hi) = _shared_lo_keys(2000, 9)
    r_hi[3] = 0xFFFFFFFE                   # the inner pad, on the hi lane
    got = _carried(jx.JoinConfig(key_bits=64, **cfg), (r_lo, r_hi),
                   (s_lo, s_hi))
    assert not got.ok
    assert got.diagnostics["key_contract_violations"] == 1
    assert got.diagnostics["failure_class"] == "key_contract"


def _full_range_lanes(n, seed):
    """Keys in [2**31, 2**31 + n) (R unique, S with repeats) and keys
    across the whole uint32 range below the pads."""
    rng = np.random.default_rng(seed)
    base = np.uint32(1 << 31)
    r = (base + rng.permutation(n).astype(np.uint32)).astype(np.uint32)
    s = (base + (rng.integers(0, n, n) % (n // 3)).astype(np.uint32))
    spread = rng.integers(0, 0xFFFFFFFE, n // 4, dtype=np.uint64).astype(
        np.uint32)
    return np.concatenate([r, spread]), np.concatenate([s, spread[::2]])


@pytest.mark.parametrize("key_range,fanout", [
    ("auto", 5), ("full", 5), ("auto", 0), ("full", 7), ("full", 3)])
def test_full_range_sort_probe_equals_jax(key_range, fanout):
    """The full route, picked by the device max key under "auto" or set
    with "full", counts every key below the pads exactly."""
    r, s = _full_range_lanes(4096, fanout)
    got = _carried(jx.JoinConfig(key_range=key_range,
                                 network_fanout_bits=fanout),
                   (r, None), (s, None))
    assert got.ok and got.matches == jrel.host_join_count(r, s)


def test_full_range_keys_flag_the_narrow_route():
    r, s = _full_range_lanes(4096, 1)
    got = _carried(jx.JoinConfig(key_range="narrow"), (r, None), (s, None))
    assert not got.ok
    assert got.diagnostics["failure_class"] == "key_contract"


@pytest.mark.parametrize("key_range", ["auto", "full"])
def test_pad_keys_on_the_full_route_count_and_flag(key_range):
    """0xFFFFFFFE on both sides: the full route counts the match, as JAX
    does, and the contract flag fires."""
    r, s = _full_range_lanes(2048, 3)
    r[7] = s[11] = s[12] = 0xFFFFFFFE
    got = _carried(jx.JoinConfig(key_range=key_range), (r, None), (s, None))
    assert not got.ok
    assert got.diagnostics["key_contract_violations"] == 1
    assert got.matches == jrel.host_join_count(r, s)


def test_full_range_relations_route_by_key_bound():
    """``join`` on Relations: "auto" reads the static key bound, so a 31-bit
    domain stays narrow and "full" gives the same counts."""
    inner, outer = _specs(1 << 12, ZIPF, 32)
    got = {kr: tx.HashJoin(tx.JoinConfig(key_range=kr), device="cpu").join(
        tx.Relation(**inner), tx.Relation(**outer)) for kr in ("auto", "full")}
    want = jx.HashJoin(jx.JoinConfig(key_range="full")).join(
        jx.Relation(**inner), jx.Relation(**outer))
    for res in got.values():
        _assert_same(res, want)


# --------------------------------------------------------- key-width rules

def test_key_width_mismatch_raises():
    (r_lo, r_hi), (s_lo, s_hi) = _shared_lo_keys(100, 1)
    rid = np.arange(100, dtype=np.uint32)
    wide = [tx.batch_from_numpy(k, rid, h, device="cpu")
            for k, h in ((r_lo, r_hi), (s_lo, s_hi))]
    narrow = [tx.batch_from_numpy(k, rid, device="cpu") for k in (r_lo, s_lo)]
    for cfg, (r, s) in ((tx.JoinConfig(key_bits=64), narrow),
                        (tx.JoinConfig(), wide),
                        (tx.JoinConfig(key_bits=64), (wide[0], narrow[1])),
                        (tx.JoinConfig(probe_algorithm="bucket"), wide)):
        with pytest.raises(ValueError, match="key_hi"):
            tx.HashJoin(cfg, device="cpu").join_arrays(r, s)
    with pytest.raises(ValueError, match="key_bits"):
        tx.HashJoin(tx.JoinConfig(key_bits=64), device="cpu").join(
            tx.Relation(64), tx.Relation(64))
    with pytest.raises(ValueError, match="key_hi"):
        tx.batch_from_numpy(r_lo, rid, r_hi[:50], device="cpu")


@pytest.mark.parametrize("key_range", ["narrow", "full"])
def test_key_range_with_64bit_keys_raises_like_jax(key_range):
    with pytest.raises(ValueError, match="key_bits=64"):
        jx.JoinConfig(key_bits=64, key_range=key_range)
    with pytest.raises(ValueError, match="key_bits=64"):
        tx.JoinConfig(key_bits=64, key_range=key_range)


# -------------------------------------- the hi lane through K4 and probes

def _wide_batch(n, seed, pad=None, pad_p=0.0):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 20, n).astype(np.uint32)
    hi = jrel.key_hi_lane_np(lo)
    if pad is not None:
        sel = rng.random(n) < pad_p
        lo[sel] = pad
        hi[sel] = pad
    rid = np.arange(n, dtype=np.uint32)
    return (JBatch(jnp.asarray(lo), jnp.asarray(rid), jnp.asarray(hi)),
            TupleBatch(_lane(lo), _lane(rid), _lane(hi)), lo, hi)


@pytest.mark.parametrize("side", ["inner", "outer"])
def test_wide_padding_and_valid_mask_equal_jax(side):
    from tpu_radix_join.data import tuples as jtuples
    pad = R_PAD_KEY if side == "inner" else S_PAD_KEY
    jb, tb, _, _ = _wide_batch(3000, 2, pad=pad, pad_p=0.3)
    np.testing.assert_array_equal(valid_mask(tb, side).numpy(),
                                  np.asarray(jtuples.valid_mask(jb, side)))
    tp = make_padding_like(tb, 5, side)
    jp = jtuples.make_padding(5, side, wide=True)
    for g, w in zip(tp, jp):
        _eq(g, w)


@pytest.mark.parametrize("cap", [4096, 1000])
@pytest.mark.parametrize("side", ["inner", "outer"])
def test_wide_scatter_and_exchange_carry_the_hi_lane(side, cap):
    jb, tb, _, _ = _wide_batch(3000, 3)
    dest = np.random.default_rng(4).integers(0, 3, 3000).astype(np.uint32)
    want = jradix.scatter_to_blocks(jb, jnp.asarray(dest), 3, cap, side,
                                    impl=INTERP)
    got = tradix.scatter_to_blocks(tb, _lane(dest), 3, cap, side)
    for g, w in zip(got[0], want[0]):
        _eq(g, w)
    _eq(got[1], want[1])
    assert int(got[2]) == int(want[2])
    # the one-rank exchange hands every lane on, the hi lane included
    res = network_partition(tb, 5, _lane(np.zeros(32, np.uint32)),
                            Window(make_world(1), cap, side))
    one = jradix.scatter_to_blocks(jb, jnp.zeros(3000, jnp.uint32), 1, cap,
                                   side, impl=INTERP)[0]
    for g, w in zip(res.batch, one):
        _eq(g, w)


@pytest.mark.parametrize("valid_p", [None, 0.6])
def test_wide_reorder_by_partition_moves_four_lanes(valid_p):
    n, p = 5000, 16
    rng = np.random.default_rng(6)
    jb, tb, _, _ = _wide_batch(n, 7)
    pid = rng.integers(0, p, n).astype(np.uint32)
    valid = None if valid_p is None else rng.random(n) < valid_p
    want = jradix.reorder_by_partition(
        jb, jnp.asarray(pid), p,
        valid=None if valid is None else jnp.asarray(valid), impl=INTERP)
    got = tradix.reorder_by_partition(
        tb, _lane(pid), p,
        valid=None if valid is None else torch.from_numpy(valid))
    for g, w in zip(got[0], want[0]):
        _eq(g, w)
    for g, w in zip(got[1:], want[1:]):
        _eq(g, w)


def _wide_blocks(nb, bi, bo, seed):
    """Padded [nb, b] lo and hi blocks where keys share lo values and differ
    in hi, with the side's pad in both lanes of 20% of the slots."""
    rng = np.random.default_rng(seed)
    out = []
    for b, pad in ((bi, R_PAD_KEY), (bo, S_PAD_KEY)):
        lo = rng.integers(0, 40, (nb, b)).astype(np.uint32)
        hi = (0x40000000 + rng.integers(0, 3, (nb, b))).astype(np.uint32)
        sel = rng.random((nb, b)) < 0.2
        lo[sel] = hi[sel] = pad
        out += [lo, hi]
    return out


def _rows(a):
    return lane_from_numpy(a.reshape(-1), "cpu").view(a.shape)


@pytest.mark.parametrize("nb,bi,bo", [(8, 100, 120), (4, 256, 256),
                                      (4, 300, 500), (2, 257, 3)])
def test_wide_probe_count_bucketized_equals_jax(nb, bi, bo):
    r, rh, s, sh = _wide_blocks(nb, bi, bo, nb + bi)
    for mw in (False, True):
        want = jbp.probe_count_bucketized(*map(jnp.asarray, (r, s, rh, sh)),
                                          return_max_weight=mw)
        got = tbp.probe_count_bucketized(*map(_rows, (r, s, rh, sh)),
                                         return_max_weight=mw)
        for g, w in zip(got if mw else (got,), want if mw else (want,)):
            _eq(g, w)
    oracle = [_oracle64(r[b], rh[b], s[b][s[b] != S_PAD_KEY],
                        sh[b][s[b] != S_PAD_KEY]) for b in range(nb)]
    np.testing.assert_array_equal(lane_to_numpy(got[0]), oracle)


def test_wide_bucket_rows_sort_and_count_equal_jax():
    r, rh, s, sh = _wide_blocks(6, 300, 400, 21)
    want = jbp.bucket_rows_sort(*map(jnp.asarray, (r, s, rh, sh)))
    got = tbp.bucket_rows_sort(*map(_rows, (r, s, rh, sh)))
    # sorted (hi, key, tag) rows: K2 is stable and each row holds its inner
    # slots first, so the riding tag lands in JAX's order bit for bit
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(lane_to_numpy(g.reshape(-1)),
                                      np.asarray(w).reshape(-1))
    for mw in (False, True):
        w = jbp.bucket_rows_count(*want, return_max_weight=mw)
        g = tbp.bucket_rows_count(*got, return_max_weight=mw)
        for gi, wi in zip(g if mw else (g,), w if mw else (w,)):
            _eq(gi, wi)


# -------------------------------------------------------------------- CLI

@pytest.mark.parametrize("argv,key_range", [
    (["--key-range", "full"], "full"),
    (["--key-range", "narrow", "--outer-kind", "zipf"], "narrow"),
    ([], "auto"),
])
def test_main_cli_key_range(argv, key_range, capsys, monkeypatch):
    from tpu_radix_join_torch import main as tmain
    from tpu_radix_join_torch.operators import hash_join as thj
    seen = []
    full = thj.merge_count_per_partition_full
    monkeypatch.setattr(thj, "merge_count_per_partition_full",
                        lambda *a, **k: seen.append(1) or full(*a, **k))
    rc = tmain.main(argv + ["--device", "cpu", "--tuples-per-node", "4096"])
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0 and got["ok"] and got["matches"] == got["expected"] == 4096
    assert got["key_range"] == key_range
    assert bool(seen) == (key_range == "full")
    assert tmain.build_parser().parse_args(argv).key_range == key_range
