"""The materializing join and the probe API of the port (ROADMAP A12)
against the JAX package.

  * ``ops/build_probe.probe_count``, ``probe_materialize`` and
    ``probe_materialize_chunked``, and ``ops/local_join.local_join_sorted``,
    ``local_join_merge`` and ``local_join_partitioned``, on the same seeded
    numpy lanes as the JAX functions: narrow keys, full-range keys in
    [2**31, 2**32 - 2) (``torch.searchsorted`` compares int32 signed: the
    probes flip bit 31), 64-bit keys, duplicates and a match cap that
    overflows;
  * ``HashJoin.join_materialize`` / ``join_materialize_arrays`` against
    JAX's at one rank and at four ranks (one gloo world of
    ``tests/torch_dist_worker.py`` against the conftest's 4-device virtual
    mesh): unique, duplicates within the cap, an overflow flagged, the
    rate-cap retry, 64-bit, chunked, the skew split and ``measure_phases``
    with its registry.

Tolerance 0.  A run of equal inner keys may come out of K2 in another
order than out of ``lax.sort``: the pairs are held as the sorted list of
(s_rid, r_rid), and where the cap cuts a run short (the overflow cases)
which of the run's inner rids are kept may differ, so there the outer
rids, the validity masks, the overflow and the diagnostics are held
exactly and every pair is checked to join equal keys."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_radix_join as jx  # noqa: E402
from tpu_radix_join.data.tuples import CompressedBatch as JComp  # noqa: E402
from tpu_radix_join.data.tuples import TupleBatch as JBatch  # noqa: E402
from tpu_radix_join.ops import build_probe as jbp  # noqa: E402
from tpu_radix_join.ops import local_join as jlj  # noqa: E402
from tpu_radix_join.performance.measurements import (  # noqa: E402
    Measurements as JMeasurements)

import tpu_radix_join_torch as tx  # noqa: E402
from tpu_radix_join_torch import ops as tops  # noqa: E402
from tpu_radix_join_torch.data.tuples import (  # noqa: E402
    CompressedBatch, TupleBatch, lane_from_numpy, lane_to_numpy)
from tpu_radix_join_torch.ops import kernels  # noqa: E402
from tpu_radix_join_torch.performance import Measurements  # noqa: E402
from tpu_radix_join_torch.state import config_from_jax  # noqa: E402
from torch_dist_worker import WorkerPool  # noqa: E402

N = 4
#: counters only the JAX package keeps, and the rates (host times)
JAX_ONLY = {"PARTFALLBACK", "SORTFALLBACK", "NCOMPILE", "COMPILEMS"}
RATES = {"JRATE", "JPROCRATE", "HILOCRATE", "HOLOCRATE"}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pool = WorkerPool(N, tmp_path_factory.mktemp("gloo_materialize_world"))
    yield pool
    pool.close()


# ------------------------------------------------------------------ inputs
def _side(rng, n, lo, hi, wide):
    """(key, rid, key_hi or None): seeded uint32 lanes, rids a permutation."""
    key = rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)
    rid = (rng.permutation(n) + 11).astype(np.uint32)
    key_hi = (rng.integers(0, 3, n) + 7).astype(np.uint32) if wide else None
    return key, rid, key_hi


def _jcomp(x):
    return JComp(key_rem=jnp.asarray(x[0]), rid=jnp.asarray(x[1]),
                 key_rem_hi=None if x[2] is None else jnp.asarray(x[2]))


def _tcomp(x):
    return CompressedBatch(*(None if a is None else lane_from_numpy(a, "cpu")
                             for a in x))


def _jpairs(mm):
    v = np.asarray(mm.valid)
    return sorted(zip(np.asarray(mm.s_rid)[v].tolist(),
                      np.asarray(mm.r_rid)[v].tolist()))


def _tpairs(mm):
    v = mm.valid.reshape(-1).numpy()
    return sorted(zip(lane_to_numpy(mm.s_rid.reshape(-1))[v].tolist(),
                      lane_to_numpy(mm.r_rid.reshape(-1))[v].tolist()))


def _keys_by_rid(x):
    """rid -> (key_hi, key) of one side's lanes."""
    hi = x[2] if x[2] is not None else np.zeros_like(x[0])
    return dict(zip(x[1].tolist(), zip(hi.tolist(), x[0].tolist())))


def _assert_pairs_join(pairs, r, s):
    rk, sk = _keys_by_rid(r), _keys_by_rid(s)
    assert all(rk[r_rid] == sk[s_rid] for s_rid, r_rid in pairs)
    assert len(set(pairs)) == len(pairs)


def _assert_matches_equal(got, want, r, s, rows_in_outer_order=True):
    """One probe's MaterializedMatches against the JAX function's.  The
    wide resident probe's rows follow the sorted union, where equal keys'
    outer tuples may stand in another order: its outer rids are held as a
    sorted list."""
    assert int(got.overflow) == int(want.overflow)
    np.testing.assert_array_equal(got.valid.reshape(-1).numpy(),
                                  np.asarray(want.valid))
    v = np.asarray(want.valid)
    got_s = lane_to_numpy(got.s_rid.reshape(-1))[v]
    want_s = np.asarray(want.s_rid)[v]
    if not rows_in_outer_order:
        got_s, want_s = np.sort(got_s), np.sort(want_s)
    np.testing.assert_array_equal(got_s, want_s)
    pairs = _tpairs(got)
    if int(want.overflow) == 0:
        assert pairs == _jpairs(want)
    else:
        _assert_pairs_join(pairs, r, s)


#: id -> (n_inner, n_outer, key range, 64-bit)
PROBE_INPUTS = {
    "narrow_duplicates": (700, 900, (0, 2000), False),
    "narrow_heavy": (700, 900, (0, 50), False),
    "full_range": (700, 900, ((1 << 32) - 5002, (1 << 32) - 2), False),
    "full_range_duplicates": (700, 900, (1 << 31, (1 << 31) + 300), False),
    "straddling_2_31": (700, 900, ((1 << 31) - 300, (1 << 31) + 300), False),
    "wide_duplicates": (700, 900, (0, 2000), True),
    "wide_full_range": (700, 900, (1 << 31, (1 << 31) + 300), True),
}


@pytest.mark.parametrize("case", list(PROBE_INPUTS))
def test_probe_count_equals_jax(case):
    n_r, n_s, (lo, hi), wide = PROBE_INPUTS[case]
    rng = np.random.default_rng(len(case))
    r, s = _side(rng, n_r, lo, hi, wide), _side(rng, n_s, lo, hi, wide)
    want = int(jbp.probe_count(_jcomp(r), _jcomp(s)))
    got = tops.probe_count(_tcomp(r), _tcomp(s))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(lane_to_numpy(got.reshape(1))[0]) == want > 0


@pytest.mark.parametrize("cap", [1, 3, 8])
@pytest.mark.parametrize("case", list(PROBE_INPUTS))
def test_probe_materialize_equals_jax(case, cap):
    n_r, n_s, (lo, hi), wide = PROBE_INPUTS[case]
    rng = np.random.default_rng(len(case) + cap)
    r, s = _side(rng, n_r, lo, hi, wide), _side(rng, n_s, lo, hi, wide)
    want = jbp.probe_materialize(_jcomp(r), _jcomp(s), cap)
    got = tops.probe_materialize(_tcomp(r), _tcomp(s), cap)
    rows = n_s + (n_r if wide else 0)
    assert got.r_rid.shape == got.s_rid.shape == got.valid.shape == (rows,
                                                                     cap)
    _assert_matches_equal(got, want, r, s, rows_in_outer_order=not wide)


@pytest.mark.parametrize("slab", [128, 300, 900, 4096])
@pytest.mark.parametrize("case", ["narrow_duplicates", "full_range",
                                  "straddling_2_31", "wide_duplicates",
                                  "wide_full_range"])
def test_probe_materialize_chunked_equals_jax(case, slab):
    """The narrow and the wide slab forms (the wide one compacts each
    slab's union rows back to slab positions), with a partial last slab
    padded by the S sentinel."""
    n_r, n_s, (lo, hi), wide = PROBE_INPUTS[case]
    rng = np.random.default_rng(slab)
    r, s = _side(rng, n_r, lo, hi, wide), _side(rng, n_s, lo, hi, wide)
    for cap in (2, 8):
        want = jbp.probe_materialize_chunked(_jcomp(r), _jcomp(s), cap, slab)
        got = tops.probe_materialize_chunked(_tcomp(r), _tcomp(s), cap, slab)
        assert got.valid.shape == (-(-n_s // slab) * slab, cap)
        _assert_matches_equal(got, want, r, s)
        resident = tops.probe_materialize(_tcomp(r), _tcomp(s), cap)
        assert int(resident.overflow) == int(got.overflow)
        if not wide:
            assert torch.equal(got.valid[:n_s], resident.valid)


def test_probe_materialize_finds_keys_past_2_31():
    """Keys in [2**31, 2**32 - 2) compare unsigned: each of 64 inner keys
    matches its outer twin and nothing else."""
    keys = ((1 << 32) - 3 - np.arange(64, dtype=np.uint64) * 977).astype(
        np.uint32)
    r = (keys, np.arange(64, dtype=np.uint32), None)
    s = (keys[::-1].copy(), np.arange(100, 164, dtype=np.uint32), None)
    mm = tops.probe_materialize(_tcomp(r), _tcomp(s), 2)
    assert _tpairs(mm) == sorted((163 - i, i) for i in range(64))
    assert int(mm.overflow) == 0


def _batches(rng, n, lo, hi):
    k_r, k_s = (rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)
                for _ in range(2))
    rid = np.arange(n, dtype=np.uint32)
    return ((JBatch(key=jnp.asarray(k_r), rid=jnp.asarray(rid)),
             JBatch(key=jnp.asarray(k_s), rid=jnp.asarray(rid))),
            (TupleBatch(lane_from_numpy(k_r, "cpu"),
                        lane_from_numpy(rid, "cpu")),
             TupleBatch(lane_from_numpy(k_s, "cpu"),
                        lane_from_numpy(rid, "cpu"))))


@pytest.mark.parametrize("lo,hi", [(0, 50), (0, 5000), (0, 1 << 31),
                                   (1 << 31, (1 << 31) + 4000)])
def test_local_joins_equal_jax(lo, hi):
    """``local_join_sorted`` and ``local_join_partitioned`` at every key
    range (the partitioned one with and without a capacity overflow),
    ``local_join_merge`` below the packing bound."""
    rng = np.random.default_rng(hi - lo)
    (jr, js), (tr, ts) = _batches(rng, 1200, lo, hi)
    want = int(jlj.local_join_sorted(jr, js))
    got = tops.local_join_sorted(tr, ts)
    assert int(lane_to_numpy(got.reshape(1))[0]) == want
    if hi <= 1 << 31:
        np.testing.assert_array_equal(
            lane_to_numpy(tops.local_join_merge(tr, ts)),
            np.asarray(jlj.local_join_merge(jr, js)))
    for cap in (64, 1200):
        jc, jo = jlj.local_join_partitioned(jr, js, 3, cap)
        tc, to = tops.local_join_partitioned(tr, ts, 3, cap)
        assert int(to) == int(jo)
        if not int(to):
            np.testing.assert_array_equal(lane_to_numpy(tc), np.asarray(jc))
            assert int(lane_to_numpy(tc).astype(np.uint64).sum()) == want
    with pytest.raises(NotImplementedError, match="32-bit"):
        tops.local_join_merge(tr._replace(key_hi=tr.key), ts)


def test_local_joins_launch_their_kernels_counted_on_the_cpu():
    """On the CPU every wrapper takes its plain version and counts no
    launch: the counts of the card's run come from chip_smoke.py."""
    rng = np.random.default_rng(5)
    _, (tr, ts) = _batches(rng, 512, 0, 300)
    kernels.reset_launches()
    tops.local_join_merge(tr, ts)
    tops.local_join_partitioned(tr, ts, 3, 512)
    assert sum(kernels.launch_counts().values()) == 0


# ------------------------------------------------------- whole joins, 1 rank
def _rel(kind, seed, size=4096, nodes=1, **kw):
    return dict(global_size=size, num_nodes=nodes, kind=kind, seed=seed, **kw)


def _counters(counters):
    return {k: v for k, v in counters.items() if k not in RATES | JAX_ONLY}


def _assert_result_equal(got_pairs, got, want, overflow):
    assert got["matches"] == want.matches
    assert got["ok"] == want.ok
    assert got["diagnostics"] == want.diagnostics
    want_pairs = sorted(zip(np.asarray(want.s_rid).tolist(),
                            np.asarray(want.r_rid).tolist()))
    if overflow:
        assert [p[0] for p in got_pairs] == [p[0] for p in want_pairs]
    else:
        assert got_pairs == want_pairs


#: id -> (JAX JoinConfig fields, inner spec, outer spec, overflow?)
ONE_RANK = {
    "unique": ({}, _rel("unique", 1), _rel("unique", 2), False),
    "duplicates_within_cap": ({"match_rate_cap": 4},
                              _rel("modulo", 1, modulo=1024),
                              _rel("unique", 2, size=2048), False),
    "overflow": ({"match_rate_cap": 1}, _rel("modulo", 1, modulo=2048),
                 _rel("unique", 2), True),
    "rate_cap_retry": ({"match_rate_cap": 1, "max_retries": 2},
                       _rel("modulo", 1, modulo=1024), _rel("unique", 2),
                       False),
    "key_bits_64": ({"key_bits": 64}, _rel("unique", 1, key_bits=64),
                    _rel("modulo", 2, modulo=700, key_bits=64), False),
    "chunked": ({"chunk_size": 700}, _rel("unique", 1),
                _rel("modulo", 2, modulo=1500), False),
    "chunked_64": ({"chunk_size": 1000, "key_bits": 64},
                   _rel("unique", 1, key_bits=64),
                   _rel("unique", 2, key_bits=64), False),
    "measure_phases": ({"measure_phases": True, "match_rate_cap": 2,
                        "max_retries": 2}, _rel("modulo", 1, modulo=512),
                       _rel("modulo", 2, modulo=700), False),
    "static_window_retry": ({"window_sizing": "static",
                             "allocation_factor": 1.0, "max_retries": 3},
                            _rel("unique", 1),
                            _rel("zipf", 2, zipf_theta=0.75), False),
}


@pytest.mark.parametrize("case", list(ONE_RANK))
def test_join_materialize_equals_jax(case):
    """Pairs, matches, ok, the whole diagnostics dict, retries and the
    registry's counters and timer tags, against JAX's
    ``join_materialize``."""
    fields, inner, outer, overflow = ONE_RANK[case]
    jcfg = jx.JoinConfig(**fields)
    jm = JMeasurements()
    want = jx.HashJoin(jcfg, measurements=jm).join_materialize(
        jx.Relation(**inner), jx.Relation(**outer))
    m = Measurements()
    got = tx.HashJoin(config_from_jax(dataclasses.asdict(jcfg)),
                      device="cpu", measurements=m).join_materialize(
        tx.Relation(**inner), tx.Relation(**outer))
    assert isinstance(got, tx.MaterializedJoinResult)
    assert got.r_rid.dtype == got.s_rid.dtype == np.uint32
    pairs = sorted(zip(got.s_rid.tolist(), got.r_rid.tolist()))
    _assert_result_equal(pairs, got._asdict(), want, overflow)
    assert got.ok != overflow
    assert got.retries == jm.counters.get("RETRIES", 0)
    assert _counters(m.counters) == _counters(jm.counters)
    assert set(m.times_us) == set(jm.times_us) - {"JCOMPILE"}
    assert m.meta["exchange_plan"] == jm.meta["exchange_plan"]
    rel_r, rel_s = tx.Relation(**inner), tx.Relation(**outer)
    r_keys = rel_r.fill_np(0, rel_r.global_size)[0]
    s_keys = rel_s.fill_np(0, rel_s.global_size)[0]
    np.testing.assert_array_equal(r_keys[got.r_rid], s_keys[got.s_rid])
    if case == "rate_cap_retry":
        assert got.retries == 2 and got.matches == 4096   # cap 1, 2, 4
    if case == "overflow":
        assert got.diagnostics["local_overflow"] == 2048


def test_join_materialize_arrays_takes_full_range_keys():
    """Raw lanes with keys in [2**31, 2**32 - 2): the materializing join
    takes every key below the pads, as JAX's does."""
    rng = np.random.default_rng(31)
    r_key = ((1 << 31) + rng.permutation(3000)).astype(np.uint32)
    s_key = ((1 << 31) + rng.integers(0, 4000, 2500)).astype(np.uint32)
    r_rid = np.arange(3000, dtype=np.uint32)
    s_rid = np.arange(2500, dtype=np.uint32) + 7
    want = jx.HashJoin(jx.JoinConfig()).join_materialize_arrays(
        JBatch(key=jnp.asarray(r_key), rid=jnp.asarray(r_rid)),
        JBatch(key=jnp.asarray(s_key), rid=jnp.asarray(s_rid)))
    got = tx.HashJoin(tx.JoinConfig(), device="cpu").join_materialize_arrays(
        tx.batch_from_numpy(r_key, r_rid, device="cpu"),
        tx.batch_from_numpy(s_key, s_rid, device="cpu"))
    pairs = sorted(zip(got.s_rid.tolist(), got.r_rid.tolist()))
    _assert_result_equal(pairs, got._asdict(), want, False)
    assert got.ok and 0 < got.matches == int(np.isin(s_key, r_key).sum())


def test_join_materialize_flags_a_pad_key():
    """A key equal to the inner pad breaks the contract in both packages."""
    r_key = np.arange(100, dtype=np.uint32)
    r_key[5] = 0xFFFFFFFE
    rid = np.arange(100, dtype=np.uint32)
    want = jx.HashJoin(jx.JoinConfig()).join_materialize_arrays(
        JBatch(key=jnp.asarray(r_key), rid=jnp.asarray(rid)),
        JBatch(key=jnp.asarray(rid), rid=jnp.asarray(rid)))
    got = tx.HashJoin(tx.JoinConfig(), device="cpu").join_materialize_arrays(
        tx.batch_from_numpy(r_key, rid, device="cpu"),
        tx.batch_from_numpy(rid, rid, device="cpu"))
    assert not got.ok and got.diagnostics == want.diagnostics
    assert got.diagnostics["key_contract_violations"] == 1


# ----------------------------------------------------- whole joins, 4 ranks
def _lanes(keys, hi=None):
    keys = np.asarray(keys, np.uint32)
    return (keys, np.arange(keys.size, dtype=np.uint32),
            None if hi is None else np.full(keys.size, hi, np.uint32))


def _hot(size):
    """Half the outer keys are 3 (partition 3 hot); R is unique."""
    half = size // 2
    return (_lanes(np.arange(size)),
            _lanes(np.concatenate([np.full(half, 3), np.arange(half)])))


#: id -> (JAX JoinConfig fields, global lanes (r, s) or relation specs,
#: overflow?)
FOUR_RANKS = {
    "unique": ({}, (_rel("unique", 1, 1 << 13, N),
                    _rel("unique", 2, 1 << 13, N)), False),
    "duplicates_within_cap": (
        {"match_rate_cap": 4},
        (_rel("modulo", 1, 1 << 13, N, modulo=1 << 11),
         _rel("unique", 2, 1 << 12, N)), False),
    "overflow": ({"match_rate_cap": 1},
                 (_rel("modulo", 1, 1 << 13, N, modulo=1 << 12),
                  _rel("unique", 2, 1 << 13, N)), True),
    "rate_cap_retry": ({"match_rate_cap": 1, "max_retries": 1},
                       (_rel("modulo", 1, 1 << 13, N, modulo=1 << 12),
                        _rel("unique", 2, 1 << 13, N)), False),
    "key_bits_64": ({"key_bits": 64},
                    (_rel("unique", 1, 1 << 12, N, key_bits=64),
                     _rel("unique", 2, 1 << 12, N, key_bits=64)), False),
    "chunked": ({"chunk_size": 1500},
                (_rel("unique", 1, 1 << 13, N),
                 _rel("modulo", 2, 1 << 13, N, modulo=3000)), False),
    "skew_split": ({"skew_threshold": 4.0, "max_retries": 1},
                   _hot(1 << 13), False),
    "skew_split_64": ({"skew_threshold": 4.0, "key_bits": 64},
                      (_lanes(_hot(1 << 12)[0][0], hi=7),
                       _lanes(_hot(1 << 12)[1][0], hi=7)), False),
    "measure_phases": ({"measure_phases": True, "window_sizing": "static",
                        "allocation_factor": 1.0, "max_retries": 3},
                       (_rel("unique", 1, 1 << 13, N),
                        _rel("zipf", 2, 1 << 13, N, zipf_theta=0.75)),
                       False),
}


def _jax_batches(data, eng):
    if isinstance(data[0], dict):
        return tuple(eng.place(jx.Relation(**d)) for d in data)
    return tuple(JBatch(*(None if lane is None else jnp.asarray(lane)
                          for lane in lanes)) for lanes in data)


@pytest.mark.parametrize("case", list(FOUR_RANKS))
def test_join_materialize_over_four_ranks_equals_jax(world, case):
    """Every rank returns every pair, rank-major; the sorted pairs,
    matches, ok, diagnostics, retries and (``measure_phases``) the
    registry's counters equal JAX ``HashJoin(num_nodes=4)``'s."""
    fields, data, overflow = FOUR_RANKS[case]
    jcfg = jx.JoinConfig(num_nodes=N, **fields)
    jm = JMeasurements()
    eng = jx.HashJoin(jcfg, measurements=jm)
    want = eng.join_materialize_arrays(*_jax_batches(data, eng))
    cfg = dataclasses.asdict(config_from_jax(dataclasses.asdict(jcfg)))
    task = {"kind": "join", "config": cfg, "materialize": True,
            "measure": True}
    if isinstance(data[0], dict):
        task.update(inner=data[0], outer=data[1])
    else:
        task["lanes"] = {k: [None if lane is None else lane.tolist()
                             for lane in lanes]
                         for k, lanes in zip(("r", "s"), data)}
    got = world.run(task)
    for res in got:
        assert res["r_rid"] == got[0]["r_rid"]
        assert res["s_rid"] == got[0]["s_rid"]
        pairs = sorted(zip(res["s_rid"], res["r_rid"]))
        _assert_result_equal(pairs, res, want, overflow)
        assert res["retries"] == jm.counters.get("RETRIES", 0)
        assert _counters(res["counters"]) == _counters(jm.counters)
        assert set(res["times_us"]) == set(jm.times_us) - {"JCOMPILE"}
    if not overflow:
        assert want.ok and want.matches > 0
    if case == "rate_cap_retry":
        assert got[0]["retries"] == 1 and want.matches == 1 << 13
    if case.startswith("skew_split"):
        # each pair emitted once: the hot inner side joins on every rank,
        # the hot outer tuples on the rank they were spread to
        assert want.matches == len(set(zip(got[0]["s_rid"],
                                           got[0]["r_rid"])))
        assert want.matches == data[1][0].size
