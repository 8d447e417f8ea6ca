"""The skew split and the hierarchical exchange of the port (ROADMAP A10),
and the capacity-retry backoff (C8), against the JAX package.

  * ``operators/skew.py``'s helpers against JAX's, bit for bit;
  * ``network_partition`` with ``exclude`` / ``override`` over one 4-process
    gloo world of the port (tests/torch_dist_worker.py) against JAX's
    under ``shard_map`` on the conftest's virtual CPU mesh;
  * ``hierarchical_block_all_to_all`` on a 2 x 2 grid against JAX's on a
    ``(dcn, ici)`` mesh and against the flat route;
  * whole joins, ``HashJoin(JoinConfig(num_nodes=4, skew_threshold=...,
    num_hosts=...))``: every rank's gathered per-partition uint32 counts,
    flags (``hot_overflow`` included), retries and sizing plan equal JAX
    ``HashJoin(num_nodes=4)``'s, in the cases of ``tests/test_skew.py``;
  * the retry backoff: RETRYN, BACKOFFMS and the ``retry`` events of a
    retrying join at one rank and at four equal JAX's;
  * the configuration's rejections, and ``multihost.initialize`` on a card
    choosing gloo only when asked.

Tolerance 0 everywhere.  One world serves the module."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import tpu_radix_join as jx  # noqa: E402
from tpu_radix_join.data.tuples import TupleBatch as JBatch  # noqa: E402
from tpu_radix_join.operators import skew as jskew  # noqa: E402
from tpu_radix_join.parallel import window as jwindow  # noqa: E402
from tpu_radix_join.parallel.mesh import (  # noqa: E402
    make_hierarchical_mesh, make_mesh)
from tpu_radix_join.parallel.network_partitioning import (  # noqa: E402
    network_partition as j_network_partition)
from tpu_radix_join.performance.measurements import (  # noqa: E402
    Measurements as JMeasurements)

import tpu_radix_join_torch as tx  # noqa: E402
from tpu_radix_join_torch.data.tuples import (  # noqa: E402
    lane_from_numpy, lane_to_numpy)
from tpu_radix_join_torch.operators import skew as tskew  # noqa: E402
from tpu_radix_join_torch.parallel import multihost  # noqa: E402
from tpu_radix_join_torch.performance import Measurements  # noqa: E402
from tpu_radix_join_torch.state import config_from_jax  # noqa: E402
from torch_dist_worker import WorkerPool  # noqa: E402

N = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pool = WorkerPool(N, tmp_path_factory.mktemp("gloo_skew_world"))
    yield pool
    pool.close()


def _shard_map(fn, in_specs, out_specs, mesh=None):
    return jax.jit(jax.shard_map(fn, mesh=mesh or make_mesh(N),
                                 in_specs=in_specs, out_specs=out_specs))


# ------------------------------------------------------------------ helpers
@pytest.mark.parametrize("r_hist,s_hist,threshold,nodes", [
    ([100] * 32, [100] * 3 + [10000] + [100] * 28, 4.0, 0),
    ([100] * 5 + [50000] + [100] * 26, [100] * 32, 4.0, 0),   # build-hot
    ([100] * 32, [100] * 5 + [50000] + [100] * 26, 4.0, 0),
    ([20] * 5 + [100] + [20] * 26, [100] * 5 + [1000000] + [100] * 26,
     4.0, 0),                                                 # vetoed
    ([20] * 5 + [100] + [20] * 26, [100] * 5 + [1000000] + [100] * 26,
     4.0, 8),                                                 # tiny R
    ([20] * 5 + [1000000] + [20] * 26, [100] * 5 + [1000000] + [100] * 26,
     4.0, 8),                                                 # heavy R
    ([0] * 32, [0] * 32, 2.0, 4),
    ([7] * 16, [1] * 15 + [400], 3.0, 4),
])
def test_detect_hot_partitions_equals_jax(r_hist, s_hist, threshold,
                                          nodes):
    r = np.asarray(r_hist, np.uint64)
    s = np.asarray(s_hist, np.uint64)
    want = jskew.detect_hot_partitions(r, s, threshold, num_nodes=nodes)
    got = tskew.detect_hot_partitions(r, s, threshold, num_nodes=nodes)
    np.testing.assert_array_equal(got, want)
    assert tskew.hot_mask_bits(got) == jskew.hot_mask_bits(want)


def test_hot_mask_bits_rejects_more_than_32_partitions():
    for mod in (jskew, tskew):
        with pytest.raises(ValueError, match="at most 32"):
            mod.hot_mask_bits(np.zeros(64, bool))
    assert tskew.MAX_SKEW_PARTITIONS == jskew.MAX_SKEW_PARTITIONS == 32


@pytest.mark.parametrize("hot_bits", [0, 1 << 3, (1 << 31) | 1,
                                      0xFFFFFFFF, 0x80000000, 0x5A5A0F0F])
def test_is_hot_and_mask_hot_equal_jax(hot_bits):
    rng = np.random.default_rng(hot_bits & 0xFFFF)
    pid = rng.integers(0, 32, 5000, dtype=np.uint32)
    want = np.asarray(jskew.is_hot(jnp.asarray(pid), hot_bits))
    got = tskew.is_hot(lane_from_numpy(pid, "cpu"), hot_bits).numpy()
    np.testing.assert_array_equal(got, want)
    hist = rng.integers(0, 1 << 32, 32, dtype=np.uint32)
    np.testing.assert_array_equal(
        lane_to_numpy(tskew.mask_hot(lane_from_numpy(hist, "cpu"),
                                     hot_bits)),
        np.asarray(jskew.mask_hot(jnp.asarray(hist), hot_bits)))


@pytest.mark.parametrize("nodes", [2, 3, 4, 7, 8])
def test_spread_destinations_equal_jax(nodes):
    """``mix32(rid) % n`` over the rid's unsigned value: rids past 2**31
    (negative int32 lanes) and congruent rids included."""
    rng = np.random.default_rng(nodes)
    rid = np.concatenate([rng.integers(0, 1 << 32, 6000, dtype=np.uint32),
                          np.arange(0, 4000 * nodes, nodes, dtype=np.uint32),
                          np.array([0, 1, 0x7FFFFFFF, 0x80000000,
                                    0xFFFFFFFE, 0xFFFFFFFF], np.uint32)])
    want = np.asarray(jskew.spread_destinations(jnp.asarray(rid), nodes))
    got = lane_to_numpy(tskew.spread_destinations(
        lane_from_numpy(rid, "cpu"), nodes))
    np.testing.assert_array_equal(got, want)
    assert got.max() < nodes


# ------------------------------------------------------- exchange routes
@pytest.mark.parametrize("mode", ["exclude", "override"])
def test_exchange_with_exclude_or_override_equals_jax(world, mode):
    """The skew split's routing of ``network_partition``: withheld tuples
    (``exclude``) and tuples sent past the assignment (``override``); the
    received lanes, valid slots, pids, per-sender counts and overflow bit
    for bit.  The JAX window groups on its Pallas partition kernel
    (interpret mode), which keeps input order within a block as K4 does."""
    rng = np.random.default_rng(7 if mode == "exclude" else 8)
    key = rng.integers(0, 1 << 20, N * 1000, dtype=np.uint32)
    key[rng.random(key.size) < 0.3] = 3          # the hot partition
    rid = np.arange(key.size, dtype=np.uint32)
    assignment = (np.arange(32) * 3 % N).astype(np.uint32)
    hot = (key & 31) == 3
    dest = rng.integers(0, N, key.size).astype(np.uint32)
    side, cap = ("inner", 512) if mode == "exclude" else ("outer", 700)

    def body(k, r, h, d):
        win = jwindow.Window(N, cap, "nodes", side,
                             partition_impl="pallas_interpret")
        kw = ({"exclude": h} if mode == "exclude" else
              {"override": (h, d)})
        res = j_network_partition(JBatch(k, r), 5, jnp.asarray(assignment),
                                  win, **kw)
        return (res.batch.key, res.batch.rid, res.valid, res.pid,
                res.recv_counts, res.send_overflow.reshape(1))

    spec = P("nodes")
    want = [np.asarray(a) for a in _shard_map(body, (spec,) * 4, (spec,) * 6)(
        jnp.asarray(key), jnp.asarray(rid), jnp.asarray(hot),
        jnp.asarray(dest))]
    per = {name: arr.reshape(N, -1).tolist()
           for name, arr in (("key", key), ("rid", rid))}
    task = {"kind": "exchange", **per, "assignment": assignment.tolist(),
            "capacity": cap, "side": side, "fanout": 5,
            "global_hist": np.bincount(key & 31, minlength=32).tolist()}
    if mode == "exclude":
        task["exclude"] = hot.reshape(N, -1).tolist()
    else:
        task["override"] = [hot.reshape(N, -1).tolist(),
                            dest.reshape(N, -1).tolist()]
    got = world.run(task)
    for rank, res in enumerate(got):
        for name, arr in zip(("key", "rid", "valid", "pid", "recv_counts"),
                             want):
            np.testing.assert_array_equal(
                np.asarray(res[name]), arr.reshape(N, -1)[rank],
                err_msg=f"{name} of rank {rank}")
        assert res["send_overflow"] == int(want[5][rank])
    if mode == "exclude":   # nothing of the hot partition arrived
        assert not any((np.asarray(res["pid"])[np.asarray(res["valid"])]
                        == 3).any() for res in got)


def test_hierarchical_all_to_all_equals_jax_and_flat(world):
    """``DistWorld.all_to_all`` with ``num_hosts=2`` (2 x 2): equal to JAX's
    ``hierarchical_block_all_to_all`` on a ``(dcn, ici)`` mesh and to the
    flat route, bit for bit.  A permutation that conserves every count but
    swaps blocks would pass a conservation check and fail here: every
    (sender, destination, slot) value is distinct."""
    block = 5
    x = (np.arange(N * N * block, dtype=np.uint32) * 2654435761
         ).astype(np.uint32)
    mesh = make_hierarchical_mesh(2, N)
    hier = jax.jit(jax.shard_map(
        lambda v: jwindow.hierarchical_block_all_to_all(v, N, block, "dcn",
                                                        "ici"),
        mesh=mesh, in_specs=P(("dcn", "ici")),
        out_specs=P(("dcn", "ici"))))(jnp.asarray(x))
    want = np.asarray(hier).reshape(N, -1)
    got = world.run({"kind": "hierarchical", "num_nodes": N, "num_hosts": 2,
                     "blocks": x.reshape(N, -1).tolist()})
    blocks = x.reshape(N, N, block)
    for rank, res in enumerate(got):
        np.testing.assert_array_equal(np.asarray(res["hier"], np.uint32),
                                      want[rank])
        np.testing.assert_array_equal(np.asarray(res["flat"], np.uint32),
                                      want[rank])
        np.testing.assert_array_equal(np.asarray(res["direct"], np.uint32),
                                      want[rank])
        # block j of sender i lands at block i of receiver j
        np.testing.assert_array_equal(
            np.asarray(res["hier"], np.uint32).reshape(N, block),
            blocks[:, rank])
        assert res["counts"]["all_to_all"] == 1


# ------------------------------------------------------------ whole joins
def _lanes(keys, hi=None):
    """Global [key, rid, key_hi] lanes with rids 0..n-1 (``test_skew``'s
    ``_batch``)."""
    keys = np.asarray(keys, np.uint32)
    rid = np.arange(keys.size, dtype=np.uint32)
    key_hi = None if hi is None else np.full(keys.size, hi, np.uint32)
    return [keys, rid, key_hi]


def _hot_workload(size):
    """``test_skew._hot_workload``: R dense unique; half of S is key 3
    (partition 3), half dense unique — every S tuple matches once."""
    half = size // 2
    return (_lanes(np.arange(size)),
            _lanes(np.concatenate([np.full(half, 3), np.arange(half)])))


def _congruent(size):
    """Every hot S rid is congruent to 0 mod N: key 3 at every N-th slot."""
    sk = np.arange(size, dtype=np.uint32)
    sk[::N] = 3
    return _lanes(np.arange(size)), _lanes(sk)


def _build_hot(size):
    """Partition 5 holds half of both sides, its build side too heavy to
    replicate (``N * R[5] > S[5]`` and ``R[5]`` past the threshold times
    the mean): detection must not split it.  S is R rolled: every S tuple
    matches once."""
    half = size // 2
    k = np.arange(half)
    rk = np.concatenate([k * 32 + 5, k * 32 + 6 + k % 26])
    return _lanes(rk), _lanes(np.roll(rk, size // 3))


def _tiny_build(size):
    """Partition 5's build side relatively elevated but tiny against its
    probe side: the absolute clause lets the split run."""
    base = np.arange(size // 8)
    extra = np.arange(600) * 32 + 5 + 32 * (size // 8)
    rk = np.concatenate([base, extra])
    half = size // 2
    sk = np.concatenate([np.full(half, 5), np.arange(half) % (size // 8)])
    return _lanes(rk), _lanes(sk)


def _wide(size):
    r, s = _hot_workload(size)
    return _lanes(r[0], hi=7), _lanes(s[0], hi=7)


def _rel(kind, seed, size, **kw):
    return dict(global_size=size, num_nodes=N, kind=kind, seed=seed,
                key_bits=32, **kw)


TWO_LEVEL = dict(two_level=True, local_fanout_bits=3, skew_threshold=4.0,
                 allocation_factor=4.0, max_retries=3)
ZIPF_OUTER = _rel("zipf", 3, 1 << 14, zipf_theta=1.1, key_domain=1 << 14)
#: id -> (JAX JoinConfig fields, lanes (r, s) or relation specs, split?)
CASES = {
    "hot_workload": (dict(skew_threshold=4.0, max_retries=1),
                     _hot_workload(1 << 15), True),
    "hot_workload_unsplit": (dict(max_retries=1), _hot_workload(1 << 15),
                             False),
    "congruent_rids": (dict(skew_threshold=2.0, max_retries=1),
                       _congruent(1 << 15), True),
    "build_hot_not_split": (dict(skew_threshold=4.0, max_retries=2),
                            _build_hot(1 << 14), False),
    "tiny_build_side": (dict(skew_threshold=4.0, max_retries=1),
                        _tiny_build(1 << 14), True),
    "zipf": (dict(skew_threshold=3.0, assignment_policy="load_aware"),
             (_rel("unique", 1, 1 << 14), ZIPF_OUTER), True),
    "debug_checks": (dict(skew_threshold=4.0, debug_checks=True),
                     _hot_workload(1 << 14), True),
    "key_bits_64": (dict(skew_threshold=4.0, key_bits=64),
                    _wide(1 << 13), True),
    "two_level": (TWO_LEVEL, _hot_workload(1 << 14), True),
    "two_level_phases": (dict(TWO_LEVEL, measure_phases=True),
                         _hot_workload(1 << 14), True),
    "hierarchical_skew": (dict(num_hosts=2, skew_threshold=4.0,
                               max_retries=1), _hot_workload(1 << 14), True),
    "hierarchical": (dict(num_hosts=2),
                     (_rel("unique", 1, 1 << 14), _rel("unique", 9, 1 << 14)),
                     False),
    "hierarchical_load_aware": (
        dict(num_hosts=2, assignment_policy="load_aware",
             allocation_factor=4.0),
        (_rel("unique", 1, 1 << 14),
         _rel("zipf", 3, 1 << 14, zipf_theta=0.75, key_domain=1 << 14)),
        False),
}


def _jax_inputs(data, jcfg, measurements=None):
    """The JAX engine's inputs: global batches, or placed relations."""
    eng = jx.HashJoin(jcfg, measurements=measurements)
    if isinstance(data[0], dict):
        return eng, tuple(eng._place(jx.Relation(**d)) for d in data)
    return eng, tuple(
        JBatch(*(None if lane is None else jnp.asarray(lane)
                 for lane in lanes)) for lanes in data)


def _task(cfg, data, **kw):
    task = {"kind": "join", "config": cfg, "plan": True, **kw}
    if isinstance(data[0], dict):
        task.update(inner=data[0], outer=data[1])
    else:
        task["lanes"] = {k: [None if lane is None else lane.tolist()
                             for lane in lanes]
                         for k, lanes in zip(("r", "s"), data)}
    return task


@pytest.mark.parametrize("case", list(CASES))
def test_skew_join_over_four_ranks_equals_jax(world, case):
    fields, data, split = CASES[case]
    jcfg = jx.JoinConfig(num_nodes=N, **fields)
    jm = JMeasurements()   # its RETRIES are the JAX join's retries
    eng, (r, s) = _jax_inputs(data, jcfg, jm)
    jcap_r, jcap_s, jplan = eng._measure_capacities(r, s)
    want = (eng.join_arrays(r, s) if not isinstance(data[0], dict)
            else eng.join(jx.Relation(**data[0]), jx.Relation(**data[1])))
    assert want.ok, want.diagnostics
    assert (jplan is not None and jplan[0] != 0) == split
    cfg = dataclasses.asdict(config_from_jax(dataclasses.asdict(jcfg)))
    got = world.run(_task(cfg, data, measure=jcfg.measure_phases))
    want_counts = np.asarray(want.partition_counts)
    for res in got:
        assert res["plan"] == [jcap_r, jcap_s] + (
            list(jplan) if jplan else [None, None])
        assert res["matches"] == want.matches
        assert res["ok"] == want.ok
        assert res["retries"] == jm.counters.get("RETRIES", 0)
        np.testing.assert_array_equal(
            np.asarray(res["partition_counts"], np.uint32), want_counts)
        diag = res["diagnostics"]
        assert diag == {k: want.diagnostics[k] for k in diag}
        assert set(diag) == set(want.diagnostics)
    assert all(res["partition_counts"] == got[0]["partition_counts"]
               for res in got)
    if not isinstance(data[0], dict):
        # every S key of these workloads matches exactly one R key
        assert want.matches == data[1][0].size
    if case in ("hot_workload", "congruent_rids"):
        # the hot partition's outer load spreads over the ranks
        hot = np.asarray(got[0]["partition_counts"]).reshape(N, 32)[:, 3]
        assert hot.min() > 0 and hot.max() <= 1.5 * hot.mean()
    if case == "hot_workload_unsplit":
        pc = np.asarray(got[0]["partition_counts"]).reshape(N, 32)
        assert (pc[:, 3] > 0).sum() == 1
    if split and not jcfg.bucket_path:
        # the hot inner block's lanes are gathered once an attempt
        lanes = 3 if jcfg.key_bits == 64 else 2
        per_attempt = lanes + 1 + (2 if jcfg.debug_checks else 0)
        assert got[0]["collectives"]["all_gather"] == (
            per_attempt * (got[0]["retries"] + 1))


def test_skew_join_without_hot_partitions_takes_no_split(world):
    """A uniform workload with ``skew_threshold`` set: no partition is hot,
    the plan is None and the join is the plain one."""
    data = (_rel("unique", 1, 1 << 13), _rel("unique", 2, 1 << 13))
    jcfg = jx.JoinConfig(num_nodes=N, skew_threshold=4.0)
    eng, (r, s) = _jax_inputs(data, jcfg)
    assert eng._measure_capacities(r, s)[2] is None
    cfg = dataclasses.asdict(config_from_jax(dataclasses.asdict(jcfg)))
    got = world.run(_task(cfg, data))
    want = eng.join(jx.Relation(**data[0]), jx.Relation(**data[1]))
    for res in got:
        assert res["plan"][2:] == [None, None]
        assert res["matches"] == want.matches == 1 << 13
        np.testing.assert_array_equal(
            np.asarray(res["partition_counts"], np.uint32),
            np.asarray(want.partition_counts))


# ------------------------------------------------------------ C8: backoff
BACKOFF = dict(retry_backoff_s=0.004, retry_backoff_mult=3.0,
               retry_backoff_max_s=0.02, retry_jitter=0.5)
BACKOFF_COUNTERS = ("RETRYN", "BACKOFFMS", "RETRIES")


def _retry_events(meta):
    return [{k: v for k, v in e.items() if k not in ("t_s", "t_epoch_s")}
            for e in meta.get("events", []) if e["event"] == "retry"]


def test_retry_backoff_at_one_rank_equals_jax(monkeypatch):
    """A two-level join of a Zipf outer at one rank retries on local
    overflow: with a backoff, RETRYN, BACKOFFMS, the ``retry`` events and
    the slept delays equal JAX's (``time.sleep`` is recorded for both
    packages alike)."""
    slept = []
    monkeypatch.setattr("time.sleep", slept.append)
    inner = dict(global_size=1 << 13, num_nodes=1, kind="unique", seed=3)
    outer = dict(global_size=1 << 13, num_nodes=1, kind="zipf", seed=4,
                 zipf_theta=0.75, key_domain=1 << 13)
    jcfg = jx.JoinConfig(two_level=True, max_retries=5, **BACKOFF)
    jm = JMeasurements()
    want = jx.HashJoin(jcfg, measurements=jm).join(jx.Relation(**inner),
                                                   jx.Relation(**outer))
    want_slept, slept[:] = list(slept), []
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert (cfg.retry_backoff_s, cfg.retry_jitter) == (0.004, 0.5)
    tm = Measurements()
    got = tx.HashJoin(cfg, device="cpu", measurements=tm).join(
        tx.Relation(**inner), tx.Relation(**outer))
    assert want.ok and got.ok and got.matches == want.matches
    assert got.retries == jm.counters["RETRIES"] >= 2
    for k in BACKOFF_COUNTERS:
        assert tm.counters.get(k) == jm.counters.get(k), k
    assert tm.counters["RETRYN"] == got.retries
    assert _retry_events(tm.meta) == _retry_events(jm.meta)
    assert [e["site"] for e in _retry_events(tm.meta)] == (
        ["engine.capacity"] * got.retries)
    assert slept == want_slept and len(slept) == got.retries


def test_no_backoff_records_nothing(monkeypatch):
    """``retry_backoff_s=0`` (the default): retries neither sleep nor tick
    RETRYN, in both packages."""
    slept = []
    monkeypatch.setattr("time.sleep", slept.append)
    inner = dict(global_size=1 << 12, num_nodes=1, kind="unique", seed=3)
    outer = dict(global_size=1 << 12, num_nodes=1, kind="zipf", seed=4,
                 zipf_theta=0.75, key_domain=1 << 12)
    tm = Measurements()
    got = tx.HashJoin(tx.JoinConfig(two_level=True, max_retries=5),
                      device="cpu", measurements=tm).join(
        tx.Relation(**inner), tx.Relation(**outer))
    assert got.ok and got.retries >= 1
    assert "RETRYN" not in tm.counters and not slept
    assert not _retry_events(tm.meta)


def test_retry_backoff_over_four_ranks_equals_jax(world):
    """A static window too small for a Zipf outer forces capacity retries
    over four ranks (``static_window_retries`` of
    tests/test_torch_distributed.py) with a backoff; no ``time.sleep`` is
    patched in either package.  Every rank records JAX's RETRYN, BACKOFFMS
    and ``retry`` events."""
    size = 1 << 12
    inner = _rel("unique", 3, size)
    outer = _rel("zipf", 4, size, zipf_theta=0.75, key_domain=size)
    jcfg = jx.JoinConfig(num_nodes=N, window_sizing="static",
                         allocation_factor=1.0, max_retries=3, **BACKOFF)
    jm = JMeasurements()
    want = jx.HashJoin(jcfg, measurements=jm).join(jx.Relation(**inner),
                                                   jx.Relation(**outer))
    assert want.ok and jm.counters["RETRYN"] >= 1
    cfg = dataclasses.asdict(config_from_jax(dataclasses.asdict(jcfg)))
    got = world.run({"kind": "join", "config": cfg, "inner": inner,
                     "outer": outer, "measure": True})
    for res in got:
        assert res["matches"] == want.matches and res["ok"]
        assert res["retries"] == jm.counters["RETRIES"]
        for k in BACKOFF_COUNTERS:
            assert res["counters"].get(k) == jm.counters.get(k), k
        assert res["retry_events"] == _retry_events(jm.meta)


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("fields", [
    dict(skew_threshold=2.0, chunk_size=256),
    dict(skew_threshold=2.0, network_fanout_bits=6),
    dict(skew_threshold=2.0, window_sizing="static"),
    dict(skew_threshold=0.0),
    dict(skew_threshold=-1.0),
    dict(retry_backoff_s=-0.1),
    dict(retry_backoff_max_s=-1.0),
    dict(retry_backoff_mult=0.5),
    dict(retry_jitter=1.5),
    dict(num_nodes=4, num_hosts=3),
])
def test_config_rejections_equal_jax(fields):
    """``test_config_rejects_unsupported_skew_combos`` and the backoff and
    host checks: each raises ValueError in both packages."""
    with pytest.raises(ValueError):
        jx.JoinConfig(**fields)
    with pytest.raises(ValueError):
        tx.JoinConfig(**fields)


@pytest.mark.parametrize("fields", [
    dict(skew_threshold=4.0), dict(num_nodes=4, num_hosts=2),
    dict(skew_threshold=2.5, two_level=True, num_nodes=8, num_hosts=4),
    dict(max_retries=3, **BACKOFF)])
def test_skew_hosts_and_backoff_carry_across(fields):
    cfg = config_from_jax(dataclasses.asdict(jx.JoinConfig(**fields)))
    assert cfg == tx.JoinConfig(**fields)
    for k, v in fields.items():
        assert getattr(cfg, k) == v


def test_one_rank_join_never_splits():
    """At one rank the split never runs (JAX takes it only when n > 1):
    the skew threshold leaves the one-rank joins as they were."""
    half = 1 << 11
    r_key = np.arange(2 * half, dtype=np.uint32)
    s_key = np.concatenate([np.full(half, 3, np.uint32),
                            np.arange(half, dtype=np.uint32)])
    want = jx.HashJoin(jx.JoinConfig(skew_threshold=4.0)).join_arrays(
        JBatch(*(jnp.asarray(a) for a in _lanes(r_key)[:2])),
        JBatch(*(jnp.asarray(a) for a in _lanes(s_key)[:2])))
    eng = tx.HashJoin(tx.JoinConfig(skew_threshold=4.0), device="cpu")
    r, s = (tx.TupleBatch(lane_from_numpy(k, "cpu"),
                          lane_from_numpy(np.arange(k.size, dtype=np.uint32),
                                          "cpu"))
            for k in (r_key, s_key))
    got = eng.join_arrays(r, s)
    assert got.matches == want.matches == 2 * half
    np.testing.assert_array_equal(got.partition_counts,
                                  np.asarray(want.partition_counts))
    assert eng._measure_capacities(r, s, eng._shuffle_plan(r, s))[2] is None
    got = eng.join_shuffled(r, s)
    assert got.ok and got.matches == 2 * half


# ------------------------------------------------------ the card's backend
def test_initialize_on_a_card_never_selects_gloo_unasked(monkeypatch):
    """``initialize(device="cuda")`` raises without NCCL and otherwise asks
    for NCCL; only ``backend="gloo"`` starts gloo on a card, and only then
    does ``gloo_on_card`` say so.  The card, NCCL and the rendezvous are
    stood in for: nothing is connected."""
    backends = []
    monkeypatch.setattr(multihost, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda backend, **kw: backends.append(backend))
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    kw = dict(init_method="file:///nonexistent", world_size=2, rank=0)
    monkeypatch.setattr(multihost.dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL is not available"):
        multihost.initialize(device="cuda", **kw)
    assert backends == []
    multihost.initialize(device="cuda", backend="gloo", **kw)
    assert backends == ["gloo"] and multihost._GLOO_ON_CARD
    monkeypatch.setattr(multihost.dist, "is_nccl_available", lambda: True)
    multihost.initialize(device="cuda", **kw)
    assert backends == ["gloo", "nccl"] and not multihost._GLOO_ON_CARD
    with pytest.raises(ValueError, match="backend must be"):
        multihost.initialize(device="cuda", backend="mpi", **kw)
    monkeypatch.setattr(multihost, "resolve_device", torch.device)
    with pytest.raises(ValueError, match="NCCL runs on CUDA"):
        multihost.initialize(device="cpu", backend="nccl", **kw)
    assert backends == ["gloo", "nccl"]
