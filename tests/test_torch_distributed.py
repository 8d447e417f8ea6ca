"""Port parity over ranks: one 4-process gloo world of the port
(tests/torch_dist_worker.py) against the JAX package on the conftest's
4-device virtual CPU mesh, on the same seeded relations.

  * the whole join, ``HashJoin(JoinConfig(num_nodes=4), group=...)``: every
    rank's gathered ``[4 * P]`` counts, ``matches``, ``ok`` and diagnostics
    equal JAX's ``HashJoin(num_nodes=4)`` bit for bit, for the
    ``dryrun_multichip`` geometry and each discipline of the generic body;
  * the chunked probe after the shuffle (``chunk_size``), narrow and 64-bit;
  * the registry (``HashJoin(..., measurements=...)``): the counters and
    the timer tags equal those of JAX's ``HashJoin(num_nodes=4)`` with a
    registry, with and without ``measure_phases``; a forced retry moves
    time into MWINWAIT; ``gather_all`` hands every rank four registries;
  * ``DistWorld``'s collectives; the exchange (``network_partition`` over
    K4's plain version and ``all_to_all_single``), ``compute_offsets`` and
    ``distribute`` against the JAX functions under ``shard_map``.

One world serves the module; a task that passes its deadline kills it."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import tpu_radix_join as jx  # noqa: E402
from tpu_radix_join.data.tuples import TupleBatch as JBatch  # noqa: E402
from tpu_radix_join.histograms.offset_map import (  # noqa: E402
    compute_offsets as j_compute_offsets)
from tpu_radix_join.parallel import window as jwindow  # noqa: E402
from tpu_radix_join.parallel.mesh import make_mesh  # noqa: E402
from tpu_radix_join.parallel.distribute import (  # noqa: E402
    distribute as j_distribute)
from tpu_radix_join.parallel.network_partitioning import (  # noqa: E402
    network_partition as j_network_partition)
from tpu_radix_join.performance.measurements import (  # noqa: E402
    Measurements as JMeasurements)

from tpu_radix_join_torch.state import config_from_jax  # noqa: E402
from torch_dist_worker import WorkerPool  # noqa: E402

N = 4
SIZE = 1 << 12


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pool = WorkerPool(N, tmp_path_factory.mktemp("gloo_world"))
    yield pool
    pool.close()


def _rel(kind, seed, key_bits=32, **kw):
    if kind == "zipf":
        kw = dict({"zipf_theta": 0.75, "key_domain": SIZE}, **kw)
    return dict(global_size=SIZE, num_nodes=N, kind=kind, seed=seed,
                key_bits=key_bits, **kw)


def _flipped(jrel):
    """The JAX relation's global lanes with bit 31 of every key set."""
    shards = [jrel.shard_np(i) for i in range(N)]
    key = np.concatenate([sh[0] for sh in shards]) ^ np.uint32(1 << 31)
    rid = np.concatenate([sh[-1] for sh in shards])
    return JBatch(jnp.asarray(key), jnp.asarray(rid))


DRYRUN = dict(network_fanout_bits=5, assignment_policy="load_aware")
#: id -> (JAX JoinConfig fields, inner, outer, "join" the specs or
#: "flip": join_arrays on the lanes with bit 31 of every key set)
CASES = {
    "dryrun_multichip": (DRYRUN, _rel("unique", 1), _rel("unique", 2),
                         "join"),
    "round_robin": ({}, _rel("unique", 1), _rel("modulo", 2, modulo=700),
                    "join"),
    "zipf": ({}, _rel("unique", 3), _rel("zipf", 4), "join"),
    "full_range_shifted": ({"key_range": "full"}, _rel("unique", 5),
                           _rel("modulo", 6, modulo=900), "flip"),
    "auto_range_shifted": ({}, _rel("unique", 5), _rel("zipf", 6), "flip"),
    "narrow_contract_broken": ({"key_range": "narrow"}, _rel("unique", 5),
                               _rel("unique", 6), "flip"),
    "key_bits_64": ({"key_bits": 64}, _rel("unique", 7, 64),
                    _rel("modulo", 8, 64, modulo=700), "join"),
    "bucket": ({"probe_algorithm": "bucket"}, _rel("unique", 1),
               _rel("modulo", 2, modulo=700), "join"),
    "two_level": (dict(DRYRUN, two_level=True, local_fanout_bits=3,
                       allocation_factor=3.0),
                  _rel("unique", 1), _rel("unique", 2), "join"),
    "debug_checks": (dict(DRYRUN, debug_checks=True), _rel("unique", 1),
                     _rel("unique", 2), "join"),
    "debug_checks_zipf": ({"debug_checks": True}, _rel("unique", 3),
                          _rel("zipf", 4), "join"),
    "static_window_retries": (dict(window_sizing="static",
                                   allocation_factor=1.0, max_retries=3),
                              _rel("unique", 3), _rel("zipf", 4), "join"),
    "fallback_chunked": (dict(two_level=True, max_retries=0,
                              fallback="chunked"),
                         _rel("unique", 3), _rel("zipf", 4), "join"),
    "chunked": ({"chunk_size": 1000}, _rel("unique", 1),
                _rel("modulo", 2, modulo=700), "join"),
    "chunked_64": ({"chunk_size": 1000, "key_bits": 64}, _rel("unique", 7, 64),
                   _rel("modulo", 8, 64, modulo=700), "join"),
}


def _jax_join(jcfg, inner, outer, how):
    eng = jx.HashJoin(jcfg)
    ji, jo = jx.Relation(**inner), jx.Relation(**outer)
    if how == "flip":
        return eng.join_arrays(_flipped(ji), _flipped(jo))
    return eng.join(ji, jo)


@pytest.mark.parametrize("case", list(CASES))
def test_join_over_four_ranks_equals_jax(world, case):
    fields, inner, outer, how = CASES[case]
    jcfg = jx.JoinConfig(num_nodes=N, **fields)
    want = _jax_join(jcfg, inner, outer, how)
    cfg = dataclasses.asdict(config_from_jax(dataclasses.asdict(jcfg)))
    got = world.run({"kind": "join", "config": cfg, "inner": inner,
                     "outer": outer, "flip": how == "flip"})
    want_counts = np.asarray(want.partition_counts)
    for res in got:
        assert res["matches"] == want.matches
        assert res["ok"] == want.ok
        np.testing.assert_array_equal(
            np.asarray(res["partition_counts"], np.uint32), want_counts)
        diag = res["diagnostics"]
        assert diag == {k: want.diagnostics[k] for k in diag}
        assert set(diag) == set(want.diagnostics)
    assert all(res == got[0] for res in got[1:])
    res, diag = got[0], got[0]["diagnostics"]
    oracle = jx.Relation(**inner).expected_matches(jx.Relation(**outer))
    if case == "narrow_contract_broken":
        # every rank holds keys above the packing cap: four violations
        assert not res["ok"] and diag["key_contract_violations"] == N
        return
    assert res["ok"] and (oracle is None or res["matches"] == oracle)
    if case == "fallback_chunked":
        assert diag["degraded"] == "chunked"
        return
    nodes_out = N * (jcfg.local_partition_count if jcfg.bucket_path
                     else jcfg.network_partition_count)
    assert len(res["partition_counts"]) == nodes_out
    attempts = res["retries"] + 1
    if case == "static_window_retries":
        assert res["retries"] >= 1
    # two lanes (three with 64-bit keys) and the counts, both relations
    lanes = 3 if jcfg.key_bits == 64 else 2
    assert res["collectives"]["all_to_all"] == 2 * (lanes + 1) * attempts
    # the counts, and with debug_checks the two local histograms' offsets
    assert res["collectives"]["all_gather"] == attempts * (
        3 if jcfg.debug_checks else 1)


def test_collectives_of_a_four_rank_world(world):
    got = world.run({"kind": "collectives"})
    xs = np.array([[r + 1, 10 * r, -r] for r in range(N)])
    for rank, res in enumerate(got):
        assert res["sum"] == xs.sum(0).tolist()
        assert res["max"] == xs.max(0).tolist()
        assert res["gather"] == xs.tolist()
        assert res["input_kept"] == xs[rank].tolist()
        # block j of sender i lands at block i of receiver j
        want = [100 * i + 3 * rank + k for i in range(N) for k in range(3)]
        assert res["to_all"] == want


def _shard_map(fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=make_mesh(N), in_specs=in_specs,
                                 out_specs=out_specs))


@pytest.mark.parametrize("side,cap", [("inner", 300), ("outer", 64),
                                      ("outer", 1024)])
def test_exchange_over_four_ranks_equals_jax(world, side, cap):
    """``network_partition`` and the window diagnostics: received lanes,
    valid slots, pids, per-sender counts and overflow, bit for bit.  The
    JAX window groups on its Pallas partition kernel (interpret mode),
    which keeps input order within a block as K4 does; its default XLA arm
    sorts unstably."""
    rng = np.random.default_rng(cap)
    key = rng.integers(0, 1 << 20, N * 1000, dtype=np.uint32)
    key[rng.random(key.size) < 0.3] = 7          # a hot partition
    rid = np.arange(key.size, dtype=np.uint32)
    assignment = (np.arange(32) * 3 % N).astype(np.uint32)
    ghist = np.bincount(key & 31, minlength=32).astype(np.uint32)

    def body(k, r):
        win = jwindow.Window(N, cap, "nodes", side,
                             partition_impl="pallas_interpret")
        res = j_network_partition(JBatch(k, r), 5, jnp.asarray(assignment),
                                  win)
        lost, bad = win.diagnostics(
            jwindow.ExchangeResult(res.batch, res.recv_counts,
                                   res.send_overflow),
            jnp.asarray(ghist), jnp.asarray(assignment))
        return (res.batch.key, res.batch.rid, res.valid, res.pid,
                res.recv_counts, res.send_overflow.reshape(1),
                lost.reshape(1), bad.reshape(1))

    spec = P("nodes")
    want = [np.asarray(a) for a in _shard_map(
        body, (spec, spec), (spec,) * 8)(jnp.asarray(key), jnp.asarray(rid))]
    got = world.run({"kind": "exchange", "key": key.reshape(N, -1).tolist(),
                     "rid": rid.reshape(N, -1).tolist(),
                     "assignment": assignment.tolist(), "capacity": cap,
                     "side": side, "fanout": 5,
                     "global_hist": ghist.tolist()})
    names = ("key", "rid", "valid", "pid", "recv_counts")
    for rank, res in enumerate(got):
        for name, arr in zip(names, want):
            part = arr.reshape(N, -1)[rank]
            np.testing.assert_array_equal(np.asarray(res[name]), part,
                                          err_msg=f"{name} of rank {rank}")
        assert res["send_overflow"] == int(want[5][rank])
        assert res["lost"] == int(want[6][rank])
        assert res["bad"] == bool(want[7][rank])
        assert res["all_written"] == (res["lost"] == 0 and not res["bad"])
    assert (got[0]["lost"] > 0) == (cap < 1000)


@pytest.mark.parametrize("policy", ["round_robin", "load_aware"])
def test_offsets_over_four_ranks_equal_jax(world, policy):
    """``compute_offsets`` (one ``all_gather`` of the local histograms)
    against the JAX function under ``shard_map``."""
    rng = np.random.default_rng(11)
    local = rng.integers(0, 5000, (N, 32)).astype(np.uint32)
    ghist = local.sum(0).astype(np.uint32)
    if policy == "round_robin":
        assignment = (np.arange(32) % N).astype(np.uint32)
    else:
        assignment = rng.integers(0, N, 32).astype(np.uint32)

    def body(lh):
        offs = j_compute_offsets(lh, jnp.asarray(ghist),
                                 jnp.asarray(assignment), "nodes")
        return offs.base, offs.relative, offs.absolute, offs.all_local_hists

    spec = P("nodes")
    want = [np.asarray(a) for a in _shard_map(
        body, (spec,), (spec,) * 4)(jnp.asarray(local.reshape(-1)))]
    got = world.run({"kind": "offsets", "local_hists": local.tolist(),
                     "global_hist": ghist.tolist(),
                     "assignment": assignment.tolist()})
    for rank, res in enumerate(got):
        for name, arr in zip(("base", "relative", "absolute"), want[:3]):
            np.testing.assert_array_equal(
                np.asarray(res[name], np.uint32), arr.reshape(N, -1)[rank],
                err_msg=f"{name} of rank {rank}")
        np.testing.assert_array_equal(
            np.asarray(res["all_local_hists"], np.uint32),
            want[3].reshape(N, N, 32)[rank])
        assert (np.asarray(res["relative"]) + local[rank] <= ghist).all()


#: the registry counters the engines derive alike (the JAX package adds its
#: own backend counters, PARTFALLBACK and SORTFALLBACK, and the rates
#: divide host times)
REGISTRY_COUNTERS = ("RESULTS", "RTUPLES", "STUPLES", "MWINPUTCNT",
                     "MWINBYTES", "WIREBYTES", "WINCAPR", "WINCAPS",
                     "PACKRATIO", "XSTAGES", "RETRIES", "BPBUILDTUPLES",
                     "BPPROBETUPLES")


@pytest.mark.parametrize("case,phases", [
    ("bucket", False), ("bucket", True), ("two_level", True),
    ("chunked", True), ("static_window_retries", False)])
def test_registry_over_four_ranks_equals_jax(world, case, phases):
    """Every rank's registry against JAX's registry of the same join: the
    counters, and the timer tags but JCOMPILE (a first-use build; the port
    builds nothing on the CPU); every rank gathers all four registries."""
    fields, inner, outer, how = CASES[case]
    jcfg = jx.JoinConfig(num_nodes=N, measure_phases=phases, **fields)
    jm = JMeasurements()
    want = jx.HashJoin(jcfg, measurements=jm).join(jx.Relation(**inner),
                                                   jx.Relation(**outer))
    cfg = dataclasses.asdict(config_from_jax(dataclasses.asdict(jcfg)))
    got = world.run({"kind": "join", "config": cfg, "inner": inner,
                     "outer": outer, "flip": False, "measure": True})
    want_tags = set(jm.times_us) - {"JCOMPILE"}
    for rank, res in enumerate(got):
        assert res["matches"] == want.matches
        for k in REGISTRY_COUNTERS:
            assert res["counters"].get(k) == jm.counters.get(k), k
        assert set(res["times_us"]) == want_tags
        assert res["gathered"] == [[i, want.matches, sorted(want_tags)]
                                   for i in range(N)]
    if phases:
        assert {"JMPI", "SNETCOMPL", "JPROC"} <= want_tags
    if case == "static_window_retries":
        assert jm.counters["RETRIES"] >= 1
        assert all(res["times_us"]["MWINWAIT"] > 0 for res in got)


@pytest.mark.parametrize("key_bits,seed", [(32, 0), (64, 5)])
def test_distribute_over_four_ranks_equals_jax(world, key_bits, seed):
    """``distribute`` (one all_to_all a lane, then the hash sort) against
    the JAX function under ``shard_map``: every lane of every rank."""
    rng = np.random.default_rng(seed + key_bits)
    lanes = [rng.integers(0, 1 << 32, N * 600, dtype=np.uint32)
             for _ in range(3 if key_bits == 64 else 2)]
    lanes[0][:50] = 7                                # duplicate keys

    def body(*ls):
        out = j_distribute(JBatch(*ls), N, "nodes", seed=seed)
        return tuple(lane for lane in out if lane is not None)

    spec = P("nodes")
    want = [np.asarray(a) for a in _shard_map(
        body, (spec,) * len(lanes), (spec,) * len(lanes))(
            *[jnp.asarray(lane) for lane in lanes])]
    # TupleBatch order: key, rid, key_hi
    per_rank = [[lane.reshape(N, -1)[rank].tolist() for lane in lanes]
                for rank in range(N)]
    if key_bits == 32:
        per_rank = [ls + [None] for ls in per_rank]
    got = world.run({"kind": "distribute", "lanes": per_rank, "seed": seed})
    for rank, res in enumerate(got):
        for i, arr in enumerate(want):
            np.testing.assert_array_equal(
                np.asarray(res["lanes"][i], np.uint32),
                arr.reshape(N, -1)[rank], err_msg=f"lane {i} of rank {rank}")


def test_registry_records_the_last_attempt_when_retries_run_out(world):
    """Retries exhausted on a capacity shortfall: the port records the
    exchange of the attempt that produced the result.  JAX's registry
    records the capacities doubled once more after that attempt (its retry
    loop doubles before it finds no attempt left), so the expected values
    halve JAX's on each side that still overflowed."""
    fields = dict(window_sizing="static", allocation_factor=1.0,
                  max_retries=1)
    inner, outer = _rel("unique", 3), _rel("zipf", 4)
    jcfg = jx.JoinConfig(num_nodes=N, **fields)
    jm = JMeasurements()
    want = jx.HashJoin(jcfg, measurements=jm).join(jx.Relation(**inner),
                                                   jx.Relation(**outer))
    diag = want.diagnostics
    assert not want.ok and diag["failure_class"] == "capacity_overflow"
    cap_r = jm.counters["WINCAPR"] // (2 if diag["shuffle_overflow_r_tuples"]
                                       else 1)
    cap_s = jm.counters["WINCAPS"] // (2 if diag["shuffle_overflow_s_tuples"]
                                       else 1)
    assert (cap_r, cap_s) != (jm.counters["WINCAPR"], jm.counters["WINCAPS"])
    cfg = dataclasses.asdict(config_from_jax(dataclasses.asdict(jcfg)))
    got = world.run({"kind": "join", "config": cfg, "inner": inner,
                     "outer": outer, "flip": False, "measure": True})
    for res in got:
        assert res["matches"] == want.matches and not res["ok"]
        c = res["counters"]
        assert (c["WINCAPR"], c["WINCAPS"]) == (cap_r, cap_s)
        assert c["MWINBYTES"] == c["WIREBYTES"] == 8 * N * (cap_r + cap_s)
        assert c["RETRIES"] == jm.counters["RETRIES"] == 1
        assert res["times_us"]["MWINWAIT"] > 0
