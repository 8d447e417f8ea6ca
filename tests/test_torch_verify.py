"""Integrity verification and repair of the port (ROADMAP A15) against the
JAX package.

  * ``ops/sorting.segmented_xor_fold`` (K2, then a blocked prefix xor) and
    ``robustness/verify.py``'s checksums, ``damaged_partitions`` and
    ``cross_check_counts``, bit for bit; ``global_partition_checksums``
    over one 4-process gloo world (tests/torch_dist_worker.py) against
    JAX's under ``shard_map``;
  * the engine with the fault site ``exchange.corrupt_lane`` armed once:
    silent without verify (the counts conserve, the matches are wrong),
    ``ok=False`` with ``data_corruption`` under "check", the oracle count
    with JAX's ``repaired`` / ``repaired_partitions`` under "repair" — one
    1 x 1 grid a damaged partition on the sort and chunked paths, the
    whole join on the bucket path — at one rank and at four; VCHKN, VFAIL,
    VREPAIR, GRIDPAIRS and the ``data_corruption`` / ``repair`` events
    equal JAX's;
  * the configuration (``verify`` with ``measure_phases`` raises,
    ``grid_pipeline`` carries across) and ``--verify``.

Tolerance 0 everywhere.  One world serves the module."""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import tpu_radix_join as jx  # noqa: E402
from tpu_radix_join.data.tuples import TupleBatch as JBatch  # noqa: E402
from tpu_radix_join.ops.sorting import (  # noqa: E402
    segmented_xor_fold as j_xor_fold)
from tpu_radix_join.parallel.mesh import make_mesh  # noqa: E402
from tpu_radix_join.performance.measurements import (  # noqa: E402
    Measurements as JMeasurements)
from tpu_radix_join.robustness import faults as jfaults  # noqa: E402
from tpu_radix_join.robustness import verify as jverify  # noqa: E402

import tpu_radix_join_torch as tx  # noqa: E402
from tpu_radix_join_torch.data.tuples import (  # noqa: E402
    TupleBatch, lane_from_numpy, lane_to_numpy)
from tpu_radix_join_torch.ops.sorting import (  # noqa: E402
    segmented_xor_fold)
from tpu_radix_join_torch.parallel.world import OneRankWorld  # noqa: E402
from tpu_radix_join_torch.performance import Measurements  # noqa: E402
from tpu_radix_join_torch.robustness import faults as tfaults  # noqa: E402
from tpu_radix_join_torch.robustness import verify as tverify  # noqa: E402
from tpu_radix_join_torch.state import config_from_jax  # noqa: E402
from torch_dist_worker import WorkerPool  # noqa: E402

N = 4
VERIFY_COUNTERS = ("VCHKN", "VFAIL", "VREPAIR", "GRIDPAIRS", "FINJECT")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pool = WorkerPool(N, tmp_path_factory.mktemp("gloo_verify_world"))
    yield pool
    pool.close()


def _lane(a):
    return lane_from_numpy(np.asarray(a, np.uint32), "cpu")


# ------------------------------------------------------------ primitives
@pytest.mark.parametrize("n,segments", [(1, 4), (6, 4), (3000, 1),
                                        (5000, 33), (20000, 128),
                                        (4097, 32)])
def test_segmented_xor_fold_equals_jax(n, segments):
    """Random values over every segment and the discard bucket
    ``segments``; empty segments fold to 0."""
    rng = np.random.default_rng(n + segments)
    seg = rng.integers(0, segments + 1, n).astype(np.uint32)
    seg[seg == segments // 2] = segments      # one segment left empty
    val = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    want = np.asarray(j_xor_fold(jnp.asarray(seg), jnp.asarray(val),
                                 segments))
    got = lane_to_numpy(segmented_xor_fold(_lane(seg), _lane(val), segments))
    np.testing.assert_array_equal(got, want)


def test_segmented_xor_fold_reference_vectors():
    """``tests/test_verify.py``'s two vectors."""
    got = lane_to_numpy(segmented_xor_fold(_lane([2, 0, 1, 0, 2, 3]),
                                           _lane([5, 13, 7, 9, 17, 11]), 4))
    assert got.tolist() == [13 ^ 9, 7, 5 ^ 17, 11]
    got = lane_to_numpy(segmented_xor_fold(_lane([0, 0, 3]), _lane([1, 2, 4]),
                                           4))
    assert got.tolist() == [3, 0, 0, 4]


def _checksum_inputs(seed, n=4000, num_p=32, wide=False):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    pid = (key & (num_p - 1)).astype(np.uint32)
    valid = rng.random(n) > 0.15
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint32) if wide else None
    return key, pid, valid, hi


@pytest.mark.parametrize("wide,masked,num_p", [
    (False, False, 32), (False, True, 32), (True, True, 32),
    (False, True, 128), (True, False, 1)])
def test_device_partition_checksums_equal_jax(wide, masked, num_p):
    key, pid, valid, hi = _checksum_inputs(num_p + wide, num_p=num_p,
                                           wide=wide)
    jadds, jxors = jverify.device_partition_checksums(
        jnp.asarray(key), jnp.asarray(pid), num_p,
        valid=jnp.asarray(valid) if masked else None,
        key_hi=None if hi is None else jnp.asarray(hi))
    adds, xors = tverify.device_partition_checksums(
        _lane(key), _lane(pid), num_p,
        valid=torch.from_numpy(valid) if masked else None,
        key_hi=None if hi is None else _lane(hi))
    np.testing.assert_array_equal(lane_to_numpy(adds.reshape(-1)),
                                  np.asarray(jadds).reshape(-1))
    np.testing.assert_array_equal(lane_to_numpy(xors.reshape(-1)),
                                  np.asarray(jxors).reshape(-1))
    assert adds.shape[0] + xors.shape[0] == tverify.checksum_rows(wide) \
        == jverify.checksum_rows(wide)
    one = tverify.global_partition_checksums(
        _lane(key), _lane(pid), num_p, OneRankWorld(),
        valid=torch.from_numpy(valid) if masked else None,
        key_hi=None if hi is None else _lane(hi))
    np.testing.assert_array_equal(
        lane_to_numpy(one.reshape(-1)),
        np.concatenate([np.asarray(jadds), np.asarray(jxors)]).reshape(-1))


@pytest.mark.parametrize("wide", [False, True])
def test_global_partition_checksums_over_four_ranks_equal_jax(world, wide):
    """The sums wrap in uint32 over the ranks (keys near 2**32 make them
    wrap) and the xor rows combine by per-bit parity: equal to JAX's
    ``psum`` fingerprint bit for bit."""
    key, pid, valid, hi = _checksum_inputs(40 + wide, n=N * 1500, wide=wide)
    key[::3] |= 0xF0000000

    def body(k, p, v, h=None):
        return jverify.global_partition_checksums(k, p, 32, "nodes",
                                                  valid=v, key_hi=h)[None]

    args = [jnp.asarray(key), jnp.asarray(pid), jnp.asarray(valid)] + (
        [jnp.asarray(hi)] if wide else [])
    want = np.asarray(jax.jit(jax.shard_map(
        body, mesh=make_mesh(N), in_specs=(P("nodes"),) * len(args),
        out_specs=P()))(*args)).reshape(-1)
    task = {"kind": "checksums", "num_partitions": 32,
            "key": key.reshape(N, -1).tolist(),
            "pid": pid.reshape(N, -1).tolist(),
            "valid": valid.reshape(N, -1).tolist()}
    if wide:
        task["key_hi"] = hi.reshape(N, -1).tolist()
    for res in world.run(task):
        np.testing.assert_array_equal(np.asarray(res["checksums"], np.uint32),
                                      want)


def test_damaged_partitions_and_cross_check_equal_jax():
    pre = np.arange(12, dtype=np.uint32).reshape(3, 4)
    post = pre.copy()
    post[1, 2] ^= 1
    post[2, 0] ^= 8
    for a, b in ((pre, pre), (pre, post)):
        np.testing.assert_array_equal(tverify.damaged_partitions(a, b),
                                      jverify.damaged_partitions(a, b))
    for mod in (jverify, tverify):
        with pytest.raises(ValueError, match="shape"):
            mod.damaged_partitions(pre, post[:2])
    r = np.asarray([2, 3], np.uint64)
    s = np.asarray([4, 5], np.uint64)
    for counts, total in (([[8, 15]], 23), ([[8, 15]], 22), ([[9, 15]], 24),
                          ([[4, 5], [4, 10]], 23)):
        c = np.asarray(counts, np.uint64)
        assert (tverify.cross_check_counts(c, total, r, s)
                == jverify.cross_check_counts(c, total, r, s))


def test_data_corruption_carries_partitions_and_class():
    e = tverify.DataCorruption("damaged", partitions=[3, np.uint32(7)])
    assert isinstance(e, ValueError) and e.partitions == (3, 7)
    assert e.failure_class == jverify.DataCorruption.failure_class
    assert tverify.DataCorruption("lane").partitions == ()
    assert tfaults.EXCHANGE_CORRUPT == jfaults.EXCHANGE_CORRUPT
    assert tfaults.EXCHANGE_CORRUPT in tfaults.SITES


# ------------------------------------------------------------ the engine
def _inputs(n=1 << 12, seed=0):
    """``tests/test_verify._join_inputs``: R unique 1..n, S uniform over
    1..n, so the oracle is n and any damaged outer key moves the count."""
    rng = np.random.default_rng(seed)
    rk = (rng.permutation(n) + 1).astype(np.uint32)
    sk = rng.integers(1, n + 1, size=n).astype(np.uint32)
    rid = np.arange(n, dtype=np.uint32)
    return [rk, rid, None], [sk, rid, None], n


def _events(meta):
    return [{k: v for k, v in e.items() if k not in ("t_s", "t_epoch_s")}
            for e in meta.get("events", [])
            if e["event"] in ("data_corruption", "repair")]


def _jax_run(fields, data, fault, nodes):
    jm = JMeasurements()
    eng = jx.HashJoin(jx.JoinConfig(num_nodes=nodes, **fields),
                      measurements=jm)
    r, s = (JBatch(*(None if lane is None else jnp.asarray(lane)
                     for lane in lanes)) for lanes in data)
    inj = jfaults.FaultInjector()
    inj.arm(jfaults.EXCHANGE_CORRUPT, at=1)
    # an active injector stamps fault_sites into the diagnostics
    with inj if fault else contextlib.nullcontext():
        want = eng.join_arrays(r, s)
    return want, jm


def _port_run(fields, data, fault):
    m = Measurements()
    eng = tx.HashJoin(tx.JoinConfig(**fields), device="cpu", measurements=m)
    r, s = (TupleBatch(*(None if lane is None else _lane(lane)
                         for lane in lanes)) for lanes in data)
    inj = tfaults.FaultInjector()
    inj.arm(tfaults.EXCHANGE_CORRUPT, at=1)
    with inj if fault else contextlib.nullcontext():
        got = eng.join_arrays(r, s)
    return got, m


#: id -> (config fields, fault armed, what the join must report)
ENGINE_CASES = {
    "sort_check_clean": (dict(verify="check"), False, "clean"),
    "sort_silent": (dict(verify="off"), True, "silent"),
    "sort_check": (dict(verify="check"), True, "caught"),
    "sort_repair": (dict(verify="repair"), True, "partition"),
    "bucket_check_clean": (dict(verify="check", probe_algorithm="bucket"),
                           False, "clean"),
    "bucket_check": (dict(verify="check", probe_algorithm="bucket"), True,
                     "caught"),
    "bucket_repair": (dict(verify="repair", probe_algorithm="bucket"), True,
                      "full"),
    "chunked_repair": (dict(verify="repair", chunk_size=1024), True,
                       "partition"),
    "pack_check_clean": (dict(verify="check", exchange_codec="pack"), False,
                         "clean"),
    "staged_repair": (dict(verify="repair", exchange_stages=3), True,
                      "partition"),
    "two_level_repair_pipelined": (dict(verify="repair", two_level=True,
                                        local_fanout_bits=3,
                                        grid_pipeline="on"), True, "full"),
}


def _assert_outcome(got, oracle, outcome):
    if outcome == "clean":
        assert got["ok"] and got["matches"] == oracle
    elif outcome == "silent":
        assert got["ok"] and got["matches"] != oracle
    elif outcome == "caught":
        assert not got["ok"]
        assert got["diagnostics"]["failure_class"] == "data_corruption"
        assert got["diagnostics"]["data_corruption_partitions"] >= 1
    else:
        assert got["ok"] and got["matches"] == oracle
        assert got["diagnostics"]["repaired"] == outcome
        assert got["diagnostics"]["failure_class"] == "data_corruption"


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_verify_at_four_ranks_equals_jax(world, case):
    fields, fault, outcome = ENGINE_CASES[case]
    r, s, oracle = _inputs()
    want, jm = _jax_run(fields, (r, s), fault, N)
    cfg = dataclasses.asdict(config_from_jax(dataclasses.asdict(
        jx.JoinConfig(num_nodes=N, **fields))))
    task = {"kind": "join", "config": cfg, "measure": True, "fault": fault,
            "lanes": {"r": [r[0].tolist(), r[1].tolist(), None],
                      "s": [s[0].tolist(), s[1].tolist(), None]}}
    for res in world.run(task):
        _assert_outcome(res, oracle, outcome)
        assert res["ok"] == want.ok and res["matches"] == want.matches
        np.testing.assert_array_equal(
            np.asarray(res["partition_counts"], np.uint32),
            np.asarray(want.partition_counts))
        assert res["diagnostics"] == want.diagnostics
        for name in VERIFY_COUNTERS:
            assert res["counters"].get(name) == jm.counters.get(name), name
        assert res["verify_events"] == _events(jm.meta)
        assert ("VCHK" in res["times_us"]) == (fields["verify"] != "off")
    if outcome == "partition":
        assert len(want.diagnostics["repaired_partitions"]) == 1
        assert jm.counters["VREPAIR"] == jm.counters["GRIDPAIRS"] == 1


@pytest.mark.parametrize("case", ["sort_check_clean", "sort_silent",
                                  "bucket_check_clean", "bucket_check",
                                  "bucket_repair", "chunked_repair",
                                  "two_level_repair_pipelined"])
def test_verify_at_one_rank_equals_jax(case):
    """One rank: the bucket and chunked paths verify and repair as JAX's
    one-device engine does; the sort probe exchanges nothing, so it is not
    verified (no VCHK) while the fault site still damages its keys."""
    fields, fault, outcome = ENGINE_CASES[case]
    r, s, oracle = _inputs()
    want, jm = _jax_run(fields, (r, s), fault, 1)
    got, m = _port_run(fields, (r, s), fault)
    res = {"ok": got.ok, "matches": got.matches,
           "diagnostics": got.diagnostics}
    if case != "sort_check_clean":
        _assert_outcome(res, oracle, outcome)
    assert got.ok == want.ok and got.matches == want.matches
    np.testing.assert_array_equal(got.partition_counts,
                                  np.asarray(want.partition_counts))
    assert got.diagnostics == want.diagnostics
    for name in VERIFY_COUNTERS:
        assert m.counters.get(name) == jm.counters.get(name), name
    assert _events(m.meta) == _events(jm.meta)
    sort_probe = case.startswith("sort")
    assert ("VCHK" in m.times_us) == (not sort_probe)
    assert ("VCHK" in jm.times_us) == (not sort_probe)


@pytest.mark.parametrize("mode", ["check", "repair"])
def test_verify_with_pipelined_repeats_equals_jax(mode):
    """``join_arrays(..., repeats=3)`` keeps the last attempt's checksum
    sets (hash_join.py:1880-1900): with the fault armed once, every
    attempt joins the damaged lanes, and the verdict and the repaired
    count equal JAX's, with RESULTS three joins' worth."""
    r, s, oracle = _inputs(1 << 11)
    fields = dict(verify=mode, probe_algorithm="bucket")
    jm = JMeasurements()
    jeng = jx.HashJoin(jx.JoinConfig(**fields), measurements=jm)
    m = Measurements()
    eng = tx.HashJoin(tx.JoinConfig(**fields), device="cpu", measurements=m)
    outs = []
    for f, e, batch in ((jfaults, jeng, JBatch), (tfaults, eng, TupleBatch)):
        lanes = [batch(*(None if x is None else (
            jnp.asarray(x) if batch is JBatch else _lane(x)) for x in side))
            for side in (r, s)]
        with f.FaultInjector().arm(f.EXCHANGE_CORRUPT, at=1):
            outs.append(e.join_arrays(*lanes, repeats=3))
    want, got = outs
    assert got.ok == want.ok and got.matches == want.matches
    assert got.diagnostics == want.diagnostics
    for name in VERIFY_COUNTERS + ("RESULTS",):
        assert m.counters.get(name) == jm.counters.get(name), name
    assert (got.ok and got.matches == oracle) == (mode == "repair")


def test_verify_under_the_skew_split_equals_jax(world):
    """A split join verifies its exchange with the hot inner partitions
    left out of the pre-exchange fingerprint (they take the replication
    route): clean, and with the fault the damaged partition repaired."""
    half = 1 << 13
    rk = np.arange(2 * half, dtype=np.uint32)
    sk = np.concatenate([np.full(half, 3), np.arange(half)]).astype(np.uint32)
    rid = np.arange(2 * half, dtype=np.uint32)
    data = ([rk, rid, None], [sk, rid, None])
    for mode, fault in (("check", False), ("repair", True)):
        fields = dict(verify=mode, skew_threshold=4.0, max_retries=1)
        want, jm = _jax_run(fields, data, fault, N)
        cfg = dataclasses.asdict(config_from_jax(dataclasses.asdict(
            jx.JoinConfig(num_nodes=N, **fields))))
        got = world.run({"kind": "join", "config": cfg, "measure": True,
                         "fault": fault,
                         "lanes": {k: [lanes[0].tolist(), lanes[1].tolist(),
                                       None]
                                   for k, lanes in zip("rs", data)}})
        for res in got:
            assert res["ok"] and res["matches"] == want.matches == 2 * half
            assert res["diagnostics"] == want.diagnostics
            for name in VERIFY_COUNTERS:
                assert res["counters"].get(name) == jm.counters.get(name)


# ------------------------------------------------------------ config, CLI
def test_config_carries_verify_and_grid_pipeline():
    for fields in (dict(verify="check"), dict(verify="repair",
                                              grid_pipeline="off"),
                   dict(grid_pipeline="on")):
        jcfg = jx.JoinConfig(**fields)
        assert config_from_jax(dataclasses.asdict(jcfg)) == \
            tx.JoinConfig(**fields)


def test_config_rejects_verify_with_measure_phases_as_jax():
    for mod in (jx, tx):
        with pytest.raises(ValueError, match="measure_phases"):
            mod.JoinConfig(verify="check", measure_phases=True)
        with pytest.raises(ValueError, match="verify"):
            mod.JoinConfig(verify="paranoid")
        with pytest.raises(ValueError, match="grid pipeline"):
            mod.JoinConfig(grid_pipeline="sometimes")


def test_cli_verify_flag(monkeypatch, capsys):
    """``--verify`` (JAX ``main.py:55-60``) reaches the config, and a
    verified one-rank bucket join passes and counts its comparisons."""
    import json
    from tpu_radix_join_torch import main as tmain
    seen = []
    real = tx.HashJoin

    def spy(cfg, *a, **kw):
        seen.append(cfg)
        return real(cfg, *a, **kw)

    monkeypatch.setattr(tx, "HashJoin", spy)
    rc = tmain.main(["--device", "cpu", "--tuples-per-node", "4096",
                     "--probe", "bucket", "--verify", "repair",
                     "--grid-pipeline", "off"])
    assert rc == 0
    assert seen[0].verify == "repair" and seen[0].grid_pipeline == "off"
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["counters"]["VCHKN"] == 4
