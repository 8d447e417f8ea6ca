"""The knobs and hooks of the port's command line (ROADMAP A20) against
the JAX package.

  * the host generators: ``Relation.shard_np`` / ``fill_np`` and
    ``feistel_permutation_np``, ``zipf_keys_np``, ``key_hi_lane_np``,
    bit for bit against JAX's numpy arms (its native ``datagen.cc`` off)
    and against JAX's ``shard_np`` as it runs, for every kind;
  * ``JoinConfig(generation="host")``: ``HashJoin.place`` gives the device
    generator's bits, and the joins equal JAX's;
  * ``join_arrays(..., repeats=k)`` / ``join_arrays_pipelined``: the result
    and the registry's counters against JAX's, and the rejections;
  * the fault site ``engine.shuffle_overflow`` in the counting and the
    materializing retry loops: results, diagnostics (``fault_sites``
    included), counters and events against JAX's;
  * the command line's ``--debug-checks``, ``--generation`` and
    ``--pipeline-repeats``: the ``[RESULTS]`` and ``[PERF]`` count lines
    against the JAX command line's.

Tolerance 0 everywhere."""

import dataclasses
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_radix_join as jx  # noqa: E402
from tpu_radix_join.data import relation as jrel  # noqa: E402
from tpu_radix_join.main import main as jax_main  # noqa: E402
from tpu_radix_join.performance.measurements import (  # noqa: E402
    Measurements as JMeasurements)
from tpu_radix_join.robustness import faults as jfaults  # noqa: E402

import tpu_radix_join_torch as tx  # noqa: E402
from tpu_radix_join_torch.data import relation as trel  # noqa: E402
from tpu_radix_join_torch.data.tuples import lane_to_numpy  # noqa: E402
from tpu_radix_join_torch.main import main as tx_main  # noqa: E402
from tpu_radix_join_torch.performance import Measurements  # noqa: E402
from tpu_radix_join_torch.robustness import faults as tfaults  # noqa: E402
from tpu_radix_join_torch.state import config_from_jax  # noqa: E402

JAX_ONLY = {"PARTFALLBACK", "SORTFALLBACK", "NCOMPILE", "COMPILEMS"}
RATES = {"JRATE", "JPROCRATE", "HILOCRATE", "HOLOCRATE"}


def _counters(counters):
    return {k: v for k, v in counters.items() if k not in RATES | JAX_ONLY}


def _events(meta):
    return [{k: v for k, v in e.items() if k not in ("t_s", "t_epoch_s")}
            for e in meta.get("events", [])]


# ------------------------------------------------------- host generation
KINDS = {
    "unique": dict(kind="unique"),
    "unique_odd_domain": dict(kind="unique", global_size=5000 * 4),
    "modulo": dict(kind="modulo", modulo=777),
    "zipf_head": dict(kind="zipf", zipf_theta=0.75),
    "zipf_tail": dict(kind="zipf", zipf_theta=1.1, key_domain=1 << 20),
    "unique_64": dict(kind="unique", key_bits=64),
    "zipf_64": dict(kind="zipf", zipf_theta=0.5, key_bits=64),
}


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("case", list(KINDS))
def test_shard_np_equals_jax(case, native, monkeypatch):
    """Every node's shard, bit for bit and uint32, against JAX's numpy
    arms (``native=False``) and against JAX's ``shard_np`` as it runs
    (its native generator where it built), and the port's device lanes."""
    if not native:
        monkeypatch.setattr(jrel, "_load_native", lambda: None)
    spec = dict(dict(global_size=1 << 15, num_nodes=4, seed=7), **KINDS[case])
    want_rel, got_rel = jx.Relation(**spec), tx.Relation(**spec)
    for node in range(4):
        want, got = want_rel.shard_np(node), got_rel.shard_np(node)
        assert len(got) == len(want) == (3 if spec.get("key_bits") == 64
                                         else 2)
        for w, g in zip(want, got):
            assert g.dtype == np.uint32
            np.testing.assert_array_equal(g, w)
        dev = got_rel.shard(node, "cpu")
        np.testing.assert_array_equal(lane_to_numpy(dev.key), got[0])
        np.testing.assert_array_equal(lane_to_numpy(dev.rid), got[-1])


def test_host_generator_pieces_equal_jax():
    """``feistel_permutation_np``, ``zipf_keys_np``, ``key_hi_lane_np`` and
    ``fill_np`` into caller buffers, against JAX's."""
    idx = np.arange(0, 1 << 14, 3, dtype=np.uint64)
    for bits, seed in ((14, 1), (15, 99), (31, 1234)):
        np.testing.assert_array_equal(
            trel.feistel_permutation_np(idx, bits, seed),
            jrel.feistel_permutation_np(idx, bits, seed))
    head, tail = jrel.zipf_tables(1.2, 1 << 22)
    np.testing.assert_array_equal(
        trel.zipf_keys_np(1 << 31, 4096, head, tail, 1 << 22, 5),
        jrel.zipf_keys_np(1 << 31, 4096, head, tail, 1 << 22, 5))
    keys = np.random.default_rng(2).integers(0, 1 << 32, 5000,
                                             dtype=np.uint64)
    np.testing.assert_array_equal(trel.key_hi_lane_np(keys),
                                  jrel.key_hi_lane_np(keys))
    rel = tx.Relation(10000, kind="modulo", modulo=33)
    key, rid = np.empty(500, np.uint32), np.empty(500, np.uint32)
    out = rel.fill_np(9000, 500, out_key=key, out_rid=rid)
    assert out[0] is key and out[1] is rid
    np.testing.assert_array_equal(key, np.arange(9000, 9500) % 33)
    with pytest.raises(ValueError, match="contiguous uint32"):
        rel.fill_np(0, 500, out_key=np.empty(500, np.int64))


@pytest.mark.parametrize("fields,outer", [
    ({}, dict(kind="zipf", zipf_theta=0.75)),
    ({"probe_algorithm": "bucket"}, dict(kind="modulo", modulo=900)),
    ({"key_bits": 64}, dict(kind="unique", key_bits=64)),
])
def test_host_generation_joins_equal_jax(fields, outer):
    """``generation="host"`` places the device generator's bits, and the
    join's result equals JAX's under the same setting."""
    kb = fields.get("key_bits", 32)
    inner = dict(global_size=4096, num_nodes=1, kind="unique", seed=1,
                 key_bits=kb)
    outer = dict(dict(global_size=4096, num_nodes=1, seed=2), **outer)
    jcfg = jx.JoinConfig(generation="host", **fields)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert cfg.generation == "host"
    host = tx.HashJoin(cfg, device="cpu")
    dev = tx.HashJoin(dataclasses.replace(cfg, generation="device"),
                      device="cpu")
    for spec in (inner, outer):
        a, b = host.place(tx.Relation(**spec)), dev.place(tx.Relation(**spec))
        assert all((x is None and y is None) or torch.equal(x, y)
                   for x, y in zip(a, b))
    want = jx.HashJoin(jcfg).join(jx.Relation(**inner), jx.Relation(**outer))
    got = host.join(tx.Relation(**inner), tx.Relation(**outer))
    assert got.matches == want.matches and got.ok == want.ok
    np.testing.assert_array_equal(got.partition_counts,
                                  np.asarray(want.partition_counts))
    assert got.diagnostics == want.diagnostics


def test_generation_mode_is_checked():
    with pytest.raises(ValueError, match="generation"):
        tx.JoinConfig(generation="gpu")


# ------------------------------------------------------------ repeats
@pytest.mark.parametrize("fields", [
    {}, {"probe_algorithm": "bucket"}, {"key_bits": 64},
    {"chunk_size": 700}, {"two_level": True, "local_fanout_bits": 3},
    {"key_range": "full"}])
def test_repeats_equal_jax(fields):
    """k pipelined joins: the result of one, and RESULTS, RTUPLES,
    STUPLES and the exchange counters k times, as JAX's."""
    kb = fields.get("key_bits", 32)
    rels = [dict(global_size=4096, num_nodes=1, kind="unique", seed=1,
                 key_bits=kb),
            dict(global_size=4096, num_nodes=1, kind="modulo", seed=2,
                 modulo=700, key_bits=kb)]
    jcfg = jx.JoinConfig(**fields)
    jm = JMeasurements()
    jeng = jx.HashJoin(jcfg, measurements=jm)
    want = jeng.join_arrays(*[jeng.place(jx.Relation(**r)) for r in rels],
                            repeats=3)
    m = Measurements()
    eng = tx.HashJoin(config_from_jax(dataclasses.asdict(jcfg)),
                      device="cpu", measurements=m)
    r, s = (eng.place(tx.Relation(**x)) for x in rels)
    got = eng.join_arrays_pipelined(r, s, 3)
    assert got.matches == want.matches == 4096 and got.ok == want.ok
    np.testing.assert_array_equal(got.partition_counts,
                                  np.asarray(want.partition_counts))
    assert got.diagnostics == want.diagnostics and got.retries == 0
    assert _counters(m.counters) == _counters(jm.counters)
    assert m.counters["RESULTS"] == 3 * 4096
    assert set(m.times_us) == set(jm.times_us) - {"JCOMPILE"}
    one = tx.HashJoin(eng.config, device="cpu").join_arrays(r, s)
    np.testing.assert_array_equal(one.partition_counts,
                                  got.partition_counts)


def test_repeats_rejections_equal_jax():
    rels = [jx.Relation(1024, seed=1), jx.Relation(1024, seed=2)]
    jeng = jx.HashJoin(jx.JoinConfig(measure_phases=True))
    jr, js = (jeng.place(x) for x in rels)
    eng = tx.HashJoin(tx.JoinConfig(measure_phases=True), device="cpu")
    r, s = (eng.place(tx.Relation(1024, seed=k)) for k in (1, 2))
    for join, a, b in ((jeng.join_arrays, jr, js), (eng.join_arrays, r, s)):
        with pytest.raises(ValueError, match="measure_phases"):
            join(a, b, repeats=2)
        with pytest.raises(ValueError, match="repeats must be >= 1"):
            join(a, b, repeats=0)


def test_repeats_read_back_once(monkeypatch):
    """The k attempts of a pipelined join reach the host once: one
    ``.cpu()`` of the flags and counts, after the last."""
    eng = tx.HashJoin(tx.JoinConfig(probe_algorithm="bucket"), device="cpu")
    r, s = (eng.place(tx.Relation(2048, seed=k)) for k in (1, 2))
    calls = []
    attempt = eng._attempt_on_device

    def counted(*a, **kw):
        out = attempt(*a, **kw)
        calls.append(out.shape)
        return out

    monkeypatch.setattr(eng, "_attempt_on_device", counted)
    reads = []
    real_cpu = torch.Tensor.cpu

    def cpu(self, *a, **kw):
        reads.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    res = eng.join_arrays(r, s, repeats=4)
    assert res.matches == 2048 and len(calls) == 4
    assert reads.count(tuple(calls[-1])) == 1


# ------------------------------------------------------------ fault site
def test_shuffle_overflow_site_is_known():
    assert tfaults.SHUFFLE_OVERFLOW == jfaults.SHUFFLE_OVERFLOW
    assert tfaults.SHUFFLE_OVERFLOW in tfaults.SITES
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tfaults.FaultInjector().arm(tfaults.SHUFFLE_OVERFLOW, at=1)


BACKOFF = dict(retry_backoff_s=0.002, retry_backoff_mult=2.0,
               retry_backoff_max_s=0.01, retry_jitter=0.25)


@pytest.mark.parametrize("fields", [
    {"max_retries": 1}, {"max_retries": 0},
    {"max_retries": 1, "probe_algorithm": "bucket"},
    {"max_retries": 2, "chunk_size": 1000, **BACKOFF},
    {"max_retries": 1, **BACKOFF},
    {"max_retries": 1, "materialize": True},
    {"max_retries": 0, "materialize": True}])
def test_shuffle_overflow_fault_equals_jax(fields, monkeypatch):
    """Armed at the first hit: one retry (or, without retries, an outer
    shortfall reported), the exact count, and JAX's diagnostics
    (``fault_sites`` included), counters and events (``fault``, and
    ``retry`` under a backoff, whose sleeps are recorded in both
    packages alike)."""
    fields = dict(fields)
    materialize = fields.pop("materialize", False)
    slept = []
    monkeypatch.setattr("time.sleep", slept.append)
    rels = [dict(global_size=4096, num_nodes=1, kind="unique", seed=1),
            dict(global_size=4096, num_nodes=1, kind="unique", seed=2)]
    jcfg = jx.JoinConfig(**fields)
    jm = JMeasurements()
    with jfaults.FaultInjector(seed=3).arm(jfaults.SHUFFLE_OVERFLOW, at=1):
        jeng = jx.HashJoin(jcfg, measurements=jm)
        run = jeng.join_materialize if materialize else jeng.join
        want = run(*[jx.Relation(**r) for r in rels])
    m = Measurements()
    with tfaults.FaultInjector(seed=3).arm(tfaults.SHUFFLE_OVERFLOW, at=1):
        eng = tx.HashJoin(config_from_jax(dataclasses.asdict(jcfg)),
                          device="cpu", measurements=m)
        run = eng.join_materialize if materialize else eng.join
        got = run(*[tx.Relation(**r) for r in rels])
    retries = min(1, fields["max_retries"])
    assert got.matches == want.matches == 4096
    assert got.ok == want.ok == bool(retries)
    assert got.diagnostics == want.diagnostics
    assert got.diagnostics["fault_sites"] == {
        "engine.shuffle_overflow": {"hits": 1 + retries, "fired": 1}}
    assert got.retries == retries == jm.counters.get("RETRIES", 0)
    want_counters = _counters(jm.counters)
    if materialize and not retries:
        # retries exhausted: the JAX loop has doubled cap_s once more and
        # records it (ROADMAP C.7); the port records the attempt that ran
        exchanged = ("WINCAPS", "MWINBYTES", "WIREBYTES")
        assert want_counters["WINCAPS"] == 2 * m.counters["WINCAPS"]
        want_counters.update({k: m.counters[k] for k in exchanged})
    assert _counters(m.counters) == want_counters
    assert _events(m.meta) == _events(jm.meta)
    if "retry_backoff_s" in fields:
        assert [e["event"] for e in _events(m.meta)] == ["fault", "retry"]
        assert len(slept) == 2 and slept[0] == slept[1] > 0


# ------------------------------------------------------------ the CLI
def _report(main, argv, capsys):
    assert main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    results = [ln for ln in lines if ln.startswith(("[RESULTS] Tuples",
                                                     "[RESULTS] Expected",
                                                     "[RESULTS] Conserv"))]
    counters = [ln for ln in lines if ln.startswith("[PERF]")
                and ln.endswith("\tcount")
                and ln.split()[1] not in RATES | JAX_ONLY]
    return lines, results, counters


@pytest.mark.parametrize("flags", [
    ["--debug-checks", "--probe", "bucket"],
    ["--generation", "host"],
    ["--generation", "device", "--probe", "bucket"],
    ["--pipeline-repeats", "--repeat", "3"],
    ["--pipeline-repeats", "--repeat", "2", "--probe", "bucket"]])
def test_cli_flags_equal_the_jax_cli(capsys, flags):
    argv = ["--tuples-per-node", "4096", "--outer-kind", "modulo", *flags]
    _, want_results, want_counters = _report(
        jax_main, ["--nodes", "1", *argv], capsys)
    lines, results, counters = _report(tx_main, ["--device", "cpu", *argv],
                                       capsys)
    assert results == want_results and len(results) == 3
    assert "[RESULTS] Expected: 4096 (OK)" in results
    assert counters == want_counters
    res = json.loads(lines[-1])
    assert res["matches"] == 4096 and res["ok"]
    if "--pipeline-repeats" in flags:
        assert res["pipeline_repeats"] and res["counters"]["RTUPLES"] == (
            4096 * int(flags[flags.index("--repeat") + 1]))


def test_cli_pipeline_repeats_refuses_measure_phases(capsys):
    for main in (jax_main, tx_main):
        with pytest.raises(SystemExit):
            main(["--pipeline-repeats", "--measure-phases", "--repeat", "2"])
        assert "--measure-phases" in capsys.readouterr().err
