"""Port parity: the one-GPU partitioned join (``probe_algorithm="bucket"``
and ``two_level=True``) of ``tpu_radix_join_torch.HashJoin`` against the
JAX ``HashJoin`` with the same config on the JAX CPU backend: per-bucket
counts, the 7 flags, matches and failure class equal exactly, and matches
equal the oracle wherever the join succeeds — retries included.

The JAX join on the CPU routes its partition pass to the sort path (Pallas
is unavailable there), so block contents differ in order from K4's; the
counts and flags, which do not depend on that order, are what is held."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import tpu_radix_join as jx  # noqa: E402
from tpu_radix_join.data.relation import host_join_count  # noqa: E402
from tpu_radix_join.data.tuples import TupleBatch as JBatch  # noqa: E402

import tpu_radix_join_torch as tx  # noqa: E402
from tpu_radix_join_torch.state import config_from_jax  # noqa: E402


def _spec(kind, size, seed, **kw):
    if kind == "zipf":
        kw = dict(kw, key_domain=size)
    return dict(global_size=size, num_nodes=1, kind=kind, seed=seed, **kw)


def _assert_same(got, want):
    assert got.matches == want.matches
    assert got.ok == want.ok
    assert got.partition_counts.dtype == np.uint32
    np.testing.assert_array_equal(got.partition_counts,
                                  np.asarray(want.partition_counts))
    assert set(got.diagnostics) <= set(want.diagnostics)
    assert got.diagnostics == {k: want.diagnostics[k] for k in got.diagnostics}


def _relations(size, outer):
    kind, kw = outer
    return _spec("unique", size, 1234), _spec(kind, size, 1235, **kw)


def _both(cfg_kw, size, outer):
    inner, outer_s = _relations(size, outer)
    want = jx.HashJoin(jx.JoinConfig(**cfg_kw)).join(jx.Relation(**inner),
                                                     jx.Relation(**outer_s))
    got = tx.HashJoin(tx.JoinConfig(**cfg_kw), device="cpu").join(
        tx.Relation(**inner), tx.Relation(**outer_s))
    _assert_same(got, want)
    oracle = tx.Relation(**inner).expected_matches(tx.Relation(**outer_s))
    return got, oracle


UNIQUE = ("unique", {})
ZIPF = ("zipf", {"zipf_theta": 0.75})


@pytest.mark.parametrize("cfg,size,outer", [
    (dict(probe_algorithm="bucket"), 1 << 13, UNIQUE),
    (dict(probe_algorithm="bucket"), 1 << 12, ("modulo", {"modulo": 1024})),
    # Zipf(1.75) puts ~95% of S in one local bucket: five doublings
    (dict(probe_algorithm="bucket", max_retries=5), 1 << 12, ZIPF),
    (dict(two_level=True), 1 << 14, UNIQUE),
    (dict(two_level=True, max_retries=5), 1 << 13, ZIPF),
    (dict(probe_algorithm="bucket", local_fanout_bits=6,
          allocation_factor=2.0), 1 << 13, UNIQUE),
    # 256 buckets: the invalid bucket id is 256, one past the last group
    (dict(two_level=True, network_fanout_bits=3, local_fanout_bits=8),
     1 << 12, ("modulo", {"modulo": 3000})),
    (dict(probe_algorithm="bucket", assignment_policy="load_aware"),
     1 << 12, UNIQUE),
])
def test_partitioned_join_equals_jax(cfg, size, outer):
    got, oracle = _both(cfg, size, outer)
    assert got.ok and got.matches == oracle
    assert got.partition_counts.shape == (
        tx.JoinConfig(**cfg).local_partition_count,)


@pytest.mark.parametrize("max_retries,ok,retries", [
    (0, False, 0), (2, False, 2), (5, True, 5)])
def test_static_sizing_retries_only_what_fell_short(max_retries, ok,
                                                    retries):
    """allocation_factor=1.0 sizes every block at its expected share; the
    Zipf head overflows its bucket, and each retry doubles only the local
    slack until the bucket holds it."""
    cfg = dict(probe_algorithm="bucket", window_sizing="static",
               allocation_factor=1.0, max_retries=max_retries)
    got, oracle = _both(cfg, 1 << 12, ZIPF)
    assert got.ok == ok and got.retries == retries
    d = got.diagnostics
    if ok:
        assert got.matches == oracle and d["failure_class"] == "ok"
    else:
        assert d["failure_class"] == "capacity_overflow"
        assert d["local_overflow"] > 0 and got.matches < oracle
        assert d["shuffle_overflow_r_tuples"] == 0
        assert d["shuffle_overflow_s_tuples"] == 0


@pytest.mark.parametrize("window_sizing", ["measured", "static"])
def test_histograms_and_assignment_run_once_a_join(window_sizing,
                                                   monkeypatch):
    """The sizing pass and every retry share one pair of histograms and
    one assignment: they depend on the relations alone."""
    from tpu_radix_join_torch.operators import hash_join as thj
    calls = {"hist": 0, "assign": 0}

    def counted(fn, key):
        def wrapper(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(thj, "compute_local_histogram",
                        counted(thj.compute_local_histogram, "hist"))
    monkeypatch.setattr(thj, "compute_partition_assignment",
                        counted(thj.compute_partition_assignment, "assign"))
    cfg = dict(probe_algorithm="bucket", window_sizing=window_sizing,
               allocation_factor=1.0, max_retries=5,
               assignment_policy="load_aware")
    got, oracle = _both(cfg, 1 << 12, ZIPF)
    assert got.ok and got.matches == oracle and got.retries > 0
    assert calls == {"hist": 2, "assign": 1}


def _carried(jcfg, r_key, s_key):
    """Both engines on the same raw lanes: the JAX one directly, the port's
    through from_jax_state."""
    r_rid = np.arange(len(r_key), dtype=np.uint32)
    s_rid = np.arange(len(s_key), dtype=np.uint32)
    want = jx.HashJoin(jcfg).join_arrays(
        JBatch(jnp.asarray(r_key), jnp.asarray(r_rid)),
        JBatch(jnp.asarray(s_key), jnp.asarray(s_rid)))
    cfg_dict = dataclasses.asdict(jcfg)
    cfg, r = tx.from_jax_state(cfg_dict, r_key, r_rid, device="cpu")
    _, s = tx.from_jax_state(cfg_dict, s_key, s_rid, device="cpu")
    got = tx.HashJoin(cfg, device="cpu").join_arrays(r, s)
    _assert_same(got, want)
    return got


@pytest.mark.parametrize("two_level", [False, True])
def test_full_range_keys_join_exactly(two_level):
    """Keys in [2**31, 2**31 + n): above the sort probe's 31-bit packing,
    legal on the partitioned path, which needs no key-range probe."""
    n = 1 << 12
    rng = np.random.default_rng(17)
    base = np.uint32(1 << 31)
    r_key = (base + rng.permutation(n).astype(np.uint32)).astype(np.uint32)
    s_key = (base + (np.arange(n) % 1000).astype(np.uint32)).astype(
        np.uint32)
    cfg = jx.JoinConfig(probe_algorithm="sort" if two_level else "bucket",
                        two_level=two_level)
    got = _carried(cfg, r_key, s_key)
    assert got.ok and got.matches == host_join_count(r_key, s_key) == n


def test_pad_keys_flag_the_contract():
    n = 1 << 12
    rng = np.random.default_rng(19)
    r_key = rng.integers(0, 1 << 20, n).astype(np.uint32)
    s_key = rng.integers(0, 1 << 20, n).astype(np.uint32)
    r_key[5] = 0xFFFFFFFE                  # the inner pad
    s_key[9] = 0xFFFFFFFE                  # below the outer pad, on R's pad
    got = _carried(jx.JoinConfig(probe_algorithm="bucket"), r_key, s_key)
    assert not got.ok
    assert got.diagnostics["key_contract_violations"] == 1
    assert got.diagnostics["failure_class"] == "key_contract"


def test_partitioned_config_agrees_with_jax():
    kw = dict(probe_algorithm="bucket", two_level=True, local_fanout_bits=7,
              network_fanout_bits=4, window_sizing="static",
              allocation_factor=2.5, assignment_policy="load_aware",
              max_retries=3, key_range="full")
    jcfg = jx.JoinConfig(**kw)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert cfg == tx.JoinConfig(**kw)
    for c, j in ((cfg, jcfg), (tx.JoinConfig(), jx.JoinConfig())):
        for prop in ("sort_probe", "bucket_path", "local_partition_count",
                     "network_partition_count"):
            assert getattr(c, prop) == getattr(j, prop), prop
        for size in (1, 8, 4096, 20_000_000, 1 << 25):
            assert c.shuffle_block_capacity(size) == \
                j.shuffle_block_capacity(size)
            for nb in (1, 32, 256):
                assert c.bucket_capacity(size, nb) == \
                    j.bucket_capacity(size, nb)
    assert tx.JoinConfig().bucket_capacity(1 << 25, 32) == 1_572_864


@pytest.mark.parametrize("field,value,match", [
    ("window_sizing", "exact", "window sizing"),
    ("allocation_factor", 0.5, "allocation_factor"),
    ("assignment_policy", "hash", "assignment policy"),
    ("max_retries", -1, "max_retries"),
])
def test_partitioned_settings_out_of_range_raise(field, value, match):
    with pytest.raises((ValueError, NotImplementedError), match=match):
        tx.JoinConfig(probe_algorithm="bucket", **{field: value})


def test_local_fanout_past_k4s_groups_joins_as_jax():
    """Local fanout 9 (512 buckets, past K4's 256 onesweep groups: its wide
    path) carries across from the JAX config and joins as the JAX engine
    does, bucket counts and flags included."""
    cfg = config_from_jax(dataclasses.asdict(jx.JoinConfig(
        probe_algorithm="bucket", local_fanout_bits=9, max_retries=3)))
    assert cfg.local_fanout_bits == 9
    got, oracle = _both(dict(probe_algorithm="bucket", local_fanout_bits=9,
                             max_retries=3), 1 << 13, ("unique", {}))
    assert got.partition_counts.size == 512
    assert got.ok and got.matches == oracle


@pytest.mark.parametrize("argv,retries", [
    (["--probe", "bucket", "--outer-kind", "modulo"], 0),
    (["--two-level", "--outer-kind", "zipf", "--max-retries", "5",
      "--window-sizing", "static", "--local-fanout", "4"], None),
])
def test_main_cli_runs_the_partitioned_join_on_the_cpu(argv, retries,
                                                       capsys):
    from tpu_radix_join_torch import main as tmain
    rc = tmain.main(argv + ["--device", "cpu", "--tuples-per-node", "4096"])
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0 and got["ok"] and got["matches"] == got["expected"] == 4096
    assert got["pipeline"] == "partitioned" and got["device"] == "cpu"
    if retries is not None:
        assert got["retries"] == retries
