"""Port parity: the whole single-GPU join (tpu_radix_join_torch.HashJoin)
against ``tpu_radix_join.HashJoin(JoinConfig()).join`` on the JAX CPU
backend — matches, ok, per-partition counts bit for bit, diagnostics — plus
the overflow-guard refine branch and the key contract, with JAX lanes
carried over through ``from_jax_state``."""

import dataclasses

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
    return dict(global_size=size, num_nodes=1, kind=kind, seed=seed, **kw)


def _assert_same(got, want):
    assert got.matches == want.matches
    assert got.ok == want.ok
    assert got.partition_counts.dtype == np.uint32
    np.testing.assert_array_equal(got.partition_counts,
                                  np.asarray(want.partition_counts))
    assert got.diagnostics == {k: want.diagnostics[k] for k in got.diagnostics}
    assert set(got.diagnostics) == set(want.diagnostics)


@pytest.mark.parametrize("size,outer", [
    (1 << 12, ("unique", {})),
    (5000, ("modulo", {"modulo": 1250})),
    (1 << 14, ("zipf", {"zipf_theta": 0.75})),
    (1 << 16, ("unique", {})),
    (1 << 16, ("zipf", {"zipf_theta": 1.1})),
])
def test_join_equals_jax_join(size, outer):
    kind, kw = outer
    if kind == "zipf":
        kw = dict(kw, key_domain=size)
    inner = _spec("unique", size, 1234)
    outer_s = _spec(kind, size, 1235, **kw)
    want = jx.HashJoin(jx.JoinConfig()).join(jx.Relation(**inner),
                                             jx.Relation(**outer_s))
    got = tx.HashJoin(tx.JoinConfig(), device="cpu").join(
        tx.Relation(**inner), tx.Relation(**outer_s))
    _assert_same(got, want)
    assert got.ok and got.matches == tx.Relation(**inner).expected_matches(
        tx.Relation(**outer_s))


def _carried(jcfg, r_key, s_key):
    """Both engines on the same lanes: the JAX one directly, the port's
    through from_jax_state."""
    n_r, n_s = len(r_key), len(s_key)
    r_rid = np.arange(n_r, dtype=np.uint32)
    s_rid = np.arange(n_s, dtype=np.uint32)
    want = jx.HashJoin(jcfg).join_arrays(
        JBatch(jnp.asarray(r_key), jnp.asarray(r_rid)),
        JBatch(jnp.asarray(s_key), jnp.asarray(s_rid)))
    cfg_dict = dataclasses.asdict(jcfg)
    cfg, r = tx.from_jax_state(cfg_dict, r_key, r_rid, device="cpu")
    _, s = tx.from_jax_state(cfg_dict, s_key, s_rid, device="cpu")
    got = tx.HashJoin(cfg, device="cpu").join_arrays(r, s)
    return got, want


def test_refine_branch_runs_and_agrees():
    """maxw (one key with 2**17 inner copies) exceeds (2**32 - 1) // |S|, so
    the guard pays the per-partition histogram; no count can wrap."""
    r_key = np.zeros(1 << 17, np.uint32)
    s_key = tx.Relation(1 << 16, seed=3).generate("cpu").key.numpy().view(
        np.uint32)
    got, want = _carried(jx.JoinConfig(), r_key, s_key)
    _assert_same(got, want)
    assert got.ok and got.matches == 1 << 17


def test_refine_branch_flags_a_count_that_may_wrap():
    r_key = np.full(70000, 9, np.uint32)
    s_key = np.full(1 << 16, 9, np.uint32)
    got, want = _carried(jx.JoinConfig(), r_key, s_key)
    _assert_same(got, want)
    assert not got.ok
    assert got.diagnostics["failure_class"] == "count_overflow_risk"


def test_key_above_max_merge_key_flags_the_contract():
    rng = np.random.default_rng(2)
    r_key = rng.integers(0, 1 << 20, 4096, dtype=np.uint32)
    s_key = rng.integers(0, 1 << 20, 4096, dtype=np.uint32)
    s_key[17] = 0x7FFFFFFE            # MAX_MERGE_KEY + 1
    got, want = _carried(jx.JoinConfig(key_range="narrow"), r_key, s_key)
    _assert_same(got, want)
    assert not got.ok
    assert got.diagnostics["key_contract_violations"] == 1
    assert got.diagnostics["failure_class"] == "key_contract"


def test_raw_arrays_probe_the_key_range():
    """key_range="auto" on raw lanes: the device max-key probe keeps the
    packed path for in-range keys and takes the full-range probe above
    MAX_MERGE_KEY, as the JAX join does."""
    rng = np.random.default_rng(5)
    r_key = rng.integers(0, 1 << 30, 3000, dtype=np.uint32)
    s_key = np.concatenate([r_key[:1000],
                            rng.integers(0, 1 << 30, 2000, dtype=np.uint32)])
    got, want = _carried(jx.JoinConfig(), r_key, s_key)
    _assert_same(got, want)
    s_key[0] = 0x90000000
    r_key[1] = 0x90000000
    got, want = _carried(jx.JoinConfig(), r_key, s_key)
    _assert_same(got, want)
    assert got.ok and got.matches == host_join_count(r_key, s_key)


@pytest.mark.parametrize("field,value,item", [
    ("num_nodes", 4, "A7"), ("exchange_codec", "pack", "A13"),
    ("verify", "check", "A15"), ("skew_threshold", 2.0, "A10"),
    ("chunk_size", 1024, "A7"), ("debug_checks", True, "A7"),
])
def test_settings_outside_the_slice_raise(field, value, item):
    """Every setting that once raised, naming its ROADMAP item, now runs;
    the fanouts past the kernels' bins (A19) are held in
    :func:`test_wide_fanouts_carry_across_and_join_as_jax`.
    A7, the distributed main path, is ported: ``num_nodes`` and
    ``debug_checks`` carry across (a world of 4 then needs its process
    group); so does ``chunk_size`` (A7b), whose chunked probe then joins
    exactly as the JAX engine does; and ``skew_threshold`` (A10), which a
    one-rank join never acts on, so it joins exactly as the JAX engine
    does.  The wire codec (A13) and verification (A15) carry across too:
    a one-rank bucket join under each (a one-rank world ships raw; the
    bucket path verifies its exchange and its second radix pass) joins
    exactly as the JAX engine does."""
    jcfg = jx.JoinConfig()
    d = dataclasses.asdict(jcfg)
    d[field] = value
    if field == "skew_threshold":
        assert config_from_jax(d).skew_threshold == value
        rng = np.random.default_rng(13)
        r_key = rng.integers(0, 5000, 3000, dtype=np.uint32)
        s_key = np.concatenate([np.full(2000, 3, np.uint32), r_key[:500]])
        got, want = _carried(jx.JoinConfig(skew_threshold=value), r_key,
                             s_key)
        _assert_same(got, want)
        assert got.ok and got.matches == host_join_count(r_key, s_key)
        return
    if field in ("exchange_codec", "verify"):
        assert getattr(config_from_jax(d), field) == value
        rng = np.random.default_rng(17)
        r_key = rng.integers(0, 5000, 3000, dtype=np.uint32)
        s_key = rng.integers(0, 5000, 2500, dtype=np.uint32)
        got, want = _carried(jx.JoinConfig(probe_algorithm="bucket",
                                           **{field: value}), r_key, s_key)
        _assert_same(got, want)
        assert got.ok and got.matches == host_join_count(r_key, s_key)
        return
    if field in ("num_nodes", "debug_checks", "chunk_size"):
        cfg = config_from_jax(d)
        assert getattr(cfg, field) == value
        if field == "num_nodes":
            with pytest.raises(ValueError, match="initialize"):
                tx.HashJoin(cfg, device="cpu")
        if field == "chunk_size":
            rng = np.random.default_rng(9)
            r_key = rng.integers(0, 5000, 3000, dtype=np.uint32)
            s_key = rng.integers(0, 5000, 2500, dtype=np.uint32)
            got, want = _carried(jx.JoinConfig(chunk_size=value), r_key,
                                 s_key)
            _assert_same(got, want)
            assert got.ok and got.matches == host_join_count(r_key, s_key)
        return
    raise AssertionError(f"no case for {field}")


@pytest.mark.parametrize("field,value", [("network_fanout_bits", 8),
                                         ("local_fanout_bits", 9)])
def test_wide_fanouts_carry_across_and_join_as_jax(field, value):
    """The fanouts past the kernels' shared bins (A19) carry across from
    the JAX config and join exactly as the JAX engine does: the sort probe
    at network fanout 8 (256 partition counts), the bucket join at local
    fanout 9 (512 bucket counts)."""
    extra = {} if field == "network_fanout_bits" else {
        "probe_algorithm": "bucket"}
    jcfg = jx.JoinConfig(**{field: value}, **extra)
    assert getattr(config_from_jax(dataclasses.asdict(jcfg)), field) == value
    rng = np.random.default_rng(value)
    r_key = rng.integers(0, 1 << 16, 4096, dtype=np.uint32)
    s_key = np.concatenate([r_key[:1500],
                            rng.integers(0, 1 << 16, 2500, dtype=np.uint32)])
    got, want = _carried(jcfg, r_key, s_key)
    _assert_same(got, want)
    assert got.partition_counts.size == 1 << value
    if got.ok:
        assert got.matches == host_join_count(r_key, s_key)


@pytest.mark.parametrize("field,value", [("key_bits", 64),
                                         ("key_range", "full"),
                                         ("fallback", "chunked")])
def test_settings_of_the_slice_carry_across(field, value):
    """64-bit keys, the full key range and the chunked fallback are
    ported: the JAX config carries across unchanged, with the same
    sort-probe discipline."""
    jcfg = jx.JoinConfig(**{field: value})
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert cfg == tx.JoinConfig(**{field: value})
    assert getattr(cfg, field) == value and cfg.sort_probe == jcfg.sort_probe


def test_default_configs_agree():
    cfg = config_from_jax(dataclasses.asdict(jx.JoinConfig()))
    assert cfg == tx.JoinConfig()
    assert cfg.network_partition_count == jx.JoinConfig().network_partition_count
    with pytest.raises(ValueError):
        config_from_jax({"no_such_field": 1})


def test_exchange_stages_is_refused_not_dropped():
    """C9, then A13: a staged JAX config reports its stages
    (``_exchange_stats``, XSTAGES and the exchange plan read k).  The port
    first refused it rather than join fused and report 1; now it carries
    across and the staged join reports what JAX's does.  A negative stage
    count is refused; the fused exchange (``exchange_stages=1``) carries
    across."""
    from tpu_radix_join.performance.measurements import Measurements
    from tpu_radix_join_torch.performance import Measurements as TMeas
    for stages, want_k in ((4, 4), (0, 4)):   # "auto": 4096-slot blocks
        jm, tm = Measurements(), TMeas()
        jcfg = jx.JoinConfig(exchange_stages=stages, probe_algorithm="bucket")
        want = jx.HashJoin(jcfg, measurements=jm).join(
            jx.Relation(4096, seed=1), jx.Relation(4096, seed=2))
        assert want.ok and want.matches == 4096
        assert jm.counters["XSTAGES"] == want_k
        assert jm.meta["exchange_plan"]["stages"] == want_k
        cfg = config_from_jax(dataclasses.asdict(jcfg))
        assert cfg.exchange_stages == stages
        got = tx.HashJoin(cfg, device="cpu", measurements=tm).join(
            tx.Relation(4096, seed=1), tx.Relation(4096, seed=2))
        assert got.ok and got.matches == want.matches
        assert tm.counters["XSTAGES"] == want_k
        assert tm.meta["exchange_plan"] == jm.meta["exchange_plan"]
    with pytest.raises(ValueError, match="exchange_stages"):
        tx.JoinConfig(exchange_stages=-1)
    cfg = config_from_jax(
        dataclasses.asdict(jx.JoinConfig(exchange_stages=1)))
    assert cfg.exchange_stages == 1 and cfg == tx.JoinConfig()


def test_fields_the_port_does_not_read_are_pinned():
    """Every JAX config field is the port's or one of the three the port's
    joins never read; no other field is dropped without a word
    (``grid_pipeline`` came off with the repair, A15, and the
    implementation choices ``sort_impl`` / ``partition_impl`` with A21:
    they carry across as they are)."""
    from tpu_radix_join_torch import state
    assert state._UNREAD == {"payload_bits", "mesh_axis",
                             "result_aggregation_node"}
    assert not hasattr(state, "_ONE_IMPL")
    jax_fields = set(jx.JoinConfig.__dataclass_fields__)
    own = set(tx.JoinConfig.__dataclass_fields__)
    assert jax_fields == own | state._UNREAD
    assert not own & state._UNREAD
    for field, value in (("sort_impl", "xla"), ("sort_impl", "pallas"),
                         ("partition_impl", "sort"),
                         ("partition_impl", "pallas_interpret")):
        d = dataclasses.asdict(jx.JoinConfig(**{field: value}))
        assert getattr(config_from_jax(d), field) == value
    for field, value in (("match_rate_cap", 3), ("generation", "host"),
                         ("exchange_stages", 1), ("grid_pipeline", "on")):
        d = dataclasses.asdict(jx.JoinConfig(**{field: value}))
        assert getattr(config_from_jax(d), field) == value
    with pytest.raises(ValueError, match="match_rate_cap"):
        tx.JoinConfig(match_rate_cap=0)
