"""Wider fanout (ROADMAP A19) and the implementation choice (A21) in whole
joins, against the JAX package's ``HashJoin`` on its CPU backend (its XLA
and sort arms, which its ``auto`` takes there):

  * one-rank joins: the sort probe at network fanout 8, 10 and 12, narrow
    and ``key_range="full"``; 64-bit keys at 10; the bucket join at local
    fanout 9 and 10, including the ``local_overflow`` outcome of 2**13
    tuples with the default retries and the same join with
    ``max_retries=4``; the two-level join at 8 + 10.  Matches, ``ok``,
    per-partition counts, the flags, ``failure_class`` and retries equal;
  * four gloo ranks (tests/torch_dist_worker.py) against JAX's 4-device
    virtual mesh: the raw exchange at network fanout 8, the packed one at
    7 (4 x 128 = 512 groups) and at 8, counts, flags and the exchange plan;
  * A21: the configuration and the command line accept and reject what
    JAX's do, ``config_from_jax`` carries a non-``auto`` choice, a join
    under ``sort_impl="xla"`` and ``partition_impl="sort"`` equals JAX's
    under the same choice, the baseline counters tick, no kernel wrapper
    runs, and the result names the arms.

Tolerance 0 everywhere."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_radix_join as jx  # noqa: E402
from tpu_radix_join import main as jmain  # noqa: E402

import tpu_radix_join_torch as tx  # noqa: E402
from tpu_radix_join_torch import main as tmain  # noqa: E402
from tpu_radix_join_torch.ops import kernels  # noqa: E402
from tpu_radix_join_torch.state import config_from_jax  # noqa: E402
from torch_dist_worker import WorkerPool  # noqa: E402

N = 4


def _spec(kind, size, seed, nodes=1, **kw):
    if kind == "zipf":
        kw = dict(kw, key_domain=size)
    return dict(global_size=size, num_nodes=nodes, kind=kind, seed=seed, **kw)


def _assert_same(got, want, want_retries, clipped=False):
    """Equal results.  ``clipped``: the join ended short of bucket
    capacity, and which tuples a full bucket keeps is the partition arm's
    order: K4 keeps input order (as JAX's Pallas kernel does), JAX's CPU
    sort arm the order of its unstable sort, so the surviving matches
    differ and only the outcome and the flags are held."""
    assert got.ok == want.ok
    assert got.retries == want_retries
    if not clipped:
        assert got.matches == want.matches
        np.testing.assert_array_equal(got.partition_counts,
                                      np.asarray(want.partition_counts))
    diag = {k: v for k, v in got.diagnostics.items()
            if k != "baseline_arms"}
    assert diag == dict(want.diagnostics)


def _both(cfg_kw, inner, outer, clipped=False):
    """The port's join and JAX's of the same config and relations, held
    equal (JAX's retries from its registry: its result has none)."""
    from tpu_radix_join.performance.measurements import Measurements
    jcfg = jx.JoinConfig(**cfg_kw)
    jm = Measurements()
    want = jx.HashJoin(jcfg, measurements=jm).join(jx.Relation(**inner),
                                                   jx.Relation(**outer))
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert cfg == tx.JoinConfig(**cfg_kw)
    got = tx.HashJoin(cfg, device="cpu").join(tx.Relation(**inner),
                                              tx.Relation(**outer))
    _assert_same(got, want, jm.counters.get("RETRIES", 0), clipped)
    return got


ONE_RANK = {   # id -> (config, inner, outer)
    "sort_f8": (dict(network_fanout_bits=8), _spec("unique", 1 << 13, 1),
                _spec("zipf", 1 << 13, 2, zipf_theta=0.75)),
    "sort_f10": (dict(network_fanout_bits=10), _spec("unique", 1 << 14, 1),
                 _spec("unique", 1 << 14, 2)),
    "sort_f12": (dict(network_fanout_bits=12), _spec("unique", 1 << 13, 3),
                 _spec("modulo", 1 << 13, 4, modulo=1000)),
    "full_f8": (dict(network_fanout_bits=8, key_range="full"),
                _spec("unique", 1 << 13, 1), _spec("unique", 1 << 13, 2)),
    "full_f12": (dict(network_fanout_bits=12, key_range="full"),
                 _spec("unique", 1 << 13, 5),
                 _spec("zipf", 1 << 13, 6, zipf_theta=0.75)),
    "wide64_f10": (dict(network_fanout_bits=10, key_bits=64),
                   _spec("unique", 1 << 13, 1, key_bits=64),
                   _spec("modulo", 1 << 13, 2, modulo=3000, key_bits=64)),
    "bucket_lf9": (dict(probe_algorithm="bucket", local_fanout_bits=9,
                        max_retries=4),
                   _spec("unique", 1 << 14, 1), _spec("unique", 1 << 14, 2)),
    "bucket_lf10_overflow": (dict(probe_algorithm="bucket",
                                  local_fanout_bits=10),
                             _spec("unique", 1 << 13, 1),
                             _spec("unique", 1 << 13, 2)),
    "bucket_lf10_retries": (dict(probe_algorithm="bucket",
                                 local_fanout_bits=10, max_retries=4),
                            _spec("unique", 1 << 13, 1),
                            _spec("unique", 1 << 13, 2)),
    "two_level_8_10": (dict(two_level=True, network_fanout_bits=8,
                            local_fanout_bits=10, max_retries=4),
                       _spec("unique", 1 << 14, 1),
                       _spec("unique", 1 << 14, 2)),
}


@pytest.mark.parametrize("case", list(ONE_RANK))
def test_wide_fanout_join_equals_jax(case):
    cfg_kw, inner, outer = ONE_RANK[case]
    got = _both(cfg_kw, inner, outer, clipped=case == "bucket_lf10_overflow")
    bits = (cfg_kw.get("local_fanout_bits") if "local_fanout_bits" in cfg_kw
            else cfg_kw["network_fanout_bits"])
    assert got.partition_counts.size == 1 << bits
    oracle = tx.Relation(**inner).expected_matches(tx.Relation(**outer))
    if case == "bucket_lf10_overflow":
        # 2**13 tuples into 1024 buckets of 8 + slack: JAX's outcome too
        assert not got.ok and got.diagnostics["local_overflow"] > 0
        assert got.diagnostics["failure_class"] == "capacity_overflow"
        # the same clip on the library arm: its stable argsort keeps the
        # tuples K4 keeps
        base = tx.HashJoin(tx.JoinConfig(**cfg_kw, partition_impl="sort"),
                           device="cpu").join(tx.Relation(**inner),
                                              tx.Relation(**outer))
        assert base.matches == got.matches
        np.testing.assert_array_equal(base.partition_counts,
                                      got.partition_counts)
    else:
        assert got.ok and got.matches == oracle
    if case == "bucket_lf10_retries":
        assert got.retries > 0


# ------------------------------------------------------------ 4 ranks
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pool = WorkerPool(N, tmp_path_factory.mktemp("gloo_wide_world"))
    yield pool
    pool.close()


FOUR_RANKS = {   # id -> config
    "raw_f8": dict(network_fanout_bits=8),
    "pack_f7": dict(network_fanout_bits=7, exchange_codec="pack"),
    "pack_f8": dict(network_fanout_bits=8, exchange_codec="pack",
                    max_retries=2),
}


@pytest.mark.parametrize("case", list(FOUR_RANKS))
def test_wide_fanout_exchange_over_four_ranks_equals_jax(world, case):
    """Counts, flags and the wire plan equal JAX's ``HashJoin(num_nodes=4)``
    on the virtual mesh; the packed exchange's grouped scatter takes 4 x
    2**f groups (512 and 1024: K4's wide path on the card)."""
    from tpu_radix_join.performance.measurements import Measurements
    inner = _spec("unique", 1 << 13, 1, nodes=N)
    outer = _spec("zipf", 1 << 13, 2, nodes=N, zipf_theta=0.75)
    jcfg = jx.JoinConfig(num_nodes=N, **FOUR_RANKS[case])
    jm = Measurements()
    want = jx.HashJoin(jcfg, measurements=jm).join(jx.Relation(**inner),
                                                   jx.Relation(**outer))
    assert want.ok, want.diagnostics
    cfg = dataclasses.asdict(config_from_jax(dataclasses.asdict(jcfg)))
    got = world.run({"kind": "join", "config": cfg, "inner": inner,
                     "outer": outer, "measure": True})
    for res in got:
        assert res["ok"] and res["matches"] == want.matches
        np.testing.assert_array_equal(
            np.asarray(res["partition_counts"], np.uint32),
            np.asarray(want.partition_counts))
        assert res["diagnostics"] == want.diagnostics
        assert res["exchange_plan"] == jm.meta["exchange_plan"]
    plan = got[0]["exchange_plan"]
    packs = FOUR_RANKS[case].get("exchange_codec") == "pack"
    assert (plan["codec_r"] == plan["codec_s"] == "pack") == packs


# ----------------------------------------------------------------- A21
IMPLS = [("sort_impl", v) for v in ("auto", "xla", "pallas",
                                     "pallas_interpret")] + \
    [("partition_impl", v) for v in ("auto", "sort", "pallas",
                                     "pallas_interpret")]


@pytest.mark.parametrize("field,value", IMPLS)
def test_impl_choices_carry_across_and_the_cli_takes_them(field, value):
    jcfg = jx.JoinConfig(**{field: value})
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert getattr(cfg, field) == value and cfg == tx.JoinConfig(
        **{field: value})
    flag = "--" + field.replace("_", "-")
    got = tmain.build_parser().parse_args([flag, value])
    want = jmain.build_parser().parse_args([flag, value])
    assert getattr(got, field) == getattr(want, field) == value
    assert tmain._join_config(got) == tx.JoinConfig(**{field: value})


@pytest.mark.parametrize("field,value", [
    ("sort_impl", "sort"), ("sort_impl", "loop"), ("partition_impl", "xla"),
    ("partition_impl", "gather"), ("sort_impl", "")])
def test_impl_choices_reject_as_jax(field, value):
    with pytest.raises(ValueError) as want:
        jx.JoinConfig(**{field: value})
    with pytest.raises(ValueError) as got:
        tx.JoinConfig(**{field: value})
    assert str(got.value) == str(want.value)
    flag = "--" + field.replace("_", "-")
    for parser in (tmain.build_parser(), jmain.build_parser()):
        with pytest.raises(SystemExit):
            parser.parse_args([flag, value])


BASELINE = {   # id -> (config, inner, outer, baseline counters that tick)
    "sort_probe": (dict(sort_impl="xla", partition_impl="sort"),
                   _spec("unique", 1 << 13, 1),
                   _spec("zipf", 1 << 13, 2, zipf_theta=0.75),
                   ("baseline_sort",)),
    "bucket": (dict(probe_algorithm="bucket", sort_impl="xla",
                    partition_impl="sort"),
               _spec("unique", 1 << 13, 1), _spec("unique", 1 << 13, 2),
               ("baseline_sort", "baseline_partition",
                "baseline_histogram")),
    "bucket_sort_only": (dict(probe_algorithm="bucket", sort_impl="xla"),
                         _spec("unique", 1 << 13, 1),
                         _spec("unique", 1 << 13, 2), ("baseline_sort",)),
    "sort_probe_f10_sort_only": (dict(network_fanout_bits=10,
                                      sort_impl="xla"),
                                 _spec("unique", 1 << 13, 5),
                                 _spec("unique", 1 << 13, 6),
                                 ("baseline_sort",)),
    "two_level_partition_only": (dict(two_level=True, partition_impl="sort",
                                      max_retries=4),
                                 _spec("unique", 1 << 13, 3),
                                 _spec("modulo", 1 << 13, 4, modulo=2000),
                                 ("baseline_partition",
                                  "baseline_histogram")),
}


@pytest.mark.parametrize("case", list(BASELINE))
def test_baseline_arms_join_as_jax_counted_and_named(case, monkeypatch):
    """A join under the library arms equals JAX's under the same choice;
    each arm asked for ticks its counter, the other arm's kernels keep
    running, and ``diagnostics["baseline_arms"]`` names what was asked."""
    from tpu_radix_join_torch.ops import radix as tradix
    from tpu_radix_join_torch.ops import sorting as tsorting
    cfg_kw, inner, outer, ticks = BASELINE[case]
    calls = {"radix_sort": 0, "partition_scatter": 0}

    def spy(mod, name):
        real = getattr(mod, name)

        def counted(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)

    spy(tsorting, "radix_sort")
    spy(tradix, "partition_scatter")
    kernels.reset_launches()
    got = _both(cfg_kw, inner, outer)
    counts = kernels.launch_counts()
    for k in ("baseline_sort", "baseline_partition", "baseline_histogram"):
        assert (counts[k] > 0) == (k in ticks), (k, counts)
    asked = {k: v for k, v in cfg_kw.items() if k.endswith("_impl")}
    assert got.diagnostics["baseline_arms"] == asked
    if "sort_impl" in asked:
        assert calls["radix_sort"] == 0
    if "partition_impl" in asked:
        assert calls["partition_scatter"] == 0
    oracle = tx.Relation(**inner).expected_matches(tx.Relation(**outer))
    assert got.ok and got.matches == oracle


def test_kernel_runs_name_no_arm_and_tick_no_baseline():
    for impl in ("auto", "pallas", "pallas_interpret"):
        kernels.reset_launches()
        res = tx.HashJoin(tx.JoinConfig(sort_impl=impl, partition_impl=impl,
                                        probe_algorithm="bucket"),
                          device="cpu").join(tx.Relation(4096, seed=1),
                                             tx.Relation(4096, seed=2))
        assert res.ok and "baseline_arms" not in res.diagnostics
        assert not any(v for k, v in kernels.launch_counts().items()
                       if k.startswith("baseline"))


def test_sort_impl_is_the_engines_not_the_processes():
    """Two engines with different choices in one process: each join runs
    its own arm (the JAX package binds a process default instead)."""
    rels = (tx.Relation(4096, seed=1), tx.Relation(4096, seed=2))
    xla = tx.HashJoin(tx.JoinConfig(sort_impl="xla"), device="cpu")
    auto = tx.HashJoin(tx.JoinConfig(), device="cpu")
    for eng, ticks in ((xla, True), (auto, False), (xla, True)):
        kernels.reset_launches()
        assert eng.join(*rels).ok
        assert (kernels.launch_counts()["baseline_sort"] > 0) == ticks


def test_cli_runs_a_wide_fanout_join_on_the_baseline_arms(capsys):
    rc = tmain.main(["--device", "cpu", "--tuples-per-node", "4096",
                     "--network-fanout", "10", "--sort-impl", "xla",
                     "--partition-impl", "sort"])
    assert rc == 0
    out = capsys.readouterr().out
    assert '"ok": true' in out and '"matches": 4096' in out
