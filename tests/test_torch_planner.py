"""The planner of the port (ROADMAP A17: ``planner/profile.py``,
``cost_model.py``, ``plan.py``, ``audit.py``) against the JAX package's on
the same inputs: JAX's ``tests/test_planner.py`` cases, each run through
both packages.

Cost tables (``StrategyCost`` dicts, rounded as JAX rounds them), plans and
``explain_table`` text are held equal on synthetic profiles written from a
numpy seed, whose workloads make every strategy row win at least once.
The JAX cost model mirrors JAX's engine where the port's mirrors its own:
JAX's CPU probes call the Pallas arms unavailable and its sorts under
2**18 elements take ``lax.sort``, while the port runs K2 and K4 wherever
its ``auto`` runs.  So the parity tests give JAX the port's answer
(``port_rules``: both probes true, the floor 0).  ``explain_table``'s
``sort:`` line names the port's arms (K2, ``torch.sort``) where JAX names
its own; the comparison maps the one onto the other and nothing else.

Not ported: the plan-cache and warm-start cases (ported in
``test_torch_service.py``), ``test_print_results_surfaces_failure_classes``
(``test_torch_measurements.py``), ``test_emit_profile_distills_artifacts``
(``tools_make_report.py`` distils TPU artifacts) and
``test_bench_backend_unavailable_json`` (``bench.py``; ROADMAP A8b).
"""

import collections
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_radix_join.planner as jp  # noqa: E402
from tpu_radix_join.planner import cost_model as jcm  # noqa: E402
from tpu_radix_join.planner import profile as jprofile  # noqa: E402

import tpu_radix_join_torch.planner as tp  # noqa: E402
from tpu_radix_join_torch.planner import audit as taudit  # noqa: E402
from tpu_radix_join_torch.planner import cost_model as tcm  # noqa: E402
from tpu_radix_join_torch.planner import profile as tprofile  # noqa: E402
from tpu_radix_join_torch.planner.profile import (  # noqa: E402
    REQUIRED_CONSTANTS, _profiles_dir)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V5E = os.path.join(ROOT, "tpu_radix_join", "planner", "profiles",
                   "v5e_lite.json")
H100 = os.path.join(_profiles_dir(), "h100.json")
STRATEGIES = ("incore_fused_sort_narrow", "incore_split_sort_narrow",
              "incore_fused_sort_full", "incore_split_sort_full",
              "incore_fused_twolevel", "chunked_grid",
              "chunked_grid_pipelined")

#: log-uniform ranges of the synthetic constants
RANGES = {"sort_stage_unit_ms": (0.005, 0.5),
          "full_range_sort_factor": (1.0, 2.5),
          "dispatch_floor_ms": (0.005, 200.0),
          "hbm_gbps": (50.0, 4000.0), "hbm_bytes": (2 ** 30, 2 ** 37),
          "scatter_loop_melems_s": (100.0, 20000.0),
          "gather_melems_s": (100.0, 100000.0),
          "ici_gbps": (5.0, 500.0), "ici_bytes_per_s": (5e9, 5e11),
          "partition_pass_unit_ms": (0.001, 0.5),
          "radix_sort_pass_unit_ms": (0.001, 0.5),
          "result_cache_lookup_ms": (0.01, 1.0)}
SEED, NPROFILES = 20, 16

WORKLOADS = [
    dict(r_tuples=1 << 16, s_tuples=1 << 16, key_bound=1 << 16),
    dict(r_tuples=20_000_000, s_tuples=20_000_000, key_bound=20_000_000),
    dict(r_tuples=1 << 24, s_tuples=1 << 24, key_bound=1 << 31),
    dict(r_tuples=1 << 24, s_tuples=1 << 24),
    dict(r_tuples=1 << 22, s_tuples=1 << 22, key_bits=64),
    dict(r_tuples=1 << 26, s_tuples=1 << 26, key_bound=1 << 26,
         memory_budget_bytes=1 << 32),
    dict(r_tuples=1 << 16, s_tuples=1 << 16, key_bound=1 << 16,
         memory_budget_bytes=1 << 20),
    dict(r_tuples=1 << 22, s_tuples=1 << 22, key_bound=1 << 22,
         num_nodes=8, repeats=3),
    dict(r_tuples=1 << 20, s_tuples=1 << 20, key_bound=1 << 20, num_nodes=4),
    dict(r_tuples=1 << 28, s_tuples=1 << 28, key_bound=1 << 28),
]


def _port_rules(monkeypatch):
    import tpu_radix_join.ops.pallas.partition as jpart
    import tpu_radix_join.ops.sorting as jsort
    monkeypatch.setattr(jpart, "pallas_partition_available", lambda: True)
    monkeypatch.setattr(jsort, "pallas_sort_available", lambda: True)
    monkeypatch.setattr(jsort, "PALLAS_SORT_MIN_ELEMS", 0)


@pytest.fixture
def port_rules(monkeypatch):
    """The JAX cost model under the port's availability rules (JAX's own
    engine cannot run under them on the CPU)."""
    _port_rules(monkeypatch)


def synthetic_profile(path, i):
    """Profile ``i`` of the seeded set; every fourth one has a negative
    dispatch floor, the only way the phase split's extra program can make
    its row the cheapest (a tie goes to the fused row)."""
    rng = np.random.default_rng([SEED, i])
    constants = {}
    for k in REQUIRED_CONSTANTS:
        lo, hi = RANGES[k]
        constants[k] = {
            "value": float(np.exp(rng.uniform(np.log(lo), np.log(hi)))),
            "source": f"synthetic:seed {SEED} profile {i}"}
    if i % 4 == 3:
        constants["dispatch_floor_ms"]["value"] *= -1
    with open(path, "w") as f:
        json.dump({"schema_version": 6, "name": f"synthetic{i}",
                   "constants": constants}, f)
    return str(path)


def _both(path):
    return jp.load_profile(path), tp.load_profile(path)


def _sort_line_as_jax(text):
    return (text.replace("(LSD radix kernel K2, csrc/radix_sort.cu)",
                         "(LSD radix kernel, ops/pallas/radix_sort.py)")
            .replace("(library baseline arm, stable torch.sort)",
                     "(lax.sort emitter)"))


def _plan_both(jprof, tprof, w):
    """(JAX's, the port's) (plan dict or the error's class, cost dicts,
    explain text)."""
    out = []
    for mod, prof, W in ((jp, jprof, jcm.Workload), (tp, tprof,
                                                     tcm.Workload)):
        try:
            plan, costs = mod.plan_join(prof, W(**w))
        except mod.PlanInfeasibleError as e:
            out.append(("infeasible", type(e).__name__))
            continue
        text = mod.explain_table(costs, plan)
        out.append((plan.to_dict(), [c.to_dict() for c in costs],
                    text if mod is jp else _sort_line_as_jax(text)))
    return out


# ----------------------------------------------------------------- profile

def test_packaged_profile_is_the_cards_and_cited():
    prof = tp.load_profile()
    card = prof.notes.split(";")[0]
    assert "H100" in card and " W" in card      # name and power limit
    for key in REQUIRED_CONSTANTS:
        if key in ("ici_gbps", "ici_bytes_per_s"):
            with pytest.raises(tp.ProfileError, match=key):
                prof.value(key)
            continue
        assert prof.value(key) > 0
        assert prof.source(key).startswith("fit:ledger")
        assert card in prof.source(key)
        assert prof.provenance(key)["n"] >= 2
    for key in REQUIRED_CONSTANTS:
        assert jp.load_profile().source(key).strip()


def test_cost_model_constants_all_declared_required():
    with open(tcm.__file__) as f:
        used = set(re.findall(r'profile\.value\("([a-z_]+)"\)', f.read()))
    assert used and used <= set(REQUIRED_CONSTANTS)
    from tpu_radix_join.planner.profile import \
        REQUIRED_CONSTANTS as J_REQUIRED
    assert REQUIRED_CONSTANTS == J_REQUIRED


@pytest.mark.parametrize("case", ["uncited", "missing", "newer_schema"])
def test_malformed_profile_rejected_by_both(case):
    base = json.load(open(V5E))["constants"]
    for mod in (jprofile, tprofile):
        constants = {k: dict(v) for k, v in base.items()}
        kw = {}
        if case == "uncited":
            constants["hbm_gbps"] = {"value": 105.0, "source": "  "}
            match = "uncited"
        elif case == "missing":
            del constants["ici_gbps"]
            match = "ici_gbps"
        else:
            kw["schema_version"] = 99
            match = "schema_version"
        with pytest.raises(mod.ProfileError, match=match):
            mod.DeviceProfile(name="bad", constants=constants, **kw)


def test_profile_saved_by_either_loads_in_the_other(tmp_path):
    jprof, tprof = _both(V5E)
    a = tprof.save(str(tmp_path / "port.json"))
    b = jprof.save(str(tmp_path / "jax.json"))
    assert jp.load_profile(a).fingerprint() == jprof.fingerprint()
    assert tp.load_profile(b).fingerprint() == tprof.fingerprint()
    assert open(a).read() == open(b).read()
    tweaked = tprof.replace_constants(hbm_gbps={"value": 1.0,
                                                "source": "test"})
    assert tweaked.fingerprint() != tprof.fingerprint()
    h = tp.load_profile()
    assert jp.load_profile(h.save(str(tmp_path / "h.json"))).fingerprint() \
        == h.fingerprint()


# -------------------------------------------------- parity on synthetic sets

@pytest.mark.parametrize("i", range(NPROFILES))
def test_cost_tables_plans_and_explain_equal_jax(tmp_path, port_rules, i):
    jprof, tprof = _both(synthetic_profile(tmp_path / f"p{i}.json", i))
    for w in WORKLOADS:
        j, t = _plan_both(jprof, tprof, w)
        assert t == j, w


def test_every_strategy_row_wins_once(tmp_path):
    wins = collections.Counter()
    for i in range(NPROFILES):
        prof = tp.load_profile(synthetic_profile(tmp_path / f"p{i}.json", i))
        for w in WORKLOADS:
            try:
                wins[tp.plan_join(prof, tcm.Workload(**w))[0].strategy] += 1
            except tp.PlanInfeasibleError:
                pass
    assert set(wins) == set(STRATEGIES), wins


@pytest.mark.parametrize("ctx", [dict(), dict(batch_queries=4),
                                 dict(delta_tuples=1 << 16, resident=True),
                                 dict(batch_queries=64, delta_tuples=8)])
def test_serving_strategies_equal_jax(tmp_path, port_rules, ctx):
    for i in (0, 5, 10):
        jprof, tprof = _both(synthetic_profile(tmp_path / f"p{i}.json", i))
        for w in WORKLOADS[:3] + WORKLOADS[7:8]:
            j = jcm.enumerate_serving_strategies(
                jprof, jcm.Workload(**w), jcm.ServingContext(**ctx))
            t = tcm.enumerate_serving_strategies(
                tprof, tcm.Workload(**w), tcm.ServingContext(**ctx))
            assert [c.to_dict() for c in t] == [c.to_dict() for c in j]


# ------------------------------------------------------------- crossovers

def _strategy(costs, name):
    return next(c for c in costs if c.strategy == name)


def test_crossover_memory_budget_routes_to_chunked(port_rules):
    jprof, tprof = _both(V5E)
    w = dict(r_tuples=1 << 20, s_tuples=1 << 20, key_bound=1 << 20)
    assert _plan_both(jprof, tprof, w)[1] == _plan_both(jprof, tprof, w)[0]
    plan, costs = tp.plan_join(tprof, tcm.Workload(**w))
    assert plan.engine == "incore"
    assert _strategy(costs, "chunked_grid").feasible
    w["memory_budget_bytes"] = 1 << 20
    j, t = _plan_both(jprof, tprof, w)
    assert t == j
    plan, costs = tp.plan_join(tprof, tcm.Workload(**w))
    assert plan.engine == "chunked"
    assert plan.strategy == "chunked_grid_pipelined"
    assert plan.grid_pipeline == "on"
    assert plan.chunk_tuples & (plan.chunk_tuples - 1) == 0
    assert not _strategy(costs, "incore_fused_sort_narrow").feasible


def test_crossover_key_bound_narrow_to_full(port_rules):
    from tpu_radix_join_torch.ops.merge_count import MAX_MERGE_KEY
    jprof, tprof = _both(V5E)
    at = dict(r_tuples=1 << 20, s_tuples=1 << 20, key_bound=MAX_MERGE_KEY + 1)
    over = dict(at, key_bound=MAX_MERGE_KEY + 2)
    for w in (at, over):
        j, t = _plan_both(jprof, tprof, w)
        assert t == j
    plan, costs = tp.plan_join(tprof, tcm.Workload(**at))
    assert _strategy(costs, "incore_fused_sort_narrow").feasible
    plan, costs = tp.plan_join(tprof, tcm.Workload(**over))
    # K4's arm makes the two-level row (key range auto) the cheapest here
    assert plan.key_range != "narrow"
    row = _strategy(costs, "incore_fused_sort_narrow")
    assert not row.feasible and "packing limit" in row.note


def test_crossover_fused_vs_split_is_exactly_the_dispatch_floor(port_rules):
    jprof, tprof = _both(V5E)
    w = dict(r_tuples=1 << 22, s_tuples=1 << 22, key_bound=1 << 22,
             num_nodes=8)
    costs = tcm.enumerate_strategies(tprof, tcm.Workload(**w))
    assert ([c.to_dict() for c in costs] == [
        c.to_dict() for c in jcm.enumerate_strategies(jprof,
                                                      jcm.Workload(**w))])
    fused = _strategy(costs, "incore_fused_sort_narrow")
    split = _strategy(costs, "incore_split_sort_narrow")
    delta = (tcm.PROGRAMS["split_sort"] - tcm.PROGRAMS["fused"]) \
        * tprof.value("dispatch_floor_ms")
    assert split.cost_ms - fused.cost_ms == pytest.approx(delta, rel=1e-6)
    free = tprof.replace_constants(
        dispatch_floor_ms={"value": 0.0, "source": "test: zeroed floor"})
    plan, _ = tp.plan_join(free, tcm.Workload(**w))
    assert plan.fused and plan.strategy == "incore_fused_sort_narrow"


def test_pipelined_repeats_amortize_fused_dispatch_only():
    tprof = tp.load_profile(V5E)
    w1 = tcm.Workload(r_tuples=1 << 22, s_tuples=1 << 22, key_bound=1 << 22,
                      num_nodes=8)
    w10 = dataclasses.replace(w1, repeats=10)

    def term(w, name):
        return _strategy(tcm.enumerate_strategies(tprof, w),
                         name).terms["dispatch"]
    assert term(w10, "incore_fused_sort_narrow") == pytest.approx(
        term(w1, "incore_fused_sort_narrow") / 10, rel=1e-6)
    assert (term(w10, "incore_split_sort_narrow")
            == term(w1, "incore_split_sort_narrow"))


def test_wide_keys_never_narrow_and_grid_is_one_rank(port_rules):
    jprof, tprof = _both(V5E)
    wide = dict(r_tuples=1 << 20, s_tuples=1 << 20, key_bits=64)
    multi = dict(r_tuples=1 << 20, s_tuples=1 << 20, num_nodes=8)
    for w in (wide, multi):
        j, t = _plan_both(jprof, tprof, w)
        assert t == j
    plan, costs = tp.plan_join(tprof, tcm.Workload(**wide))
    assert not _strategy(costs, "incore_fused_sort_narrow").feasible
    assert plan.key_range == "auto"
    costs = tcm.enumerate_strategies(tprof, tcm.Workload(**multi))
    assert not _strategy(costs, "chunked_grid").feasible


def test_explain_table_lists_every_strategy_and_actuals(port_rules):
    jprof, tprof = _both(V5E)
    w = dict(r_tuples=1 << 20, s_tuples=1 << 20, key_bound=1 << 20)
    plan, costs = tp.plan_join(tprof, tcm.Workload(**w))
    jplan_, jcosts = jp.plan_join(jprof, jcm.Workload(**w))
    actuals = {"strategy": plan.strategy, "actual_ms": 123.4,
               "drift_pct": 23.3}
    table = tp.explain_table(costs, plan, actuals=actuals)
    for c in costs:
        assert c.strategy in table
    assert "predicted_ms" in table and "chosen:" in table
    assert "actual_ms" in table and "123.4" in table
    assert _sort_line_as_jax(table) == jp.explain_table(
        jcosts, jplan_, actuals=actuals)
    critpath = {"strategy": plan.strategy, "bound_ms": 150.25,
                "bound_rank": 0, "wait_fraction": 0.125}
    table = tp.explain_table(costs, plan, actuals=actuals, critpath=critpath)
    assert "critical_path" in table and "150.2@r0" in table
    assert _sort_line_as_jax(table) == jp.explain_table(
        jcosts, jplan_, actuals=actuals, critpath=critpath)
    with pytest.raises(NotImplementedError, match="A18e"):
        tp.explain_table(costs, plan, static={"drift_pct": 1.0})


# ------------------------------------------------------- the port's rules

def test_probe_rules_are_the_ports():
    prof = tp.load_profile(V5E)
    # K2 at every size: no 2**18 floor, available without a probe
    small = tcm.plan_sort(prof, 1 << 10, lanes=1, key_bound=1 << 8)
    assert small.passes == 1
    assert small.impl == ("pallas" if small.pallas_ms <= small.xla_ms
                          else "xla")
    j = jcm.plan_sort(jp.load_profile(V5E), 1 << 20, lanes=2,
                      pallas_ok=False)
    t = tcm.plan_sort(prof, 1 << 20, lanes=2, pallas_ok=False)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.impl == "xla"
    # batched rows run on K2 with the row index as a key
    rows = tcm.plan_sort(prof, 1 << 20, rows=64)
    assert rows.passes == 4 + 1
    for ok in (True, False):
        assert dataclasses.asdict(tcm.plan_partition(
            prof, 1 << 22, pallas_ok=ok)) == dataclasses.asdict(
            jcm.plan_partition(jp.load_profile(V5E), 1 << 22, pallas_ok=ok))
    assert tcm.plan_partition(prof, 1 << 22).impl == "pallas"


def test_static_gate_refused_by_name():
    with pytest.raises(NotImplementedError, match="A18e"):
        tp.plan_join(tp.load_profile(V5E),
                     tcm.Workload(r_tuples=1 << 16, s_tuples=1 << 16),
                     static_gate=True)


def test_h100_prices_one_rank_and_refuses_more():
    prof = tp.load_profile()
    plan, costs = tp.plan_join(prof, tcm.Workload(
        r_tuples=20_000_000, s_tuples=20_000_000, key_bound=20_000_000))
    assert plan.profile_name == "h100" and plan.predicted_ms > 0
    assert plan.strategy == "incore_fused_sort_narrow"
    assert plan.sort_impl == "pallas"
    with pytest.raises(tp.ProfileError, match="ici_bytes_per_s"):
        tp.plan_join(prof, tcm.Workload(r_tuples=1 << 20, s_tuples=1 << 20,
                                        num_nodes=4))


# ------------------------------------------------------------------ plans

def test_plan_saved_by_either_loads_in_the_other(tmp_path, port_rules):
    jprof, tprof = _both(V5E)
    w = dict(r_tuples=1 << 20, s_tuples=1 << 20, key_bound=1 << 20)
    plan, _ = tp.plan_join(tprof, tcm.Workload(**w))
    jplan_, _ = jp.plan_join(jprof, jcm.Workload(**w))
    a = plan.save(str(tmp_path / "port.json"))
    b = jplan_.save(str(tmp_path / "jax.json"))
    assert jp.JoinPlan.load(a) == jplan_
    assert tp.JoinPlan.load(b) == plan
    assert plan.config_kwargs() == jplan_.config_kwargs()
    doc = plan.to_dict()
    for bad, match in (({"surprise": 1}, "unknown plan fields"),
                       ({"schema_version": 99}, "schema_version"),
                       ({"engine": "warp"}, "engine")):
        with pytest.raises(tp.PlanError, match=match):
            tp.JoinPlan.from_dict({**doc, **bad})


def test_audit_plan_equals_jax():
    from tpu_radix_join.performance.measurements import \
        Measurements as JMeasurements
    from tpu_radix_join_torch.performance import Measurements
    plan = tp.JoinPlan(engine="incore", fused=False, strategy="split",
                       predicted_ms=40.0,
                       predicted_terms={"sort": 20.0, "shuffle": 15.0,
                                        "dispatch": 5.0},
                       profile_name="x")
    got = []
    for m, mod in ((JMeasurements(), jp), (Measurements(), tp)):
        m.add_time_us("JTOTAL", 10_000.0)
        m.add_time_us("JMPI", 2_000.0)
        t0 = mod.phase_snapshot(m)
        m.add_time_us("JTOTAL", 100_000.0)
        m.add_time_us("JMPI", 30_000.0)
        m.add_time_us("JPROC", 60_000.0)
        table = mod.audit_plan(plan.to_dict(), m, repeats=2, times0=t0)
        assert mod.audit_plan(plan, m, times0=mod.phase_snapshot(m)) is None
        events = [{k: v for k, v in e.items() if k not in ("t_s",
                                                            "t_epoch_s")}
                  for e in m.meta["events"]]
        got.append((table, m.counters["PLANDRIFT"], events,
                    mod.actuals_for_explain(table)))
    assert got[0] == got[1]
    assert got[1][0]["actual_ms"] == 50.0 and got[1][1] == 25
    assert taudit.audit_plan(None, Measurements()) is None


# -------------------------------------------------------------------- CLI

def _main(argv, capsys):
    from tpu_radix_join_torch.main import main
    rc = main([*argv, "--device", "cpu"])
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_cli_plan_explain_prints_cost_table(capsys, tmp_path):
    rc, out, _ = _main(["--tuples-per-node", "4096", "--plan", "explain",
                        "--ledger-dir", str(tmp_path)], capsys)
    assert rc == 0
    for s in ("predicted_ms", "incore_fused_sort_narrow", "chunked_grid",
              "chosen:", "provenance/staleness"):
        assert s in out
    assert "[RESULTS]" not in out
    assert not os.path.exists(tmp_path / "ledger.jsonl")


def test_cli_plan_auto_runs_and_caches(capsys, tmp_path):
    cache = str(tmp_path / "pc")
    argv = ["--tuples-per-node", "2048", "--plan", "auto",
            "--plan-cache-dir", cache]
    rc, cold, _ = _main(argv, capsys)
    assert rc == 0 and "[PLAN] strategy=" in cold
    assert "[PLAN] actual_ms=" in cold and "PLANDRIFT" in cold
    doc = json.loads(cold.splitlines()[-1])
    assert doc["matches"] == 2048 and doc["plan"]
    rc, warm, _ = _main(argv, capsys)
    assert rc == 0
    assert "[PLAN] strategy=" + doc["plan"] in warm
    assert "CKPTLOAD" in warm                    # the plan from the cache
    assert "[RESULTS] Tuples: 2048" in warm


def test_cli_plan_from_a_jax_plan_file(capsys, tmp_path, port_rules):
    jplan_, _ = jp.plan_join(jp.load_profile(H100), jcm.Workload(
        r_tuples=1 << 13, s_tuples=1 << 13, key_bound=1 << 13))
    path = jplan_.save(str(tmp_path / "plan.json"))
    rc, out, _ = _main(["--tuples-per-node", "8192", "--plan", path], capsys)
    assert rc == 0
    assert f"[PLAN] strategy={jplan_.strategy}" in out
    assert "[RESULTS] Tuples: 8192" in out


def test_cli_manifest_mismatch_fails_fast(capsys, tmp_path):
    cache_dir = str(tmp_path / "pc")
    tp.PlanCache(cache_dir, tp.load_profile()).write_manifest(num_ranks=4)
    rc, _, err = _main(["--tuples-per-node", "1024", "--plan", "auto",
                        "--plan-cache-dir", cache_dir], capsys)
    assert rc == 2 and "4-rank" in err


def test_cli_unreadable_plan_refused(capsys, tmp_path):
    bad = tmp_path / "plan.json"
    bad.write_text('{"engine": "warp"}')
    rc, _, err = _main(["--tuples-per-node", "1024", "--plan", str(bad)],
                       capsys)
    assert rc == 2 and "[PLAN]" in err


def test_cli_grid_plan_folds_into_checkpoint_and_pipeline(capsys, tmp_path):
    from tpu_radix_join_torch.robustness.checkpoint import CheckpointMismatch
    ckpt = str(tmp_path / "ck")
    for pipeline in ("off", "on"):
        plan = tp.JoinPlan(engine="chunked", strategy="chunked_grid",
                           chunk_tuples=4096, grid_pipeline=pipeline,
                           predicted_ms=1.0)
        path = plan.save(str(tmp_path / f"{pipeline}.json"))
        rc, out, _ = _main(["--tuples-per-node", "16384", "--plan", path,
                            "--checkpoint-dir", ckpt], capsys)
        doc = json.loads(out.splitlines()[-1])
        assert rc == 0 and doc["matches"] == 16384
        assert doc["grid_pipeline"] == pipeline
        assert doc["chunk_tuples"] == 4096
        assert doc["plan_vs_actual"]["strategy"] == "chunked_grid"
        with open(os.path.join(ckpt, "grid.ckpt")) as f:
            assert json.load(f)["fingerprint"]["plan"] == {
                "strategy": "chunked_grid", "chunk_tuples": 4096}
    with pytest.raises(CheckpointMismatch):
        from tpu_radix_join_torch.ops.chunked import chunked_join_grid
        from tpu_radix_join_torch.data.tuples import TupleBatch
        lane = torch.arange(4096, dtype=torch.int32)
        chunk = TupleBatch(key=lane, rid=lane)
        path = str(tmp_path / "g.ckpt")
        plan_a = tp.JoinPlan(engine="chunked", strategy="chunked_grid",
                             chunk_tuples=4096)
        assert chunked_join_grid([chunk], [chunk], 1024,
                                 checkpoint_path=path, checkpoint_tag="t",
                                 plan=plan_a) == 4096
        chunked_join_grid([chunk], [chunk], 1024, checkpoint_path=path,
                          checkpoint_tag="t",
                          plan=dataclasses.replace(plan_a,
                                                   chunk_tuples=2048))


def test_grid_checkpoint_with_a_plan_resumes_across_packages(tmp_path):
    import jax.numpy as jnp
    from tpu_radix_join.data.tuples import TupleBatch as JBatch
    from tpu_radix_join.ops.chunked import chunked_join_grid as j_grid
    from tpu_radix_join_torch.data.tuples import TupleBatch
    from tpu_radix_join_torch.ops.chunked import chunked_join_grid
    from tpu_radix_join_torch.robustness.checkpoint import CheckpointMismatch
    keys = np.arange(4096, dtype=np.uint32)
    path = str(tmp_path / "grid.ckpt")
    plan_a = jp.JoinPlan(engine="chunked", strategy="chunked_grid",
                         chunk_tuples=4096)
    jchunk = JBatch(key=jnp.asarray(keys), rid=jnp.asarray(keys))
    assert j_grid([jchunk], [jchunk], 1024, checkpoint_path=path,
                  checkpoint_tag="t", plan=plan_a) == 4096
    lane = torch.from_numpy(keys.view(np.int32).copy())
    chunk = TupleBatch(key=lane, rid=lane)
    port_a = tp.JoinPlan.from_dict(plan_a.to_dict())
    assert chunked_join_grid([chunk], [chunk], 1024, checkpoint_path=path,
                             checkpoint_tag="t", plan=port_a) == 4096
    with pytest.raises(CheckpointMismatch):
        chunked_join_grid([chunk], [chunk], 1024, checkpoint_path=path,
                          checkpoint_tag="t",
                          plan=dataclasses.replace(port_a,
                                                   strategy="other"))


def test_cli_plan_auto_prints_jax_strategy_and_total(tmp_path, monkeypatch):
    n = 1 << 16
    import tpu_radix_join as jx
    jtotal = jx.HashJoin(jx.JoinConfig(num_nodes=1)).join(
        jx.Relation(n, 1, "unique", seed=1234),
        jx.Relation(n, 1, "unique", seed=1235)).matches
    _port_rules(monkeypatch)
    jplan_, _ = jp.plan_join(jp.load_profile(H100), jcm.Workload(
        r_tuples=n, s_tuples=n, key_bound=n))
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_radix_join_torch.main", "--device",
         "cpu", "--plan", "auto", "--tuples-per-node", str(n),
         "--ledger-dir", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (f"[PLAN] strategy={jplan_.strategy} engine={jplan_.engine} "
            f"predicted_ms={jplan_.predicted_ms:.1f} profile=h100"
            in proc.stdout)
    assert f"[RESULTS] Tuples: {jtotal}" in proc.stdout
    assert jtotal == n
