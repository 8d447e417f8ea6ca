"""Profile calibration of the port (``planner/calibrate.py``, the profile
schema shims, ``format_provenance``, ``resolve_profile``, ``calibrate``)
against the JAX package's: JAX's ``tests/test_calibrate.py`` cases, each
run through both packages on the same rows, and random ledgers from a
numpy seed on which fits, staleness, diffs and provenance tables must be
equal.

``test_profile_fit_cli_fit_and_diff``,
``test_profile_fit_cli_refuses_under_sampled`` and
``test_profile_fit_cli_refresh_flags_stale``, which drive
``tools_profile_fit.py``, are ``tests/test_torch_report_tools.py``'s
(the port's ``python -m tpu_radix_join_torch.tools.profile_fit``).
``test_plan_explain_shows_provenance_and_refit_changes_it`` is ported with
the fit made in process instead of by the tool.
"""

import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_radix_join.planner import profile as jprof  # noqa: E402

from tpu_radix_join_torch.planner import profile as tprof  # noqa: E402

# the packages export ``calibrate`` (profile.calibrate), which hides the
# submodule of the same name from attribute access
jcal = importlib.import_module("tpu_radix_join.planner.calibrate")
tcal = importlib.import_module("tpu_radix_join_torch.planner.calibrate")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V5E = os.path.join(ROOT, "tpu_radix_join", "planner", "profiles",
                   "v5e_lite.json")
PKGS = ((jcal, jprof), (tcal, tprof))


def _bench_row(unit_ms, size=1 << 24, rid="b0"):
    union = 2 * size
    t_ms = (unit_ms * (union / tprof.SORT_REF_ELEMS)
            * tprof.sort_stage_units(union))
    return {"kind": "bench", "run_id": rid,
            "metric": "single_chip_join_throughput",
            "value": union / (t_ms / 1e3), "size": size}


def _partition_row(unit_ms, size=1 << 24, rid="p0"):
    kernel_ms = unit_ms * 2.0 * size / 1e6
    return {"kind": "bench", "run_id": rid,
            "metric": "partition_fused_speedup", "value": 1.7, "size": size,
            "partition_kernel_ms": kernel_ms,
            "partition_ms": kernel_ms * 1.6,
            "partition_sort_ms": kernel_ms * 2.8,
            "partition_unit_ms": unit_ms}


def _sort_row(unit_ms, size=20_000_000, passes=4, rid="s0"):
    return {"kind": "bench", "run_id": rid, "metric": "radix_sort_speedup",
            "value": 3.7, "size": size, "sort_passes": passes,
            "sort_kernel_ms": unit_ms * passes * size / 1e6}


def _drift_row(rid, drift_pct, term="shuffle", predicted_ms=40.0):
    return {"kind": "run", "run_id": rid,
            "plan_vs_actual": {"drift_pct": drift_pct,
                               "terms": [
                                   {"term": term,
                                    "predicted_ms": predicted_ms,
                                    "actual_ms": None},
                                   {"term": "dispatch", "predicted_ms": 1.0,
                                    "actual_ms": None}]}}


def _fit_both(rows, **kw):
    """(JAX's, the port's) fitted profile dict and fits, on the v5e_lite
    snapshot as each package loads it."""
    out = []
    for cal, prof in PKGS:
        p, fits = cal.fit_profile(rows, base=prof.load_profile(V5E),
                                  fitted_at=1000.0, **kw)
        out.append((p.to_dict(), {k: (f.value, f.n, tuple(f.ci95),
                                      f.residual, f.runs)
                                  for k, f in fits.items()}))
    return out


# ------------------------------------------------------------ sample -> fit

def test_sort_unit_recovered_within_ci():
    truth = 0.25
    rows = [_bench_row(truth * f, rid=f"b{i}")
            for i, f in enumerate((0.97, 1.0, 1.02, 1.01, 0.99))]
    j, t = _fit_both(rows)
    assert t == j
    prof, fits = tcal.fit_profile(rows, base=tprof.load_profile(V5E))
    fit = fits["sort_stage_unit_ms"]
    assert fit.ci95[0] <= truth <= fit.ci95[1]
    assert abs(fit.value - truth) / truth < 0.05
    assert fit.n == 5 and "b0" in fit.runs


def test_dispatch_and_ici_samples_from_run_rows():
    rows = [{"kind": "run", "run_id": f"r{i}",
             "times_us": {"SDISPATCH": 98_000.0 + i * 1000,
                          "JMPI": 1_000_000.0},
             "counters": {"WIREBYTES": 50_000_000_000}} for i in range(3)]
    rows.append({"kind": "run", "run_id": "tiny",
                 "times_us": {"JTOTAL": 101_000.0},
                 "workload": {"global_size": 4096}})
    samples = tcal.collect_samples(rows)
    assert len(samples["dispatch_floor_ms"]) == 4
    assert len(samples["ici_bytes_per_s"]) == 3
    assert ({k: [(x.value, x.run_id) for x in v] for k, v in samples.items()}
            == {k: [(x.value, x.run_id) for x in v]
                for k, v in jcal.collect_samples(rows).items()})
    j, t = _fit_both(rows)
    assert t == j
    assert t[1]["ici_bytes_per_s"][0] == pytest.approx(5e10)


def test_partition_unit_recovered_within_ci():
    truth = 0.09
    rows = [_partition_row(truth * f, rid=f"p{i}")
            for i, f in enumerate((0.98, 1.0, 1.03, 1.0, 0.99))]
    j, t = _fit_both(rows)
    assert t == j
    prov = t[0]["constants"]["partition_pass_unit_ms"]["provenance"]
    assert prov["origin"] == "fit" and prov["n"] == 5
    lo, hi = prov["ci95"]
    assert lo <= truth <= hi and "p0" in prov["runs"]


def test_partition_unit_falls_back_to_reduced_tag():
    row = _partition_row(0.08, rid="p9")
    del row["partition_kernel_ms"]
    for cal, _ in PKGS:
        samples = cal.collect_samples([row])
        assert [s.value for s in samples["partition_pass_unit_ms"]] == [0.08]


def test_radix_sort_unit_from_sort_bench_rows():
    rows = [_sort_row(0.0085 * f, rid=f"s{i}")
            for i, f in enumerate((1.0, 0.98, 1.03))]
    rows.append(dict(_sort_row(0.02, rid="bounded"), sort_passes=2))
    j, t = _fit_both(rows)
    assert t == j
    assert t[1]["radix_sort_pass_unit_ms"][1] == 4


def test_obs_rows_feed_any_constant():
    rows = [{"kind": "obs", "run_id": f"o{i}", "constant": "hbm_gbps",
             "value": 100.0 + i} for i in range(3)]
    rows.append({"kind": "obs", "run_id": "x", "constant": "hbm_gbps",
                 "value": "not a number"})
    j, t = _fit_both(rows)
    assert t == j and t[1]["hbm_gbps"][0] == 101.0


def test_robust_fit_resists_outlier():
    vals = [1.0, 1.01, 0.99, 1.02, 50.0]
    fits = [cal.robust_fit([cal.Sample(v, f"r{i}")
                            for i, v in enumerate(vals)]) for cal, _ in PKGS]
    assert fits[0].__dict__ == fits[1].__dict__
    assert abs(fits[1].value - 1.0) < 0.05


def test_under_sampled_fit_refused():
    for cal, prof in PKGS:
        base = prof.load_profile(V5E)
        with pytest.raises(cal.UnderSampledError):
            cal.fit_profile([], base=base)
        with pytest.raises(cal.UnderSampledError):
            cal.fit_profile([_bench_row(0.2)], base=base)


@pytest.mark.parametrize("seed", range(6))
def test_random_ledgers_fit_stale_diff_and_provenance_equal_jax(seed):
    rng = np.random.default_rng(seed)
    keys = list(tprof.REQUIRED_CONSTANTS)
    rows = []
    for i in range(int(rng.integers(10, 40))):
        kind = rng.choice(["obs", "bench", "run", "drift"])
        rid = f"r{seed}-{i}"
        if kind == "obs":
            rows.append({"kind": "obs", "run_id": rid,
                         "constant": keys[int(rng.integers(len(keys)))],
                         "value": float(rng.lognormal(0, 2))})
        elif kind == "bench":
            rows.append([_bench_row, _partition_row, _sort_row][
                int(rng.integers(3))](float(rng.uniform(0.001, 0.3)),
                                      rid=rid))
        elif kind == "run":
            rows.append({"kind": "run", "run_id": rid,
                         "times_us": {"SDISPATCH": float(rng.uniform(5, 5e4)),
                                      "JMPI": float(rng.uniform(1, 1e6)),
                                      "JTOTAL": float(rng.uniform(1, 1e6))},
                         "counters": {"WIREBYTES": int(rng.integers(1e9))},
                         "workload": {"global_size":
                                      int(rng.choice([4096, 1 << 20]))}})
        else:
            rows.append(_drift_row(rid, float(rng.uniform(0, 100)),
                                   term=str(rng.choice(
                                       ["shuffle", "sort", "scan", "dispatch",
                                        "partition", "overlap"]))))
    min_samples = int(rng.integers(1, 4))
    try:
        j, t = _fit_both(rows, min_samples=min_samples)
    except jcal.UnderSampledError:
        with pytest.raises(tcal.UnderSampledError):
            tcal.fit_profile(rows, base=tprof.load_profile(V5E),
                             min_samples=min_samples)
        return
    assert t == j
    kw = dict(threshold_pct=float(rng.uniform(10, 60)),
              min_persist=int(rng.integers(1, 4)))
    stale = tcal.detect_stale(rows, **kw)
    assert stale == jcal.detect_stale(rows, **kw)
    a, b = (tprof.DeviceProfile(**{k: v for k, v in t[0].items()}),
            jprof.DeviceProfile(**{k: v for k, v in j[0].items()}))
    base_t, base_j = tprof.load_profile(V5E), jprof.load_profile(V5E)
    assert tcal.diff_profiles(base_t, a) == jcal.diff_profiles(base_j, b)
    assert (tprof.format_provenance(a, stale=stale, now_s=5000.0)
            == jprof.format_provenance(b, stale=stale, now_s=5000.0))


# ------------------------------------------------------------- schema v3+

def test_v3_profile_roundtrips_with_provenance(tmp_path):
    rows = [_bench_row(0.2, rid=f"b{i}") for i in range(2)]
    for cal, prof in PKGS:
        p, _ = cal.fit_profile(rows, base=prof.load_profile(V5E),
                               fitted_at=1000.0)
        path = str(tmp_path / f"{cal.__name__}.json")
        p.save(path)
        for other in (jprof, tprof):
            back = other.load_profile(path)
            assert back.schema_version == 6
            pv = back.provenance("sort_stage_unit_ms")
            assert pv["origin"] == "fit" and pv["n"] == 2
            assert pv["runs"] == ["b0", "b1"]
            assert back.freshness() == 1000.0
            assert all(back.provenance(k) is not None
                       for k in back.constants)
            assert back.provenance("hbm_gbps")["origin"] == "committed"


@pytest.mark.parametrize("version", [1, 3, 4, 5])
def test_old_schema_shims_equal_jax(tmp_path, version):
    committed = json.load(open(V5E))["constants"]
    drop = {1: ("ici_bytes_per_s", "partition_pass_unit_ms",
                "radix_sort_pass_unit_ms", "result_cache_lookup_ms"),
            3: ("partition_pass_unit_ms", "radix_sort_pass_unit_ms",
                "result_cache_lookup_ms"),
            4: ("radix_sort_pass_unit_ms", "result_cache_lookup_ms"),
            5: ("result_cache_lookup_ms",)}[version]
    path = str(tmp_path / f"v{version}.json")
    with open(path, "w") as f:
        json.dump({"schema_version": version, "name": "old",
                   "constants": {k: v for k, v in committed.items()
                                 if k not in drop}}, f)
    t, j = tprof.load_profile(path), jprof.load_profile(path)
    assert t.to_dict() == j.to_dict()
    for k in drop:
        assert t.source(k).startswith("shim:")
        assert f"schema v{version}" in t.source(k)
    assert t.freshness() is None


def test_fingerprint_ignores_provenance():
    base = tprof.load_profile(V5E)
    prof, _ = tcal.fit_profile(
        [_bench_row(base.value("sort_stage_unit_ms"), rid=f"b{i}")
         for i in range(2)], base=base, name=base.name)
    assert (set(prof.fingerprint()["constants"])
            == set(base.fingerprint()["constants"]))


# -------------------------------------------------------------- staleness

def test_stale_trips_on_persistent_drift_attributed_to_constant():
    rows = [_drift_row(f"d{i}", 60.0) for i in range(3)]
    assert tcal.TERM_TO_CONSTANT == jcal.TERM_TO_CONSTANT
    stale = tcal.detect_stale(rows)
    assert stale == jcal.detect_stale(rows)
    assert stale["ici_bytes_per_s"] == {"hits": 3, "mean_drift_pct": 60.0,
                                        "runs": ["d0", "d1", "d2"]}


def test_stale_needs_persistence_and_threshold():
    for cal, _ in PKGS:
        assert cal.detect_stale([_drift_row("a", 60.0)] * 2) == {}
        assert cal.detect_stale([_drift_row(f"x{i}", 10.0)
                                 for i in range(5)]) == {}


def test_format_provenance_shows_stale_column():
    rows = [_bench_row(0.2, rid=f"b{i}") for i in range(2)]
    stale = tcal.detect_stale([_drift_row(f"d{i}", 80.0) for i in range(3)])
    texts = []
    for cal, prof in PKGS:
        p, _ = cal.fit_profile(rows, base=prof.load_profile(V5E),
                               fitted_at=1000.0)
        texts.append((prof.format_provenance(p, stale=stale, now_s=4600.0),
                      prof.format_provenance(p, now_s=4600.0)))
    assert texts[0] == texts[1]
    txt, clean = texts[1]
    assert "STALE (80% drift)" in txt and "STALE" not in clean
    # an unset constant reads "unset" in the port's table
    assert "| unset " in tprof.format_provenance(tprof.load_profile())


def test_diff_profiles_table():
    for cal, prof in PKGS:
        a = prof.load_profile(V5E)
        b = a.replace_constants(hbm_gbps={"value": 210.0, "source": "x"})
        rows = {r["constant"]: r for r in cal.diff_profiles(a, b)}
        assert rows["hbm_gbps"]["rel_delta"] == 1.0
        assert rows["ici_gbps"]["rel_delta"] == 0.0
    h = tprof.load_profile()
    rows = {r["constant"]: r for r in tcal.diff_profiles(h, h)}
    assert rows["ici_gbps"] == {"constant": "ici_gbps", "a": None,
                                "b": None, "rel_delta": None}


# ------------------------------------------------------------ resolve auto

def test_resolve_profile_prefers_fresh_fit_then_falls_back(tmp_path):
    d = str(tmp_path)
    assert tprof.resolve_profile("v5e_lite") == "v5e_lite"   # passthrough
    assert tprof.resolve_profile("auto", ledger_dir=d) == "h100"
    assert jprof.resolve_profile("auto", ledger_dir=d) == "v5e_lite"
    prof, _ = tcal.fit_profile([_bench_row(0.2, rid=f"b{i}")
                                for i in range(2)],
                               base=tprof.load_profile())
    fitted = os.path.join(d, tprof.FITTED_PROFILE_BASENAME)
    prof.save(fitted)
    for pkg in (tprof, jprof):
        assert pkg.resolve_profile("auto", ledger_dir=d) == fitted
    assert tprof.resolve_profile("auto", ledger_dir=d, fresh_s=0.0) == "h100"
    with open(fitted, "w") as f:
        f.write("{not json")
    assert tprof.resolve_profile("auto", ledger_dir=d) == "h100"


def test_resolve_profile_reads_the_env_ledger(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_RADIX_LEDGER_DIR", str(tmp_path))
    prof, _ = tcal.fit_profile([_bench_row(0.2, rid=f"b{i}")
                                for i in range(2)],
                               base=tprof.load_profile())
    fitted = prof.save(str(tmp_path / tprof.FITTED_PROFILE_BASENAME))
    assert tprof.resolve_profile("auto") == fitted


# ----------------------------------------------------------- calibrate()

def test_calibrate_on_the_cpu_tags_what_it_measured():
    base = tprof.load_profile()
    cal = tprof.calibrate(base=base, sort_elems=1 << 14, device="cpu")
    assert cal.name == "h100+calibrated"
    measured = {"hbm_gbps", "sort_stage_unit_ms", "dispatch_floor_ms",
                "hbm_bytes"}
    for k in tprof.REQUIRED_CONSTANTS:
        if k in measured:
            assert cal.value(k) > 0
            assert cal.source(k).startswith("calibrate:")
            assert cal.source(k).endswith(" on cpu")
        else:
            assert cal.constants[k] == base.constants[k]
    assert "impl=xla(torch.sort)" in cal.source("sort_stage_unit_ms")


def test_calibrate_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprof.calibrate()


# -------------------------------------------------------------------- CLI

def test_plan_explain_shows_provenance_and_refit_changes_it(tmp_path, capsys,
                                                            monkeypatch):
    from tpu_radix_join_torch.main import main
    from tpu_radix_join_torch.observability.ledger import Ledger
    monkeypatch.setenv("TPU_RADIX_LEDGER_DIR", str(tmp_path))
    argv = ["--plan", "explain", "--tuples-per-node", "4096", "--device",
            "cpu"]
    assert main(argv) == 0
    base_out = capsys.readouterr().out
    assert "provenance/staleness" in base_out
    assert "chip_smoke:u:0" in base_out     # the fit's runs cited
    led = Ledger(str(tmp_path))
    for i in range(2):
        led.append("obs", {"constant": "sort_stage_unit_ms", "value": 0.3},
                   run_id=f"o{i}")
    for i in range(3):
        led.append("run", _drift_row(f"d{i}", 70.0))
    prof, _ = tcal.fit_profile(led.rows(), base=tprof.load_profile())
    prof.save(str(tmp_path / tprof.FITTED_PROFILE_BASENAME))
    assert main([*argv, "--profile", "auto"]) == 0
    cap = capsys.readouterr()
    assert "[PROFILE] auto ->" in cap.err
    assert "STALE" in cap.out and "o0,o1" in cap.out
    assert cap.out != base_out
