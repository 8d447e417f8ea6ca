"""The port's evidence tools against the JAX package's root tools:
``python -m tpu_radix_join_torch.tools.make_report`` against
``tools_make_report.py`` (the report over ``artifacts/chip_r3`` as
``tests/test_tools.py`` reads it, the empty directory, ``perf_row`` a run,
``--emit-profile`` on a fixture ``breakdown.json`` and ``.perf`` as
``tests/test_planner.py`` builds it, ``--emit-timeline``, ``--emit-ledger``)
and ``python -m tpu_radix_join_torch.tools.profile_fit`` against
``tools_profile_fit.py`` (``fit``, ``diff``, ``refresh`` and the refused
fits of ``tests/test_calibrate.py``), exit codes equal.

Named divergences: the port's ``--emit-profile`` and ``profile_fit`` start
from ``h100`` (JAX's from ``v5e_lite``), so the distilled or fitted values
are compared, not the profiles; ``--emit-ledger`` reads ``BENCH_r*.json``
only from a ``--bench-dir`` (JAX's from the repo root, TPU runs); and
fitting onto ``h100``, ``profile_fit`` sets aside every row whose
fingerprint names no H100 (JAX's tool has no such rule)."""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import tools_make_report as jreport  # noqa: E402
import tools_profile_fit as jfit  # noqa: E402
from tpu_radix_join.observability.ledger import (  # noqa: E402
    load_rows as jload_rows)
from tpu_radix_join.planner.profile import (  # noqa: E402
    load_profile as jload_profile)

from tpu_radix_join_torch.observability.ledger import (  # noqa: E402
    Ledger, load_rows)
from tpu_radix_join_torch.observability.spans import SpanTracer  # noqa: E402
from tpu_radix_join_torch.planner.profile import (  # noqa: E402
    FITTED_PROFILE_BASENAME, SORT_REF_ELEMS, load_profile, sort_stage_units)
from tpu_radix_join_torch.tools import make_report, profile_fit  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
R3 = REPO / "artifacts" / "chip_r3"
H100 = "NVIDIA H100 80GB HBM3"


def _run(*argv):
    out = subprocess.run([sys.executable, *argv], capture_output=True,
                         text=True, cwd=REPO, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return out.returncode, out.stdout, out.stderr


def _call(main, argv):
    """``main(argv)`` in this process: (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


# ------------------------------------------------------------------ report

def test_make_report_prints_the_jax_tools_table_over_chip_r3():
    want = _run("tools_make_report.py", str(R3))
    got = _run("-m", "tpu_radix_join_torch.tools.make_report", str(R3))
    assert got == want and got[0] == 0
    # tests/test_tools.py's lines, straight from the artifacts
    assert "| perf_16m_sort_devgen | 3 |  |  |  |  | 108.5 | 309.4 |" \
        in got[1]
    assert "| perf_20m_phases_devgen | 3 |  | 83.2 | 317.1 | 366.3 | " \
        "507.4 | 78.8 |" in got[1]


def test_make_report_of_an_empty_directory_equals_jax(tmp_path):
    got = _call(make_report.main, [str(tmp_path)])
    rc, out, _ = _run("tools_make_report.py", str(tmp_path))
    assert got[:2] == (rc, out) == (0, f"# Evidence summary: {tmp_path}\n\n"
                                       f"## Task status\n\n")


@pytest.mark.parametrize("name", sorted(p.name for p in R3.glob("perf_*")))
def test_perf_row_equals_jax(name):
    assert make_report.perf_row(str(R3 / name)) == \
        jreport.perf_row(str(R3 / name))
    assert make_report.PHASES == jreport.PHASES


def test_perf_row_nets_repeats_and_pipelined_jhist(tmp_path):
    for pipelined in (False, True):
        d = tmp_path / f"perf_{int(pipelined)}"
        d.mkdir()
        (d / "0.perf").write_text("JHIST\t9000\tus\nJPROC\t6000\tus\n"
                                  "SDISPATCH\t30\tus\nRESULTS\t7\tcount\n")
        (d / "0.info").write_text(json.dumps(
            {"config": {"repeat": 3, "pipeline_repeats": pipelined}}))
        got = make_report.perf_row(str(d))
        assert got == jreport.perf_row(str(d))
        assert got["JPROC"] == 2.0 and got["SDISPATCH"] == 0.03
        assert got["JHIST"] == (9.0 if pipelined else 3.0)
        assert got["pipelined"] == ("y" if pipelined else "")
    assert make_report.perf_row(str(tmp_path)) is None


def test_make_report_usage_errors_exit_2(tmp_path):
    assert _call(make_report.main, [str(tmp_path / "missing")])[0] == 2
    assert _call(make_report.main, [])[0] == 2
    assert _call(make_report.main, [str(tmp_path), "--emit-ledger", "a",
                                    "--emit-timeline", "b"])[0] == 2


# ----------------------------------------------------------- emit-profile

def _profile_fixture(art, plane="/device:GPU:0"):
    """``tests/test_planner.py``'s fixture: one run's SDISPATCH and one
    sort-discipline trace breakdown, plus runs and breakdowns that must not
    count (a host plane, another discipline, a file)."""
    for name, us in (("perf_16m_sort", 123000), ("perf_b", 5000),
                     ("perf_c", 250000)):
        (art / name).mkdir(parents=True)
        (art / name / "0.perf").write_text(f"SDISPATCH\t{us}\tus\n")
    (art / "perf_file").write_text("not a run")
    (art / "trace_pipeline").mkdir()
    (art / "trace_pipeline" / "breakdown.json").write_text(json.dumps({
        "plane": plane, "busy_us": 2e5, "iters": 10, "sort_share": 0.5,
        "size": 1 << 24, "discipline": "sort"}))
    (art / "trace_zz_bucket").mkdir()
    (art / "trace_zz_bucket" / "breakdown.json").write_text(json.dumps({
        "plane": plane, "busy_us": 9e5, "iters": 10, "sort_share": 0.9,
        "size": 1 << 24, "discipline": "bucket"}))


@pytest.mark.parametrize("plane", ["/device:GPU:0", "/host:CPU"])
def test_emit_profile_distills_jaxs_values_on_the_h100_base(tmp_path,
                                                            monkeypatch,
                                                            plane):
    art = tmp_path / "chip_rX"
    _profile_fixture(art, plane)
    (art / "perf_file").unlink()        # JAX's loader takes it for a dir
    monkeypatch.chdir(tmp_path)
    got_path, want_path = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    rc, out, err = _call(lambda a: make_report.emit_profile(*a),
                         [str(art), got_path])
    assert rc == jreport.emit_profile(str(art), want_path) == 0
    got, want = load_profile(got_path), jload_profile(want_path)
    base = load_profile("h100")
    assert got.name == "h100+chip_rX" and want.name == "v5e_lite+chip_rX"
    keys = ["dispatch_floor_ms"] + (["sort_stage_unit_ms"]
                                    if plane.startswith("/device") else [])
    for k in keys:
        assert got.value(k) == pytest.approx(want.value(k), abs=1e-9)
        assert got.source(k) == want.source(k)
        assert "artifact:" in got.source(k)
    assert got.value("dispatch_floor_ms") == 123.0     # the median of three
    if plane.startswith("/device"):
        expect = 10.0 / sort_stage_units(SORT_REF_ELEMS)
        assert got.value("sort_stage_unit_ms") == pytest.approx(expect,
                                                                rel=1e-3)
    else:
        assert got.constants["sort_stage_unit_ms"] == \
            base.constants["sort_stage_unit_ms"]
    # the constants no artifact measures keep h100's values and citations
    for k in ("hbm_gbps", "radix_sort_pass_unit_ms", "ici_gbps"):
        assert got.constants[k] == base.constants[k]
    assert "dispatch_floor_ms" in out and not err


def test_emit_profile_with_nothing_to_distill_keeps_the_base(tmp_path):
    out = str(tmp_path / "p.json")
    rc, said, err = _call(make_report.main, [str(tmp_path), "--emit-profile",
                                             out, "--profile-name", "x"])
    assert rc == jreport.emit_profile(str(tmp_path),
                                      str(tmp_path / "j.json"), "x") == 0
    assert "no distillable measurements" in err
    prof = load_profile(out)
    assert prof.name == "x"
    assert prof.constants == load_profile("h100").constants
    rc, _, err = _call(make_report.main, [str(tmp_path), "--emit-profile",
                                          str(tmp_path / "no" / "p.json")])
    assert rc == 2 and "cannot write" in err


# ---------------------------------------------------------- emit-timeline

def _spans(d, rank, epoch_s, nodes=3):
    tr = SpanTracer(rank=rank, trace_id="cafe", tags={"nodes": nodes},
                    epoch_s=epoch_s, mono_s=0.0)
    tr.begin("JTOTAL", at=0.001)
    tr.begin("JPROC", at=0.002)
    tr.end("JPROC", at=0.004)
    tr.end("JTOTAL", at=0.005)
    tr.events.append({"name": "rank_lost", "ph": "i", "s": "p",
                      "ts": 4500.0, "pid": rank, "tid": 0, "args": {}})
    tr.save(str(d))


@pytest.mark.parametrize("damage", ["none", "torn_and_missing"])
def test_emit_timeline_equals_jaxs_merge(tmp_path, damage):
    d = tmp_path / "tl"
    for rank, epoch in ((0, 1000.0), (2, 1000.5)):
        _spans(d, rank, epoch)
    if damage != "none":
        _spans(d, 1, 1000.2)
        (d / "1.spans.json").write_text('{"traceEv')
    got_path, want_path = tmp_path / "t.json", tmp_path / "j.json"
    rc, out, err = _call(make_report.main, [str(d), "--emit-timeline",
                                            str(got_path)])
    with contextlib.redirect_stdout(io.StringIO()) as jout, \
            contextlib.redirect_stderr(io.StringIO()) as jerr:
        want_rc = jreport.emit_timeline(str(d), str(want_path))
    assert rc == want_rc == 0
    assert json.loads(got_path.read_text()) == \
        json.loads(want_path.read_text())
    assert out.replace(str(got_path), "M") == \
        jout.getvalue().replace(str(want_path), "M")
    assert err.replace("--timeline-dir", "") == \
        jerr.getvalue().replace("--timeline-dir", "")
    if damage != "none":
        assert "PARTIAL" in err and "1.spans.json" in err


def test_emit_timeline_with_no_span_file_exits_1(tmp_path):
    rc, _, err = _call(make_report.main, [str(tmp_path), "--emit-timeline",
                                          str(tmp_path / "m.json")])
    with contextlib.redirect_stderr(io.StringIO()):
        assert rc == jreport.emit_timeline(str(tmp_path),
                                           str(tmp_path / "j.json")) == 1
    assert "no *.spans.json" in err


# ------------------------------------------------------------ emit-ledger

def test_emit_ledger_equals_jaxs_with_a_bench_dir(tmp_path):
    rc, out, _ = _call(make_report.main, [
        str(REPO / "artifacts"), "--emit-ledger", str(tmp_path / "port"),
        "--bench-dir", str(REPO)])
    want = _run("tools_make_report.py", str(REPO / "artifacts"),
                "--emit-ledger", str(tmp_path / "jax"))
    assert rc == want[0] == 0
    assert "2 bench row(s)" in out
    assert out.replace(str(tmp_path / "port"), "X") == \
        want[1].replace(str(tmp_path / "jax"), "X")
    assert len(load_rows(str(tmp_path / "port"))) == \
        len(jload_rows(str(tmp_path / "jax")))


def test_emit_ledger_without_a_bench_dir_ingests_no_bench_row(tmp_path):
    """The named divergence: JAX's tool reads its repo root's TPU
    ``BENCH_r*.json``; the port's only a ``--bench-dir``'s."""
    empty = tmp_path / "empty"
    empty.mkdir()
    rc, out, err = _call(make_report.main, [str(empty), "--emit-ledger",
                                            str(tmp_path / "led")])
    assert rc == 1 and "0 bench row(s), 0 run row(s)" in out
    assert "nothing to ingest" in err
    want = _run("tools_make_report.py", str(empty), "--emit-ledger",
                str(tmp_path / "jled"))
    assert want[0] == 0 and "2 bench row(s)" in want[1]
    rc, out, _ = _call(make_report.main, [str(R3), "--emit-ledger",
                                          str(tmp_path / "r3")])
    assert rc == 0 and "0 bench row(s), 8 run row(s)" in out


# -------------------------------------------------------------- profile_fit

def _bench_row(unit_ms, rid, device=H100, size=1 << 24):
    """A bench row whose throughput encodes a known sort-stage unit
    (``tests/test_calibrate.py``'s), measured on ``device``."""
    union = 2 * size
    t_ms = unit_ms * (union / SORT_REF_ELEMS) * sort_stage_units(union)
    row = {"metric": "single_chip_join_throughput",
           "value": union / (t_ms / 1e3), "size": size}
    if device is not None:
        row["fingerprint"] = {"device": device}
    return row


def _drift_row(drift_pct, device=H100):
    return {"fingerprint": {"device": device},
            "plan_vs_actual": {"drift_pct": drift_pct, "terms": [
                {"term": "shuffle", "predicted_ms": 40.0,
                 "actual_ms": None},
                {"term": "dispatch", "predicted_ms": 1.0,
                 "actual_ms": None}]}}


def _ledger(d, bench=(), drift=()):
    led = Ledger(str(d))
    for i, (unit, dev) in enumerate(bench):
        led.append("bench", _bench_row(unit, f"b{i}", dev), run_id=f"b{i}")
    for i, pct in enumerate(drift):
        led.append("run", _drift_row(pct), run_id=f"d{i}")
    return str(d)


def _both(argv):
    """The port's tool and JAX's on one argv: their exit codes and
    outputs."""
    return _call(profile_fit.main, argv), _call(jfit.main, argv)


def test_profile_fit_fit_and_diff_exit_as_jaxs(tmp_path):
    led = _ledger(tmp_path, bench=[(0.3, H100)] * 3)
    want = _call(jfit.main, ["fit", "--ledger", led, "--out",
                             str(tmp_path / "jax_fit.json")])
    got = _call(profile_fit.main, ["fit", "--ledger", led])
    assert got[0] == want[0] == 0
    assert "fitted 1/12 constants" in got[1] and \
        "fitted 1/12 constants" in want[1]
    fitted = str(tmp_path / FITTED_PROFILE_BASENAME)
    prof = load_profile(fitted)
    assert prof.value("sort_stage_unit_ms") == pytest.approx(0.3)
    assert prof.name == "h100+fitted"
    assert "kept from h100 (under 2 samples)" in got[1]
    # 0.3 against the packaged 0.02448 (JAX's v5e_lite: 0.147): both gate
    jfitted = str(tmp_path / "jax_fit.json")
    (got_rc, *_), (want_rc, *_) = (_call(profile_fit.main,
                                         ["diff", "h100", fitted]),
                                   _call(jfit.main,
                                         ["diff", "v5e_lite", jfitted]))
    assert got_rc == want_rc == 1
    got, want = (_call(profile_fit.main, ["diff", "h100", fitted,
                                          "--threshold", "20"]),
                 _call(jfit.main, ["diff", "v5e_lite", jfitted,
                                   "--threshold", "20"]))
    assert got[0] == want[0] == 0
    assert _both(["diff", "h100", str(tmp_path / "nope.json")])[0][0] == 2


def test_profile_fit_refuses_under_sampled_fits_as_jaxs(tmp_path):
    got, want = _both(["fit", "--ledger", str(tmp_path)])
    assert got[0] == want[0] == 2
    assert "no ledger rows" in got[2] and "no ledger rows" in want[2]
    _ledger(tmp_path, bench=[(0.2, H100)])
    got, want = _both(["fit", "--ledger", str(tmp_path)])
    assert got[0] == want[0] == 2
    assert "under-sampled" in got[2] and "under-sampled" in want[2]
    assert not (tmp_path / FITTED_PROFILE_BASENAME).exists()


def test_profile_fit_refresh_flags_stale_as_jaxs(tmp_path):
    led = _ledger(tmp_path, bench=[(0.2, H100)] * 2, drift=[70.0] * 3)
    got, want = _both(["refresh", "--ledger", led])
    assert got[0] == want[0] == 1
    for out in (got[1], want[1]):
        assert "stale constants re-fit: ici_bytes_per_s" in out


def test_profile_fit_refresh_without_drift_exits_0_as_jaxs(tmp_path):
    led = _ledger(tmp_path, bench=[(0.2, H100)] * 2, drift=[5.0] * 3)
    got, want = _both(["refresh", "--ledger", led])
    assert got[0] == want[0] == 0
    assert "no stale constants" in got[1] and "no stale constants" in want[1]


def test_profile_fit_sets_aside_rows_of_another_device(tmp_path):
    """The named divergence: onto h100 only rows measured on an H100 are
    samples, so TPU, CPU and unnamed rows fit nothing (JAX's tool fits
    them all)."""
    led = _ledger(tmp_path, bench=[(0.2, "TPU v5 lite"), (0.2, "cpu"),
                                   (0.2, None), (0.2, H100)])
    got, want = _both(["fit", "--ledger", led])
    assert want[0] == 0
    assert got[0] == 2 and "under-sampled" in got[2]
    assert "set aside 3 ledger row(s)" in got[1]
    # onto a profile of another card the rows are not the tool's to judge
    other = load_profile("h100").replace_constants(name="lab")
    other.save(str(tmp_path / "lab.json"))
    rc, out, _ = _call(profile_fit.main, [
        "fit", "--ledger", led, "--base", str(tmp_path / "lab.json"),
        "--out", str(tmp_path / "lab_fit.json")])
    assert rc == 0 and "set aside" not in out
    assert load_profile(str(tmp_path / "lab_fit.json")).value(
        "sort_stage_unit_ms") == pytest.approx(0.2)
    kept, dropped = profile_fit.card_rows(load_rows(led), "h100+fitted")
    assert dropped == 3 and len(kept) == 1


def test_tools_run_as_modules(tmp_path):
    rc, out, err = _run("-m", "tpu_radix_join_torch.tools.profile_fit",
                        "fit", "--ledger", str(tmp_path))
    assert rc == 2 and "no ledger rows" in err
    rc, out, err = _run("-m", "tpu_radix_join_torch.tools.make_report",
                        str(tmp_path), "--emit-timeline",
                        str(tmp_path / "m.json"))
    assert rc == 1 and "no *.spans.json" in err
