"""The port's command-line tools (``tpu_radix_join_torch/tools``): each
exits 0/1/2 as its JAX twin does; ``check_regress``, ``critical_path`` and
``postmortem --merge`` print what ``tools_check_regress.py``,
``tools_critical_path.py`` and ``tools_postmortem.py`` print on the same
files; and SORTPASS / PARTPASS tick once a K2 sort and once a K4 grouping
of a one-rank CPU join, the baseline arms not at all."""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import tools_check_regress  # noqa: E402
import tools_critical_path  # noqa: E402
import tools_postmortem  # noqa: E402
from tpu_radix_join.observability import postmortem as jpm  # noqa: E402
from tpu_radix_join.performance.measurements import (  # noqa: E402
    Measurements as JMeasurements)
from tpu_radix_join_torch import HashJoin, JoinConfig, Relation  # noqa: E402
from tpu_radix_join_torch.main import main as tx_main  # noqa: E402
from tpu_radix_join_torch.observability import postmortem  # noqa: E402
from tpu_radix_join_torch.ops import radix, sorting  # noqa: E402
from tpu_radix_join_torch.performance.measurements import (  # noqa: E402
    PARTPASS, SORTPASS, Measurements)
from tpu_radix_join_torch.tools import (chaos, check_regress,  # noqa: E402
                                        critical_path, lint)
from tpu_radix_join_torch.tools import postmortem as tpostmortem  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv):
    """(exit code, stdout, stderr) of one in-process CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:           # argparse's usage errors
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _write(path, obj):
    path.write_text(json.dumps(obj))
    return str(path)


# ------------------------------------------------------------ check_regress
_BASE = {"JTOTAL": 100.0, "JPROC": 40.0, "JRATE": 5e8, "RETRIES": 0,
         "wirebytes": 4096, "RTUPLES": 4096}


@pytest.mark.parametrize("fresh,argv,code", [
    ({}, [], 0),
    ({"JTOTAL": 300.0}, [], 1),
    ({"JTOTAL": 300.0}, ["--allow", "JTOTAL"], 0),
    ({"JTOTAL": 120.0}, ["--tag-threshold", "JTOTAL=0.10"], 1),
    ({"JRATE": 1e8}, [], 1),
    ({"RETRIES": 1}, [], 1),
    ({"JPROC": None}, ["--strict"], 1),
    ({}, ["--tag-threshold", "JTOTAL"], 2),
], ids=["same", "cost", "allowed", "tag-threshold", "rate", "zero-pin",
        "strict-missing", "bad-spec"])
def test_check_regress_equals_jax(tmp_path, fresh, argv, code):
    result = {k: v for k, v in {**_BASE, **fresh}.items() if v is not None}
    base = _write(tmp_path / "base.json", _BASE)
    new = _write(tmp_path / "fresh.json", result)
    got = _run(check_regress.main, [new, "--baseline", base, *argv])
    want = _run(tools_check_regress.main, [new, "--baseline", base, *argv])
    assert got == want
    assert got[0] == code


def test_check_regress_io_errors(tmp_path):
    base = _write(tmp_path / "base.json", _BASE)
    assert _run(check_regress.main, [str(tmp_path / "missing.json"),
                                     "--baseline", base])[0] == 2
    (tmp_path / "torn.json").write_text("{")
    assert _run(check_regress.main, [str(tmp_path / "torn.json"),
                                     "--baseline", base])[0] == 2
    assert _run(check_regress.main, [base])[0] == 2        # no --baseline


def test_tools_run_as_modules(tmp_path):
    """``python -m tpu_radix_join_torch.tools.<name>``: the regress gate's
    exit 1 on a regression, from a process of its own."""
    base = _write(tmp_path / "base.json", _BASE)
    new = _write(tmp_path / "fresh.json", {**_BASE, "JTOTAL": 900.0})
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_radix_join_torch.tools.check_regress",
         new, "--baseline", base], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=120, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 1 and "REGRESSED" in proc.stdout


# ------------------------------------------------------------ critical_path
@pytest.fixture(scope="module")
def timeline(tmp_path_factory):
    """A span directory the port's command line wrote (one rank)."""
    tl = tmp_path_factory.mktemp("timeline")
    rc, _, _ = _run(tx_main, ["--device", "cpu", "--tuples-per-node", "2048",
                              "--timeline-dir", str(tl)])
    assert rc == 0
    return str(tl)


@pytest.mark.parametrize("flags", [["--json"], ["--summary"], []],
                         ids=["json", "summary", "report"])
def test_critical_path_equals_jax(timeline, flags):
    got = _run(critical_path.main, [timeline, *flags])
    want = _run(tools_critical_path.main, [timeline, *flags])
    assert got[0] == want[0] == 0
    if flags == ["--json"]:
        assert json.loads(got[1]) == json.loads(want[1])
    else:
        assert got[1] == want[1]
    if flags == ["--summary"]:
        assert got[1].startswith("[CRITPATH] path_ms=")


def test_critical_path_exit_codes(tmp_path, timeline):
    assert _run(critical_path.main, [str(tmp_path)])[0] == 1   # no spans
    assert _run(critical_path.main, [str(tmp_path / "nope")])[0] == 2
    assert _run(critical_path.main,
                [timeline, "--trace-id", "no-such-trace"])[0] == 1


# --------------------------------------------------------------- postmortem
@pytest.fixture()
def bundles(tmp_path):
    """Two bundles the port wrote and one the JAX package wrote."""
    d = tmp_path / "forensics"
    m = Measurements()
    m.incr("RTUPLES", 4)
    postmortem.write_bundle(str(d), measurements=m, reason="watchdog_trip",
                            failure_class="backend_unavailable",
                            extra={"idle_s": 2.0})
    postmortem.write_bundle(str(d), measurements=Measurements(),
                            reason="deadline", failure_class=
                            "deadline_exceeded")
    jpm.write_bundle(str(d), measurements=JMeasurements(),
                     reason="chaos_violation", failure_class=None)
    return d


@pytest.mark.parametrize("flags", [["--merge", "--json"], ["--merge"]],
                         ids=["json", "text"])
def test_postmortem_merge_equals_jax(bundles, flags):
    got = _run(tpostmortem.main, [str(bundles), *flags])
    want = _run(tools_postmortem.main, [str(bundles), *flags])
    assert got == want and got[0] == 0
    if "--json" in flags:
        assert json.loads(got[1])["bundles"] == 3


def test_postmortem_exit_codes(tmp_path, bundles):
    one = sorted(str(p) for p in bundles.iterdir())[0]
    rc, out, _ = _run(tpostmortem.main, [one, "--no-stacks"])
    assert rc == 0 and out.startswith(f"# {one}")
    (tmp_path / "torn.json").write_text("{")
    assert _run(tpostmortem.main, [str(tmp_path / "torn.json")])[0] == 1
    assert _run(tpostmortem.main,
                [str(tmp_path / "torn.json"), "--merge"])[0] == 1
    empty = tmp_path / "empty"
    empty.mkdir()
    assert _run(tpostmortem.main, [str(empty)])[0] == 2


# -------------------------------------------------------------------- chaos
@pytest.mark.parametrize("argv,code", [
    (["--runs", "1", "--base-seed", "0"], 0),       # classified
    (["--runs", "1", "--base-seed", "1"], 1),       # a one-rank violation
    (["--runs", "1", "--base-seed", "1", "--demo-shrink"], 0),
    (["--runs", "0"], 2),
    (["--runs", "1", "--nodes", "3"], 2),
], ids=["classified", "violation", "demo-shrink", "no-runs", "bad-nodes"])
def test_chaos_exit_codes(tmp_path, argv, code):
    """One rank on the CPU: seed 0 arms the device-init site (classified);
    seed 1 the corrupt lane, which the unverified one-rank sort probe
    counts silently, in both packages (ROADMAP C caveat 9): a violation,
    shrunk and written with its repro."""
    art = tmp_path / "chaos"
    rc, out, _ = _run(chaos.main, [*argv, "--device", "cpu", "--size",
                                   "1024", "--artifact-dir", str(art)])
    assert rc == code
    if code != 2:
        summary = json.loads(out.strip().splitlines()[-1][len("[CHAOS] "):])
        assert summary["runs"] == 1
    if "--base-seed" in argv and argv[argv.index("--base-seed") + 1] == "1":
        assert list(art.glob("repro_seed1.json"))


def test_lint_cli_exit_codes(capsys):
    assert lint.main(["--list-rules"]) == 0
    assert lint.main(["--rule", "no-such-rule"]) == 2
    capsys.readouterr()


# ------------------------------------------------------ SORTPASS / PARTPASS
@pytest.mark.parametrize("cfg,sorts,groups", [
    ({}, True, False),
    ({"probe_algorithm": "bucket"}, False, True),     # a dense row count
    ({"sort_impl": "xla", "partition_impl": "sort",
      "probe_algorithm": "bucket"}, False, False),
], ids=["sort-probe", "bucket", "baseline-arms"])
def test_pass_ticks_equal_the_dispatches(monkeypatch, cfg, sorts, groups):
    calls = {"sort": 0, "group": 0}
    k2, k4 = sorting.radix_sort, radix.partition_scatter

    def k2_counted(*a, **kw):
        calls["sort"] += 1
        return k2(*a, **kw)

    def k4_counted(*a, **kw):
        calls["group"] += 1
        return k4(*a, **kw)

    monkeypatch.setattr(sorting, "radix_sort", k2_counted)
    monkeypatch.setattr(radix, "partition_scatter", k4_counted)
    m = Measurements()
    res = HashJoin(JoinConfig(**cfg), device="cpu", measurements=m).join(
        Relation(4096, 1, "unique", seed=1), Relation(4096, 1, "unique",
                                                      seed=2))
    assert res.matches == 4096 and res.ok
    assert m.counters.get(SORTPASS, 0) == calls["sort"]
    assert m.counters.get(PARTPASS, 0) == calls["group"]
    assert (calls["sort"] > 0) == sorts and (calls["group"] > 0) == groups
