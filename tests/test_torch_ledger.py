"""The run ledger of the port (``observability/ledger.py``) against the JAX
package's: JAX's ``tests/test_ledger.py`` cases for the row schema, the
tolerant reader and ``run_payload``, each run through both packages on the
same files and registries; then the writers the port adds this slice —
``main --ledger-dir`` (one ``run`` row at exit) and ``JoinSession(
ledger=...)`` (one ``query`` row an executed query), held against JAX's.

The backfill (``bench_payload``, ``rows_from_perf_dir``,
``ingest_artifacts``; JAX's ``test_bench_payload_unwraps_runner_wrapper``,
``test_rows_from_perf_dir_roundtrip``,
``test_ingest_artifacts_backfills_committed_history``) is held row for row
against JAX's on the committed artifacts, with two named divergences: a
backfilled run row's fingerprint carries ``device`` (the ``.info``'s,
else ``"unknown"``), and ``ingest_artifacts`` with no ``bench_dir`` reads
no ``BENCH_r*.json`` (the repo root's are TPU runs).  JAX's
``test_emit_ledger_cli`` is ``tests/test_torch_report_tools.py``'s.

Not ported: ``test_compile_monitor_counts_backend_compiles`` and the
three metrics-sampler cases (``compilemon.py`` and ``metrics.py`` have
their own port tests).
"""

import json
import os
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import tpu_radix_join.observability.ledger as jled  # noqa: E402
from tpu_radix_join.performance.measurements import (  # noqa: E402
    Measurements as JMeasurements)

import tpu_radix_join_torch.observability.ledger as tled  # noqa: E402
from tpu_radix_join_torch.performance.measurements import (  # noqa: E402
    WIREBYTES, Measurements)

PKGS = (jled, tled)
REPO = Path(__file__).resolve().parents[1]
R3 = REPO / "artifacts" / "chip_r3"


def _strip(row):
    return {k: v for k, v in row.items() if k not in ("run_id", "t_epoch_s")}


# ------------------------------------------------------------------- core I/O

def test_append_rows_roundtrip_and_kind_filter(tmp_path):
    got = []
    for led_mod in PKGS:
        led = led_mod.Ledger(str(tmp_path / led_mod.__name__))
        r1 = led.append("run", {"counters": {"JTOTAL": 1}, "none": None})
        r2 = led.append("bench", {"metric": "m", "value": 1.0})
        assert r1["schema_version"] == led_mod.LEDGER_SCHEMA_VERSION == 1
        assert r1["run_id"] and r1["run_id"] != r2["run_id"]
        assert led.path.endswith("ledger.jsonl")
        assert [r["kind"] for r in led.rows(kind="bench")] == ["bench"]
        got.append([_strip(r) for r in led.rows()])
    assert got[0] == got[1]
    assert "none" not in got[1][0]


def test_append_rejects_unknown_kind(tmp_path):
    for led_mod in PKGS:
        with pytest.raises(ValueError, match="kind"):
            led_mod.Ledger(str(tmp_path)).append("nope", {})
    assert tled.KINDS == jled.KINDS


def test_explicit_jsonl_path_and_custom_run_id(tmp_path):
    path = str(tmp_path / "custom.jsonl")
    row = tled.Ledger(path).append("obs", {"constant": "hbm_gbps",
                                           "value": 1.0},
                                   run_id="my-run", t_epoch_s=123.0)
    assert row["run_id"] == "my-run" and row["t_epoch_s"] == 123.0
    assert jled.load_rows(path) == tled.load_rows(path) == [row]


def test_reader_skips_torn_lines_and_newer_schema(tmp_path):
    led = tled.Ledger(str(tmp_path))
    led.append("run", {"a": 1})
    jled.Ledger(str(tmp_path)).append("query", {"b": 2})
    with open(led.path, "a") as f:
        f.write(json.dumps({"schema_version": 2, "kind": "run",
                            "future": True}) + "\n")
        f.write("[1, 2]\n\n")
        f.write('{"kind": "run", "torn...')
    for kind in (None, "run", "query"):
        rows = tled.load_rows(led.path, kind=kind)
        assert rows == jled.load_rows(str(tmp_path), kind=kind)
    assert [r.get("a", r.get("b")) for r in tled.load_rows(led.path)] == \
        [1, 2]


def test_missing_ledger_reads_empty(tmp_path):
    for led_mod in PKGS:
        assert led_mod.load_rows(str(tmp_path / "absent")) == []


def test_default_ledger_dir_env_override(monkeypatch):
    monkeypatch.setenv("TPU_RADIX_LEDGER_DIR", "/x/y")
    assert tled.default_ledger_dir() == jled.default_ledger_dir() == "/x/y"
    monkeypatch.delenv("TPU_RADIX_LEDGER_DIR")
    assert tled.default_ledger_dir() == os.path.join("artifacts", "ledger")


# ------------------------------------------------------------------- payloads

def test_run_payload_distills_registry():
    m = Measurements(node_id=0, num_nodes=2)
    m.add_time_us("JTOTAL", 5000.0)
    m.incr(WIREBYTES, by=4096)
    m.counters["ZERO"] = 0
    m.meta.update(tuples_per_node=1 << 10, global_size=1 << 11, nodes=2,
                  plan={"strategy": "x"}, plan_vs_actual={"drift_pct": 3.0},
                  config={"repeat": 2, "nested": {"x": 1}})
    p = tled.run_payload(m)
    q = jled.run_payload(m)
    assert ({k: v for k, v in p.items() if k != "fingerprint"}
            == {k: v for k, v in q.items() if k != "fingerprint"})
    assert p["times_us"]["JTOTAL"] == 5000.0
    assert p["counters"] == {"WIREBYTES": 4096}
    assert p["workload"]["global_size"] == 1 << 11
    assert p["plan_vs_actual"]["drift_pct"] == 3.0 and p["repeat"] == 2
    assert "nested" not in p["config"]
    assert p["fingerprint"]["nodes"] == 2


def test_run_fingerprint_names_the_torch_stack():
    fp = tled.run_fingerprint({"extra": 1})
    assert fp["torch"] == torch.__version__
    assert fp["cuda"] == torch.version.cuda
    assert fp["device"] == ("cpu" if not torch.cuda.is_available()
                            else torch.cuda.get_device_name())
    assert fp["extra"] == 1 and fp["host"]
    assert "jax" not in fp


# ------------------------------------------------------------------ writers

def _main(argv, capsys):
    from tpu_radix_join_torch.main import main
    rc = main([*argv, "--device", "cpu"])
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_cli_ledger_dir_writes_one_run_row(tmp_path, capsys):
    from tpu_radix_join.planner.calibrate import detect_stale
    rc, out, err = _main(["--tuples-per-node", "4096", "--plan", "auto",
                          "--ledger-dir", str(tmp_path)], capsys)
    assert rc == 0 and "[OBS] ledger row" in err
    [row] = tled.load_rows(str(tmp_path))
    assert row == jled.load_rows(str(tmp_path))[0]
    assert row["kind"] == "run"
    assert row["workload"] == {"tuples_per_node": 4096,
                               "global_size": 4096, "nodes": 1}
    assert row["plan"]["strategy"] == row["plan_vs_actual"]["strategy"]
    assert row["counters"]["PLANDRIFT"] >= 0
    assert row["times_us"]["JTOTAL"] > 0
    assert row["config"]["plan"] == "auto"
    assert isinstance(detect_stale([row] * 3), dict)
    # --plan explain measures nothing and writes nothing
    rc, _, _ = _main(["--tuples-per-node", "4096", "--plan", "explain",
                      "--ledger-dir", str(tmp_path)], capsys)
    assert rc == 0 and len(tled.load_rows(str(tmp_path))) == 1


def test_cli_ledger_env_and_grid_rows(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("TPU_RADIX_LEDGER_DIR", str(tmp_path))
    rc, out, _ = _main(["--tuples-per-node", "8192", "--grid-chunk-tuples",
                        "4096"], capsys)
    assert rc == 0
    [row] = tled.load_rows(str(tmp_path))
    assert row["counters"]["GRIDPAIRS"] == 4
    assert "plan" not in row and row["times_us"]["JTOTAL"] > 0


def test_a_failing_ledger_write_never_fails_the_run(tmp_path, capsys):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    rc, _, err = _main(["--tuples-per-node", "2048", "--ledger-dir",
                        str(blocker)], capsys)
    assert rc == 0 and "[OBS] ledger append failed" in err


def test_session_ledger_rows_equal_jax(tmp_path):
    import tpu_radix_join as jx
    import tpu_radix_join.service as jsvc
    from tpu_radix_join.core.config import ServiceConfig as JServiceConfig

    import tpu_radix_join_torch as tx
    import tpu_radix_join_torch.service as tsvc
    from tpu_radix_join_torch.core.config import ServiceConfig
    got = []
    for pkg, svc, cfg, Svc, Led, Meas in (
            ("jax", jsvc, jx.JoinConfig(num_nodes=1), JServiceConfig,
             jled.Ledger, JMeasurements),
            ("port", tsvc, tx.JoinConfig(), ServiceConfig, tled.Ledger,
             Measurements)):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        led = Led(str(tmp_path / pkg))
        with svc.JoinSession(cfg, Svc(result_cache_max=4),
                             measurements=Meas(), ledger=led, **kw) as sess:
            for qid, seed in (("q0", 1), ("q1", 2), ("q0", 1)):
                req = svc.QueryRequest(query_id=qid, tuples_per_node=2048,
                                       seed=seed)
                if sess.try_cache(req) is None:
                    sess.submit(req)
                    sess.run_next()
        got.append([{k: v for k, v in _strip(r).items()
                     if k != "latency_ms"} for r in led.rows()])
    assert got[0] == got[1]
    assert [r["query_id"] for r in got[1]] == ["q0", "q1"]
    assert [r["warm"] for r in got[1]] == [False, True]


# ------------------------------------------------------------------ backfill

def _no_device(payload):
    """A run payload with the fingerprint's ``device`` set aside (the
    port's addition)."""
    fp = {k: v for k, v in payload["fingerprint"].items() if k != "device"}
    return {**payload, "fingerprint": fp}


@pytest.mark.parametrize("doc", [
    {"n": 1, "rc": 0, "parsed": {"metric": "m", "value": 2.5, "unit": "u",
                                 "extra": 7, "planned": {"strategy": "x"}}},
    {"rc": 2, "tail": "died"},
    {"metric": "m", "value": 1.0, "size": 64},
    {"metric": "m", "value": None, "flag": True},
])
def test_bench_payload_equals_jax(doc):
    got, want = tled.bench_payload(doc), jled.bench_payload(doc)
    assert got == want
    assert tled.BENCH_DEFAULT_SIZE == jled.BENCH_DEFAULT_SIZE
    if got is not None and "parsed" in doc:
        assert got["rc"] == 0 and "planned" not in got


def test_rows_from_perf_dir_equals_jax_on_the_committed_runs():
    dirs = sorted(R3.glob("perf_*"))
    assert len(dirs) == 8
    for d in dirs:
        got = tled.rows_from_perf_dir(str(d))
        want = jled.rows_from_perf_dir(str(d))
        assert len(got) == len(want) == 1
        assert [(i, _no_device(p)) for i, p in got] == want
        # the JAX package's .info names no device
        assert got[0][1]["fingerprint"]["device"] == "unknown"


def test_rows_from_perf_dir_reads_the_port_clis_device(tmp_path, capsys):
    from tpu_radix_join_torch.main import main as tx_main
    assert tx_main(["--device", "cpu", "--tuples-per-node", "4096",
                    "--output-dir", str(tmp_path / "perf_a")]) == 0
    capsys.readouterr()
    info = json.loads((tmp_path / "perf_a" / "0.info").read_text())
    assert info["device"] == "cpu"
    ((run_id, payload),) = tled.rows_from_perf_dir(str(tmp_path / "perf_a"))
    assert run_id == "perf_a:0"
    assert payload["fingerprint"]["device"] == "cpu"
    assert payload["workload"]["global_size"] == 4096
    assert payload["times_us"]["JTOTAL"] > 0
    assert "SDISPATCH" in payload["times_us"]
    assert tled.rows_from_perf_dir(str(tmp_path / "missing")) == []


def test_ingest_artifacts_equals_jax_with_a_bench_dir(tmp_path):
    got = tled.ingest_artifacts(str(REPO / "artifacts"),
                                str(tmp_path / "port"), bench_dir=str(REPO))
    want = jled.ingest_artifacts(str(REPO / "artifacts"),
                                 str(tmp_path / "jax"), bench_dir=str(REPO))
    assert got == want and got["bench"] == 2 and got["run"] >= 8
    rows = [_strip(r) for r in tled.load_rows(str(tmp_path / "port"))]
    rows = [_no_device(r) if r["kind"] == "run" else r for r in rows]
    assert rows == [_strip(r) for r in jled.load_rows(str(tmp_path / "jax"))]


def test_ingest_artifacts_reads_no_bench_file_unless_asked(tmp_path):
    """The named divergence: with no ``bench_dir`` JAX reads its repo
    root's ``BENCH_r*.json`` (TPU runs), the port none."""
    want = jled.ingest_artifacts(str(R3), str(tmp_path / "jax"))
    got = tled.ingest_artifacts(str(R3), str(tmp_path / "port"))
    assert want["bench"] == 2
    assert got == {"bench": 0, "run": want["run"]}
    assert not tled.load_rows(str(tmp_path / "port"), kind="bench")
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tled.ingest_artifacts(str(empty), str(tmp_path / "e")) == {
        "bench": 0, "run": 0}
