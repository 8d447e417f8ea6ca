"""Critical-path attribution of the port (``observability/critpath.py``)
against the JAX package's: the same span documents — one rank, a skewed
barrier, exchange spans and gaps, hedge claims (measured and projected),
a torn span, a missing rank, epoch bumps, a window, no streams — give
equal dicts from ``compute_critical_path``, equal ``format_summary`` lines
and ``render_report`` texts; ``critical_path_for_dir`` over span files the
port's tracer wrote (a torn file, a missing rank, another trace) equals
JAX's over the same directory.  The plan audit's re-pricing and the
explain column equal JAX's.  Then the port's own traced CPU runs: the
``[CRITPATH]`` line of a join and of a grid, ``meta["critical_path"]``
beside JTOTAL, ``--plan explain --timeline-dir``, a session's per-query
paths and a bundle's summary line."""

import contextlib
import copy
import io
import json

import pytest

torch = pytest.importorskip("torch")

from tpu_radix_join.observability import critpath as jcp  # noqa: E402
from tpu_radix_join.performance.measurements import (  # noqa: E402
    Measurements as JMeasurements)
from tpu_radix_join.planner import audit as jaudit  # noqa: E402

from tpu_radix_join_torch import JoinConfig  # noqa: E402
from tpu_radix_join_torch.core.config import ServiceConfig  # noqa: E402
from tpu_radix_join_torch.main import main as tx_main  # noqa: E402
from tpu_radix_join_torch.observability import critpath as tcp  # noqa: E402
from tpu_radix_join_torch.observability import postmortem  # noqa: E402
from tpu_radix_join_torch.observability.spans import SpanTracer  # noqa: E402
from tpu_radix_join_torch.performance.measurements import (  # noqa: E402
    Measurements)
from tpu_radix_join_torch.planner import audit as taudit  # noqa: E402
from tpu_radix_join_torch.service import (JoinSession,  # noqa: E402
                                          QueryRequest)


def _span(name, ts, dur, rank, **args):
    return {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur),
            "pid": rank, "tid": 0, "args": args}


def _instant(name, ts, rank, **args):
    return {"name": name, "ph": "i", "s": "p", "ts": float(ts),
            "pid": rank, "tid": 0, "args": args}


def _stream(rank, events, trace_id="t1", epoch_s=100.0):
    return {"rank": rank, "trace_id": trace_id, "epoch_s": epoch_s,
            "tags": {}, "events": events, "file": None}


def _skewed():
    """Rank 1 straggles through the JHIST barrier (arrivals 30 / 90 / 32
    ms) and owns the tail; rank 2's clock anchor is 2 ms later."""
    return [
        _stream(0, [_span("JTOTAL", 0, 100_000, 0),
                    _span("JHIST", 0, 30_000, 0),
                    _span("JMPI", 30_000, 20_000, 0),
                    _span("JPROC", 50_000, 40_000, 0)]),
        _stream(1, [_span("JTOTAL", 0, 160_000, 1),
                    _span("JHIST", 0, 90_000, 1),
                    _span("JMPI", 90_000, 10_000, 1),
                    _span("SNETCOMPL", 92_000, 5_000, 1),
                    _span("JPROC", 100_000, 60_000, 1)]),
        _stream(2, [_span("JTOTAL", 0, 98_000, 2),
                    _span("JHIST", 0, 30_000, 2),
                    _span("JMPI", 30_000, 20_000, 2),
                    _span("JPROC", 50_000, 40_000, 2)], epoch_s=100.002),
    ]


def _cases():
    one = [_stream(0, [_span("JTOTAL", 0, 50_000, 0),
                       _span("SWINALLOC", 0, 5_000, 0),
                       _span("JHIST", 500, 4_000, 0),
                       _span("JPROC", 5_000, 40_000, 0),
                       _span("JCOMPILE", 6_000, 3_000, 0),
                       _instant("plan_decision", 100, 0)])]
    gap = [_stream(0, [_span("JTOTAL", 0, 100_000, 0),
                       _span("JPROC", 0, 40_000, 0),
                       _span("JMPI", 40_000, 30_000, 0)])]
    measured = _skewed()
    measured[0]["events"] += [
        _instant("hedge_claim", 100_000, 0, partition=3, owner=0, epoch=2),
        _instant("hedge", 95_000, 0, straggler=1)]
    projected = [s for s in _skewed() if s["rank"] != 1]
    projected[0]["events"] += [
        _instant("hedge_claim", 80_000, 0, partition=3, owner=0),
        _instant("hedge", 80_000, 0, straggler=1, progress=50,
                 outstanding=50)]
    stalled = [s for s in _skewed() if s["rank"] != 1]
    stalled[0]["events"] += [
        _instant("hedge", 80_000, 0, straggler=1, progress=0,
                 outstanding=4)]
    torn = [_stream(0, [_span("JTOTAL", 0, 40_000, 0, unclosed=True),
                        _span("JPROC", 0, 40_000, 0)])]
    bumps = _skewed()
    bumps[2]["events"].append(_instant("rank_lost", 45_000, 2, epoch=3))
    bumps[0]["events"].append(_instant("rank_join", 70_000, 0, epoch=4))
    recovery = _skewed()
    recovery[0]["events"].append(_span("recovery", 120_000, 30_000, 0))
    hull = [_stream(0, [_span("grid_pair", 0, 10_000, 0),
                        _span("presort", 10_000, 2_000, 0),
                        _span("prefetch_wait", 12_000, 1_000, 0),
                        _span("readback_flush", 13_000, 3_000, 0)]),
            _stream(3, [_span("grid_pair", 1_000, 10_000, 3)])]
    served = [_stream(0, [_span("query", 0, 10_000, 0),
                          _span("JTOTAL", 1_000, 8_000, 0),
                          _span("query", 20_000, 30_000, 0),
                          _span("JTOTAL", 22_000, 26_000, 0),
                          _span("JPROC", 22_000, 26_000, 0)])]
    return {"one_rank": (one, None), "gap": (gap, None),
            "skewed": (_skewed(), None), "measured": (measured, None),
            "projected": (projected, None), "stalled": (stalled, None),
            "torn": (torn, None), "bumps": (bumps, None),
            "recovery": (recovery, None), "hull": (hull, None),
            "window": (served, (15_000, 60_000)),
            "empty_window": (served, (11_000, 12_000)),
            "no_streams": ([], None),
            "no_events": ([_stream(0, [])], None)}


@pytest.mark.parametrize("case", list(_cases()))
def test_compute_critical_path_equals_jax(case):
    streams, window = _cases()[case]
    want = jcp.compute_critical_path(copy.deepcopy(streams),
                                     warnings=["w0"], window_us=window)
    got = tcp.compute_critical_path(copy.deepcopy(streams),
                                    warnings=["w0"], window_us=window)
    assert got == want
    assert tcp.format_summary(got) == jcp.format_summary(want)
    assert tcp.render_report(got) == jcp.render_report(want)
    if case == "skewed":
        assert got["bounding_rank"] == 1 and got["path_ms"] == 160.0
        assert sum(got["fractions"].values()) == pytest.approx(1.0,
                                                               abs=1e-3)
    if case == "measured":
        assert got["hedge"]["saved_ms_estimate"] == pytest.approx(60.0)


def _tracer_file(d, rank, trace_id, epoch_s, spans, torn=None):
    clock = {"t": 0.0}
    tr = SpanTracer(rank=rank, trace_id=trace_id, epoch_s=epoch_s,
                    mono_s=0.0)
    tr.now_us = lambda: clock["t"]
    for name, start, end in spans:
        clock["t"] = start
        tr.begin(name)
        clock["t"] = end
        tr.end(name)
    if torn:
        clock["t"] = torn[1]
        tr.begin(torn[0])
        clock["t"] = torn[1] + 7_000
    return tr.save(str(d), filename=f"r{rank}_{trace_id}.spans.json")


def test_critical_path_for_dir_equals_jax(tmp_path):
    _tracer_file(tmp_path, 0, "aaa", 100.0,
                 [("JTOTAL", 0, 90_000), ("JHIST", 0, 20_000),
                  ("JMPI", 20_000, 50_000), ("JPROC", 50_000, 90_000)])
    _tracer_file(tmp_path, 2, "aaa", 100.001,
                 [("JTOTAL", 0, 80_000), ("JHIST", 0, 45_000),
                  ("JMPI", 45_000, 55_000)], torn=("JPROC", 55_000))
    _tracer_file(tmp_path, 0, "bbb", 300.0, [("JTOTAL", 0, 1_000)])
    (tmp_path / "broken.spans.json").write_text("{not json")
    for tid in (None, "aaa", "bbb", "zzz"):
        want = jcp.critical_path_for_dir(str(tmp_path), trace_id=tid)
        got = tcp.critical_path_for_dir(str(tmp_path), trace_id=tid)
        assert got == want
        assert tcp.format_summary(got) == jcp.format_summary(want)
    got = tcp.critical_path_for_dir(str(tmp_path))
    assert got["missing_ranks"] == [1] and got["partial"]
    assert got["barriers"][0]["bounding_rank"] == 2
    assert any("torn" in w for w in got["warnings"])
    assert tcp.load_streams(str(tmp_path)) == jcp.load_streams(str(tmp_path))
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tcp.critical_path_for_dir(str(empty)) == \
        jcp.critical_path_for_dir(str(empty))


def test_stream_from_tracer_and_audit_repricing_equal_jax():
    tr = SpanTracer(rank=0, trace_id="ttt", epoch_s=5.0, mono_s=0.0)
    tr.events.append(_span("JTOTAL", 0, 12_000, 0))
    tr.events.append(_span("JCOMPILE", 100, 2_000, 0))
    tr.events.append(_span("JPROC", 2_100, 9_000, 0))
    st = tcp.stream_from_tracer(tr)
    assert st == {"rank": 0, "trace_id": "ttt", "epoch_s": 5.0, "tags": {},
                  "events": tr.events, "file": None}
    cp = tcp.critical_path_from_tracer(tr)
    assert cp == jcp.compute_critical_path([st])
    plan = {"strategy": "incore_fused_sort_narrow", "engine": "incore",
            "profile_name": "h100", "predicted_ms": 4.0,
            "predicted_terms": {"sort": 3.0, "shuffle": 1.0}}
    tables = []
    for m in (Measurements(), JMeasurements()):
        m.times_us["JTOTAL"] = 24_000.0
        audit = taudit if isinstance(m, Measurements) else jaudit
        tables.append((audit.audit_plan(plan, m, repeats=2, critical_path=cp),
                       m.counters["PLANDRIFT"],
                       audit.critpath_for_explain(m.meta["plan_vs_actual"])))
    assert tables[0] == tables[1]
    table, drift, col = tables[0]
    assert table["critical_path"] == {"bound_ms": 5.0, "bound_rank": 0,
                                      "wait_fraction": cp["wait_fraction"],
                                      "drift_pct": 25.0}
    assert drift == 25 and col["bound_ms"] == 5.0
    assert taudit.critpath_for_explain(None) is None
    assert taudit.audit_plan(plan, Measurements(), critical_path=cp) is None


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = tx_main(["--device", "cpu", *argv])
    return rc, out.getvalue().splitlines()


def test_traced_join_prints_its_critical_path(tmp_path):
    tl = str(tmp_path / "tl")
    rc, out = _cli(["--tuples-per-node", "4096", "--timeline-dir", tl,
                    "--lease-dir", str(tmp_path / "leases"), "--plan",
                    "auto"])
    assert rc == 0
    lines = [x for x in out if x.startswith("[CRITPATH] ")]
    assert len(lines) == 1
    doc = json.loads(out[-1])
    cp = tcp.critical_path_for_dir(tl)
    assert "error" not in cp and cp["ranks"] == [0]
    assert lines[0] == "[CRITPATH] " + tcp.format_summary(cp)
    jtotal_ms = doc["phases_us"]["JTOTAL"] / 1e3
    assert 0 < cp["path_ms"] <= 1.05 * jtotal_ms
    assert cp["jtotal_ms"] == pytest.approx(jtotal_ms, abs=0.01)
    assert sum(cp["fractions"].values()) == pytest.approx(1.0, abs=2e-3)
    assert doc["plan_vs_actual"]["critical_path"]["bound_rank"] == 0
    explain = [x for x in out if x.startswith("| strategy")]
    assert "critical_path" in explain[0]
    # --plan explain --timeline-dir prices the chosen row against the path
    rc, out = _cli(["--tuples-per-node", "4096", "--plan", "explain",
                    "--timeline-dir", tl,
                    "--lease-dir", str(tmp_path / "leases")])
    assert rc == 0
    header = next(x for x in out if x.startswith("| strategy"))
    assert "critical_path" in header
    chosen = next(x for x in out if " * |" in x)
    assert "@r0" in chosen
    assert any(x.startswith("critical path: ") for x in out)
    # without a timeline the table has no such column
    rc, out = _cli(["--tuples-per-node", "4096", "--plan", "explain"])
    assert "critical_path" not in next(x for x in out
                                       if x.startswith("| strategy"))


def test_traced_grid_prints_its_critical_path(tmp_path):
    rc, out = _cli(["--tuples-per-node", "8192", "--grid-chunk-tuples",
                    "4096", "--timeline-dir", str(tmp_path / "tl")])
    assert rc == 0
    lines = [x for x in out if x.startswith("[CRITPATH] ")]
    assert len(lines) == 1 and "top=" in lines[0]
    assert json.loads(out[-1])["matches"] == 8192


def test_session_keeps_each_querys_path_and_bundles_summarise():
    m = Measurements()
    m.attach_tracer(nodes=1)
    sess = JoinSession(JoinConfig(), ServiceConfig(), measurements=m,
                       device="cpu")
    try:
        for i in range(10):
            sess.submit(QueryRequest(query_id=f"q{i}", tuples_per_node=512,
                                     seed=i))
            out = sess.run_next()
            assert out.status == "ok"
        paths = list(sess.recent_critical_paths)
    finally:
        sess.close()
    assert [p["query_id"] for p in paths] == [f"q{i}" for i in range(2, 10)]
    for p in paths:
        assert "error" not in p and p["ranks"] == [0]
        assert p["path_ms"] > 0
    bundle = postmortem.build_bundle(m, reason="test")
    bundle["critical_path"] = paths[-1]
    text = postmortem.render_bundle(bundle)
    assert ("critical path: " + tcp.format_summary(paths[-1])) in text
    plain = JoinSession(JoinConfig(), ServiceConfig(), device="cpu")
    try:
        plain.submit(QueryRequest(query_id="p0", tuples_per_node=512))
        plain.run_next()
        assert list(plain.recent_critical_paths) == []
    finally:
        plain.close()


# ---------------------------------------------------- one reading a stamp

class _TickingClock:
    """A clock that moves on every read, one second further each time, so
    no two reads agree and no two intervals between reads are alike: a
    timer and its span agree only if they share their readings."""

    def __init__(self, t=100.0):
        self.t = t
        self.step = 0.0

    def perf_counter(self):
        self.step += 1.0
        self.t += self.step
        return self.t

    def monotonic(self):
        return self.perf_counter()

    def time(self):
        return 1.7e9 + self.t


def test_a_timer_and_its_span_share_their_readings(monkeypatch):
    import tpu_radix_join_torch.observability.spans as tspans
    import tpu_radix_join_torch.performance.measurements as tmeas
    clock = _TickingClock()
    for mod in (tspans, tmeas):
        monkeypatch.setattr(mod, "time", clock)
    m = Measurements()
    tr = m.attach_tracer(trace_id="tick")
    m.start("JTOTAL")
    m.start("JPROC")
    m.incr("RESULTS", 5)               # the ring records between readings
    m.event("checkpoint_load", path="x")
    m.stop("JPROC")
    with m.span("grid_pair", i=1):
        pass
    m.stop("JTOTAL")
    spans = {e["name"]: e for e in tr.events if e["ph"] == "X"}
    assert spans["JTOTAL"]["dur"] == m.times_us["JTOTAL"]
    assert spans["JPROC"]["dur"] == m.times_us["JPROC"]
    assert spans["JPROC"]["ts"] >= spans["JTOTAL"]["ts"]
    cp = tcp.critical_path_from_tracer(tr)
    assert cp["jtotal_ms"] == round(m.times_us["JTOTAL"] / 1e3, 3)


def test_tracer_stamps_a_callers_reading_through_its_anchor():
    tr = SpanTracer(rank=0, trace_id="at", epoch_s=5.0, mono_s=10.0)
    tr.begin("JTOTAL", at=10.5, step=1)
    tr.end("JTOTAL", at=10.75)
    tr.now_us = lambda: 900_000.0
    tr.begin("JPROC")                   # no reading: the tracer's clock
    tr.end("JPROC", at=11.0)
    tr.end("JHIST", at=12.0)            # never begun: dropped
    assert [(e["name"], e["ts"], e["dur"], e["args"]) for e in tr.events] \
        == [("JTOTAL", 500_000.0, 250_000.0, {"step": 1}),
            ("JPROC", 900_000.0, 100_000.0, {})]
